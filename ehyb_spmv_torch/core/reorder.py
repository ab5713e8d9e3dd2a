"""Two-level row reordering + vector permute/recover.

TPU re-design of ``reordering.c``:
  * level 1 — group rows by graph-partition label (``reordering.c:300-321``),
    first-come stable order within each partition;
  * boundary alignment — partition boundaries are snapped to ``plan.part_align``
    rows so every window start is tile-aligned for the x DMA (no GPU analog; the
    reference's windows start at raw partition boundaries);
  * level 2 — stable sort rows *within each partition* by descending in-window
    nnz (``sortRordrList`` ``reordering.c:18-39`` + comparator ``Partition.h:17-24``),
    which makes SELL slice widths uniform-by-construction — the static-schedule
    replacement for the reference's warp work-stealing (``kernel.cu:164-167``).

The permutation is symmetric (P·A·Pᵀ): x is permuted before the solve and y
inverse-permuted after, exactly like ``vectorReorder``/``vectorRecover``
(``reordering.c:380-391``, applied at ``solver_test.c:376,383``).

Port copy of ``ehyb_spmv_gpu_tpu/core/reorder.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.coo import MatrixCOO
from ..core.planner import Plan


@dataclasses.dataclass
class Reordering:
    """A row permutation plus the partition geometry it induces."""

    #: ``new_to_old[new] = old`` — gather form: ``x_reordered = x[new_to_old]``.
    new_to_old: np.ndarray
    #: ``old_to_new[old] = new`` — the reference's ``reorderList`` semantics
    #: (scatter form, ``reordering.c:380-384``).
    old_to_new: np.ndarray
    #: Partition row boundaries in the *new* ordering, length n_parts+1;
    #: boundaries[0] = 0, boundaries[-1] = dim; interior entries aligned to
    #: ``plan.part_align``.  Role of ``partBoundary`` (``spmv.h:31``).
    boundaries: np.ndarray

    @property
    def dim(self) -> int:
        return int(self.new_to_old.shape[0])

    @property
    def n_parts(self) -> int:
        return int(self.boundaries.shape[0]) - 1

    def vector_reorder(self, v: np.ndarray) -> np.ndarray:
        """Permute a vector into the reordered space (``vectorReorder``,
        ``reordering.c:380-384``)."""
        return np.asarray(v)[self.new_to_old]

    def vector_recover(self, v: np.ndarray) -> np.ndarray:
        """Inverse-permute a reordered vector back to the original space
        (``vectorRecover``, ``reordering.c:386-391``)."""
        return np.asarray(v)[self.old_to_new]

    def apply_to_matrix(self, m: MatrixCOO) -> MatrixCOO:
        """Symmetric permutation of the COO triples (``reordering.c:347-362``)."""
        return MatrixCOO(m.n_rows, m.n_cols,
                         self.old_to_new[m.row], self.old_to_new[m.col],
                         m.val.copy())


def identity_reordering(dim: int, boundaries: np.ndarray) -> Reordering:
    i = np.arange(dim, dtype=np.int64)
    return Reordering(i, i.copy(), np.asarray(boundaries, dtype=np.int64))


def _aligned_boundaries(sizes: np.ndarray, align: int, dim: int) -> np.ndarray:
    """Snap cumulative partition boundaries to ``align`` rows, keeping them
    monotone.  Rows shifted across a snapped boundary simply belong to the
    neighboring window; the converter re-tests window membership exactly, so
    this only (slightly) grows the ER tail."""
    cum = np.concatenate([[0], np.cumsum(sizes)])
    snapped = (np.round(cum / align) * align).astype(np.int64)
    snapped[0], snapped[-1] = 0, dim
    # enforce monotonicity
    snapped = np.maximum.accumulate(snapped)
    snapped = np.minimum(snapped, dim)
    return snapped


def in_window_counts(row: np.ndarray, col: np.ndarray, boundaries: np.ndarray,
                     window_rows: int, dim: int) -> np.ndarray:
    """Per-row count of entries whose column lies inside the row's partition
    window [b_p, b_p + window_rows) — the reference's ``numInRow2``
    (``reordering.c:358-361``)."""
    part_of_row = np.searchsorted(boundaries, row, side="right") - 1
    win_start = boundaries[part_of_row]
    in_win = (col >= win_start) & (col < win_start + window_rows)
    return np.bincount(row[in_win], minlength=dim).astype(np.int64)


def two_level_reorder(m: MatrixCOO, labels: np.ndarray, plan: Plan,
                      sort_rows: bool = True,
                      sort_mode: str = "density") -> Reordering:
    """Build the two-level permutation from partition labels.

    ``labels[old_row] = partition id`` (what ``MTMETIS_PartGraphKway`` returns,
    ``reordering.c:280-293``).  Returns a :class:`Reordering` with aligned
    boundaries; if ``sort_rows`` the in-partition sort is applied.

    ``sort_mode``:
      * ``"density"`` — descending in-window nnz (the reference's sort,
        ``reordering.c:18-39``): uniform SELL slice widths;
      * ``"pattern"`` — by quantized minimum column, then density: groups rows
        with *similar column structure* into the same 128-row slice, which is
        what minimizes the multi-window layout's per-(slice, window, chunk)
        padding (a graph partition selects spatially-close but
        interleaved-ordered rows; this re-linearizes them).
    """
    dim = m.dimension
    labels = np.asarray(labels)
    if labels.shape[0] != dim:
        raise ValueError("labels length != dim")
    n_parts = plan.n_parts
    if labels.max(initial=0) >= n_parts:
        raise ValueError("label out of range")

    # Level 1: stable grouping by partition (reordering.c:300-321).
    new_to_old = np.argsort(labels, kind="stable").astype(np.int64)
    sizes = np.bincount(labels, minlength=n_parts).astype(np.int64)
    boundaries = _aligned_boundaries(sizes, plan.part_align, dim)

    old_to_new = np.empty(dim, dtype=np.int64)
    old_to_new[new_to_old] = np.arange(dim, dtype=np.int64)

    if sort_rows:
        # Level 2: in-partition sort.  Counts/keys are computed in the level-1
        # ordering (cf. reordering.c:327-334).
        row1 = old_to_new[m.row]
        col1 = old_to_new[m.col]
        counts = in_window_counts(row1, col1, boundaries, plan.window_rows, dim)
        part_of_new = np.searchsorted(boundaries, np.arange(dim), side="right") - 1
        if sort_mode == "pattern":
            min_col = np.full(dim, dim, dtype=np.int64)
            np.minimum.at(min_col, row1, col1)
            # lexsort: last key is primary → (part, min_col//1024, min_col//128,
            # -count); stable, so ties keep first-come order.
            order = np.lexsort((-counts, min_col // 128, min_col // 1024,
                                part_of_new))
        elif sort_mode == "density":
            # Stable sort key: (partition, -count), like the reference's qsort.
            order = np.lexsort((-counts, part_of_new))
        else:
            raise ValueError(f"unknown sort_mode {sort_mode!r}")
        # order maps: position-in-sorted -> level-1 row.  Compose permutations.
        new_to_old = new_to_old[order]
        old_to_new = np.empty(dim, dtype=np.int64)
        old_to_new[new_to_old] = np.arange(dim, dtype=np.int64)

    return Reordering(new_to_old=new_to_old, old_to_new=old_to_new,
                      boundaries=boundaries)
