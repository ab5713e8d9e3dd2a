"""COO / CSR matrix containers, the deterministic test vector, and the exact-f64
host oracle.

This is the TPU-framework analog of the reference's ``matrixCOO`` struct
(``spmv.h:17-33``) and of the golden-model machinery built into its readers: the
reference accumulates the golden ``y = A·x`` on the host *while parsing*
(``solver_test.c:102, 247-254``) and seeds a deterministic pseudo-random x
(``solver_test.c:89-93, 228-232``).  Here the oracle is an explicit exact-float64
NumPy SpMV over the original (un-reordered) ordering, and the deterministic x uses
our own documented LCG (we do not replicate C ``rand()`` bit-for-bit — the oracle
is recomputed from the same x, so parity is self-contained).

Port copy of ``ehyb_spmv_gpu_tpu/core/coo.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MatrixCOO:
    """Coordinate-format sparse matrix (always the *original* ordering unless a
    reorder pass says otherwise).  Analog of ``matrixCOO`` (``spmv.h:17-33``) minus
    the planner/reorder fields, which live in :class:`~..core.planner.Plan` and
    :class:`~..core.reorder.Reordering` instead of being mixed into the matrix.
    """

    n_rows: int
    n_cols: int
    row: np.ndarray  # int64/int32 [nnz]
    col: np.ndarray  # int64/int32 [nnz]
    val: np.ndarray  # float64 [nnz]

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def dimension(self) -> int:
        """Square dimension (the reference only handles square matrices —
        ``matrixCOO.dimension``, ``spmv.h:19``)."""
        if self.n_rows != self.n_cols:
            raise ValueError(
                f"matrix is {self.n_rows}x{self.n_cols}; EHYB requires square"
            )
        return self.n_rows

    def __post_init__(self) -> None:
        self.row = np.asarray(self.row)
        self.col = np.asarray(self.col)
        self.val = np.asarray(self.val, dtype=np.float64)
        if not (self.row.shape == self.col.shape == self.val.shape):
            raise ValueError("row/col/val shape mismatch")
        if self.nnz:
            if self.row.min(initial=0) < 0 or self.row.max(initial=0) >= self.n_rows:
                raise ValueError("row index out of range")
            if self.col.min(initial=0) < 0 or self.col.max(initial=0) >= self.n_cols:
                raise ValueError("col index out of range")

    # -- derived structure ---------------------------------------------------

    def row_counts(self) -> np.ndarray:
        """nnz per row — the reference's ``numInRow`` (``spmv.h:26``)."""
        return np.bincount(self.row, minlength=self.n_rows).astype(np.int64)

    def row_ptr(self) -> np.ndarray:
        """CSR row pointer (prefix sum of row counts) — the reference's
        ``rowIdx`` built at ``solver_test.c:111-121, 214-222``."""
        ptr = np.zeros(self.n_rows + 1, dtype=np.int64)
        np.cumsum(self.row_counts(), out=ptr[1:])
        return ptr

    def max_col(self) -> int:
        """Max nnz in any row — the reference's ``maxCol`` (``solver_test.c:123``)."""
        return int(self.row_counts().max(initial=0))

    def to_csr(self) -> "MatrixCSR":
        order = np.lexsort((self.col, self.row))
        return MatrixCSR(
            n_rows=self.n_rows,
            n_cols=self.n_cols,
            row_ptr=self.row_ptr(),
            col=self.col[order].copy(),
            val=self.val[order].copy(),
        )

    def sorted_by_row(self) -> "MatrixCOO":
        order = np.lexsort((self.col, self.row))
        return MatrixCOO(self.n_rows, self.n_cols,
                         self.row[order], self.col[order], self.val[order])

    def transpose_pattern_union(self) -> "MatrixCOO":
        """Symmetrized pattern A ∪ Aᵀ (values summed on duplicates) — what the
        unsymmetric reorder path feeds METIS (``reordering.c:50-89``)."""
        row = np.concatenate([self.row, self.col])
        col = np.concatenate([self.col, self.row])
        val = np.concatenate([self.val, self.val])
        return coalesce(MatrixCOO(self.n_rows, self.n_cols, row, col, val))


@dataclasses.dataclass
class MatrixCSR:
    n_rows: int
    n_cols: int
    row_ptr: np.ndarray  # int64 [n_rows+1]
    col: np.ndarray      # [nnz]
    val: np.ndarray      # float64 [nnz]

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to_coo(self) -> MatrixCOO:
        counts = np.diff(self.row_ptr)
        row = np.repeat(np.arange(self.n_rows, dtype=np.int64), counts)
        return MatrixCOO(self.n_rows, self.n_cols, row,
                         self.col.astype(np.int64), self.val)


def coalesce(m: MatrixCOO) -> MatrixCOO:
    """Sort by (row, col) and sum duplicate entries."""
    order = np.lexsort((m.col, m.row))
    row, col, val = m.row[order], m.col[order], m.val[order]
    if row.size == 0:
        return MatrixCOO(m.n_rows, m.n_cols, row, col, val)
    key_new = np.empty(row.size, dtype=bool)
    key_new[0] = True
    np.not_equal(row[1:], row[:-1], out=key_new[1:])
    key_new[1:] |= col[1:] != col[:-1]
    group = np.cumsum(key_new) - 1
    out_val = np.zeros(int(group[-1]) + 1, dtype=np.float64)
    np.add.at(out_val, group, val)
    return MatrixCOO(m.n_rows, m.n_cols, row[key_new], col[key_new], out_val)


# ---------------------------------------------------------------------------
# Deterministic test vector + oracle.
# ---------------------------------------------------------------------------

def deterministic_x(dim: int, dtype=np.float64) -> np.ndarray:
    """Deterministic pseudo-random input vector in [-0.100, 0.099].

    Plays the role of the reference's per-index seeded vector
    (``srand(i); x[i] = (rand()%200-100)/1000`` at ``solver_test.c:89-93``):
    reproducible across machines, small magnitude, sign-mixed.  Implemented with
    a 64-bit LCG (MMIX constants) instead of C ``rand`` — the oracle below is
    computed from this same x, so correctness comparisons are self-contained.
    """
    i = np.arange(dim, dtype=np.uint64)
    state = i * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)
    state ^= state >> np.uint64(33)
    r = (state >> np.uint64(16)) % np.uint64(200)
    return ((r.astype(np.int64) - 100) / 1000.0).astype(dtype)


def oracle_spmv(m: MatrixCOO, x: np.ndarray) -> np.ndarray:
    """Exact-float64 host SpMV y = A·x on the original ordering — the golden
    oracle (role of ``solver_test.c:102, 247-254``)."""
    x64 = np.asarray(x, dtype=np.float64)
    contrib = m.val * x64[m.col]
    return np.bincount(m.row, weights=contrib, minlength=m.n_rows)


def spmv_power_iterations(m: MatrixCOO, x: np.ndarray, iters: int,
                          normalize: bool = True) -> np.ndarray:
    """Repeated y = A·x in f64 (with optional inf-norm normalization to avoid
    overflow), for multi-iteration correctness checks."""
    v = np.asarray(x, dtype=np.float64)
    for _ in range(iters):
        v = oracle_spmv(m, v)
        if normalize:
            nrm = np.max(np.abs(v))
            if nrm > 0:
                v = v / nrm
    return v
