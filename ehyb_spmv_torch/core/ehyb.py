"""The EHYB-TPU matrix container.

TPU re-design of ``matrixEHYB`` (``spmv.h:35-63``).  Four sub-formats — the
reference's three plus a TPU-native DIA body — split by what the hardware
executes well:

  * **DIA body** — dense high-fill diagonals as (K, dim) value rows plus a
    *static* offset list.  No reference analog: on TPU a diagonal multiply is
    a statically-shifted slice of x (pure VPU FMA, no gather), ~4x cheaper per
    element than the SELL dynamic_gather path, so regular banded structure is
    peeled off first.  Offsets are compile-time constants (pytree aux data).

Remaining three, same roles as the reference with TPU-native layouts:

  * **blockELL body** — SELL-C-σ slices with C = 128 rows (rows live on VPU
    *lanes*; the ELL width dimension runs along sublanes), window-local column
    indices, one VMEM-cached x window per partition.  Replaces the reference's
    32-row blocked ELL with int16 local columns (``spmv.h:44-47``,
    ``convert.c:107-127``).
  * **ER tail** — out-of-window entries, rows density-sorted globally and packed
    into SELL slices with *global* column indices (``spmv.h:48-55``,
    ``convert.c:148-168``), plus the scatter-back row map (``rowVecER``).
  * **long-row stream** — rows with pathologically many out-of-window entries,
    kept as a COO-like stream reduced by segments (``spmv.h:58-62``,
    ``convert.c:33-59``, ``kernel.cu:43-67``).  Note the deviation: the
    reference long-extracts rows by *in-window* count (``convert.c:92-101``)
    because its ELL width is a per-32-row-block cost; in SELL-128 the in-window
    width is bounded by the window and amortized over 128 lanes, so extraction
    by *ER* count is what protects the ER slice widths instead.

All shapes are static; slices are concatenated along the width-step axis with
prefix-sum offsets (scalar-prefetched by the Pallas kernel), replacing the
reference's ``biasVecBlockELL``/``biasVecER`` (``convert.c:336-350``).

Port copy of ``ehyb_spmv_gpu_tpu/core/ehyb.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.  The
device mirror :class:`EhybDevice` is a ``torch.nn.Module`` of buffers in place
of the JAX pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import LANES, round_up


@dataclasses.dataclass
class EhybMatrix:
    """Host-side EHYB-TPU matrix (NumPy arrays; see :meth:`to_torch`)."""

    dim: int
    nnz_total: int
    window_rows: int
    n_parts: int

    # --- blockELL body (SELL-128 over window-local columns) ---
    #: (ell_steps, 128) window-local column indices (role of ``colBlockELL``,
    #: int16 in the reference ``spmv.h:46``; int32/int16 here per config).
    ell_col: np.ndarray
    #: (ell_steps, 128) values (role of ``valBlockELL``).
    ell_val: np.ndarray
    #: (n_slices + 1,) int32 — width-step offset of each slice (prefix sum, role
    #: of ``biasVecBlockELL`` ``convert.c:336-340``).
    slice_offset: np.ndarray
    #: (n_slices,) int32 — window start row of each slice's partition (derived
    #: from ``partBoundary``, ``spmv.h:31``).  For the multi-window layout this
    #: is the window of the slice's FIRST group only; ``step_win`` is
    #: authoritative.
    slice_win_start: np.ndarray
    #: (ell_steps,) int32 — x-window start row of every width-step (the
    #: generalization that lets each 8-step tile pick its own 1024-aligned
    #: window; constant within a tile by construction).
    step_win: np.ndarray

    # --- ER tail (SELL over global columns, density-sorted rows) ---
    #: (er_steps, 128) global column indices (role of ``colER`` ``spmv.h:53``).
    er_col: np.ndarray
    #: (er_steps, 128) values (role of ``valER``).
    er_val: np.ndarray
    #: (n_er_slices + 1,) int32 (role of ``biasVecER``).
    er_slice_offset: np.ndarray
    #: (n_er_slices * 128,) int32 — true row of each packed ER lane-row, padding
    #: lanes point at the dump row ``dim`` (role of ``rowVecER`` ``spmv.h:51``;
    #: scatter-back ``y[rowVecER[i]] += yER[i]`` is ``kernel.cu:69-77``).
    er_rows: np.ndarray

    # --- long-row stream ---
    #: (n_long_entries,) int32 global columns (role of ``longVecCol``).
    long_col: np.ndarray
    #: (n_long_entries,) values (role of ``longVecVal`` — and unlike the
    #: reference, actually the values: see the H2D copy bug at ``spmv.cu:58``).
    long_val: np.ndarray
    #: (n_long_entries,) int32 — position of each entry's row in ``long_rows``.
    long_seg: np.ndarray
    #: (n_long,) int32 — true row ids of long rows.
    long_rows: np.ndarray

    #: (ell_steps,) int32 — SECOND x-window start row per width-step, for the
    #: relaxed lo-slot layout (``sell_rx``): each sub-tile carries a window
    #: PAIR and the packed index's bit 10 selects A vs B.  Empty for the
    #: chunk-synchronized layouts (kernel uses ``step_win`` alone).
    step_win_b: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    #: THIRD/FOURTH per-step window starts: with
    #: ``config.windows_per_subtile = 4`` each sub-tile serves a window QUAD
    #: and ``sel`` has two bits (10-11).  Empty at the default 2.
    step_win_c: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    step_win_d: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    #: Hub-row splitting (sell_rx): body row ``split_src[k]`` (a synthetic
    #: overflow row in the slices past the real rows) accumulates surplus
    #: entries of true row ``split_dst[k]``; combine scatter-adds them back
    #: (the in-body analog of the ER scatter-back, kernel.cu:69-77).
    split_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    split_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))

    # --- DIA body (TPU-native; extracted before SELL packing) ---
    #: (K,) int64 — diagonal offsets d (col = row + d), sorted ascending.
    #: Static metadata on device (baked into the jitted apply as slice starts).
    dia_offsets: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    #: (K, round_up(dim, LANES)) values: ``dia_val[k, i] = A[i, i + d_k]``
    #: (0 where the diagonal has no entry / runs off the matrix edge).
    dia_val: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.float32))

    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def n_slices(self) -> int:
        return int(self.slice_offset.shape[0]) - 1

    @property
    def n_er_slices(self) -> int:
        return int(self.er_slice_offset.shape[0]) - 1

    @property
    def n_long(self) -> int:
        return int(self.long_rows.shape[0])

    @property
    def padded_rows(self) -> int:
        """Row-space size of the padded y vector (multiple of LANES, +LANES for
        the ER dump row)."""
        return round_up(self.dim + 1, LANES)

    @property
    def padded_x_rows(self) -> int:
        """Row-space size of the padded x vector: every window
        [win_start, win_start + window_rows) must be in range."""
        return round_up(self.dim, LANES) + round_up(self.window_rows, LANES)

    def pad_x(self, x: np.ndarray) -> np.ndarray:
        """Zero-pad a reordered x to ``padded_x_rows`` (kernel input form)."""
        out = np.zeros(self.padded_x_rows, dtype=x.dtype)
        out[: self.dim] = x[: self.dim]
        return out

    def to_torch(self, dtype: Optional[str] = None,
                 device: Any = "cpu") -> "EhybDevice":
        """Upload every array field (role of ``cudaMallocTransDataEHYB``,
        ``spmv.cu:6-60``); ``dtype`` casts the value arrays."""
        return EhybDevice(self, dtype=dtype).to(device)

    # -- serialization (the reference never caches its converted format; we do,
    #    per SURVEY.md §5 "Checkpoint / resume") --
    def save_npz(self, path: str) -> None:
        # uncompressed: zlib on a ~400 MB audikw-class artifact costs ~45 s
        # of the setup budget; disk is cheap, reconversion is not
        np.savez(
            path,
            dim=self.dim, nnz_total=self.nnz_total,
            window_rows=self.window_rows, n_parts=self.n_parts,
            ell_col=self.ell_col, ell_val=self.ell_val,
            slice_offset=self.slice_offset, slice_win_start=self.slice_win_start,
            step_win=self.step_win, step_win_b=self.step_win_b,
            step_win_c=self.step_win_c, step_win_d=self.step_win_d,
            split_src=self.split_src, split_dst=self.split_dst,
            er_col=self.er_col, er_val=self.er_val,
            er_slice_offset=self.er_slice_offset, er_rows=self.er_rows,
            long_col=self.long_col, long_val=self.long_val,
            long_seg=self.long_seg, long_rows=self.long_rows,
            dia_offsets=self.dia_offsets, dia_val=self.dia_val,
            stats_json=np.bytes_(
                __import__("json").dumps(self.stats).encode()),
        )

    @staticmethod
    def load_npz(path: str) -> "EhybMatrix":
        z = np.load(path)
        extra = {}
        if "dia_offsets" in z:  # older caches predate the DIA body
            extra = dict(dia_offsets=z["dia_offsets"], dia_val=z["dia_val"])
        if "step_win_b" in z:
            extra["step_win_b"] = z["step_win_b"]
        if "step_win_c" in z:
            extra["step_win_c"] = z["step_win_c"]
            extra["step_win_d"] = z["step_win_d"]
        if "split_src" in z:
            extra["split_src"] = z["split_src"]
            extra["split_dst"] = z["split_dst"]
        stats = {}
        if "stats_json" in z:
            stats = __import__("json").loads(bytes(z["stats_json"]).decode())
        return EhybMatrix(
            stats=stats, **extra,
            dim=int(z["dim"]), nnz_total=int(z["nnz_total"]),
            window_rows=int(z["window_rows"]), n_parts=int(z["n_parts"]),
            ell_col=z["ell_col"], ell_val=z["ell_val"],
            slice_offset=z["slice_offset"], slice_win_start=z["slice_win_start"],
            step_win=z["step_win"],
            er_col=z["er_col"], er_val=z["er_val"],
            er_slice_offset=z["er_slice_offset"], er_rows=z["er_rows"],
            long_col=z["long_col"], long_val=z["long_val"],
            long_seg=z["long_seg"], long_rows=z["long_rows"],
        )


class EhybDevice(torch.nn.Module):
    """Device-side mirror of :class:`EhybMatrix` (role of the device struct
    filled by ``cudaMallocTransDataEHYB``, ``spmv.cu:6-60``).  Array fields
    are buffers, so ``to(device)`` uploads all of them; ``dim``,
    ``window_rows``, ``dia_offsets``, ``body_nnz`` and ``rx_body`` stay plain
    Python metadata (the JAX mirror keeps them as static pytree aux data)."""

    ARRAY_FIELDS = ("ell_col", "ell_val", "slice_offset", "slice_win_start",
                    "step_win", "step_win_b", "step_win_c", "step_win_d",
                    "split_src", "split_dst",
                    "er_col", "er_val", "er_slice_offset", "er_rows",
                    "long_col", "long_val", "long_seg", "long_rows",
                    "dia_val")
    VALUE_FIELDS = ("ell_val", "er_val", "long_val", "dia_val")

    def __init__(self, e: EhybMatrix, dtype: Optional[str] = None):
        super().__init__()
        self.dim = e.dim
        self.window_rows = e.window_rows
        self.dia_offsets = tuple(int(d) for d in e.dia_offsets)
        #: SELL-body nnz: 0 lets the applies skip the body entirely.
        self.body_nnz = int(e.stats.get("nnz_ell", e.ell_val.size))
        #: The body uses the relaxed lo-slot (multi-window) layout.
        self.rx_body = bool(e.step_win_b.size)
        for f in self.ARRAY_FIELDS:
            a = np.ascontiguousarray(getattr(e, f))
            if dtype and f in self.VALUE_FIELDS:
                a = a.astype(dtype)
            self.register_buffer(f, torch.from_numpy(a.copy()))

    @property
    def padded_x_rows(self) -> int:
        """Length the padded x must have (as :attr:`EhybMatrix.padded_x_rows`)."""
        return round_up(self.dim, LANES) + round_up(self.window_rows, LANES)

    @property
    def nwin(self) -> int:
        """x windows per 8-step sub-tile: 1 (plain window-local columns),
        2 or 4 (relaxed lo-slot layouts)."""
        if not self.step_win_b.shape[0]:
            return 1
        return 4 if self.step_win_c.shape[0] else 2


def ehyb_from_arrays(fields: Dict[str, np.ndarray], meta: Dict[str, Any]
                     ) -> EhybMatrix:
    """Rebuild an :class:`EhybMatrix` from another build's NumPy fields (the
    JAX package's ``EhybMatrix`` included), so both applies can run on one
    artifact.  ``meta`` holds ``dim``, ``nnz_total``, ``window_rows``,
    ``n_parts`` and optionally ``stats``."""
    names = {f.name for f in dataclasses.fields(EhybMatrix)}
    arrays = {k: np.asarray(v) for k, v in fields.items()
              if k in names and k not in meta}
    return EhybMatrix(
        dim=int(meta["dim"]), nnz_total=int(meta["nnz_total"]),
        window_rows=int(meta["window_rows"]), n_parts=int(meta["n_parts"]),
        stats=dict(meta.get("stats", {})), **arrays)
