"""One shard's body plan for K1, its row blocks split into interior and
boundary.

The GPU counterpart of the interior/boundary split of the JAX sharded
path (``ehyb_spmv_gpu_tpu/parallel/spmv.py:346-369``), which sorts the
shard's padded sub-tiles into two tile groups for two Pallas calls.  Here
the shard's body is decoded once into K1's compact plan
(``ops/stream_cells.py::build_stream_cells``) over the shard's ``x_ext =
[left halo W | local R | right halo W]``, and each 32-row block of the
plan is classified:

* **interior**: every x row in the tables of all its pieces lies in the
  local rows ``[W/128, (W+R)/128)`` (a row block without cells reads
  nothing and is interior too), so K1 can compute it before the halos
  arrive;
* **boundary**: any other row block.

The two lists cover every row block exactly once; the sharded apply
launches K1 over each into one y.  As in the JAX package, a world of one
rank (whose "halos" are zeros) and ``EHYB_FORCE_BOUNDARY=1`` (the control
arm of an overlap measurement) put every row block on the boundary side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import LANES
from ..core.ehyb import EhybMatrix
from ..ops.stream_cells import (PIECE_RB, PIECE_ROW, StreamCellsDevice,
                                StreamCellsPlan, build_stream_cells)


def local_row_blocks(plan: StreamCellsPlan, lo: int, hi: int) -> np.ndarray:
    """(n_rb,) bool: the row blocks whose pieces read only x rows (of 128
    values) in ``[lo, hi)``."""
    piece = plan.piece.astype(np.int64)
    rows = plan.rows.astype(np.int64)
    if not rows.size:
        return np.ones(plan.n_rb, dtype=bool)
    t0, t1 = piece[:-1, PIECE_ROW], piece[1:, PIECE_ROW]
    # a piece's table is sorted: its first and last rows bound it
    first = rows[np.minimum(t0, rows.size - 1)]
    last = rows[np.maximum(t1 - 1, 0)]
    bad = (t1 > t0) & ((first < lo) | (last >= hi))
    n_bad = np.bincount(piece[:-1, PIECE_RB][bad], minlength=plan.n_rb)
    return n_bad == 0


@dataclasses.dataclass
class ShardCellsPlan:
    """K1's plan of one shard and its row blocks by kind (int32 ids)."""

    plan: StreamCellsPlan
    interior: np.ndarray
    boundary: np.ndarray

    @property
    def stats(self) -> dict:
        return {**self.plan.stats, "n_interior": int(self.interior.size),
                "n_boundary": int(self.boundary.size)}

    def to_torch(self, device=None) -> "ShardCellsDevice":
        return ShardCellsDevice(self).to(device)


class ShardCellsDevice(torch.nn.Module):
    """Device mirror of :class:`ShardCellsPlan`: the plan and both lists."""

    def __init__(self, p: ShardCellsPlan):
        super().__init__()
        self.plan = StreamCellsDevice(p.plan)
        self.stats = p.stats
        self.register_buffer("interior", torch.from_numpy(
            np.ascontiguousarray(p.interior, dtype=np.int32)))
        self.register_buffer("boundary", torch.from_numpy(
            np.ascontiguousarray(p.boundary, dtype=np.int32)))


def build_shard_cells(e: EhybMatrix, sh, force_boundary: bool = False
                      ) -> ShardCellsPlan:
    """K1's plan of the shard ``e`` (windows in ``x_ext`` coordinates, as
    :func:`~.spmv.shard_matrix` gives it) of the sharded matrix ``sh``, and
    its interior and boundary row blocks."""
    R, W = sh.rows_per_dev, sh.window_rows
    plan = build_stream_cells(e, x_rows=R + 2 * W)
    if sh.n_dev == 1 or force_boundary:
        interior = np.zeros(plan.n_rb, dtype=bool)
    else:
        interior = local_row_blocks(plan, W // LANES, (W + R) // LANES)
    return ShardCellsPlan(
        plan=plan, interior=np.flatnonzero(interior).astype(np.int32),
        boundary=np.flatnonzero(~interior).astype(np.int32))
