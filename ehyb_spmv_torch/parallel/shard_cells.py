"""One shard's K1 plan, its row blocks split into interior and boundary.

The GPU counterpart of the interior/boundary split of the JAX sharded
path (``ehyb_spmv_gpu_tpu/parallel/spmv.py:346-369``), which sorts the
shard's padded sub-tiles into two tile groups for two Pallas calls.  Here
the shard is decoded once into K1's plan as the flagship's artifact is
(``ops/stream_cells.py::k1_folded_plan``): its body and its EHYB tail (the
ER and long rows, whose columns the conversion remapped into ``[x_ext |
recv]``) as cells of their true rows, with the options of its value type
(the split form past ``SPLIT_STEPS``; in float64 also direct pieces and
grouped rows).  The plan reads the rank's ``x_buf = [left halo W | local R
| right halo W | recv D*S]`` (``parallel/comm.py``), and each 32-row block
of it is classified:

* **interior**: every cell of all its pieces reads a local x value, in
  ``[W, W + R)`` (a table piece through every row of its table, a direct
  piece at every column; a row block without cells reads nothing and is
  interior too), so K1 can compute it before the halos and ``recv``
  arrive;
* **boundary**: any other row block.

A direct piece's padding cells (value 0) are pointed at x[W], the first
local value, so that they read no halo either.  The two kinds cover every
row block exactly once; the sharded apply launches K1 over each into one
y.  A chunked row block's chunks follow its kind: over a plan in the split
form a list is the listed row blocks' work items
(``stream_cells.list_items``), so a row block's chunk partials are added
into y by the call that runs them.  As in the JAX package, a world of one
rank (whose "halos" are zeros) and ``EHYB_FORCE_BOUNDARY=1`` (the control
arm of an overlap measurement) put every row block on the boundary side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import LANES
from ..core.ehyb import EhybMatrix
from ..ops.stream_cells import (PIECE_CELL, PIECE_RB, PIECE_ROW,
                                StreamCellsDevice, StreamCellsPlan,
                                k1_folded_plan, list_items, split)


def _direct_cells(plan: StreamCellsPlan):
    """(n_pieces,) bool of the direct pieces (cells, no table) and each
    cell's piece; the second is None where no piece is direct."""
    piece = plan.piece.astype(np.int64)
    n_cells = np.diff(piece[:, PIECE_CELL])
    direct = (np.diff(piece[:, PIECE_ROW]) == 0) & (n_cells > 0)
    if not direct.any():
        return direct, None
    return direct, np.repeat(np.arange(len(piece) - 1), n_cells)


def local_row_blocks(plan: StreamCellsPlan, lo: int, hi: int) -> np.ndarray:
    """(n_rb,) bool: the row blocks whose cells read only x rows (of 128
    values) in ``[lo, hi)``: every table row of their table pieces and
    every column of their direct pieces."""
    piece = plan.piece.astype(np.int64)
    rows = plan.rows.astype(np.int64)
    t0, t1 = piece[:-1, PIECE_ROW], piece[1:, PIECE_ROW]
    bad = np.zeros(len(piece) - 1, dtype=bool)
    if rows.size:
        # a piece's table is sorted: its first and last rows bound it
        first = rows[np.minimum(t0, rows.size - 1)]
        last = rows[np.maximum(t1 - 1, 0)]
        bad |= (t1 > t0) & ((first < lo) | (last >= hi))
    direct, cell_piece = _direct_cells(plan)
    if cell_piece is not None:
        xrow = plan.cell_col.astype(np.int64) >> 7
        off = direct[cell_piece] & ((xrow < lo) | (xrow >= hi))
        bad[np.unique(cell_piece[off])] = True
    n_bad = np.bincount(piece[:-1, PIECE_RB][bad], minlength=plan.n_rb)
    return n_bad == 0


def _pad_to_local(plan: StreamCellsPlan, col: int) -> None:
    """Point every padding cell (value 0) of the direct pieces at x
    column ``col``, in place."""
    direct, cell_piece = _direct_cells(plan)
    if cell_piece is not None:
        pad = direct[cell_piece] & (plan.cell_val == 0)
        plan.cell_col[pad] = col


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

    def kernel_list(self, rbs: np.ndarray) -> np.ndarray:
        """The list K1 takes for the row blocks ``rbs``: the ids, or over
        a plan in the split form their work items."""
        if split(self.plan):
            return list_items(self.plan, rbs)
        return np.ascontiguousarray(rbs, dtype=np.int32)

    def to_torch(self, device=None) -> "ShardCellsDevice":
        return ShardCellsDevice(self).to(device)


class ShardCellsDevice(torch.nn.Module):
    """Device mirror of :class:`ShardCellsPlan`: the plan, and each kind's
    list in the form K1 takes (:meth:`ShardCellsPlan.kernel_list`)."""

    def __init__(self, p: ShardCellsPlan):
        super().__init__()
        self.plan = StreamCellsDevice(p.plan)
        self.stats = p.stats
        self.register_buffer("interior", torch.from_numpy(
            p.kernel_list(p.interior)))
        self.register_buffer("boundary", torch.from_numpy(
            p.kernel_list(p.boundary)))


def build_shard_cells(e: EhybMatrix, sh, force_boundary: bool = False,
                      cache: str = None) -> ShardCellsPlan:
    """K1's plan of the shard ``e`` (windows in ``x_ext`` coordinates, ER
    and long columns in ``[x_ext | recv]``, as :func:`~.spmv.shard_matrix`
    gives it) of the sharded matrix ``sh``, with its tail folded in, and
    its interior and boundary row blocks.  ``cache`` (None: off) is where
    ``k1_folded_plan`` reads and writes the plan (a path without its
    suffix)."""
    R, W = sh.rows_per_dev, sh.window_rows
    plan = k1_folded_plan(e, x_rows=R + 2 * W + sh.n_dev * sh.exchange_slots,
                          cache=cache, lists=True)
    _pad_to_local(plan, W)
    if sh.n_dev == 1 or force_boundary:
        interior = np.zeros(plan.n_rb, dtype=bool)
    else:
        interior = local_row_blocks(plan, W // LANES, (W + R) // LANES)
    return ShardCellsPlan(
        plan=plan, interior=np.flatnonzero(interior).astype(np.int32),
        boundary=np.flatnonzero(~interior).astype(np.int32))
