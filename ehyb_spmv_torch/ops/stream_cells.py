"""The host plan of the streamed SELL body kernel (K1): compact cells.

The TPU's K1 reads the body as the host layer packs it: 128-lane width
steps of window-local (``sell_mw``) or relaxed lo-slot (``sell_rx``)
columns, padded to each slice's width and, in the relaxed layouts, to what
two-stage gathers can address (50% of the cells at permuted_poisson_512,
76% at permuted_poisson_4096).  A GPU thread can read x at any index, so
:func:`build_stream_cells` decodes every body cell once, keeps only the
real ones and re-encodes them for ``csrc/ehyb_stream.cu``:

* rows in blocks of 32 (a slice holds 4), each block with one width, its
  longest row; cell k of row r at ``cell0 + 32 k + r`` (column-major, so a
  warp's loads coalesce), a row's cells in step order, so the sums equal
  the padded body's bit for bit for finite x (the dropped cells are zeros);
* each cell a value (the body's own type: float32, or float64 in the
  precision mode) and a 16-bit index ``slot * 128 + lane`` into the block's
  table of x rows (128 values each, sorted): the paper's window-local int16
  column;
* a row block whose cells touch more x rows than 16 bits address (512) is
  cut, between its steps, into pieces, each with a table of its own.
  Piece i < n_rb is row block i's first; the later pieces of a row block
  follow the main ones, chained by ``next``.

The arrays are the plan's only link to the padded body: the flagship frees
the padded cells on the device once the plan is uploaded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import LANES
from ..core.ehyb import EhybMatrix

#: Rows of a row block: one width, one table.
BLOCK_ROWS = 32
#: Row blocks of a slice.
RB_PER_SLICE = LANES // BLOCK_ROWS
#: Most x rows a 16-bit index addresses (slot * 128 + lane).
MAX_TABLE_ROWS = (1 << 16) // LANES
#: Body steps the builder decodes at once (bounds its numpy temporaries).
_CHUNK_STEPS = 1 << 15

#: Columns of the ``piece`` array.
PIECE_CELL, PIECE_ROW, PIECE_NEXT, PIECE_RB = range(4)


@dataclasses.dataclass
class StreamCellsPlan:
    """Host plan of K1 (see the module docstring).

    ``piece`` is (n_pieces + 1, 4) int32: piece p's cells are
    ``cell_val/cell_idx[piece[p, 0]:piece[p + 1, 0]]`` (its width is their
    count over 32), its table ``rows[piece[p, 1]:piece[p + 1, 1]]``, its
    row block's next piece ``piece[p, 2]`` (-1: none) and its row block
    ``piece[p, 3]``.  The last row is a sentinel holding the totals."""

    n_slices: int
    piece: np.ndarray
    rows: np.ndarray
    cell_val: np.ndarray
    cell_idx: np.ndarray
    stats: dict

    @property
    def n_rb(self) -> int:
        return RB_PER_SLICE * self.n_slices

    def to_torch(self, device=None) -> "StreamCellsDevice":
        return StreamCellsDevice(self).to(device)


class StreamCellsDevice(torch.nn.Module):
    """Device mirror of :class:`StreamCellsPlan`: its arrays as buffers,
    its sizes as host ints (the plain version reads no device scalar, so it
    can be captured in a CUDA graph)."""

    def __init__(self, p: StreamCellsPlan):
        super().__init__()
        self.n_slices = p.n_slices
        self.n_rb = p.n_rb
        self.n_pieces = len(p.piece) - 1
        self.n_cells = int(p.piece[-1, PIECE_CELL])
        self.stats = dict(p.stats)
        self.register_buffer("piece", torch.from_numpy(
            np.ascontiguousarray(p.piece, dtype=np.int32)))
        self.register_buffer("rows", torch.from_numpy(
            np.ascontiguousarray(p.rows, dtype=np.int32)))
        self.register_buffer("cell_val", torch.from_numpy(p.cell_val))
        self.register_buffer("cell_idx", torch.from_numpy(p.cell_idx))


def decode_columns(e: EhybMatrix, a: int, b: int) -> np.ndarray:
    """(b - a, 128) global x column of every cell of steps [a, b): the
    decoding of ``ops/torch_ops.py::body_gather_index`` (plain window-local
    columns, or the lo-slot layout whose ``(sel, hi)`` bits sit at lane
    ``lo`` of the same step)."""
    idx = e.ell_col[a:b].astype(np.int64)
    if not e.step_win_b.size:
        return e.step_win[a:b, None].astype(np.int64) + idx
    lo = idx & (LANES - 1)
    attr = np.take_along_axis(idx, lo, axis=1)
    sel = attr >> 10
    base = np.where(sel == 1, e.step_win_b[a:b, None],
                    e.step_win[a:b, None]).astype(np.int64)
    if e.step_win_c.size:
        base = np.where(sel == 2, e.step_win_c[a:b, None], base)
        base = np.where(sel == 3, e.step_win_d[a:b, None], base)
    return base + ((attr >> 7) & 7) * LANES + lo


def _cut_pieces(step: np.ndarray, xrow: np.ndarray):
    """Piece number of each cell of one row block (cells in step order):
    greedy over its steps, a piece closes where the next step's x rows
    would take its table past ``MAX_TABLE_ROWS``."""
    piece = np.zeros(step.size, np.int64)
    cur: set = set()
    n = 0
    bounds = np.flatnonzero(np.diff(step)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, step.size]):
        new = set(xrow[lo:hi].tolist())
        if cur and len(cur | new) > MAX_TABLE_ROWS:
            n += 1
            cur = set()
        cur |= new
        piece[lo:hi] = n
    return piece


def _chunk(e: EhybMatrix, s0: int, s1: int, offs: np.ndarray, n_xrows: int):
    """Compact cells of slices [s0, s1): the units (main pieces of the
    chunk's row blocks, then their later pieces in (row block, piece)
    order) with widths, table sizes, tables and cells, and each later
    piece's row block (chunk-local)."""
    a, b = int(offs[s0]), int(offs[s1])
    n_rb = RB_PER_SLICE * (s1 - s0)
    val = e.ell_val[a:b]
    keep = val != 0
    st, ln = np.nonzero(keep)              # step-major: a row's cells in order
    # rank of each cell in its row (slice, lane), in step order
    cs = np.zeros((b - a + 1, LANES), np.int32)
    np.cumsum(keep, axis=0, dtype=np.int32, out=cs[1:])
    step_slice = np.repeat(np.arange(s1 - s0), np.diff(offs[s0:s1 + 1]))
    sl = step_slice[st]
    k = (cs[st + 1, ln] - cs[offs[s0:s1][sl] - a, ln] - 1).astype(np.int64)
    rb = sl * RB_PER_SLICE + ln // BLOCK_ROWS
    col = decode_columns(e, a, b)[st, ln]
    xrow = col >> 7
    # distinct x rows per row block; past 16 bits the block is cut
    ukey = np.unique(rb * n_xrows + xrow)
    n_distinct = np.bincount(ukey // n_xrows, minlength=n_rb)
    unit = rb.copy()
    extra_rb = []
    over = np.flatnonzero(n_distinct > MAX_TABLE_ROWS)
    if over.size:
        order = np.argsort(rb, kind="stable")
        starts = np.searchsorted(rb[order], over, side="left")
        ends = np.searchsorted(rb[order], over, side="right")
        for j, r in enumerate(over):
            cells = order[starts[j]:ends[j]]
            pc = _cut_pieces(st[cells], xrow[cells])
            # a row's rank restarts in each piece
            row = ln[cells]
            first = np.zeros(cells.size, np.int64)
            for p in range(1, int(pc.max()) + 1):
                in_p = pc == p
                before = np.bincount(row[pc < p], minlength=LANES)
                first[in_p] = before[row[in_p]]
            k[cells] -= first
            unit[cells] = np.where(pc == 0, r, n_rb + len(extra_rb) + pc - 1)
            extra_rb += [r] * int(pc.max())
    n_units = n_rb + len(extra_rb)
    # one width per unit: its longest row
    row_cells = np.bincount(unit * BLOCK_ROWS + ln % BLOCK_ROWS,
                            minlength=n_units * BLOCK_ROWS)
    width = row_cells.reshape(n_units, BLOCK_ROWS).max(axis=1)
    start = np.zeros(n_units + 1, np.int64)
    np.cumsum(width * BLOCK_ROWS, out=start[1:])
    pos = start[unit] + k * BLOCK_ROWS + ln % BLOCK_ROWS
    # each unit's table: its distinct x rows, sorted
    key, inv = np.unique(unit * n_xrows + xrow, return_inverse=True)
    key_unit = key // n_xrows
    t_size = np.bincount(key_unit, minlength=n_units)
    t_start = np.zeros(n_units + 1, np.int64)
    np.cumsum(t_size, out=t_start[1:])
    slot = inv.reshape(-1) - t_start[unit]
    cell_val = np.zeros(int(start[-1]), e.ell_val.dtype)
    cell_val[pos] = val[st, ln]
    cell_idx = np.zeros(int(start[-1]), np.uint16)
    cell_idx[pos] = slot * LANES + (col & (LANES - 1))
    return (width, t_size, key % n_xrows, cell_val, cell_idx,
            np.asarray(extra_rb, np.int64), int(st.size))


def build_stream_cells(e: EhybMatrix, x_rows: int = None) -> StreamCellsPlan:
    """Decode the body of ``e`` once and re-encode its real cells as K1's
    compact plan.  ``x_rows`` is the length of the x the body reads
    (``e.padded_x_rows`` where None; a shard's ``x_ext`` is longer)."""
    offs = e.slice_offset.astype(np.int64)
    n_slices = offs.shape[0] - 1
    n_steps = int(offs[-1]) if n_slices else 0
    x_rows = e.padded_x_rows if x_rows is None else x_rows
    n_xrows = -(-x_rows // LANES)
    main, extra = [], []
    n_real = 0
    s0 = 0
    while s0 < n_slices:
        s1 = max(int(np.searchsorted(offs, offs[s0] + _CHUNK_STEPS,
                                     side="right")) - 1, s0 + 1)
        s1 = min(s1, n_slices)
        width, t_size, rows, val, idx, x_rb, n = _chunk(
            e, s0, s1, offs, n_xrows)
        n_rb = RB_PER_SLICE * (s1 - s0)
        c_main = int(width[:n_rb].sum()) * BLOCK_ROWS
        t_main = int(t_size[:n_rb].sum())
        main.append((width[:n_rb], t_size[:n_rb], rows[:t_main],
                     val[:c_main], idx[:c_main]))
        extra.append((width[n_rb:], t_size[n_rb:], rows[t_main:],
                      val[c_main:], idx[c_main:],
                      x_rb + RB_PER_SLICE * s0))
        n_real += n
        s0 = s1
    parts = main + [x[:5] for x in extra]
    cat = lambda i, dt: (np.concatenate([p[i] for p in parts])  # noqa: E731
                         if parts else np.zeros(0, dt))
    width, t_size = cat(0, np.int64), cat(1, np.int64)
    rows, cell_val = cat(2, np.int64), cat(3, e.ell_val.dtype)
    cell_idx = cat(4, np.uint16)
    n_rb = RB_PER_SLICE * n_slices
    x_rb = (np.concatenate([x[5] for x in extra]) if extra
            else np.zeros(0, np.int64))
    n_pieces = n_rb + x_rb.size
    piece = np.zeros((n_pieces + 1, 4), np.int64)
    np.cumsum(width * BLOCK_ROWS, out=piece[1:, PIECE_CELL])
    np.cumsum(t_size, out=piece[1:, PIECE_ROW])
    piece[:n_rb, PIECE_RB] = np.arange(n_rb)
    piece[n_rb:n_pieces, PIECE_RB] = x_rb
    piece[n_pieces, PIECE_RB] = -1
    piece[:, PIECE_NEXT] = -1
    # chain each row block's later pieces (in order) behind its main piece
    last = np.arange(n_rb)
    for j, r in enumerate(x_rb.tolist()):
        piece[last[r], PIECE_NEXT] = n_rb + j
        last[r] = n_rb + j
    n_cells = int(piece[-1, PIECE_CELL])
    if n_cells >= 2 ** 31 or rows.size >= 2 ** 31:
        raise ValueError("K1 plan too large for int32 maps")
    cell_bytes = n_cells * (cell_val.itemsize + 2)
    map_bytes = piece.size * 4 + rows.size * 4
    x_bytes = x_rows * cell_val.itemsize
    y_bytes = n_slices * LANES * cell_val.itemsize
    stats = dict(
        n_rb=n_rb, n_pieces=n_pieces, split_rbs=int(np.unique(x_rb).size),
        real_cells=n_real, compact_cells=n_cells,
        padded_cells=n_steps * LANES,
        max_width=int(width.max()) if width.size else 0,
        table_rows=int(rows.size),
        max_table_rows=int(t_size.max()) if t_size.size else 0,
        cell_bytes=cell_bytes, map_bytes=map_bytes,
        # what the plan itself streams per call: cells, pieces and tables
        stream_bytes=cell_bytes + map_bytes,
        body_bytes=n_steps * LANES * (e.ell_col.dtype.itemsize
                                      + cell_val.itemsize),
        x_rows=x_rows, x_bytes=x_bytes, y_bytes=y_bytes,
        # what the kernel moves: the plan, x once and y once
        layout_bytes=cell_bytes + map_bytes + x_bytes + y_bytes)
    return StreamCellsPlan(
        n_slices=n_slices, piece=piece.astype(np.int32),
        rows=rows.astype(np.int32), cell_val=cell_val,
        cell_idx=cell_idx.view(np.int16), stats=stats)

