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

Two options serve a body whose columns are scattered, as the precision
mode's unordered one (``ops/dword.py``), where a table holds about one x
row per cell; the float64 kernel reads them, so they are asked for float64
values only (:func:`k1_plan`):

* **direct pieces** (``direct_below``): a piece with fewer cells than
  ``direct_below`` times its table rows keeps no table and stores each
  cell's global x column as an int32 (``cell_col``), one dependent load
  fewer a cell.  A piece is direct exactly when its table is empty and it
  has cells.
* **grouped rows** (``group_rows``): where the body is scattered, rows that
  read the same x (a k-way partition of the body's pattern into parts of
  ``group_rows`` rows, each part in RCM order) share row blocks, and the
  plan writes y through ``row_map`` (plan row → body row, a permutation).
  The grouping is kept only where it lowers the estimated 32-B sectors a
  row block moves (x read, y written).  A grouped row block's pieces are
  cut between places in its rows, as its rows come from several slices.

The arrays are the plan's only link to the padded body: the flagship frees
the padded cells on the device once the plan is uploaded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import LANES
from ..core.coo import MatrixCOO
from ..core.ehyb import EhybMatrix

#: Rows of a row block: one width, one table.
BLOCK_ROWS = 32
#: Row blocks of a slice.
RB_PER_SLICE = LANES // BLOCK_ROWS
#: Most x rows a 16-bit index addresses (slot * 128 + lane).
MAX_TABLE_ROWS = (1 << 16) // LANES
#: Body steps the builder decodes at once (bounds its numpy temporaries).
_CHUNK_STEPS = 1 << 15
#: A float64 plan's pieces with fewer cells than this a table row store
#: their columns (``direct_below``).  The bodies on the card's main paths
#: sit at 1.0-1.9 (the precision mode's permuted_poisson_512) and 27.8
#: (the flagship layout's): any value between picks the same pieces.
DIRECT_BELOW = 8.0
#: Rows of a part of a float64 plan's grouping (``group_rows``): of 32 to
#: 2,048, the fastest at permuted_poisson_512 in the precision mode
#: (``chip_k1_sweep.py --f64``: 8.85 us, against 9.22 at 512 rows).
GROUP_ROWS = 2048
#: 32-B sectors a row block writes to y in body order, and through a row
#: map (one a row): the grouping's cost in the sector estimate.
_Y_SECTORS = (BLOCK_ROWS * 8 // 32, BLOCK_ROWS)

#: Columns of the ``piece`` array.
PIECE_CELL, PIECE_ROW, PIECE_NEXT, PIECE_RB = range(4)


@dataclasses.dataclass
class StreamCellsPlan:
    """Host plan of K1 (see the module docstring).

    ``piece`` is (n_pieces + 1, 4) int32: piece p's cells are
    ``cell_val[piece[p, 0]:piece[p + 1, 0]]`` (its width is their count
    over 32), its table ``rows[piece[p, 1]:piece[p + 1, 1]]``, its row
    block's next piece ``piece[p, 2]`` (-1: none) and its row block
    ``piece[p, 3]``.  The last row is a sentinel holding the totals.  A
    cell's index is ``cell_idx`` (16 bits into its piece's table) or, in a
    piece with no table, ``cell_col`` (its x column); each array holds
    every cell where some piece reads it, else nothing.  ``row_map`` (plan
    row → body row) is empty where the plan keeps the body's row order."""

    n_slices: int
    piece: np.ndarray
    rows: np.ndarray
    cell_val: np.ndarray
    cell_idx: np.ndarray
    stats: dict
    cell_col: np.ndarray = None
    row_map: np.ndarray = None

    def __post_init__(self):
        if self.cell_col is None:
            self.cell_col = np.zeros(0, np.int32)
        if self.row_map is None:
            self.row_map = np.zeros(0, np.int32)

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
        self.register_buffer("cell_col", torch.from_numpy(
            np.ascontiguousarray(p.cell_col, dtype=np.int32)))
        self.register_buffer("row_map", torch.from_numpy(
            np.ascontiguousarray(p.row_map, dtype=np.int32)))


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


def _decode(e: EhybMatrix, s0: int, s1: int, offs: np.ndarray):
    """The real cells of slices [s0, s1) in step-major order: each one's
    body row, place in its row (step order), step, x column and value."""
    a, b = int(offs[s0]), int(offs[s1])
    val = e.ell_val[a:b]
    keep = val != 0
    st, ln = np.nonzero(keep)              # step-major: a row's cells in order
    # rank of each cell in its row (slice, lane), in step order
    cs = np.zeros((b - a + 1, LANES), np.int32)
    np.cumsum(keep, axis=0, dtype=np.int32, out=cs[1:])
    step_slice = np.repeat(np.arange(s1 - s0), np.diff(offs[s0:s1 + 1]))
    sl = step_slice[st]
    k = (cs[st + 1, ln] - cs[offs[s0:s1][sl] - a, ln] - 1).astype(np.int64)
    row = (s0 + sl) * LANES + ln
    col = decode_columns(e, a, b)[st, ln]
    return row, k, a + st, col, val[st, ln]


def _units(rb, lane, k, step, col, val, n_rb: int, n_xrows: int,
           direct_below: float):
    """Compact cells of ``n_rb`` row blocks: the units (main pieces of the
    row blocks, then their later pieces in (row block, piece) order) with
    widths, table sizes, tables, values, indices, columns and kinds, each
    later piece's row block, and the count of distinct (unit, x row)
    pairs; the columns are None where no unit is direct.  Cell i sits in
    row ``lane[i] % 32`` of row block ``rb[i]`` at place ``k[i]``; a row
    block's cells come in the order of ``step``, between whose values its
    pieces are cut."""
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
            pc = _cut_pieces(step[cells], xrow[cells])
            # a row's rank restarts in each piece
            row = lane[cells] % BLOCK_ROWS
            first = np.zeros(cells.size, np.int64)
            for p in range(1, int(pc.max()) + 1):
                in_p = pc == p
                before = np.bincount(row[pc < p], minlength=BLOCK_ROWS)
                first[in_p] = before[row[in_p]]
            k[cells] -= first
            unit[cells] = np.where(pc == 0, r, n_rb + len(extra_rb) + pc - 1)
            extra_rb += [r] * int(pc.max())
    n_units = n_rb + len(extra_rb)
    # one width per unit: its longest row
    row_cells = np.bincount(unit * BLOCK_ROWS + lane % BLOCK_ROWS,
                            minlength=n_units * BLOCK_ROWS)
    width = row_cells.reshape(n_units, BLOCK_ROWS).max(axis=1)
    start = np.zeros(n_units + 1, np.int64)
    np.cumsum(width * BLOCK_ROWS, out=start[1:])
    pos = start[unit] + k * BLOCK_ROWS + lane % BLOCK_ROWS
    # each unit's distinct x rows, sorted; a unit with fewer cells than
    # direct_below a row keeps no table and reads its columns directly
    key, inv = np.unique(unit * n_xrows + xrow, return_inverse=True)
    inv = inv.reshape(-1)
    key_unit = key // n_xrows
    t_size = np.bincount(key_unit, minlength=n_units)
    direct = (width > 0) & (width * BLOCK_ROWS
                            < direct_below * np.maximum(t_size, 1))
    t_size[direct] = 0
    in_table = ~direct[key_unit]
    t_start = np.zeros(n_units + 1, np.int64)
    np.cumsum(t_size, out=t_start[1:])
    slot = (np.cumsum(in_table) - 1)[inv] - t_start[unit]
    cell_val = np.zeros(int(start[-1]), val.dtype)
    cell_val[pos] = val
    cell_idx = np.zeros(int(start[-1]), np.uint16)
    tab = ~direct[unit]
    cell_idx[pos[tab]] = slot[tab] * LANES + (col[tab] & (LANES - 1))
    cell_col = None
    if direct.any():
        cell_col = np.zeros(int(start[-1]), np.int64)
        cell_col[pos[~tab]] = col[~tab]
    return (width, t_size, key[in_table] % n_xrows, cell_val, cell_idx,
            cell_col, direct, np.asarray(extra_rb, np.int64), int(key.size))


def _sectors(rb: np.ndarray, col: np.ndarray, n_rb: int, grouped: bool):
    """The estimated 32-B sectors a row block moves: the distinct sectors
    of x (8-B values) its cells read, and those of y it writes."""
    n_sec = int(col.max()) // 4 + 1 if col.size else 1
    reads = np.unique(rb * n_sec + col // 4).size
    return reads / max(n_rb, 1) + _Y_SECTORS[int(grouped)]


def group_order(row: np.ndarray, col: np.ndarray, n_rows: int,
                group_rows: int) -> np.ndarray:
    """Body rows in the order of a grouped plan (``new_to_old``): a k-way
    partition of the body's pattern (rows and the columns below
    ``n_rows``, as one graph) into parts of about ``group_rows`` rows, the
    parts in label order and each part's rows in RCM order."""
    from ..core.ordering import rcm_order
    from ..partition import adjacency_csr, partition_rows

    inside = col < n_rows
    m = MatrixCOO(n_rows, n_rows, row[inside], col[inside],
                  np.ones(int(inside.sum())))
    adj = adjacency_csr(m)
    labels = partition_rows(m, max(1, -(-n_rows // group_rows)), adj=adj)
    rank = np.empty(n_rows, np.int64)
    rank[rcm_order(m, adj=adj)] = np.arange(n_rows)
    return np.lexsort((rank, labels)).astype(np.int64)


def _assemble(parts, n_rb: int, val_dtype):
    """Concatenate units in the plan's order (every main piece, then every
    later piece) from ``parts``, each (main units, later units) with its
    later pieces' row blocks: piece, tables and cells."""
    main = [p[0] for p in parts]
    extra = [p[1] for p in parts]
    units = main + [x[:7] for x in extra]
    # where some unit is direct, a unit with no columns takes zeros
    if any(u[5] is not None for u in units):
        units = [u if u[5] is not None else u[:5] + (
            np.zeros(u[3].size, np.int64),) + u[6:] for u in units]
    else:
        units = [u[:5] + (np.zeros(0, np.int64),) + u[6:] for u in units]
    cat = lambda i, dt: (np.concatenate([u[i] for u in units])  # noqa: E731
                         if units else np.zeros(0, dt))
    width, t_size = cat(0, np.int64), cat(1, np.int64)
    rows, cell_val = cat(2, np.int64), cat(3, val_dtype)
    cell_idx, cell_col = cat(4, np.uint16), cat(5, np.int64)
    direct = cat(6, bool)
    x_rb = (np.concatenate([x[7] for x in extra]) if extra
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
    return piece, width, t_size, rows, cell_val, cell_idx, cell_col, direct


def _split(u, n_rb: int, x_rb_base: int):
    """One call's units as (main, later) for :func:`_assemble`."""
    width, t_size, rows, val, idx, col, direct, x_rb, _ = u
    c_main = int(width[:n_rb].sum()) * BLOCK_ROWS
    t_main = int(t_size[:n_rb].sum())
    cut = (None, None) if col is None else (col[:c_main], col[c_main:])
    return ((width[:n_rb], t_size[:n_rb], rows[:t_main], val[:c_main],
             idx[:c_main], cut[0], direct[:n_rb]),
            (width[n_rb:], t_size[n_rb:], rows[t_main:], val[c_main:],
             idx[c_main:], cut[1], direct[n_rb:], x_rb + x_rb_base))


def build_stream_cells(e: EhybMatrix, x_rows: int = None,
                       direct_below: float = 0.0,
                       group_rows: int = 0) -> StreamCellsPlan:
    """Decode the body of ``e`` once and re-encode its real cells as K1's
    compact plan.  ``x_rows`` is the length of the x the body reads
    (``e.padded_x_rows`` where None; a shard's ``x_ext`` is longer).
    ``direct_below`` and ``group_rows`` (0: off) are the scattered body's
    options of the module docstring; the float kernel reads neither."""
    offs = e.slice_offset.astype(np.int64)
    n_slices = offs.shape[0] - 1
    n_steps = int(offs[-1]) if n_slices else 0
    x_rows = e.padded_x_rows if x_rows is None else x_rows
    n_xrows = -(-x_rows // LANES)
    n_rb = RB_PER_SLICE * n_slices
    val_dtype = e.ell_val.dtype
    chunks = []
    s0 = 0
    while s0 < n_slices:
        s1 = max(int(np.searchsorted(offs, offs[s0] + _CHUNK_STEPS,
                                     side="right")) - 1, s0 + 1)
        s1 = min(s1, n_slices)
        chunks.append((s0, s1))
        s0 = s1
    parts, n_keys = [], 0
    for a, b in chunks:
        row, k, st, col, val = _decode(e, a, b, offs)
        rb0 = RB_PER_SLICE * a
        u = _units(row // BLOCK_ROWS - rb0, row, k, st, col, val,
                   RB_PER_SLICE * (b - a), n_xrows, direct_below)
        parts.append(_split(u, RB_PER_SLICE * (b - a), rb0))
        n_keys += u[-1]
    row_map = sectors = None
    n_real = sum(int(np.count_nonzero(p[0][3])) + int(np.count_nonzero(
        p[1][3])) for p in parts)
    # a body whose row blocks hold fewer cells than direct_below an x row
    # is scattered: weigh a grouping of its rows
    if group_rows and n_rb and n_real < direct_below * n_keys:
        row, k, _, col, val = (np.concatenate(a) for a in zip(
            *[_decode(e, a, b, offs) for a, b in chunks]))
        n_rows = n_rb * BLOCK_ROWS
        order = group_order(row, col, n_rows, group_rows)
        pos = np.empty(n_rows, np.int64)
        pos[order] = np.arange(n_rows)
        prow = pos[row]
        sectors = (_sectors(row // BLOCK_ROWS, col, n_rb, False),
                   _sectors(prow // BLOCK_ROWS, col, n_rb, True))
        if sectors[1] < sectors[0]:
            row_map = order
            # a row block's cells by place: its pieces cut between places
            o = np.argsort(k, kind="stable")
            parts = [_split(_units(
                prow[o] // BLOCK_ROWS, prow[o], k[o], k[o], col[o], val[o],
                n_rb, n_xrows, direct_below), n_rb, 0)]
        del row, k, col, val, prow
    piece, width, t_size, rows, cell_val, cell_idx, cell_col, direct = \
        _assemble(parts, n_rb, val_dtype)
    n_pieces = len(piece) - 1
    n_cells = int(piece[-1, PIECE_CELL])
    if n_cells >= 2 ** 31 or rows.size >= 2 ** 31 or \
            (cell_col.size and cell_col.max() >= 2 ** 31):
        raise ValueError("K1 plan too large for int32 maps")
    n_direct = int((width[direct] * BLOCK_ROWS).sum())
    # each index array holds every cell where some piece reads it
    if not direct.any():
        cell_col = np.zeros(0, np.int64)
    if direct[width > 0].all():
        cell_idx = np.zeros(0, np.uint16)
    cell_bytes = n_cells * cell_val.itemsize + 2 * (n_cells - n_direct) \
        + 4 * n_direct
    map_bytes = piece.size * 4 + rows.size * 4 \
        + (0 if row_map is None else 4 * row_map.size)
    x_bytes = x_rows * cell_val.itemsize
    y_bytes = n_slices * LANES * cell_val.itemsize
    stats = dict(
        n_rb=n_rb, n_pieces=n_pieces,
        split_rbs=int(np.unique(piece[n_rb:n_pieces, PIECE_RB]).size),
        real_cells=n_real, compact_cells=n_cells,
        padded_cells=n_steps * LANES,
        max_width=int(width.max()) if width.size else 0,
        # the most cells a row takes over its pieces (the places of the
        # compensated plain version)
        max_row_cells=int(np.bincount(piece[:n_pieces, PIECE_RB],
                                      weights=width).max())
        if n_pieces else 0,
        table_rows=int(rows.size),
        max_table_rows=int(t_size.max()) if t_size.size else 0,
        direct_pieces=int(direct.sum()), direct_cells=n_direct,
        grouped=row_map is not None,
        # the estimated 32-B sectors a row block moves, in body order and
        # grouped (where a grouping was weighed)
        sectors_per_rb=sectors,
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
        cell_idx=cell_idx.view(np.int16), stats=stats,
        cell_col=cell_col.astype(np.int32),
        row_map=None if row_map is None else row_map.astype(np.int32))


def k1_plan(e: EhybMatrix, x_rows: int = None) -> StreamCellsPlan:
    """K1's plan of a flagship or precision-mode body: float64 values take
    direct pieces and grouped rows where the body is scattered (the float64
    kernel reads them), float32 values the table form alone."""
    if e.ell_val.dtype == np.float64:
        return build_stream_cells(e, x_rows, DIRECT_BELOW, GROUP_ROWS)
    return build_stream_cells(e, x_rows)
