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
values only (:func:`k1_options`):

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

A third option serves a heavy-tailed body, whose hub rows make some row
blocks far wider than the rest; every K1 variant reads it
(:func:`k1_options` takes it for float32 and float64 values, with or
without compensation, over any of the forms above):

* **the split form** (``split_steps``): a row block wider than
  ``split_steps`` steps (the sum of its pieces' widths) is cut into pieces
  of at most ``split_steps`` steps each (each with its table, or direct),
  and its chain into **chunks**: runs of consecutive pieces of at most
  ``split_steps`` steps.  Each chunk is a work item of its own and sums
  its 32 rows into a partial (one slot of 32 values, or of 32 (sum,
  compensation) pairs); the row block's partials are then added in chunk
  order into y (through the row map, where there is one).  Every other
  row block is one work item, summed into y as before.  The work items
  are ordered longest first (``item``), so the kernel's persistent grid
  does not end on a tail.  A body with no row block wider than
  ``split_steps`` gets the plan it gets without the option, byte for
  byte.  A list over a plan in this form (the sharded apply's interior and
  boundary row blocks) is a list of work items, :func:`list_items`: the
  listed row blocks' items, every chunk of a chunked one among them, so
  the last of its chunks to finish adds its partials into y as in a full
  call.

A body too small to fill the card with the split form's items takes its
**small form** (``small_steps``, ``hub_steps``; :func:`k1_options` asks for
it, and :func:`small_form_wanted` is the rule that grants it): where the
split form would chunk some row block, in chunks longer than the small
form's rows (``split_steps > small_steps``), and gives the card no more
than ``SMALL_WAVE_SHARE`` of a wave of work items (``WAVE_WARPS``):

* **hub rows laid out apart**: every row with more than ``small_steps``
  cells leaves its row block; its cells are stored row-major in
  ``hub_val``/``hub_col`` (int32 columns), padded with zeros to a
  multiple of 32, so a warp reads 32 consecutive entries of it a step.
  The row blocks keep the other rows' cells at their own width (at most
  ``small_steps`` steps), in any piece form above, each one work item
  (``item``: slot -1, and in its fourth field the mask of its lanes that
  are hubs, which it does not write);
* **short hub items**: a hub's steps in chunks of ``hub_steps``, each a
  work item (``hub_item``: first cell, steps, partial slot or -1, hub);
  a lane sums
  its entries of the chunk in order, the warp's 32 lane sums meet in a
  fixed shuffle tree, and a hub's chunk partials (slots
  ``hub_first[h]:hub_first[h + 1]``) are folded by the last chunk to
  finish: lane l adds slots l, l + 32, ... in order, then the same tree
  (``csrc/ehyb_stream.cu`` writes the order out).  The plan's y row of
  hub h is ``hub_row[h]``.

A plan in the small form is also in the split form (:func:`split`: it has
work items, none chunked); :func:`small` tells it apart.  It takes no list.

The flagship's plan also **folds the EHYB tail** (``fold``,
:func:`k1_folded_plan`): every entry the apply would otherwise add around
K1 becomes a cell of its true row, after the row's body cells, so K1
computes the body, the ER tail, the long rows and the hub-split rows into
one y, and K9 then adds the diagonals into it (``ops/ehyb_stream.py``).
A row's cells then run: its body cells in step order, the cells of the
overflow rows that ``split_src`` maps to it (``split_dst``; in split
order, each in step order), its ER entries (``er_val``/``er_col`` by
``er_rows``, in ER step order; padding lanes and the dump row dropped) and
its long-row entries (``long_val``/``long_col`` by ``long_seg``, in stream
order).  The overflow rows themselves keep no cell, so K1 writes them 0.
The appended cells take the piece forms above like any other, and a row
block their tail makes wider than ``split_steps`` the split form.  An
artifact with no tail gets the plan it gets without the option, byte for
byte; one with an empty body and a tail a plan of its tail alone.

The arrays are the plan's only link to the padded body: the flagship frees
the padded cells on the device once the plan is uploaded.  Where the
artifact cache is on, the flagship's plan is cached beside the artifact
(:func:`k1_folded_plan`'s ``cache``), so a cached setup loads it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..config import LANES
from ..core.coo import MatrixCOO
from ..core.ehyb import EhybMatrix
from ..utils.log import get_logger

log = get_logger(__name__)

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
#: A float32 plan's row blocks wider than this many steps take the split
#: form (``split_steps``), in chunks of at most as many, with or without
#: compensation (the compensated variant reads the same plan).  Not below
#: the flagship float bodies' widest row block (4 steps at
#: permuted_poisson_512, 46 at random_16k), so their plans stay as they
#: are; of 48 to 128 the one whose times over the fastest at powerlaw_1m's
#: dense body and powerlaw_16k's body sum the least (``chip_k1_sweep.py
#: --long``: 185.4 and 12.8 us against the fastest 155.7 and 12.7; a
#: chunk's walk is what powerlaw_16k waits for, and more chunks cost
#: powerlaw_1m).
SPLIT_STEPS = 48
#: A float64 plan's row blocks wider than this many steps take the split
#: form, in chunks of at most as many, with or without compensation.  Not
#: below the float64 bodies' widest row block on the card's paths (78
#: steps at fem3d_68_audikw_class --dword, 46 at random_16k --dtype
#: float64, 4 at permuted_poisson_512 in either mode), so their plans stay
#: as they are; of 80, 96 and 128 the one whose times over the fastest at
#: powerlaw_16k (--dword, --dtype float64 with and without --compensated)
#: and powerlaw_1m (--dword, --dtype float64) sum the least
#: (``chip_k1_sweep.py --long --f64``; PERF.md has the readings).  A whole
#: row block up to this width is walked by one warp, which is what
#: powerlaw_16k waits for; longer chunks cost powerlaw_1m fewer partials.
SPLIT_STEPS_F64 = 80
#: The small form's row threshold: a row with more cells is a hub, laid
#: out apart; the row blocks then hold at most this many steps.  With
#: ``HUB_STEPS``, a hub chunk's steps, chosen by ``chip_k1_sweep.py
#: --small`` at powerlaw_16k in five configs: of 16, 32 and 40 cells x
#: chunks of 8, 16 and 32 steps, the least sum of the times over the
#: fastest (PERF.md).  Fewer, longer items won: each hub chunk past a
#: hub's first costs a partial, a fence and an atomic.
SMALL_STEPS = 40
HUB_STEPS = 32
#: Resident warps of one wave on the card the port is tuned on (an H100's
#: 132 SMs at the split variants' 32 resident warps an SM in float64).
WAVE_WARPS = 132 * 32
#: The small form is taken where the split form's work items fill at most
#: this share of ``WAVE_WARPS``.
SMALL_WAVE_SHARE = 0.5
#: 32-B sectors a row block writes to y in body order, and through a row
#: map (one a row): the grouping's cost in the sector estimate.
_Y_SECTORS = (BLOCK_ROWS * 8 // 32, BLOCK_ROWS)

#: Bump on any change to the plans :func:`build_stream_cells` makes: a
#: cached plan (:func:`k1_folded_plan`'s ``cache``) is the builder's
#: output, keyed by its inputs.
PLAN_VERSION = 2

#: Columns of the ``piece`` array.
PIECE_CELL, PIECE_ROW, PIECE_NEXT, PIECE_RB = range(4)
#: Columns of the ``item`` array (the split form's work items; in the
#: small form the fourth holds the item's hub lanes).
ITEM_PIECE, ITEM_PIECES, ITEM_SLOT, ITEM_CHUNKED = range(4)
#: Columns of the ``hub_item`` array (the small form's hub chunks).
HUB_CELL, HUB_STEPS_COL, HUB_SLOT, HUB_ID = range(4)


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
    row → body row) is empty where the plan keeps the body's row order.

    The split form's arrays are empty where no row block was chunked.
    ``item`` is (n_items, 4) int32, longest first: a work item's first
    piece, its count of pieces (walked through ``next``), its partial slot
    (-1: a whole row block, summed into y) and its chunked row block's
    number (-1 likewise).  Chunked row block i has the slots
    ``chunk_first[i]:chunk_first[i + 1]``, in chunk order, and is row block
    ``chunk_rb[i]``; ``piece_slot`` is each piece's slot (-1: none).

    The small form's arrays are empty in every other plan: hub h's cells
    ``hub_val``/``hub_col[hub_cell[h]:hub_cell[h + 1]]`` (row-major, 32 a
    step), its slots ``hub_first[h]:hub_first[h + 1]`` (none: one chunk),
    its plan row ``hub_row[h]``.  The small form's ``item`` and ``hub_item``
    are (n, 8) int32: the first four columns as above (``HUB_*`` for a
    hub item), then what the kernel reads with them (a row block's cells
    and table; a hub's slots and y row)."""

    n_slices: int
    piece: np.ndarray
    rows: np.ndarray
    cell_val: np.ndarray
    cell_idx: np.ndarray
    stats: dict
    cell_col: np.ndarray = None
    row_map: np.ndarray = None
    item: np.ndarray = None
    chunk_first: np.ndarray = None
    chunk_rb: np.ndarray = None
    piece_slot: np.ndarray = None
    hub_val: np.ndarray = None
    hub_col: np.ndarray = None
    hub_cell: np.ndarray = None
    hub_first: np.ndarray = None
    hub_row: np.ndarray = None
    hub_item: np.ndarray = None

    def __post_init__(self):
        for name in ("cell_col", "row_map", "chunk_first", "chunk_rb",
                     "piece_slot", "hub_col", "hub_cell", "hub_first",
                     "hub_row"):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(0, np.int32))
        if self.hub_val is None:
            self.hub_val = np.zeros(0, self.cell_val.dtype)
        for name in ("item", "hub_item"):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros((0, 4), np.int32))

    @property
    def n_rb(self) -> int:
        return RB_PER_SLICE * self.n_slices

    def to_torch(self, device=None) -> "StreamCellsDevice":
        return StreamCellsDevice(self).to(device)

    def save(self, path: str) -> None:
        """Write the plan to ``path`` (an uncompressed ``.npz``), through a
        temporary file, so that a reader sees the whole plan or none."""
        arrays = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)
                  if f.name not in ("n_slices", "stats")}
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, n_slices=self.n_slices, stats_json=json.dumps(
            self.stats, default=lambda v: v.item()), **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "StreamCellsPlan":
        """The plan :meth:`save` wrote to ``path``."""
        with np.load(path) as z:
            kw = {k: z[k] for k in z.files if k not in ("n_slices",
                                                         "stats_json")}
            return cls(n_slices=int(z["n_slices"]),
                       stats=json.loads(str(z["stats_json"])), **kw)


class StreamCellsDevice(torch.nn.Module):
    """Device mirror of :class:`StreamCellsPlan`: its arrays as buffers,
    its sizes as host ints (the plain version reads no device scalar, so it
    can be captured in a CUDA graph).  A split plan also holds the kernel's
    workspace: ``partial`` (two slots of 32 values a chunk: the plain
    variants fill the first half, the compensated ones a chunk's sums and
    compensations in slots 2 s and 2 s + 1; in the small form a hub
    chunk's sum and compensation at 2 s and 2 s + 1) and ``counter`` (one
    a chunked row block, or a hub in the small form, 0 between calls: the
    last chunk of a row block or hub to finish adds its partials into y and
    puts it back), so two calls over one plan must not run at once."""

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
        self.n_items = len(p.item)
        self.n_chunked = len(p.chunk_rb)
        self.n_chunks = int(p.chunk_first[-1]) if self.n_chunked else 0
        #: The most chunks a row block has (the compensated plain version's
        #: passes over the partials).
        self.max_chunks = int(np.diff(p.chunk_first).max()) \
            if self.n_chunked else 0
        for name in ("item", "chunk_first", "chunk_rb", "piece_slot",
                     "hub_col", "hub_cell", "hub_first", "hub_row",
                     "hub_item"):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(getattr(p, name), dtype=np.int32)))
        self.register_buffer("hub_val", torch.from_numpy(
            np.ascontiguousarray(p.hub_val)))
        #: The small form's sizes: hubs, hub items, partial slots, the
        #: longest hub chunk's steps, the widest fold's partials.
        self.n_hubs = len(p.hub_row)
        self.n_hub_items = len(p.hub_item)
        self.n_hub_slots = int(p.hub_first[-1]) if self.n_hubs else 0
        self.n_hub_cells = len(p.hub_val)
        self.hub_steps = int(p.hub_item[:, HUB_STEPS_COL].max()) \
            if self.n_hub_items else 0
        self.max_fold = int(np.diff(p.hub_first).max()) if self.n_hubs \
            else 0
        self.register_buffer("partial", torch.zeros(
            2 * (self.n_chunks * BLOCK_ROWS + self.n_hub_slots),
            dtype=self.cell_val.dtype))
        self.register_buffer("counter", torch.zeros(
            self.n_chunked + self.n_hubs, dtype=torch.int32))


def split(p) -> bool:
    """Whether plan ``p`` (host or device) is in the split form (the small
    form among it)."""
    return len(p.item) > 0


def small(p) -> bool:
    """Whether plan ``p`` (host or device) is in the split form's small
    form: hub rows laid out apart."""
    return len(p.hub_item) > 0


def list_items(p: StreamCellsPlan, rbs) -> np.ndarray:
    """The work items of the row blocks ``rbs`` of plan ``p`` (in the
    split form): the rows of ``p.item`` whose row block is listed, in the
    plan's order (longest first), a chunked row block's every chunk among
    them.  It is the list the split variants take where the table form's
    take ``rbs``.  A plan in the small form takes no list: raises."""
    if small(p):
        raise ValueError("a plan in the small form takes no list: build a "
                         "listed plan with k1_options(e, lists=True)")
    rb = p.piece[p.item[:, ITEM_PIECE], PIECE_RB]
    return np.ascontiguousarray(p.item[np.isin(rb, rbs)], dtype=np.int32)


def _stable_order(key: np.ndarray) -> np.ndarray:
    """``np.argsort(key, kind="stable")`` of non-negative integer keys:
    where ``key * n + i`` fits in int64, a sort of those values (numpy
    sorts int64 values several times faster than it argsorts them)."""
    n = key.size
    if n and int(key.max()) < np.iinfo(np.int64).max // n - 1:
        return np.sort(key.astype(np.int64) * n + np.arange(n)) % n
    return np.argsort(key, kind="stable")


def _unique_first(key: np.ndarray):
    """The sorted distinct values of ``key`` (non-negative integers), the
    index of each one's first occurrence, and each element's index into
    them: ``np.unique(key, return_index=True, return_inverse=True)``."""
    o = _stable_order(key)
    s = key[o]
    new = np.empty(s.size, bool)
    new[:1] = True
    np.not_equal(s[1:], s[:-1], out=new[1:])
    inv = np.empty(s.size, np.int64)
    inv[o] = np.cumsum(new) - 1
    return s[new], o[new], inv


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


def _cut_pieces(step: np.ndarray, xrow: np.ndarray, max_steps: int = 0,
                group: np.ndarray = None):
    """Piece number of each cell of row blocks ``group`` (0, 1, ...; None:
    one row block), each block's cells in step order and the blocks one
    after another: greedy over a block's steps, a piece closes where the
    next step's x rows would take its table past ``MAX_TABLE_ROWS``, or
    where it holds ``max_steps`` steps (0: no such limit).  Every block's
    next piece is found at once in numpy, over a window of steps from its
    start that doubles until the piece ends inside it."""
    if not step.size:
        return np.zeros(0, np.int64)
    g = np.zeros(step.size, np.int64) if group is None else group
    sb = np.r_[np.flatnonzero(np.r_[True, (step[1:] != step[:-1])
                                    | (g[1:] != g[:-1])]), step.size]
    # each block's steps: sb[first[b]:first[b + 1]] (its cells' offsets)
    n_blocks = int(g[-1]) + 1
    first = np.searchsorted(g[sb[:-1]], np.arange(n_blocks + 1))
    n_x = int(xrow.max()) + 1
    piece = np.zeros(step.size, np.int64)
    cur, n = first[:-1].copy(), np.zeros(n_blocks, np.int64)
    w0 = max_steps or 64
    win = np.full(n_blocks, w0, np.int64)
    act = np.flatnonzero(cur < first[1:])
    while act.size:
        s, end = cur[act], first[act + 1]
        lim = np.minimum(end, s + max_steps) if max_steps else end
        e = np.minimum(lim, s + win[act])
        c0, cnt = sb[s], sb[e] - sb[s]
        at = np.cumsum(cnt) - cnt
        idx = np.repeat(c0 - at, cnt) + np.arange(int(cnt.sum()))
        w = np.repeat(np.arange(act.size), cnt)
        # the x rows each window has seen so far, in cell order
        new = np.zeros(idx.size, np.int64)
        new[_unique_first(w * n_x + xrow[idx])[1]] = 1
        seen = np.cumsum(new)
        seen -= (seen[at] - new[at])[w]
        p = np.flatnonzero(seen > MAX_TABLE_ROWS)
        # the step holding a window's first x row past the table closes it
        p = p[np.r_[True, w[p][1:] != w[p][:-1]]] if p.size else p
        close = np.where(e == lim, e, -1)
        close[w[p]] = np.searchsorted(sb, idx[p], side="right") - 1
        done = close >= 0
        mine = done[w] & (idx < sb[np.maximum(close, 0)][w])
        piece[idx[mine]] = n[act][w[mine]]
        a = act[done]
        n[a] += 1
        cur[a] = close[done]
        win[a] = w0
        win[act[~done]] *= 2
        act = act[cur[act] < first[act + 1]]
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


def _tail(e: EhybMatrix, offs: np.ndarray, n_rows: int):
    """The cells the fold appends (see the module docstring), each as (true
    row, x column, value), sorted by row and in a row's order: the
    hub-split overflow rows' body cells, the ER entries, the long-row
    entries; and a mask of the overflow rows (None where there are none).
    Zero values are dropped, as the body's padding is."""
    rows, cols, vals = [], [], []
    is_src = None
    if e.split_src.size:
        src = e.split_src.astype(np.int64)
        owner = np.full(n_rows, -1, np.int64)
        owner[src] = np.arange(src.size)
        is_src = owner >= 0
        s0, s1 = int(src.min()) // LANES, int(src.max()) // LANES + 1
        row, k, _, col, val = _decode(e, s0, s1, offs)
        mine = owner[row]
        sel = mine >= 0
        # each overflow row's cells in step order, the rows in split order
        o = np.lexsort((k[sel], mine[sel]))
        rows.append(e.split_dst.astype(np.int64)[mine[sel][o]])
        cols.append(col[sel][o])
        vals.append(val[sel][o])
    if e.er_val.size:
        er_offs = e.er_slice_offset.astype(np.int64)
        st, ln = np.nonzero(e.er_val[:int(er_offs[-1])] != 0)
        step_slice = np.repeat(np.arange(er_offs.size - 1), np.diff(er_offs))
        row = e.er_rows.astype(np.int64)[step_slice[st] * e.er_val.shape[1]
                                         + ln]
        keep = row < e.dim                    # the dump row: padding lanes
        rows.append(row[keep])
        cols.append(e.er_col[st, ln][keep].astype(np.int64))
        vals.append(e.er_val[st, ln][keep])
    if e.long_val.size:
        keep = e.long_val != 0
        rows.append(e.long_rows.astype(np.int64)[e.long_seg[keep]])
        cols.append(e.long_col[keep].astype(np.int64))
        vals.append(e.long_val[keep])
    if not rows:
        return None, is_src
    row = np.concatenate(rows)
    o = _stable_order(row)
    return (row[o], np.concatenate(cols)[o],
            np.concatenate(vals).astype(e.ell_val.dtype)[o]), is_src


def _fold_span(cells, tail, is_src, r0: int, r1: int, n_steps: int):
    """A span's decoded body cells (``_decode``: rows in [r0, r1)) with the
    tail folded in: the overflow rows' cells dropped (``is_src``), and the
    tail's cells of these rows appended at the places after each row's
    body cells, ordered by place; a tail cell's step is ``n_steps`` plus
    its place, so a row block's pieces are cut between places there."""
    row, k, st, col, val = cells
    if is_src is not None:
        keep = ~is_src[row]
        row, k, st, col, val = row[keep], k[keep], st[keep], col[keep], \
            val[keep]
    if tail is None:
        return row, k, st, col, val
    t_row, t_col, t_val = tail
    lo, hi = np.searchsorted(t_row, (r0, r1))
    if lo == hi:
        return row, k, st, col, val
    t_row, t_col, t_val = t_row[lo:hi], t_col[lo:hi], t_val[lo:hi]
    n = hi - lo
    count = np.bincount(row - r0, minlength=r1 - r0)
    first = np.r_[0, np.flatnonzero(np.diff(t_row)) + 1]
    rank = np.arange(n) - np.repeat(first, np.diff(np.r_[first, n]))
    t_k = count[t_row - r0] + rank
    o = _stable_order(t_k)
    return (np.concatenate([row, t_row[o]]), np.concatenate([k, t_k[o]]),
            np.concatenate([st, n_steps + t_k[o]]),
            np.concatenate([col, t_col[o]]), np.concatenate([val, t_val[o]]))


def _widths(rb, row, pc, n_rb: int) -> np.ndarray:
    """Each row block's width: the sum over its pieces (cell i in piece
    ``pc[i]`` of row block ``rb[i]``, row ``row[i]``) of their longest
    rows' cells."""
    if not rb.size:
        return np.zeros(n_rb, np.int64)
    n_pc = int(pc.max()) + 1
    key, count = np.unique((rb * n_pc + pc) * BLOCK_ROWS + row,
                           return_counts=True)
    unit = key // BLOCK_ROWS
    first = np.r_[0, np.flatnonzero(np.diff(unit)) + 1]
    width = np.maximum.reduceat(count, first)
    return np.bincount(unit[first] // n_pc, weights=width,
                       minlength=n_rb).astype(np.int64)


def _units(rb, lane, k, step, col, val, n_rb: int, n_xrows: int,
           direct_below: float, split_steps: int = 0):
    """Compact cells of ``n_rb`` row blocks: the units (main pieces of the
    row blocks, then their later pieces in (row block, piece) order) with
    widths, table sizes, tables, values, indices, columns and kinds, each
    later piece's row block, and the count of distinct (unit, x row)
    pairs; the columns are None where no unit is direct.  Cell i sits in
    row ``lane[i] % 32`` of row block ``rb[i]`` at place ``k[i]``; a row
    block's cells come in the order of ``step``, between whose values its
    pieces are cut, and a row block wider than ``split_steps`` (0: none)
    into pieces of at most that many steps."""
    xrow = col >> 7
    row = lane % BLOCK_ROWS
    # distinct x rows per row block; past 16 bits the block is cut
    ukey = np.unique(rb * n_xrows + xrow)
    n_distinct = np.bincount(ukey // n_xrows, minlength=n_rb)
    over = np.flatnonzero(n_distinct > MAX_TABLE_ROWS)
    long = np.zeros(0, np.int64)
    if split_steps:
        # a row block not cut is as wide as its longest row
        longest = np.bincount(rb * BLOCK_ROWS + row,
                              minlength=n_rb * BLOCK_ROWS)
        long = np.flatnonzero(longest.reshape(n_rb, BLOCK_ROWS).max(axis=1)
                              > split_steps)
    pc = np.zeros(rb.size, np.int64)
    unit = rb.copy()
    extra_rb = np.zeros(0, np.int64)
    if over.size or long.size:
        order = _stable_order(rb)
        bounds = np.searchsorted(rb[order], np.arange(n_rb + 1))

        def rb_cells(rbs) -> np.ndarray:
            """The cells of row blocks ``rbs``, each block's in step
            order."""
            n = bounds[rbs + 1] - bounds[rbs]
            before = np.cumsum(n) - n
            return order[np.repeat(bounds[rbs] - before, n)
                         + np.arange(int(n.sum()))]

        def cut_by_steps(rbs, max_steps: int) -> np.ndarray:
            """The greedy cut of :func:`_cut_pieces` where it is a cut every
            ``max_steps`` steps (no such piece reads more x rows than a
            table holds), for all of ``rbs`` at once; returns the row blocks
            it is not."""
            cells = rb_cells(rbs)
            g = np.repeat(np.arange(rbs.size), bounds[rbs + 1] - bounds[rbs])
            st = step[cells]
            new = np.r_[True, (st[1:] != st[:-1]) | (g[1:] != g[:-1])]
            rank = np.cumsum(new) - 1
            first = np.r_[0, np.flatnonzero(np.diff(g)) + 1]
            piece = (rank - rank[first][g]) // max_steps
            key = np.unique((g * (piece.max() + 1) + piece) * n_xrows
                            + xrow[cells])
            unit_key = key // n_xrows
            count = np.bincount(unit_key, minlength=rbs.size
                                * (int(piece.max()) + 1))
            fits = count.reshape(rbs.size, -1).max(axis=1) <= MAX_TABLE_ROWS
            ok = fits[g]
            pc[cells[ok]] = piece[ok]
            return rbs[~fits]

        def cut(rbs, max_steps: int) -> None:
            if max_steps and rbs.size:
                rbs = cut_by_steps(rbs, max_steps)
            if rbs.size:
                cells = rb_cells(rbs)
                g = np.repeat(np.arange(rbs.size),
                              bounds[rbs + 1] - bounds[rbs])
                pc[cells] = _cut_pieces(step[cells], xrow[cells], max_steps,
                                        g)

        # a row block already long is cut once, below, by both limits
        short = np.setdiff1d(over, long)
        cut(short, 0)
        if split_steps and short.size:
            # a cut row block is as wide as its pieces together
            in_short = np.zeros(n_rb, bool)
            in_short[short] = True
            sel = in_short[rb]
            width = _widths(rb[sel], row[sel], pc[sel], n_rb)
            long = np.union1d(long, short[width[short] > split_steps])
        cut(long, split_steps)
        cut_rbs = np.union1d(over, long)
        # each cut row block's later pieces, numbered after the main pieces
        # in (row block, piece) order
        cells = rb_cells(cut_rbs)
        n_later = np.zeros(n_rb, np.int64)
        # a block's pieces follow its steps: its last cell's is its last
        n_later[cut_rbs] = pc[cells[np.cumsum(
            bounds[cut_rbs + 1] - bounds[cut_rbs]) - 1]]
        extra_rb = np.repeat(cut_rbs, n_later[cut_rbs])
        before = np.zeros(n_rb, np.int64)
        before[cut_rbs] = np.cumsum(n_later[cut_rbs]) - n_later[cut_rbs]
        unit[cells] = np.where(pc[cells] == 0, rb[cells],
                               n_rb + before[rb[cells]] + pc[cells] - 1)
        # a row's rank restarts in each piece: its rank among the row's
        # cells of the piece (the cut row blocks' cells in step order)
        g = unit[cells] * BLOCK_ROWS + row[cells]
        o = _stable_order(g)
        first = np.r_[0, np.flatnonzero(np.diff(g[o])) + 1]
        k[cells[o]] = np.arange(cells.size) - np.repeat(
            first, np.diff(np.r_[first, cells.size]))
    n_units = n_rb + extra_rb.size
    # one width per unit: its longest row
    row_cells = np.bincount(unit * BLOCK_ROWS + row,
                            minlength=n_units * BLOCK_ROWS)
    width = row_cells.reshape(n_units, BLOCK_ROWS).max(axis=1)
    start = np.zeros(n_units + 1, np.int64)
    np.cumsum(width * BLOCK_ROWS, out=start[1:])
    pos = start[unit] + k * BLOCK_ROWS + row
    # each unit's distinct x rows, sorted; a unit with fewer cells than
    # direct_below a row keeps no table and reads its columns directly
    key, _, inv = _unique_first(unit * n_xrows + xrow)
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


def _work_items(piece: np.ndarray, n_rb: int, split_steps: int):
    """The split form's arrays (see :class:`StreamCellsPlan`) of a plan
    whose row blocks wider than ``split_steps`` were cut into pieces of at
    most that many steps: each such row block's chain into chunks (greedy,
    at most ``split_steps`` steps each), the work items longest first and
    the longest one's steps; None where no row block is that wide."""
    n_pieces = len(piece) - 1
    width = np.diff(piece[:, PIECE_CELL]) // BLOCK_ROWS
    p_rb = piece[:n_pieces, PIECE_RB]
    rb_width = np.bincount(p_rb, weights=width, minlength=n_rb).astype(
        np.int64)
    chunked = np.flatnonzero(rb_width > split_steps)
    if not chunked.size:
        return None
    # each row block's later pieces follow in order (see _assemble)
    x_rb = p_rb[n_rb:]
    assert np.all(np.diff(x_rb) >= 0)
    lo = np.searchsorted(x_rb, np.arange(n_rb), side="left")
    hi = np.searchsorted(x_rb, np.arange(n_rb), side="right")
    is_chunked = np.zeros(n_rb, bool)
    is_chunked[chunked] = True
    piece_slot = np.full(n_pieces, -1, np.int64)
    # (steps, first piece, pieces, slot, chunked row block) of each item
    items, chunk_first = [], [0]
    for r in range(n_rb):
        chain = [r] + list(range(n_rb + lo[r], n_rb + hi[r]))
        if rb_width[r] <= split_steps:
            items.append((rb_width[r], r, len(chain), -1, -1))
            continue
        i, slot, start, held = len(chunk_first) - 1, chunk_first[-1], 0, 0
        for j in range(len(chain) + 1):
            if j == len(chain) or (held and held + width[chain[j]]
                                   > split_steps):
                items.append((held, chain[start], j - start, slot, i))
                piece_slot[chain[start:j]] = slot
                slot += 1
                if j == len(chain):
                    break
                start, held = j, 0
            held += width[chain[j]]
        chunk_first.append(slot)
    items = np.asarray(items, np.int64)
    # longest first; ties in row-block order
    items = items[np.argsort(-items[:, 0], kind="stable")]
    return (items[:, 1:], np.asarray(chunk_first, np.int64), chunked,
            piece_slot, int(items[0, 0]))


def _take_hubs(cells, small_steps: int):
    """Cells (row, place, step, column, value) split into the rest and the
    cells of hub rows (more than ``small_steps`` cells), the latter as
    (row, column, value) by row and a row's places in order."""
    row, k = cells[0], cells[1]
    if not row.size:
        return cells, None
    hub = np.bincount(row)[row] > small_steps
    if not hub.any():
        return cells, None
    o = np.lexsort((k[hub], row[hub]))
    return (tuple(a[~hub] for a in cells),
            (row[hub][o], cells[3][hub][o], cells[4][hub][o]))


def _hub_arrays(hubs, hub_steps: int, val_dtype,
                row_map: np.ndarray = None) -> dict:
    """The small form's hub arrays (:class:`StreamCellsPlan`) of the hub
    cells ``hubs`` (row, column, value; by row, in a row's order): each
    hub's cells row-major from a multiple of 32, zeros after its last;
    its steps in chunks of ``hub_steps``; a hub of one chunk takes no
    partial slot; an item also holds its hub's slots and y row (through
    ``row_map`` where given)."""
    row, col, val = hubs
    rows, first, count = np.unique(row, return_index=True,
                                   return_counts=True)
    steps = -(-count // BLOCK_ROWS)
    cell = np.zeros(rows.size + 1, np.int64)
    np.cumsum(steps * BLOCK_ROWS, out=cell[1:])
    pos = np.repeat(cell[:-1] - first, count) + np.arange(row.size)
    hub_val = np.zeros(int(cell[-1]), val_dtype)
    hub_val[pos] = val
    hub_col = np.zeros(int(cell[-1]), np.int64)
    hub_col[pos] = col
    n_chunks = -(-steps // hub_steps)
    n_slots = np.where(n_chunks > 1, n_chunks, 0)
    hub_first = np.zeros(rows.size + 1, np.int64)
    np.cumsum(n_slots, out=hub_first[1:])
    hub = np.repeat(np.arange(rows.size), n_chunks)
    c = np.arange(hub.size) - np.repeat(np.cumsum(n_chunks) - n_chunks,
                                        n_chunks)
    out = rows if row_map is None else row_map[rows]
    item = np.stack([cell[hub] + BLOCK_ROWS * hub_steps * c,
                     np.minimum(hub_steps, steps[hub] - hub_steps * c),
                     np.where(n_slots[hub] > 0, hub_first[hub] + c, -1),
                     hub, hub_first[hub], hub_first[hub + 1], out[hub],
                     np.zeros(hub.size, np.int64)], axis=1)
    return dict(hub_val=hub_val, hub_col=hub_col, hub_cell=cell,
                hub_first=hub_first, hub_row=rows, hub_item=item)


def _small_items(piece: np.ndarray, n_rb: int, hub_row: np.ndarray):
    """The small form's row-block work items: every row block one item
    (its main piece, its pieces; slot -1; the int32 mask of its lanes that
    are hubs; then its main piece's cells, first and end, and its table's
    first row, -1 where the piece is direct), longest first, ties in
    row-block order."""
    n_pieces = len(piece) - 1
    width = np.diff(piece[:, PIECE_CELL]) // BLOCK_ROWS
    p_rb = piece[:n_pieces, PIECE_RB]
    rb_width = np.bincount(p_rb, weights=width, minlength=n_rb)
    mask = np.zeros(n_rb, np.int64)
    np.add.at(mask, hub_row // BLOCK_ROWS,
              np.left_shift(1, hub_row % BLOCK_ROWS))
    main = piece[:n_rb + 1]
    direct = main[1:, PIECE_ROW] == main[:-1, PIECE_ROW]
    item = np.stack([np.arange(n_rb), np.bincount(p_rb, minlength=n_rb),
                     np.full(n_rb, -1), mask.astype(np.uint32).view(
                         np.int32).astype(np.int64),
                     main[:-1, PIECE_CELL], main[1:, PIECE_CELL],
                     np.where(direct, -1, main[:-1, PIECE_ROW]),
                     np.zeros(n_rb, np.int64)], axis=1)
    return item[np.argsort(-rb_width, kind="stable")]


def small_form_wanted(parent: StreamCellsPlan, split_steps: int,
                      small_steps: int) -> bool:
    """The rule that gives a body the small form, read off ``parent``, its
    plan in the split form: some row block is chunked; the chunks are
    longer than the small form's rows (``split_steps > small_steps``); and
    the work items fill at most ``SMALL_WAVE_SHARE`` of ``WAVE_WARPS``
    (powerlaw_16k's 681-865 do, powerlaw_1m's tens of thousands do not)."""
    return bool(
        small_steps and parent.stats["chunked_rbs"] > 0
        and split_steps > small_steps
        and parent.stats["n_items"] <= SMALL_WAVE_SHARE * WAVE_WARPS)


def build_stream_cells(e: EhybMatrix, x_rows: int = None,
                       direct_below: float = 0.0, group_rows: int = 0,
                       split_steps: int = 0, fold: bool = False,
                       small_steps: int = 0,
                       hub_steps: int = 0) -> StreamCellsPlan:
    """Decode the body of ``e`` once and re-encode its real cells as K1's
    compact plan.  ``x_rows`` is the length of the x the body reads
    (``e.padded_x_rows`` where None; a shard's ``x_ext`` is longer).
    ``direct_below`` and ``group_rows`` (0: off) are the scattered body's
    options of the module docstring, ``split_steps`` (0: off) the heavy
    tail's; the float kernels read neither of the first two.  With
    ``fold`` the plan also holds the EHYB tail (the module docstring).
    ``small_steps`` and ``hub_steps`` (0: off) ask for the small form,
    which the body gets where :func:`small_form_wanted` grants it (its
    split form is built first, and returned where not)."""
    plan = _build(e, x_rows, direct_below, group_rows, split_steps, fold)
    if not small_form_wanted(plan, split_steps, small_steps):
        return plan
    return _build(e, x_rows, direct_below, group_rows, split_steps, fold,
                  small_steps, hub_steps or HUB_STEPS) or plan


def _build(e: EhybMatrix, x_rows: int, direct_below: float,
           group_rows: int, split_steps: int, fold: bool,
           small_steps: int = 0, hub_steps: int = 0) -> StreamCellsPlan:
    """:func:`build_stream_cells` in the form its options name: with
    ``small_steps`` the small form, hub rows taken apart (None where no
    row is a hub: a row block made wide by its tables' cuts alone)."""
    offs = e.slice_offset.astype(np.int64)
    n_slices = offs.shape[0] - 1
    n_steps = int(offs[-1]) if n_slices else 0
    x_rows = e.padded_x_rows if x_rows is None else x_rows
    n_xrows = -(-x_rows // LANES)
    n_rb = RB_PER_SLICE * n_slices
    val_dtype = e.ell_val.dtype
    tail, is_src = _tail(e, offs, n_rb * BLOCK_ROWS) if fold else (None,
                                                                    None)
    n_tail = 0 if tail is None else int(tail[0].size)

    def cells_of(a: int, b: int):
        cells = _decode(e, a, b, offs)
        if tail is None and is_src is None:
            return cells
        return _fold_span(cells, tail, is_src, a * LANES, b * LANES,
                          n_steps)

    spans = []
    s0 = 0
    while s0 < n_slices:
        s1 = max(int(np.searchsorted(offs, offs[s0] + _CHUNK_STEPS,
                                     side="right")) - 1, s0 + 1)
        s1 = min(s1, n_slices)
        spans.append((s0, s1))
        s0 = s1
    # a body whose row blocks hold fewer cells than direct_below an x row
    # is scattered: a grouping of its rows is weighed.  While the spans so
    # far are scattered, their decoded cells (row, place, column, value,
    # whether a body cell) are kept for it, so such a body is decoded once;
    # once they are not, the kept cells go, and a body scattered after all
    # is decoded again
    kept = [] if group_rows and n_rb else None
    parts, n_keys, n_real, hubs = [], 0, 0, []
    if small_steps:
        split_steps = 0     # the row blocks' widest rows are hubs now
    for a, b in spans:
        row, k, st, col, val = cells_of(a, b)
        if kept is not None:
            kept.append((row, k.copy(), col, val, st < n_steps))
        if small_steps:
            (row, k, st, col, val), hub = _take_hubs((row, k, st, col, val),
                                                    small_steps)
            if hub is not None:
                hubs.append(hub)
                n_real += hub[0].size
                n_keys += np.unique((hub[0] // BLOCK_ROWS) * n_xrows
                                    + (hub[1] >> 7)).size
        rb0 = RB_PER_SLICE * a
        u = _units(row // BLOCK_ROWS - rb0, row, k, st, col, val,
                   RB_PER_SLICE * (b - a), n_xrows, direct_below, split_steps)
        parts.append(_split(u, RB_PER_SLICE * (b - a), rb0))
        n_keys += u[-1]
        n_real += int(np.count_nonzero(parts[-1][0][3])) + int(
            np.count_nonzero(parts[-1][1][3]))
        if kept is not None and n_real >= direct_below * n_keys:
            kept = None
        del row, k, st, col, val
    row_map = sectors = None
    if group_rows and n_rb and n_real < direct_below * n_keys:
        if kept is None:
            kept = [(row, k, col, val, st < n_steps)
                    for row, k, st, col, val in
                    (cells_of(a, b) for a, b in spans)]
        row, k, col, val, body = (np.concatenate(a) for a in zip(*kept))
        kept = None
        n_rows = n_rb * BLOCK_ROWS
        # the partition reads the body's pattern: a folded tail's cells are
        # out of the body's windows by construction, and would only make
        # the partition (the build's costliest step) slower; the sectors
        # are weighed over every cell
        order = group_order(row[body], col[body], n_rows, group_rows)
        pos = np.empty(n_rows, np.int64)
        pos[order] = np.arange(n_rows)
        prow = pos[row]
        sectors = (_sectors(row // BLOCK_ROWS, col, n_rb, False),
                   _sectors(prow // BLOCK_ROWS, col, n_rb, True))
        if sectors[1] < sectors[0]:
            row_map = order
            # a row block's cells by place: its pieces cut between places
            o = _stable_order(k)
            cells = (prow[o], k[o], k[o], col[o], val[o])
            if small_steps:
                cells, hub = _take_hubs(cells, small_steps)
                hubs = [] if hub is None else [hub]
            parts = [_split(_units(
                cells[0] // BLOCK_ROWS, *cells, n_rb, n_xrows, direct_below,
                split_steps), n_rb, 0)]
            del cells
        del row, k, col, val, prow, body
    piece, width, t_size, rows, cell_val, cell_idx, cell_col, direct = \
        _assemble(parts, n_rb, val_dtype)
    n_pieces = len(piece) - 1
    n_cells = int(piece[-1, PIECE_CELL])
    split = _work_items(piece, n_rb, split_steps) if split_steps else None
    item, chunk_first, chunk_rb, piece_slot, max_item = split or (None,) * 5
    n_chunks = int(chunk_first[-1]) if split else 0
    hub_arrays, n_hub_cells, max_fold = {}, 0, 0
    if small_steps and not hubs:
        return None
    if small_steps:
        hub_arrays = _hub_arrays(tuple(np.concatenate(a) for a in zip(*hubs)),
                                 hub_steps, val_dtype, row_map)
        item = _small_items(piece, n_rb, hub_arrays["hub_row"])
        n_hub_cells = hub_arrays["hub_val"].size
        max_fold = int(np.diff(hub_arrays["hub_first"]).max())
        rb_width = np.bincount(piece[:n_pieces, PIECE_RB], weights=width,
                               minlength=n_rb)
        max_item = max(int(rb_width.max()) if n_rb else 0,
                       int(hub_arrays["hub_item"][:, HUB_STEPS_COL].max()))
    n_hub_slots = int(hub_arrays["hub_first"][-1]) if small_steps else 0
    if n_cells >= 2 ** 31 or rows.size >= 2 ** 31 or \
            (cell_col.size and cell_col.max() >= 2 ** 31) or \
            n_hub_cells >= 2 ** 31:
        raise ValueError("K1 plan too large for int32 maps")
    n_direct = int((width[direct] * BLOCK_ROWS).sum())
    # each index array holds every cell where some piece reads it
    if not direct.any():
        cell_col = np.zeros(0, np.int64)
    if direct[width > 0].all():
        cell_idx = np.zeros(0, np.uint16)
    cell_bytes = n_cells * cell_val.itemsize + 2 * (n_cells - n_direct) \
        + 4 * n_direct + n_hub_cells * (val_dtype.itemsize + 4)
    map_bytes = piece.size * 4 + rows.size * 4 \
        + (0 if row_map is None else 4 * row_map.size) \
        + (0 if split is None else 4 * (item.size + chunk_first.size)) \
        + 4 * sum(hub_arrays[k].size for k in (
            "hub_item", "hub_first", "hub_row") if k in hub_arrays) + (
            4 * item.size if small_steps else 0)
    # the split form's partials: written once and read once (the small
    # form's: a sum and a compensation a hub chunk)
    partial_bytes = 2 * (n_chunks * BLOCK_ROWS + n_hub_slots) \
        * cell_val.itemsize
    x_bytes = x_rows * cell_val.itemsize
    y_bytes = n_slices * LANES * cell_val.itemsize
    stats = dict(
        n_rb=n_rb, n_pieces=n_pieces,
        split_rbs=int(np.unique(piece[n_rb:n_pieces, PIECE_RB]).size),
        real_cells=n_real, compact_cells=n_cells + n_hub_cells,
        # the fold: whether the plan holds the tail, and its cells
        folded=bool(fold), tail_cells=n_tail,
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
        # the split form: row blocks chunked, their chunks (partial slots),
        # work items, the widest item's steps
        split_steps=split_steps, chunked_rbs=0 if split is None
        else int(chunk_rb.size), n_chunks=n_chunks,
        n_items=len(item) + len(hub_arrays["hub_item"]) if small_steps
        else 0 if split is None else len(item),
        max_item_steps=max_item if split or small_steps else 0,
        # the small form: its row threshold, hub rows and their cells, hub
        # items of at most hub_steps steps, the widest fold's partials
        small=bool(small_steps), small_steps=small_steps,
        n_hubs=len(hub_arrays.get("hub_row", ())), hub_cells=n_hub_cells,
        hub_items=len(hub_arrays.get("hub_item", ())),
        hub_steps=hub_steps if small_steps else 0, max_fold=max_fold,
        cell_bytes=cell_bytes, map_bytes=map_bytes,
        # what the plan itself streams per call: cells, pieces and tables
        stream_bytes=cell_bytes + map_bytes,
        body_bytes=n_steps * LANES * (e.ell_col.dtype.itemsize
                                      + cell_val.itemsize),
        x_rows=x_rows, x_bytes=x_bytes, y_bytes=y_bytes,
        partial_bytes=partial_bytes,
        # what the kernel moves: the plan, x once, y once and the partials
        layout_bytes=cell_bytes + map_bytes + x_bytes + y_bytes
        + partial_bytes)
    return StreamCellsPlan(
        n_slices=n_slices, piece=piece.astype(np.int32),
        rows=rows.astype(np.int32), cell_val=cell_val,
        cell_idx=cell_idx.view(np.int16), stats=stats,
        cell_col=cell_col.astype(np.int32),
        row_map=None if row_map is None else row_map.astype(np.int32),
        **({} if split is None else dict(
            item=item.astype(np.int32),
            chunk_first=chunk_first.astype(np.int32),
            chunk_rb=chunk_rb.astype(np.int32),
            piece_slot=piece_slot.astype(np.int32))),
        **({} if not small_steps else dict(
            item=item.astype(np.int32),
            **{k: v if k == "hub_val" else v.astype(np.int32)
               for k, v in hub_arrays.items()})))


def k1_options(e: EhybMatrix, lists: bool = False) -> dict:
    """The options of K1's plans for ``e``'s value type, plain or
    compensated alike: float64 values take direct pieces and grouped rows
    where the body is scattered, and the split form where a row block is
    wider than ``SPLIT_STEPS_F64``; float32 values the split form where a
    row block is wider than ``SPLIT_STEPS``; both ask for the small form
    (``SMALL_STEPS``, ``HUB_STEPS``; :func:`small_form_wanted` grants it),
    but for a plan walked through lists (``lists``: the sharded apply's),
    which the small form's kernel does not take.  ``build_stream_cells(e,
    **k1_options(e))`` is the plan of the body alone."""
    small = {} if lists else dict(small_steps=SMALL_STEPS,
                                  hub_steps=HUB_STEPS)
    if e.ell_val.dtype == np.float64:
        return dict(direct_below=DIRECT_BELOW, group_rows=GROUP_ROWS,
                    split_steps=SPLIT_STEPS_F64, **small)
    return dict(split_steps=SPLIT_STEPS, **small)


def k1_folded_plan(e: EhybMatrix, x_rows: int = None, cache: str = None,
                   lists: bool = False) -> StreamCellsPlan:
    """K1's plan of a flagship or precision-mode artifact: the body with
    :func:`k1_options`, and the EHYB tail folded in, so that the plan holds
    the whole apply but its diagonals (ER, long-row and hub-split entries
    as cells of their true rows; the module docstring).  Where ``e`` has
    no tail it is the body's plan byte for byte.

    ``cache`` (None: off) is the artifact's path in the cache without its
    suffix: the plan is read from a file beside it, keyed by the options,
    ``x_rows``, the value type and ``PLAN_VERSION``, where one is there;
    else built and written there, with its build's seconds in
    ``stats["build_seconds"]``."""
    opts = dict(k1_options(e, lists), fold=True)
    if cache is None:
        return build_stream_cells(e, x_rows, **opts)
    key = hashlib.sha256(json.dumps(dict(
        opts, x_rows=x_rows, dtype=str(e.ell_val.dtype),
        version=PLAN_VERSION), sort_keys=True).encode()).hexdigest()[:16]
    path = f"{cache}.k1-{key}.npz"
    if os.path.exists(path):
        try:
            plan = StreamCellsPlan.load(path)
            log.info("loaded cached K1 plan <- %s", path)
            return plan
        except Exception as exc:  # a corrupted cache: build again
            log.warning("K1 plan cache load failed (%s); rebuilding", exc)
    t0 = time.perf_counter()
    plan = build_stream_cells(e, x_rows, **opts)
    plan.stats["build_seconds"] = time.perf_counter() - t0
    plan.save(path)
    log.info("cached K1 plan -> %s", path)
    return plan


def has_tail(e) -> bool:
    """Whether artifact ``e`` (host or device) has entries outside its body
    and diagonals: ER, long-row or hub-split ones."""
    return bool(e.er_val.shape[0] or e.long_val.shape[0]
                or e.split_src.shape[0])
