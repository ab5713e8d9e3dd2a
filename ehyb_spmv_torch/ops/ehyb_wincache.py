"""The SELL body through an explicit x-window cache: plan, wrapper and plain
version.

Port counterpart of the HBM-streamed bodies of
``ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py`` (``_make_stream_hbm_kernel``, K3,
and ``_make_stream_hbm_big_kernel``, K4, with the branches of
``make_ehyb_pallas_apply`` that run them).  The kernel is
``csrc/ehyb_wincache.cu``; its header says what it computes, what bounds it
and why the GPU needs a plan and a cell layout of its own.

:func:`build_wincache_plan` cuts the slices into stages whose windows fit
the block's shared memory and re-encodes the body's real cells per stage:
one width per 32-row block, each cell a float32 value and a 16-bit index
into its stage's staged x rows.  :func:`wincache_body` launches the kernel
for CUDA tensors and takes :func:`wincache_body_plain` only for CPU tensors.
The plain version applies the same plan on tensors (gather each stage's
rows, index them with the cells), so the CPU tests hold the plan itself.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from ..config import LANES
from ..core.ehyb import EhybDevice, EhybMatrix
from .build import BuiltLibrary, build_cuda_library
from .stream_plan import WIN_ROWS

#: x rows of 128 floats (512 B) one stage holds, the groups of 128 threads
#: of a block, and the most slices one stage holds: 80 KB of rows, so two
#: 1024-thread blocks fill an SM, each staging while the other sums.
#: Measured on permuted_poisson_4096 by chip_wincache_sweep.py: smaller
#: stages stage more x again, larger ones (or a second buffer of rows per
#: block) leave one block per SM.
SLOT_ROWS = 160
GROUPS = 8
MAX_RUN_SLICES = 128
#: Rows of a cell block: one warp, one width.
BLOCK_ROWS = 32
#: Largest stage a 16-bit cell index addresses (slot * 128 + lane).
MAX_SLOT_ROWS = (1 << 16) // LANES
#: Body steps the plan decodes at once (bounds its numpy temporaries).
_CHUNK_STEPS = 1 << 15

_lock = threading.Lock()
_built = None
_lib = None


@dataclasses.dataclass
class WinCachePlan:
    """Host plan of the window-cache body.

    Block b walks stages ``[block_stage[b], block_stage[b+1])``: one stage
    of whole slices, or the stages of one slice whose rows do not fit.
    Stage t covers slices ``[stage_slice[t, 0], stage_slice[t, 1])`` and,
    of them, body steps ``[stage_step[t], stage_step[t+1])``, and stages the
    x rows ``stage_rows[stage_row_ptr[t]:stage_row_ptr[t+1]]`` (sorted, each
    a row of 128 floats).

    The stage's cells sit in its row blocks ``[stage_rb[t],
    stage_rb[t+1])``: 32 rows each, 4 per slice, row block j of the stage
    holding rows ``stage_slice[t, 0] * 128 + 32 * j + [0, 32)``.  Row block
    i holds the cells ``[rb_cell[i], rb_cell[i+1])``, column-major: cell k
    of its row r at ``rb_cell[i] + 32 * k + r``, a row's cells in step
    order, zero-padded to the block's width.  ``cell_idx`` is the cell's
    place in its stage's staged rows, ``slot * 128 + lane`` (a uint16 kept
    in int16 bits)."""

    slot_rows: int
    groups: int
    n_slices: int
    block_stage: np.ndarray
    stage_slice: np.ndarray
    stage_step: np.ndarray
    stage_row_ptr: np.ndarray
    stage_rows: np.ndarray
    stage_rb: np.ndarray
    rb_cell: np.ndarray
    cell_val: np.ndarray
    cell_idx: np.ndarray
    stats: dict

    def to_torch(self, device=None) -> "WinCacheDevice":
        return WinCacheDevice(self).to(device)


class WinCacheDevice(torch.nn.Module):
    """Device mirror of :class:`WinCachePlan`: its arrays as buffers."""

    MAP_FIELDS = ("block_stage", "stage_slice", "stage_step",
                  "stage_row_ptr", "stage_rows", "stage_rb", "rb_cell")
    ARRAY_FIELDS = MAP_FIELDS + ("cell_val", "cell_idx")

    def __init__(self, p: WinCachePlan):
        super().__init__()
        self.slot_rows = p.slot_rows
        self.groups = p.groups
        self.n_slices = p.n_slices
        # sizes as host ints: the plain version reads no device scalar, so
        # it can be captured in a CUDA graph
        self.n_stages = len(p.stage_rb) - 1
        self.n_rb = len(p.rb_cell) - 1
        self.n_cells = int(p.rb_cell[-1])
        self.stats = dict(p.stats)
        for f in self.MAP_FIELDS:
            self.register_buffer(f, torch.from_numpy(
                np.ascontiguousarray(getattr(p, f), dtype=np.int32)))
        self.register_buffer("cell_val", torch.from_numpy(p.cell_val))
        self.register_buffer("cell_idx", torch.from_numpy(p.cell_idx))

    @property
    def n_blocks(self) -> int:
        return self.block_stage.shape[0] - 1


def _window_rows(e: EhybMatrix) -> np.ndarray:
    """(nwin, n_steps) first x row (of 128 floats) of each step's windows."""
    wins = [a for a in (e.step_win, e.step_win_b, e.step_win_c, e.step_win_d)
            if a.size]
    w = np.stack([a.astype(np.int64) for a in wins])
    if np.any(w % LANES):
        raise ValueError("window starts must be 128-row aligned")
    w //= LANES
    n_rows = e.padded_x_rows // LANES
    if w.size and (w.min() < 0 or w.max() + WIN_ROWS > n_rows):
        raise ValueError("a window reaches past the padded x")
    return w


def _rows_of(windows) -> set:
    rows = set()
    for w in windows:
        rows.update(range(w, w + WIN_ROWS))
    return rows


def _stages(offs: np.ndarray, w: np.ndarray, n_xrows: int, slot_rows: int,
            max_run_slices: int):
    """Greedy stages over the slices in order.  Returns the stages' (lo, hi)
    slices, step bounds and staged rows, and the stage count of each block
    (one stage of whole slices, or the stages of one overflowing slice)."""
    n_slices = offs.shape[0] - 1
    n_steps = int(offs[-1]) if n_slices else 0
    # distinct windows per slice, sorted by (slice, window row)
    step_slice = np.repeat(np.arange(n_slices, dtype=np.int64), np.diff(offs))
    key = np.unique((step_slice[None, :] * n_xrows + w).reshape(-1))
    win_slice, win_row = key // n_xrows, (key % n_xrows).tolist()
    win_ptr = np.searchsorted(win_slice, np.arange(n_slices + 1))

    stage_step, stage_slice, stage_rows, per_block = [0], [], [], []

    def close_stage(end_step: int, rows: set, lo: int, hi: int) -> None:
        stage_step.append(end_step)
        stage_slice.append((lo, hi))
        stage_rows.append(sorted(rows))

    run_rows: set = set()
    run_start = 0
    for s in range(n_slices):
        rows_s = _rows_of(win_row[win_ptr[s]:win_ptr[s + 1]])
        new = rows_s - run_rows
        if s > run_start and (len(run_rows) + len(new) > slot_rows
                              or s - run_start >= max_run_slices):
            close_stage(int(offs[s]), run_rows, run_start, s)
            per_block.append(1)
            run_rows, run_start, new = set(), s, rows_s
        if len(rows_s) <= slot_rows:
            run_rows |= new
            continue
        # one slice past the budget: stages of its steps, one block
        n0 = len(stage_rows)
        cur: set = set()
        for step in range(int(offs[s]), int(offs[s + 1])):
            rows_k = _rows_of(w[:, step].tolist())
            if cur and len(cur | rows_k) > slot_rows:
                close_stage(step, cur, s, s + 1)
                cur = set()
            cur |= rows_k
        close_stage(int(offs[s + 1]), cur, s, s + 1)
        per_block.append(len(stage_rows) - n0)
        run_rows, run_start = set(), s + 1
    if run_start < n_slices:
        close_stage(n_steps, run_rows, run_start, n_slices)
        per_block.append(1)
    return stage_slice, stage_step, stage_rows, per_block


def _window_slots(w: np.ndarray, stage_step: np.ndarray, row_ptr: np.ndarray,
                  rows: np.ndarray, n_xrows: int) -> np.ndarray:
    """(nwin, n_steps) slot of each step's windows' first rows within its
    stage's staged rows."""
    n_steps = w.shape[1]
    sizes = np.diff(row_ptr)
    stage_of = np.searchsorted(stage_step[1:], np.arange(n_steps),
                               side="right")
    stage_key = np.repeat(np.arange(sizes.size), sizes) * n_xrows + rows
    q = stage_of[None, :] * n_xrows + w
    pos = np.searchsorted(stage_key, q)
    if n_steps and not np.array_equal(
            stage_key[np.minimum(pos, rows.size - 1)], q):
        raise AssertionError("a step's window is not staged")
    return pos - row_ptr[stage_of][None, :]


def _stage_index(e: EhybMatrix, slot: np.ndarray, step: np.ndarray,
                 lane: np.ndarray) -> np.ndarray:
    """Stage index ``slot * 128 + lane`` of the cells (step, lane): the
    lo-slot decode of ``body_gather_index``, against the stage's slots
    instead of x."""
    idx = e.ell_col[step, lane].astype(np.int64)
    lo = idx & (LANES - 1)
    if slot.shape[0] == 1:
        row = slot[0, step] + (idx >> 7)
    else:
        attr = e.ell_col[step, lo].astype(np.int64)
        row = slot[attr >> 10, step] + ((attr >> 7) & 7)
    return row * LANES + lo


def _compact(e: EhybMatrix, slot: np.ndarray, seg_beg: np.ndarray,
             seg_end: np.ndarray):
    """Re-encode the real cells (``ell_val != 0``) segment by segment (a
    segment is one slice's steps within one stage).  Returns the row
    blocks' cell offsets, the cells' values and stage indices, and the
    count of real cells."""
    n_seg = seg_beg.size
    rb_groups = LANES // BLOCK_ROWS
    widths, vals, idxs = [], [], []
    n_real = 0
    i0 = 0
    while i0 < n_seg:
        i1 = max(int(np.searchsorted(seg_end, seg_beg[i0] + _CHUNK_STEPS,
                                     side="right")), i0 + 1)
        a, b = int(seg_beg[i0]), int(seg_end[i1 - 1])
        val = e.ell_val[a:b]
        keep = val != 0
        cs = np.zeros((b - a + 1, LANES), np.int32)
        np.cumsum(keep, axis=0, dtype=np.int32, out=cs[1:])
        sb, se = seg_beg[i0:i1] - a, seg_end[i0:i1] - a
        base = cs[sb]
        # each row block's width: its longest row in the segment
        width = (cs[se] - base).reshape(-1, rb_groups, BLOCK_ROWS).max(2)
        width = width.reshape(-1).astype(np.int64)
        start = np.zeros(width.size + 1, np.int64)
        np.cumsum(width * BLOCK_ROWS, out=start[1:])
        step_seg = np.repeat(np.arange(i1 - i0), se - sb)
        st, ln = np.nonzero(keep)
        k = cs[st + 1, ln] - base[step_seg[st], ln] - 1
        pos = start[step_seg[st] * rb_groups + (ln // BLOCK_ROWS)] \
            + k * BLOCK_ROWS + (ln % BLOCK_ROWS)
        out_val = np.zeros(int(start[-1]), val.dtype)
        out_val[pos] = val[st, ln]
        out_idx = np.zeros(int(start[-1]), np.uint16)
        out_idx[pos] = _stage_index(e, slot, st + a, ln)
        widths.append(width)
        vals.append(out_val)
        idxs.append(out_idx)
        n_real += st.size
        i0 = i1
    width = np.concatenate(widths) if widths else np.zeros(0, np.int64)
    rb_cell = np.zeros(width.size + 1, np.int64)
    np.cumsum(width * BLOCK_ROWS, out=rb_cell[1:])
    cell_val = np.concatenate(vals) if vals else e.ell_val[:0, 0].copy()
    cell_idx = np.concatenate(idxs) if idxs else np.zeros(0, np.uint16)
    return rb_cell, cell_val, cell_idx.view(np.int16), n_real


def build_wincache_plan(e: EhybMatrix, slot_rows: int = SLOT_ROWS,
                        groups: int = GROUPS,
                        max_run_slices: int = MAX_RUN_SLICES) -> WinCachePlan:
    """Cut the body into stages of whole slices whose windows fit
    ``slot_rows`` staged x rows, one block each, and re-encode each stage's
    real cells against its staged rows.

    Greedy over the slices in order: a slice joins the current stage while
    the union of the stage's window rows stays within ``slot_rows`` and the
    stage holds fewer than ``max_run_slices`` slices.  A slice whose own
    union passes ``slot_rows`` is walked in stages of steps (a stage closes
    where the next step's windows would overflow), all in one block."""
    if not 4 * WIN_ROWS <= slot_rows <= MAX_SLOT_ROWS:
        raise ValueError(f"slot_rows must hold one step's 4 windows "
                         f"({4 * WIN_ROWS} rows) and fit a 16-bit index "
                         f"(at most {MAX_SLOT_ROWS} rows)")
    if not 1 <= groups <= 8:
        raise ValueError("groups must be 1 to 8 (at most 1024 threads)")
    offs = e.slice_offset.astype(np.int64)
    n_slices = offs.shape[0] - 1
    n_steps = int(offs[-1]) if n_slices else 0
    w = _window_rows(e)[:, :n_steps]
    n_xrows = e.padded_x_rows // LANES
    stage_slice, stage_step, stage_rows, per_block = _stages(
        offs, w, n_xrows, slot_rows, max_run_slices)
    block_stage = np.zeros(len(per_block) + 1, dtype=np.int64)
    np.cumsum(per_block, out=block_stage[1:])

    stage_step = np.asarray(stage_step, dtype=np.int64)
    stage_slice = np.asarray(stage_slice, dtype=np.int64).reshape(-1, 2)
    sizes = np.array([len(r) for r in stage_rows], dtype=np.int64)
    row_ptr = np.zeros(len(stage_rows) + 1, dtype=np.int64)
    np.cumsum(sizes, out=row_ptr[1:])
    rows = (np.concatenate([np.asarray(r, dtype=np.int64)
                            for r in stage_rows])
            if stage_rows else np.zeros(0, np.int64))
    slot = _window_slots(w, stage_step, row_ptr, rows, n_xrows)

    # one segment per (stage, slice): the slice's steps within the stage
    per_stage = stage_slice[:, 1] - stage_slice[:, 0]
    seg_stage = np.repeat(np.arange(per_stage.size), per_stage)
    seg_slice = np.arange(seg_stage.size) \
        - np.repeat(np.cumsum(per_stage) - per_stage, per_stage) \
        + stage_slice[seg_stage, 0]
    seg_beg = np.maximum(offs[seg_slice], stage_step[seg_stage])
    seg_end = np.minimum(offs[seg_slice + 1], stage_step[seg_stage + 1])
    rb_cell, cell_val, cell_idx, n_real = _compact(e, slot, seg_beg, seg_end)
    stage_rb = np.zeros(per_stage.size + 1, np.int64)
    np.cumsum(per_stage * (LANES // BLOCK_ROWS), out=stage_rb[1:])
    if rb_cell[-1] >= 2 ** 31 or row_ptr[-1] >= 2 ** 31 \
            or n_steps >= 2 ** 31:
        raise ValueError("window-cache plan too large for int32 maps")

    n_cells = int(rb_cell[-1])
    y_bytes = n_slices * LANES * 4
    stats = dict(
        n_blocks=len(block_stage) - 1, n_stages=len(stage_rows),
        chunked_slices=sum(u > 1 for u in per_block),
        staged_rows=int(row_ptr[-1]),
        staged_bytes=int(row_ptr[-1]) * LANES * 4,
        max_stage_rows=int(sizes.max()) if sizes.size else 0,
        real_cells=int(n_real), compact_cells=n_cells,
        padded_cells=n_steps * LANES,
        max_width=int(np.diff(rb_cell).max() // BLOCK_ROWS)
        if n_cells else 0,
        cell_bytes=n_cells * (cell_val.itemsize + 2),
        body_bytes=n_steps * LANES * (e.ell_col.dtype.itemsize + 4),
        x_bytes=e.padded_x_rows * 4, y_bytes=y_bytes)
    # what the kernel moves: its cells, its staged rows (x and re-fetch)
    # and y once
    stats["layout_bytes"] = stats["cell_bytes"] + stats["staged_bytes"] \
        + y_bytes
    return WinCachePlan(
        slot_rows=slot_rows, groups=groups, n_slices=n_slices, block_stage=block_stage,
        stage_slice=stage_slice, stage_step=stage_step,
        stage_row_ptr=row_ptr, stage_rows=rows, stage_rb=stage_rb,
        rb_cell=rb_cell, cell_val=cell_val, cell_idx=cell_idx, stats=stats)


def build_kernel() -> BuiltLibrary:
    """Compile ``csrc/ehyb_wincache.cu`` (once per process) and return the
    library's path, build time and ptxas report."""
    global _built, _lib
    with _lock:
        if _built is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the window-cache body kernel needs a "
                                   "CUDA device; none is available")
            built = build_cuda_library("ehyb_wincache", ["ehyb_wincache.cu"])
            lib = ctypes.CDLL(built.path)
            lib.ehyb_wincache_body.restype = ctypes.c_int
            lib.ehyb_wincache_body.argtypes = (
                [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 3
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p])
            _built, _lib = built, lib
        return _built


def _check(e: EhybDevice, p: WinCacheDevice, x_pad: torch.Tensor) -> None:
    """Refuse anything the kernel does not take."""
    dev = x_pad.device
    if x_pad.dtype != torch.float32 or x_pad.dim() != 1 \
            or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous 1-D float32 tensor")
    if x_pad.shape[0] < e.padded_x_rows:
        raise ValueError(f"x_pad has {x_pad.shape[0]} rows; the windows "
                         f"need {e.padded_x_rows}")
    if x_pad.data_ptr() % 16:
        raise ValueError("x_pad must be 16-byte aligned (cp.async)")
    if p.cell_val.dtype != torch.float32 or p.cell_idx.dtype != torch.int16:
        raise ValueError("the plan's cells must be float32 values and "
                         "16-bit indices")
    if p.n_slices != e.slice_offset.shape[0] - 1:
        raise ValueError("the plan does not match this body")
    for t in [e.slice_offset, *(getattr(p, f) for f in p.ARRAY_FIELDS)]:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, x_pad on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.dtype == torch.int64:
            raise ValueError("maps must be int32")


def wincache_body(e: EhybDevice, p: WinCacheDevice, x_pad: torch.Tensor,
                  kahan: bool = False) -> torch.Tensor:
    """SELL-body sums per row lane, flattened to (n_slices * 128,), with
    every x read served from the plan's staged windows.

    CPU tensors take :func:`wincache_body_plain`; CUDA tensors launch the
    kernel (``kahan`` selects the compensated variant) or raise."""
    if x_pad.device.type == "cpu":
        return wincache_body_plain(e, p, x_pad, kahan)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    _check(e, p, x_pad)
    build_kernel()
    y = torch.empty(p.n_slices * LANES, dtype=torch.float32,
                    device=x_pad.device)
    rc = _lib.ehyb_wincache_body(
        p.cell_val.data_ptr(), p.cell_idx.data_ptr(), p.rb_cell.data_ptr(),
        p.stage_rb.data_ptr(), e.slice_offset.data_ptr(),
        p.block_stage.data_ptr(), p.stage_slice.data_ptr(),
        p.stage_step.data_ptr(), p.stage_row_ptr.data_ptr(),
        p.stage_rows.data_ptr(), p.slot_rows, p.groups, int(bool(kahan)),
        x_pad.data_ptr(), y.data_ptr(), p.n_blocks,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_wincache_body launch failed: CUDA error "
                           f"{rc}")
    if p.n_blocks:
        wincache_body.launches += 1
    return y


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
wincache_body.launches = 0


def wincache_body_plain(e: EhybDevice, p: WinCacheDevice,
                        x_pad: torch.Tensor, kahan: bool = False
                        ) -> torch.Tensor:
    """Plain-torch version of the kernel: gather every stage's x rows into
    one staging tensor, read each cell's x there through its stage index,
    and add the products per row in cell order (a row's step order).  With
    ``kahan`` it sums in float64 and rounds once, the answer the
    compensated kernel reaches to about one ulp."""
    dev = x_pad.device
    acc = torch.float64 if kahan else x_pad.dtype
    y = torch.zeros(p.n_slices * LANES, dtype=acc, device=dev)
    if p.n_cells == 0:
        return y.to(x_pad.dtype)
    x_rows = x_pad[:x_pad.shape[0] // LANES * LANES].view(-1, LANES)
    staged = x_rows.index_select(0, p.stage_rows.long()).reshape(-1)
    # each row block's stage, and its first row in y
    rb_stage = torch.repeat_interleave(
        torch.arange(p.n_stages, device=dev), torch.diff(p.stage_rb.long()),
        output_size=p.n_rb)
    rb_first = torch.arange(p.n_rb, device=dev) \
        - p.stage_rb.long()[rb_stage] \
        + p.stage_slice.long()[rb_stage, 0] * (LANES // BLOCK_ROWS)
    cell_rb = torch.repeat_interleave(
        torch.arange(p.n_rb, device=dev), torch.diff(p.rb_cell.long()),
        output_size=p.n_cells)
    lane = torch.arange(p.n_cells, device=dev) % BLOCK_ROWS
    flat = p.stage_row_ptr.long()[rb_stage][cell_rb] * LANES \
        + (p.cell_idx.long() & 0xFFFF)
    contrib = p.cell_val.to(x_pad.dtype) * staged[flat]
    y.index_add_(0, rb_first[cell_rb] * BLOCK_ROWS + lane, contrib.to(acc))
    return y.to(x_pad.dtype)
