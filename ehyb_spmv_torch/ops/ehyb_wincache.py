"""The SELL body through an explicit x-window cache: plan, wrapper and plain
version.

Port counterpart of the HBM-streamed bodies of
``ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py`` (``_make_stream_hbm_kernel``, K3,
and ``_make_stream_hbm_big_kernel``, K4, with the branches of
``make_ehyb_pallas_apply`` that run them).  The kernel is
``csrc/ehyb_wincache.cu``; its header says what it computes, what bounds it
and why the GPU needs a plan of its own instead of the TPU's LRU.

:func:`build_wincache_plan` cuts the slices into runs whose windows fit the
block's shared memory; :func:`wincache_body` launches the kernel for CUDA
tensors and takes :func:`wincache_body_plain` only for CPU tensors.  The
plain version applies the same plan on tensors (gather each stage's rows,
decode through the slot maps), so the CPU tests hold the plan itself.
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
from .torch_ops import _sum_slices

#: x rows of 128 floats (512 B) one block stages at once, and the groups of
#: 128 threads that share them: 80 KB of rows plus 32 KB of the groups'
#: column chunks, so two 1024-thread blocks fill an SM (64 warps).  Measured
#: on permuted_poisson_4096 by chip_wincache_sweep.py: fewer warps per SM
#: cost more than re-fetch, more rows leave one block per SM.
SLOT_ROWS = 160
GROUPS = 8
#: Most slices one stage holds (keeps enough blocks to fill the card when
#: the windows alone would allow longer runs).
MAX_RUN_SLICES = 128

_lock = threading.Lock()
_built = None
_lib = None


@dataclasses.dataclass
class WinCachePlan:
    """Host plan of the window-cache body (int32 arrays).

    Block b walks stages ``[block_stage[b], block_stage[b+1])``; stage t
    covers slices ``[stage_slice[t, 0], stage_slice[t, 1])`` and, of them,
    steps ``[stage_step[t], stage_step[t+1])``, and stages the x rows
    ``stage_rows[stage_row_ptr[t]:stage_row_ptr[t+1]]`` (sorted, each a row
    of 128 floats).  A stage holds whole slices, or part of one slice whose
    rows do not fit (then its block walks only that slice's stages).
    ``step_slot[j, step]`` is the slot of window selector j's first row
    within its step's stage.  ``groups`` groups of 128 threads per block
    share the staged rows."""

    slot_rows: int
    groups: int
    block_stage: np.ndarray
    stage_slice: np.ndarray
    stage_step: np.ndarray
    stage_row_ptr: np.ndarray
    stage_rows: np.ndarray
    step_slot: np.ndarray
    stats: dict

    def to_torch(self, device=None) -> "WinCacheDevice":
        return WinCacheDevice(self).to(device)


class WinCacheDevice(torch.nn.Module):
    """Device mirror of :class:`WinCachePlan`: its arrays as buffers."""

    ARRAY_FIELDS = ("block_stage", "stage_slice", "stage_step",
                    "stage_row_ptr", "stage_rows", "step_slot")

    def __init__(self, p: WinCachePlan):
        super().__init__()
        self.slot_rows = p.slot_rows
        self.groups = p.groups
        #: Steps the plan covers (host int: the plain version reads no
        #: device scalar, so it can be captured in a CUDA graph).
        self.n_steps = int(p.stage_step[-1])
        self.stats = dict(p.stats)
        for f in self.ARRAY_FIELDS:
            self.register_buffer(f, torch.from_numpy(
                np.ascontiguousarray(getattr(p, f), dtype=np.int32)))

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


def build_wincache_plan(e: EhybMatrix, slot_rows: int = SLOT_ROWS,
                        groups: int = GROUPS,
                        max_run_slices: int = MAX_RUN_SLICES
                        ) -> WinCachePlan:
    """Cut the body into stages of whole slices whose windows fit
    ``slot_rows`` staged x rows, and give each step its slots.

    Greedy over the slices in order: a slice joins the current stage while
    the union of the stage's window rows stays within ``slot_rows`` and the
    stage holds fewer than ``max_run_slices`` slices; each such stage is a
    block.  A slice whose own union passes ``slot_rows`` is a block of its
    own, walked in stages of steps (a stage closes where the next step's
    windows would overflow)."""
    if slot_rows < 4 * WIN_ROWS:
        raise ValueError(f"slot_rows must hold one step's 4 windows "
                         f"({4 * WIN_ROWS} rows)")
    if not 1 <= groups <= 8:
        raise ValueError("groups must be 1 to 8 (at most 1024 threads)")
    offs = e.slice_offset.astype(np.int64)
    n_slices = offs.shape[0] - 1
    n_steps = int(offs[-1]) if n_slices else 0
    w = _window_rows(e)[:, :n_steps]
    nwin = w.shape[0]
    n_xrows = e.padded_x_rows // LANES
    # distinct windows per slice, sorted by (slice, window row)
    step_slice = np.repeat(np.arange(n_slices, dtype=np.int64), np.diff(offs))
    key = np.unique((step_slice[None, :] * n_xrows + w).reshape(-1))
    win_slice, win_row = key // n_xrows, (key % n_xrows).tolist()
    win_ptr = np.searchsorted(win_slice, np.arange(n_slices + 1))

    block_stage, stage_step, stage_slice, stage_rows = [0], [0], [], []

    def close_stage(end_step: int, rows: set, lo: int, hi: int) -> None:
        stage_step.append(end_step)
        stage_slice.append((lo, hi))
        stage_rows.append(sorted(rows))

    run_rows: set = set()
    run_start = 0
    chunked = 0
    for s in range(n_slices):
        rows_s = _rows_of(win_row[win_ptr[s]:win_ptr[s + 1]])
        new = rows_s - run_rows
        if s > run_start and (len(run_rows) + len(new) > slot_rows
                              or s - run_start >= max_run_slices):
            close_stage(int(offs[s]), run_rows, run_start, s)
            block_stage.append(len(stage_rows))
            run_rows, run_start, new = set(), s, rows_s
        if len(rows_s) <= slot_rows:
            run_rows |= new
            continue
        # one slice past the budget: a block of its own, in stages of steps
        chunked += 1
        cur: set = set()
        for step in range(int(offs[s]), int(offs[s + 1])):
            rows_k = _rows_of(w[:, step].tolist())
            if cur and len(cur | rows_k) > slot_rows:
                close_stage(step, cur, s, s + 1)
                cur = set()
            cur |= rows_k
        close_stage(int(offs[s + 1]), cur, s, s + 1)
        block_stage.append(len(stage_rows))
        run_rows, run_start = set(), s + 1
    if run_start < n_slices:
        close_stage(n_steps, run_rows, run_start, n_slices)
        block_stage.append(len(stage_rows))

    stage_step = np.asarray(stage_step, dtype=np.int64)
    sizes = np.array([len(r) for r in stage_rows], dtype=np.int64)
    row_ptr = np.zeros(len(stage_rows) + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(sizes)
    rows = (np.concatenate([np.asarray(r, dtype=np.int64)
                            for r in stage_rows])
            if stage_rows else np.zeros(0, np.int64))
    if row_ptr[-1] >= 2 ** 31 or n_steps >= 2 ** 31:
        raise ValueError("window-cache plan too large for int32 maps")
    # slot of each selector's window: its first row's place in the stage
    step_slot = np.zeros((nwin, e.ell_col.shape[0]), dtype=np.int64)
    if n_steps:
        stage_of = np.searchsorted(stage_step[1:], np.arange(n_steps),
                                   side="right")
        stage_key = np.repeat(np.arange(len(stage_rows)), sizes) * n_xrows \
            + rows
        q = stage_of[None, :] * n_xrows + w
        pos = np.searchsorted(stage_key, q)
        if not np.array_equal(stage_key[np.minimum(pos, rows.size - 1)], q):
            raise AssertionError("a step's window is not staged")
        step_slot[:, :n_steps] = pos - row_ptr[stage_of][None, :]
    col_bytes = e.ell_col.dtype.itemsize
    stats = dict(
        n_blocks=len(block_stage) - 1, n_stages=len(stage_rows),
        chunked_slices=chunked, staged_rows=int(row_ptr[-1]),
        staged_bytes=int(row_ptr[-1]) * LANES * 4,
        body_bytes=int(n_steps) * LANES * (col_bytes + 4),
        x_bytes=e.padded_x_rows * 4,
        max_stage_rows=int(sizes.max()) if sizes.size else 0)
    return WinCachePlan(
        slot_rows=slot_rows, groups=groups,
        block_stage=np.asarray(block_stage, dtype=np.int32),
        stage_slice=np.asarray(stage_slice, dtype=np.int32).reshape(-1, 2),
        stage_step=stage_step.astype(np.int32),
        stage_row_ptr=row_ptr.astype(np.int32),
        stage_rows=rows.astype(np.int32), step_slot=step_slot.astype(
            np.int32), stats=stats)


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
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
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
    if e.ell_col.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"ell_col must be int16 or int32, not "
                         f"{e.ell_col.dtype}")
    if e.ell_val.dtype != torch.float32 or e.ell_col.dim() != 2 \
            or e.ell_col.shape[1] != LANES \
            or e.ell_val.shape != e.ell_col.shape:
        raise ValueError("ell_col/ell_val must both be (steps, 128), "
                         "ell_val float32")
    if p.step_slot.shape != (e.nwin, e.ell_col.shape[0]):
        raise ValueError("the plan's slot maps do not match this body")
    for t in [e.ell_col, e.ell_val, e.slice_offset,
              *(getattr(p, f) for f in p.ARRAY_FIELDS)]:
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
    n_slices = e.slice_offset.shape[0] - 1
    y = torch.empty(n_slices * LANES, dtype=torch.float32,
                    device=x_pad.device)
    rc = _lib.ehyb_wincache_body(
        e.ell_col.data_ptr(), e.ell_col.element_size(), e.ell_val.data_ptr(),
        e.slice_offset.data_ptr(), p.step_slot.data_ptr(),
        p.step_slot.shape[1], e.nwin, int(bool(kahan)),
        p.block_stage.data_ptr(), p.stage_slice.data_ptr(),
        p.stage_step.data_ptr(), p.stage_row_ptr.data_ptr(),
        p.stage_rows.data_ptr(), p.slot_rows, p.groups, x_pad.data_ptr(),
        y.data_ptr(), p.n_blocks,
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
    one staging tensor, decode each cell through its step's slot, sum per
    slice.  With ``kahan`` it sums in float64 and rounds once, the answer
    the compensated kernel reaches to about one ulp."""
    n_slices = e.slice_offset.shape[0] - 1
    n_steps = p.n_steps
    if n_steps == 0 or e.body_nnz == 0:
        return x_pad.new_zeros(n_slices * LANES)
    x_rows = x_pad[:x_pad.shape[0] // LANES * LANES].view(-1, LANES)
    staged = x_rows.index_select(0, p.stage_rows.long()).reshape(-1)
    steps = torch.arange(n_steps, device=x_pad.device)
    stage = torch.searchsorted(p.stage_step[1:].long(), steps, right=True)
    base = p.stage_row_ptr.long()[stage]
    idx = e.ell_col[:n_steps].to(torch.int32)
    slot = p.step_slot[:, :n_steps].long()
    lo = idx & 127
    if e.nwin == 1:
        row = slot[0][:, None] + (idx >> 7)
    else:
        attr = torch.gather(idx, 1, lo.long())
        row = torch.gather(slot.t(), 1, (attr >> 10).long()) \
            + ((attr >> 7) & 7)
    flat = (base[:, None] + row) * LANES + lo
    contrib = e.ell_val[:n_steps].to(x_pad.dtype) * staged[flat]
    acc = torch.float64 if kahan else x_pad.dtype
    return _sum_slices(contrib, e.slice_offset, n_slices,
                       acc).to(x_pad.dtype)
