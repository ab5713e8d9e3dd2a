"""The streamed SELL body on the GPU: wrapper, plain version and host maps.

Port counterpart of the resident streamed body in
``ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py`` (``_make_stream_resident_kernel``
and the branch of ``make_ehyb_pallas_apply`` that runs it).  The kernel is
``csrc/ehyb_stream.cu``; see its header for what it computes, what bounds
it on the H100, and how it replaces the TPU's sequential-grid carry.

:func:`stream_body` launches the kernel for tensors on a CUDA device and
takes the plain version :func:`stream_body_plain` only for tensors on the
CPU.  A CUDA call launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..config import LANES, SUBLANES_F32
from ..core.ehyb import EhybDevice, EhybMatrix
from .build import BuiltLibrary, build_cuda_library
from .torch_ops import (combine_ehyb, ehyb_body, ehyb_dia, ehyb_er,
                        ehyb_long)

#: Width-steps per TPU sub-tile (one (8,128) vreg of nnz).
TILE_STEPS = SUBLANES_F32
#: TPU sub-tiles per grid step of the older per-slice body; the flagship pins
#: slice widths to multiples of SUBTILES * TILE_STEPS so both packages pack
#: the same layout.
SUBTILES = 4
#: TPU sub-tiles per streamed grid step (the geometry of the stream maps).
STREAM_SUBTILES = 32
#: The TPU's x-residency limit.  The GPU keeps x in device memory at any
#: size; the flagship reads this only to pick the layout the TPU picks.
X_RESIDENT_BYTES = 64 * 1024 * 1024

_lock = threading.Lock()
_built = None
_lib = None


def build_kernel() -> BuiltLibrary:
    """Compile ``csrc/ehyb_stream.cu`` (once per process) and return the
    library's path, build time and ptxas report."""
    global _built, _lib
    with _lock:
        if _built is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the streamed SELL-body kernel needs a "
                                   "CUDA device; none is available")
            built = build_cuda_library("ehyb_stream", ["ehyb_stream.cu"])
            lib = ctypes.CDLL(built.path)
            lib.ehyb_stream_body.restype = ctypes.c_int
            lib.ehyb_stream_body.argtypes = (
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
            _built, _lib = built, lib
        return _built


def _check(e: EhybDevice, x_pad: torch.Tensor) -> None:
    """Refuse anything the kernel does not take."""
    dev = x_pad.device
    if x_pad.dtype != torch.float32 or x_pad.dim() != 1 \
            or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous 1-D float32 tensor")
    if x_pad.shape[0] < e.padded_x_rows:
        raise ValueError(f"x_pad has {x_pad.shape[0]} rows; the windows "
                         f"need {e.padded_x_rows}")
    steps = e.ell_col.shape[0]
    if e.ell_col.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"ell_col must be int16 or int32, not "
                         f"{e.ell_col.dtype}")
    if e.ell_val.dtype != torch.float32:
        raise ValueError(f"ell_val must be float32, not {e.ell_val.dtype}")
    if e.ell_col.dim() != 2 or e.ell_col.shape[1] != LANES \
            or e.ell_val.shape != e.ell_col.shape:
        raise ValueError("ell_col/ell_val must both be (steps, 128)")
    n_slices = e.slice_offset.shape[0] - 1
    if e.slice_offset.dtype != torch.int32 or n_slices < 0:
        raise ValueError("slice_offset must be int32 (n_slices + 1,)")
    wins = [e.step_win, e.step_win_b, e.step_win_c, e.step_win_d][:e.nwin]
    for w in wins:
        if w.dtype != torch.int32 or w.shape != (steps,):
            raise ValueError("window maps must be int32 (steps,)")
    for t in [e.ell_col, e.ell_val, e.slice_offset, *wins]:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, x_pad on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def stream_body(e: EhybDevice, x_pad: torch.Tensor,
                kahan: bool = False) -> torch.Tensor:
    """SELL-body sums per row lane, flattened to (n_slices * 128,).

    CPU tensors take :func:`stream_body_plain`; CUDA tensors launch the
    kernel (``kahan`` selects the compensated variant) or raise."""
    if x_pad.device.type == "cpu":
        return stream_body_plain(e, x_pad, kahan)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    _check(e, x_pad)
    build_kernel()
    n_slices = e.slice_offset.shape[0] - 1
    y = torch.empty(n_slices * LANES, dtype=torch.float32,
                    device=x_pad.device)
    w = [e.step_win, e.step_win_b, e.step_win_c, e.step_win_d][:e.nwin]
    w = w + [e.step_win] * (4 - len(w))       # unused maps alias win0
    rc = _lib.ehyb_stream_body(
        e.ell_col.data_ptr(), e.ell_col.element_size(), e.ell_val.data_ptr(),
        e.slice_offset.data_ptr(), *(t.data_ptr() for t in w), e.nwin,
        int(bool(kahan)), x_pad.data_ptr(), y.data_ptr(), n_slices,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_stream_body launch failed: CUDA error {rc}")
    if n_slices:
        stream_body.launches += 1
    return y


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
stream_body.launches = 0


def stream_body_plain(e: EhybDevice, x_pad: torch.Tensor,
                      kahan: bool = False) -> torch.Tensor:
    """Plain-torch version of the kernel (same inputs, same output).  With
    ``kahan`` it sums in float64 and rounds once, the answer the
    compensated kernel reaches to about one ulp."""
    return ehyb_body(e, x_pad, compensated=kahan)


class EhybStreamApply(torch.nn.Module):
    """Device apply of the flagship: the streamed body plus the torch ER,
    long-row, DIA and combine phases.  ``forward(x_pad)`` → padded y."""

    def __init__(self, e: EhybDevice, kahan: bool = False):
        super().__init__()
        self.e = e
        self.kahan = kahan

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        e = self.e
        if e.body_nnz == 0:
            # everything went to DIA/ER/long: nothing for the body to do
            y_body = x_pad.new_zeros(e.slice_win_start.shape[0] * LANES)
        else:
            y_body = stream_body(e, x_pad, self.kahan)
        return combine_ehyb(e, y_body, ehyb_er(e, x_pad),
                            ehyb_long(e, x_pad), ehyb_dia(e, x_pad))


# ---------------------------------------------------------------------------
# Host maps (copied from ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py; keep in step).
# ---------------------------------------------------------------------------

def build_stream_maps(e: EhybMatrix, spt: int = None):
    """Host metadata for the streamed body: per-sub-tile window rows and the
    sub-tile → slice segment ids (padding sub-tiles map to the dump slice
    ``n_slices``).  Steps are padded to a whole number of stream tiles.

    Returns (sub_wins, sub_slice, reset, last_sub, n_tiles); ``sub_wins`` is
    a LIST of per-sub-tile window-row maps — one entry for the chunk-sync
    layouts, two for dual-window ``sell_rx``, four for quad
    (windows_per_subtile=4); ``reset`` flags each slice's first sub-tile
    (for the in-kernel cumulative accumulator); ``last_sub[s]`` is the
    sub-tile whose emitted running sum is slice s's finished total.

    The CUDA kernel needs none of these maps (it reads the per-step window
    arrays); the flagship uses this to check the same layout invariants the
    TPU checks, so both land on the same layout.
    """
    widths = np.diff(e.slice_offset.astype(np.int64))
    if not np.all(widths % TILE_STEPS == 0):
        raise ValueError("slice widths must be multiples of 8")
    n_sub = e.step_win.shape[0] // TILE_STEPS
    spt = spt or STREAM_SUBTILES
    n_tiles = max(1, -(-n_sub // spt))
    sub_wins = []
    win_arrays = [e.step_win, e.step_win_b, e.step_win_c, e.step_win_d]
    for a in win_arrays:
        if a is None or not a.size:
            break
        sw = a.astype(np.int64).reshape(-1, TILE_STEPS)
        if not np.all(sw == sw[:, :1]):
            raise ValueError(
                "window must be constant within each 8-step sub-tile")
        m = np.zeros(n_tiles * spt, dtype=np.int32)
        m[:n_sub] = (sw[:, 0] // LANES).astype(np.int32)
        sub_wins.append(m)
    sub_slice = np.full(n_tiles * spt, e.n_slices, dtype=np.int32)  # dump
    step_slice = np.repeat(np.arange(e.n_slices, dtype=np.int32),
                           widths // TILE_STEPS)
    sub_slice[:n_sub] = step_slice
    reset = np.zeros(n_tiles * spt, dtype=np.int32)
    reset[0] = 1
    reset[1:] = sub_slice[1:] != sub_slice[:-1]
    last_sub = np.searchsorted(sub_slice, np.arange(e.n_slices),
                               side="right").astype(np.int32) - 1
    return sub_wins, sub_slice, reset, last_sub, n_tiles


def stream_body_fits(e: EhybMatrix, value_bytes: int = 4) -> bool:
    """True iff the streamed body can serve this matrix (resident case of
    the TPU predicate: the stream-map invariants hold and the body is not
    empty)."""
    if e.stats.get("nnz_ell", 1) == 0:
        return False
    try:
        build_stream_maps(e)
    except ValueError:
        return False
    return True
