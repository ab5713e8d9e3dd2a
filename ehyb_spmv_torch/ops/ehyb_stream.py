"""The streamed SELL body on the GPU (K1): wrapper, plain version, and the
flagship's apply.

Port counterpart of the resident streamed body in
``ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py`` (``_make_stream_resident_kernel``
and the branch of ``make_ehyb_pallas_apply`` that runs it).  The kernel is
``csrc/ehyb_stream.cu``; see its header for what it computes, what bounds
it on the H100, and how it replaces the TPU's sequential-grid carry.  It
reads its window maps from device memory at any size, so it also computes
the bodies the TPU gives to K2 (maps in HBM meta blocks), K5 and K6 (the
per-slice chunk-sync bodies).  :func:`make_stream_apply` picks K1 or the
window-cache kernel (``ops/ehyb_wincache.py``) by the TPU's branch.

:func:`stream_body` launches the kernel for tensors on a CUDA device and
takes the plain version :func:`stream_body_plain` only for tensors on the
CPU.  A CUDA call launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..config import LANES
from ..core.ehyb import EhybDevice, EhybMatrix
from ..utils.log import get_logger
from . import stream_plan
from .build import BuiltLibrary, build_cuda_library
from .dia import dia_body
from .ehyb_wincache import WinCacheDevice, build_wincache_plan, wincache_body
from .torch_ops import combine_ehyb, ehyb_body, ehyb_er, ehyb_long

log = get_logger(__name__)

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
    """Device apply of the flagship: the body kernel, the DIA kernel and the
    torch ER, long-row and combine phases.  ``forward(x_pad)`` → padded y.

    The body runs through the window-cache kernel when ``wincache`` (its
    plan on the device) is given, else through K1."""

    def __init__(self, e: EhybDevice, kahan: bool = False,
                 wincache: WinCacheDevice = None, branch: str = ""):
        super().__init__()
        self.e = e
        self.kahan = kahan
        self.wincache = wincache
        #: The TPU branch the JAX flagship takes for this artifact.
        self.branch = branch

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        e = self.e
        if e.body_nnz == 0:
            # everything went to DIA/ER/long: nothing for the body to do
            y_body = x_pad.new_zeros(e.slice_win_start.shape[0] * LANES)
        elif self.wincache is not None:
            y_body = wincache_body(e, self.wincache, x_pad, self.kahan)
        else:
            y_body = stream_body(e, x_pad, self.kahan)
        return combine_ehyb(e, y_body, ehyb_er(e, x_pad),
                            ehyb_long(e, x_pad), dia_body(e, x_pad))


def make_stream_apply(e: EhybMatrix, dev: EhybDevice, kahan: bool = False,
                      value_bytes: int = 4) -> EhybStreamApply:
    """The flagship's apply for this artifact: the TPU branch decides the
    body kernel.  Where the JAX package runs K3 or K4 (x past
    ``X_RESIDENT_BYTES`` and the window-cache plan schedules) the body goes
    through the window-cache kernel; everywhere else through K1, which
    computes the bodies of K2, K5 and K6 and the XLA fallbacks too.

    The window-cache plan holds the body's real cells in a layout of its
    own, so ``dev`` then gives up its padded cells (``ell_col`` and
    ``ell_val`` become None); ``e`` keeps them on the host."""
    branch = stream_plan.tpu_body_branch(e, value_bytes)
    wincache = None
    if stream_plan.BRANCH_KERNEL[branch] in ("K3", "K4"):
        plan = build_wincache_plan(e)
        wincache = plan.to_torch(dev.ell_col.device)
        dev.ell_col = dev.ell_val = None
        st = plan.stats
        log.info("body [%s on the TPU]: window-cache kernel, %d "
                 "blocks, %d stages (%d chunked slices), %.1f MB of cells "
                 "in place of %.1f MB padded, staged %.1f MB of %.1f MB "
                 "of x", branch, st["n_blocks"], st["n_stages"],
                 st["chunked_slices"], st["cell_bytes"] / 1e6,
                 st["body_bytes"] / 1e6, st["staged_bytes"] / 1e6,
                 st["x_bytes"] / 1e6)
    else:
        log.info("body [%s on the TPU]: %s", branch,
                 "none (all DIA/ER/long)" if branch == "skipped" else "K1")
    return EhybStreamApply(dev, kahan=kahan, wincache=wincache,
                           branch=branch)
