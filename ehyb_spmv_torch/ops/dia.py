"""The DIA body on the GPU: wrapper and plain version.

Port counterpart of ``ehyb_spmv_gpu_tpu/ops/dia_pallas.py``
(``make_dia_pallas_apply``, the Pallas kernel K9, in both its x-resident and
x-streamed variants).  The kernel is ``csrc/dia.cu``; its header says what
it computes, what bounds it on the H100 and what it leaves behind of the
TPU's blocked layout: it reads the (K, dim_r) ``dia_val`` the device mirror
already holds.

:func:`dia_body` launches the kernel for tensors on a CUDA device and takes
the plain version :func:`dia_body_plain` (the shifted-slice torch op) only
for tensors on the CPU.  A CUDA call launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core.ehyb import EhybDevice
from .build import BuiltLibrary, build_cuda_library
from .torch_ops import ehyb_dia

#: Shared memory the kernel may take for its offsets and staged x span;
#: wider spans read x through __ldg instead.
STAGE_LIMIT_BYTES = 200 * 1024

_lock = threading.Lock()
_built = None
_lib = None
#: (offsets, device) → the offsets as a device int32 tensor, made once so
#: that a call (and a CUDA graph capture of it) copies nothing to the card.
_offsets_on_device: dict = {}


def build_kernel() -> BuiltLibrary:
    """Compile ``csrc/dia.cu`` (once per process) and return the library's
    path, build time and ptxas report."""
    global _built, _lib
    with _lock:
        if _built is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the DIA kernel needs a CUDA device; "
                                   "none is available")
            built = build_cuda_library("ehyb_dia", ["dia.cu"])
            lib = ctypes.CDLL(built.path)
            lib.ehyb_dia.restype = ctypes.c_int
            lib.ehyb_dia.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p]
            lib.ehyb_dia_block_rows.restype = ctypes.c_int
            lib.ehyb_dia_block_rows.argtypes = []
            _built, _lib = built, lib
        return _built


def stages_x(offsets) -> bool:
    """Whether the kernel stages each block's x span in shared memory: the
    span and the offsets, as ``csrc/dia.cu`` lays them out, fit
    ``STAGE_LIMIT_BYTES``."""
    build_kernel()
    n = len(offsets)
    span = max(offsets) - min(offsets) + _lib.ehyb_dia_block_rows()
    return 4 * ((n + 3) // 4 * 4 + span) <= STAGE_LIMIT_BYTES


def _offsets_tensor(offsets: tuple, device) -> torch.Tensor:
    key = (offsets, device)
    t = _offsets_on_device.get(key)
    if t is None:
        t = torch.tensor(offsets, dtype=torch.int32, device=device)
        _offsets_on_device[key] = t
    return t


def _check(e: EhybDevice, x_pad: torch.Tensor) -> None:
    """Refuse anything the kernel does not take."""
    if x_pad.dtype != torch.float32 or x_pad.dim() != 1 \
            or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous 1-D float32 tensor")
    v = e.dia_val
    if v.dtype != torch.float32 or v.dim() != 2 or not v.is_contiguous():
        raise ValueError("dia_val must be a contiguous (K, dim_r) float32 "
                         "tensor")
    if v.shape[0] != len(e.dia_offsets):
        raise ValueError(f"dia_val has {v.shape[0]} rows for "
                         f"{len(e.dia_offsets)} offsets")
    if v.device != x_pad.device:
        raise ValueError(f"dia_val on {v.device}, x_pad on {x_pad.device}")
    if max(abs(d) for d in e.dia_offsets) >= 2 ** 30:
        raise ValueError("diagonal offsets out of int32 range")


def dia_body(e: EhybDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """y[i] = Σ_k dia_val[k, i] · x[i + d_k] for i < dia_val.shape[1], an x
    index outside x_pad reading as zero; length 0 without diagonals.

    CPU tensors take :func:`dia_body_plain`; CUDA tensors launch the kernel
    or raise."""
    if x_pad.device.type == "cpu":
        return dia_body_plain(e, x_pad)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    if not e.dia_offsets:
        return x_pad.new_zeros(0)
    _check(e, x_pad)
    build_kernel()
    offs = e.dia_offsets
    dim_r = e.dia_val.shape[1]
    y = torch.empty(dim_r, dtype=torch.float32, device=x_pad.device)
    rc = _lib.ehyb_dia(
        e.dia_val.data_ptr(), _offsets_tensor(offs, x_pad.device).data_ptr(),
        len(offs), dim_r, min(offs), max(offs), x_pad.data_ptr(),
        x_pad.shape[0], y.data_ptr(), int(stages_x(offs)),
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_dia launch failed: CUDA error {rc}")
    if dim_r:
        dia_body.launches += 1
    return y


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
dia_body.launches = 0


def dia_body_plain(e: EhybDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the kernel: the shifted-slice op, one
    ``addcmul_`` per diagonal (same inputs, same output)."""
    return ehyb_dia(e, x_pad)
