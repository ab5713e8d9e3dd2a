"""The routed engine on the GPU: kernels K7 and K8, their plain versions, the
spill tail and the epilogues.

Port counterpart of ``ehyb_spmv_gpu_tpu/ops/route_pallas.py``.  The kernels
are ``csrc/route_at.cu`` (stages A+T, replacing ``_route_at_kernel``) and
``csrc/route_b.cu`` (stage B, replacing ``_make_route_b_kernel``); see their
headers for what each computes, what bounds it on the H100 and how it
replaces the TPU's sequential-grid carry.  The spill tail is a torch
``index_add_`` (the JAX package's XLA scatter-add), and the epilogue returns
the dst-space y to input space: a slice for identity-dst schedules, one
index copy otherwise.

:func:`route_at` and :func:`route_b` launch their kernels for tensors on a
CUDA device and take the plain versions only for tensors on the CPU.  A
CUDA call launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..config import LANES
from ..core.route import TS, RoutedDevice
from .build import BuiltLibrary, build_cuda_library

#: Product rows of one fused A+T grid step (the TPU's ``T_QC``): a grid step
#: covers ``T_QC * 128`` = 1024 width-steps of one band group.
T_QC = 8

_lock = threading.Lock()
_built = {}
_libs = {}


def _build(name: str, bind) -> BuiltLibrary:
    with _lock:
        if name not in _built:
            if not torch.cuda.is_available():
                raise RuntimeError(f"the routed kernel {name} needs a CUDA "
                                   "device; none is available")
            built = build_cuda_library(name, [f"{name}.cu"])
            lib = ctypes.CDLL(built.path)
            bind(lib)
            _built[name], _libs[name] = built, lib
        return _built[name]


def _bind_at(lib) -> None:
    lib.ehyb_route_at.restype = ctypes.c_int
    lib.ehyb_route_at.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _bind_b(lib) -> None:
    lib.ehyb_route_b.restype = ctypes.c_int
    lib.ehyb_route_b.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]


def build_route_at() -> BuiltLibrary:
    """Compile ``csrc/route_at.cu`` (once per process)."""
    return _build("route_at", _bind_at)


def build_route_b() -> BuiltLibrary:
    """Compile ``csrc/route_b.cu`` (once per process)."""
    return _build("route_b", _bind_b)


def _check(tensors: dict, device: torch.device) -> None:
    """Refuse anything the kernels do not take: ``tensors`` maps a name to
    (tensor, dtype, shape); a None extent accepts any length."""
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, not {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != n for s, n in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _repeat(t: torch.Tensor, k: int) -> torch.Tensor:
    """Each element ``k`` times in a row (``repeat_interleave`` by a
    constant, written so that it never waits for the device)."""
    return t[:, None].expand(-1, k).reshape(-1)


# ---------------------------------------------------------------------------
# K7: stages A+T.
# ---------------------------------------------------------------------------

def route_at(d: RoutedDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """Products of the A stream, band-major: flat (n_bg * 128 * gr * 128,).

    CPU tensors take :func:`route_at_plain`; CUDA tensors launch the kernel
    or raise."""
    if x_pad.device.type == "cpu":
        return route_at_plain(d, x_pad)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    steps = d.a_col.shape[0]
    if steps != d.n_bg * d.gr * LANES:
        raise ValueError(f"A stream has {steps} steps; the band-major "
                         f"output needs {d.n_bg * d.gr * LANES}")
    _check({"a_col": (d.a_col, torch.int16, (steps, LANES)),
            "a_val": (d.a_val, torch.float32, (steps, LANES)),
            "a_win": (d.a_win, torch.int32, (steps // TS,)),
            "x_pad": (x_pad, torch.float32, (None,))}, x_pad.device)
    if x_pad.shape[0] < d.padded_x_rows:
        raise ValueError(f"x_pad has {x_pad.shape[0]} rows; the windows "
                         f"need {d.padded_x_rows}")
    build_route_at()
    out = torch.empty(steps * LANES, dtype=torch.float32,
                      device=x_pad.device)
    rc = _libs["route_at"].ehyb_route_at(
        d.a_col.data_ptr(), d.a_val.data_ptr(), d.a_win.data_ptr(),
        x_pad.data_ptr(), out.data_ptr(), steps, d.gr, _stream(x_pad.device))
    if rc != 0:
        raise RuntimeError(f"ehyb_route_at launch failed: CUDA error {rc}")
    if steps:
        route_at.launches += 1
    return out


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
route_at.launches = 0


def route_at_plain(d: RoutedDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of K7 (same inputs, same output, bit for bit)."""
    col = d.a_col.to(torch.int32)
    lo = col & 127
    hi = torch.gather(col, 1, lo.long()) >> 7   # slot attribute at lane lo
    win = _repeat(d.a_win, TS)[:, None]
    idx = ((win + hi) * LANES + lo).reshape(-1)
    prod = d.a_val * x_pad.index_select(0, idx).reshape(col.shape)
    # step t of grid step (b, q) and lane l go to out[b, l, q*8 + t//128,
    # t%128]: the TPU's in-register (128, 128) tile transposes
    nq = d.gr // T_QC
    return prod.reshape(d.n_bg, nq, T_QC, LANES, LANES) \
        .permute(0, 4, 1, 2, 3).reshape(-1)


# ---------------------------------------------------------------------------
# K8: stage B.
# ---------------------------------------------------------------------------

def route_b(d: RoutedDevice, t: torch.Tensor) -> torch.Tensor:
    """Dst-space row sums of the routed products: (n_dst_rows,).

    CPU tensors take :func:`route_b_plain`; CUDA tensors launch the kernel
    or raise."""
    if t.device.type == "cpu":
        return route_b_plain(d, t)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    steps = d.b_idx.shape[0]
    n_sub = steps // TS
    n_segs = d.n_segs
    _check({"b_idx": (d.b_idx, torch.int16, (steps, LANES)),
            "b_gmap": (d.b_gmap, torch.int32, (n_sub // d.s_b,)),
            "b_boff": (d.b_boff, torch.int32, (n_sub,)),
            "seg_first": (d.seg_first, torch.int32, (n_segs,)),
            "seg_last": (d.seg_last, torch.int32, (n_segs,)),
            "t": (t, torch.float32, (d.n_bg * LANES * d.gr * LANES,))},
           t.device)
    if n_segs * (TS if d.octet else 1) * LANES != d.n_dst_rows:
        raise ValueError("segments do not cover the dst rows")
    build_route_b()
    y = torch.empty(d.n_dst_rows, dtype=torch.float32, device=t.device)
    rc = _libs["route_b"].ehyb_route_b(
        d.b_idx.data_ptr(), d.b_gmap.data_ptr(), d.b_boff.data_ptr(),
        d.seg_first.data_ptr(), d.seg_last.data_ptr(), t.data_ptr(),
        y.data_ptr(), n_segs, d.s_b, d.bands_per_block * d.gr, d.chain,
        int(d.octet), _stream(t.device))
    if rc != 0:
        raise RuntimeError(f"ehyb_route_b launch failed: CUDA error {rc}")
    if n_segs:
        route_b.launches += 1
    return y


#: Kernel launches since the count was last reset.
route_b.launches = 0


def route_b_plain(d: RoutedDevice, t: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of K8 (same inputs, same output; the sums run in
    another order)."""
    iv = d.b_idx.to(torch.int32)
    src = iv & 127
    attr = torch.gather(iv, 1, src.long())     # slot attribute at lane src
    sel = (attr >> 10) & 15
    sel = torch.where(sel < d.chain, sel, 0)
    srow = (attr >> 7) & 7
    masked = (iv >> 14) != 0
    base = _repeat(d.b_gmap, d.s_b) * (d.bands_per_block * d.gr) + d.b_boff
    row = _repeat(base, TS)[:, None] + sel * TS + srow
    gidx = torch.where(masked, 0, row.long() * LANES + src)
    g = torch.where(masked, 0.0,
                    t.index_select(0, gidx.reshape(-1)).reshape(iv.shape))
    # each segment's sub-tiles, first to last (sizes known on the host, so
    # nothing here waits for the device)
    n = (d.seg_last - d.seg_first + 1).long()
    seg = torch.repeat_interleave(
        torch.arange(d.n_segs, device=t.device), n,
        output_size=d.seg_subtiles)
    starts = torch.cumsum(n, 0) - n
    sub = torch.arange(d.seg_subtiles, device=t.device) - starts[seg] \
        + d.seg_first.long()[seg]
    g3 = g.reshape(-1, TS, LANES)
    if d.octet:
        y = t.new_zeros(d.n_segs, TS, LANES)
        y.index_add_(0, seg, g3[sub])
    else:
        y = t.new_zeros(d.n_segs, LANES)
        y.index_add_(0, seg, g3.sum(1)[sub])
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# The routed apply.
# ---------------------------------------------------------------------------

def spill_tail(d: RoutedDevice, x_pad: torch.Tensor,
               y_dst: torch.Tensor) -> torch.Tensor:
    """Add the spilled entries into ``y_dst`` in place (the XLA gather tail
    of the JAX package, as one ``index_add_``)."""
    if d.sp_val.shape[0]:
        y_dst.index_add_(0, d.sp_dst, d.sp_val * x_pad[d.sp_col])
    return y_dst


def to_input_space(d: RoutedDevice, y_dst: torch.Tensor) -> torch.Tensor:
    """Dst-space y → input-space y of ``out_rows`` rows (chainable).
    Identity dst: a slice or a zero pad (synthetic tail rows are exact
    zeros); permuted dst: one index copy."""
    if d.ident:
        if d.out_rows <= d.n_dst_rows:
            return y_dst[:d.out_rows]
        return torch.nn.functional.pad(y_dst,
                                       (0, d.out_rows - d.n_dst_rows))
    y = y_dst.new_zeros(d.out_rows)
    return y.index_copy_(0, d.scat_dst, y_dst[d.scat_src])


class RoutedApply(torch.nn.Module):
    """Routed SpMV of one schedule: K7 → K8 → spill tail → epilogue
    (the role of ``make_routed_apply``).  ``forward(x_pad)`` takes x padded
    to ``padded_x_rows`` in the schedule's column space and returns y of
    ``out_rows`` rows in input space."""

    def __init__(self, d: RoutedDevice):
        super().__init__()
        self.d = d

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        d = self.d
        y_dst = spill_tail(d, x_pad, route_b(d, route_at(d, x_pad)))
        return to_input_space(d, y_dst)
