"""The routed engine on the GPU: the one-pass apply, the plain versions of
the TPU's two stages, the spill tail and the epilogues.

Port counterpart of ``ehyb_spmv_gpu_tpu/ops/route_pallas.py``.  The TPU runs
the schedule in two Pallas stages, K7 (``_route_at_kernel``: stages A+T) and
K8 (``_make_route_b_kernel``: stage B), plus an XLA spill tail.  The H100
runs all three as one kernel, ``csrc/route_xcache.cu``, over a plan the
host decodes once from the schedule (``ops/route_xcache.py``); see its
header for why.  :func:`route_at_plain` and :func:`route_b_plain` stay as the
CPU reference of the schedule itself (held against the JAX stages), and
:func:`spill_tail` as its spill.  The epilogue returns the dst-space y to
input space: a slice for identity-dst schedules, one index copy otherwise.
"""
from __future__ import annotations

import torch

from ..config import LANES
from ..core.route import TS, RoutedDevice, RoutedEpilogue, RoutedMatrix
from .route_xcache import RoutePlanDevice, build_route_plan, route_xcache

#: Product rows of one fused A+T grid step (the TPU's ``T_QC``): a grid step
#: covers ``T_QC * 128`` = 1024 width-steps of one band group.
T_QC = 8


def _repeat(t: torch.Tensor, k: int) -> torch.Tensor:
    """Each element ``k`` times in a row (``repeat_interleave`` by a
    constant, written so that it never waits for the device)."""
    return t[:, None].expand(-1, k).reshape(-1)


def route_at_plain(d: RoutedDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """Stages A+T of the schedule (what the TPU's K7 computes): the products
    of the A stream, band-major, flat (n_bg * 128 * gr * 128,)."""
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


def route_b_plain(d: RoutedDevice, t: torch.Tensor) -> torch.Tensor:
    """Stage B of the schedule (what the TPU's K8 computes): the dst-space
    row sums of the band-major products ``t``, (n_dst_rows,)."""
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


def to_input_space(d: RoutedEpilogue, y_dst: torch.Tensor) -> torch.Tensor:
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
    """Routed SpMV of one schedule: the one-pass kernel over its plan
    (routed and spilled entries), then the epilogue (the role of
    ``make_routed_apply``).  ``forward(x_pad)`` takes x padded to
    ``padded_x_rows`` in the schedule's column space and returns y of
    ``out_rows`` rows in input space."""

    def __init__(self, d: RoutedEpilogue, plan: RoutePlanDevice):
        super().__init__()
        self.d = d
        self.plan = plan

    @classmethod
    def of(cls, rm: RoutedMatrix, device="cuda") -> "RoutedApply":
        """Build the plan of ``rm`` and upload it with the epilogue's maps
        (the schedule's stage arrays stay on the host), on the card unless
        the caller asks for the CPU; a CUDA request without a CUDA device
        raises."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"RoutedApply: device {device} requested but "
                               "CUDA is not available")
        return cls(RoutedEpilogue(rm).to(device),
                   build_route_plan(rm).to_torch(device))

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        return to_input_space(self.d, route_xcache(self.plan, x_pad))
