"""Benchmark timing + throughput math.

Port counterpart of ``ehyb_spmv_gpu_tpu/utils/timing.py``.  The reference's
protocol (``spmv.cu:94-122``): warm-up iterations, then a timed loop of
SpMVs, reporting ``GFLOP/s = 1e-9 · (2·nnz) · iter / seconds`` — the formula
at ``spmv.cu:121-122`` — plus a bytes-moved model and a roofline fraction.

On a CUDA device the timed region is bracketed by CUDA events and ends in a
synchronize.  On the CPU the host clock times it, and the result says
``cpu``: it is never a device number.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from .graphs import CapturedGraph
from .log import get_logger

log = get_logger(__name__)

#: Device-memory bandwidth (bytes/s) by card, for roofline audits (NVIDIA's
#: data sheets).  Matched against ``torch.cuda.get_device_name()``; the first
#: key found in the lower-cased name wins.
HBM_BW = {
    "h100 pcie": 2.0e12,
    "h100": 3.35e12,      # SXM
}


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def detect_hbm_bw(device: torch.device) -> Optional[float]:
    """The card's bandwidth, or None where no entry matches (the CPU
    included): then no roofline is reported."""
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for k, bw in HBM_BW.items():
        if k in kind:
            return bw
    log.warning("no bandwidth entry for %r; roofline not reported", kind)
    return None


@dataclasses.dataclass
class BenchResult:
    name: str
    device: str
    nnz: int
    iters: int
    seconds: float
    gflops: float          # reference formula (spmv.cu:121)
    nnz_per_sec: float
    bytes_model: int       # modeled bytes moved per iteration
    roofline_gflops: Optional[float]
    roofline_frac: Optional[float]

    def __str__(self) -> str:
        roof = ("" if self.roofline_gflops is None else
                f", roofline {self.roofline_gflops:.0f} GFLOP/s "
                f"→ {100 * self.roofline_frac:.1f}%")
        return (f"[{self.name} on {self.device}] {self.iters} iters in "
                f"{self.seconds * 1e3:.2f} ms → {self.gflops:.2f} GFLOP/s "
                f"({self.nnz_per_sec / 1e9:.2f} Gnnz/s){roof}")


def phase_roofline(stats: dict, value_bytes: int = 4,
                   ell_index_bytes: int = 4, dim: int = 0) -> dict:
    """(flops, device-memory bytes) per iteration of each EHYB phase from
    the converter's stats: streamed values and indices (padding included:
    zeros move bytes too; the diagonals carry no indices), plus one x read
    and one y write."""
    st = stats.get
    return {
        "x/y vectors": (0, 2 * dim * value_bytes),
        "dia": (2 * st("nnz_dia", 0),
                (st("nnz_dia", 0) + st("waste_dia", 0)) * value_bytes),
        "body": (2 * st("nnz_ell", 0),
                 (st("nnz_ell", 0) + st("waste_ell", 0))
                 * (value_bytes + ell_index_bytes)),
        "er": (2 * st("nnz_er", 0),
               (st("nnz_er", 0) + st("waste_er", 0)) * (value_bytes + 4)),
        "long": (2 * st("nnz_long", 0), st("nnz_long", 0) * (value_bytes + 4)),
    }


def spmv_bytes_model(stats: dict, value_bytes: int = 4,
                     ell_index_bytes: int = 4, dim: int = 0) -> int:
    """Modeled device-memory bytes per SpMV iteration: the sum of
    :func:`phase_roofline`'s bytes."""
    return int(sum(b for _, b in phase_roofline(
        stats, value_bytes, ell_index_bytes, dim).values()))


def timed_seconds(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds one call of ``fn`` takes on ``device``: CUDA events and a
    synchronize on a card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_apply(name: str, apply_iters: Callable[[int], torch.Tensor],
                nnz: int, device: torch.device, iters: int = 2000,
                warmup: int = 10,
                bytes_model: Optional[int] = None) -> BenchResult:
    """Time ``apply_iters(n)`` (n chained SpMVs): ``warmup`` iterations,
    then one timed region of ``iters`` (``spmv.cu:100-119``).  Raises if a
    CUDA graph was captured inside the timed region."""
    device = torch.device(device)
    apply_iters(warmup)
    captures = CapturedGraph.captures
    dt = timed_seconds(lambda: apply_iters(iters), device)
    if CapturedGraph.captures != captures:
        raise RuntimeError(
            f"{CapturedGraph.captures - captures} CUDA graph(s) captured "
            "inside the timed region: the warm-up call must capture every "
            "graph the timed call replays")
    gflops = 1e-9 * (2.0 * nnz) * iters / dt
    bw = detect_hbm_bw(device)
    bm = bytes_model if bytes_model is not None else nnz * 8
    roofline = 1e-9 * (2.0 * nnz) * bw / bm if bw and bm else None
    res = BenchResult(
        name=name, device=device_name(device), nnz=nnz, iters=iters,
        seconds=dt, gflops=gflops, nnz_per_sec=nnz * iters / dt,
        bytes_model=bm, roofline_gflops=roofline,
        roofline_frac=gflops / roofline if roofline else None)
    log.info("%s", res)
    return res
