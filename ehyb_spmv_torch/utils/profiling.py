"""Profiling and the roofline audit.

Port counterpart of ``ehyb_spmv_gpu_tpu/utils/profiling.py``:

  * :func:`trace` — a ``torch.profiler`` trace of the enclosed region (the
    card's kernels where there is one), written as a Chrome trace file;
  * :func:`roofline_report` — bytes and flops per phase of what the card
    moves, the model's own ``roofline_phases`` (the plans' compact cells
    where a plan runs the body), whose total is ``model.bytes_model()``,
    with the achieved share from a measured :class:`~.timing.BenchResult`;
  * :func:`phase_breakdown` — seconds per call of each EHYB phase (DIA,
    body, ER, long) and of the full apply, on a card from CUDA events
    around the replay of a CUDA graph of many calls.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .graphs import CapturedGraph, warm_up
from .log import get_logger
from .timing import BenchResult, detect_hbm_bw

log = get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` (CPU ops, and
    the card's kernels where CUDA is available) and write a Chrome trace
    into ``logdir``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-"
                                f"{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def roofline_report(model, result: Optional[BenchResult] = None) -> str:
    """Per-phase flops and device-memory bytes of one iteration, each with
    the least time the card's bandwidth allows (where it is known), the
    total (``model.bytes_model()``) and, given ``result``, the measured
    time per iteration and its share of that floor."""
    phases = model.roofline_phases()
    bw = detect_hbm_bw(model.device)
    lines = [f"roofline audit ({model.name}; "
             + (f"{bw / 1e12:.2f} TB/s):" if bw else
                "no device bandwidth: bytes and flops only):")]
    total_b = sum(b for _, b in phases.values())
    for name, (flops, n_bytes) in phases.items():
        if flops == 0 and n_bytes == 0:
            continue
        line = (f"  {name:16s} {flops / 1e6:9.1f} Mflop "
                f"{n_bytes / 1e6:9.1f} MB (AI {flops / max(n_bytes, 1):.2f})")
        if bw:
            line += f" → ≥{n_bytes / bw * 1e6:8.1f} us/iter"
        lines.append(line)
    line = f"  total bytes/iter: {total_b / 1e6:.1f} MB"
    if bw:
        line += f" → floor {total_b / bw * 1e6:.1f} us/iter"
    lines.append(line)
    if result is not None:
        line = (f"  measured: {result.seconds / result.iters * 1e6:.1f} "
                f"us/iter on {result.device}")
        if result.roofline_frac is not None:
            line += f" → {100 * result.roofline_frac:.1f}% of the roofline"
        lines.append(line)
    return "\n".join(lines)


def phase_breakdown(model, x_dev, iters: int = 100) -> Dict[str, float]:
    """Seconds per call of each phase of one apply (``dia``, ``body``,
    ``er``, ``long``, for the EHYB models) and of the whole apply
    (``full_apply``, every model), each called alone on ``x_dev``.

    On a card: ``iters`` calls captured in one CUDA graph, replayed once
    between CUDA events after a warm replay (device time, no host launch
    cost).  On the CPU: the host clock over ``iters`` eager calls."""
    phases = getattr(model.module, "phases", None)
    fns = dict(phases()) if phases is not None else {}
    fns["full_apply"] = model.apply
    device = model.device
    out = {}
    for name, fn in fns.items():
        def calls(fn=fn):
            for _ in range(iters):
                fn(x_dev)

        if device.type != "cuda":
            t0 = time.perf_counter()
            calls()
            out[name] = (time.perf_counter() - t0) / iters
            continue
        with torch.no_grad():
            if fn(x_dev).numel() == 0:
                out[name] = 0.0        # an empty phase launches nothing
                continue
            warm_up(lambda: fn(x_dev), device)
            graph = CapturedGraph(calls, device)
        graph.replay()
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / 1e3 / iters
    return out
