"""CUDA graphs of the device loops: capture, replay and the launch counts.

The JAX package runs its loops as one compiled device program each (a
``fori_loop`` of chained products, a CG ``while_loop``, a power-iteration
``fori_loop``).  PyTorch launches every op from Python, ~10 µs of host time
a launch on the card's machine, which is more than a small product takes on
the card.  So on a CUDA device each loop body is captured once in a
``torch.cuda.CUDAGraph`` and replayed: the host launches one graph for many
kernels, and the card runs them back to back.

A capture records the launches its ops make without running them.  The
kernel wrappers count a launch when they make one, so a capture would count
launches that never ran and a replay none of those that do: a
:class:`CapturedGraph` puts the counts back after its capture and adds the
launches it holds at each replay.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from .log import get_logger

log = get_logger(__name__)


def launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` count the card's kernels."""
    from ..ops import dia, ehyb_stream, ehyb_wincache, route_xcache

    return (ehyb_stream.stream_body, route_xcache.route_xcache, dia.dia_body,
            ehyb_wincache.wincache_body)


def warm_up(fn: Callable[[], object], device: torch.device) -> None:
    """Run ``fn`` once on a side stream before a capture, so that what its
    first call does only once (building a kernel, a plan's table upload, the
    allocator's first blocks) happens outside the graph."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


class CapturedGraph:
    """``fn()`` captured once in a CUDA graph on ``device``; ``out`` is what
    the captured call returned, rewritten in place by every replay.  A
    failed capture raises: nothing falls back to launching eagerly."""

    #: Graphs captured in this process; a timed region that replays graphs
    #: must leave it unchanged (``utils/timing.py::bench_apply`` checks).
    captures = 0

    def __init__(self, fn: Callable[[], object], device: torch.device):
        counters = launch_counters()
        before = [c.launches for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(self.graph):
                self.out = fn()
        finally:
            during = [c.launches for c in counters]
            for c, n in zip(counters, before):
                c.launches = n
        #: Kernel launches one replay makes, per counter.
        self.launches: List[int] = [d - b for d, b in zip(during, before)]
        self._counters = counters
        CapturedGraph.captures += 1

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        for c, n in zip(self._counters, self.launches):
            c.launches += n * times
