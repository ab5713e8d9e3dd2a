"""SpMV model base: the prepare → apply → recover pipeline contract, and the
chained loop.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/base.py``.  ``setup`` does the
one-time host preprocessing and the device upload; ``prepare_x`` and
``recover_y`` are the vector permutations outside the timed region
(``vectorReorder``/``vectorRecover``, ``solver_test.c:376,383``); ``apply``
runs the device apply module, the only thing inside the benchmark loop.

The model runs on the device it is given, the card unless the caller asks
for the CPU; a CUDA request without a CUDA device raises.  There is no const-
vs-args operand mode (that exists only for TPU VMEM prestaging).

``iterate`` is the counterpart of the JAX package's ``_iterate_jit`` (one
``fori_loop`` of chained products).  One step function serves both devices:
on the CPU it runs eagerly; on a card it is captured in CUDA graphs of
``UNROLL`` steps (``utils/graphs.py``), made once per (x layout, eps) and
replayed.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EhybConfig
from ..core.coo import MatrixCOO
from ..utils.graphs import CapturedGraph, warm_up

#: Steps a graph of the chained loop holds, longest first: n steps replay
#: the 16-step graph n // 16 times and the others for the rest, so a call
#: launches at most n // 16 + 6 graphs and every graph is captured before
#: the first call returns (none is captured inside a timed call).
UNROLL = (16, 4, 1)


def replay_plan(n_steps: int, unroll=UNROLL) -> List[Tuple[int, int]]:
    """(steps a graph holds, replays) that make ``n_steps``, longest first."""
    plan = []
    for u in unroll:
        times, n_steps = divmod(n_steps, u)
        if times:
            plan.append((u, times))
    return plan


class SpmvModel(abc.ABC):
    """Base class for SpMV strategies."""

    name: str = "base"

    def __init__(self, config: Optional[EhybConfig] = None, *,
                 device="cuda"):
        self.config = config or EhybConfig()
        if self.config.dword_values:
            raise NotImplementedError(
                "double-word precision is not ported yet (ROADMAP Queue 1 "
                "item 5)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{self.name}: device {self.device} requested "
                               "but CUDA is not available")
        self.m: Optional[MatrixCOO] = None
        #: The device apply: ``module(x_dev)`` → y in the model's layout.
        self.module: Optional[torch.nn.Module] = None
        #: The chained loop's buffers and graphs, by (x layout, eps).
        self._chains: Dict[tuple, "_Chain"] = {}

    # -- one-time host preprocessing ---------------------------------------
    @abc.abstractmethod
    def setup(self, m: MatrixCOO) -> "SpmvModel":
        """Plan/partition/reorder/convert + device upload.  Returns self."""

    # -- vector in/out ------------------------------------------------------
    def prepare_x(self, x: np.ndarray) -> torch.Tensor:
        """Host x (original ordering) → device tensor in the model's layout."""
        return torch.as_tensor(np.asarray(x, dtype=self.config.dtype),
                               device=self.device)

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        """Device y (model layout) → host f64 vector in the original ordering."""
        return y.detach().cpu().numpy().astype(np.float64)[: self.m.n_rows]

    # -- the timed device op ------------------------------------------------
    @torch.no_grad()
    def apply(self, x_dev: torch.Tensor) -> torch.Tensor:
        """One SpMV in the model's layout."""
        return self.module(x_dev)

    # -- the roofline's model ----------------------------------------------
    @abc.abstractmethod
    def roofline_phases(self) -> Dict[str, Tuple[int, int]]:
        """(flops, device-memory bytes) per iteration of each phase of the
        apply: what the card must move, x and y included."""

    def bytes_model(self) -> int:
        """Device-memory bytes per iteration (the roofline's denominator)."""
        return sum(b for _, b in self.roofline_phases().values())

    # -- conveniences -------------------------------------------------------
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """End-to-end y = A·x (original ordering, host in/out)."""
        return self.recover_y(self.apply(self.prepare_x(x)))

    @torch.no_grad()
    def iterate(self, x_dev, n_iters: int, eps: float = 0.0) -> torch.Tensor:
        """``n_iters`` chained SpMVs for benchmarking: y_k = A·(x + eps·y_{k-1}).

        With eps = 0 the result equals a single A·x, but every iteration
        reads the previous one's y, so no iteration can be skipped — the
        honest launch loop of the reference (``spmv.cu:110-116``).  A model
        whose x is a tuple of device vectors (one per engine) chains y into
        each of them.  On a card the steps replay CUDA graphs (x is copied
        in once a call, y cloned out once); elsewhere they run eagerly."""
        if self.device.type != "cuda":
            return self.iterate_eager(x_dev, n_iters, eps)
        chain = self._chain_for(x_dev, eps)
        _copy_(chain.x, x_dev)
        _copy_(chain.xin, x_dev)
        y = None
        for u, times in replay_plan(max(int(n_iters), 1)):
            chain.graphs[u].replay(times)
            y = chain.graphs[u].out
        return y.clone()

    @torch.no_grad()
    def iterate_eager(self, x_dev, n_iters: int,
                      eps: float = 0.0) -> torch.Tensor:
        """The loop of :meth:`iterate` with every op launched from Python:
        the CPU's loop, and on a card the A/B against the graphs."""
        xin = _clone(x_dev)
        y = None
        for _ in range(max(int(n_iters), 1)):
            y = self._chain_step(x_dev, xin, eps)
        return y

    def _chain_step(self, x, xin, eps: float) -> torch.Tensor:
        """One chained product: y = A·xin, then xin ← x + eps·y in place
        (``eps`` is the add's ``alpha``), ready for the next step."""
        y = self.apply(xin)
        _chain_into(xin, x, y, eps)
        return y

    def _chain_for(self, x_dev, eps: float) -> "_Chain":
        key = (_layout(x_dev), float(eps))
        chain = self._chains.get(key)
        if chain is None:
            chain = self._chains[key] = _Chain(self, x_dev, float(eps))
        return chain


class _Chain:
    """The chained loop of one (x layout, eps) on a card: x and the step's
    input in static buffers, and a graph of ``u`` steps for each ``u`` of
    ``UNROLL``, all captured here, after one warm-up step."""

    def __init__(self, model: SpmvModel, x_dev, eps: float):
        self.x = _clone(x_dev)
        self.xin = _clone(x_dev)
        warm_up(lambda: model._chain_step(self.x, self.xin, eps),
                model.device)

        def steps(u: int):
            y = None
            for _ in range(u):
                y = model._chain_step(self.x, self.xin, eps)
            return y

        self.graphs = {u: CapturedGraph(lambda u=u: steps(u), model.device)
                       for u in UNROLL}


def _layout(x) -> tuple:
    if isinstance(x, tuple):
        return tuple(_layout(xi) for xi in x)
    return (tuple(x.shape), x.dtype, x.device)


def _clone(x):
    if isinstance(x, tuple):
        return tuple(_clone(xi) for xi in x)
    return x.clone()


def _copy_(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_(d, s)
    else:
        dst.copy_(src)


def _chain_into(out, x, y: torch.Tensor, eps: float) -> None:
    """out ← x + eps·y, with y resized to each of x's vectors."""
    if isinstance(x, tuple):
        for o, xi in zip(out, x):
            _chain_into(o, xi, y, eps)
    else:
        torch.add(x, _resize_like(y, x), alpha=eps, out=out)


def _resize_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pad/trim y's last axis to x's (models emit a padded y whose length
    differs from the padded x)."""
    n, m = x.shape[-1], y.shape[-1]
    if m == n:
        return y
    if m > n:
        return y[..., :n]
    return torch.nn.functional.pad(y, (0, n - m))
