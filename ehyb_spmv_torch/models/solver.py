"""Iterative solvers on top of the SpMV models: CG and power iteration.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/solver.py``.  The reference
carries the skeleton of a preconditioned conjugate-gradient solver as dead
code (``kernelMyxpy`` ``kernel.cu:288-296``, the ``PRECOND``/``FACT`` flags
``spmv.h:8,13``); this is the live version: conjugate gradient, optionally
Jacobi-preconditioned, whose product is any :class:`SpmvModel` apply, with
the vector work left to torch ops (XLA fusion in the JAX package), and
checkpoint/resume of the solver state.

The JAX package runs a CG segment under one ``while_loop`` and power
iteration under one ``fori_loop``.  Here one step function serves both
devices: on the CPU it runs eagerly; on a card it is captured in CUDA
graphs (``utils/graphs.py``) and replayed.  CG's graph holds ``CG_STEPS``
masked iterations: each computes ``active = (k < budget) & (r·r > tol²)``
on the device and commits every update under ``torch.where``, so the
iterations past convergence change nothing and the count and x are the
``while_loop``'s; the host reads the state once a replay.  ``budget`` is a
device scalar, so one capture serves every segment length and checkpoint
cadence, as one compile does in the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.coo import MatrixCOO
from ..utils.graphs import CapturedGraph, warm_up
from ..utils.log import get_logger
from .base import SpmvModel, _resize_like

log = get_logger(__name__)

#: Masked CG iterations in one graph replay; the host reads whether to go
#: on once a replay, and up to CG_STEPS - 1 masked iterations run past the
#: end (they change nothing).
CG_STEPS = 16


@dataclasses.dataclass
class CgResult:
    x: np.ndarray
    iterations: int
    residual_norm: float
    converged: bool


class CgSolver:
    """Conjugate gradient for SPD systems A·x = b using a SpMV model.

    ``precondition='jacobi'`` enables diagonal (Jacobi) preconditioning — the
    working analog of the reference's vestigial PRECOND flag (``spmv.h:8``).
    """

    def __init__(self, model: SpmvModel, precondition: str = "none"):
        if precondition not in ("none", "jacobi"):
            raise ValueError(f"unknown preconditioner {precondition!r}")
        self.model = model
        self.precondition = precondition
        self._minv = None
        #: The CG loop (state buffers and, on a card, its graphs), built at
        #: the first solve and kept for every later one.
        self._loop: Optional[_CgLoop] = None

    def _prepare(self, m: MatrixCOO):
        if self.precondition == "jacobi":
            diag = np.zeros(m.n_rows)
            on_diag = m.row == m.col
            np.add.at(diag, m.row[on_diag], m.val[on_diag])
            diag[diag == 0.0] = 1.0
            # move the inverse diagonal through the model's vector layout
            self._minv = self.model.prepare_x(1.0 / diag)

    def solve(self, b: np.ndarray, tol: float = 1e-6, max_iters: int = 1000,
              x0: Optional[np.ndarray] = None,
              checkpoint_every: Optional[int] = None,
              checkpoint_path: Optional[str] = None) -> CgResult:
        """Solve A·x = b.

        With ``checkpoint_every``/``checkpoint_path``, the device loop runs in
        segments of that many iterations and the solver state (x, iteration
        count) is written to ``<checkpoint_path>`` after each segment.  If
        the file already exists and belongs to this (matrix, b, tol)
        problem, the solve RESUMES from it (restart-CG: r/p are rebuilt from
        the checkpointed x, a fresh CG warm-started at x).  On a card every
        segment replays the loop's CUDA graphs."""
        return self._solve(b, tol, max_iters, x0, checkpoint_every,
                           checkpoint_path,
                           graphs=self.model.device.type == "cuda")

    def solve_eager(self, b: np.ndarray, tol: float = 1e-6,
                    max_iters: int = 1000, x0: Optional[np.ndarray] = None,
                    checkpoint_every: Optional[int] = None,
                    checkpoint_path: Optional[str] = None) -> CgResult:
        """:meth:`solve` with every op launched from Python: the CPU's
        loop, and on a card the A/B against the graphs."""
        return self._solve(b, tol, max_iters, x0, checkpoint_every,
                           checkpoint_path, graphs=False)

    def _solve(self, b, tol, max_iters, x0, checkpoint_every,
               checkpoint_path, graphs: bool) -> CgResult:
        m = self.model.m
        self._prepare(m)
        b_dev = self.model.prepare_x(b)
        if isinstance(b_dev, tuple):
            raise TypeError(f"CG needs a model whose x is one device vector; "
                            f"{self.model.name} takes {len(b_dev)}")
        it_base = 0
        # Checkpoints are keyed to the (matrix, b, tol) problem: a stale file
        # from a different problem must not warm-start this one.
        fp = _problem_fingerprint(m, b, tol)
        if checkpoint_path and os.path.exists(checkpoint_path):
            z = np.load(checkpoint_path)
            if "fingerprint" in z and str(z["fingerprint"]) == fp:
                x0 = z["x"]
                it_base = int(z["iterations"])
                log.info("CG: resuming from %s (iteration %d)",
                         checkpoint_path, it_base)
            else:
                log.warning("CG: checkpoint %s belongs to a different "
                            "problem (or predates fingerprints); ignoring",
                            checkpoint_path)
        loop = self._loop
        if loop is None or not loop.fits(b_dev):
            loop = self._loop = _CgLoop(self.model, b_dev, m.n_rows)
        if graphs and loop.graphs is None:
            loop.capture()                 # before the state is loaded
        loop.load(b_dev, self._minv,
                  None if x0 is None else self.model.prepare_x(x0),
                  tol * tol * _norm2_host(b))

        seg = checkpoint_every or max_iters
        it_total = it_base
        res2 = 0.0
        ran = False
        while it_total < max_iters:
            ran = True
            budget = min(seg, max_iters - it_total)
            it_seg, res2 = loop.segment(budget, graphs)
            it_total += it_seg
            if checkpoint_path:
                tmp = checkpoint_path + ".tmp"
                with open(tmp, "wb") as fh:   # write-then-rename: atomic
                    np.savez(fh, x=self.model.recover_y(loop.x),
                             iterations=it_total, fingerprint=fp)
                os.replace(tmp, checkpoint_path)
            if it_seg < budget:
                break
        if not ran:
            # resume already at/over budget: report the true residual of
            # the checkpointed x instead of a fabricated zero
            _, res2 = loop.segment(0, graphs)

        x_host = self.model.recover_y(loop.x)
        res = float(np.sqrt(res2))
        converged = res <= tol * max(np.linalg.norm(b), 1e-300)
        if converged and checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # done: nothing to resume
        log.info("CG: %d iterations, residual %.3e (%s)", it_total, res,
                 "converged" if converged else "NOT converged")
        return CgResult(x=x_host, iterations=it_total, residual_norm=res,
                        converged=converged)


class _CgLoop:
    """CG's state in static buffers on the model's device: a segment's
    restart (:meth:`init`) and one masked iteration (:meth:`step`).  On a
    card both are captured once (:meth:`capture`) and replayed.

    Reductions run in ``promote(dtype, float32)`` over the first ``n`` rows
    (the padded tails are zero by construction)."""

    def __init__(self, model: SpmvModel, like: torch.Tensor, n: int):
        self.model = model
        self.n = n
        acc = torch.promote_types(like.dtype, torch.float32)
        self.x, self.b, self.minv, self.r, self.z, self.p = (
            torch.zeros_like(like) for _ in range(6))

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=like.device)

        self.rz, self.rr, self.tol2 = scalar(acc), scalar(acc), scalar(acc)
        self.k, self.budget = scalar(torch.int32), scalar(torch.int32)
        #: Whether the next iteration runs: the ``while_loop``'s condition.
        self.active = scalar(torch.bool)
        self.graphs: Optional[Tuple[CapturedGraph, CapturedGraph]] = None

    def fits(self, like: torch.Tensor) -> bool:
        return (self.x.shape == like.shape and self.x.dtype == like.dtype
                and self.x.device == like.device)

    def load(self, b: torch.Tensor, minv: Optional[torch.Tensor],
             x0: Optional[torch.Tensor], tol2: float) -> None:
        self.b.copy_(b)
        if minv is None:
            self.minv.fill_(1.0)
        else:
            self.minv.copy_(minv)
        if x0 is None:
            self.x.zero_()
        else:
            self.x.copy_(x0)
        self.tol2.fill_(tol2)

    def _matvec(self, v: torch.Tensor) -> torch.Tensor:
        return _resize_like(self.model.apply(v), v)

    def _dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        acc = self.rz.dtype
        return torch.dot(u[:self.n].to(acc), v[:self.n].to(acc))

    def _check(self) -> None:
        self.rr.copy_(self._dot(self.r, self.r))
        torch.logical_and(self.k < self.budget, self.rr > self.tol2,
                          out=self.active)

    def init(self) -> None:
        """Restart from x: r = b − A·x, z = M⁻¹·r, p = z, rz = r·z, k = 0."""
        torch.sub(self.b, self._matvec(self.x), out=self.r)
        torch.mul(self.minv, self.r, out=self.z)
        self.p.copy_(self.z)
        self.rz.copy_(self._dot(self.r, self.z))
        self.k.zero_()
        self._check()

    def step(self) -> None:
        """One CG iteration, committed only where ``active``: past the
        budget or the tolerance nothing changes (inactive, beta would be 1
        and p would move, were it not masked)."""
        a = self.active
        ap = self._matvec(self.p)
        alpha = self.rz / torch.clamp(self._dot(self.p, ap), min=1e-30)
        r = torch.addcmul(self.r, alpha, ap, value=-1)   # kernelMyxpy analog
        z = self.minv * r
        rz = self._dot(r, z)
        beta = rz / torch.clamp(self.rz, min=1e-30)
        torch.where(a, torch.addcmul(self.x, alpha, self.p), self.x,
                    out=self.x)
        torch.where(a, torch.addcmul(z, beta, self.p), self.p, out=self.p)
        torch.where(a, r, self.r, out=self.r)
        torch.where(a, z, self.z, out=self.z)
        torch.where(a, rz, self.rz, out=self.rz)
        self.k.add_(a.to(torch.int32))
        self._check()

    def capture(self) -> None:
        """Capture the restart and ``CG_STEPS`` iterations, after one warm-up
        of each (the budget is still 0 there, so the warm-up moves no x)."""
        dev = self.x.device
        warm_up(lambda: (self.init(), self.step()), dev)

        def steps():
            for _ in range(CG_STEPS):
                self.step()

        self.graphs = (CapturedGraph(self.init, dev),
                       CapturedGraph(steps, dev))

    def segment(self, budget: int, graphs: bool) -> Tuple[int, float]:
        """Restart from x and iterate until k = budget or r·r ≤ tol²;
        returns (k, r·r)."""
        self.budget.fill_(budget)
        if graphs:
            self.graphs[0].replay()
            while bool(self.active):
                self.graphs[1].replay()
        else:
            self.init()
            while bool(self.active):
                self.step()
        return int(self.k), float(self.rr)


def _problem_fingerprint(m: MatrixCOO, b: np.ndarray, tol: float) -> str:
    """Stable id of the (matrix, rhs, tolerance) problem a checkpoint solves
    (the JAX package's, so either package resumes the other's file)."""
    h = hashlib.sha1()
    h.update(np.int64([m.n_rows, m.n_cols, m.nnz, len(b)]).tobytes())
    h.update(np.ascontiguousarray(m.row[:4096], dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(m.val[:4096], dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(b[:4096], dtype=np.float64).tobytes())
    h.update(np.float64(tol).tobytes())
    return h.hexdigest()[:16]


def _norm2_host(b: np.ndarray) -> float:
    v = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
    return v * v


class PowerIteration:
    """Dominant-eigenvalue power iteration — a second end-to-end consumer of
    the SpMV apply.  On a card one normalised step is captured once and
    replayed ``iters`` times."""

    def __init__(self, model: SpmvModel):
        self.model = model
        self._loop: Optional[_PowerLoop] = None

    def run(self, iters: int = 50, seed: int = 0):
        """(v, λ) after ``iters`` steps from numpy's ``default_rng(seed)``
        start vector."""
        return self._run(iters, seed, graphs=self.model.device.type == "cuda")

    def run_eager(self, iters: int = 50, seed: int = 0):
        """:meth:`run` with every op launched from Python: the CPU's loop,
        and on a card the A/B against the graph."""
        return self._run(iters, seed, graphs=False)

    def _run(self, iters: int, seed: int, graphs: bool):
        m = self.model.m
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(m.n_rows)
        v /= np.linalg.norm(v)
        v_dev = self.model.prepare_x(v)
        loop = self._loop
        if loop is None or not loop.fits(v_dev):
            loop = self._loop = _PowerLoop(self.model, v_dev, m.n_rows)
        if graphs and loop.graph is None:
            loop.capture()                 # before the start vector is loaded
        loop.v.copy_(v_dev)
        loop.lam.zero_()
        if graphs:
            loop.graph.replay(iters)
        else:
            for _ in range(iters):
                loop.step()
        return self.model.recover_y(loop.v), float(loop.lam)


class _PowerLoop:
    """v and λ in static buffers and the normalised step over them."""

    def __init__(self, model: SpmvModel, like: torch.Tensor, n: int):
        self.model = model
        self.n = n
        self.v = torch.zeros_like(like)
        self.lam = torch.zeros((), dtype=like.dtype, device=like.device)
        self.graph: Optional[CapturedGraph] = None

    def fits(self, like: torch.Tensor) -> bool:
        return (self.v.shape == like.shape and self.v.dtype == like.dtype
                and self.v.device == like.device)

    def step(self) -> None:
        """v ← A·v / ‖A·v‖ (the norm over the first n rows), λ = ‖A·v‖."""
        w = _resize_like(self.model.apply(self.v), self.v)
        nrm = torch.sqrt(torch.dot(w[:self.n], w[:self.n]))
        torch.div(w, torch.clamp(nrm, min=1e-30), out=self.v)
        self.lam.copy_(nrm)

    def capture(self) -> None:
        warm_up(self.step, self.v.device)
        self.graph = CapturedGraph(self.step, self.v.device)
