"""Result validation — the reference's ``compare`` (``solver_test.c:7-29``).

Elementwise |y − ŷ| vs ``tol · min(|y|, |ŷ|)``, reporting the first violators
and aggregate diffs.  Fixes the reference's quirk where ``avgdiff`` /
``avgampldiff`` were accumulated but never divided (``solver_test.c:26-27``):
here the averages are actual averages.

Port copy of ``ehyb_spmv_gpu_tpu/utils/validate.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class CompareResult:
    n: int
    n_violations: int
    max_rel: float
    avg_abs_diff: float
    avg_rel_diff: float
    first_violations: list  # [(idx, got, want)]

    @property
    def ok(self) -> bool:
        return self.n_violations == 0

    def __str__(self) -> str:
        s = (f"compare: {self.n_violations}/{self.n} violations, "
             f"max_rel={self.max_rel:.3e}, avg_abs={self.avg_abs_diff:.3e}, "
             f"avg_rel={self.avg_rel_diff:.3e}")
        for idx, got, want in self.first_violations[:10]:
            s += f"\n  y[{idx}] = {got!r} want {want!r}"
        return s


def compare(got: np.ndarray, want: np.ndarray, tol: float = 0.01,
            atol: Optional[float] = None,
            max_report: int = 100) -> CompareResult:
    """Reference-tolerance comparison (default 1% relative, like
    ``solver_test.c:389``).  ``want`` is the oracle.

    Unlike the reference's purely-relative check, entries whose magnitudes sit
    below an absolute floor (``atol``, default ``1e-9 · max|want|``) are exempt:
    exactly-cancelling sums land at ±roundoff, where relative error is
    meaningless.  Pass ``atol=0`` for the strict reference behavior.
    """
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, f"shape mismatch {got.shape} vs {want.shape}"
    if atol is None:
        atol = 1e-9 * float(np.max(np.abs(want), initial=0.0))
    diff = np.abs(got - want)
    floor = np.minimum(np.abs(got), np.abs(want))
    thresh = np.maximum(tol * floor, atol)
    denom = np.maximum(np.maximum(floor, atol), np.finfo(np.float64).tiny)
    rel = diff / denom
    viol = diff > thresh
    idxs = np.flatnonzero(viol)[:max_report]
    res = CompareResult(
        n=got.size,
        n_violations=int(viol.sum()),
        max_rel=float(rel.max(initial=0.0)),
        avg_abs_diff=float(diff.mean()) if got.size else 0.0,
        avg_rel_diff=float(rel.mean()) if got.size else 0.0,
        first_violations=[(int(i), float(got[i]), float(want[i])) for i in idxs],
    )
    if not res.ok:
        log.warning("%s", res)
    return res


def rel_error(got: np.ndarray, want: np.ndarray) -> float:
    """Global 2-norm relative error ‖got − want‖ / ‖want‖ (the ≤1e-6 parity
    metric from BASELINE.md)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    denom = np.linalg.norm(want)
    if denom == 0:
        return float(np.linalg.norm(got))
    return float(np.linalg.norm(got - want) / denom)
