"""The flagship's small-matrix gate (``EhybSpmv._maybe_delegate_small``) on
the CPU, case for case with the JAX package's ``TestSmallGate``
(``tests/test_route.py``), on the same matrix made from the same seed.

Below 65,536 rows the gate times the candidate engine (the routed engine,
or the degree-split hybrid with a heavy tail) against the body on the card.
The A/B runs only where ``_can_measure()`` (a card); here the tests patch
it and ``_measured_gflops`` on the instance, as the JAX tests patch
``_pallas_mode``.  The gate's estimate against the perfect-fill floor is
held equal to the JAX gate's.  End to end the engines are held to rel
1e-6 against the exact-f64 oracle, the JAX tests' bound.
"""
import numpy as np
import pytest

import ehyb_spmv_gpu_tpu as ref
import ehyb_spmv_gpu_tpu.core.ordering as ref_ordering
from ehyb_spmv_gpu_tpu.io import generate

from ehyb_spmv_torch.config import EhybConfig
from ehyb_spmv_torch.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv_torch.models.ehyb import EhybSpmv
from ehyb_spmv_torch.models.routed import RoutedSpmv
from test_torch_parity import PORT, coo_for, rel

ORACLE_TOL = 1e-6


def _random_coo(dim, k, seed=11):
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(dim), k)
    col = rng.integers(0, dim, dim * k)
    key = row.astype(np.int64) * dim + col
    _, ui = np.unique(key, return_index=True)
    row, col = row[ui], col[ui]
    val = rng.standard_normal(row.size)
    return MatrixCOO(n_rows=dim, n_cols=dim, row=row.astype(np.int32),
                     col=col.astype(np.int32), val=val)


@pytest.fixture(scope="module")
def small_random():
    return _random_coo(1 << 14, 26, seed=7)   # nnz ~ 4.2e5 >= 1 << 18


@pytest.fixture(scope="module")
def stencil():
    return coo_for(PORT, generate.stencil3d(24, points=27))  # dim 13,824


def _patched(cfg, fake):
    model = EhybSpmv(cfg, device="cpu")
    # instance-only patches: the body the A/B builds is a fresh EhybSpmv
    model._can_measure = lambda: True
    model._measured_gflops = fake
    return model


def _boom(*a, **k):
    raise AssertionError("the gate measured")


def _oracle_rel(model, m) -> float:
    x = deterministic_x(m.dimension)
    return rel(model.matvec(x), oracle_spmv(m, x))


def test_scattered_small_runs_ab_and_picks_winner(small_random, tmp_path):
    m = small_random
    cfg = EhybConfig(artifact_cache=True, cache_dir=str(tmp_path))
    fake = lambda mdl, mm: 48.0 if isinstance(mdl, RoutedSpmv) else 35.8  # noqa
    model = _patched(cfg, fake)
    out = model.setup(m)
    assert isinstance(out, RoutedSpmv), type(out)
    gate = out.small_gate
    assert gate["kind"] == "routed" and gate["est"] > 3.0 * gate["floor"]
    assert (gate["candidate_gflops"], gate["body_gflops"]) == (48.0, 35.8)
    assert model._load_gate_decision(m) == "routed"
    # the verdict is cached: a warm run delegates before the ordering,
    # without measuring
    warm = _patched(cfg, _boom).setup(m)
    assert isinstance(warm, RoutedSpmv), type(warm)
    assert _oracle_rel(out, m) < ORACLE_TOL


def test_body_win_returns_built_body(small_random, tmp_path):
    m = small_random
    cfg = EhybConfig(artifact_cache=True, cache_dir=str(tmp_path))
    fake = lambda mdl, mm: 10.0 if isinstance(mdl, RoutedSpmv) else 22.2  # noqa
    model = _patched(cfg, fake)
    out = model.setup(m)
    # the body the A/B built and timed, not the gate's own model
    assert isinstance(out, EhybSpmv) and out is not model, type(out)
    assert out.small_gate["body_gflops"] == 22.2
    assert model._load_gate_decision(m) is False
    warm = _patched(cfg, _boom).setup(m)
    assert isinstance(warm, EhybSpmv), type(warm)
    assert _oracle_rel(out, m) < ORACLE_TOL


def test_structured_small_skips_measurement(stencil):
    """est <= K * floor: the body is kept without a build or a run."""
    model = _patched(EhybConfig(artifact_cache=False), _boom)
    out = model.setup(stencil)
    assert out is model
    assert model.small_gate["est"] <= 3.0 * model.small_gate["floor"]


def test_cpu_backend_keeps_body(small_random):
    """Without a card the A/B cannot run: a scattered small matrix keeps
    the body."""
    model = EhybSpmv(EhybConfig(artifact_cache=False), device="cpu")
    assert not model._can_measure()
    out = model.setup(small_random)
    assert out is model and "kind" not in model.small_gate


def test_budget_guard_skips_ab(small_random, tmp_path, monkeypatch):
    """EHYB_SMALL_GATE_BUDGET below the estimated A/B cost: the body stays
    without a candidate build or a run, and the verdict is cached so the
    estimate is paid once."""
    m = small_random
    monkeypatch.setenv("EHYB_SMALL_GATE_BUDGET", "0.001")
    cfg = EhybConfig(artifact_cache=True, cache_dir=str(tmp_path))
    model = _patched(cfg, _boom)
    out = model.setup(m)
    assert out is model
    assert model._load_gate_decision(m) is False
    warm = _patched(cfg, _boom)
    assert warm.setup(m) is warm and warm.small_gate is None


@pytest.mark.parametrize("fixture", ["small_random", "stencil"])
def test_estimate_over_floor_equals_the_jax_gate(fixture, request,
                                                 tmp_path, monkeypatch):
    """The structured skip's est / floor, the port's against the JAX
    gate's on the same matrix (the JAX gate in Pallas mode "1", stopped by
    the budget guard right after its estimate)."""
    m = request.getfixturevalue(fixture)
    monkeypatch.setenv("EHYB_SMALL_GATE_BUDGET", "0.001")
    seen = []
    real = ref_ordering.estimate_cost

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(ref_ordering, "estimate_cost", spy)
    jax_model = ref.EhybSpmv(ref.EhybConfig(artifact_cache=False))
    jax_model._pallas_mode = lambda: "1"
    jax_model._measured_gflops = _boom
    jax_model.setup(coo_for("ehyb_spmv_gpu_tpu", m))
    # the gate's is the last estimate of the setup
    jax_ratio = seen[-1] / (m.nnz / 1024.0 * ref_ordering._CYC_DIA_VREG)

    model = _patched(EhybConfig(artifact_cache=False), _boom)
    model.setup(m)
    gate = model.small_gate
    assert gate["est"] / gate["floor"] == jax_ratio
    assert (jax_ratio > 3.0) == (fixture == "small_random")


def test_measured_gflops_times_the_chained_loop():
    """The A/B's timer on a small model: the chained loop's GFLOP/s, 512
    iterations or more (on the CPU the host clock times the eager loop)."""
    m = coo_for(PORT, generate.poisson2d(32))
    model = EhybSpmv(EhybConfig(), device="cpu").setup(m)
    calls = []
    loop = model.iterate
    model.iterate = lambda x, n, eps=0.0: calls.append(n) or loop(x, n, eps)
    g = model._measured_gflops(model, m)
    assert np.isfinite(g) and g > 0
    # a warm-up step, then runs of 512 x 4^k iterations until >= 50 ms
    assert calls[0] == 1 and calls[1] == 512
    assert all(b == 4 * a for a, b in zip(calls[1:], calls[2:]))
