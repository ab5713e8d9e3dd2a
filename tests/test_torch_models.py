"""The port's models on the CPU: against the exact-f64 oracle (rel <= 5e-6,
the suite's bound) and against the JAX models on the same matrix — the
flagship against the JAX flagship in Pallas interpret mode, landing on the
same artifact (f32 rel <= 2e-6, summation order differs)."""
import numpy as np
import pytest

import ehyb_spmv_gpu_tpu as ref
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv

import ehyb_spmv_torch as port
from ehyb_spmv_torch.ops import ehyb_stream
from test_torch_parity import (assert_same_ehyb, cancellation_matrix, coo_for,
                              rel)

ORACLE_TOL = 5e-6
PARITY_TOL = 2e-6


@pytest.mark.parametrize("fixture", ["poisson_mid", "scrambled",
                                     "powerlaw_small"])
def test_flagship_matches_oracle_and_jax_interpret(fixture, request,
                                                   monkeypatch):
    m = request.getfixturevalue(fixture)
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    launches = ehyb_stream.stream_body.launches
    model = port.EhybSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", m))
    assert isinstance(model.module, ehyb_stream.EhybStreamApply)
    got = model.matvec(x)
    assert rel(got, want) <= ORACLE_TOL

    monkeypatch.setenv("EHYB_FORCE_PALLAS", "interpret")
    jmodel = ref.EhybSpmv(ref.EhybConfig()).setup(m)
    assert model.config.body_layout == jmodel.config.body_layout
    assert model.config.windows_per_subtile == \
        jmodel.config.windows_per_subtile
    assert_same_ehyb(model.ehyb, jmodel.ehyb)
    assert rel(got, jmodel.matvec(x)) <= PARITY_TOL
    # the CPU path runs the plain version: no kernel launch is counted
    assert ehyb_stream.stream_body.launches == launches


@pytest.mark.parametrize("fixture", ["poisson_mid", "fem_small", "scrambled",
                                     "powerlaw_small"])
def test_plain_model_matches_oracle_and_jax(fixture, request):
    m = request.getfixturevalue(fixture)
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    model = port.MODELS["ehyb_xla"](port.EhybConfig(window_rows=1024),
                                    device="cpu").setup(
        coo_for("ehyb_spmv_torch", m))
    got = model.matvec(x)
    assert rel(got, want) <= ORACLE_TOL
    jmodel = ref.MODELS["ehyb_xla"](ref.EhybConfig(window_rows=1024)).setup(m)
    assert_same_ehyb(model.ehyb, jmodel.ehyb)
    assert rel(got, jmodel.matvec(x)) <= PARITY_TOL


def test_iterate_eps_chaining(scrambled):
    """y_k = A·(x + eps·y_{k-1}) against the same chain through the f64
    oracle; eps = 0 gives a single apply bit for bit."""
    model = port.EhybSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", scrambled))
    x = deterministic_x(scrambled.dimension)
    x_dev = model.prepare_x(x)
    y1 = model.apply(x_dev)
    assert np.array_equal(y1.numpy(), model.iterate(x_dev, 4).numpy())
    eps = 0.1
    want = oracle_spmv(scrambled, x)
    for _ in range(2):
        want = oracle_spmv(scrambled, x + eps * want)
    got = model.recover_y(model.iterate(x_dev, 3, eps=eps))
    assert rel(got, want) <= ORACLE_TOL


def test_compensated_sum_exact_row():
    """compensated_sum runs the body's compensated variant: the row that
    naive f32 summation gets wrong comes out exact."""
    m = cancellation_matrix("ehyb_spmv_torch")
    model = port.EhybSpmv(port.EhybConfig(compensated_sum=True),
                          device="cpu").setup(m)
    assert model.module.kahan
    y = model.matvec(np.ones(m.dimension))
    assert y[0] == 100.0
    np.testing.assert_allclose(y[1:], 1.0, rtol=1e-6)

