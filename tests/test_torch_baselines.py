"""The port's baselines on the CPU against the JAX package's and the
exact-f64 oracle at rel 5e-6 in f32 (the suite's bound,
``__graft_entry__.py:80``): ``csr`` (COO gather + ``index_add_``), ``bcoo``
(``torch.sparse_csr_tensor``; cuSPARSE on a card) and ``hyb`` (one
whole-matrix window, no reordering), whose artifact is the JAX one byte for
byte."""
import pytest

import ehyb_spmv_gpu_tpu as ref
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv

import ehyb_spmv_torch as port
from test_torch_parity import assert_same_ehyb, coo_for, rel

TOL = 5e-6


@pytest.mark.parametrize("fixture", ["poisson_mid", "fem_small", "scrambled",
                                     "powerlaw_small"])
@pytest.mark.parametrize("name", ["csr", "bcoo", "hyb"])
def test_baseline_matches_jax_and_oracle(name, fixture, request):
    m = request.getfixturevalue(fixture)
    x = deterministic_x(m.dimension)
    model = port.MODELS[name](port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", m))
    jmodel = ref.MODELS[name](ref.EhybConfig()).setup(m)
    got = model.matvec(x)
    assert got.shape == (m.n_rows,)
    assert rel(got, oracle_spmv(m, x)) <= TOL
    assert rel(got, jmodel.matvec(x)) <= TOL
    if name == "hyb":
        assert model.config.window_rows == jmodel.config.window_rows
        assert model.plan.n_parts == 1
        assert_same_ehyb(model.ehyb, jmodel.ehyb)


def test_baselines_in_float64(scrambled):
    x = deterministic_x(scrambled.dimension)
    want = oracle_spmv(scrambled, x)
    for name in ("csr", "bcoo", "hyb"):
        model = port.MODELS[name](port.EhybConfig(dtype="float64"),
                                  device="cpu").setup(
            coo_for("ehyb_spmv_torch", scrambled))
        assert rel(model.matvec(x), want) <= 1e-14, name


def test_models_are_the_references_seven():
    assert set(port.MODELS) == set(ref.MODELS)
    for name, cls in port.MODELS.items():
        assert cls.name == name
    for attr in ("CsrSpmv", "BcooSpmv", "HybSpmv", "MatrixCSR", "make_plan",
                 "Plan", "two_level_reorder", "Reordering", "coo_to_ehyb"):
        assert hasattr(port, attr), attr


@pytest.mark.parametrize("name", ["csr", "bcoo"])
def test_baseline_roofline_counts_entries_and_vectors(name, scrambled):
    m = coo_for("ehyb_spmv_torch", scrambled)
    model = port.MODELS[name](port.EhybConfig(), device="cpu").setup(m)
    idx = 8 if name == "csr" else 4          # row and column, or column
    extra = 0 if name == "csr" else 4 * (m.n_rows + 1)
    assert model.bytes_model() == m.nnz * (4 + idx) + extra \
        + 4 * (m.n_rows + m.n_cols)
    flops = sum(f for f, _ in model.roofline_phases().values())
    assert flops == 2 * m.nnz
