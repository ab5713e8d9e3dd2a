"""The port's precision mode (``dword_values``, ``ops/dword.py``) on the CPU
against the JAX package's double-word mode and the exact-f64 oracle.

The same inputs, made from a seed with numpy, go through the JAX models in
their double-word mode (the XLA formulation of ``ops/dword.py``: (hi, lo)
f32 pairs) and through the port's models in f64, whose wrappers take the
kernels' plain versions on CPU tensors.  Four matrices are those of
``tests/test_dword.py``: values that need every f64 bit (its
``_f64_stress_matrix``, as ``chip_smoke.stress_matrix`` makes it for the
card too), a DIA-heavy Poisson matrix, dense long rows, and the chained
loop on a scrambled one; the fifth is that scrambled matrix in the mode's
own plan, whose body is scattered (K1's plan takes direct columns and
groups its rows).  The body goes through each form of K1's plan.

Bounds: the JAX mode's own, rel <= 1e-12 against the oracle (and so
against the JAX result), and the per-element 1e-8 of its cancellation
check; the host artifacts byte for byte.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu as ref
from ehyb_spmv_gpu_tpu.core.coo import MatrixCOO, coalesce, deterministic_x
from ehyb_spmv_gpu_tpu.core.coo import oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from ehyb_spmv_torch.models.solver import CgSolver, PowerIteration
from ehyb_spmv_torch.ops import stream_cells
from ehyb_spmv_torch.ops.dword import DWORD_MODELS
from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv
from ehyb_spmv_torch.parallel.routed import ShardedRoutedSpmv
from ehyb_spmv_torch.parallel.spmv import ShardedEhybSpmv
from chip_smoke import stress_matrix
from test_torch_parity import PORT, REF, assert_same_ehyb, coo_for, rel

TOL = 1e-12
PER_ELEMENT_TOL = 1e-8


def _long_rows_matrix():
    """Two dense rows whose out-of-window entries pass the long-row
    threshold, at cancellation-scale magnitudes."""
    dim = 4096
    rng = np.random.default_rng(11)
    base = generate.random_general(dim, 6, seed=11)
    extra_r, extra_c, extra_v = [], [], []
    for r in (5, 2700):
        cols = rng.permutation(dim)[:3000]
        vals = rng.standard_normal(3000) * 10.0 ** rng.uniform(-6, 6, 3000)
        extra_r.append(np.full(3000, r))
        extra_c.append(cols)
        extra_v.append(vals)
    return coalesce(MatrixCOO(
        dim, dim, np.concatenate([base.row] + extra_r),
        np.concatenate([base.col] + extra_c),
        np.concatenate([base.val] + extra_v)))


#: case → (matrix, config fields): the four matrices of tests/test_dword.py
CASES = {
    "stress": (stress_matrix, {}),
    "poisson": (lambda: generate.poisson2d(64), {}),
    "long_rows": (_long_rows_matrix, dict(window_budget_bytes=4096,
                                          long_row_threshold=256)),
    "chain": (lambda: generate.permuted(generate.poisson2d(64), seed=7),
              dict(window_rows=1024)),
    "scattered": (lambda: generate.permuted(generate.poisson2d(64), seed=7),
                  {}),
}
#: The cases with a SELL body (the Poisson matrix is all DIA).
BODY_CASES = ["chain", "long_rows", "scattered", "stress"]
#: K1's plan forms: name → build_stream_cells options, the tail folded in
#: (None: k1_folded_plan, the shipped one).
FORMS = {"table": {}, "all direct": {"direct_below": np.inf},
         "shipped": None}


def _config(pkg, case, **kw):
    mod = ref if pkg == REF else port
    return mod.EhybConfig(dword_values=True, artifact_cache=False,
                          **CASES[case][1], **kw)


@pytest.fixture(scope="module")
def built():
    """(case, model) → (matrix, JAX model, port model, x, oracle y), set up
    once for the module."""
    cache, mats = {}, {}

    def get(case, name):
        key = (case, name)
        if key not in cache:
            if case not in mats:
                mats[case] = CASES[case][0]()
            m = coo_for(REF, mats[case])
            r = ref.MODELS[name](_config(REF, case)).setup(m)
            p = port.MODELS[name](_config(PORT, case), device="cpu").setup(
                coo_for(PORT, m))
            x = deterministic_x(m.dimension)
            cache[key] = (m, r, p, x, oracle_spmv(m, x))
        return cache[key]

    return get


@pytest.mark.parametrize("name", DWORD_MODELS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dword_matches_oracle_and_jax(case, name, built):
    m, r, p, x, want = built(case, name)
    got = p.matvec(x)
    assert got.dtype == np.float64
    assert rel(got, want) <= TOL, rel(got, want)
    y_jax = r.matvec(x)
    if (case, name) == ("long_rows", "hyb"):
        # the JAX pair arithmetic misses its own bound here (1.06e-12 from
        # the oracle: with one window the dense rows stay in the body, in
        # chains of thousands of steps); its suite runs this matrix
        # through ehyb_xla only.  The port is held to the oracle above.
        assert rel(y_jax, want) > TOL
    else:
        assert rel(got, y_jax) <= TOL
    if case == "long_rows" and name != "hyb":   # hyb: one window
        assert p.ehyb.long_rows.size >= 2, p.ehyb.stats
    if case == "poisson":
        assert p.ehyb.stats["nnz_dia"] > 0


@pytest.mark.parametrize("name", DWORD_MODELS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dword_host_artifacts_byte_identical(case, name, built):
    """The same EhybMatrix, ordering and config after setup as the JAX
    model's in its double-word mode: f64 host values, no layout pinned."""
    _, r, p, _, _ = built(case, name)
    assert_same_ehyb(r.ehyb, p.ehyb)
    assert p.ehyb.ell_val.dtype == np.float64
    for k in ("new_to_old", "old_to_new", "boundaries"):
        a, b = getattr(r.reordering, k), getattr(p.reordering, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert dataclasses.asdict(r.config) == dataclasses.asdict(p.config)
    assert p.config.dtype == "float64" and p.config.relax_body == "never"


@pytest.mark.parametrize("name", DWORD_MODELS)
def test_dword_apply_runs_the_f64_kernels_plain_versions(name, built):
    """The body through K1's compact plan and the DIA part through K9's
    wrapper, in f64, on the XLA branch; the roofline counts 8-byte
    values, x and y."""
    m, _, p, _, _ = built("chain", name)
    mod = p.module
    assert mod.branch == "dword xla" and mod.wincache is None
    assert mod.cells.cell_val.dtype == torch.float64
    assert p.dev.ell_val is None and p.dev.dia_val.dtype == torch.float64
    assert mod.cells.stats["x_bytes"] == 8 * mod.cells.stats["x_rows"]
    phases = p.roofline_phases()
    assert phases["x/y vectors"][1] == 2 * m.dimension * 8
    assert phases["body"][1] == mod.cells.stats["stream_bytes"]
    assert phases["dia"][1] == 8 * (p.ehyb.stats["nnz_dia"]
                                    + p.ehyb.stats["waste_dia"])


def test_dword_beats_f32(built):
    """The per-element check of ``tests/test_dword.py``: f32 loses the
    cancellation rows, the precision mode keeps them."""
    m, _, p, x, want = built("stress", "ehyb_xla")
    plain = port.EhybPlainSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for(PORT, m))
    denom = np.maximum(np.abs(want), 1.0)
    per_elem_plain = np.max(np.abs(plain.matvec(x) - want) / denom)
    per_elem_dword = np.max(np.abs(p.matvec(x) - want) / denom)
    assert per_elem_plain > 1e-5, per_elem_plain
    assert per_elem_dword <= PER_ELEMENT_TOL, per_elem_dword
    assert per_elem_dword < per_elem_plain * 1e-3


def test_dword_iterate_chain(built):
    """Three chained products at eps 0 give one product, in f64."""
    _, _, p, x, want = built("chain", "ehyb")
    x_dev = p.prepare_x(x)
    assert x_dev.dtype == torch.float64
    y3 = p.iterate(x_dev, 3)
    assert torch.equal(y3, p.apply(x_dev))
    assert rel(p.recover_y(y3), want) <= TOL


@pytest.mark.parametrize("engine", [
    "csr", "bcoo", "ehyb_routed", "ehyb_split", ShardedEhybSpmv,
    ShardedRoutedSpmv, ShardedDegreeSplitSpmv])
def test_other_models_refuse_the_mode(engine):
    cls = port.MODELS[engine] if isinstance(engine, str) else engine
    with pytest.raises(NotImplementedError, match="ehyb_xla, ehyb, hyb"):
        cls(port.EhybConfig(dword_values=True), device="cpu")


def test_dword_cg_converges():
    """CG over a precision-mode flagship on poisson2d(32), in f64 vectors:
    it converges to its tolerance, and the true residual from the oracle
    stays within 10x of it."""
    m = coo_for(PORT, generate.poisson2d(32))
    x_true = deterministic_x(m.dimension)
    b = oracle_spmv(m, x_true)
    model = port.EhybSpmv(port.EhybConfig(dword_values=True),
                          device="cpu").setup(m)
    tol = 1e-10
    res = CgSolver(model).solve(b, tol=tol, max_iters=3000)
    assert res.converged, res
    true_res = np.linalg.norm(b - oracle_spmv(m, res.x)) / np.linalg.norm(b)
    assert true_res <= 10 * tol, true_res
    assert rel(res.x, x_true) <= 1e-7


def test_dword_power_iteration(built):
    """Power iteration over a precision-mode model runs in f64 vectors: λ
    and v as an f64 run of the plain model from the same start vector."""
    m, _, p, _, _ = built("chain", "ehyb")
    v, lam = PowerIteration(p).run(iters=30, seed=2)
    f64 = port.EhybPlainSpmv(port.EhybConfig(dtype="float64"),
                             device="cpu").setup(coo_for(PORT, m))
    v_ref, lam_ref = PowerIteration(f64).run(iters=30, seed=2)
    assert v.dtype == np.float64
    assert abs(lam - lam_ref) <= 1e-12 * abs(lam_ref)
    assert rel(v, v_ref) <= 1e-12


@pytest.mark.parametrize("steps", [None, 4], ids=["shipped", "steps4"])
def test_dword_heavy_tail_split_matches_oracle_and_jax(steps, powerlaw_small,
                                                       monkeypatch):
    """A heavy-tailed matrix (powerlaw_small) in the precision mode: K1's
    plan takes the split form (at the shipped SPLIT_STEPS_F64, and at 4
    steps), and the product lies within 1e-12 of the oracle and of the JAX
    double-word result."""
    if steps is not None:
        monkeypatch.setattr(stream_cells, "SPLIT_STEPS_F64", steps)
    m = powerlaw_small
    p = port.EhybSpmv(port.EhybConfig(dword_values=True,
                                      artifact_cache=False),
                      device="cpu").setup(coo_for(PORT, m))
    st = p.module.cells.stats
    assert stream_cells.split(p.module.cells)
    if steps is None:
        # as shipped, a body this small takes the split form's small form:
        # hub rows apart, row blocks of at most SMALL_STEPS steps
        assert stream_cells.small(p.module.cells) and st["n_hubs"] > 0
        assert st["max_item_steps"] <= max(stream_cells.SMALL_STEPS,
                                           st["hub_steps"])
    else:
        assert st["chunked_rbs"] > 0 and st["max_item_steps"] <= steps
    x = deterministic_x(m.dimension)
    got, want = p.matvec(x), oracle_spmv(m, x)
    assert got.dtype == np.float64
    assert rel(got, want) <= TOL, rel(got, want)
    r = ref.EhybSpmv(ref.EhybConfig(dword_values=True, artifact_cache=False)
                     ).setup(coo_for(REF, m))
    assert rel(got, r.matvec(x)) <= TOL


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
def test_dword_small_form_matches_its_order_oracle_and_jax(kahan,
                                                          powerlaw_small):
    """The precision mode's heavy-tailed body as shipped takes the split
    form's small form (hub rows apart, y through the row map where the
    rows are grouped): K1's plain version, plain or Neumaier, bit for bit
    against the numpy replay of the kernel's order
    (``test_torch_stream_cells._small_replay``), and the product within
    1e-12 of the oracle and of the JAX double-word result."""
    from ehyb_spmv_torch.ops import ehyb_stream
    from test_torch_stream_cells import _small_replay

    m = powerlaw_small
    p = port.EhybSpmv(port.EhybConfig(dword_values=True,
                                      compensated_sum=kahan,
                                      artifact_cache=False),
                      device="cpu").setup(coo_for(PORT, m))
    cells = p.module.cells
    assert stream_cells.small(cells) and cells.stats["n_hubs"] > 0
    plan = stream_cells.k1_folded_plan(p.ehyb)
    x_pad = torch.from_numpy(np.random.default_rng(8).standard_normal(
        cells.stats["x_rows"]))
    np.testing.assert_array_equal(
        ehyb_stream.stream_body(cells, x_pad, kahan).numpy(),
        _small_replay(plan, x_pad.numpy(), kahan))
    x = deterministic_x(m.dimension)
    got, want = p.matvec(x), oracle_spmv(m, x)
    assert got.dtype == np.float64 and rel(got, want) <= TOL
    r = ref.EhybSpmv(ref.EhybConfig(dword_values=True, artifact_cache=False)
                     ).setup(coo_for(REF, m))
    assert rel(got, r.matvec(x)) <= TOL


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("case", BODY_CASES)
def test_dword_plan_forms_match_oracle_and_jax(case, form, built):
    """The ``ehyb`` model with its plan (the body and the tail folded in)
    in each form (the table form; direct columns in every piece; the
    shipped ``k1_folded_plan``, which groups the scattered case's rows and
    gives long_rows pieces of both kinds and, its dense rows past
    SPLIT_STEPS_F64, the split form): the product within 1e-12 of the
    oracle and of the JAX double-word result, and bit for bit the table
    form's where the plan is not split (a split plan adds a chunked row
    block's chunks as partials: within 1e-12)."""
    m, r, p, x, want = built(case, "ehyb")
    kw = FORMS[form]
    plan = stream_cells.k1_folded_plan(p.ehyb) if kw is None \
        else stream_cells.build_stream_cells(p.ehyb, fold=True, **kw)
    st = plan.stats
    if form == "shipped":
        assert st["grouped"] == (case == "scattered")
        if case in ("scattered", "long_rows"):
            assert st["direct_pieces"] > 0
        assert stream_cells.split(plan) == (case == "long_rows")
    shipped, table = p.module.cells, stream_cells.build_stream_cells(
        p.ehyb, fold=True).to_torch()
    try:
        p.module.cells = table
        y_table = p.matvec(x)
        p.module.cells = plan.to_torch()
        got = p.matvec(x)
    finally:
        p.module.cells = shipped
    if stream_cells.split(plan):
        assert rel(got, y_table) <= TOL
    else:
        assert np.array_equal(got, y_table)
    assert rel(got, want) <= TOL, rel(got, want)
    assert rel(got, r.matvec(x)) <= TOL
