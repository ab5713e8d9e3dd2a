"""The port's CG and power iteration on the CPU against the JAX package's
(``tests/test_solver.py``'s systems): in float64 (the JAX side under
``jax.enable_x64``) the iteration counts agree within one and x within rel
1e-10; in float32 both converge, the counts agree within 3% and x lies
within rel 1e-3 of the true solution (the JAX test's bound).  The masked
step the CUDA graph replays runs here eagerly: iterations past the end
change nothing."""
import os

import jax
import numpy as np
import pytest

import ehyb_spmv_gpu_tpu as ref
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate
from ehyb_spmv_gpu_tpu.models.solver import CgSolver as RefCg
from ehyb_spmv_gpu_tpu.models.solver import PowerIteration as RefPower

import ehyb_spmv_torch as port
from ehyb_spmv_torch.models import solver
from ehyb_spmv_torch.models.solver import CgSolver, PowerIteration
from test_torch_parity import coo_for, rel

PORT = "ehyb_spmv_torch"


@pytest.fixture(scope="module")
def spd_system():
    m = generate.poisson2d(32)  # SPD Laplacian, dim 1024
    x_true = deterministic_x(m.dimension)
    return m, x_true, oracle_spmv(m, x_true)


def _config(pkg, name: str, dtype: str = "float32"):
    cfg = pkg.EhybConfig(dtype=dtype)
    if name != "ehyb":
        cfg = pkg.EhybConfig(window_rows=1024, dtype=dtype)
    return cfg


def port_model(name: str, m, dtype: str = "float32"):
    return port.MODELS[name](_config(port, name, dtype), device="cpu").setup(
        coo_for(PORT, m))


def ref_model(name: str, m, dtype: str = "float32"):
    return ref.MODELS[name](_config(ref, name, dtype)).setup(m)


@pytest.fixture
def x64():
    if jax.config.read("jax_enable_x64"):
        pytest.skip("x64 mode globally toggled")
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
@pytest.mark.parametrize("name", ["csr", "ehyb_xla", "ehyb"])
def test_cg_f32_matches_jax(spd_system, name, precondition):
    m, x_true, b = spd_system
    got = CgSolver(port_model(name, m), precondition).solve(
        b, tol=1e-5, max_iters=3000)
    want = RefCg(ref_model(name, m), precondition).solve(
        b, tol=1e-5, max_iters=3000)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 0.03 * want.iterations
    assert rel(got.x, x_true) < 1e-3


@pytest.mark.parametrize("precondition", ["none", "jacobi"])
@pytest.mark.parametrize("name", ["csr", "ehyb_xla"])
def test_cg_f64_matches_jax(spd_system, name, precondition, x64):
    m, x_true, b = spd_system
    got = CgSolver(port_model(name, m, "float64"), precondition).solve(
        b, tol=1e-10, max_iters=3000)
    want = RefCg(ref_model(name, m, "float64"), precondition).solve(
        b, tol=1e-10, max_iters=3000)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 1
    assert rel(got.x, want.x) < 1e-10
    assert rel(got.x, x_true) < 1e-8


def test_cg_bad_preconditioner_name(spd_system):
    with pytest.raises(ValueError):
        CgSolver(port_model("csr", spd_system[0]), precondition="ilu")


def test_cg_checkpoint_resume_matches_jax(tmp_path, x64):
    """A solve cut at 5 iterations writes its checkpoint; the resumed solve
    restarts CG from the checkpointed x, as the JAX one does, and lands on
    the same count and x."""
    m = generate.poisson2d(24)
    b = np.random.default_rng(3).standard_normal(m.dimension)
    results = []
    for pkg, model in (("port", port_model("ehyb_xla", m, "float64")),
                       ("ref", ref_model("ehyb_xla", m, "float64"))):
        cg = CgSolver if pkg == "port" else RefCg
        ckpt = str(tmp_path / f"{pkg}.npz")
        r1 = cg(model).solve(b, tol=1e-8, max_iters=5, checkpoint_every=5,
                             checkpoint_path=ckpt)
        assert not r1.converged
        z = np.load(ckpt)
        assert int(z["iterations"]) == 5 and z["x"].shape == (m.dimension,)
        r2 = cg(model).solve(b, tol=1e-8, max_iters=2000,
                             checkpoint_every=50, checkpoint_path=ckpt)
        assert r2.converged and r2.iterations > 5
        assert not os.path.exists(ckpt)          # converged: removed
        results.append((r1, r2))
    (p1, p2), (j1, j2) = results
    assert rel(p1.x, j1.x) < 1e-10
    assert abs(p2.iterations - j2.iterations) <= 1
    assert rel(p2.x, j2.x) < 1e-10
    dense = np.zeros((m.dimension, m.dimension))
    np.add.at(dense, (m.row, m.col), m.val)
    np.testing.assert_allclose(dense @ p2.x, b, rtol=0, atol=1e-6)


def test_cg_resumes_a_jax_checkpoint(tmp_path, x64):
    """Both packages write the same fingerprint, so the port resumes a
    checkpoint the JAX package wrote, and the resume already at its budget
    reports the checkpointed x's true residual (the not-ran branch)."""
    m = generate.poisson2d(16)
    b = np.random.default_rng(5).standard_normal(m.dimension)
    ckpt = str(tmp_path / "cg.npz")
    RefCg(ref_model("csr", m, "float64")).solve(
        b, tol=1e-8, max_iters=7, checkpoint_every=7, checkpoint_path=ckpt)
    z = np.load(ckpt)
    model = port_model("csr", m, "float64")
    got = CgSolver(model).solve(b, tol=1e-8, max_iters=7,
                                checkpoint_every=7, checkpoint_path=ckpt)
    assert got.iterations == 7 and not got.converged
    np.testing.assert_array_equal(got.x, z["x"])
    want = np.linalg.norm(b - oracle_spmv(m, z["x"]))
    assert abs(got.residual_norm - want) <= 1e-10 * want
    assert os.path.exists(ckpt)


def test_cg_checkpoint_fingerprint_and_cleanup(tmp_path):
    """A checkpoint of a different problem is ignored; a converged solve
    removes its checkpoint."""
    m = generate.poisson2d(16)
    rng = np.random.default_rng(4)
    b1 = rng.standard_normal(m.dimension)
    b2 = rng.standard_normal(m.dimension)
    model = port_model("ehyb_xla", m, "float64")
    ckpt = str(tmp_path / "cg.npz")
    r1 = CgSolver(model).solve(b1, tol=1e-8, max_iters=5,
                               checkpoint_every=5, checkpoint_path=ckpt)
    assert not r1.converged and os.path.exists(ckpt)
    r2 = CgSolver(model).solve(b2, tol=1e-8, max_iters=2000,
                               checkpoint_every=100, checkpoint_path=ckpt)
    fresh = CgSolver(model).solve(b2, tol=1e-8, max_iters=2000)
    assert r2.converged and r2.iterations == fresh.iterations
    np.testing.assert_array_equal(r2.x, fresh.x)
    assert not os.path.exists(ckpt)


def test_cg_one_loop_across_segments_and_cadences(tmp_path, monkeypatch):
    """One CG loop (the counterpart of the JAX package's single compile,
    and on a card its single capture) serves every segment length and
    checkpoint cadence: the budget is a device scalar."""
    built = []
    real = solver._CgLoop.__init__

    def counting(self, *a, **kw):
        built.append(self)
        real(self, *a, **kw)

    monkeypatch.setattr(solver._CgLoop, "__init__", counting)
    m = generate.poisson2d(16)
    b = np.ones(m.dimension)
    cg = CgSolver(port_model("ehyb_xla", m, "float64"))
    r1 = cg.solve(b, tol=1e-10, max_iters=7, checkpoint_every=3,
                  checkpoint_path=str(tmp_path / "a.npz"))
    r2 = cg.solve(b, tol=1e-10, max_iters=11, checkpoint_every=4,
                  checkpoint_path=str(tmp_path / "b.npz"))
    assert (r1.iterations, r2.iterations) == (7, 11)
    assert len(built) == 1 and cg._loop is built[0]


@pytest.mark.parametrize("name", ["csr", "ehyb"])
def test_cg_masked_steps_past_the_end_change_nothing(spd_system, name):
    """The graph's replay, run eagerly: ``CG_STEPS`` masked iterations at a
    time until the loop is inactive give the eager loop's count and x bit
    for bit, and further iterations change nothing."""
    m, _, b = spd_system
    model = port_model(name, m)
    eager = CgSolver(model).solve(b, tol=1e-5, max_iters=3000)
    cg = CgSolver(model)
    cg.solve(b, tol=1e-5, max_iters=1)        # builds and loads the loop
    loop = cg._loop
    loop.load(model.prepare_x(b), None, None, 1e-10 * solver._norm2_host(b))
    loop.budget.fill_(3000)
    loop.init()
    replays = 0
    while bool(loop.active):
        for _ in range(solver.CG_STEPS):
            loop.step()
        replays += 1
    assert int(loop.k) == eager.iterations
    assert replays == -(-eager.iterations // solver.CG_STEPS)
    np.testing.assert_array_equal(model.recover_y(loop.x), eager.x)
    state = [t.clone() for t in (loop.x, loop.r, loop.z, loop.p, loop.rz,
                                 loop.k)]
    for _ in range(3):
        loop.step()
    for before, after in zip(state, (loop.x, loop.r, loop.z, loop.p,
                                     loop.rz, loop.k)):
        assert bool((before == after).all())


def test_cg_refuses_a_tuple_layout():
    m = generate.random_general(2000, 8, seed=1, power_law=0.8)
    model = port.MODELS["ehyb_split"](port.EhybConfig(), device="cpu").setup(
        coo_for(PORT, m))
    with pytest.raises(TypeError):
        CgSolver(model).solve(np.ones(m.dimension), max_iters=2)


def _dominant_eig_matrix():
    m = generate.diag_matrix(512, 2.0)
    return ref.MatrixCOO(512, 512, np.concatenate([m.row, [7]]),
                         np.concatenate([m.col, [7]]),
                         np.concatenate([m.val, [3.0]]))   # A[7, 7] = 5


def test_power_iteration_matches_jax():
    """``tests/test_solver.py``'s matrix: λ within rel 1e-6 of the JAX
    package's, from the same numpy start vector."""
    m = _dominant_eig_matrix()
    v, lam = PowerIteration(port_model("csr", m)).run(iters=100)
    v_ref, lam_ref = RefPower(ref_model("csr", m)).run(iters=100)
    assert abs(lam - lam_ref) <= 1e-6 * abs(lam_ref)
    assert abs(lam - 5.0) < 1e-3 and abs(abs(v[7]) - 1.0) < 1e-2
    assert rel(v, v_ref) < 1e-5


def test_power_iteration_f64_matches_jax_mid_convergence(scrambled, x64):
    """Before convergence λ and v follow the start vector: the same seed
    gives the JAX package's values (f64, rel 1e-10), through the flagship
    layout's reordered vectors (the plain model)."""
    model = port_model("ehyb_xla", scrambled, "float64")
    v, lam = PowerIteration(model).run(iters=30, seed=2)
    v_ref, lam_ref = RefPower(ref_model("ehyb_xla", scrambled,
                                        "float64")).run(iters=30, seed=2)
    assert abs(lam - lam_ref) <= 1e-10 * abs(lam_ref)
    assert rel(v, v_ref) < 1e-10
