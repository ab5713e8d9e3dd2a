"""The port's routed engine on the CPU, held against the JAX package.

The same numpy-made matrices go through both builders (schedules byte for
byte), both kernels' plain versions are held against the JAX stages in
Pallas interpret mode (K7 exact: its products are single multiplies; K8 at
rel 1e-6: the sums run in another order), and the models against the JAX
models and the exact-f64 oracle at rel 5e-6, the suite's bound.  Then the
flagship's delegation gate: gather wall → routed, heavy tail → split, a
recoverable stencil and ``routed_delegate="never"`` keep the body, and a
cached verdict skips the ordering."""
import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu.core.route as ref_route
import ehyb_spmv_gpu_tpu.models.routed as ref_routed
from ehyb_spmv_gpu_tpu.config import EhybConfig as RefConfig
from ehyb_spmv_gpu_tpu.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate
from ehyb_spmv_gpu_tpu.models.hybrid import DegreeSplitSpmv as RefSplit
from ehyb_spmv_gpu_tpu.ops.route_pallas import make_routed_apply

import ehyb_spmv_torch as port
import ehyb_spmv_torch.core.ordering as port_ordering
import ehyb_spmv_torch.core.route as port_route
import ehyb_spmv_torch.models.routed as port_routed
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.ops import route as port_ops
from test_torch_parity import coo_for, rel

ORACLE_TOL = 5e-6
STAGE_B_TOL = 1e-6
#: Stage-B sub-tiles per grid step for the schedules the JAX kernels run in
#: interpret mode: the Pallas body unrolls them, so the default search (up
#: to 96) costs tens of seconds of interpret-mode compile per schedule.
SB_SMALL = "8"


def _random_coo(dim, k, seed):
    """dim x dim, k random columns per row, duplicates dropped."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(dim), k)
    col = rng.integers(0, dim, dim * k)
    _, ui = np.unique(row.astype(np.int64) * dim + col, return_index=True)
    return MatrixCOO(dim, dim, row[ui].astype(np.int32),
                     col[ui].astype(np.int32),
                     rng.standard_normal(ui.size))


def _heavy_tail(dim, seed=9):
    """4% of rows at degree 48, the rest at 2: a gather wall (pooled group
    fill under the gate at dim 2^17) whose dense rows carry half the nnz."""
    rng = np.random.default_rng(seed)
    deg = np.where(rng.random(dim) < 0.04, 48, 2)
    row = np.repeat(np.arange(dim), deg)
    col = rng.integers(0, dim, row.size)
    _, ui = np.unique(row.astype(np.int64) * dim + col, return_index=True)
    return MatrixCOO(dim, dim, row[ui].astype(np.int32),
                     col[ui].astype(np.int32),
                     rng.standard_normal(ui.size))


# name -> (matrix maker, build_routed kwargs)
SCHEDULES = {
    "random_16k": (lambda: generate.random_general(16384, 12, seed=3), {}),
    "octet": (lambda: _random_coo(1 << 17, 1, seed=41), dict(R=4096, P=64)),
    "powerlaw_spill": (
        lambda: generate.random_general(4096, 12, seed=9, power_law=0.8), {}),
}


@pytest.fixture(scope="module")
def built():
    """name -> (matrix, JAX RoutedMatrix, port RoutedMatrix)."""
    out = {}
    for name, (make, kw) in SCHEDULES.items():
        m = make()
        out[name] = (m, ref_route.build_routed(m, **kw),
                     port_route.build_routed(coo_for("ehyb_spmv_torch", m),
                                             **kw))
    return out


def _assert_same_routed(a, b):
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f
            assert va.tobytes() == vb.tobytes(), f
        else:
            assert va == vb, f


def _x_pad(rm, m):
    xp = np.zeros(rm.padded_x_rows, dtype=np.float32)
    xp[:m.dimension] = deterministic_x(m.dimension).astype(np.float32)
    return xp


@pytest.mark.parametrize("args", [
    (1 << 20, 1 << 20, 16 << 20, None, None),     # random_1m
    (1_000_000, 1_000_000, 16_000_000, None, None),
    (1 << 24, 1 << 20, 1 << 24, None, None),      # a column block
    (16384, 16384, 196608, None, None),
    (1 << 17, 1 << 17, 1 << 17, 4096, 64),
    (1 << 20, 1 << 20, 200 << 20, None, None),    # too dense: both raise
], ids=["random_1m", "dim_1e6", "block", "16k", "pinned", "too_dense"])
def test_choose_params_matches_jax(args):
    try:
        want = ref_route._choose_params(*args)
    except ValueError:
        with pytest.raises(ValueError):
            port_route._choose_params(*args)
        return
    assert port_route._choose_params(*args) == want


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_build_routed_byte_identical(name, built):
    m, rm_ref, rm_port = built[name]
    _assert_same_routed(rm_ref, rm_port)
    assert np.array_equal(
        ref_route.routed_row_perm(m.row, m.dimension, rm_ref.R),
        port_route.routed_row_perm(m.row, m.dimension, rm_port.R))
    if name == "octet":
        assert rm_port.octet == 1
    if name == "powerlaw_spill":
        assert rm_port.stats["nnz_spill"] > 0


@pytest.mark.parametrize("name", ["octet", "powerlaw_spill"])
def test_stage_plain_versions_match_jax_stages(name, monkeypatch):
    """Plain K7 equals the JAX fused A+T stage exactly; plain K8 matches the
    JAX stage B within rel 1e-6 on the same products (octet layout, and the
    slice layout with a spill tail); the wrappers take the plain versions on
    the CPU and count no launch."""
    import jax.numpy as jnp

    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", SB_SMALL)
    make, kw = SCHEDULES[name]
    m = make()
    rm_ref = ref_route.build_routed(m, **kw)
    rm_port = port_route.build_routed(coo_for("ehyb_spmv_torch", m), **kw)
    _assert_same_routed(rm_ref, rm_port)
    assert rm_port.s_b == int(SB_SMALL)
    xp = _x_pad(rm_ref, m)
    ap = make_routed_apply(rm_ref, interpret=True)
    dev = rm_ref.to_jax()
    t_ref = np.asarray(ap.stages[0](dev, jnp.asarray(xp)))
    y_ref = np.asarray(ap.stages[1](dev, jnp.asarray(t_ref)))

    d = rm_port.to_torch()
    launches = (port_ops.route_at.launches, port_ops.route_b.launches)
    t_port = port_ops.route_at(d, torch.from_numpy(xp))
    assert np.array_equal(t_port.numpy(), t_ref.reshape(-1))
    y_port = port_ops.route_b(d, torch.from_numpy(t_ref.reshape(-1)))
    assert y_port.shape == y_ref.shape
    assert rel(y_port.numpy(), y_ref) <= STAGE_B_TOL
    assert (port_ops.route_at.launches, port_ops.route_b.launches) \
        == launches


def test_permuted_dst_apply_matches_oracle(built):
    """The full plain apply of a permuted-dst schedule (built without
    identity_dst) lands on the oracle through the scatter epilogue."""
    m, _, rm_port = built["powerlaw_spill"]
    assert not port_route.RoutedDevice(rm_port).ident
    y = port_ops.RoutedApply(rm_port.to_torch())(
        torch.from_numpy(_x_pad(rm_port, m)))
    x = deterministic_x(m.dimension)
    assert rel(y.numpy()[:m.dimension], oracle_spmv(m, x)) <= ORACLE_TOL


@pytest.mark.parametrize("external_order", [False, True],
                         ids=["single_block", "external_order"])
def test_routed_model_matches_jax_and_oracle(external_order, built,
                                             monkeypatch):
    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", SB_SMALL)
    m = built["random_16k"][0]
    x = deterministic_x(m.dimension)
    model = port.RoutedSpmv(port.EhybConfig(), external_order=external_order,
                            device="cpu").setup(coo_for("ehyb_spmv_torch", m))
    jmodel = ref_routed.RoutedSpmv(RefConfig(),
                                   external_order=external_order).setup(m)
    _assert_same_routed(jmodel.blocks[0], model.blocks[0])
    assert np.array_equal(model._perm, jmodel._perm)
    got = model.matvec(x)
    assert rel(got, oracle_spmv(m, x)) <= ORACLE_TOL
    assert rel(got, jmodel.matvec(x)) <= ORACLE_TOL
    if external_order:
        assert np.array_equal(model._perm, np.arange(m.dimension))


def test_routed_block_mode_matches_jax_and_oracle(monkeypatch):
    """Column-block mode with BLOCK_COLS patched small: both packages split
    into the same blocks with the same schedules, and the blocks' summed
    outputs hit the oracle."""
    m = _random_coo(1 << 15, 8, seed=17)
    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", SB_SMALL)
    monkeypatch.setattr(ref_routed, "BLOCK_COLS", 1 << 14)
    monkeypatch.setattr(port_routed, "BLOCK_COLS", 1 << 14)
    models = []
    for mod, model in ((ref_routed, ref_routed.RoutedSpmv(RefConfig())),
                       (port_routed, port.RoutedSpmv(port.EhybConfig(),
                                                     device="cpu"))):
        mm = m if mod is ref_routed else coo_for("ehyb_spmv_torch", m)
        model.m, model.setup_seconds, model.ehyb = mm, {}, None
        model._setup_blocks(mm, mod._block_ranges(m.dimension))
        models.append(model)
    jmodel, model = models
    assert len(model.blocks) == len(jmodel.blocks) == 2
    for a, b in zip(jmodel.blocks, model.blocks):
        _assert_same_routed(a, b)
    x = deterministic_x(m.dimension)
    got = model.matvec(x)
    assert rel(got, oracle_spmv(m, x)) <= ORACLE_TOL
    assert rel(got, jmodel.matvec(x)) <= ORACLE_TOL
    y_it = model.recover_y(model.iterate(model.prepare_x(x), 3))
    assert np.array_equal(y_it, got)


def test_split_model_matches_jax_and_oracle(monkeypatch):
    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", SB_SMALL)
    m = generate.random_general(1 << 14, 24, seed=4, power_law=0.7)
    x = deterministic_x(m.dimension)
    model = port.DegreeSplitSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", m))
    jmodel = RefSplit(RefConfig()).setup(m)
    got = model.matvec(x)
    assert rel(got, oracle_spmv(m, x)) <= ORACLE_TOL
    assert rel(got, jmodel.matvec(x)) <= ORACLE_TOL
    # the base class's eager loop chains both engines' x forms
    y_it = model.recover_y(model.iterate(model.prepare_x(x), 3))
    assert np.array_equal(y_it, got)
    want = oracle_spmv(m, x)
    for _ in range(2):
        want = oracle_spmv(m, x + 0.1 * want)
    got3 = model.recover_y(model.iterate(model.prepare_x(x), 3, eps=0.1))
    assert rel(got3, want) <= ORACLE_TOL


@pytest.fixture(scope="module")
def gather_wall():
    return _random_coo(1 << 17, 3, seed=31)


def test_gate_delegates_gather_wall_to_routed(gather_wall):
    m = coo_for("ehyb_spmv_torch", gather_wall)
    model = port.EhybSpmv(port.EhybConfig(), device="cpu").setup(m)
    assert isinstance(model, port.RoutedSpmv), type(model)
    # its setup seconds count the ordering the gate paid for
    assert {"order", "convert", "total"} <= set(model.setup_seconds)
    x = deterministic_x(m.dimension)
    assert rel(model.matvec(x), oracle_spmv(gather_wall, x)) <= ORACLE_TOL


def test_gate_picks_split_on_heavy_tail():
    hm = _heavy_tail(1 << 17)
    m = coo_for("ehyb_spmv_torch", hm)
    model = port.EhybSpmv(port.EhybConfig(), device="cpu").setup(m)
    assert isinstance(model, port.DegreeSplitSpmv), type(model)
    x = deterministic_x(m.dimension)
    assert rel(model.matvec(x), oracle_spmv(hm, x)) <= ORACLE_TOL


@pytest.mark.parametrize("case", ["stencil", "never"])
def test_gate_keeps_the_body(case, gather_wall):
    """A scrambled stencil recovers under the ordering (high group fill);
    routed_delegate='never' opts out on a real gather wall."""
    if case == "stencil":
        m = generate.permuted(generate.poisson2d(256), seed=11)
        cfg = port.EhybConfig()
    else:
        m = gather_wall
        cfg = port.EhybConfig(routed_delegate="never")
    assert m.dimension >= 1 << 16 and m.nnz >= 1 << 18   # gate-sized
    model = port.EhybSpmv(cfg, device="cpu").setup(
        coo_for("ehyb_spmv_torch", m))
    assert type(model) is port.EhybSpmv
    x = deterministic_x(m.dimension)
    assert rel(model.matvec(x), oracle_spmv(m, x)) <= ORACLE_TOL


def test_cached_gate_verdict_skips_ordering(gather_wall, tmp_path,
                                            monkeypatch):
    """The cold run caches its verdict (and the routed schedule) under the
    port's own cache dir; the warm run delegates from the pre-order hook,
    with no ordering and no routed rebuild."""
    m = coo_for("ehyb_spmv_torch", gather_wall)
    cfg = port.EhybConfig(artifact_cache=True, cache_dir=str(tmp_path))
    cold = port.EhybSpmv(cfg, device="cpu").setup(m)
    assert isinstance(cold, port.RoutedSpmv)
    assert [p for p in tmp_path.iterdir() if "-gate" in p.name]

    def boom(*a, **k):
        raise AssertionError("ordering chain paid on a warm delegation")

    monkeypatch.setattr(port_ordering, "pick_ordering", boom)
    monkeypatch.setattr(port_routed, "build_routed", boom)
    warm = port.EhybSpmv(cfg, device="cpu").setup(m)
    assert isinstance(warm, port.RoutedSpmv)
    assert "cache_load" in warm.setup_seconds
    x = deterministic_x(m.dimension)
    assert np.array_equal(warm.matvec(x), cold.matvec(x))


def test_cli_routed_on_cpu(tmp_path, monkeypatch, capsys):
    """``--model ehyb_routed --device cpu`` drives the routed engine end to
    end and reports its engine and schedule split."""
    import json

    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path))
    assert cli.main(["-g", "random_16k", "--model", "ehyb_routed", "-i", "3",
                     "--warmup", "1", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == "RoutedSpmv" and out["device"] == "cpu"
    assert out["nnz_routed"] + out["nnz_spill"] == out["nnz"]
    assert out["rel_error"] <= ORACLE_TOL
