"""The one-pass routed plan on the CPU (``ops/route_xcache.py``).

The plan decodes the TPU's routed schedule into (dst row, column, value)
entries tiled by row group and x part; the CUDA kernel reads it on the card,
its plain version here.  Held: every COO entry decoded exactly once (as
multisets, in numpy); the plain apply against the schedule's plain stages
(``route_b_plain(route_at_plain(x))`` plus the spill) and against the JAX
routed apply in Pallas interpret mode at rel 1e-6, the same products summed
in another order; the exact-f64 oracle at 5e-6, the suite's bound; and the
geometry's edges."""
import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu.core.route as ref_route
from ehyb_spmv_gpu_tpu.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.ops.route_pallas import make_routed_apply

import ehyb_spmv_torch as port
import ehyb_spmv_torch.core.route as port_route
import ehyb_spmv_torch.models.routed as port_routed
from ehyb_spmv_torch.ops import route as port_ops
from ehyb_spmv_torch.ops import route_xcache as rx
from test_torch_parity import coo_for, rel
from test_torch_route import SB_SMALL, SCHEDULES, _random_coo, _x_pad

ORACLE_TOL = 5e-6
PLAN_TOL = 1e-6


@pytest.fixture(scope="module")
def schedules():
    """name -> (matrix, port RoutedMatrix)."""
    return {name: (m, port_route.build_routed(coo_for("ehyb_spmv_torch", m),
                                              **kw))
            for name, (make, kw) in SCHEDULES.items() for m in [make()]}


def _block_model(m, block_cols=1 << 14):
    """RoutedSpmv in column-block mode at a small size."""
    model = port.RoutedSpmv(port.EhybConfig(), device="cpu")
    mm = coo_for("ehyb_spmv_torch", m)
    model.m, model.setup_seconds, model.ehyb = mm, {}, None
    model._setup_blocks(mm, port_routed._block_ranges(m.dimension,
                                                      block_cols))
    return model


def _multiset(row, col, val):
    order = np.lexsort((val, col, row))
    return (np.asarray(row, np.int64)[order], np.asarray(col, np.int64)[order],
            np.asarray(val, np.float32)[order])


def _assert_same_entries(got, m):
    want = _multiset(m.row, m.col, np.asarray(m.val, np.float32))
    for a, b in zip(_multiset(*got), want):
        assert np.array_equal(a, b)


def _plan_apply(rm, x, **geo):
    """The plan's plain apply in dst space."""
    plan = rx.build_route_plan(rm, **geo)
    return rx.route_xcache(plan.to_torch(), torch.from_numpy(x)).numpy(), plan


def _stages_apply(rm, x):
    """The schedule's own plain stages plus the spill, in dst space."""
    d, xt = rm.to_torch(), torch.from_numpy(x)
    y = port_ops.route_b_plain(d, port_ops.route_at_plain(d, xt))
    return port_ops.spill_tail(d, xt, y).numpy()


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plan_decodes_each_entry_once(name, schedules):
    m, rm = schedules[name]
    row, col, val = rx.decode_routed(rm)
    assert row.shape[0] == m.nnz \
        == rm.stats["nnz_routed"] + rm.stats["nnz_spill"]
    _assert_same_entries((rm.dst_rows[row], col, val), m)
    plan = rx.build_route_plan(rm)
    assert plan.stats["entries"] == m.nnz
    assert plan.stats["spilled"] == rm.stats["nnz_spill"]


def test_plan_decodes_each_entry_once_in_block_mode():
    """Column blocks: each block's plan holds its own columns (block-local),
    in the model's permuted space; together they hold the matrix."""
    m = _random_coo(1 << 15, 8, seed=17)
    model = _block_model(m)
    assert len(model.blocks) == 2
    rows, cols, vals = [], [], []
    for rm, lo in zip(model.blocks, model._lo):
        r, c, v = rx.decode_routed(rm)
        assert c.max() < rm.padded_x_rows
        rows.append(model._perm[r])
        cols.append(model._perm[c + lo])
        vals.append(v)
    _assert_same_entries((np.concatenate(rows), np.concatenate(cols),
                          np.concatenate(vals)), m)
    x = deterministic_x(m.dimension)
    assert rel(model.matvec(x), oracle_spmv(m, x)) <= ORACLE_TOL


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plan_apply_matches_the_stages(name, schedules):
    m, rm = schedules[name]
    x = _x_pad(rm, m)
    y, _ = _plan_apply(rm, x)
    assert y.shape == (rm.n_dst_rows,)
    assert rel(y, _stages_apply(rm, x)) <= PLAN_TOL


@pytest.mark.parametrize("name", ["octet", "powerlaw_spill"])
def test_plan_apply_matches_jax_interpret(name, monkeypatch):
    """The whole routed apply (plan, then epilogue) against the JAX routed
    apply run in Pallas interpret mode, on the same schedule."""
    import jax.numpy as jnp

    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", SB_SMALL)
    make, kw = SCHEDULES[name]
    m = make()
    rm_ref = ref_route.build_routed(m, **kw)
    rm = port_route.build_routed(coo_for("ehyb_spmv_torch", m), **kw)
    assert rm.b_idx.tobytes() == rm_ref.b_idx.tobytes()
    x = _x_pad(rm, m)
    want = np.asarray(make_routed_apply(rm_ref, interpret=True)(
        rm_ref.to_jax(), jnp.asarray(x)))
    got = port_ops.RoutedApply.of(rm, device="cpu")(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= PLAN_TOL


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_routed_apply_meets_the_oracle(name, schedules):
    m, rm = schedules[name]
    ap = port_ops.RoutedApply.of(rm, device="cpu")
    launches = rx.route_xcache.launches
    y = ap(torch.from_numpy(_x_pad(rm, m))).numpy()[:m.dimension]
    assert rel(y, oracle_spmv(m, deterministic_x(m.dimension))) <= ORACLE_TOL
    # the CPU takes the plain version and counts no launch
    assert rx.route_xcache.launches == launches


def test_routed_apply_defaults_to_the_card(schedules):
    """``RoutedApply.of`` uploads to the card unless the caller asks for
    the CPU, as every model does: without a CUDA device it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ops.RoutedApply.of(schedules["random_16k"][1])


def test_model_keeps_no_stage_arrays_on_the_device():
    """The model uploads the plan and the epilogue's maps; the schedule's
    stage arrays stay on the host, and the plan's build is timed."""
    m = SCHEDULES["random_16k"][0]()
    model = port.RoutedSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", m))
    d = model.applies[0].d
    assert type(d) is port_route.RoutedEpilogue
    assert {n for n, _ in d.named_buffers()} == {"scat_src", "scat_dst"}
    assert model.applies[0].plan.n_ent == m.nnz
    assert model.setup_seconds["route_plan"] > 0
    # the roofline counts the bytes the kernel moves, not the TPU's stages
    assert model.bytes_model() == model.applies[0].plan.stats["layout_bytes"]
    x = deterministic_x(m.dimension)
    assert rel(model.matvec(x), oracle_spmv(m, x)) <= ORACLE_TOL


def _geometry_case(case):
    """(matrix, plan geometry) of one edge of the tiling."""
    rng = np.random.default_rng(7)
    dim = 1 << 14
    if case == "empty_windows":
        # columns only in even windows of 1024: the odd ones hold nothing
        row = np.repeat(np.arange(dim), 6)
        col = rng.integers(0, dim // 2048, row.size) * 2048 \
            + rng.integers(0, 1024, row.size)
        geo = dict(group_rows=2048, parts=4, chunk_windows=1)
    elif case in ("full_row", "heavy_row"):
        # row 5 has an entry in every window, so in every part; or 40 in
        # window 3, more than one segment's passes
        extra = (np.arange(dim // 1024) * 1024 + 3 if case == "full_row"
                 else 3 * 1024 + np.arange(40) * 7)
        row = np.concatenate([np.repeat(np.arange(dim), 4),
                              np.full(extra.size, 5)])
        col = np.concatenate([rng.integers(0, dim, dim * 4), extra])
        geo = dict(group_rows=4096, parts=4, chunk_windows=2)
    else:
        m = SCHEDULES["random_16k"][0]()
        geo = (dict(group_rows=96, parts=3, chunk_windows=2)
               if case == "short_group"
               else dict(group_rows=1 << 16, parts=1, chunk_windows=64))
        return m, geo
    _, ui = np.unique(row.astype(np.int64) * dim + col, return_index=True)
    m = MatrixCOO(dim, dim, row[ui].astype(np.int32), col[ui].astype(np.int32),
                  np.random.default_rng(9).standard_normal(ui.size))
    return m, geo


@pytest.mark.parametrize("case", ["short_group", "one_tile", "empty_windows",
                                  "full_row", "heavy_row"])
def test_plan_geometry_edges(case):
    m, geo = _geometry_case(case)
    rm = port_route.build_routed(coo_for("ehyb_spmv_torch", m))
    x = _x_pad(rm, m)
    y, plan = _plan_apply(rm, x, **geo)
    st = plan.stats
    n_chunks = -(-rm.padded_x_rows // plan.chunk_cols)
    per_part = -(-n_chunks // plan.parts)
    seg_tile = np.repeat(np.arange(st["n_tiles"]), np.diff(plan.tile_seg))
    ent_seg = np.repeat(np.arange(st["n_segs"]), np.diff(plan.seg_ent))
    idx = plan.ent_idx.view(np.uint32).astype(np.int64)
    ent_pass = idx >> rx.PASS_SHIFT
    ent_row = (seg_tile[ent_seg] // plan.parts) * plan.group_rows \
        + ((idx >> rx.ROW_SHIFT) & (rx.MAX_GROUP_ROWS - 1))
    dst5 = int(np.flatnonzero(rm.dst_rows == 5)[0])
    if case == "short_group":
        assert rm.n_dst_rows % plan.group_rows
        assert st["n_groups"] == -(-rm.n_dst_rows // 96)
        assert plan.parts == 3
    elif case == "one_tile":
        assert st["n_tiles"] == 1 and plan.parts == 1
        assert plan.group_rows == rm.n_dst_rows
    elif case == "empty_windows":
        assert st["n_segs"] < st["n_groups"] * n_chunks
        assert set(plan.seg_chunk.tolist()) <= set(range(0, n_chunks, 2))
    elif case == "full_row":
        # the dst row of input row 5 has entries in every part of its group
        parts5 = set((seg_tile[ent_seg][ent_row == dst5]
                      % plan.parts).tolist())
        assert plan.parts == 4 and parts5 == set(range(4))
    else:
        # row 5's 40 entries of one chunk fill 8 passes of 5 segments
        segs5 = np.unique(ent_seg[ent_row == dst5])
        assert plan.seg_npass.max() == rx.MAX_PASSES
        assert len(set(plan.seg_chunk[segs5].tolist())) < segs5.size
    # segments run in chunk order within a tile, each chunk inside its part
    same_tile = np.diff(seg_tile) == 0
    assert np.all(np.diff(plan.seg_chunk)[same_tile] >= 0)
    assert np.all(plan.seg_chunk // per_part == seg_tile % plan.parts)
    assert np.all(np.diff(plan.seg_ent) > 0)
    # a segment runs pass by pass, and a pass holds each row at most once
    assert np.all(np.diff(ent_pass)[np.diff(ent_seg) == 0] >= 0)
    assert np.array_equal(plan.seg_npass, np.maximum.reduceat(
        ent_pass, plan.seg_ent[:-1]) + 1)
    key = (ent_seg * rx.MAX_PASSES + ent_pass) * rm.n_dst_rows + ent_row
    assert np.unique(key).size == key.size
    assert rel(y, _stages_apply(rm, x)) <= PLAN_TOL
    y_in = port_ops.to_input_space(port_route.RoutedEpilogue(rm),
                                   torch.from_numpy(y)).numpy()
    x0 = deterministic_x(m.dimension)
    assert rel(y_in[:m.dimension], oracle_spmv(m, x0)) <= ORACLE_TOL


@pytest.mark.parametrize("geo", [dict(threads=48), dict(threads=2048),
                                 dict(parts=0), dict(group_rows=100)],
                         ids=["threads_48", "threads_2048", "parts_0",
                              "rows_100"])
def test_plan_refuses_bad_geometry(geo, schedules):
    """The plan refuses a bad tiling; the launch a bad block size, before
    it reaches for the card."""
    rm = schedules["powerlaw_spill"][1]
    with pytest.raises(ValueError):
        if "threads" in geo:
            rx._launch(rx.build_route_plan(rm).to_torch(),
                       torch.zeros(rm.padded_x_rows), geo["threads"])
        else:
            rx.build_route_plan(rm, **geo)


def test_epilogue_alone_maps_as_the_schedule(schedules):
    """The epilogue module the model keeps returns a permuted-dst
    schedule's y to input space as the whole device mirror does."""
    m, rm = schedules["powerlaw_spill"]
    e, d = port_route.RoutedEpilogue(rm), rm.to_torch()
    assert not e.ident
    y_dst = torch.arange(rm.n_dst_rows, dtype=torch.float32)
    assert torch.equal(port_ops.to_input_space(e, y_dst),
                       port_ops.to_input_space(d, y_dst))
