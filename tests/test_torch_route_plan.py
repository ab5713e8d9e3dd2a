"""The one-pass routed plan on the CPU (``ops/route_xcache.py``).

The plan decodes the TPU's routed schedule into (dst row, column, value)
entries tiled by row group and x part; the CUDA kernel reads it on the card,
its plain version here.  Held: every COO entry decoded exactly once (as
multisets, in numpy), also in one plan over a matrix's column blocks; the
plain apply against the schedule's plain stages
(``route_b_plain(route_at_plain(x))`` plus the spill) and against the JAX
routed apply in Pallas interpret mode at rel 1e-6, the same products summed
in another order; the exact-f64 oracle at 5e-6, the suite's bound; the
geometry's edges; a staged plan of one schedule byte for byte as before
direct plans and column blocks in one plan (digests of its arrays); direct
plans; the geometry rule at random_1m's and random_4m's densities; and the
host replay of the kernel's order of sums, the same bits at every
geometry."""
import hashlib

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
    """RoutedSpmv in column-block mode at a small size (blocks of
    ``block_cols`` columns; None: ``BLOCK_COLS``)."""
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


def test_plan_decodes_each_entry_once_in_block_mode(monkeypatch):
    """Column blocks (BLOCK_COLS patched small): the host keeps one
    schedule per block, each holding its own columns (block-local); the
    model's one plan holds every block's entries at its columns of the
    shared x, each exactly once, in the model's permuted space."""
    monkeypatch.setattr(port_routed, "BLOCK_COLS", 1 << 14)
    m = _random_coo(1 << 15, 8, seed=17)
    model = _block_model(m, None)
    assert len(model.blocks) == 2
    for rm in model.blocks:
        assert rx.decode_routed(rm)[1].max() < rm.padded_x_rows
    p = model.routed_apply.plan
    assert p.stats["blocks"] == 2 and p.n_x == model._padded_x_rows
    row, col = (t.numpy() for t in rx.plan_rows_cols(p))
    _assert_same_entries((model._perm[row], model._perm[col],
                          p.ent_val.numpy()), m)
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
    d = model.routed_apply.d
    assert type(d) is port_route.RoutedEpilogue
    assert {n for n, _ in d.named_buffers()} == {"scat_src", "scat_dst"}
    assert model.routed_apply.plan.n_ent == m.nnz
    assert model.setup_seconds["route_plan"] > 0
    # the roofline counts the bytes the kernel moves, not the TPU's stages
    assert model.bytes_model() == model.routed_apply.plan.stats[
        "layout_bytes"]
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


def test_block_mode_model_runs_one_plan(monkeypatch):
    """RoutedSpmv in column-block mode (BLOCK_COLS patched small) runs its
    blocks through one plan on the CPU, one kernel call a product: the
    oracle's y, and the y of the blocks' own plans added as the TPU's model
    adds them.  (``test_torch_route.py``'s block-mode test holds the same
    model to the JAX RoutedSpmv.)"""
    monkeypatch.setattr(port_routed, "BLOCK_COLS", 1 << 14)
    m = _random_coo(1 << 15, 4, seed=23)
    model = _block_model(m, None)
    assert len(model.blocks) == 2
    p = model.routed_apply.plan
    assert p.n_ent == m.nnz and p.stats["blocks"] == 2
    calls = []
    plain = rx.route_xcache_plain
    monkeypatch.setattr(rx, "route_xcache_plain",
                        lambda *a: calls.append(1) or plain(*a))
    x = deterministic_x(m.dimension)
    xp = model.prepare_x(x)
    got = model.apply(xp)
    assert len(calls) == 1
    want = sum(port_ops.RoutedApply.of(rm, device="cpu")(
        xp[lo:lo + rm.padded_x_rows]) for rm, lo in zip(model.blocks,
                                                       model._lo))
    assert rel(got.numpy(), want.numpy()) <= PLAN_TOL
    assert rel(model.recover_y(got), oracle_spmv(m, x)) <= ORACLE_TOL


#: sha256 of the plan's arrays (tile_seg, seg_chunk, seg_ent, seg_npass,
#: ent_idx, ent_val) at GROUP_ROWS, PARTS and CHUNK_WINDOWS, as the plan was
#: built before direct plans and column blocks in one plan.
PLAN_DIGESTS = {
    "random_16k": "d4ea993ed985c226551ef483fe2edc1ab36bbe78209221c3e132f9a5"
                  "b996eda3",
    "octet": "0bcabb84d8adeeb051febc3330cf0a6295d0129132baebca1a01dd801dfb"
             "4890",
    "powerlaw_spill": "4304d25beb5244bbd8468a56d323430e3163239e7b6e9cd6e6579"
                      "a9acb02219b"}


@pytest.mark.parametrize("name", list(PLAN_DIGESTS))
def test_staged_plan_is_unchanged(name, schedules):
    """A single schedule's staged plan is the plan before direct plans and
    column blocks in one plan, byte for byte."""
    _, rm = schedules[name]
    p = rx.build_route_plan(rm, group_rows=rx.GROUP_ROWS, parts=rx.PARTS,
                            chunk_windows=rx.CHUNK_WINDOWS)
    h = hashlib.sha256()
    for f in ("tile_seg", "seg_chunk", "seg_ent", "seg_npass", "ent_idx",
              "ent_val"):
        h.update(np.ascontiguousarray(getattr(p, f)).tobytes())
    assert h.hexdigest() == PLAN_DIGESTS[name]


def test_geometry_rule_reads_entries_per_chunk():
    """random_1m's density (16 entries a row over 2^20 columns: 4,096 a
    staged chunk, 8 B of L2 an entry) keeps today's staged plan; random_4m's
    (8 over 2^22: 512, 64 B) reads x through L2 in a direct plan.  At small
    size the same densities choose the same."""
    one = rx.choose_geometry(16 << 20, 1 << 20, 1 << 20)
    four = rx.choose_geometry(8 << 22, 1 << 22, 1 << 22)
    assert one == dict(group_rows=rx.GROUP_ROWS, parts=rx.PARTS,
                       chunk_windows=rx.CHUNK_WINDOWS, threads=rx.THREADS,
                       direct=False)
    assert four == dict(group_rows=rx.DIRECT_GROUP_ROWS, parts=1,
                        chunk_windows=rx.DIRECT_CHUNK_WINDOWS,
                        threads=rx.DIRECT_THREADS, direct=True)
    # 2^18 rows: 4 entries a row over 2^18 columns is random_1m's 4,096 a
    # chunk; half an entry a row is random_4m's 512
    rng = np.random.default_rng(5)
    n = 1 << 18
    for per_row, direct in ((4, False), (0.5, True)):
        k = int(per_row * n)
        rows = np.sort(rng.integers(0, n, k))
        plan = rx.tile_entries((rows, rng.integers(0, n, k),
                                rng.standard_normal(k).astype(np.float32)),
                               n, n)
        assert plan.direct == direct
        assert plan.stats["staged_bytes"] / k <= (0 if direct else 8)
        if direct:
            # wide chunks: the column field takes the bits a staged plan's
            # rows would
            assert plan.chunk_cols == 1 << plan.col_bits \
                == rx.DIRECT_CHUNK_WINDOWS * 1024
            assert plan.stats["smem_bytes"] == 4 * rx.DIRECT_GROUP_ROWS


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_replay_is_the_kernels_order(name, schedules):
    """The host replay of the kernel's order of sums agrees with the plain
    version and gives the same bits at every geometry of one chunk size and
    part count, of any group size, staged or direct (a row's sum runs in
    plan order whatever the tiling of the other rows)."""
    m, rm = schedules[name]
    x = torch.from_numpy(_x_pad(rm, m))
    want = rx.route_xcache_plain(rx.build_route_plan(rm).to_torch(), x)
    got = None
    for geo in (dict(group_rows=8192), dict(group_rows=2048),
                dict(group_rows=8192, direct=True)):
        p = rx.build_route_plan(rm, chunk_windows=4, parts=2,
                                **geo).to_torch()
        y = rx.route_xcache_replay(p, x)
        assert rel(y, want.numpy()) <= PLAN_TOL
        assert got is None or np.array_equal(y, got)
        got = y


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_direct_plan_holds_each_entry_once(name, schedules):
    """A direct plan (wide chunks: the column field takes ``col_bits`` bits
    and leaves the rest to the row) holds every entry once, runs each
    segment pass by pass with a row at most once a pass, and its plain
    apply is the schedule's stages'."""
    m, rm = schedules[name]
    plan = rx.build_route_plan(rm, direct=True)
    p = plan.to_torch()
    assert plan.direct and plan.chunk_cols == 1 << plan.col_bits
    assert plan.stats["staged_bytes"] == 0
    row, col = (t.numpy() for t in rx.plan_rows_cols(p))
    _assert_same_entries((rm.dst_rows[row], col, plan.ent_val), m)
    ent_seg = np.repeat(np.arange(plan.stats["n_segs"]),
                        np.diff(plan.seg_ent))
    ent_pass = plan.ent_idx.view(np.uint32).astype(np.int64) >> rx.PASS_SHIFT
    key = (ent_seg * rx.MAX_PASSES + ent_pass) * rm.n_dst_rows + row
    assert np.unique(key).size == key.size
    assert np.all(np.diff(ent_pass)[np.diff(ent_seg) == 0] >= 0)
    x = _x_pad(rm, m)
    y = rx.route_xcache(p, torch.from_numpy(x)).numpy()
    assert rel(y, _stages_apply(rm, x)) <= PLAN_TOL


def test_plan_is_cached_beside_the_schedules(tmp_path):
    """With ``artifact_cache`` the model writes its plan beside its
    schedule, and a second setup reads it back: the same arrays, geometry
    and stats, and the same y."""
    m = SCHEDULES["random_16k"][0]()
    cfg = port.EhybConfig(artifact_cache=True, cache_dir=str(tmp_path))
    mm = coo_for("ehyb_spmv_torch", m)
    first = port.RoutedSpmv(cfg, device="cpu").setup(mm)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert any(f.endswith(f".plan{rx.PLAN_VERSION}.npz") for f in files)
    second = port.RoutedSpmv(cfg, device="cpu").setup(mm)
    assert "cache_load" in second.setup_seconds
    a, b = first.routed_apply.plan, second.routed_apply.plan
    for f in ("n_rows", "n_x", "group_rows", "parts", "chunk_cols",
              "threads", "direct", "col_bits", "n_tiles", "n_segs"):
        assert getattr(a, f) == getattr(b, f)
    assert a.stats == b.stats
    for f in (*a.MAP_FIELDS, "ent_idx", "ent_val"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    x = deterministic_x(m.dimension)
    assert np.array_equal(first.matvec(x), second.matvec(x))
