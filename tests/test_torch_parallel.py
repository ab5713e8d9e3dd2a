"""The port's sharded host layer against the JAX package's, and one shard's
K1 plan split into interior and boundary row blocks (no process group:
everything here runs in this process, on the CPU).

* ``plan_sharded`` takes the layout decisions of the JAX
  ``ShardedEhybSpmv.setup`` (run with ``EHYB_FORCE_PALLAS=interpret``, the
  branch the TPU takes) and ``build_sharded`` cuts every array of
  ``ShardedEhyb`` byte for byte as the JAX one does, the exchange plan and
  the DIA union included;
* ``build_sharded_routed`` gives every shard the JAX package's schedule;
* the interior row blocks of a shard's plan read local x rows only, the
  two lists cover every row block once, and two K1 calls over them fill
  the same y as one call over all;
* K1's row-block list in its plain version writes exactly the listed rows.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ehyb_spmv_gpu_tpu.config import EhybConfig as RefConfig
from ehyb_spmv_gpu_tpu.io import generate
from ehyb_spmv_gpu_tpu.parallel import routed as ref_routed
from ehyb_spmv_gpu_tpu.parallel import spmv as ref_spmv
from ehyb_spmv_torch.config import EhybConfig
from ehyb_spmv_torch.ops import ehyb_stream, stream_cells
from ehyb_spmv_torch.parallel import routed as port_routed
from ehyb_spmv_torch.parallel.comm import ShardExchange
from ehyb_spmv_torch.parallel.shard_cells import (ShardCellsPlan,
                                                  build_shard_cells)
from ehyb_spmv_torch.parallel.spmv import (ShardedEhyb, ShardedEhybApply,
                                           ShardedEhybSpmv, plan_sharded,
                                           shard_matrix)
from test_torch_parity import coo_for

PORT = "ehyb_spmv_torch"

#: Matrices of the sharded tests (JAX package's generators), each with the
#: config keywords it runs under.
MATRICES = {
    "poisson_mid": (lambda: generate.poisson2d(64), {}),
    "scrambled": (lambda: generate.permuted(generate.poisson2d(48),
                                            seed=11), {}),
    "powerlaw_long": (lambda: generate.with_dense_rows(
        generate.random_general(4000, 8, seed=7), 2, density=0.7, seed=8),
        {"long_row_threshold": 64}),
    "dim_2025": (lambda: generate.poisson2d(45), {}),
}


def _mesh(n: int):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), (ref_spmv.AXIS,))


def _assert_same_sharded(ref, port) -> None:
    """Every field of the JAX ShardedEhyb equal in the port's: arrays byte
    for byte (dtype and shape included), scalars, offsets and stats."""
    for f in dataclasses.fields(ref):
        if f.name == "stream":
            assert ref.stream is None
            continue
        va, vb = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            assert va.tobytes() == vb.tobytes(), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(MATRICES))
def test_build_sharded_matches_jax(name, n_dev, monkeypatch):
    """The port's host setup lands on the JAX one's reordering, layout and
    stacked shards, for every matrix at every world size."""
    monkeypatch.setenv("EHYB_FORCE_PALLAS", "interpret")
    make, kw = MATRICES[name]
    m = make()
    ref = ref_spmv.ShardedEhybSpmv(RefConfig(window_rows=1024, **kw),
                                   mesh=_mesh(n_dev)).setup(m)
    host = plan_sharded(coo_for(PORT, m), EhybConfig(window_rows=1024, **kw),
                        n_dev)
    for f in ("new_to_old", "old_to_new", "boundaries"):
        np.testing.assert_array_equal(getattr(host.reordering, f),
                                      getattr(ref.reordering, f))
    for f in ("body_layout", "index_dtype", "windows_per_subtile",
              "window_rows", "row_split_threshold"):
        assert getattr(host.config, f) == getattr(ref.config, f), f
    assert host.plan.window_rows == ref.plan.window_rows
    # the JAX arrays before its TPU stream maps reorder the body
    want = ref_spmv.build_sharded(
        ref.reordering.apply_to_matrix(m), ref.reordering,
        ref.plan.window_rows, n_dev, ref.config, stream_maps=False)
    _assert_same_sharded(want, host.sharded)
    sh = host.sharded
    assert isinstance(sh, ShardedEhyb)
    if sh.n_dev > 1 and name in ("scrambled", "powerlaw_long"):
        assert sh.exchange_slots > 0  # these cuts do need the exchange


@pytest.mark.parametrize("n_dev,block_cols", [(2, None), (4, 4096)])
def test_build_sharded_routed_matches_jax(n_dev, block_cols, monkeypatch):
    """Every shard's routed schedule of every column block is the JAX
    package's (its stacked arrays hold the same shard, padded)."""
    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", "8")
    rng = np.random.default_rng(3)
    dim = 8192
    rr = np.repeat(np.arange(dim), 4)
    cc = rng.integers(0, dim, rr.size)
    _, ui = np.unique(rr.astype(np.int64) * dim + cc, return_index=True)
    from ehyb_spmv_gpu_tpu.core.coo import MatrixCOO

    m = MatrixCOO(dim, dim, rr[ui].astype(np.int32), cc[ui].astype(np.int32),
                  rng.standard_normal(ui.size))
    ref_blocks, r_ref, l_ref = ref_routed.build_sharded_routed(
        m, n_dev, block_cols=block_cols)
    blocks, r_sh, L = port_routed.build_sharded_routed(
        coo_for(PORT, m), n_dev, block_cols=block_cols)
    assert (r_sh, L) == (r_ref, l_ref)
    assert len(blocks) == len(ref_blocks) == (1 if block_cols is None
                                              else 2)
    for (stacked, tmpl, lo_ref), (built, lo) in zip(ref_blocks, blocks):
        assert lo == lo_ref and sorted(built) == list(range(n_dev))
        for d, rm in built.items():
            for f in ("n_win", "P", "R", "s_b", "octet", "n_bg",
                      "bands_per_block"):
                assert getattr(rm, f) == getattr(tmpl, f), f
            for f in ("a_col", "a_val", "b_idx", "b_gmap", "sp_val",
                      "sp_col"):
                got = getattr(rm, f)
                want = stacked[f][d][: got.shape[0]]
                assert got.dtype == want.dtype, f
                assert got.tobytes() == want.tobytes(), f
            keep = rm.dst_rows < r_sh
            np.testing.assert_array_equal(np.flatnonzero(keep),
                                          stacked["scat_src"][d])
            np.testing.assert_array_equal(rm.dst_rows[keep],
                                          stacked["scat_dst"][d])
    # a rank builds its own shard (and shard 0, which pins the geometry)
    mine = port_routed.build_sharded_routed(
        coo_for(PORT, m), n_dev, block_cols=block_cols, shards=[n_dev - 1])
    assert sorted(mine[0][0][0]) == [0, n_dev - 1]


#: A heavy-tailed matrix (the suite's powerlaw_small), whose shards' K1
#: plans take the split form at every world size.
POWERLAW = (lambda: generate.random_general(3000, 16, seed=5,
                                            power_law=0.8), {})


def _shards(name: str, n_dev: int, force: bool = False, **extra):
    """(sharded matrix, [(shard EhybMatrix, its ShardCellsPlan)]); ``extra``
    config keywords."""
    make, kw = POWERLAW if name == "powerlaw_small" else MATRICES[name]
    sh = plan_sharded(coo_for(PORT, make()),
                      EhybConfig(window_rows=1024, **kw, **extra),
                      n_dev).sharded
    out = []
    for d in range(n_dev):
        e = shard_matrix(sh, d)
        out.append((e, build_shard_cells(e, sh, force_boundary=force)))
    return sh, out


def _x_ext(sh, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """A random ``[x_ext | recv]`` of one rank."""
    R, W = sh.rows_per_dev, sh.window_rows
    n = R + 2 * W + sh.n_dev * sh.exchange_slots
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _cell_reads(plan):
    """(row block, x column) of every cell of a K1 plan, its padding cells
    included: through its piece's table, or its own column in a direct
    piece."""
    piece = plan.piece.astype(np.int64)
    cell_piece = np.repeat(np.arange(len(piece) - 1), np.diff(piece[:, 0]))
    table = (np.diff(piece[:, 1]) > 0)[cell_piece]
    col = np.zeros(cell_piece.size, np.int64)
    if plan.cell_idx.size:
        idx = plan.cell_idx.view(np.uint16).astype(np.int64)[table]
        col[table] = plan.rows[piece[cell_piece[table], 1] + (idx >> 7)] \
            .astype(np.int64) * 128 + (idx & 127)
    if plan.cell_col.size:
        col[~table] = plan.cell_col[~table]
    return piece[cell_piece, 3], col


@pytest.mark.parametrize("name,n_dev,direct", [
    ("scrambled", 2, False), ("scrambled", 4, False),
    ("poisson_mid", 4, False), ("powerlaw_long", 2, False),
    ("scrambled", 4, True)], ids=["scrambled-2", "scrambled-4",
                                  "poisson_mid-4", "powerlaw_long-2",
                                  "scrambled-4-f64-direct"])
def test_interior_reads_local_rows_only(name, n_dev, direct, monkeypatch):
    """The lists cover every row block once, and the interior row blocks
    are exactly those none of whose cells (the folded ER and long-row
    cells among them, and padding) reads a halo or ``recv``: at
    scrambled's two ranks none (every row block holds an ER cell off the
    shard), elsewhere some; interior row blocks give the same sums when
    every x row outside the local ones is NaN, and two calls over the
    lists fill the same y as one call over all row blocks (over a split
    plan, two calls over their work items).  ``direct``: a float64 config
    whose every piece is direct (``DIRECT_BELOW`` patched), padding cells
    and all, its rows grouped where the grouping is kept."""
    extra, dtype = {}, np.float32
    if direct:
        monkeypatch.setattr(stream_cells, "DIRECT_BELOW", 1e9)
        extra, dtype = {"dtype": "float64"}, np.float64
    sh, shards = _shards(name, n_dev, **extra)
    R, W = sh.rows_per_dev, sh.window_rows
    n_int = n_bnd = 0
    for d, (e, sc) in enumerate(shards):
        both = np.concatenate([sc.interior, sc.boundary])
        assert np.array_equal(np.sort(both), np.arange(sc.plan.n_rb))
        rb, col = _cell_reads(sc.plan)
        off = np.unique(rb[(col < W) | (col >= W + R)])
        assert np.array_equal(sc.boundary, off)
        assert sc.plan.stats["folded"]
        with_cells = int((np.diff(sc.plan.piece[:, 0]) > 0).sum())
        assert sc.plan.stats["direct_pieces"] == (with_cells if direct
                                                  else 0)
        n_int += sc.interior.size
        n_bnd += sc.boundary.size
        p = sc.to_torch("cpu")
        x = torch.from_numpy(_x_ext(sh, d, dtype))
        full = ehyb_stream.stream_body(p.plan, x)
        # the interior list alone, with the halos and recv poisoned
        x_nan = x.clone()
        x_nan[:W] = float("nan")
        x_nan[W + R:] = float("nan")
        y_int = ehyb_stream.stream_body(p.plan, x_nan, rb_list=p.interior)
        rows = (torch.from_numpy(sc.interior).long()[:, None] * 32
                + torch.arange(32)).reshape(-1)
        if p.plan.row_map.numel():
            rows = p.plan.row_map.long()[rows]
        assert torch.equal(y_int[rows], full[rows])
        # interior, then boundary, into one y
        y = torch.full_like(full, 7.0)
        ehyb_stream.stream_body(p.plan, x, rb_list=p.interior, out=y)
        ehyb_stream.stream_body(p.plan, x, rb_list=p.boundary, out=y)
        assert torch.equal(y, full)
    assert n_bnd > 0 and (n_int > 0) == ((name, n_dev) != ("scrambled", 2))


@pytest.mark.parametrize("n_dev,force", [(1, False), (2, True)])
def test_all_boundary_at_one_rank_or_forced(n_dev, force):
    """As in the JAX package: a world of one rank, or
    EHYB_FORCE_BOUNDARY=1, puts every row block on the boundary side."""
    _, shards = _shards("scrambled", n_dev, force)
    for _, sc in shards:
        assert sc.interior.size == 0
        assert np.array_equal(sc.boundary, np.arange(sc.plan.n_rb))


@pytest.mark.parametrize("kahan", [False, True])
def test_row_block_list_plain_matches_full(kahan):
    """K1's plain version over a row-block list: the listed rows equal the
    full walk's, every other row keeps what ``out`` held (or zero without
    ``out``); an empty list writes nothing."""
    sh, shards = _shards("scrambled", 2)
    e, sc = shards[1]
    p = sc.to_torch("cpu").plan
    x = torch.from_numpy(_x_ext(sh, 5))
    full = ehyb_stream.stream_body_plain(p, x, kahan)
    rng = np.random.default_rng(1)
    pick = rng.permutation(p.n_rb)[: p.n_rb // 3].astype(np.int32)
    rb = torch.from_numpy(pick)
    rows = (rb.long()[:, None] * 32 + torch.arange(32)).reshape(-1)
    other = torch.ones(p.n_rb * 32, dtype=torch.bool)
    other[rows] = False
    y0 = ehyb_stream.stream_body_plain(p, x, kahan, rb_list=rb)
    assert torch.equal(y0[rows], full[rows])
    assert not y0[other].any()
    y = torch.full_like(full, -3.0)
    assert ehyb_stream.stream_body(p, x, kahan, rb_list=rb, out=y) is y
    assert torch.equal(y[rows], full[rows])
    assert bool((y[other] == -3.0).all())
    empty = torch.zeros(0, dtype=torch.int32)
    y2 = torch.full_like(full, 2.0)
    ehyb_stream.stream_body(p, x, kahan, rb_list=empty, out=y2)
    assert bool((y2 == 2.0).all())
    with pytest.raises(ValueError):
        ehyb_stream.stream_body(p, x, kahan, rb_list=rb.long())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
def test_split_list_plain_matches_full(dtype, kahan):
    """K1's plain version over a list of a split plan's work items
    (``stream_cells.list_items`` of some of its row blocks, a chunked one
    among them): the listed row blocks' rows equal the full call's bit for
    bit (their chunks are added in the same order), the other rows keep
    what ``out`` held; the wrapper on CPU tensors is the plain version.  A
    row-block list over a split plan, and a list of items over a plan in
    the table form, are refused."""
    sh, shards = _shards("powerlaw_small", 2, dtype=dtype)
    e, sc = shards[0]
    plan = sc.plan
    assert stream_cells.split(plan)
    p = plan.to_torch("cpu")
    x = torch.from_numpy(_x_ext(sh, 3, np.dtype(dtype)))
    full = ehyb_stream.stream_body_plain(p, x, kahan)
    rng = np.random.default_rng(2)
    rbs = np.union1d(plan.chunk_rb[:1],
                     rng.permutation(plan.n_rb)[: plan.n_rb // 3])
    items = torch.from_numpy(stream_cells.list_items(plan, rbs))
    assert items.shape[0] > len(rbs)      # a chunked row block's chunks
    rows = (torch.from_numpy(rbs).long()[:, None] * 32
            + torch.arange(32)).reshape(-1)
    other = torch.ones_like(full, dtype=torch.bool)
    other[rows] = False
    for fn in (ehyb_stream.stream_body_plain, ehyb_stream.stream_body):
        y = torch.full_like(full, -5.0)
        assert fn(p, x, kahan, rb_list=items, out=y) is y
        assert torch.equal(y[rows], full[rows])
        assert bool((y[other] == -5.0).all())
    # every item of the plan, as one list: the full call
    y = ehyb_stream.stream_body(p, x, kahan, rb_list=p.item)
    assert torch.equal(y, full)
    with pytest.raises(ValueError, match="split form.*row-block list"):
        ehyb_stream.stream_body(p, x, kahan, rb_list=torch.from_numpy(
            rbs.astype(np.int32)))
    table = shards[1][1] if not stream_cells.split(shards[1][1].plan) \
        else _shards("scrambled", 2)[1][0][1]
    q = table.plan.to_torch("cpu")
    with pytest.raises(ValueError, match="table form.*work items"):
        ehyb_stream.stream_body(q, torch.zeros(q.stats["x_rows"]),
                                rb_list=items)


def _world_one(name: str, **extra):
    """A ShardedEhybSpmv of one rank on the CPU, on MATRICES[name] (or the
    heavy-tailed matrix), and x for it."""
    make, kw = POWERLAW if name == "powerlaw_small" else MATRICES[name]
    m = coo_for(PORT, make())
    model = ShardedEhybSpmv(EhybConfig(window_rows=1024, **kw, **extra),
                            device="cpu").setup(m)
    xr = np.random.default_rng(7).standard_normal(m.dimension)
    return model, model.prepare_x(xr)


def test_sharded_apply_refuses_a_plan_without_the_tail():
    """Like the flagship's, the sharded apply takes only a K1 plan that
    holds the shard's ER and long rows: a plan of the body alone, or none,
    is refused (no torch tail runs in its place)."""
    sh, shards = _shards("powerlaw_long", 2)
    e, sc = shards[0]
    assert sc.plan.stats["folded"] and sc.plan.stats["tail_cells"] > 0
    R, W = sh.rows_per_dev, sh.window_rows
    body = stream_cells.build_stream_cells(
        e, R + 2 * W + sh.n_dev * sh.exchange_slots,
        **stream_cells.k1_options(e, lists=True))
    alone = dataclasses.replace(sc, plan=body).to_torch("cpu")
    ex = ShardExchange(None, 0, 1, R, W, sh.send_idx[0], sh.exchange_slots,
                       "cpu")
    dev = e.to_torch(device="cpu")
    for cells in (alone, None):
        with pytest.raises(ValueError, match="plan does not hold them"):
            ShardedEhybApply(dev, cells, ex)
    assert isinstance(sc, ShardCellsPlan)
    ShardedEhybApply(dev, sc.to_torch("cpu"), ex)


@pytest.mark.parametrize("name", ["scrambled", "powerlaw_small"])
def test_sharded_apply_phases_and_roofline(name):
    """One rank's apply is its phases: K1 over the interior row blocks
    (none at one rank), K1 over the boundary ones, and K9 (its accumulate
    mode adds into K1's y what its write mode writes), bit for bit; the
    roofline counts K1's plan with the tail inside it (no ER or long
    phase), K9's diagonals and the x/y vectors, its total
    ``bytes_model()``."""
    model, x = _world_one(name)
    ph = model.module.phases()
    assert set(ph) == {"body interior", "body boundary", "dia"}
    assert ph["body interior"](x).numel() == 0
    y = model.apply(x)
    want = ph["body boundary"](x)[:y.shape[0]]
    y_dia = ph["dia"](x)
    if y_dia.numel():
        want = want + y_dia
    assert torch.equal(y, want)
    st = model.ehyb.stats
    roof = model.roofline_phases()
    assert set(roof) == {"x/y vectors", "dia", "body"}
    cells = model.module.cells.plan.stats
    assert roof["body"] == (2 * (st.get("nnz_ell", 0) + st.get("nnz_er", 0)
                                 + st.get("nnz_long", 0)),
                            cells["stream_bytes"])
    assert sum(b for _, b in roof.values()) == model.bytes_model()


def test_sharded_setup_is_cached(tmp_path):
    """With ``artifact_cache`` the sharded degree split at one rank writes
    its host setup (``cached_plan_sharded``'s, the rank's K1 plan, the
    routed schedules and plans) into the cache, and a second setup reads
    every piece of it and gives the same product bit for bit."""
    from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv

    m = coo_for(PORT, POWERLAW[0]())
    cfg = EhybConfig(window_rows=1024, artifact_cache=True,
                     cache_dir=str(tmp_path))
    x = np.random.default_rng(8).standard_normal(m.dimension)
    first = ShardedDegreeSplitSpmv(cfg, device="cpu").setup(m, threshold=32)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert any(n.endswith(".pkl") and "-sharded-" in n for n in names)
    assert any(".k1-" in n for n in names)
    assert any("-sharded1-r0" in n and n.endswith(".pkl") for n in names)
    assert any("-sharded1-r0" in n and ".plan" in n for n in names)
    again = ShardedDegreeSplitSpmv(cfg, device="cpu").setup(m, threshold=32)
    assert "cache_load" in again.e.setup_seconds
    assert sorted(p.name for p in tmp_path.iterdir()) == names
    np.testing.assert_array_equal(again.matvec(x), first.matvec(x))


def test_sharded_models_default_to_the_card(monkeypatch):
    """Without a process group a sharded model is a world of one rank; its
    default device is the card, so asking for it without CUDA raises (the
    CPU only where asked)."""
    from ehyb_spmv_torch.parallel.comm import group_rank_world, rank_device
    from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv
    from ehyb_spmv_torch.parallel.routed import ShardedRoutedSpmv
    from ehyb_spmv_torch.parallel.spmv import ShardedEhybSpmv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert group_rank_world(None) == (None, 0, 1)
    assert rank_device("cpu", 3) == torch.device("cpu")
    for cls in (ShardedEhybSpmv, ShardedRoutedSpmv, ShardedDegreeSplitSpmv):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(EhybConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(EhybConfig(), device="cuda")
        model = cls(EhybConfig(), device="cpu")
        assert (model.n_dev, model.rank, model.device.type) == (1, 0, "cpu")


def test_dryrun_ranks_default_to_the_card(monkeypatch):
    """``dryrun_multichip``'s ranks run on the card unless the caller asks
    for the CPU: a rank with no device and no CUDA raises before any work."""
    import inspect

    from ehyb_spmv_torch.parallel import launch

    params = inspect.signature(launch.dryrun_multichip).parameters
    assert params["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch._dryrun_rank(0, 1, None)
