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
from ehyb_spmv_torch.ops import ehyb_stream
from ehyb_spmv_torch.parallel import routed as port_routed
from ehyb_spmv_torch.parallel.shard_cells import build_shard_cells
from ehyb_spmv_torch.parallel.spmv import (ShardedEhyb, plan_sharded,
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


def _shards(name: str, n_dev: int, force: bool = False):
    """(sharded matrix, [(shard EhybMatrix, its ShardCellsPlan)])."""
    make, kw = MATRICES[name]
    sh = plan_sharded(coo_for(PORT, make()),
                      EhybConfig(window_rows=1024, **kw), n_dev).sharded
    out = []
    for d in range(n_dev):
        e = shard_matrix(sh, d)
        out.append((e, build_shard_cells(e, sh, force_boundary=force)))
    return sh, out


def _x_ext(sh, seed: int = 0) -> np.ndarray:
    """A random ``[x_ext | recv]`` of one rank."""
    R, W = sh.rows_per_dev, sh.window_rows
    n = R + 2 * W + sh.n_dev * sh.exchange_slots
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("name,n_dev", [("scrambled", 2), ("scrambled", 4),
                                        ("poisson_mid", 4),
                                        ("powerlaw_long", 2)])
def test_interior_reads_local_rows_only(name, n_dev):
    """Both kinds of row block exist at D >= 2; the lists cover every row
    block once; interior row blocks give the same sums when every x row
    outside the local ones is NaN (they read none of them), and two calls
    over the lists fill the same y as one call over all row blocks."""
    sh, shards = _shards(name, n_dev)
    R, W = sh.rows_per_dev, sh.window_rows
    n_int = n_bnd = 0
    for d, (e, sc) in enumerate(shards):
        both = np.concatenate([sc.interior, sc.boundary])
        assert np.array_equal(np.sort(both), np.arange(sc.plan.n_rb))
        n_int += sc.interior.size
        n_bnd += sc.boundary.size
        p = sc.to_torch("cpu")
        x = torch.from_numpy(_x_ext(sh, d))
        full = ehyb_stream.stream_body(p.plan, x)
        # the interior list alone, with the halos and recv poisoned
        x_nan = x.clone()
        x_nan[:W] = float("nan")
        x_nan[W + R:] = float("nan")
        y_int = ehyb_stream.stream_body(p.plan, x_nan, rb_list=p.interior)
        rows = (p.interior.long()[:, None] * 32
                + torch.arange(32)).reshape(-1)
        assert torch.equal(y_int[rows], full[rows])
        # interior, then boundary, into one y
        y = torch.full_like(full, 7.0)
        ehyb_stream.stream_body(p.plan, x, rb_list=p.interior, out=y)
        ehyb_stream.stream_body(p.plan, x, rb_list=p.boundary, out=y)
        assert torch.equal(y, full)
    assert n_int > 0 and n_bnd > 0


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
