"""Rank functions of the multi-process tests of the sharded port
(``tests/test_torch_parallel_dist.py``): each runs in a process of its own,
started by ``ehyb_spmv_torch.parallel.launch.spawn``, so this module
imports the port only."""
from __future__ import annotations

import torch

from ehyb_spmv_torch.config import EhybConfig
from ehyb_spmv_torch.core.coo import deterministic_x
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv
from ehyb_spmv_torch.parallel.launch import _random_matrix
from ehyb_spmv_torch.parallel.routed import ShardedRoutedSpmv
from ehyb_spmv_torch.parallel.spmv import ShardedEhybSpmv

#: The sharded EHYB cases: matrix and config keywords.
EHYB_CASES = {
    "scrambled": (lambda: generate.permuted(generate.poisson2d(48),
                                            seed=11), {}),
    "powerlaw_long": (lambda: generate.with_dense_rows(
        generate.random_general(4000, 8, seed=7), 2, density=0.7, seed=8),
        {"long_row_threshold": 64}),
    "dim_2025": (lambda: generate.poisson2d(45), {}),
    # a float64 config: K1's f64 list variants (interior and boundary)
    "scrambled_f64": (lambda: generate.permuted(generate.poisson2d(48),
                                                seed=11),
                      {"dtype": "float64"}),
    # heavy-tailed (the suite's powerlaw_small): every world's shards reach
    # K1's split form, their lists work items
    "powerlaw_split": (lambda: generate.random_general(
        3000, 16, seed=5, power_law=0.8), {}),
}


def routed_matrix():
    return _random_matrix(8192, 4, seed=3)


def split_matrix():
    return generate.random_general(6144, 24, seed=4, power_law=0.7)


def check_rank(rank: int, world: int) -> dict:
    """Every sharded engine on this rank, on the CPU: y of each case (rank
    0 returns them, gathered over the ranks), the shard's row-block counts
    and exchange size, and whether the chained loop at eps 0 repeats the
    apply bit for bit."""
    out = {"y": {}, "stats": {}}
    for name, (make, kw) in EHYB_CASES.items():
        m = make()
        model = ShardedEhybSpmv(EhybConfig(window_rows=1024, **kw),
                                device="cpu").setup(m)
        x = model.prepare_x(deterministic_x(m.dimension))
        y1 = model.apply(x).clone()
        y3 = model.iterate(x, 3, eps=0.0)
        st = model.module.cells.stats
        out["stats"][name] = dict(
            interior=st["n_interior"], boundary=st["n_boundary"],
            chunked=st["chunked_rbs"], folded=st["folded"],
            S=model.sharded.exchange_slots, loop=model.loop,
            iterate_equal=bool(torch.equal(y1, y3)))
        out["y"][name] = model.recover_y(y1)
    mr = routed_matrix()
    xr = deterministic_x(mr.dimension)
    cfg = EhybConfig(artifact_cache=False)
    out["y"]["routed"] = ShardedRoutedSpmv(cfg, device="cpu").setup(
        mr).matvec(xr)
    out["y"]["routed_blocks"] = ShardedRoutedSpmv(cfg, device="cpu").setup(
        mr, block_cols=4096).matvec(xr)
    mh = split_matrix()
    hm = ShardedDegreeSplitSpmv(
        EhybConfig(window_rows=1024, artifact_cache=False),
        device="cpu").setup(mh, threshold=32)
    xh = hm.prepare_x(deterministic_x(mh.dimension))
    out["stats"]["split"] = dict(
        nnz=(hm.e.m.nnz, hm.r.m.nnz),
        iterate_equal=bool(torch.equal(hm.apply(xh), hm.iterate(xh, 2))))
    out["y"]["split"] = hm.recover_y(hm.apply(xh))
    if rank:
        out["y"] = {}
    return out
