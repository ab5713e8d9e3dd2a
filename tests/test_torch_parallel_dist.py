"""The sharded port in several processes: gloo ranks on the CPU, started by
``ehyb_spmv_torch.parallel.launch``, one spawn per world size (1, 2, 4),
each rank running every sharded engine (``tests/torch_parallel_ranks.py``).

Each product is held against the JAX package's sharded model on the
virtual 8-device mesh (rel 2e-6; 1e-5 for the degree split, the JAX
suite's own bound for it) and against the f64 oracle (rel 5e-6; 1e-5 for
the split; 1e-12 for a float64 config, which the JAX package computes in
f32, so the JAX bound stays the f32 one).  The JAX routed engines run their Pallas kernels in interpret
mode here, which compiles slowly, so the routed engine is held against
JAX at two ranks and the split at four (the JAX suite's case); the
column-block mode against the oracle and the single-block product.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from ehyb_spmv_gpu_tpu.config import EhybConfig as RefConfig
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.parallel.hybrid import \
    ShardedDegreeSplitSpmv as RefSplit
from ehyb_spmv_gpu_tpu.parallel.routed import ShardedRoutedSpmv as RefRouted
from ehyb_spmv_gpu_tpu.parallel.spmv import AXIS
from ehyb_spmv_gpu_tpu.parallel.spmv import ShardedEhybSpmv as RefSharded
from ehyb_spmv_torch.parallel.launch import dryrun_multichip, spawn
from test_torch_parity import coo_for, rel
from torch_parallel_ranks import (EHYB_CASES, check_rank, routed_matrix,
                                  split_matrix)

#: Seconds a spawn of every engine may take before its ranks are killed.
SPAWN_TIMEOUT_S = 240


def _mesh(n: int):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), (AXIS,))


def _ref(m):
    """The port's MatrixCOO as the JAX package's."""
    return coo_for("ehyb_spmv_gpu_tpu", m)


@pytest.fixture(scope="module", params=[1, 2, 4])
def ranks(request):
    """(world size, each rank's result) of one spawn of every engine."""
    world = request.param
    return world, spawn(check_rank, world, "gloo", timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", list(EHYB_CASES))
def test_sharded_ehyb_matches_jax_and_oracle(ranks, name):
    world, res = ranks
    make, kw = EHYB_CASES[name]
    m = _ref(make())
    x = deterministic_x(m.dimension)
    want = RefSharded(RefConfig(window_rows=1024, **kw),
                      mesh=_mesh(world)).setup(m).matvec(x)
    y = res[0]["y"][name]
    assert rel(y, want) <= 2e-6
    tol = 1e-12 if kw.get("dtype") == "float64" else 5e-6
    assert rel(y, oracle_spmv(m, x)) <= tol


def test_sharded_ehyb_row_block_kinds(ranks):
    """Both kinds of row block exist at two ranks and more (none interior
    at one), the exchange runs where the cut needs it, the loop is eager
    on the CPU and repeats the apply bit for bit at eps 0."""
    world, res = ranks
    for name in EHYB_CASES:
        st = [r["stats"][name] for r in res]
        assert all(s["loop"] == "eager" and s["iterate_equal"] for s in st)
        if world == 1:
            assert all(s["interior"] == 0 and s["boundary"] > 0 for s in st)
        elif name == "scrambled":
            assert sum(s["interior"] for s in st) > 0
            assert sum(s["boundary"] for s in st) > 0
            assert st[0]["S"] > 0


def test_sharded_routed(ranks, monkeypatch):
    world, res = ranks
    m = _ref(routed_matrix())
    x = deterministic_x(m.dimension)
    y, yb = res[0]["y"]["routed"], res[0]["y"]["routed_blocks"]
    want = oracle_spmv(m, x)
    assert rel(y, want) <= 5e-6 and rel(yb, want) <= 5e-6
    assert rel(yb, y) <= 2e-6
    if world == 2:
        monkeypatch.setenv("EHYB_ROUTE_SB_MAX", "8")
        ref = RefRouted(RefConfig(artifact_cache=False),
                        mesh=_mesh(world)).setup(m)
        assert rel(y, ref.matvec(x)) <= 2e-6


def test_sharded_degree_split(ranks, monkeypatch):
    world, res = ranks
    m = _ref(split_matrix())
    x = deterministic_x(m.dimension)
    y = res[0]["y"]["split"]
    st = [r["stats"]["split"] for r in res]
    assert all(s["iterate_equal"] for s in st)
    assert st[0]["nnz"][0] > 0 and st[0]["nnz"][1] > 0
    assert sum(st[0]["nnz"]) == m.nnz
    assert rel(y, oracle_spmv(m, x)) <= 1e-5
    if world == 4:
        monkeypatch.setenv("EHYB_ROUTE_SB_MAX", "8")
        ref = RefSplit(RefConfig(window_rows=1024, artifact_cache=False),
                       mesh=_mesh(world)).setup(m, threshold=32)
        assert rel(y, ref.matvec(x)) <= 1e-5


def test_dryrun_multichip_four_ranks():
    """The port's counterpart of ``__graft_entry__.dryrun_multichip(4)``:
    one sharded product of each engine on four gloo ranks."""
    errs = dryrun_multichip(4, device="cpu", timeout=SPAWN_TIMEOUT_S)
    assert set(errs) == {"ehyb", "routed", "routed_blocks", "split"}
