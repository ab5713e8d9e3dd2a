"""Start ranks of the sharded models on one machine, and the multi-rank
dry run.

Port counterpart of ``scripts/multihost.py`` (a multi-process run of the
sharded path) and of ``__graft_entry__.dryrun_multichip`` (one sharded
product of each engine on tiny shapes).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(the spawn method, as CUDA needs), joins them in one process group over a
file store in a fresh temporary directory (no port to pick, nothing
outside the machine), runs ``fn(rank, world, *args)`` in each and returns
what each rank returned, in rank order.  A rank that raises fails the
call (the others are stopped).

Gloo runs several ranks on one card (or on the CPU); NCCL refuses two
ranks on one device, so it needs a card per rank.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import rank_device

#: How long a collective may wait before the group gives up.
TIMEOUT_S = 600


def _worker(rank: int, world: int, backend: str, store: str, out_dir: str,
            fn: Callable, args: tuple) -> None:
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "gloo",
          args: tuple = (), timeout: Optional[float] = None) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` ranks of one process
    group (``fn`` must be importable by name: a module-level function) and
    return each rank's result, in rank order.  Past ``timeout`` seconds the
    ranks are killed and the call raises ``TimeoutError``."""
    tmp = tempfile.mkdtemp(prefix="ehyb_ranks_")
    try:
        ctx = mp.start_processes(
            _worker, args=(world, backend, os.path.join(tmp, "store"), tmp,
                           fn, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            if ctx.join(timeout=left):
                break
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The dry run: one product of each sharded engine on tiny shapes.
# ---------------------------------------------------------------------------

def _random_matrix(dim: int, per_row: int, seed: int):
    """A random square matrix of ``per_row`` entries a row (duplicates
    merged), values from a seeded normal."""
    from ..core.coo import MatrixCOO

    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(dim), per_row)
    cc = rng.integers(0, dim, rr.size)
    _, ui = np.unique(rr.astype(np.int64) * dim + cc, return_index=True)
    return MatrixCOO(n_rows=dim, n_cols=dim, row=rr[ui].astype(np.int32),
                     col=cc[ui].astype(np.int32),
                     val=rng.standard_normal(ui.size))


def _dryrun_rank(rank: int, world: int, device: Optional[str]) -> dict:
    from ..config import EhybConfig
    from ..core.coo import deterministic_x, oracle_spmv
    from ..io import generate
    from ..utils.validate import rel_error
    from .hybrid import ShardedDegreeSplitSpmv
    from .routed import ShardedRoutedSpmv
    from .spmv import ShardedEhybSpmv

    dev = rank_device(device, rank)
    errs = {}
    # sharded EHYB on a scrambled stencil (real ER entries)
    m = generate.permuted(generate.poisson2d(48), seed=11)
    model = ShardedEhybSpmv(EhybConfig(window_rows=1024),
                            device=dev).setup(m)
    x = deterministic_x(m.dimension)
    errs["ehyb"] = rel_error(model.matvec(x), oracle_spmv(m, x))
    # the gather-wall engine: one routed instance per rank, x gathered
    mr = _random_matrix(8192, 4, seed=3)
    xr = deterministic_x(mr.dimension)
    cfg = EhybConfig(artifact_cache=False)
    rmodel = ShardedRoutedSpmv(cfg, device=dev).setup(mr)
    errs["routed"] = rel_error(rmodel.matvec(xr), oracle_spmv(mr, xr))
    # column-block mode (the >2M-column regime, forced small)
    bmodel = ShardedRoutedSpmv(cfg, device=dev).setup(mr, block_cols=4096)
    errs["routed_blocks"] = rel_error(bmodel.matvec(xr), oracle_spmv(mr, xr))
    # degree-split hybrid (heavy-tail regime)
    mh = generate.random_general(6144, 24, seed=4, power_law=0.7)
    hmodel = ShardedDegreeSplitSpmv(
        EhybConfig(window_rows=1024, artifact_cache=False),
        device=dev).setup(mh, threshold=32)
    if not (hmodel.e.m.nnz > 0 and hmodel.r.m.nnz > 0):
        raise AssertionError("the split left one engine empty")
    xh = deterministic_x(mh.dimension)
    errs["split"] = rel_error(hmodel.matvec(xh), oracle_spmv(mh, xh))
    return errs


#: Bounds of the dry run, as the JAX package's.
DRYRUN_BOUNDS = {"ehyb": 5e-6, "routed": 5e-6, "routed_blocks": 5e-6,
                 "split": 1e-5}


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout: Optional[float] = 600) -> dict:
    """One sharded product of each engine (sharded EHYB, sharded routed,
    routed column blocks, the sharded split) on ``n_devices`` gloo ranks,
    each checked against the oracle; returns rank 0's errors, raises where
    a rank's error passes its bound.  The ranks run on the card
    (``cuda:{rank % device_count}``) unless ``device`` says otherwise;
    ``device="cpu"`` runs them on the CPU."""
    errs = spawn(_dryrun_rank, n_devices, "gloo", args=(device,),
                 timeout=timeout)
    for r, e in enumerate(errs):
        for k, bound in DRYRUN_BOUNDS.items():
            if not e[k] < bound:
                raise AssertionError(f"dryrun_multichip({n_devices}) rank "
                                     f"{r}: {k} rel_error {e[k]} >= {bound}")
    print(f"dryrun_multichip({n_devices}): OK "
          + " ".join(f"{k}={v:.2e}" for k, v in errs[0].items()))
    return errs[0]
