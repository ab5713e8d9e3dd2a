"""The sharded engines on the card, A/B between checkouts.

    python3 chip_sharded_ab.py TAG [CASE ...]

Cases (default both):

* ``pp1024``: ``ehyb_sharded`` at one rank on ``permuted_poisson_1024``
  (1024-row windows, the TPU's Pallas branch): the kernels one apply
  launches (K1, K9), the graph loop's us a step and GFLOP/s (500 steps,
  timed twice), the kernels a step launches (``torch.profiler`` over 20
  graph replays) and K1 over the shard's boundary list (a CUDA graph of
  100 calls);
* ``pl1m``: ``ehyb_split_sharded`` at one rank on ``powerlaw_1m`` at full
  size (its host setup built here, uncached): the setup's seconds, the
  product against the exact-f64 oracle, the graph loop's GFLOP/s and the
  dense rows' K1 over their boundary list.

Each case prints one line ``AB_RESULT {json}`` with TAG, the card's name
and power limit.  The script uses only what the sharded engines had
before their K1 plans took the split form and the tail, so it runs from
the root of an older checkout too (copy it there; the script's own
directory comes first on ``sys.path``): run parent, change, change,
parent in one call to compare two commits on one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import ehyb_spmv_torch as port
from chip_smoke import device_ms_per_call, rel_np
from ehyb_spmv_torch.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import dia, ehyb_stream
from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv
from ehyb_spmv_torch.parallel.spmv import ShardedEhybSpmv

CFG = {"window_rows": 1024}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def loop_us(model, x, nnz: int, n: int) -> dict:
    """The graph loop (captured first) timed twice: us a step each time and
    GFLOP/s over both."""
    model.iterate(x, n)
    torch.cuda.synchronize()
    us = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.iterate(x, n)
        end.record()
        end.synchronize()
        us.append(1e3 * start.elapsed_time(end) / n)
    return dict(step_us=us, gflops=2e-3 * nnz * len(us) / sum(us))


def step_kernels(model, x, n: int = 20) -> dict:
    """Kernels a step of the graph loop launches (those launched at least
    once a step over ``n`` steps under ``torch.profiler``), with their
    device us a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.iterate(x, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.iterate(x, n)
        torch.cuda.synchronize()
    return {e.key[:80]: [e.count / n, e.device_time_total / n]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count >= n}


def apply_launches(model, x) -> dict:
    """K1's and K9's launches in one apply."""
    ehyb_stream.stream_body.launches = dia.dia_body.launches = 0
    model.apply(x)
    torch.cuda.synchronize()
    return dict(k1=ehyb_stream.stream_body.launches,
                k9=dia.dia_body.launches)


def k1_boundary_ms(sharded, n: int) -> float:
    """Device ms a call of K1 over the shard's boundary list, as its apply
    runs it (a CUDA graph of ``n`` calls)."""
    mod = sharded.module
    y = torch.empty(mod.cells.plan.n_rb * 32, dtype=mod.ex.x_buf.dtype,
                    device=mod.ex.x_buf.device)
    return device_ms_per_call(lambda: ehyb_stream.stream_body(
        mod.cells.plan, mod.ex.x_buf, mod.kahan, rb_list=mod.cells.boundary,
        out=y), n)


def case_pp1024(dev) -> dict:
    m = generate.load_corpus("permuted_poisson_1024")
    t0 = time.perf_counter()
    model = ShardedEhybSpmv(port.EhybConfig(**CFG), device=dev).setup(m)
    setup_s = time.perf_counter() - t0
    x = model.prepare_x(deterministic_x(m.dimension))
    out = dict(setup_s=setup_s, launches=apply_launches(model, x))
    out.update(loop_us(model, x, m.nnz, 500))
    out["kernels_a_step"] = step_kernels(model, x)
    out["k1_ms"] = k1_boundary_ms(model, 100)
    return out


def case_pl1m(dev) -> dict:
    m = generate.load_corpus("powerlaw_1m")
    xh = deterministic_x(m.dimension)
    t0 = time.perf_counter()
    model = ShardedDegreeSplitSpmv(port.EhybConfig(**CFG),
                                   device=dev).setup(m)
    setup_s = time.perf_counter() - t0
    x = model.prepare_x(xh)
    out = dict(setup_s=setup_s, nnz=m.nnz,
               dense_nnz=model.e.m.nnz,
               rel_error=rel_np(model.matvec(xh), oracle_spmv(m, xh)),
               launches=apply_launches(model, x))
    # about a second of steps, whichever form K1's plan takes
    t0 = time.perf_counter()
    model.iterate(x, 2)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    out.update(loop_us(model, x, m.nnz, int(min(500, max(20, 1 / step_s)))))
    k1_one = k1_boundary_ms(model.e, 1)
    out["k1_ms"] = k1_boundary_ms(model.e, int(min(100, max(5, 50 / k1_one))))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("error: chip_sharded_ab.py needs a CUDA device", file=sys.stderr)
        return 1
    tag, cases = argv[0], argv[1:] or ["pp1024", "pl1m"]
    dev = torch.device("cuda", 0)
    name = card()
    for case in cases:
        t0 = time.perf_counter()
        res = {"pp1024": case_pp1024, "pl1m": case_pl1m}[case](dev)
        print("AB_RESULT " + json.dumps(dict(
            tag=tag, case=case, card=name,
            wall_s=time.perf_counter() - t0, **res)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
