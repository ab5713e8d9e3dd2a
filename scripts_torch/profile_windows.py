#!/usr/bin/env python3
"""How often ``torch.profiler`` loses kernel records of CUDA-graph replays,
with and without a wait at the edges of its window.

    python3 scripts_torch/profile_windows.py [--matrix permuted_poisson_1024]
                                             [--windows 200] [--steps 20]
                                             [--pad 0.01]

Sets up ``ehyb_sharded`` at world 1 (no process group) and the flagship
``ehyb`` on the matrix, then profiles ``--windows`` windows of ``--steps``
chained steps of each model's graph loop, as ``chip_smoke.py``'s
``profile_path`` does: in turns, a window that starts the loop as soon as
the profiler starts and stops the profiler as soon as the loop ends, and
one that waits ``--pad`` seconds at both edges.  A step of either model
launches K1, K9 and the chain add once, so a window is short where a
kernel's record count is not ``--steps`` (or no kernel shows).  Prints
each short window's counts and, as its last line, one JSON object: by
model and wait, the windows, the short ones and their indices.  Needs a
card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import ehyb_spmv_torch as port  # noqa: E402
from ehyb_spmv_torch.core.coo import deterministic_x  # noqa: E402
from ehyb_spmv_torch.io import generate  # noqa: E402
from ehyb_spmv_torch.parallel.spmv import (ShardedEhybSpmv,  # noqa: E402
                                           plan_sharded)


def window(model, x_dev, steps: int, pad: float) -> dict:
    """Kernel name → records in one profiler window of ``steps`` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.iterate(x_dev, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        model.iterate(x_dev, steps)
        torch.cuda.synchronize()
        time.sleep(pad)
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "Memcpy" not in e.key}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default="permuted_poisson_1024")
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pad", type=float, default=0.01)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    m = generate.load_corpus(args.matrix)
    cfg = port.EhybConfig(window_rows=1024)
    models = {"ehyb_sharded D=1": ShardedEhybSpmv(cfg, device=dev).setup(
                  m, plan_sharded(m, cfg, 1)),
              "ehyb": port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)}
    x = deterministic_x(m.dimension)
    out = {}
    for name, model in models.items():
        x_dev = model.prepare_x(x)
        res = {pad: dict(windows=0, short=[]) for pad in (0.0, args.pad)}
        t0 = time.perf_counter()
        for i in range(args.windows):
            for pad, r in res.items():
                counts = window(model, x_dev, args.steps, pad)
                r["windows"] += 1
                if len(counts) != 3 or any(c != args.steps
                                           for c in counts.values()):
                    r["short"].append(i)
                    print(f"{name}, wait {pad} s, window {i}: "
                          + ("; ".join(f"{c} {k[:50]}"
                                       for k, c in counts.items())
                             or "no kernel record"), flush=True)
        out[name] = {f"wait {pad} s": dict(r, n_short=len(r["short"]))
                     for pad, r in res.items()}
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(matrix=args.matrix, steps=args.steps,
                          device=torch.cuda.get_device_name(0),
                          results=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
