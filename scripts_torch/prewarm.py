#!/usr/bin/env python3
"""Build every artifact and oracle the port's sweep touches, on the CPU, in
the port's cache namespace (``EHYB_TORCH_CACHE_DIR``, default
``~/.cache/ehyb_torch``), so that a run on the card pays only for its
measurement.

    python3 scripts_torch/prewarm.py [--models ehyb,...] [--dtype float64]
                                     [--dword] [--window-rows N]
                                     [matrix ...]

The port's counterpart of ``scripts/prewarm.py``.  The host layer (ordering,
EHYB conversion, routed schedules, the gate's structural verdict) does not
depend on the device, and the cache keys hash only the matrix and the
config, so artifacts built here are the ones a card run looks up.  The
models run with ``device="cpu"``; the small gate (below 65,536 rows) times
its candidates only on a card (``EhybSpmv._can_measure``), so no verdict
that is a hardware measurement is written here.  ``ehyb_split_sharded``
(asked for by name) is the sharded degree split at one rank: its host
setup (``parallel/spmv.py::cached_plan_sharded``, the rank's K1 plan and
its routed schedules and plans) is cached the same way.

Prints one line per matrix (corpus load and oracle, HIT or MISS) and one per
(matrix, model): setup seconds, HIT or MISS, and the engine.  A MISS on a
second run means a fingerprint drifted.  Exits 1 where a setup failed.
"""
from __future__ import annotations

import argparse
import io
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: The cache loads' log lines (a routed HIT must not hide an EHYB miss: the
#: flagship can delegate and load only routed artifacts).
_HIT_LINES = ("loaded cached EHYB artifacts", "loaded cached routed artifacts",
              "loaded cached sharded setup")
#: The sweep's models that build artifacts (the baselines build none).
MODELS = ("ehyb", "ehyb_routed", "ehyb_split")
#: The sharded models built at one rank, where their names are asked for.
SHARDED = ("ehyb_split_sharded",)


def main(argv=None) -> int:
    from bench_torch import cached_oracle
    from scripts_torch.sweep import DEFAULT, row_models

    import ehyb_spmv_torch as port
    from ehyb_spmv_torch.core.coo import deterministic_x
    from ehyb_spmv_torch.io import generate
    from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv

    classes = {**port.MODELS, "ehyb_split_sharded": ShardedDegreeSplitSpmv}

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrices", nargs="*", default=DEFAULT,
                   help="corpus entries (default: the sweep's 12)")
    p.add_argument("--models", default=",".join(MODELS),
                   help=f"comma-separated models (default {','.join(MODELS)})")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="the config's value type, as the CLI's --dtype "
                        "(default float32, the sweep's)")
    p.add_argument("--dword", action="store_true",
                   help="the precision mode, as the CLI's --dword")
    p.add_argument("--window-rows", type=int, default=None,
                   help="the config's window_rows (default the config's; "
                        "the sharded path's Pallas branch takes 1024)")
    args = p.parse_args(argv)
    extra = ({} if args.window_rows is None
             else {"window_rows": args.window_rows})
    columns = args.models.split(",")
    # HIT is read from the cache loads' INFO lines
    logging.getLogger("ehyb_torch").setLevel(logging.INFO)
    fails = 0
    for mat in args.matrices:
        t0 = time.perf_counter()
        m = generate.load_corpus(mat)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, hit = cached_oracle(m, deterministic_x(m.dimension))
        print(f"{mat}: corpus {t_load:.1f} s, oracle "
              f"{time.perf_counter() - t0:.1f} s {'HIT' if hit else 'MISS'}",
              flush=True)
        for name in row_models(mat, columns) + [
                c for c in columns if c in SHARDED]:
            if name not in MODELS + SHARDED:
                continue
            buf = io.StringIO()
            handler = logging.StreamHandler(buf)
            logging.getLogger("ehyb_torch").addHandler(handler)
            t0 = time.perf_counter()
            try:
                model = classes[name](
                    port.EhybConfig(artifact_cache=True, dtype=args.dtype,
                                    dword_values=args.dword, **extra),
                    device="cpu").setup(m)
                hit = any(s in buf.getvalue() for s in _HIT_LINES)
                status = f"{'HIT' if hit else 'MISS'} [{type(model).__name__}]"
                del model
            except Exception as exc:  # report, keep going
                status = f"ERROR {exc!r:.200}"
                fails += 1
            finally:
                logging.getLogger("ehyb_torch").removeHandler(handler)
            print(f"{mat} {name}: {time.perf_counter() - t0:.1f} s {status}",
                  flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
