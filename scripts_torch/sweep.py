#!/usr/bin/env python3
"""Corpus sweep of the PyTorch port on one NVIDIA GPU: the flagship and the
baselines on each matrix of the corpus, written to ``BENCH_SWEEP_H100.md``.

    python3 scripts_torch/sweep.py [--models ehyb,csr,...] [--out FILE]
                                   [--device cuda|cpu] [matrix ...]

The port's counterpart of ``scripts/sweep.py`` (whose table,
``BENCH_SWEEP.md``, stays the TPU's): the same 12 matrices and columns.
Each (model, matrix) runs in its own process through
``bench_torch.run_child`` at ``EHYB_BENCH_ITERS`` iterations (300) for every
model: the TPU sweep cut the baselines to 12 because its XLA baselines ran
100-10,000x slower than the body, which cuSPARSE on the card does not.
Every result is printed as a ``BENCH_RESULT {json}`` line (so
``scripts_torch/sweep_table.py`` can rebuild the table from this script's
standard output), and the table is rewritten after each row, so a sweep cut
short still leaves the rows it measured.  Without a card, and without
``--device cpu``, it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from scripts_torch.sweep_table import TAG, render  # noqa: E402

DEFAULT = ["poisson2d_512", "stencil27_24", "fem3d_32",
           "fem3d_68_audikw_class", "random_16k", "powerlaw_16k",
           "permuted_poisson_512", "permuted_poisson_1024",
           "permuted_poisson_4096", "random_1m", "random_4m",
           "powerlaw_1m"]
MODELS = ["ehyb", "csr", "bcoo"]
#: Entries with no recoverable structure also run the routed engine alone
#: (``models/routed.py``) in a column of its own; random_4m takes its
#: column-block mode (4 blocks of 1M columns).
ROUTED = {"random_16k", "powerlaw_16k", "random_1m", "random_4m",
          "powerlaw_1m"}
#: Heavy-tailed entries also run the degree-split hybrid
#: (``models/hybrid.py``).
SPLIT = {"powerlaw_16k", "powerlaw_1m"}
COLUMNS = MODELS + ["ehyb_routed", "ehyb_split"]


def row_models(matrix: str, columns) -> list:
    """The models a row runs: the chosen columns that apply to it."""
    applies = MODELS + (["ehyb_routed"] if matrix in ROUTED else []) \
        + (["ehyb_split"] if matrix in SPLIT else [])
    return [c for c in applies if c in columns]


def sweep(matrices, columns, out: str, device: str = "cuda",
          iters: int = None) -> list:
    """Run the sweep and write the table to ``out`` after each row; returns
    the rows, [(matrix, {model: result})]."""
    iters = iters or int(os.environ.get("EHYB_BENCH_ITERS", "300"))
    rows = []
    for mat in matrices:
        results = {}
        for model in row_models(mat, columns):
            r = bench_torch.run_child(model, mat, iters, device, timeout=2400)
            results[model] = r
            print(TAG + json.dumps(r), flush=True)
            print(f"{mat} {model}: " + (
                f"FAIL ({r['error']})" if "error" in r else
                f"{r['gflops']:.2f} GFLOP/s, engine {r['engine']}, "
                f"launches {r['launches']}, rel {r['rel_error']:.2e}, "
                f"wall {r['wall_seconds']:.1f} s"), flush=True)
        rows.append((mat, results))
        with open(out, "w") as f:
            f.write(render(rows, "scripts_torch/sweep.py"))
        print(f"wrote {out}", flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrices", nargs="*", default=DEFAULT,
                   help="corpus entries (default: the 12 of the sweep)")
    p.add_argument("--models", default=",".join(COLUMNS),
                   help="comma-separated columns (default: "
                        f"{','.join(COLUMNS)})")
    p.add_argument("--out", default=os.path.join(REPO, "BENCH_SWEEP_H100.md"),
                   help="the table (default BENCH_SWEEP_H100.md)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    columns = args.models.split(",")
    unknown = set(columns) - set(COLUMNS)
    if unknown:
        p.error(f"unknown models {sorted(unknown)}; choose from {COLUMNS}")
    if args.device == "cuda":
        ok, reason = bench_torch.backend_alive()
        if not ok:
            print(f"error: no CUDA device ({reason}); use --device cpu to "
                  "run the plain versions on the CPU", file=sys.stderr)
            return 1
    rows = sweep(args.matrices, columns, args.out, args.device)
    return 0 if all("error" not in r for _, rs in rows
                    for r in rs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
