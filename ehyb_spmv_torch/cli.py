"""Command-line entry point — the analog of the reference's ``main``
(``solver_test.c:267-408``).

Port counterpart of ``ehyb_spmv_gpu_tpu/cli.py``, with every flag of it but
``--platform`` (the device is ``--device``)::

    python -m ehyb_spmv_torch -g permuted_poisson_512 -i 2000 --json
    python -m ehyb_spmv_torch -g permuted_poisson_512 --dword
    python -m ehyb_spmv_torch -m audikw_1 --read-dir ./read

Run flow: read/generate → setup (plan/partition/reorder/convert/upload) →
validate against the exact-f64 host oracle → warm-up → timed iterations
(CUDA-graph replays on a card, captured during the warm-up) → report
GFLOP/s.  The device is ``cuda`` unless ``--device cpu`` is given;
without a CUDA device the CLI exits non-zero rather than run elsewhere.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from . import MODELS

    p = argparse.ArgumentParser(
        prog="ehyb_spmv_torch",
        description="EHYB SpMV on PyTorch + CUDA")
    src = p.add_mutually_exclusive_group()
    src.add_argument("-m", "--matrix", metavar="NAME",
                     help="matrix name: reads <read-dir>/<NAME>.mtx "
                          "(reference -m flag, solver_test.c:284)")
    src.add_argument("-g", "--generate", metavar="CORPUS",
                     help="generate a synthetic matrix from the named corpus "
                          "entry (see io/generate.py CORPUS)")
    p.add_argument("--read-dir", default="./read",
                   help="directory with .mtx files (default ./read)")
    p.add_argument("-i", "--iters", type=int, default=2000,
                   help="timed SpMV iterations (reference -i, default 2000)")
    p.add_argument("--warmup", type=int, default=10,
                   help="warm-up iterations (reference hardcodes 10, "
                        "spmv.cu:100)")
    p.add_argument("--model", default="ehyb", choices=sorted(MODELS),
                   help="SpMV model: ehyb (flagship, CUDA kernel body; "
                        "hands gather-wall matrices to the routed engine) | "
                        "ehyb_xla (plain torch ops) | hyb (one window, no "
                        "reordering) | csr (COO gather + index_add_) | bcoo "
                        "(torch.sparse_csr_tensor: cuSPARSE on a card) | "
                        "ehyb_routed (routed engine) | ehyb_split "
                        "(degree-split hybrid)")
    p.add_argument("--window", type=int, default=None,
                   help="x-window rows (multiple of 1024); default "
                        "planner-chosen")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--partitioner", default="auto",
                   choices=["auto", "native", "blocks"])
    p.add_argument("--no-reorder", action="store_true",
                   help="disable partition+reorder (RODR=off)")
    p.add_argument("--no-sort", action="store_true",
                   help="disable in-partition density sort")
    p.add_argument("--no-dia", action="store_true",
                   help="disable the gather-free DIA diagonal body")
    p.add_argument("--layout", default=None,
                   choices=["sell", "sell_cs", "sell_mw", "sell_rx"],
                   help="force a SELL body layout (default: model-chosen, "
                        "with relax_body auto-switching mw→rx)")
    p.add_argument("--no-relax", action="store_true",
                   help="disable the relaxed-layout (sell_rx) auto-switch")
    p.add_argument("--windows-per-subtile", type=int, default=None,
                   choices=[2, 4],
                   help="relaxed-layout windows per 8-step sub-tile (2 dual, "
                        "4 quad; default: auto-arbitrated)")
    p.add_argument("--dword", action="store_true",
                   help="precision mode: f64 values, x, y and sums (the "
                        "body and DIA kernels in f64 on the card); taken by "
                        "ehyb, ehyb_xla and hyb, refused with exit code 2 "
                        "by the other models")
    p.add_argument("--compensated", action="store_true",
                   help="compensated (Kahan) summation in the body kernels")
    p.add_argument("--tol", type=float, default=0.01,
                   help="validation relative tolerance (reference: 1%%)")
    p.add_argument("--cache", action="store_true",
                   help="cache converted EHYB artifacts to disk")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on (default cuda)")
    p.add_argument("--json", action="store_true",
                   help="emit a single JSON result line")
    p.add_argument("--profile", action="store_true",
                   help="print the per-phase roofline audit and phase "
                        "times; with --trace-dir also write a "
                        "torch.profiler trace")
    p.add_argument("--trace-dir", default=None,
                   help="directory for the torch.profiler trace (Chrome "
                        "trace JSON)")
    p.add_argument("--list-corpus", action="store_true",
                   help="list generator corpus names and exit")
    return p


def config_from_args(args: argparse.Namespace):
    """The EhybConfig the flags ask for (the JAX CLI's mapping,
    ``ehyb_spmv_gpu_tpu/cli.py:135-154``)."""
    from .config import EhybConfig, Features

    cfg = EhybConfig(
        dtype=args.dtype,
        window_rows=args.window,
        partitioner=args.partitioner,
        artifact_cache=args.cache,
        relax_body="never" if args.no_relax else "auto",
        compensated_sum=bool(args.compensated),
        dword_values=bool(args.dword),
        features=Features(reorder=not args.no_reorder,
                          sort_rows=not args.no_sort,
                          dia=not args.no_dia),
    )
    if args.layout:
        cfg = dataclasses.replace(cfg, body_layout=args.layout)
    if args.windows_per_subtile:
        cfg = dataclasses.replace(
            cfg, windows_per_subtile=args.windows_per_subtile)
    return cfg


def run(args: argparse.Namespace):
    """Drive one matrix end to end.  Returns (exit code, result dict,
    model); the dict is None when the run could not start."""
    import torch

    from . import MODELS
    from .core.coo import deterministic_x, oracle_spmv
    from .io import generate, read_mtx
    from .utils.timing import bench_apply
    from .utils.validate import compare, rel_error

    if args.list_corpus:
        for name in generate.CORPUS:
            print(name)
        return 0, None, None
    if not (args.matrix or args.generate):
        print("error: one of -m/--matrix or -g/--generate is required",
              file=sys.stderr)
        return 2, None, None
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but CUDA is not available "
              "(use --device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return 2, None, None
    device = torch.device(args.device)
    try:
        cfg = config_from_args(args)
        model = MODELS[args.model](cfg, device=device)
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2, None, None

    # --- load or generate the matrix (role of matrixRead_*, solver_test.c) ---
    t0 = time.perf_counter()
    if args.matrix:
        if os.path.isfile(args.matrix):      # explicit path accepted too
            path = args.matrix
        else:
            path = os.path.join(args.read_dir, f"{args.matrix}.mtx")
            if not os.path.exists(path) and os.path.exists(path + ".gz"):
                path += ".gz"
        if not os.path.exists(path):
            print(f"error: {path} not found", file=sys.stderr)
            return 2, None, None
        m = read_mtx(path)
        name = args.matrix
    else:
        if args.generate not in generate.CORPUS:
            print(f"error: unknown corpus entry {args.generate!r} "
                  "(use --list-corpus)", file=sys.stderr)
            return 2, None, None
        m = generate.load_corpus(args.generate)
        name = args.generate
    load_s = time.perf_counter() - t0
    print(f"matrix {name}: {m.n_rows}x{m.n_cols}, nnz={m.nnz}, "
          f"maxCol={m.max_col()}")

    model = model.setup(m)

    # --- validate vs exact-f64 oracle (solver_test.c:389) ---
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    got = model.matvec(x)
    err = rel_error(got, want)
    cmp_res = compare(got, want, tol=args.tol,
                      atol=1e-6 * float(np.max(np.abs(want), initial=0.0)))
    print(f"validation: rel_error={err:.3e}, "
          f"{cmp_res.n_violations}/{cmp_res.n} violations at "
          f"{100 * args.tol:.1f}% tol → {'PASS' if cmp_res.ok else 'FAIL'}")

    # --- timed loop (spmv.cu:100-122 protocol) ---
    x_dev = model.prepare_x(x)
    e = getattr(model, "ehyb", None)
    res = bench_apply(f"{args.model}:{name}",
                      lambda n: model.iterate(x_dev, n), nnz=m.nnz,
                      device=device, iters=args.iters, warmup=args.warmup,
                      bytes_model=model.bytes_model())
    print(res)
    if args.profile:
        from .utils.profiling import phase_breakdown, roofline_report, trace

        print(roofline_report(model, res))
        where = "device" if device.type == "cuda" else "cpu host"
        print(f"phase breakdown ({where} us per call): " + ", ".join(
            f"{k} {1e6 * v:.2f}" for k, v in
            phase_breakdown(model, x_dev, iters=20).items()))
        if args.trace_dir:
            with trace(args.trace_dir):
                model.iterate(x_dev, 20)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    result = {
        "matrix": name, "model": args.model, "engine": type(model).__name__,
        "device": res.device, "nnz": m.nnz, "dim": m.dimension,
        "iters": res.iters, "seconds": res.seconds, "gflops": res.gflops,
        "gnnz_per_sec": res.nnz_per_sec / 1e9,
        "roofline_frac": res.roofline_frac, "bytes_model": res.bytes_model,
        "rel_error": err, "valid": cmp_res.ok,
        "setup_seconds": {"load": load_s, **model.setup_seconds},
    }
    if getattr(model, "small_gate", None) is not None:
        # the small-matrix gate's estimate and, where it ran, its A/B
        result["small_gate"] = model.small_gate
    if e is not None:
        result["layout"] = {
            "body_layout": model.config.body_layout, "nwin": model.dev.nwin,
            **{k: int(e.stats.get(k, 0)) for k in (
                "ell_steps", "nnz_ell", "waste_ell", "nnz_dia", "nnz_er",
                "nnz_long")}}
    # the routed engine's schedule split (bench.py reports the same keys)
    blocks = (getattr(model, "blocks", None)
              or getattr(getattr(model, "r", None), "blocks", None))
    if blocks:
        result["nnz_routed"] = int(sum(b.stats.get("nnz_routed", 0)
                                       for b in blocks))
        result["nnz_spill"] = int(sum(b.stats.get("nnz_spill", 0)
                                      for b in blocks))
    return (0 if cmp_res.ok else 1), result, model


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    code, result, _ = run(args)
    if result is not None and args.json:
        print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())
