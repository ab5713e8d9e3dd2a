"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``ehyb_spmv_torch/csrc/``, checks it
against its plain PyTorch version on small matrices that land on each
layout it serves, then drives the flagship path end to end through the CLI
on ``permuted_poisson_512`` (262,144 rows, ~1.3M nnz) and checks the result
against the exact-f64 oracle.  It then shows that the run went through the
kernel (its launch count), and times the kernel and its plain version at the
main path's shapes.

Imports only the port (never JAX or the JAX package).  Exits non-zero when
any phase fails or no CUDA device is present.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import ehyb_stream

#: Kernel vs plain version, f32 both: only the summation order differs.
KERNEL_TOL = 1e-6
#: End to end vs the exact-f64 oracle: the suite's bound.
ORACLE_TOL = 5e-6
MAIN_ARGS = ["-g", "permuted_poisson_512", "-i", "500", "--json",
             "--device", "cuda"]
KERNEL = {
    "name": "ehyb_stream_body",
    "route": "cuda",
    "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
    "replaces": "ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py:148",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(
        1e-300))


def ms_per_call(fn, n: int) -> float:
    """Eager calls back to back, timed with CUDA events: host launch cost
    included (at small shapes it is most of the time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms_per_call(fn, n: int) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so no host launch cost is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def cancellation_matrix() -> port.MatrixCOO:
    """Row 0 sums 100 ones among ±1e8 blocks: exact in f64, lossy in naive
    f32 summation."""
    dim, n = 1024, 612
    vals = np.concatenate([np.ones(100), np.full(256, 1e8),
                           np.full(256, -1e8)])
    return port.MatrixCOO(
        dim, dim, np.concatenate([np.zeros(n, np.int64), np.arange(1, dim)]),
        np.concatenate([np.arange(n), np.arange(1, dim)]),
        np.concatenate([vals, np.ones(dim - 1)]))


def kernel_cases():
    """(name, matrix, config, nwin, kahan) landing on every layout K1 takes."""
    scrambled = generate.permuted(generate.poisson2d(96), seed=3)
    scattered = generate.random_general(8192, 24, seed=3)
    cfg = port.EhybConfig
    return [
        ("nwin1", scrambled, cfg(relax_body="never"), 1, False),
        ("nwin2", scrambled, cfg(body_layout="sell_rx", relax_body="never"),
         2, False),
        ("nwin4", scattered, cfg(body_layout="sell_rx", relax_body="never",
                                 windows_per_subtile=4), 4, False),
        ("nwin2_kahan", cancellation_matrix(),
         cfg(body_layout="sell_rx", relax_body="never",
             compensated_sum=True), 2, True),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    print("== phase 1: card", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(dev)}, "
          f"count {torch.cuda.device_count()}", flush=True)

    print("== phase 2: build", flush=True)
    built = ehyb_stream.build_kernel()
    print(f"  built {built.path} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    print("== phase 3: kernel vs plain version on small matrices", flush=True)
    for name, m, cfg, nwin, kahan in kernel_cases():
        model = port.EhybSpmv(cfg, device=dev).setup(m)
        e = model.dev
        check(e.nwin == nwin and e.body_nnz > 0 and model.module.kahan == kahan,
              f"{name}: layout nwin={e.nwin}, body nnz {e.body_nnz}")
        x = deterministic_x(m.dimension) if not kahan else np.ones(m.dimension)
        x_dev = model.prepare_x(x)
        y_k = ehyb_stream.stream_body(e, x_dev, kahan)
        y_p = ehyb_stream.stream_body_plain(e, x_dev, kahan)
        torch.cuda.synchronize()
        err = rel(y_k, y_p)
        check(torch.isfinite(y_k).all().item() and err <= KERNEL_TOL,
              f"{name}: kernel vs plain rel {err:.3e} <= {KERNEL_TOL}")
        y = model.matvec(x)
        err = float(np.linalg.norm(y - oracle_spmv(m, x))
                    / np.linalg.norm(oracle_spmv(m, x)))
        check(err <= ORACLE_TOL,
              f"{name}: model vs oracle rel {err:.3e} <= {ORACLE_TOL}")
        if kahan:
            check(y[0] == 100.0, f"{name}: compensated row 0 = {y[0]!r}")

    print("== phase 4: main path "
          f"(python -m ehyb_spmv_torch {' '.join(MAIN_ARGS)})", flush=True)
    ehyb_stream.stream_body.launches = 0
    t0 = time.perf_counter()
    code, result, model = cli.run(cli.build_parser().parse_args(MAIN_ARGS))
    wall = time.perf_counter() - t0
    launches = ehyb_stream.stream_body.launches
    print(json.dumps(result))
    check(code == 0 and result is not None, f"CLI exit code {code}")
    print(f"  wall {wall:.1f} s; setup seconds per phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      result["setup_seconds"].items()))
    print(f"  layout: {result['layout']}")
    check(result["dim"] == 262144 and result["nnz"] > 1_000_000,
          f"full size: dim {result['dim']}, nnz {result['nnz']}")
    check(result["rel_error"] <= ORACLE_TOL,
          f"rel error vs exact-f64 oracle {result['rel_error']:.3e} "
          f"<= {ORACLE_TOL}")
    y = model.apply(model.prepare_x(deterministic_x(result["dim"])))
    check(y.shape[0] >= result["dim"] and bool(torch.isfinite(y).all()),
          f"finite padded y of {y.shape[0]} rows")

    print("== phase 5: the main path went through the kernel", flush=True)
    check(launches > 0, f"{KERNEL['name']} launched {launches} times "
                        "during the main path")

    print("== phase 6: kernel and plain version at the main path's shapes",
          flush=True)
    e = model.dev
    kahan = model.module.kahan
    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    y_k = ehyb_stream.stream_body(e, x_dev, kahan)
    y_p = ehyb_stream.stream_body_plain(e, x_dev, kahan)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL, f"kernel vs plain rel {err:.3e} <= {KERNEL_TOL}"
                             f" (max abs {max_abs:.3e})")
    kernel = lambda: ehyb_stream.stream_body(e, x_dev, kahan)  # noqa: E731
    plain = lambda: ehyb_stream.stream_body_plain(e, x_dev, kahan)  # noqa
    # device time, in turns (plain, kernel, kernel, plain), one card
    plain_a = device_ms_per_call(plain, 20)
    kern_a = device_ms_per_call(kernel, 100)
    kern_b = device_ms_per_call(kernel, 100)
    plain_b = device_ms_per_call(plain, 20)
    print(f"  device time per call: {KERNEL['name']} {kern_a:.4f} / "
          f"{kern_b:.4f} ms, plain version {plain_a:.4f} / {plain_b:.4f} ms")
    print(f"  eager calls back to back (host launch cost included): "
          f"{KERNEL['name']} {ms_per_call(kernel, 200):.4f} ms, plain "
          f"version {ms_per_call(plain, 50):.4f} ms, full apply (kernel + "
          f"torch ER/long/DIA/combine) "
          f"{ms_per_call(lambda: model.apply(x_dev), 200):.4f} ms")
    print(f"  main path: {result['gflops']:.2f} GFLOP/s "
          f"({result['iters']} iterations in {result['seconds']:.4f} s)")

    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max_abs,
        ms=(kern_a + kern_b) / 2, plain_ms=(plain_a + plain_b) / 2)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
