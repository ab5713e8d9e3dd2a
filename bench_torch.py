#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one NVIDIA GPU.

    python3 bench_torch.py                  # on the card
    python3 bench_torch.py --device cpu     # the plain versions, on the CPU

The port's counterpart of ``bench.py``, with the same protocol: the
reference's canonical run (``./spmv.out -i 2000 -m audikw_1``,
``README.md:8-13``; timing loop ``spmv.cu:100-122``): 10 warm-up iterations,
then one timed region of chained products through ``model.iterate`` (CUDA
graph replays on a card, captured in the warm-up; a capture inside the timed
region raises), GFLOP/s = 2·nnz·iter/time, timed with CUDA events.  Imports
only ``torch`` and the port.

Each model runs in its OWN SUBPROCESS (``--run MODEL MATRIX ITERS``): a
kernel fault in one model must not poison the others, since a CUDA error is
sticky for the process.  The parent first checks, in a subprocess with a
timeout, that ``torch.cuda.is_available()``; without a card, and without
``--device cpu``, it prints the zero line with an ``"error"`` and exits 1.

Rows, in ``bench.py``'s order:

* the flagship ``ehyb`` on ``permuted_poisson_512`` (``EHYB_BENCH_MATRIX``),
  which runs the full EHYB format: the SELL body (K1), DIA (K9) and the ER
  tail.  There is no fallback: a flagship that fails prints value 0.0 with
  its ``"error"`` and exits 1, so no plain torch number ever stands under the
  headline;
* the baseline ``bcoo`` (``torch.sparse_csr_tensor``: cuSPARSE on a card),
  else ``csr``, at the same iterations: ``vs_baseline`` is the flagship over
  it;
* the secondary ``ehyb@fem3d_32`` (``EHYB_BENCH_SECONDARY``, empty for none),
  all DIA;
* the gather-wall row ``ehyb@random_1m`` (``EHYB_BENCH_GATHER`` and
  ``EHYB_BENCH_GATHER_MODEL``), which the gate hands to the routed engine,
  at ``min(iters, 100)`` iterations.

``EHYB_BENCH_ITERS`` sets the iterations (500), ``EHYB_BENCH_DELEGATE=never``
pins the EHYB body where the gate would delegate, and ``EHYB_BENCH_DWORD=1``
runs the precision mode (f64 values, x, y and sums, ``ops/dword.py``) in the
models that take it (``DWORD_MODELS``); the baselines refuse it, so they run
in f32 and their line says ``"dword": false``.  Each child holds its answer
to the exact-f64 oracle at rel 5e-6 in f32 and 1e-12 in the precision mode;
the oracle is cached by matrix fingerprint in the port's cache namespace
(``EHYB_TORCH_CACHE_DIR``, default ``~/.cache/ehyb_torch``), as the artifacts
are (``EhybConfig(artifact_cache=True)``).

Each child prints one ``BENCH_RESULT {json}`` line: ``bench.py``'s keys
(``noisy`` aside: CUDA events need no noise floor), the phase split, the
engine the gate picked, the routed engine's ``nnz_routed``/``nnz_spill``,
``launches`` (the four kernel wrappers' counts over the child: ``K1``,
``K9``, ``RX`` the routed kernel, ``WC`` the window cache; 0 on the CPU,
where the plain versions run) and ``card`` (the card's name and power limit
from ``nvidia-smi``).  The parent prints one JSON tail on stdout::

    {"metric": "spmv_gflops_<matrix>_cuda", "value": N, "unit": "GFLOP/s",
     "vs_baseline": N, "baseline_model": "bcoo", "gather_wall": {...},
     "card": "<name>, <power limit>"}

Everything else goes to stderr.  :func:`run_child` and :func:`headline` are
the same run as a callable API.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

RESULT_TAG = "BENCH_RESULT "
#: The oracle bound in f32 (the JAX suite's, ``__graft_entry__.py:80``) and
#: in the precision mode (the JAX double-word mode's, ``tests/test_dword.py``).
F32_TOL = 5e-6
DWORD_TOL = 1e-12
#: ``launches`` keys, in the order of ``utils/graphs.py::launch_counters``.
LAUNCH_KEYS = ("K1", "RX", "K9", "WC")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cached_oracle(m, x):
    """(exact-f64 oracle y, whether the cache held it), the oracle cached by
    matrix fingerprint in the port's cache namespace.

    The oracle on a 33.5M-entry matrix costs seconds of host time that every
    child of a sweep would pay again; x is the deterministic vector of the
    protocol, so it needs no key of its own."""
    import numpy as np

    from ehyb_spmv_torch.core import cache, coo

    path = os.path.join(cache.DEFAULT_CACHE_DIR,
                        f"{cache.matrix_fingerprint(m)}-oracle.npy")
    if os.path.exists(path):
        y = np.load(path)
        if y.shape[0] == m.n_rows:
            log(f"oracle cache hit: {path}")
            return y, True
    y = coo.oracle_spmv(m, x)
    try:
        os.makedirs(cache.DEFAULT_CACHE_DIR, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.npy"
        np.save(tmp, y)
        os.replace(tmp, path)
    except OSError as exc:
        log(f"oracle cache write failed: {exc}")
    return y, False


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def run_model(model_name: str, matrix_name: str, iters: int,
              device: str = "cuda") -> dict:
    """Child mode: benchmark one model on one corpus matrix in this process
    and return its result (raises where it cannot run or misses its
    bound)."""
    import torch

    import ehyb_spmv_torch as port
    from ehyb_spmv_torch.core.coo import deterministic_x
    from ehyb_spmv_torch.io import generate
    from ehyb_spmv_torch.ops.dword import DWORD_MODELS
    from ehyb_spmv_torch.utils.graphs import launch_counters
    from ehyb_spmv_torch.utils.timing import bench_apply
    from ehyb_spmv_torch.utils.validate import rel_error

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    device = torch.device(device)
    log(f"[{model_name}] backend={device.type} matrix={matrix_name}")
    t0 = time.perf_counter()
    m = generate.load_corpus(matrix_name)
    t1 = time.perf_counter()
    x = deterministic_x(m.dimension)
    want, oracle_hit = cached_oracle(m, x)
    t2 = time.perf_counter()

    # the baselines refuse the precision mode (the JAX bcoo ignores it and
    # runs in f32): they get f32, and their line says so
    dword = (os.environ.get("EHYB_BENCH_DWORD", "") not in ("", "0")
             and model_name in DWORD_MODELS)
    delegate = os.environ.get("EHYB_BENCH_DELEGATE", "auto")
    cfg = port.EhybConfig(artifact_cache=True, dword_values=dword,
                          routed_delegate=delegate)
    model = port.MODELS[model_name](cfg, device=device).setup(m)
    err = rel_error(model.matvec(x), want)
    tol = DWORD_TOL if dword else F32_TOL
    log(f"[{model_name}] rel_error={err:.3e}{' (dword)' if dword else ''}")
    if err > tol:
        raise RuntimeError(f"{model_name}@{matrix_name} validation failed: "
                           f"rel {err:.3e} > {tol}")
    x_dev = model.prepare_x(x)
    res = bench_apply(f"{model_name}:{matrix_name}",
                      lambda n: model.iterate(x_dev, n), nnz=m.nnz,
                      device=device, iters=iters, warmup=10,
                      bytes_model=model.bytes_model())
    e = getattr(model, "ehyb", None)
    stats = e.stats if e is not None else {}
    # the phase split shows which phases (so which kernels) the row ran, as
    # the reference's audikw_1 run hits every phase (spmv.cu:62-133)
    split = {k: int(stats.get(k, 0)) for k in
             ("ell_steps", "nnz_ell", "nnz_dia", "nnz_er", "nnz_long")}
    # the engine the gate may have swapped in has no EHYB stats: its
    # schedule split (routed vs spilled entries) stands in the same record
    blocks = (getattr(model, "blocks", None)
              or getattr(getattr(model, "r", None), "blocks", None))
    if blocks:
        split["nnz_routed"] = int(sum(b.stats.get("nnz_routed", 0)
                                      for b in blocks))
        split["nnz_spill"] = int(sum(b.stats.get("nnz_spill", 0)
                                     for b in blocks))
        split["routed_blocks"] = len(blocks)
    split["engine"] = type(model).__name__
    log(f"[{model_name}] phase split: {split}")
    return {
        "model": model_name, "matrix": matrix_name, "gflops": res.gflops,
        "seconds": res.seconds, "iters": iters, "rel_error": err,
        "roofline_gflops": res.roofline_gflops,
        "roofline_frac": res.roofline_frac, "bytes_model": res.bytes_model,
        "nnz": int(m.nnz), "backend": device.type, "dword": dword,
        "setup_seconds": dict(model.setup_seconds),
        "load_seconds": t1 - t0, "oracle_seconds": t2 - t1,
        "oracle_hit": oracle_hit, **split,
        "launches": {k: int(c.launches)
                     for k, c in zip(LAUNCH_KEYS, counters)},
        "card": card_name() if device.type == "cuda" else None,
    }


def child_main(model_name: str, matrix_name: str, iters: int,
               device: str) -> int:
    """``--run``: one model in this process; prints one ``BENCH_RESULT``
    line, with an ``"error"`` where it failed (and exits 1 then)."""
    try:
        result = run_model(model_name, matrix_name, iters, device)
    except Exception as exc:  # the child's boundary: report, exit non-zero
        traceback.print_exc()
        print(RESULT_TAG + json.dumps({
            "model": model_name, "matrix": matrix_name,
            "error": f"{type(exc).__name__}: {exc}"}), flush=True)
        return 1
    print(RESULT_TAG + json.dumps(result), flush=True)
    return 0


def failed(result) -> bool:
    return result is None or "error" in result


def backend_alive(timeout: int = 300):
    """(ok, reason): does a fresh process see a CUDA device within
    ``timeout`` seconds?"""
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, torch; "
             "sys.exit(0 if torch.cuda.is_available() else 3)"],
            capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return False, f"torch.cuda.is_available() hung > {timeout} s"
    if proc.returncode == 3:
        return False, "torch.cuda.is_available() is false"
    return proc.returncode == 0, proc.stderr[-500:]


def run_child(model_name: str, matrix: str, iters: int,
              device: str = "cuda", timeout: int = 1500) -> dict:
    """Parent side: run one model in a subprocess and return its result;
    a failed child's dict carries ``"error"``.  ``wall_seconds`` is the
    child's wall time, process start included."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", model_name,
             matrix, str(iters), "--device", device],
            stdout=subprocess.PIPE, timeout=timeout)
    except subprocess.TimeoutExpired:
        log(f"[{model_name}] TIMED OUT after {timeout} s")
        return {"model": model_name, "matrix": matrix,
                "error": f"timed out after {timeout} s",
                "wall_seconds": time.perf_counter() - t0}
    out = proc.stdout.decode(errors="replace")
    result = None
    for line in out.splitlines():
        if line.startswith(RESULT_TAG):
            result = json.loads(line[len(RESULT_TAG):])
    if result is None:
        log(f"[{model_name}] no result (exit {proc.returncode}); stdout:\n"
            f"{out[-2000:]}")
        result = {"model": model_name, "matrix": matrix,
                  "error": f"no result (exit {proc.returncode})"}
    result["wall_seconds"] = time.perf_counter() - t0
    return result


def headline(device: str = "cuda"):
    """The headline run: (rows, tail).  ``rows`` holds the child results by
    role (``flagship``, ``baseline``, ``secondary``, ``gather``; a role not
    run is absent); ``tail`` is the JSON tail, with ``"error"`` where the
    flagship failed."""
    matrix = os.environ.get("EHYB_BENCH_MATRIX", "permuted_poisson_512")
    secondary = os.environ.get("EHYB_BENCH_SECONDARY", "fem3d_32")
    iters = int(os.environ.get("EHYB_BENCH_ITERS", "500"))
    gw_matrix = os.environ.get("EHYB_BENCH_GATHER", "random_1m")
    gw_model = os.environ.get("EHYB_BENCH_GATHER_MODEL", "ehyb")
    metric = f"spmv_gflops_{matrix}_{device}"

    rows = {"flagship": run_child("ehyb", matrix, iters, device)}
    flagship = rows["flagship"]
    if failed(flagship):
        return rows, {"metric": metric, "value": 0.0, "unit": "GFLOP/s",
                      "vs_baseline": 0.0, "error": flagship["error"]}
    # the vendor baseline (cuSPARSE on a card), csr where it fails; at the
    # flagship's iterations (the TPU bench cut them for XLA baselines
    # 100-10,000x slower than the body, which cuSPARSE on the card is not)
    for name in ("bcoo", "csr"):
        rows["baseline"] = run_child(name, matrix, iters, device)
        if not failed(rows["baseline"]):
            break
    baseline = rows["baseline"]
    if secondary:
        rows["secondary"] = run_child("ehyb", secondary, iters, device)
    if gw_matrix:
        rows["gather"] = run_child(gw_model, gw_matrix, min(iters, 100),
                                   device, timeout=2400)

    vs = 0.0 if failed(baseline) else flagship["gflops"] / baseline["gflops"]
    log(f"flagship[ehyb@{matrix}] {flagship['gflops']:.2f} GFLOP/s "
        f"(engine {flagship['engine']}, ell_steps {flagship['ell_steps']}, "
        f"nnz_er {flagship['nnz_er']}, launches {flagship['launches']}) | "
        f"baseline[{baseline['model']}] "
        f"{baseline.get('gflops', float('nan')):.2f} -> {vs:.3f}x")
    tail = {"metric": metric, "value": flagship["gflops"], "unit": "GFLOP/s",
            "vs_baseline": vs,
            "baseline_model": None if failed(baseline) else baseline["model"]}
    second = rows.get("secondary")
    if second is not None and not failed(second):
        log(f"secondary[ehyb@{secondary}] {second['gflops']:.2f} GFLOP/s "
            f"(engine {second['engine']}, launches {second['launches']})")
    gather = rows.get("gather")
    if gather is not None:
        tail["gather_wall"] = {"matrix": gw_matrix, "model": gw_model}
        if failed(gather):
            tail["gather_wall"]["error"] = gather["error"]
        else:
            log(f"gather-wall[{gw_model}@{gw_matrix}] {gather['gflops']:.2f} "
                f"GFLOP/s engine={gather['engine']} "
                f"nnz_routed={gather.get('nnz_routed', 0)} "
                f"nnz_spill={gather.get('nnz_spill', 0)}")
            tail["gather_wall"].update(
                engine=gather["engine"], gflops=gather["gflops"],
                nnz_routed=gather.get("nnz_routed", 0),
                nnz_spill=gather.get("nnz_spill", 0))
    tail["card"] = flagship["card"]
    return rows, tail


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", nargs=3, metavar=("MODEL", "MATRIX", "ITERS"),
                   help="child mode: benchmark one model in this process")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device the models run on (default cuda)")
    args = p.parse_args(argv)
    if args.run:
        model_name, matrix, iters = args.run
        return child_main(model_name, matrix, int(iters), args.device)
    if args.device == "cuda":
        ok, reason = backend_alive()
        if not ok:
            log(f"backend probe failed: {reason}")
            print(json.dumps({"metric": "spmv_gflops", "value": 0.0,
                              "unit": "GFLOP/s", "vs_baseline": 0.0,
                              "error": f"backend unavailable: {reason}"}))
            return 1
    _, tail = headline(args.device)
    print(json.dumps(tail))
    return 1 if "error" in tail else 0


if __name__ == "__main__":
    sys.exit(main())
