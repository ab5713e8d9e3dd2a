"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``ehyb_spmv_torch/csrc/`` (one
``nvcc`` each, all started together): K1, the streamed SELL body over its
compact plan; the routed engine's one-pass kernel, which takes the place of
the TPU's K7 and K8; K9, the DIA body; and the x-window-cache body that
serves the TPU's K3/K4.  Checks each against its plain PyTorch version on
small matrices that land on every layout it serves (K1 at every built
variant on nwin 1/2/4, Kahan, int32 columns and a synthetic body with a
ragged last slice, a zero-width row block and row blocks cut for the 16-bit
range, bit for bit where Kahan is off; K9 at every built variant, in both
of its x modes, on cases that reach its tile and x edges; and K1 where the
JAX package would run K5 or K6, timed there), then drives four main paths
end to end through the CLI and checks each against the exact-f64 oracle:

* the flagship on ``permuted_poisson_512`` (262,144 rows, ~1.3M nnz), which
  runs K1 and K9;
* the gather-wall row: ``ehyb`` on ``random_1m`` (1,048,576 rows, 16,769,356
  nnz), which the flagship's delegation gate hands to the routed engine
  (the one-pass routed kernel);
* the audikw-class FEM row ``fem3d_68_audikw_class`` (943,296 rows,
  74,181,672 nnz, all DIA), which runs K9 alone;
* ``permuted_poisson_4096`` (16,777,216 rows, 83,869,696 nnz), whose x is
  past the TPU's residency limit: the window-cache body and K9.

Each path runs with the launch counts set to 0 just before it and read just
after, to show it went through its kernels.  The CLI's timed loop replays
CUDA graphs of the apply (captured in its warm-up); a replay adds the
launches its graph holds to the counts, so they read captured launches
times replays.  Then it times every kernel and
its plain version at its main path's shapes (K1 also on
``permuted_poisson_1024`` on its own resident path, and on
permuted_poisson_4096's body beside the window cache; both on
``permuted_poisson_1024`` forced past the residency limit, where the TPU
runs K3), beside one cuSPARSE call (``torch.sparse_csr_tensor`` matvec) as
a yardstick, with K1 and K9 also in their other x mode, in turns, and
prints one JSON line of kernels with two bounds each:
``bound_ms``, the same work in any layout (each entry's value and column,
x and y once: what the function must move), and ``layout_bound_ms``, the
bytes of the kernel's own layout (its cells, maps, staged or re-read x
rows, partial y vectors).  A kernel whose data stays in L2 between graph
replays (``permuted_poisson_512``'s 15 MB in f64) can read faster than
either, which count every byte at HBM's rate.  Beside each main path's
GFLOP/s and each kernel's time it prints the card's SM clock, power draw,
temperature and active throttle reasons, read right after the timed loop.

Then the device loops: on each of the four rows the chained loop as
CUDA-graph replays against the eager loop (the same y within rel 1e-6 at eps
0 and 0.1, both timed in turns with no capture inside the timed calls, the
graph no slower), where the device time goes under the graph
(``torch.profiler`` and ``phase_breakdown``), CG on ``permuted_poisson_512``
through the flagship with and without Jacobi (graph against eager, the true
residual from the exact-f64 oracle, a checkpointed solve cut at 500
iterations and resumed), power iteration (graph against eager), and the
``csr``, ``bcoo`` and ``hyb`` baselines through the CLI beside ``ehyb``.

Last, the sharded path (``ehyb_spmv_torch/parallel/``): K1 with a
row-block list against its plain version (a sharded stencil's interior,
boundary, both and empty lists, row blocks cut for the 16-bit range,
Kahan, at every built variant); ``ShardedEhybSpmv`` at one rank on
``permuted_poisson_1024`` with no process group, through the graph loop
(its launch counts set to 0 before it and read after; against the oracle,
the flagship and, in turns, the flagship's graph loop); two and four gloo
ranks on the one card (``parallel/launch.py``; NCCL refuses two ranks on
one device), each rank's interior and boundary row blocks, the exchange
size and its eager µs per apply (the ranks share the card: not scaling);
the sharded K1 per rank and list, timed on its own; the sharded routed
engine at one rank on ``random_1m`` and, with the sharded degree split, at
two ranks on small matrices.  The ``kernels`` line lists the sharded K1
beside the other four.

Then the precision mode (``--dword``: f64 values, x, y and sums; phase 17):
K1 and K9 in f64 against their f64 plain versions (rel <= 1e-12) on the
f64 layouts of the K1 cases, the edge body, the stress matrix of
``tests/test_dword.py`` and K9's cases with odd and negative offsets;
``permuted_poisson_512 --dword`` at full size through the CLI (rel <= 1e-12
against the oracle, K1 f64 launched, the window cache not) beside the f32
row; ``fem3d_68_audikw_class --dword`` (K9 f64 on its DIA part); then K1
f64 and K9 f64 timed (also K9 f64 at fem3d_68's 99 diagonals) beside both
bounds at 8-byte values, their plain versions and cuSPARSE in f64.  Last
the small gate (phase 18): ``ehyb`` on ``random_16k`` and
``powerlaw_16k``, each with a fresh cache, times the candidate engine
against the body through the graph loop and keeps the one the 5% rule
picks; a warm setup reads the verdict without measuring, and
``stencil3d(24, 27)`` keeps the body without measuring.  The ``kernels``
line gains ``ehyb_stream_body (f64)`` and ``dia (f64)``.

Last, a float64 config (``--dtype float64``, not the precision mode;
phase 19), whose variants phases 5, 16a and 17a check first, bit for bit
against their plain versions run on the CPU: K1 f64 with Neumaier
compensation and with row-block lists, and the window cache in f64, plain
and Kahan, at 80, 112 (the plan's) and 160 slot rows, a tight budget and
one group of 128 threads, with an f64 cancellation matrix (±1e17) whose
row only the Kahan variants keep.  Phase 19 drives
``permuted_poisson_512 --dtype float64 --compensated`` (K1 f64 Kahan),
``permuted_poisson_1024`` forced past residency with the same flags (the
window cache's Kahan variant, held bit for bit to its plain version on the
CPU and timed there), ``permuted_poisson_4096 --dtype float64`` (the window
cache in f64, plain and Kahan timed on its plan; its host artifact is
built in the background by ``scripts_torch/prewarm.py --dtype float64``
from phase 9 on, and the CLI loads it with ``--cache``) through the CLI
and ``ShardedEhybSpmv`` in f64 at one rank (graph loop) and two gloo
ranks, each within F64_TOL of the oracle with its launches counted; it
times the new variants beside both bounds, their plain
versions and cuSPARSE in f64, and the ``kernels`` line gains four entries.
The f64 plan's geometry was chosen by ``chip_wincache_sweep.py --f64``.

Last, the bench surface (phase 20, ``bench_torch.py`` and
``scripts_torch/``).  ``scripts_torch/prewarm.py --models ehyb``, started
in the background before phase 1, builds the artifacts and oracles of
phase 20's rows on the host, into a temporary cache, while the card runs
phases 1-19.  Then every child runs in its own process with
``artifact_cache=True`` on that cache: ``bench_torch.headline()`` (the
pp512 flagship with K1 and K9 launched and an ER tail, ``bcoo`` as the
baseline, ``fem3d_32`` on K9 and ``random_1m`` through the gate to
``RoutedSpmv``), the headline again in the precision mode (rel <= 1e-12,
the baseline in f32), and ``scripts_torch/sweep.py --models ehyb`` over
the five corpus rows no other phase drives (``poisson2d_512``,
``stencil27_24``, ``fem3d_32``, ``random_4m`` in the routed engine's
column-block mode, ``powerlaw_1m``), its table rebuilt from its log by
``scripts_torch/sweep_table.py``.  Each row prints its engine, launches,
rel error, setup and wall.  Phase 20 adds no kernel.

Imports only the port (never JAX or the JAX package).  Exits non-zero when
any phase fails or no CUDA device is present.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import bench_torch
import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.core import cache as port_cache
from ehyb_spmv_torch.core.coo import (MatrixCOO, coalesce, deterministic_x,
                                      oracle_spmv)
from ehyb_spmv_torch.core.route import RoutedEpilogue, build_routed
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.models import routed as routed_model
from ehyb_spmv_torch.models.solver import CgSolver, PowerIteration
from ehyb_spmv_torch.ops import dia, ehyb_stream, ehyb_wincache, route
from ehyb_spmv_torch.ops import route_xcache, stream_plan
from ehyb_spmv_torch.ops.build import BUILD_DIR
from ehyb_spmv_torch.ops.stream_cells import (PIECE_CELL, PIECE_RB,
                                              PIECE_ROW, build_stream_cells)
from ehyb_spmv_torch.parallel import launch
from ehyb_spmv_torch.parallel.comm import rank_device
from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv
from ehyb_spmv_torch.parallel.routed import ShardedRoutedSpmv
from ehyb_spmv_torch.parallel.shard_cells import build_shard_cells
from ehyb_spmv_torch.parallel.spmv import (ShardedEhybSpmv, plan_sharded,
                                           shard_matrix)
from ehyb_spmv_torch.ops.torch_ops import body_gather_index, ehyb_body
from ehyb_spmv_torch.utils.graphs import CapturedGraph, launch_counters
from ehyb_spmv_torch.utils.profiling import phase_breakdown
from ehyb_spmv_torch.utils.timing import detect_hbm_bw, timed_seconds
from scripts_torch import sweep as torch_sweep
from scripts_torch import sweep_table

#: Kernel vs plain version, f32 both: only the summation order differs.
KERNEL_TOL = 1e-6
#: The precision mode (f64 kernels against their f64 plain versions, and
#: end to end against the exact-f64 oracle): the JAX double-word mode's
#: bound (tests/test_dword.py).
F64_TOL = 1e-12
#: A float64 kernel variant against its float64 plain version (the same
#: products; the plain versions of the Kahan variants add them in the
#: kernel's order with the same compensation).
F64_KERNEL_TOL = 1e-14
#: End to end vs the exact-f64 oracle: the suite's bound.
ORACLE_TOL = 5e-6
#: The graph loop vs the eager loop, f32 both: the ER and long-row scatters
#: add with atomics, so the sums' order differs between runs.
LOOP_TOL = 1e-6
#: The graph loop may read this much slower than the eager loop in a
#: paired run before the check fails (the card-bound rows' run-to-run
#: spread; the host-bound row is expected far faster).
LOOP_SLACK = 1.03
#: CG on permuted_poisson_512 in f32: b = A·x_true takes ~50 iterations to
#: 1e-4 and ~800 to 1e-7, where the true residual sits at f32's floor
#: (~7e-7); 2e-7 takes several hundred, so a checkpoint can cut it at 500,
#: and keeps the true residual within 10x of the tolerance.
CG_TOL = 2e-7
CG_MAX = 5000
#: Power iteration, graph vs eager after 100 f32 steps.
POWER_TOL = 1e-5
#: The baselines of ``--model`` on the headline row, through the CLI.
BASELINE_ARGS = ["-g", "permuted_poisson_512", "-i", "500", "--json",
                 "--device", "cuda", "--model"]
MAIN_ARGS = ["-g", "permuted_poisson_512", "-i", "500", "--json",
             "--device", "cuda"]
#: bench.py's gather-wall row: ehyb through the gate, 100 iterations.
GATHER_ARGS = ["-g", "random_1m", "--model", "ehyb", "-i", "100", "--json",
               "--device", "cuda"]
#: The audikw-class FEM row: all DIA, K9 alone.
FEM_ARGS = ["-g", "fem3d_68_audikw_class", "--model", "ehyb", "-i", "200",
            "--json", "--device", "cuda"]
#: x past the TPU's residency limit: the window-cache body and K9.
HBM_ARGS = ["-g", "permuted_poisson_4096", "--model", "ehyb", "-i", "50",
            "--json", "--device", "cuda"]
#: The precision mode's main path: the headline row in f64.
DWORD_ARGS = MAIN_ARGS + ["--dword"]
#: fem3d_68 in the precision mode: its layout's DIA part at HBM scale.
DWORD_FEM_ARGS = ["-g", "fem3d_68_audikw_class", "--model", "ehyb", "-i",
                  "50", "--json", "--device", "cuda", "--dword"]
#: A float64 config (not the precision mode) where the reference answers:
#: the flagship past x residency at 8 B a value (the window cache in f64)
#: and the headline row with compensation (K1 f64 Kahan).
HBM_F64_ARGS = HBM_ARGS + ["--dtype", "float64"]
KAHAN_F64_ARGS = MAIN_ARGS + ["--dtype", "float64", "--compensated"]
#: The compensated window cache on a main path: permuted_poisson_1024
#: forced past residency (as EHYB_X_RESIDENT_BYTES does) in f64.
WC_KAHAN_F64_ARGS = ["-g", "permuted_poisson_1024", "-i", "200", "--json",
                     "--device", "cuda", "--dtype", "float64",
                     "--compensated"]
#: Scattered matrices under the small gate's 65,536 rows (nnz >= 2^18).
SMALL_GATE_MATRICES = ("random_16k", "powerlaw_16k")
_PALLAS = "ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py"
K1 = {"name": "ehyb_stream_body", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
      "replaces": f"{_PALLAS}:148 (K1); also serves {_PALLAS}:615 (K2), "
                  f"{_PALLAS}:84 (K5), {_PALLAS}:109 (K6)"}
_ROUTE = "ehyb_spmv_gpu_tpu/ops/route_pallas.py"
RX = {"name": "route_xcache", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/route_xcache.cu",
      "replaces": f"{_ROUTE}:56 (K7) and {_ROUTE}:87 (K8), one kernel for "
                  "both, with the spill tail"}
K9 = {"name": "dia", "route": "cuda", "source": "ehyb_spmv_torch/csrc/dia.cu",
      "replaces": "ehyb_spmv_gpu_tpu/ops/dia_pallas.py:68 (K9, inner "
                  "kernels :115 and :131)"}
WC = {"name": "ehyb_wincache_body", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/ehyb_wincache.cu",
      "replaces": f"{_PALLAS}:293 (K3), {_PALLAS}:489 (K4)"}
K1F64 = {"name": "ehyb_stream_body (f64)", "route": "cuda",
         "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
         "replaces": f"{_PALLAS}:148 (K1) in f64, the body of the precision "
                     "mode (ehyb_spmv_gpu_tpu/ops/dword.py, XLA on the TPU)"}
K9F64 = {"name": "dia (f64)", "route": "cuda",
         "source": "ehyb_spmv_torch/csrc/dia.cu",
         "replaces": "ehyb_spmv_gpu_tpu/ops/dia_pallas.py:68 (K9) in f64, "
                     "the DIA phase of the precision mode "
                     "(ehyb_spmv_gpu_tpu/ops/dword.py)"}
SK1 = {"name": "ehyb_stream_body (row-block list)", "route": "cuda",
       "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
       "replaces": "ehyb_spmv_gpu_tpu/parallel/spmv.py:511 (_stream_call, "
                   "pallas_call :538)"}
K1F64K = {"name": "ehyb_stream_body (f64, Kahan)", "route": "cuda",
          "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
          "replaces": f"{_PALLAS}:148 (K1, kahan=True) in a float64 config"}
SK1F64 = {"name": "ehyb_stream_body (f64, row-block list)", "route": "cuda",
          "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
          "replaces": "ehyb_spmv_gpu_tpu/parallel/spmv.py:511 (_stream_call, "
                      "pallas_call :538) in a float64 config"}
WCF64 = {"name": "ehyb_wincache_body (f64)", "route": "cuda",
         "source": "ehyb_spmv_torch/csrc/ehyb_wincache.cu",
         "replaces": f"{_PALLAS}:293 (K3), {_PALLAS}:489 (K4) in a float64 "
                     "config"}
WCF64K = {"name": "ehyb_wincache_body (f64, Kahan)", "route": "cuda",
          "source": "ehyb_spmv_torch/csrc/ehyb_wincache.cu",
          "replaces": f"{_PALLAS}:293 (K3), {_PALLAS}:489 (K4), kahan=True, "
                      "in a float64 config"}
#: The sharded path's matrix and config: 1024-row windows, the TPU's
#: Pallas branch of the JAX ShardedEhybSpmv (the multi-window layouts).
SHARDED_MATRIX = "permuted_poisson_1024"
SHARDED_CFG = {"window_rows": 1024}
#: Seconds a spawn of sharded ranks may take before they are killed.
RANK_TIMEOUT_S = 300
#: Phase 20: the corpus rows no earlier phase drives, through
#: ``scripts_torch/sweep.py --models ehyb``.
SWEEP_ROWS = ("poisson2d_512", "stencil27_24", "fem3d_32", "random_4m",
              "powerlaw_1m")
#: The rows phase 20 runs the flagship on: ``scripts_torch/prewarm.py``
#: builds their artifacts and oracles on the host while the card runs
#: phases 1-19, the costliest first.
PREWARM_ROWS = ("random_4m", "powerlaw_1m", "fem3d_32", "poisson2d_512",
                "stencil27_24", "random_1m", "permuted_poisson_512")
#: Seconds phase 20 waits for the prewarm to end (and 19c for its
#: prebuild).
PREWARM_TIMEOUT_S = 600
#: Phase 19c's host setup, pp4096 in a float64 config, built on the host
#: while the card runs phases 10-19b.
PREBUILD_F64_ARGS = ("--models", "ehyb", "--dtype", "float64",
                     "permuted_poisson_4096")
#: float32 peak outside the tensor cores (NVIDIA's data sheets), matched like
#: the bandwidth table of utils/timing.py: the first key in the name wins.
PEAK_F32 = {"h100 pcie": 51e12, "h100": 67e12}
#: float64 peak outside the tensor cores (the same data sheets).
PEAK_F64 = {"h100 pcie": 26e12, "h100": 34e12}


#: What the card runs at, read beside every timed row.
CARD_STATE = ("clocks.sm,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")


def card_state() -> str:
    """The SM clock, power draw, temperature and active throttle reasons
    (a bit mask, 0x0 when none) as ``nvidia-smi`` reads them now."""
    for query in (CARD_STATE, CARD_STATE.replace("throttle", "event")):
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if proc.returncode == 0:
            return f"card: {query} = {proc.stdout.strip()}"
    return f"card: nvidia-smi could not read {CARD_STATE}: {proc.stderr}"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(
        1e-300))


def rel_np(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


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
    del graph
    return start.elapsed_time(end) / n


def in_turns(kernel, plain, n_kernel: int, n_plain: int):
    """Device ms per call in turns (plain, kernel, kernel, plain) on one
    card: the means of both, and the four readings."""
    p_a = device_ms_per_call(plain, n_plain)
    k_a = device_ms_per_call(kernel, n_kernel)
    k_b = device_ms_per_call(kernel, n_kernel)
    p_b = device_ms_per_call(plain, n_plain)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, (p_a, k_a, k_b, p_b)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int, dev: torch.device,
          f64: bool = False) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its peak rate for their type (f32,
    or f64 where ``f64``)."""
    name = torch.cuda.get_device_name(dev).lower()
    bw = detect_hbm_bw(dev)
    peaks = PEAK_F64 if f64 else PEAK_F32
    peak = next((v for k, v in peaks.items() if k in name), None)
    if bw is None or peak is None:
        raise RuntimeError(f"no memory or peak rate for {name!r}")
    t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def same_work_bound(nnz: int, idx_bytes: int, n_x: int, n_y: int,
                    dev: torch.device, value_bytes: int = 4) -> dict:
    """The bound of the same product in any layout: each entry's value
    (f32, or f64 where ``value_bytes`` is 8) and ``idx_bytes`` of column
    once, x once and y once."""
    n_bytes = nnz * (value_bytes + idx_bytes) + value_bytes * (n_x + n_y)
    return dict(bound(n_bytes, 2 * nnz, dev, value_bytes == 8),
                bytes=n_bytes)


def bounds(layout: dict, same: dict) -> dict:
    """A kernel's bound fields in the ``kernels`` line: ``bound_ms`` and
    ``bound_by`` are the same work in any layout (``same``, from
    :func:`same_work_bound`), what the function itself must move; the bytes
    of the kernel's own layout (``layout``, from :func:`bound`) stand
    beside it as ``layout_bound_ms``."""
    return dict(bound_ms=same["bound_ms"], bound_by=same["bound_by"],
                layout_bound_ms=layout["bound_ms"])


def csr_of(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
           n_rows: int, n_cols: int) -> torch.Tensor:
    """A sparse CSR tensor (int32 indices) of COO entries, on their device:
    the cuSPARSE yardstick's operand."""
    order = torch.argsort(row * n_cols + col)
    counts = torch.bincount(row, minlength=n_rows)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=row.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), col[order].to(torch.int32), val[order],
        size=(n_rows, n_cols))


def random_coo(dim: int, k: int, seed: int) -> MatrixCOO:
    """dim x dim, k random columns per row, duplicates dropped."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(dim), k)
    col = rng.integers(0, dim, dim * k)
    _, ui = np.unique(row.astype(np.int64) * dim + col, return_index=True)
    return MatrixCOO(dim, dim, row[ui], col[ui], rng.standard_normal(ui.size))


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


def cancellation_matrix_f64() -> port.MatrixCOO:
    """Row 0 sums 100 ones among ±1e17 blocks (an ulp of 1e17 is 16): exact
    with Neumaier compensation in f64, lossy in naive f64 summation."""
    m = cancellation_matrix()
    val = m.val.copy()
    val[np.abs(val) == 1e8] *= 1e9
    return port.MatrixCOO(m.n_rows, m.n_cols, m.row, m.col, val)


def stress_matrix(dim: int = 2048, seed: int = 3) -> MatrixCOO:
    """Values that need every f64 bit (``tests/test_dword.py``'s matrix):
    magnitudes spanning 1e-8..1e8 with cancellation pairs and low-order
    perturbations at the 1e-13 level; f32 storage alone loses them."""
    rng = np.random.default_rng(seed)
    base = generate.random_general(dim, 8, seed=seed)
    val = base.val.copy()
    val *= 1.0 + rng.standard_normal(val.shape[0]) * 1e-13
    # cancellation rows: pairs (big, -big + eps)
    n_pairs = 64
    rows = rng.choice(dim, size=n_pairs, replace=False).astype(np.int64)
    cols_a = rng.integers(0, dim, size=n_pairs)
    cols_b = (cols_a + 1 + rng.integers(0, dim - 2, size=n_pairs)) % dim
    big = 10.0 ** rng.uniform(6, 8, size=n_pairs)
    eps = rng.standard_normal(n_pairs) * 1e-5
    return coalesce(MatrixCOO(
        dim, dim, np.concatenate([base.row, rows, rows]),
        np.concatenate([base.col, cols_a, cols_b]),
        np.concatenate([val, big, -big + eps])))


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


def edge_body(seed: int = 7) -> port.EhybMatrix:
    """A synthetic ``sell_mw`` body (nwin 1, unaligned windows) that reaches
    the edges of K1's plan: slice 0's row blocks read 80 windows of 8 x
    rows (640 x rows, past a 16-bit table: each is cut into pieces),
    slice 1 has a row block with no cell (width 0), and slice 2 is ragged
    (its last 51 rows hold nothing, the others rows of random lengths)."""
    rng = np.random.default_rng(seed)
    win, widths = 1024, (80, 16, 24)
    dim = widths[0] * win
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    n_steps = int(offs[-1])
    step_win = np.concatenate([
        np.arange(widths[0]) * win,
        rng.integers(0, dim, widths[1] + widths[2])]).astype(np.int32)
    ell_col = rng.integers(0, win, (n_steps, 128)).astype(np.int16)
    ell_val = rng.standard_normal((n_steps, 128)).astype(np.float32)
    ell_val[offs[1]:offs[2], 32:64] = 0.0
    last = ell_val[offs[2]:]
    length = rng.integers(0, widths[2] + 1, 128)
    length[77:] = 0
    last[np.arange(widths[2])[:, None] >= length[None, :]] = 0.0
    nnz = int(np.count_nonzero(ell_val))
    i32, f32 = np.int32, np.float32
    return port.EhybMatrix(
        dim=dim, nnz_total=nnz, window_rows=win, n_parts=1,
        ell_col=ell_col, ell_val=ell_val, slice_offset=offs,
        slice_win_start=step_win[offs[:-1]], step_win=step_win,
        er_col=np.zeros((0, 128), i32), er_val=np.zeros((0, 128), f32),
        er_slice_offset=np.zeros(1, i32), er_rows=np.zeros(0, i32),
        long_col=np.zeros(0, i32), long_val=np.zeros(0, f32),
        long_seg=np.zeros(0, i32), long_rows=np.zeros(0, i32),
        stats={"nnz_ell": nnz, "waste_ell": n_steps * 128 - nnz})


def k1_geometries(f64: bool = False):
    """Every built K1 variant (rows per thread, x mode) at 128 threads, and
    the default geometry; in f64 those of them built in f64 (one row a
    thread, x ldg)."""
    out = [ehyb_stream.StreamGeometry(threads=128, rows=r, x_mode=mode)
           for r in ehyb_stream.BUILT_ROWS
           for mode in ehyb_stream.X_MODES] + [ehyb_stream.GEOMETRY]
    if f64:
        out = [g for g in out if g.rows == 1 and g.x_mode == "ldg"]
    return out


def check_k1_case(name: str, e, x: np.ndarray, kahan: bool, dev,
                  cells=None) -> None:
    """K1 over the compact plan of body ``e`` (an EhybMatrix, f32 or f64
    values) at every geometry of :func:`k1_geometries` for its type:
    against its plain version and the padded body's within KERNEL_TOL
    (F64_TOL in f64), and bit for bit against the plain version on the CPU
    (which adds in the kernel's order) where Kahan is off or the type is
    f64 (whose plain version compensates in the kernel's order).  In f64
    both plain versions run on the CPU: on the card they add with atomics
    in no fixed order, and a naive f64 sum of the cancellation matrix
    depends on the order.  ``cells``, the plan on the card, defaults to a
    fresh build of ``e``'s."""
    f64 = e.ell_val.dtype == np.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    exact = f64 or not kahan
    plan = build_stream_cells(e)
    p = plan.to_torch(dev) if cells is None else cells
    x_dev = torch.as_tensor(
        x, dtype=torch.float64 if f64 else torch.float32, device=dev)
    y_cpu = ehyb_stream.stream_body_plain(plan.to_torch(), x_dev.cpu(),
                                          kahan)
    on = "cpu" if f64 else dev
    y_p = y_cpu.to(on) if f64 else ehyb_stream.stream_body_plain(p, x_dev,
                                                                 kahan)
    y_pad = ehyb_body(e.to_torch(device=on), x_dev.to(on),
                      compensated=kahan)
    worst, same = 0.0, True
    for g in k1_geometries(f64):
        y_k = ehyb_stream._launch(p, x_dev, kahan, g).to(on)
        err = max(rel(y_k, y_p), rel(y_k, y_pad))
        if not bool(torch.isfinite(y_k).all()) or err > tol:
            check(False, f"K1 {name} at {g}: vs plain rel {rel(y_k, y_p):.3e}"
                         f", vs the padded body's rel {rel(y_k, y_pad):.3e}")
        worst = max(worst, err)
        same = same and torch.equal(y_k.cpu(), y_cpu)
    st = plan.stats
    check(not exact or same,
          f"K1 {name} ({st['n_rb']} row blocks, {st['n_pieces']} pieces, "
          f"{st['split_rbs']} cut for the 16-bit range, max width "
          f"{st['max_width']}; {st['compact_cells']} of {st['padded_cells']} "
          f"cells{', f64' if f64 else ''}{', Kahan' if kahan else ''}): "
          f"{len(k1_geometries(f64))} geometries, vs plain and the padded "
          f"body rel <= {worst:.3e} <= {tol}"
          + ("; bit for bit with the plain version on the CPU" if exact
             else ""))


def reset_launches() -> None:
    for fn in launch_counters():
        fn.launches = 0


def stages_plain(d, x: torch.Tensor) -> torch.Tensor:
    """The schedule's dst-space y through the plain versions of the TPU's
    two stages (K7, K8) and the spill tail."""
    y_dst = route.route_b_plain(d, route.route_at_plain(d, x))
    return route.spill_tail(d, x, y_dst)


def routed_plain(d, x: torch.Tensor) -> torch.Tensor:
    """The routed apply of one schedule through the plain K7/K8 pair."""
    return route.to_input_space(d, stages_plain(d, x))


def check_schedule(name: str, rm, ap, x: torch.Tensor) -> None:
    """The one-pass kernel on one schedule's plan against its plain version
    and against the plain K7/K8 pair (the schedule's stage arrays uploaded
    for it), and the whole apply ``ap`` against the pair's."""
    d = rm.to_torch(device=x.device)
    p = ap.plan
    y_k = route_xcache.route_xcache(p, x)
    y_again = route_xcache.route_xcache(p, x)
    y_p = route_xcache.route_xcache_plain(p, x)
    y_s = stages_plain(d, x)
    torch.cuda.synchronize()
    err_p, err_s = rel(y_k, y_p), rel(y_k, y_s)
    st = p.stats
    check(bool(torch.isfinite(y_k).all()) and err_p <= KERNEL_TOL
          and err_s <= KERNEL_TOL and torch.equal(y_k, y_again),
          f"{name} ({st['n_tiles']} tiles of {st['group_rows']} rows x "
          f"{st['parts']} parts, {st['n_segs']} segments, {st['passes']} "
          f"passes, {st['entries']} entries): route_xcache vs plain rel "
          f"{err_p:.3e}, vs the plain K7/K8 pair rel {err_s:.3e}, the same "
          "bits twice")
    y_k = ap(x)
    y_p = routed_plain(d, x)
    torch.cuda.synchronize()
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL,
          f"{name}: routed apply vs plain rel {err:.3e} <= {KERNEL_TOL}")


def block_mode_model(m: MatrixCOO, dev) -> port.RoutedSpmv:
    """RoutedSpmv in column-block mode at a small size: blocks of a quarter
    of the dimension in place of BLOCK_COLS (the mode engages on its own
    only past ~2M columns)."""
    model = port.RoutedSpmv(port.EhybConfig(), device=dev)
    model.m, model.setup_seconds, model.ehyb = m, {}, None
    model._setup_blocks(m, routed_model._block_ranges(m.dimension,
                                                      m.dimension // 4))
    return model


def check_routed_small(dev) -> None:
    """Every layout of the TPU's routed schedule, on small matrices."""
    cfg = port.EhybConfig()
    x_of = deterministic_x
    # slice layout, one block, identity dst
    m = generate.random_general(16384, 12, seed=3)
    model = port.RoutedSpmv(cfg, device=dev).setup(m)
    d = model.applies[0].d
    check(len(model.blocks) == 1 and not model.blocks[0].octet and d.ident
          and isinstance(d, RoutedEpilogue),
          "slice: one block, slice layout, identity dst, no stage arrays on "
          "the card")
    check_schedule("slice", model.blocks[0], model.applies[0],
                   model.prepare_x(x_of(m.dimension)))
    models = [("slice", m, model)]
    # octet layout, permuted dst (built as the JAX suite builds it)
    m = random_coo(1 << 17, 1, seed=41)
    rm = build_routed(m, R=4096, P=64)
    ap = route.RoutedApply.of(rm, dev)
    check(rm.octet == 1, f"octet: octet layout ({rm.stats['b_steps']} B "
                         "steps)")
    x = np.zeros(rm.padded_x_rows, np.float32)
    x[:m.dimension] = x_of(m.dimension)
    x = torch.as_tensor(x, device=dev)
    check_schedule("octet", rm, ap, x)
    y = ap(x).cpu().numpy()[:m.dimension]
    err = rel_np(y, oracle_spmv(m, x_of(m.dimension)))
    check(err <= ORACLE_TOL, f"octet: apply vs oracle rel {err:.3e} <= "
                             f"{ORACLE_TOL}")
    # column-block mode
    m = random_coo(1 << 15, 8, seed=17)
    model = block_mode_model(m, dev)
    check(len(model.blocks) == 4, f"blocks: {len(model.blocks)} blocks")
    x = model.prepare_x(x_of(m.dimension))
    for i, (rm, ap, lo) in enumerate(zip(model.blocks, model.applies,
                                         model._lo)):
        check_schedule(f"block {i}", rm, ap, x[lo:lo + ap.d.padded_x_rows])
    models.append(("blocks", m, model))
    # slice layout with a spill tail
    m = generate.random_general(4096, 12, seed=9, power_law=0.8)
    model = port.RoutedSpmv(cfg, device=dev).setup(m)
    spill = model.blocks[0].stats["nnz_spill"]
    check(spill > 0, f"spill: {spill} spilled entries")
    check_schedule("spill", model.blocks[0], model.applies[0],
                   model.prepare_x(x_of(m.dimension)))
    models.append(("spill", m, model))
    # the degree-split hybrid (K1 beside the routed kernel)
    m = generate.random_general(1 << 14, 24, seed=4, power_law=0.7)
    models.append(("split", m, port.DegreeSplitSpmv(cfg, device=dev)
                   .setup(m)))
    for name, m, model in models:
        x = x_of(m.dimension)
        err = rel_np(model.matvec(x), oracle_spmv(m, x))
        check(err <= ORACLE_TOL,
              f"{name}: {model.name} vs oracle rel {err:.3e} <= {ORACLE_TOL}")


class patched:
    """Set attributes of ``stream_plan`` and environment variables for the
    length of a ``with`` block, and restore them after it."""

    def __init__(self, env=None, **attrs):
        self.env, self.attrs = env or {}, attrs

    def __enter__(self):
        self.old_attrs = {k: getattr(stream_plan, k) for k in self.attrs}
        self.old_env = {k: os.environ.get(k) for k in self.env}
        for k, v in self.attrs.items():
            setattr(stream_plan, k, v)
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old_attrs.items():
            setattr(stream_plan, k, v)
        for k, v in self.old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def cache_dir(path: str):
    """The port's artifact cache at ``path`` (``core/cache.py``'s default,
    read at call time) for the length of a ``with`` block."""
    old, port_cache.DEFAULT_CACHE_DIR = port_cache.DEFAULT_CACHE_DIR, path
    try:
        yield
    finally:
        port_cache.DEFAULT_CACHE_DIR = old


def dia_geometries(f64: bool = False):
    """Every built K9 variant (256 threads) in both x modes, the default
    geometry, and 128 and 512 threads; in f64 those of them built in f64
    (the default STEP and QUADS)."""
    built = dia.BUILT_STEPS_F64 if f64 else dia.BUILT_STEPS
    out = [dia.DiaGeometry(threads=256, step=s, quads=q, x_mode=mode)
           for s, q in built for mode in dia.X_MODES]
    out += [dia.GEOMETRY]
    out += [dia.DiaGeometry(threads=t, x_mode=mode)
            for t in (128, 512) for mode in dia.X_MODES]
    return out


def check_dia_case(name: str, e, x: torch.Tensor) -> None:
    """K9 at every geometry of :func:`dia_geometries` for x's type against
    its plain version on one DIA part (within KERNEL_TOL, F64_TOL in
    f64)."""
    f64 = x.dtype == torch.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    y_p = dia.dia_body_plain(e, x)
    worst, worst_at, n_run = 0.0, None, 0
    for g in dia_geometries(f64):
        try:
            dia.make_plan(e.dia_offsets, e.dia_val.shape[1], g, 1,
                          x.element_size())
        except ValueError as exc:
            # the staged windows of a wide tile past a block's shared
            # memory (f64 at 512 threads on fem3d_16): the wrapper refuses
            print(f"  K9 {name} at {g}: not run ({exc})")
            continue
        n_run += 1
        y_k = dia._launch(e, x, g)
        torch.cuda.synchronize()
        err = rel(y_k, y_p)
        if not bool(torch.isfinite(y_k).all()) or err > tol:
            check(False, f"K9 {name} at {g}: vs plain rel {err:.3e}")
        if err >= worst:
            worst, worst_at = err, g
    check(True, f"K9 {name} ({len(e.dia_offsets)} diagonals in "
                f"{len(dia.offset_runs(e.dia_offsets))} runs, "
                f"{e.dia_val.shape[1]} rows, x {x.shape[0]}, {x.dtype}): "
                f"{n_run} geometries, vs plain rel <= "
                f"{worst:.3e} (at {worst_at}) <= {tol}")


def check_dia_small(dev, dtype=torch.float32) -> None:
    """K9 against its plain version at every variant of ``dtype``: one
    diagonal; rows not a multiple of 4 (the scalar value loads) with a
    ragged last tile; odd and negative offsets (the shifted 16-B loads);
    offsets past both ends of x (the guarded x reads, the zero-filled
    windows); a run wider than a tile; fem3d_16's 99 diagonals in 9 runs
    (in f64 through the precision mode)."""
    f64 = dtype == torch.float64
    rng = np.random.default_rng(5)
    cases = [("one diagonal", (0,), 100_000, 100_000),
             ("ragged rows", (-3, 0, 5), 100_003, 100_003 - 77),
             ("odd and negative offsets", (-7, -3, -1, 0, 1, 3, 5), 100_000,
              100_000),
             ("past both ends of x",
              (-15_000, -5000, -2049, -1, 0, 1, 2047, 2048, 5000, 15_000),
              12_344, 12_344 - 77),
             ("a run wider than a tile", tuple(range(-2000, 2001, 10)),
              50_000, 50_000)]
    for name, offs, dim_r, n_x in cases:
        e = types.SimpleNamespace(dia_offsets=offs, dia_val=torch.as_tensor(
            rng.standard_normal((len(offs), dim_r)), dtype=dtype,
            device=dev))
        x = torch.as_tensor(rng.standard_normal(n_x), dtype=dtype,
                            device=dev)
        check_dia_case(name, e, x)
    m = generate.fem3d(16)
    model = port.EhybSpmv(port.EhybConfig(dword_values=f64),
                          device=dev).setup(m)
    e = model.dev
    check(len(e.dia_offsets) == 99 and e.dia_val.dtype == dtype,
          f"fem3d_16: {len(e.dia_offsets)} diagonals, {e.dia_val.dtype}")
    check_dia_case("fem3d_16", e, model.prepare_x(
        deterministic_x(m.dimension)))
    x = deterministic_x(m.dimension)
    err = rel_np(model.matvec(x), oracle_spmv(m, x))
    tol = F64_TOL if f64 else ORACLE_TOL
    check(err <= tol, f"fem3d_16 model vs oracle rel {err:.3e} <= {tol}")


def padded_body(model, dev):
    """The model's artifact on the card with its padded SELL body, for the
    yardsticks that read the TPU's layout (cuSPARSE's operand, the padded
    body's plain version): the flagship keeps only its body plan's compact
    cells there."""
    return model.ehyb.to_torch(dtype=model.config.dtype, device=dev)


def check_wincache_plan(name: str, e, p, k1, x_dev, kahan: bool) -> None:
    """The window-cache kernel on one plan against its plain version and
    against K1 on the same body (``k1``, its plan on the card); prints the
    largest difference from K1 (0 where the summation order is kept, as it
    is for finite x).  In f64 both must hold bit for bit: K1 and the plain
    version on the CPU add in the kernel's order (with the same
    compensation where ``kahan``)."""
    f64 = x_dev.dtype == torch.float64
    y_w = ehyb_wincache.wincache_body(e, p, x_dev, kahan)
    y_p = ehyb_wincache.wincache_body_plain(e, p, x_dev, kahan)
    y_1 = ehyb_stream.stream_body(k1, x_dev, kahan)
    torch.cuda.synchronize()
    err_p, err_1 = rel(y_w, y_p), rel(y_w, y_1)
    st = p.stats
    what = (f"{name} ({st['n_blocks']} blocks, {st['chunked_slices']} "
            f"chunked slices, {st['compact_cells']} of {st['padded_cells']} "
            f"cells, {p.slot_rows} slot rows, {p.groups * 128} threads, "
            f"{x_dev.dtype}"
            f"{', Kahan' if kahan else ''}): window cache vs plain rel "
            f"{err_p:.3e}, vs K1 rel {err_1:.3e}, max abs from K1 "
            f"{float((y_w - y_1).abs().max()):.3e}")
    if f64:
        y_cpu = ehyb_wincache.wincache_body_plain(
            copy.deepcopy(e).cpu(), copy.deepcopy(p).cpu(), x_dev.cpu(),
            kahan)
        check(torch.equal(y_w.cpu(), y_cpu) and torch.equal(y_w, y_1),
              what + "; bit for bit with K1 and the plain version on the CPU")
        return
    check(bool(torch.isfinite(y_w).all()) and err_p <= KERNEL_TOL
          and err_1 <= KERNEL_TOL, what)


def f64_cases():
    """:func:`kernel_cases` in a float64 config, and the f64 cancellation
    matrix plain and with compensation."""
    cfg = port.EhybConfig(body_layout="sell_rx", relax_body="never")
    out = [(f"{name} f64", m, dataclasses.replace(c, dtype="float64"), nwin,
            kahan) for name, m, c, nwin, kahan in kernel_cases()]
    for kahan in (False, True):
        out.append((f"cancel 1e17 f64{' kahan' if kahan else ''}",
                    cancellation_matrix_f64(),
                    dataclasses.replace(cfg, dtype="float64",
                                        compensated_sum=kahan), 2, kahan))
    return out


def check_cancel_row(name: str, m, y: np.ndarray, kahan: bool) -> None:
    """The product ``y`` of ``m`` against the oracle (x all ones on a
    cancellation matrix, else ``deterministic_x``).  On a cancellation
    matrix the compensated product gives row 0's exact value, 100; on the
    f64 one (±1e17) the plain product, whose naive sum loses it, does not,
    and the oracle (an f64 sum too) holds only the other rows."""
    big = float(np.abs(m.val).max())
    x = np.ones(m.dimension) if big >= 1e8 else deterministic_x(m.dimension)
    if big >= 1e8:
        check(y[0] == 100.0 if kahan else big < 1e17 or y[0] != 100.0,
              f"{name}: row 0 = {y[0]!r}"
              + (" (exact)" if kahan else ", the naive f64 sum loses it"
                 if big >= 1e17 else ""))
    rows = slice(1, None) if big >= 1e17 else slice(None)
    tol = F64_TOL if y.dtype == np.float64 else ORACLE_TOL
    err = rel_np(y[rows], oracle_spmv(m, x)[rows])
    check(err <= tol, f"{name}: model vs oracle rel {err:.3e} <= {tol}"
                      + (" (rows 1 on)" if big >= 1e17 else ""))


def check_wincache_small(dev) -> None:
    """The window-cache kernel against its plain version and against K1
    at nwin 1/2/4 and Kahan, forced past the residency limit in-process,
    with a slot budget so tight that slices overflow a stage, and with 1
    and 4 groups; then in a float64 config (plain and Kahan, the f64
    cancellation matrix) at the slot budgets the f64 sweep times, a tight
    one and one group."""
    for name, m, cfg, nwin, kahan in kernel_cases():
        with patched(X_RESIDENT_BYTES=1024):
            model = port.EhybSpmv(cfg, device=dev).setup(m)
        e, plan = model.dev, model.module.wincache
        k1 = build_stream_cells(model.ehyb).to_torch(dev)
        check(e.nwin == nwin and plan is not None
              and model.module.branch.startswith("streamed hbm")
              and model.dev.ell_val is None,
              f"{name}: branch {model.module.branch}, nwin={e.nwin}, no "
              f"padded body on the card")
        x = deterministic_x(m.dimension) if not kahan else np.ones(m.dimension)
        x_dev = model.prepare_x(x)
        check_wincache_plan(name, e, plan, k1, x_dev, kahan)
        tight = ehyb_wincache.build_wincache_plan(model.ehyb, slot_rows=32)
        if tight.stats["chunked_slices"]:
            check_wincache_plan(f"{name} tight", e, tight.to_torch(dev), k1,
                                x_dev, kahan)
        y = model.matvec(x)
        err = rel_np(y, oracle_spmv(m, x))
        check(err <= ORACLE_TOL,
              f"{name}: model vs oracle rel {err:.3e} <= {ORACLE_TOL}")
        if kahan:
            check(y[0] == 100.0, f"{name}: compensated row 0 = {y[0]!r}")
    m = random_coo(1 << 15, 24, seed=11)
    cfg = port.EhybConfig(body_layout="sell_rx", relax_body="never",
                          windows_per_subtile=4, routed_delegate="never")
    with patched(X_RESIDENT_BYTES=1024):
        model = port.EhybSpmv(cfg, device=dev).setup(m)
    x_dev = model.prepare_x(deterministic_x(m.dimension))
    k1 = build_stream_cells(model.ehyb).to_torch(dev)
    for groups in (1, 4):
        p = ehyb_wincache.build_wincache_plan(model.ehyb, slot_rows=64,
                                              groups=groups)
        check(p.stats["chunked_slices"] > 0, "scattered 32k quad: slices "
                                             "overflow 64 slot rows")
        check_wincache_plan(f"scattered 32k quad, {groups} groups", model.dev,
                            p.to_torch(dev), k1, x_dev, False)
    for name, m, cfg, nwin, kahan in f64_cases():
        with patched(X_RESIDENT_BYTES=1024):
            model = port.EhybSpmv(cfg, device=dev).setup(m)
        e, plan = model.dev, model.module.wincache
        check(e.nwin == nwin and plan is not None
              and plan.cell_val.dtype == torch.float64
              and plan.slot_rows == ehyb_wincache.SLOT_ROWS_F64
              and model.module.branch.startswith("streamed hbm"),
              f"{name}: branch {model.module.branch}, nwin={e.nwin}, the "
              f"window cache's plan in {plan.cell_val.dtype} at "
              f"{plan.slot_rows} slot rows")
        k1 = build_stream_cells(model.ehyb).to_torch(dev)
        x = np.ones(m.dimension) if m.val.max() >= 1e8 \
            else deterministic_x(m.dimension)
        x_dev = model.prepare_x(x)
        check_wincache_plan(name, e, plan, k1, x_dev, kahan)
        # the other slot budgets chip_wincache_sweep.py --f64 times, a
        # tight one (slices overflow a stage) and one group of 128 threads
        for slot_rows, groups in ((80, None), (160, None), (32, None),
                                  (None, 1)):
            other = ehyb_wincache.build_wincache_plan(
                model.ehyb, slot_rows=slot_rows, groups=groups)
            if slot_rows != 32 or other.stats["chunked_slices"]:
                check_wincache_plan(name, e, other.to_torch(dev), k1, x_dev,
                                    kahan)
        reset_launches()
        y = model.matvec(x)
        check(ehyb_wincache.wincache_body.launches == 1,
              f"{name}: the window cache launched once in a product")
        check_cancel_row(name, m, y, kahan)


def check_k5_k6(dev) -> None:
    """K1 where the JAX package would run K5 (the stream turned off) or K6
    (x past residency, no window-cache geometry, 1024-aligned windows):
    the flagship takes the TPU's branch and launches K1, timed there on the
    body it sees beside both bounds, its plain version and cuSPARSE."""
    m = generate.permuted(generate.poisson2d(96), seed=3)
    cases = [("K5", "resident-x", patched(env={"EHYB_STREAM_BODY": "0"}),
              port.EhybConfig()),
             ("K6", "windowed", patched(X_RESIDENT_BYTES=1024, NSLOT=8,
                                        HBM_NSLOT=8),
              port.EhybConfig(sliding_windows=False))]
    for kid, branch, ctx, cfg in cases:
        with ctx:
            model = port.EhybSpmv(cfg, device=dev).setup(m)
        check(model.module.branch == branch and model.module.wincache is None
              and model.module.cells is not None
              and model.config.body_layout == "sell_mw",
              f"{kid}: TPU branch {model.module.branch}, layout "
              f"{model.config.body_layout}")
        reset_launches()
        x = deterministic_x(m.dimension)
        y = model.matvec(x)
        launches = ehyb_stream.stream_body.launches
        err = rel_np(y, oracle_spmv(m, x))
        check(launches > 0 and err <= ORACLE_TOL,
              f"{kid}: K1 launched {launches} times, model vs oracle rel "
              f"{err:.3e}")
        print(f"  {kid}: K1 on the {model.config.body_layout} body of "
              f"{model.ehyb.ell_val.shape[0]} steps it runs there:")
        time_k1(model, {"dim": m.dimension}, dev, n_eager=50)


def drive(args, tol: float = ORACLE_TOL):
    """One main path through the CLI with the launch counts set to 0 just
    before it, held to ``tol`` against the oracle; returns (result, model,
    launches)."""
    reset_launches()
    t0 = time.perf_counter()
    code, result, model = cli.run(cli.build_parser().parse_args(args))
    wall = time.perf_counter() - t0
    launches = {"K1": ehyb_stream.stream_body.launches,
                "RX": route_xcache.route_xcache.launches,
                "K9": dia.dia_body.launches,
                "WC": ehyb_wincache.wincache_body.launches}
    print(json.dumps(result))
    check(code == 0 and result is not None, f"CLI exit code {code}")
    print(f"  wall {wall:.1f} s; setup seconds per phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      result["setup_seconds"].items()))
    check(result["rel_error"] <= tol,
          f"rel error vs exact-f64 oracle {result['rel_error']:.3e} "
          f"<= {tol}")
    print(f"  launches during the run: {launches}")
    # read right after the timed loop, beside its GFLOP/s
    result["card"] = card_state()
    print(f"  {result['gflops']:.2f} GFLOP/s; {result['card']}")
    return result, model, launches


def body_csr(e, n_rows: int, n_cols: int, dev) -> torch.Tensor:
    """The SELL body's own entries as CSR (row = slice * 128 + lane, the
    decoded column; reordered space): cuSPARSE's operand."""
    steps = e.ell_val.shape[0]
    step_slice = torch.searchsorted(
        e.slice_offset[1:], torch.arange(steps, dtype=torch.int32,
                                         device=dev), right=True)
    rows = step_slice.long()[:, None] * 128 \
        + torch.arange(128, device=dev)[None, :]
    keep = e.ell_val != 0
    return csr_of(rows[keep], body_gather_index(e).long()[keep],
                  e.ell_val[keep], n_rows, n_cols)


def other_x_mode(g0):
    """The geometry ``g0`` in the other x mode, with fewer rows a thread,
    then 128 threads, where its staged rows do not fit a block's shared
    memory."""
    mode = next(m for m in ehyb_stream.X_MODES if m != g0.x_mode)
    for rows in sorted(ehyb_stream.BUILT_ROWS, reverse=True):
        for threads in (g0.threads, 128):
            g = dataclasses.replace(g0, x_mode=mode, rows=min(rows, g0.rows),
                                    threads=threads)
            if ehyb_stream.smem_bytes(g) <= dia.SMEM_LIMIT_BYTES:
                return g
    raise RuntimeError(f"no geometry of K1 fits in the {mode} mode")


def time_k1(model, result, dev, cells=None, n: int = 100, n_plain: int = 20,
            n_eager: int = 200) -> dict:
    """K1 at a flagship path's shapes: kernel, plain version and cuSPARSE
    over the body's own entries (the padded body, uploaded for it), both
    bounds, the card's state, and the A/B of the two x modes (the default
    geometry with the other mode, in turns).  ``cells``, K1's plan on the
    card, defaults to the model's own."""
    p = model.module.cells if cells is None else cells
    kahan = model.module.kahan
    f64 = p.cell_val.dtype == torch.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    body_nnz = model.dev.body_nnz
    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    y_k = ehyb_stream.stream_body(p, x_dev, kahan)
    y_p = ehyb_stream.stream_body_plain(p, x_dev, kahan)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= tol, f"K1 vs plain rel {err:.3e} <= {tol} (max abs "
                      f"{max_abs:.3e}, {p.n_rb} row blocks, {x_dev.dtype})")
    if f64 and kahan:
        check(torch.equal(y_k, y_p), "K1 f64 Kahan bit for bit with its "
                                     "plain version (Neumaier, no atomics)")
    e = padded_body(model, dev)
    err = rel(y_k, ehyb_body(e, x_dev, compensated=kahan))
    check(err <= tol, f"K1 vs the padded body's plain version rel "
                      f"{err:.3e}")
    a = body_csr(e, y_k.shape[0], x_dev.shape[0], dev)
    del e
    y_l = torch.mv(a, x_dev)
    torch.cuda.synchronize()
    err = rel(y_l, y_p)
    check(err <= tol, f"cuSPARSE over K1's {a.values().numel()} body "
                      f"entries ({a.dtype}) vs plain rel {err:.3e}")
    g0 = ehyb_stream.GEOMETRY
    # the f64 kernel is built in the default geometry's x mode only
    other = None if f64 else other_x_mode(g0)
    if other is not None:
        err = rel(ehyb_stream._launch(p, x_dev, kahan, other), y_p)
        check(err <= tol, f"K1 with x {other.x_mode} vs plain rel "
                          f"{err:.3e}")
    del y_l
    kernel = lambda: ehyb_stream.stream_body(p, x_dev, kahan)  # noqa: E731
    plain = lambda: ehyb_stream.stream_body_plain(p, x_dev, kahan)  # noqa
    ms, plain_ms, turns = in_turns(kernel, plain, n, n_plain)
    ab = None if other is None else in_turns(
        kernel, lambda: ehyb_stream._launch(p, x_dev, kahan, other), n, n)[2]
    lib_ms = device_ms_per_call(lambda: torch.mv(a, x_dev), n)
    state = card_state()
    st = p.stats
    b = bound(st["layout_bytes"], 2 * body_nnz, dev, f64)
    same = same_work_bound(body_nnz, 2, x_dev.numel(), y_k.numel(), dev,
                           8 if f64 else 4)
    grid = ehyb_stream.grid_of(p, g0, kahan, dev)
    print(f"  K1 ({g0.threads} threads, {g0.rows} rows a thread, "
          f"{g0.blocks_per_sm} blocks/SM asked, x {g0.x_mode}; grid {grid}; "
          f"{st['n_rb']} row blocks, {st['n_pieces']} pieces, "
          f"{st['split_rbs']} cut, max width {st['max_width']}, max table "
          f"{st['max_table_rows']} rows) device ms per call (plain, kernel, "
          f"kernel, plain): {turns}")
    print(f"  cuSPARSE over its body {lib_ms:.4f} ms (K1 / cuSPARSE = "
          f"{ms / lib_ms:.3f}); layout bound {b['bound_ms']:.4f} ms "
          f"({st['layout_bytes']} B: cells {st['cell_bytes']}, maps "
          f"{st['map_bytes']}, x {st['x_bytes']}, y {st['y_bytes']}; "
          f"{b['bound_ms'] / ms:.3f} of it reached); same-work bound "
          f"{same['bound_ms']:.4f} ms ({same['bytes']} B; "
          f"{same['bound_ms'] / ms:.3f} reached); the padded body would "
          f"move {st['body_bytes']} B of cells")
    if ab is not None:
        print(f"  x-mode A/B ({other}, the default, the default, the "
              f"other): {ab}")
    print(f"  {state}")
    print(f"  eager calls back to back (host launch cost included): "
          f"K1 {ms_per_call(kernel, n_eager):.4f} ms, full apply "
          f"{ms_per_call(lambda: model.apply(x_dev), n_eager):.4f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(b, same))


def body_library_ms(model, x_dev: torch.Tensor, dev, n: int = 20) -> float:
    """cuSPARSE (``torch.mv`` on a CSR of x's type) over the body's own
    entries, from the padded body uploaded for it, device ms per call."""
    e = padded_body(model, dev)
    a = body_csr(e, model.dev.slice_win_start.shape[0] * 128,
                 x_dev.shape[0], dev)
    del e
    return device_ms_per_call(lambda: torch.mv(a, x_dev), n)


def time_wincache(model, result, dev, k1: dict = None, cells=None,
                  kahan: bool = None, library_ms: float = None) -> dict:
    """The window-cache body at a path's shapes against its plain version,
    beside cuSPARSE over the same entries and, where ``k1`` is given (from
    :func:`time_k1` with ``cells``, K1's plan of that body), K1 on the same
    body, with the cells it reads against the padded body's and both
    bounds: the bytes its layout moves, and the same work in any layout.
    ``kahan`` (default the model's) selects the variant timed; cuSPARSE
    is timed here unless ``k1`` or ``library_ms`` gives its time."""
    d = model.dev
    p = model.module.wincache
    kahan = model.module.kahan if kahan is None else kahan
    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    f64 = x_dev.dtype == torch.float64
    tol = F64_KERNEL_TOL if f64 else KERNEL_TOL
    y_k = ehyb_wincache.wincache_body(d, p, x_dev, kahan)
    y_p = ehyb_wincache.wincache_body_plain(d, p, x_dev, kahan)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= tol, f"window cache ({p.slot_rows} slot rows, "
                      f"{x_dev.dtype}{', Kahan' if kahan else ''}) vs plain "
                      f"rel {err:.3e} <= {tol} (max abs {max_abs:.3e})")
    if f64 and kahan:
        check(torch.equal(y_k, y_p), "window cache f64 Kahan bit for bit "
                                     "with its plain version (Neumaier, no "
                                     "atomics)")
    if cells is not None:
        y_1 = ehyb_stream.stream_body(cells, x_dev, kahan)
        torch.cuda.synchronize()
        err = rel(y_k, y_1)
        check(err <= tol, f"window cache vs K1 rel {err:.3e}, max abs "
                          f"{float((y_k - y_1).abs().max()):.3e}")
        del y_1
    del y_p
    ms, plain_ms, turns = in_turns(
        lambda: ehyb_wincache.wincache_body(d, p, x_dev, kahan),
        lambda: ehyb_wincache.wincache_body_plain(d, p, x_dev, kahan), 20, 2)
    if library_ms is None:
        library_ms = k1["library_ms"] if k1 is not None \
            else body_library_ms(model, x_dev, dev)
    st = p.stats
    check(st["compact_cells"] <= 1.1 * d.body_nnz,
          f"compact cells {st['compact_cells']} of {st['padded_cells']} "
          f"padded ({st['real_cells']} real; body nnz {d.body_nnz}): "
          f"{st['compact_cells'] / d.body_nnz:.5f} x the body's entries")
    lay = bound(st["layout_bytes"], 2 * d.body_nnz, dev, f64)
    same = same_work_bound(d.body_nnz, 2, x_dev.numel(), y_k.numel(), dev,
                           x_dev.element_size())
    blocks = ehyb_wincache.resident_blocks(p, kahan, dev)
    regs = ehyb_wincache.registers(p, kahan)
    print(f"  window cache ({p.slot_rows} slot rows, {p.groups * 128} "
          f"threads, {blocks} blocks/SM resident, {regs} registers; "
          f"{x_dev.dtype}{', Kahan' if kahan else ''}) device ms per call "
          f"(plain, kernel, kernel, plain): {turns}; "
          + (f"K1 on the same body {k1['ms']:.4f} ms; " if k1 else "")
          + f"cuSPARSE over the body {library_ms:.4f} ms; {card_state()}")
    print(f"  bounds: layout {lay['bound_ms']:.4f} ms ({st['layout_bytes']} "
          f"B: cells {st['cell_bytes']}, staged rows {st['staged_bytes']}, y "
          f"{st['y_bytes']}; {lay['bound_ms'] / ms:.3f} of it reached); same "
          f"work {same['bound_ms']:.4f} ms ({same['bytes']} B; "
          f"{same['bound_ms'] / ms:.3f} reached)")
    print(f"  plan: {st['n_blocks']} blocks, {st['n_stages']} stages, "
          f"{st['chunked_slices']} chunked slices; staged "
          f"{st['staged_bytes'] / st['x_bytes']:.3f} x the padded x; the "
          f"padded body would move {st['body_bytes']} B of cells")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bounds(lay, same))


def dia_csr(e, n_x: int, dev) -> torch.Tensor:
    """The DIA part's entries (nonzero values with x inside [0, n_x)) as
    CSR: cuSPARSE's operand."""
    dim_r = e.dia_val.shape[1]
    i = torch.arange(dim_r, device=dev)
    rows, cols, vals = [], [], []
    for k, d in enumerate(e.dia_offsets):
        keep = (e.dia_val[k] != 0) & (i + d >= 0) & (i + d < n_x)
        rows.append(i[keep])
        cols.append(i[keep] + d)
        vals.append(e.dia_val[k][keep])
    return csr_of(torch.cat(rows), torch.cat(cols), torch.cat(vals), dim_r,
                  n_x)


def time_dia(model, result, dev, n: int = 50) -> dict:
    """K9 at a flagship path's shapes (:func:`time_dia_part` on the model's
    DIA part and its x)."""
    return time_dia_part(model.dev, model.prepare_x(
        deterministic_x(result["dim"])), dev, n)


def time_dia_part(e, x_dev: torch.Tensor, dev, n: int = 50) -> dict:
    """K9 on the DIA part ``e`` (f32 or f64, as x): kernel, plain version
    and cuSPARSE over the same DIA entries, both bounds, and the A/B of the
    two x modes (the default geometry with the other mode, in turns)."""
    f64 = x_dev.dtype == torch.float64
    tol, vb = (F64_TOL, 8) if f64 else (KERNEL_TOL, 4)
    y_k = dia.dia_body(e, x_dev)
    y_p = dia.dia_body_plain(e, x_dev)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= tol, f"K9 vs plain rel {err:.3e} <= {tol} (max abs "
                      f"{max_abs:.3e}, {len(e.dia_offsets)} diagonals, "
                      f"{x_dev.dtype})")
    a = dia_csr(e, x_dev.shape[0], dev)
    y_l = torch.mv(a, x_dev)
    torch.cuda.synchronize()
    err = rel(y_l, y_p)
    check(err <= tol, f"cuSPARSE over the {a.values().numel()} DIA "
                      f"entries ({a.dtype}) vs plain rel {err:.3e}")
    g0 = dia.GEOMETRY
    other = dataclasses.replace(
        g0, x_mode=next(m for m in dia.X_MODES if m != g0.x_mode))
    y_o = dia._launch(e, x_dev, other)
    torch.cuda.synchronize()
    err = rel(y_o, y_p)
    check(err <= tol, f"K9 with x {other.x_mode} vs plain rel {err:.3e}")
    del y_l, y_o
    ms, plain_ms, turns = in_turns(lambda: dia.dia_body(e, x_dev),
                                   lambda: dia.dia_body_plain(e, x_dev),
                                   n, max(n // 10, 2))
    ab = in_turns(lambda: dia.dia_body(e, x_dev),
                  lambda: dia._launch(e, x_dev, other), n, n)[2]
    lib_ms = device_ms_per_call(lambda: torch.mv(a, x_dev), n)
    k, dim_r = e.dia_val.shape
    plan, _ = dia.device_plan(e.dia_offsets, dim_r, dim_r % 4 == 0, dev,
                              None, vb)
    st = plan.stats
    b = bound(st["layout_bytes"], 2 * k * dim_r, dev, f64)
    # the diagonals carry no column: each entry's value, x and y once
    same = same_work_bound(a.values().numel(), 0, x_dev.numel(), dim_r, dev,
                           vb)
    print(f"  K9 ({k} diagonals in {st['runs']} runs, {dim_r} rows; "
          f"{g0.threads} threads, {g0.quads} quads, step {g0.step}, x "
          f"{g0.x_mode}; grid {st['grid']}, tiles of {st['tile_rows']} "
          f"rows, {st['smem_bytes']} B of shared memory) device ms per call "
          f"(plain, kernel, kernel, plain): {turns}")
    print(f"  cuSPARSE over its entries {lib_ms:.4f} ms (K9 / cuSPARSE = "
          f"{ms / lib_ms:.3f}); layout bound {b['bound_ms']:.4f} ms "
          f"({st['layout_bytes']} B, {b['bound_by']}; "
          f"{b['bound_ms'] / ms:.3f} of it reached); same-work bound "
          f"{same['bound_ms']:.4f} ms ({same['bytes']} B; "
          f"{same['bound_ms'] / ms:.3f} reached)")
    print(f"  x-mode A/B ({other.x_mode}, {g0.x_mode}, {g0.x_mode}, "
          f"{other.x_mode}): {ab}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(b, same))


def time_routed(model, result, m: MatrixCOO, dev) -> dict:
    """The one-pass routed kernel at random_1m's shapes against its plain
    version and the plain K7/K8 pair, and the whole routed apply; cuSPARSE
    over the same entries in dst order (the same function) and over the
    whole matrix in the original order.  Bounds: the same work in any
    layout (the kernel's ``bound_ms``), and the bytes of the plan's layout
    (``layout_bound_ms``: the same work plus the partials and maps)."""
    check(len(model.applies) == 1, "random_1m runs one routed block")
    rm, ap = model.blocks[0], model.applies[0]
    p = ap.plan
    x_dev = model.prepare_x(deterministic_x(m.dimension))
    y_k = route_xcache.route_xcache(p, x_dev)
    y_again = route_xcache.route_xcache(p, x_dev)
    y_p = route_xcache.route_xcache_plain(p, x_dev)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(bool(torch.isfinite(y_k).all()) and err <= KERNEL_TOL
          and torch.equal(y_k, y_again),
          f"route_xcache vs plain rel {err:.3e} <= {KERNEL_TOL} (max abs "
          f"{max_abs:.3e}, {p.n_ent} entries), the same bits twice")
    del y_again
    d = rm.to_torch(device=dev)
    y_s = stages_plain(d, x_dev)
    torch.cuda.synchronize()
    err = rel(y_k, y_s)
    check(err <= KERNEL_TOL, f"route_xcache vs the plain K7/K8 pair rel "
                             f"{err:.3e}, max abs "
                             f"{float((y_k - y_s).abs().max()):.3e}")
    del d, y_s
    ms, plain_ms, turns = in_turns(
        lambda: route_xcache.route_xcache(p, x_dev),
        lambda: route_xcache.route_xcache_plain(p, x_dev), 50, 5)
    apply_ms = device_ms_per_call(lambda: model.apply(x_dev), 20)
    # the same function in one library call: CSR over the plan's entries
    row, col = route_xcache.plan_rows_cols(p)
    a_dst = csr_of(row, col, p.ent_val, p.n_rows, p.n_x)
    del row, col
    err = rel(torch.mv(a_dst, x_dev), y_p)
    check(err <= KERNEL_TOL, f"cuSPARSE over the same entries in dst order "
                             f"vs plain rel {err:.3e}")
    lib_ms = device_ms_per_call(lambda: torch.mv(a_dst, x_dev), 20)
    del a_dst
    st = p.stats
    lay = bound(st["layout_bytes"], 2 * p.n_ent, dev)
    # 1M columns need 32-bit column indices
    same = same_work_bound(m.nnz, 4, m.dimension, m.n_rows, dev)
    # the routed engine's first yardstick: one cuSPARSE CSR matvec over the
    # whole matrix, in the original ordering
    a = csr_of(torch.as_tensor(m.row, device=dev).long(),
               torch.as_tensor(m.col, device=dev).long(),
               torch.as_tensor(m.val, dtype=torch.float32, device=dev),
               m.n_rows, m.n_cols)
    x = torch.as_tensor(deterministic_x(m.dimension), dtype=torch.float32,
                        device=dev)
    y_l = torch.mv(a, x).cpu().numpy()
    err = rel_np(y_l, oracle_spmv(m, deterministic_x(m.dimension)))
    check(err <= ORACLE_TOL, f"cuSPARSE over random_1m vs oracle rel "
                             f"{err:.3e}")
    whole_ms = device_ms_per_call(lambda: torch.mv(a, x), 20)
    print(f"  route_xcache device ms (plain, kernel, kernel, plain): {turns}")
    print(f"  plan: {st['n_tiles']} blocks ({st['n_groups']} groups of "
          f"{st['group_rows']} rows x {st['parts']} parts), "
          f"{st['chunk_windows']} windows per chunk, {route_xcache.THREADS} "
          f"threads, {st['smem_bytes']} B of shared memory; "
          f"{st['n_segs']} segments, "
          f"{st['passes']} passes; {st['entries']} entries "
          f"({st['spilled']} spilled), largest tile "
          f"{st['max_tile_entries']} (mean {st['mean_tile_entries']:.0f}); "
          f"staged {st['staged_bytes'] / st['x_bytes']:.3f} x x "
          f"({st['staged_bytes']} B from L2); built in "
          f"{result['setup_seconds']['route_plan']:.2f} s")
    print(f"  bounds: layout {lay['bound_ms']:.4f} ms ({st['layout_bytes']} "
          f"B: entries {st['ent_bytes']}, x {st['x_bytes']}, partials "
          f"{st['partial_bytes']}, y {st['y_bytes']}, maps "
          f"{st['map_bytes']}; {lay['bound_ms'] / ms:.3f} of it reached); "
          f"same work {same['bound_ms']:.4f} ms ({same['bytes']} B; "
          f"{same['bound_ms'] / ms:.3f} reached)")
    print(f"  cuSPARSE over the same entries in dst order {lib_ms:.4f} ms "
          f"(route_xcache / cuSPARSE = {ms / lib_ms:.3f}); over the whole "
          f"matrix in the original order {whole_ms:.4f} ms")
    print(f"  routed apply (route_xcache + epilogue) {apply_ms:.4f} ms device "
          f"time: apply / cuSPARSE = {apply_ms / whole_ms:.3f}; the apply's "
          f"device GFLOP/s {2e-6 * m.nnz / apply_ms:.2f}, cuSPARSE's "
          f"{2e-6 * m.nnz / whole_ms:.2f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(lay, same))


def check_loop(res: dict, model, dev) -> dict:
    """The chained loop of one main path as CUDA-graph replays against the
    eager loop: the same y at eps 0 and 0.1 over 3 iterations (rel <=
    LOOP_TOL), then both loops timed in turns (eager, graph, graph, eager)
    at the CLI's iteration count, with no capture inside the timed calls.
    Returns the graph's and the eager loop's seconds per iteration."""
    x_dev = model.prepare_x(deterministic_x(res["dim"]))
    for eps in (0.0, 0.1):
        err = rel(model.iterate(x_dev, 3, eps),
                  model.iterate_eager(x_dev, 3, eps))
        check(err <= LOOP_TOL, f"{res['matrix']}: graph vs eager loop at eps "
                               f"{eps}, 3 iterations: rel {err:.3e}")
    n = res["iters"]
    model.iterate(x_dev, n)          # every graph of the row captured
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    captures = CapturedGraph.captures
    loops = {"eager": model.iterate_eager, "graph": model.iterate}
    readings = {k: [] for k in loops}
    for k in ("eager", "graph", "graph", "eager"):
        readings[k].append(timed_seconds(lambda: loops[k](x_dev, n), dev) / n)
    check(CapturedGraph.captures == captures,
          f"{res['matrix']}: no graph captured inside the timed calls "
          f"({captures} before, {CapturedGraph.captures} after)")
    out = {k: sum(v) / len(v) for k, v in readings.items()}
    gf = {k: 2e-9 * res["nnz"] / t for k, t in out.items()}
    print(f"  {res['matrix']}: graph {1e6 * out['graph']:.2f} us/iter "
          f"({gf['graph']:.2f} GFLOP/s; readings "
          + ", ".join(f"{1e6 * t:.2f}" for t in readings["graph"])
          + f"), eager {1e6 * out['eager']:.2f} us/iter ({gf['eager']:.2f} "
            "GFLOP/s; readings "
          + ", ".join(f"{1e6 * t:.2f}" for t in readings["eager"])
          + f"); graph/eager {out['graph'] / out['eager']:.3f}; peak device "
            f"memory in the loops {torch.cuda.max_memory_allocated(dev)} B; "
          + card_state())
    check(out["graph"] <= LOOP_SLACK * out["eager"],
          f"{res['matrix']}: the graph loop no slower than the eager loop "
          f"(within {LOOP_SLACK:g}x)")
    return out


def profile_path(name: str, result: dict, model, graph_s: float,
                 n: int = 20) -> None:
    """Device time by kernel over ``n`` iterations of a main path's graph
    loop (``torch.profiler``), the device's busy share of the unprofiled
    graph loop's time per iteration, and ``phase_breakdown``'s device time
    per phase.  Where the profiler sees no kernel inside the graph
    replays, the split comes from the eager loop instead (said so)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    source = "graph replays"
    for loop in (model.iterate, model.iterate_eager):
        loop(x_dev, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop(x_dev, n)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0]
        if kernels:
            break
        source = "the eager loop (the profiler saw no kernel in the graph)"
    busy_us = sum(e.device_time_total for e in kernels) / n
    wall_us = 1e6 * graph_s
    print(f"  {name}: device busy {busy_us:.2f} us per iteration "
          f"(torch.profiler over {source}, {n} iterations) of "
          f"{wall_us:.2f} us of the unprofiled graph loop: "
          f"{100 * busy_us / wall_us:.1f}% busy")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / n:10.2f} us  x{e.count / n:g}  "
              f"{e.key[:90]}")
    phases = phase_breakdown(model, x_dev, iters=n)
    print("    phase_breakdown (device us per call, CUDA graph replay): "
          + ", ".join(f"{k} {1e6 * v:.2f}" for k, v in phases.items()))


def check_cg(model, dev) -> None:
    """CG on a main path's model, b = A·x_true (x_true = deterministic_x),
    with and without Jacobi: the graph solve against the eager one (counts
    within 1%), the true residual from the exact-f64 oracle within
    ``10 * CG_TOL``, the kernels launched in the graph, µs per iteration;
    then a checkpointed solve cut at 500 iterations and resumed."""
    m = model.m
    b = oracle_spmv(m, deterministic_x(m.dimension))
    nb = float(np.linalg.norm(b))

    def true_rel(x: np.ndarray) -> float:
        return float(np.linalg.norm(b - oracle_spmv(m, x))) / nb

    for pre in ("none", "jacobi"):
        cg = CgSolver(model, pre)
        cg.solve(b, tol=CG_TOL, max_iters=CG_MAX)          # captures
        reset_launches()
        captures = CapturedGraph.captures
        t0 = time.perf_counter()
        g = cg.solve(b, tol=CG_TOL, max_iters=CG_MAX)
        t_g = time.perf_counter() - t0
        check(CapturedGraph.captures == captures and
              ehyb_stream.stream_body.launches > 0
              and dia.dia_body.launches > 0,
              f"CG ({pre}): the graph solve replayed its graphs (no capture) "
              f"with K1 launched {ehyb_stream.stream_body.launches} times and "
              f"K9 {dia.dia_body.launches} times")
        t0 = time.perf_counter()
        e = cg.solve_eager(b, tol=CG_TOL, max_iters=CG_MAX)
        t_e = time.perf_counter() - t0
        check(g.converged and e.converged
              and abs(g.iterations - e.iterations) <= 0.01 * e.iterations,
              f"CG ({pre}) to {CG_TOL:g}: graph {g.iterations} iterations, "
              f"eager {e.iterations}, both converged")
        tr = true_rel(g.x)
        check(tr <= 10 * CG_TOL,
              f"CG ({pre}): true residual |b - A x| / |b| = {tr:.3e} (exact "
              f"f64 oracle) <= {10 * CG_TOL:g}; eager's {true_rel(e.x):.3e}")
        print(f"  CG ({pre}), the solve's wall over its iterations: graph "
              f"{1e6 * t_g / g.iterations:.2f} us per iteration "
              f"({t_g:.4f} s), eager {1e6 * t_e / e.iterations:.2f} us per "
              f"iteration ({t_e:.4f} s); eager/graph "
              f"{t_e / e.iterations / (t_g / g.iterations):.2f}x; "
              + card_state())
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cg.npz")
        r1 = CgSolver(model).solve(b, tol=CG_TOL, max_iters=500,
                                   checkpoint_every=500, checkpoint_path=path)
        check(not r1.converged and r1.iterations == 500
              and os.path.exists(path),
              f"checkpointed CG cut at {r1.iterations} iterations")
        saved = int(np.load(path)["iterations"])
        check(saved == 500, f"the checkpoint holds {saved} iterations")
        r2 = CgSolver(model).solve(b, tol=CG_TOL, max_iters=CG_MAX,
                                   checkpoint_every=500,
                                   checkpoint_path=path)
        tr = true_rel(r2.x)
        check(r2.converged and r2.iterations > 500 and tr <= 10 * CG_TOL
              and not os.path.exists(path),
              f"resumed to convergence at {r2.iterations} iterations, true "
              f"residual {tr:.3e}, checkpoint removed")


def check_power(model) -> None:
    """Power iteration, 100 steps: the graph against the eager loop."""
    pw = PowerIteration(model)
    pw.run(iters=2)                                        # captures
    t0 = time.perf_counter()
    _, lam_g = pw.run(iters=100)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, lam_e = pw.run_eager(iters=100)
    t_e = time.perf_counter() - t0
    err = abs(lam_g - lam_e) / abs(lam_e)
    check(err <= POWER_TOL, f"power iteration, 100 steps: lambda graph "
                            f"{lam_g!r}, eager {lam_e!r}: rel {err:.3e}")
    print(f"  a run of 100 steps, the start vector's host work included: "
          f"graph {1e3 * t_g:.2f} ms, eager {1e3 * t_e:.2f} ms")


# ---------------------------------------------------------------------------
# Phase 16: the sharded path.
# ---------------------------------------------------------------------------

def rb_rows(rbs: torch.Tensor) -> torch.Tensor:
    """The y rows of row blocks ``rbs``."""
    return (rbs.long()[:, None] * 32
            + torch.arange(32, device=rbs.device)).reshape(-1)


def check_k1_list(name: str, plan, rbs: np.ndarray, x: np.ndarray,
                  kahan: bool, dev) -> None:
    """K1 over the row-block list ``rbs`` of ``plan`` (a host
    StreamCellsPlan, f32 or f64 values) at every geometry of
    :func:`k1_geometries` for its type, into a y of sentinels: the listed
    rows against the plain version on the card (within KERNEL_TOL, F64_TOL
    in f64) and on the CPU (bit for bit where Kahan is off or the type is
    f64), every other row untouched."""
    p, p_cpu = plan.to_torch(dev), plan.to_torch()
    f64 = plan.cell_val.dtype == np.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    exact = f64 or not kahan
    x_dev = torch.as_tensor(x, dtype=p.cell_val.dtype, device=dev)
    lst = torch.as_tensor(np.ascontiguousarray(rbs, dtype=np.int32),
                          device=dev)
    fill = -7.0
    y_p = torch.full((p.n_rb * 32,), fill, dtype=x_dev.dtype, device=dev)
    ehyb_stream.stream_body_plain(p, x_dev, kahan, rb_list=lst, out=y_p)
    y_cpu = torch.full((p.n_rb * 32,), fill, dtype=x_dev.dtype)
    ehyb_stream.stream_body_plain(p_cpu, x_dev.cpu(), kahan,
                                  rb_list=lst.cpu(), out=y_cpu)
    rows = rb_rows(lst)
    other = torch.ones(p.n_rb * 32, dtype=torch.bool, device=dev)
    other[rows] = False
    worst, same = 0.0, True
    for g in k1_geometries(f64):
        y = torch.full((p.n_rb * 32,), fill, dtype=x_dev.dtype, device=dev)
        ehyb_stream._launch(p, x_dev, kahan, g, rb_list=lst, out=y)
        torch.cuda.synchronize()
        err = rel(y[rows], y_p[rows]) if rows.numel() else 0.0
        if not bool(torch.isfinite(y).all()) or err > tol \
                or not bool((y[other] == fill).all()):
            check(False, f"K1 list {name} at {g}: rel {err:.3e}, rows "
                         "outside the list written")
        worst = max(worst, err)
        same = same and torch.equal(y.cpu(), y_cpu)
    check(not exact or same,
          f"K1 list {name} ({len(rbs)} of {p.n_rb} row blocks, "
          f"{plan.stats['split_rbs']} of the plan's cut for the 16-bit "
          f"range{', f64' if f64 else ''}{', Kahan' if kahan else ''}): "
          f"{len(k1_geometries(f64))} geometries, listed rows vs plain rel "
          f"<= {worst:.3e}, the others untouched"
          + ("; bit for bit with the plain version on the CPU" if exact
             else ""))


def check_k1_lists(dev) -> None:
    """16a: K1 with a row-block list against its plain version: a sharded
    scrambled stencil's interior, boundary, both and empty lists at two
    ranks; the row blocks cut for the 16-bit range; Kahan; each of them
    also in f64 (the plans' values in f64, x random in f64)."""
    m = generate.permuted(generate.poisson2d(96), seed=3)
    sh = plan_sharded(m, port.EhybConfig(**SHARDED_CFG), 2).sharded
    rng = np.random.default_rng(16)
    for d in range(2):
        sc = build_shard_cells(shard_matrix(sh, d), sh)
        check(sc.interior.size > 0 and sc.boundary.size > 0,
              f"scrambled stencil shard {d}/2: {sc.interior.size} interior, "
              f"{sc.boundary.size} boundary row blocks")
        n_x = sh.rows_per_dev + 2 * sh.window_rows
        x = rng.standard_normal(n_x)
        lists = {"interior": sc.interior, "boundary": sc.boundary,
                 "both": np.concatenate([sc.interior, sc.boundary]),
                 "empty": np.zeros(0, np.int32)}
        for plan, tag in ((sc.plan, ""), (plan_f64(sc.plan), " f64")):
            for kind, rbs in lists.items():
                check_k1_list(f"shard {d} {kind}{tag}", plan, rbs, x, False,
                              dev)
            check_k1_list(f"shard {d} boundary kahan{tag}", plan,
                          sc.boundary, x, True, dev)
    e = edge_body()
    plan = build_stream_cells(e)
    cut = np.unique(plan.piece[plan.n_rb:-1, PIECE_RB])
    rbs = np.union1d(cut, rng.permutation(plan.n_rb)[: plan.n_rb // 2])
    check(cut.size > 0, f"edge body: {cut.size} row blocks cut, listed")
    x = rng.standard_normal(e.padded_x_rows)
    for kahan in (False, True):
        for p, tag in ((plan, ""), (plan_f64(plan), " f64")):
            check_k1_list(f"edge body{' kahan' if kahan else ''}{tag}", p,
                          rng.permutation(rbs).astype(np.int32), x, kahan,
                          dev)


def plan_f64(plan):
    """A K1 host plan with its values in f64 (for the f64 list variants)."""
    return dataclasses.replace(plan, cell_val=plan.cell_val.astype(
        np.float64))


def list_work(p, rbs: np.ndarray, n_x: int, dev) -> dict:
    """What K1 over the list ``rbs`` of the plan ``p`` (on the card) must
    move: its cells, pieces and table rows, the list, the x rows of its
    tables and its y rows; the real entries (nonzero cells) with their
    decoded columns; and those entries as a CSR of the plan's rows
    (cuSPARSE's operand).  Values, x and y count the plan's value size."""
    vb = p.cell_val.element_size()
    plan = types.SimpleNamespace(
        piece=p.piece.cpu().numpy(), rows=p.rows.cpu().numpy(),
        cell_val=p.cell_val.cpu().numpy(), cell_idx=p.cell_idx.cpu().numpy(),
        n_rb=p.n_rb)
    piece = plan.piece.astype(np.int64)
    sel = np.isin(piece[:-1, PIECE_RB], rbs)
    n_cells = np.diff(piece[:, PIECE_CELL])
    n_rows = np.diff(piece[:, PIECE_ROW])
    cell_sel = np.repeat(sel, n_cells)
    row_sel = np.repeat(sel, n_rows)
    x_rows = np.unique(plan.rows[row_sel])
    pid = np.repeat(np.arange(len(piece) - 1), n_cells)
    cell = np.flatnonzero(cell_sel & (plan.cell_val != 0))
    first = piece[pid[cell]]
    idx = plan.cell_idx[cell].astype(np.int64) & 0xFFFF
    col = plan.rows[first[:, PIECE_ROW] + (idx >> 7)].astype(np.int64) \
        * 128 + (idx & 127)
    row = first[:, PIECE_RB] * 32 + (cell - first[:, PIECE_CELL]) % 32
    layout = (int(cell_sel.sum()) * (vb + 2) + int(sel.sum()) * 16
              + int(row_sel.sum()) * 4 + rbs.size * 4
              + x_rows.size * 128 * vb + rbs.size * 32 * vb)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    a = csr_of(t(row), t(col), t(plan.cell_val[cell]), plan.n_rb * 32, n_x)
    return dict(layout_bytes=layout, nnz=int(cell.size),
                n_cols=int(np.unique(col).size), csr=a)


def time_k1_list(p, rbs: np.ndarray, x_dev: torch.Tensor, kahan: bool, dev,
                 n: int = 100, n_plain: int = 10) -> dict:
    """K1 over one row-block list at its real shapes: kernel and plain
    version in turns, cuSPARSE over the same entries, the layout and
    same-work bounds."""
    lst = torch.as_tensor(np.ascontiguousarray(rbs, dtype=np.int32),
                          device=dev)
    f64 = x_dev.dtype == torch.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    y = torch.zeros(p.n_rb * 32, dtype=x_dev.dtype, device=dev)
    y_p = torch.zeros(p.n_rb * 32, dtype=x_dev.dtype, device=dev)
    ehyb_stream.stream_body(p, x_dev, kahan, rb_list=lst, out=y)
    ehyb_stream.stream_body_plain(p, x_dev, kahan, rb_list=lst, out=y_p)
    w = list_work(p, rbs, x_dev.numel(), dev)
    y_l = torch.mv(w["csr"], x_dev)
    torch.cuda.synchronize()
    rows = rb_rows(lst)
    max_abs = float((y - y_p).abs().max())
    err = rel(y[rows], y_p[rows])
    check(err <= tol and rel(y_l[rows], y_p[rows]) <= tol,
          f"K1 over {len(rbs)} listed row blocks vs plain rel {err:.3e} "
          f"(max abs {max_abs:.3e}); cuSPARSE over their {w['nnz']} entries "
          f"rel {rel(y_l[rows], y_p[rows]):.3e}")
    ms, plain_ms, turns = in_turns(
        lambda: ehyb_stream.stream_body(p, x_dev, kahan, rb_list=lst, out=y),
        lambda: ehyb_stream.stream_body_plain(p, x_dev, kahan, rb_list=lst,
                                              out=y_p), n, n_plain)
    lib_ms = device_ms_per_call(lambda: torch.mv(w["csr"], x_dev), n)
    b = bound(w["layout_bytes"], 2 * w["nnz"], dev, f64)
    same = same_work_bound(w["nnz"], 2, w["n_cols"], rows.numel(), dev,
                           x_dev.element_size())
    print(f"    device ms (plain, kernel, kernel, plain): {turns}; cuSPARSE "
          f"{lib_ms:.4f} ms; layout bound {b['bound_ms']:.4f} ms "
          f"({w['layout_bytes']} B, {b['bound_ms'] / ms:.3f} reached); "
          f"same-work bound {same['bound_ms']:.4f} ms ({same['bytes']} B)")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(b, same),
                row_blocks=int(len(rbs)), nnz=w["nnz"])


def time_graph_loops(models: dict, x: dict, nnz: int, dev, card: str,
                     n: int = 500) -> dict:
    """The graph loops of ``models`` (name → model, every graph captured
    first) timed in turns (a, b, b, a): GFLOP/s each, beside the card
    (``card``: its name and power limit) and its state."""
    for k, mod in models.items():
        mod.iterate(x[k], n)
    torch.cuda.synchronize(dev)
    captures = CapturedGraph.captures
    a, b = list(models)
    readings = {k: [] for k in models}
    for k in (a, b, b, a):
        readings[k].append(timed_seconds(
            lambda: models[k].iterate(x[k], n), dev) / n)
    check(CapturedGraph.captures == captures,
          "no graph captured inside the timed loops")
    out = {k: 2e-9 * nnz * len(v) / sum(v) for k, v in readings.items()}
    print("  graph loop, in turns: " + "; ".join(
        f"{k} {out[k]:.2f} GFLOP/s (us/iter "
        + ", ".join(f"{1e6 * t:.2f}" for t in readings[k]) + ")"
        for k in models) + f"; {card}; {card_state()}")
    return out


def sharded_rank(rank: int, world: int, m, host, extra: bool) -> dict:
    """One rank of the sharded path on the card (16c/16d, 19d): the sharded
    EHYB model on ``host`` (in its config's dtype; its y against nothing
    here: rank 0 returns the gathered y), its row-block counts, K1's
    launches in one apply, the eager chained loop against one apply, and
    the host-clock microseconds per eager apply; with ``extra``, the
    sharded routed engine and the sharded degree split on small matrices,
    against the oracle."""
    dev = rank_device("cuda", rank)
    cfg = port.EhybConfig(**SHARDED_CFG)
    model = ShardedEhybSpmv(cfg, device=dev).setup(m, host)
    x = deterministic_x(m.dimension)
    xd = model.prepare_x(x)
    reset_launches()
    y = model.apply(xd)
    torch.cuda.synchronize(dev)
    launches = ehyb_stream.stream_body.launches
    y_host = model.recover_y(y)
    err_loop = rel(model.iterate(xd, 3), y)
    torch.distributed.barrier()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        model.apply(xd)
    torch.cuda.synchronize(dev)
    us = 1e6 * (time.perf_counter() - t0) / n
    st = model.module.cells.stats
    out = dict(rank=rank, interior=st["n_interior"],
               boundary=st["n_boundary"], S=model.sharded.exchange_slots,
               staged=model.module.ex.staged, loop=model.loop,
               launches=launches, err_loop=err_loop, us_per_apply=us,
               y=y_host if rank == 0 else None)
    if extra:
        rm = random_coo(131072, 8, seed=21)
        xr = deterministic_x(rm.dimension)
        r = ShardedRoutedSpmv(port.EhybConfig(), device=dev).setup(rm)
        reset_launches()
        out["routed_err"] = rel_np(r.matvec(xr), oracle_spmv(rm, xr))
        out["routed_launches"] = route_xcache.route_xcache.launches
        mh = generate.random_general(65536, 24, seed=4, power_law=0.7)
        xh = deterministic_x(mh.dimension)
        h = ShardedDegreeSplitSpmv(port.EhybConfig(**SHARDED_CFG),
                                   device=dev).setup(mh, threshold=32)
        reset_launches()
        out["split_err"] = rel_np(h.matvec(xh), oracle_spmv(mh, xh))
        out["split_launches"] = (ehyb_stream.stream_body.launches,
                                 route_xcache.route_xcache.launches)
        out["split_nnz"] = (h.e.m.nnz, h.r.m.nnz)
    return out


def check_sharded(m, model_flat, m_gather, dev, card: str) -> dict:
    """16b-16d: the sharded path; returns the sharded K1's JSON fields.
    ``card`` is the card's name and power limit, printed beside the
    graph loops' GFLOP/s."""
    cfg = port.EhybConfig(**SHARDED_CFG)
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)

    print(f"  16b: ShardedEhybSpmv at world 1 on {SHARDED_MATRIX} (no "
          "process group), through the graph loop")
    host1 = plan_sharded(m, cfg, 1)
    print(f"  host setup {host1.seconds}; layout "
          f"{host1.config.body_layout}, {host1.config.windows_per_subtile} "
          f"windows a sub-tile")
    model = ShardedEhybSpmv(cfg, device=dev).setup(m, host1)
    cells = model.module.cells
    st = cells.stats
    check(model.loop == "graph" and st["n_interior"] == 0
          and st["n_boundary"] == cells.plan.n_rb,
          f"world 1: loop {model.loop}, {st['n_interior']} interior and "
          f"{st['n_boundary']} boundary row blocks (all boundary, as the "
          "JAX package at D=1)")
    xd = model.prepare_x(x)
    n_iter = 500
    reset_launches()
    y = model.recover_y(model.apply(xd))
    model.iterate(xd, n_iter)
    torch.cuda.synchronize(dev)
    launches = ehyb_stream.stream_body.launches
    check(launches > 0, f"{SK1['name']} launched {launches} times in one "
                        f"apply and the {n_iter}-step graph loop")
    err = rel_np(y, want)
    check(err <= ORACLE_TOL, f"world 1 vs oracle rel {err:.3e} <= "
                             f"{ORACLE_TOL}")
    y_flat = model_flat.matvec(x)
    err = rel_np(y, y_flat)
    check(err <= KERNEL_TOL, f"world 1 vs the flagship ehyb rel {err:.3e} "
                             f"<= {KERNEL_TOL}")
    time_graph_loops({"ehyb": model_flat, "ehyb_sharded D=1": model},
                     {"ehyb": model_flat.prepare_x(x),
                      "ehyb_sharded D=1": xd}, m.nnz, dev, card)
    print(f"  the sharded K1 at D=1 over all {st['n_boundary']} row blocks "
          "(the boundary list):")
    sk1 = time_k1_list(cells.plan, cells.boundary.cpu().numpy(),
                       model.module.ex.x_buf, model.module.kahan, dev)
    y1 = y
    del model

    print(f"  16c: D=2 and D=4 gloo ranks on the one card, on "
          f"{SHARDED_MATRIX} (the ranks share cuda:0, so their times are "
          "not scaling)")
    any_s = False
    hosts = {}
    for world in (2, 4):
        hosts[world] = host = plan_sharded(m, cfg, world)
        print(f"  D={world}: host setup {host.seconds}; layout "
              f"{host.config.body_layout}; R={host.sharded.rows_per_dev}; "
              f"exchange slots S={host.sharded.exchange_slots}")
        res = launch.spawn(sharded_rank, world, "gloo",
                           args=(m, host, world == 2),
                           timeout=RANK_TIMEOUT_S)
        for r in res:
            print(f"    rank {r['rank']}: {r['interior']} interior, "
                  f"{r['boundary']} boundary row blocks; S={r['S']}; "
                  f"staged {r['staged']}; loop {r['loop']}; K1 launches in "
                  f"one apply {r['launches']}; eager loop vs apply rel "
                  f"{r['err_loop']:.3e}; {r['us_per_apply']:.1f} us per "
                  "eager apply")
            check(r["interior"] > 0 and r["boundary"] > 0
                  and r["launches"] == 2 and r["loop"] == "eager"
                  and r["err_loop"] <= LOOP_TOL,
                  f"D={world} rank {r['rank']}: both kinds of row block, "
                  "two K1 launches an apply, the eager loop")
        any_s = any_s or res[0]["S"] > 0
        err, err1 = rel_np(res[0]["y"], want), rel_np(res[0]["y"], y1)
        check(err <= ORACLE_TOL and err1 <= KERNEL_TOL,
              f"D={world} vs oracle rel {err:.3e} <= {ORACLE_TOL}, vs "
              f"world 1 rel {err1:.3e} <= {KERNEL_TOL}")
        if world == 2:
            r0 = res[0]
            check(r0["routed_err"] <= ORACLE_TOL
                  and r0["routed_launches"] > 0,
                  f"16d: ShardedRoutedSpmv at D=2 (random 131072 x 8) vs "
                  f"oracle rel {r0['routed_err']:.3e}, "
                  f"{r0['routed_launches']} routed launches on rank 0")
            check(r0["split_err"] <= 1e-5 and min(r0["split_nnz"]) > 0
                  and min(r0["split_launches"]) > 0,
                  f"16d: ShardedDegreeSplitSpmv at D=2 (power law 65536 x "
                  f"24) vs oracle rel {r0['split_err']:.3e} <= 1e-05; nnz "
                  f"(body, routed) {r0['split_nnz']}; launches (K1, routed) "
                  f"{r0['split_launches']}")
    check(any_s, "the compressed exchange ran (S > 0) at D >= 2")

    print("  the sharded K1 per rank at D=4, each list on its own (the "
          "shard's plan, x_ext random):")
    sh4 = hosts[4].sharded
    rng = np.random.default_rng(4)
    per_rank = []
    for r in range(4):
        sc = build_shard_cells(shard_matrix(sh4, r), sh4)
        p = sc.plan.to_torch(dev)
        x_ext = torch.as_tensor(rng.standard_normal(
            sh4.rows_per_dev + 2 * sh4.window_rows + 4 * sh4.exchange_slots),
            dtype=torch.float32, device=dev)
        for kind in ("interior", "boundary"):
            print(f"   rank {r} {kind}:")
            t = time_k1_list(p, getattr(sc, kind), x_ext, False, dev,
                             n=50, n_plain=5)
            per_rank.append(dict(rank=r, kind=kind, ms=t["ms"],
                                 plain_ms=t["plain_ms"],
                                 library_ms=t["library_ms"],
                                 bound_ms=t["bound_ms"],
                                 layout_bound_ms=t["layout_bound_ms"],
                                 row_blocks=t["row_blocks"]))
    del hosts

    print(f"  16d: ShardedRoutedSpmv at world 1 on random_1m")
    xg = deterministic_x(m_gather.dimension)
    rmodel = ShardedRoutedSpmv(port.EhybConfig(), device=dev).setup(m_gather)
    reset_launches()
    err = rel_np(rmodel.matvec(xg), oracle_spmv(m_gather, xg))
    check(err <= ORACLE_TOL and route_xcache.route_xcache.launches > 0,
          f"world 1 routed vs oracle rel {err:.3e} <= {ORACLE_TOL}; "
          f"{route_xcache.route_xcache.launches} routed launches; "
          f"setup {rmodel.setup_seconds}")
    return dict(launches=launches, **sk1, d4_per_rank=per_rank)


# ---------------------------------------------------------------------------
# Phases 17 and 18: the precision mode and the small gate.
# ---------------------------------------------------------------------------

def check_f64_small(dev) -> None:
    """K1 and K9 in f64 against their f64 plain versions on small matrices
    that reach every f64 variant: K1 on the layouts of :func:`f64_cases`
    (the flagship at ``dtype="float64"``: nwin 1/2/4, plain and Kahan, the
    f64 cancellation matrix, where only Kahan keeps row 0), on the edge
    body (cut row blocks, a zero-width one, a ragged slice; plain and
    Kahan) and on the precision mode's stress matrix end to end (rel <=
    F64_TOL against the oracle); K9 through :func:`check_dia_small` in f64
    (odd and negative offsets, both x modes, the guarded edges, fem3d_16
    in the precision mode)."""
    for name, m, cfg, nwin, kahan in f64_cases():
        model = port.EhybSpmv(cfg, device=dev).setup(m)
        check(model.dev.nwin == nwin and model.module.cells is not None
              and model.module.kahan == kahan
              and model.module.cells.cell_val.dtype == torch.float64,
              f"{name}: layout nwin={model.dev.nwin}, K1's plan in f64")
        x = np.ones(m.dimension) if m.val.max() >= 1e8 \
            else deterministic_x(m.dimension)
        check_k1_case(name, model.ehyb, model.prepare_x(x).cpu().numpy(),
                      kahan, dev, model.module.cells)
        reset_launches()
        y = model.matvec(x)
        check(ehyb_stream.stream_body.launches == 1,
              f"{name}: K1 launched once in a product")
        check_cancel_row(name, m, y, kahan)
    e = edge_body()
    rng = np.random.default_rng(3)
    e.ell_val = np.where(e.ell_val != 0, rng.standard_normal(
        e.ell_val.shape), 0.0)
    x = rng.standard_normal(e.padded_x_rows)
    for kahan in (False, True):
        check_k1_case(f"edge body f64{' kahan' if kahan else ''}", e, x,
                      kahan, dev)
    m = stress_matrix()
    model = port.EhybSpmv(port.EhybConfig(dword_values=True),
                          device=dev).setup(m)
    check(model.module.branch == "dword xla"
          and model.module.wincache is None,
          f"stress: precision-mode branch {model.module.branch}")
    x = deterministic_x(m.dimension)
    check_k1_case("stress (precision mode)", model.ehyb,
                  model.prepare_x(x).cpu().numpy(), False, dev,
                  model.module.cells)
    reset_launches()
    err = rel_np(model.matvec(x), oracle_spmv(m, x))
    check(err <= F64_TOL and ehyb_stream.stream_body.launches == 1,
          f"stress: precision mode vs oracle rel {err:.3e} <= {F64_TOL}, K1 "
          f"launched {ehyb_stream.stream_body.launches} time")
    check_dia_small(dev, torch.float64)


def check_small_gate(dev, card: str) -> dict:
    """The small gate on the card: ``ehyb`` on each of SMALL_GATE_MATRICES
    with a fresh cache directory: the A/B's verdict, both GFLOP/s, the
    engine returned (the one the 5% rule picks from those numbers) and its
    error against the oracle; a warm setup reads the verdict without
    measuring.  Then stencil3d(24, 27) keeps the body without measuring.
    Returns each matrix's record; ``card`` (the card's name and power
    limit) stands beside each timed row."""
    def measured(*_):
        raise RuntimeError("the gate measured where it should not")

    names = {"routed": "RoutedSpmv", "split": "DegreeSplitSpmv"}
    out = {}
    for name in SMALL_GATE_MATRICES:
        m = generate.load_corpus(name)
        with tempfile.TemporaryDirectory() as cache:
            cfg = port.EhybConfig(artifact_cache=True, cache_dir=cache)
            gate = port.EhybSpmv(cfg, device=dev)
            t0 = time.perf_counter()
            model = gate.setup(m)
            setup_s = time.perf_counter() - t0
            g = gate.small_gate
            check(g is not None and "kind" in g,
                  f"{name} ({m.dimension} rows, {m.nnz} nnz): the A/B ran, "
                  f"est {g['est'] / g['floor']:.3f}x the floor")
            cand = g["candidate_gflops"] > 1.05 * g["body_gflops"]
            verdict = gate._load_gate_decision(m)
            engine = type(model).__name__
            x = deterministic_x(m.dimension)
            err = rel_np(model.matvec(x), oracle_spmv(m, x))
            print(f"  {name}: {g['kind']} {g['candidate_gflops']:.2f} vs "
                  f"body {g['body_gflops']:.2f} GFLOP/s (the graph loop; "
                  f"{card}) "
                  f"-> verdict {verdict!r}, engine {engine}; gate "
                  f"{model.setup_seconds['small_gate']:.2f} s of "
                  f"{setup_s:.2f} s setup; {card_state()}")
            check(engine == (names[g["kind"]] if cand else "EhybSpmv")
                  and verdict == (g["kind"] if cand else False)
                  and model.small_gate is g,
                  f"{name}: the 5% rule picks {engine} (verdict "
                  f"{verdict!r})")
            check(err <= ORACLE_TOL, f"{name}: {engine} vs oracle rel "
                                     f"{err:.3e} <= {ORACLE_TOL}")
            warm = port.EhybSpmv(cfg, device=dev)
            warm._measured_gflops = measured
            check(type(warm.setup(m)).__name__ == engine,
                  f"{name}: a warm setup reads the verdict and returns "
                  f"{engine} without measuring")
        out[name] = dict(g, engine=engine, rel_error=err)
    m = generate.stencil3d(24, 27)
    model = port.EhybSpmv(port.EhybConfig(), device=dev)
    model._measured_gflops = measured
    g = model.setup(m).small_gate
    check(g is not None and "kind" not in g
          and g["est"] <= model._SMALL_EST_K * g["floor"],
          f"stencil3d(24, 27): est {g['est'] / g['floor']:.3f}x the floor, "
          "the body kept without measuring")
    return out


# ---------------------------------------------------------------------------
# Phase 19: a float64 config where the reference answers.
# ---------------------------------------------------------------------------

def graph_loop_gflops(model, x: torch.Tensor, nnz: int, dev,
                      n: int = 500) -> float:
    """One model's graph loop (captured first), timed twice: GFLOP/s over
    both readings."""
    model.iterate(x, n)
    torch.cuda.synchronize(dev)
    captures = CapturedGraph.captures
    secs = [timed_seconds(lambda: model.iterate(x, n), dev) / n
            for _ in range(2)]
    check(CapturedGraph.captures == captures,
          "no graph captured inside the timed loop")
    print(f"  graph loop: us/iter " + ", ".join(f"{1e6 * t:.2f}"
                                                for t in secs))
    return 2e-9 * nnz * len(secs) / sum(secs)


def check_sharded_f64(dev, card: str) -> tuple:
    """19d: ShardedEhybSpmv in a float64 config on SHARDED_MATRIX: one
    rank through the graph loop (K1's f64 list variant over the boundary
    list), two gloo ranks on the one card (interior and boundary lists),
    each against the oracle within F64_TOL; the f64 list kernel timed; and
    the f64 cancellation matrix at one rank, where only the compensated
    list variant keeps row 0.  Returns (launches, timing fields)."""
    m = generate.load_corpus(SHARDED_MATRIX)
    cfg = port.EhybConfig(**SHARDED_CFG, dtype="float64")
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    host1 = plan_sharded(m, cfg, 1)
    model = ShardedEhybSpmv(cfg, device=dev).setup(m, host1)
    cells = model.module.cells
    check(model.loop == "graph"
          and cells.plan.cell_val.dtype == torch.float64,
          f"world 1 in f64: loop {model.loop}, the shard's plan in "
          f"{cells.plan.cell_val.dtype}, {cells.stats['n_boundary']} "
          "boundary row blocks")
    xd = model.prepare_x(x)
    reset_launches()
    y = model.recover_y(model.apply(xd))
    model.iterate(xd, 500)
    torch.cuda.synchronize(dev)
    launches = ehyb_stream.stream_body.launches
    err = rel_np(y, want)
    check(launches > 0 and err <= F64_TOL,
          f"{SK1F64['name']} launched {launches} times in one apply and the "
          f"500-step graph loop; world 1 f64 vs oracle rel {err:.3e} <= "
          f"{F64_TOL}")
    gf = graph_loop_gflops(model, xd, m.nnz, dev)
    print(f"  ehyb_sharded D=1 f64 on {SHARDED_MATRIX}: {gf:.2f} GFLOP/s; "
          f"{card}; {card_state()}")
    print("  the f64 sharded K1 at D=1 over all its row blocks (the "
          "boundary list):")
    sk1 = time_k1_list(cells.plan, cells.boundary.cpu().numpy(),
                       model.module.ex.x_buf, False, dev)
    del model
    host2 = plan_sharded(m, cfg, 2)
    res = launch.spawn(sharded_rank, 2, "gloo", args=(m, host2, False),
                       timeout=RANK_TIMEOUT_S)
    for r in res:
        check(r["interior"] > 0 and r["boundary"] > 0 and r["launches"] == 2
              and r["err_loop"] <= F64_TOL,
              f"D=2 f64 rank {r['rank']}: {r['interior']} interior, "
              f"{r['boundary']} boundary row blocks, {r['launches']} K1 "
              f"launches an apply, eager loop vs apply rel "
              f"{r['err_loop']:.3e}, {r['us_per_apply']:.1f} us per eager "
              "apply")
    err = rel_np(res[0]["y"], want)
    check(err <= F64_TOL, f"D=2 f64 vs oracle rel {err:.3e} <= {F64_TOL}")
    mc = cancellation_matrix_f64()
    for kahan in (False, True):
        c = dataclasses.replace(cfg, compensated_sum=kahan)
        sm = ShardedEhybSpmv(c, device=dev).setup(mc)
        reset_launches()
        yc = sm.matvec(np.ones(mc.dimension))
        check(ehyb_stream.stream_body.launches > 0,
              f"the f64 cancellation matrix at world 1: K1's list variant "
              f"launched {ehyb_stream.stream_body.launches} times")
        check_cancel_row(f"sharded cancel 1e17 f64{' kahan' if kahan else ''}",
                         mc, yc, kahan)
    return launches, dict(sk1, gflops_d1=gf)


def check_f64_paths(dev, card: str, prebuild: "Prewarm") -> dict:
    """19: a float64 config (``--dtype float64``, not the precision mode)
    where the reference answers, through the CLI at full size: pp512 with
    compensation (K1 f64 Kahan + K9 f64), pp1024 forced past residency with
    compensation (the window cache's f64 Kahan variant on a main path, bit
    for bit with its plain version on the CPU and timed there), pp4096 (the
    window cache in f64 + K9 f64; the window cache timed on its plan, plain
    and Kahan; its host artifact from ``prebuild``'s cache), each within
    F64_TOL of the oracle; then the sharded engine in f64.  Returns the
    ``kernels`` line's new entries."""
    t0 = time.perf_counter()
    print(f"  19a: python -m ehyb_spmv_torch {' '.join(KAHAN_F64_ARGS)}")
    res, model, la = drive(KAHAN_F64_ARGS, F64_TOL)
    check(la["K1"] > 0 and la["K9"] > 0 and la["WC"] == 0
          and model.module.kahan
          and model.module.cells.cell_val.dtype == torch.float64,
          f"{K1F64K['name']} launched {la['K1']} times, K9 f64 {la['K9']} "
          f"times; {res['gflops']:.2f} GFLOP/s; {card}")
    print(f"  K1 f64 Kahan on {res['matrix']}'s body ({card}):")
    k1k = time_k1(model, res, dev, n_eager=50)
    del model
    t1 = time.perf_counter()
    print(f"  19b: python -m ehyb_spmv_torch {' '.join(WC_KAHAN_F64_ARGS)} "
          "(X_RESIDENT_BYTES=1024 in-process)")
    with patched(X_RESIDENT_BYTES=1024):
        res, model, lw = drive(WC_KAHAN_F64_ARGS, F64_TOL)
    p = model.module.wincache
    check(p is not None and lw["WC"] > 0 and lw["K1"] == 0
          and model.module.kahan and p.cell_val.dtype == torch.float64,
          f"{WCF64K['name']} launched {lw['WC']} times, K1 {lw['K1']} "
          f"times (TPU branch {model.module.branch}); {res['gflops']:.2f} "
          f"GFLOP/s; {card}")
    k1 = build_stream_cells(model.ehyb).to_torch(dev)
    check_wincache_plan(res["matrix"], model.dev, p, k1,
                        model.prepare_x(deterministic_x(res["dim"])), True)
    del k1
    print(f"  the window cache's Kahan variant in f64 on {res['matrix']}'s "
          f"body, its main path ({card}):")
    wck = time_wincache(model, res, dev)
    del model, p
    t2 = time.perf_counter()
    rc, since, out = prebuild.wait(PREWARM_TIMEOUT_S)
    print("  19c's host artifact, built on the host since phase 9 "
          f"(scripts_torch/prewarm.py {' '.join(PREBUILD_F64_ARGS)}):")
    print("".join(f"    {ln}\n" for ln in out.splitlines()), end="")
    check(rc == 0, f"the prebuild exited {rc} after {since:.1f} s (19c "
                   f"waited {time.perf_counter() - t2:.1f} s of it)")
    print(f"  19c: python -m ehyb_spmv_torch {' '.join(HBM_F64_ARGS)} --cache "
          f"(the cache at {prebuild.cache_dir})")
    with cache_dir(prebuild.cache_dir):
        res, model, lh = drive(HBM_F64_ARGS + ["--cache"], F64_TOL)
    check("cache_load" in res["setup_seconds"],
          "19c loaded the prebuilt artifact")
    p = model.module.wincache
    check(res["dim"] == 16777216 and res["nnz"] == 83869696
          and p is not None and p.cell_val.dtype == torch.float64
          and p.slot_rows == ehyb_wincache.SLOT_ROWS_F64
          and lh["WC"] > 0 and lh["K9"] > 0 and lh["K1"] == 0,
          f"full size in f64: {WCF64['name']} launched {lh['WC']} times, K9 "
          f"f64 {lh['K9']} times, K1 {lh['K1']} times; plan at "
          f"{p.slot_rows} slot rows; TPU branch {model.module.branch}; "
          f"setup {sum(res['setup_seconds'].values()):.1f} s (its cache "
          "load and plan); "
          f"{res['gflops']:.2f} GFLOP/s; {card}")
    print(f"  the window cache in f64 on {res['matrix']}'s body ({card}):")
    wc = time_wincache(model, res, dev)
    print(f"  its Kahan variant on the same plan ({card}):")
    wck4 = time_wincache(model, res, dev, kahan=True,
                         library_ms=wc["library_ms"])
    print(f"  window cache f64 on {res['matrix']} ({p.slot_rows} slot rows, "
          f"{p.groups * 128} threads): plain {wc['ms']:.4f} ms, Kahan "
          f"{wck4['ms']:.4f} ms; {card}")
    print(f"  K9 f64 on {res['matrix']}'s diagonal ({card}):")
    time_dia(model, res, dev, n=20)
    del model, p
    t3 = time.perf_counter()
    print(f"  19d: ehyb_sharded in f64 on {SHARDED_MATRIX}")
    ls, sk1 = check_sharded_f64(dev, card)
    t4 = time.perf_counter()
    print(f"  phase 19 wall: 19a {t1 - t0:.1f} s, 19b {t2 - t1:.1f} s, 19c "
          f"{t3 - t2:.1f} s, 19d {t4 - t3:.1f} s")
    return {"k1k": dict(K1F64K, launches=la["K1"], **k1k),
            "wc": dict(WCF64, launches=lh["WC"], **wc),
            "wck": dict(WCF64K, launches=lw["WC"], **wck),
            "sk1": dict(SK1F64, launches=ls, **sk1)}


# ---------------------------------------------------------------------------
# Phase 20: the bench surface (bench_torch.py and scripts_torch/).
# ---------------------------------------------------------------------------

class Prewarm:
    """``scripts_torch/prewarm.py ARGS`` in a background process, into
    ``cache_dir``: the host builds artifacts and oracles while the card
    runs earlier phases.  Leaving the ``with`` block stops it if it still
    runs."""

    def __init__(self, cache_dir: str, tag: str, args):
        self.cache_dir, self.args = cache_dir, list(args)
        self.out = os.path.join(cache_dir, f"{tag}.out")
        self.err = os.path.join(cache_dir, f"{tag}.err")

    def __enter__(self):
        self.t0 = time.perf_counter()
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(os.path.dirname(
                    os.path.abspath(__file__)), "scripts_torch", "prewarm.py"),
                 *self.args], stdout=out, stderr=err,
                env={**os.environ, "EHYB_TORCH_CACHE_DIR": self.cache_dir})
        return self

    def wait(self, timeout: float) -> tuple:
        """(exit code, seconds since the start, standard output); the exit
        code is None where it still runs after ``timeout`` seconds."""
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            rc = None
        with open(self.out) as f:
            return rc, time.perf_counter() - self.t0, f.read()

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def bench_row(role: str, r: dict) -> str:
    """One child's line: engine, launches, rel error, setup and wall."""
    if bench_torch.failed(r):
        return f"{role} {r['model']}@{r['matrix']}: FAIL {r['error']}"
    setup = r["setup_seconds"]
    return (f"{role} {r['model']}@{r['matrix']}: {r['gflops']:.2f} GFLOP/s, "
            f"engine {r['engine']}, launches {r['launches']}, rel "
            f"{r['rel_error']:.3e}, setup "
            f"{setup.get('total', sum(setup.values())):.1f} s "
            f"({', '.join(f'{k} {v:.2f}' for k, v in setup.items())}), "
            f"corpus {r['load_seconds']:.1f} s, oracle "
            f"{r['oracle_seconds']:.1f} s "
            f"({'hit' if r['oracle_hit'] else 'miss'}), "
            f"child wall {r['wall_seconds']:.1f} s")


def table_rows(text: str) -> list:
    """The data rows of a sweep table (its header row dropped)."""
    return [ln for ln in text.splitlines() if ln.startswith("| ")][1:]


def check_body_row(r: dict) -> None:
    """An EHYB body row launched the kernel of every phase it holds: K9
    where it has DIA entries, K1 or the window cache where it has a body,
    and neither where it has none."""
    la = r["launches"]
    body = la["K1"] + la["WC"]
    check(r["engine"] == "EhybSpmv" and (la["K9"] > 0) == (r["nnz_dia"] > 0)
          and (body > 0) == (r["nnz_ell"] > 0) and la["RX"] == 0,
          f"{r['matrix']}: {r['engine']}, K9 {la['K9']} launches for "
          f"{r['nnz_dia']} DIA entries, K1 {la['K1']} and the window cache "
          f"{la['WC']} for {r['nnz_ell']} body entries")


def check_routed_row(r: dict) -> None:
    la = r["launches"]
    check(r["engine"] == "RoutedSpmv" and la["RX"] > 0
          and r["nnz_routed"] > 0
          and r["nnz_routed"] + r["nnz_spill"] == r["nnz"],
          f"{r['matrix']}: {r['engine']} over {r['routed_blocks']} column "
          f"block(s), {RX['name']} launched {la['RX']} times, "
          f"{r['nnz_routed']} entries routed + {r['nnz_spill']} spilled = "
          f"{r['nnz']}")


def check_bench_surface(prewarm: Prewarm, res1: dict) -> None:
    """Phase 20: the default headline through ``bench_torch``, its
    precision mode, and ``scripts_torch/sweep.py --models ehyb`` over the
    rows no earlier phase drives; every child in its own process with
    ``artifact_cache=True``, reading the cache the prewarm filled."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the children need the card's memory
    rc, since, out = prewarm.wait(PREWARM_TIMEOUT_S)
    print("  the prewarm (scripts_torch/prewarm.py on the host, started "
          "before phase 1):")
    print("".join(f"    {ln}\n" for ln in out.splitlines()), end="")
    check(rc == 0, f"the prewarm exited {rc} after {since:.1f} s (phase 20 "
                   f"waited {time.perf_counter() - t0:.1f} s of it)")
    with patched(env={"EHYB_TORCH_CACHE_DIR": prewarm.cache_dir}):
        print("  20a: the default headline (bench_torch.headline)")
        t1 = time.perf_counter()
        rows, tail = bench_torch.headline("cuda")
        for role, r in rows.items():
            print(f"  {bench_row(role, r)}")
        print(f"  tail: {json.dumps(tail)}")
        print(f"  {tail['metric']} {tail['value']:.2f} GFLOP/s through "
              f"bench_torch; phase 6's CLI read {res1['gflops']:.2f} for the "
              "same row (other processes: not gated on each other)")
        fl, base = rows["flagship"], rows["baseline"]
        check(not bench_torch.failed(fl) and "error" not in tail
              and fl["engine"] == "EhybSpmv" and fl["launches"]["K1"] > 0
              and fl["launches"]["K9"] > 0
              and fl["launches"]["RX"] == fl["launches"]["WC"] == 0
              and fl["ell_steps"] > 0 and fl["nnz_er"] > 0
              and fl["rel_error"] <= ORACLE_TOL,
              f"flagship ehyb@{fl['matrix']}: launches {fl.get('launches')}, "
              f"ell_steps {fl.get('ell_steps')}, nnz_er {fl.get('nnz_er')}, "
              f"rel {fl.get('rel_error')}")
        check(tail["baseline_model"] == "bcoo"
              and base.get("engine") == "BcooSpmv",
              f"baseline {tail['baseline_model']} ({base.get('engine')}), "
              f"vs_baseline {tail['vs_baseline']:.3f}")
        sec = rows["secondary"]
        check(not bench_torch.failed(sec), f"secondary {bench_row('', sec)}")
        check_body_row(sec)
        gw = rows["gather"]
        check(not bench_torch.failed(gw), f"gather {bench_row('', gw)}")
        check_routed_row(gw)
        print(f"  20a wall {time.perf_counter() - t1:.1f} s")

        print("  20b: EHYB_BENCH_DWORD=1, the headline alone")
        t1 = time.perf_counter()
        with patched(env={"EHYB_BENCH_DWORD": "1", "EHYB_BENCH_SECONDARY": "",
                          "EHYB_BENCH_GATHER": ""}):
            rows, tail = bench_torch.headline("cuda")
        for role, r in rows.items():
            print(f"  {bench_row(role, r)}")
        print(f"  tail: {json.dumps(tail)}")
        fl, base = rows["flagship"], rows["baseline"]
        check(not bench_torch.failed(fl) and fl["dword"]
              and fl["rel_error"] <= F64_TOL and fl["launches"]["K1"] > 0
              and set(rows) == {"flagship", "baseline"},
              f"precision-mode flagship: rel {fl.get('rel_error')} <= "
              f"{F64_TOL}, K1 launched {fl.get('launches')}")
        check(not bench_torch.failed(base) and base["dword"] is False,
              f"the baseline {base['model']} ran in f32 (dword "
              f"{base.get('dword')})")
        print(f"  20b wall {time.perf_counter() - t1:.1f} s")

        print("  20c: scripts_torch/sweep.py --models ehyb "
              + " ".join(SWEEP_ROWS))
        t1 = time.perf_counter()
        table = os.path.join(prewarm.cache_dir, "BENCH_SWEEP_H100.md")
        sweep_log = os.path.join(prewarm.cache_dir, "sweep.log")
        with open(sweep_log, "w") as f, contextlib.redirect_stdout(f):
            swept = torch_sweep.sweep(SWEEP_ROWS, ["ehyb"], table, "cuda")
        print(f"  {card_state()}")
        with open(table) as f:
            written = table_rows(f.read())
        rebuilt = table_rows(sweep_table.render(
            sweep_table.parse(sweep_log), "scripts_torch/sweep_table.py"))
        check(written == rebuilt and len(written) == len(SWEEP_ROWS),
              f"the table's {len(written)} rows, rebuilt the same from the "
              "sweep's log by scripts_torch/sweep_table.py")
        swept = dict(swept)
        for mat in SWEEP_ROWS:
            r = swept[mat]["ehyb"]
            print(f"  {bench_row('sweep', r)}")
            check(not bench_torch.failed(r) and r["rel_error"] <= ORACLE_TOL,
                  f"{mat}: rel {r.get('rel_error')} <= {ORACLE_TOL}")
        for mat in ("poisson2d_512", "stencil27_24", "fem3d_32"):
            check_body_row(swept[mat]["ehyb"])
        r4 = swept["random_4m"]["ehyb"]
        if r4["engine"] == "RoutedSpmv":
            check_routed_row(r4)
        else:
            print(f"  FINDING: the gate kept the body on random_4m "
                  f"({r4['engine']})")
            check_body_row(r4)
        rp = swept["powerlaw_1m"]["ehyb"]
        print(f"  powerlaw_1m: the gate picked {rp['engine']}")
        if rp["engine"] == "RoutedSpmv":
            check_routed_row(rp)
        elif rp["engine"] == "DegreeSplitSpmv":
            check(rp["launches"]["RX"] > 0 and rp["launches"]["K1"] > 0,
                  f"powerlaw_1m: the split launched {rp['launches']}")
        else:
            check_body_row(rp)
        print(f"  20c wall {time.perf_counter() - t1:.1f} s")
    print(f"  phase 20 wall {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="ehyb_bench_") as cache, \
            contextlib.ExitStack() as jobs:
        # phase 20's rows, built on the host while the card runs 1-19
        prewarm = jobs.enter_context(
            Prewarm(cache, "prewarm", ["--models", "ehyb", *PREWARM_ROWS]))
        return run_phases(prewarm, jobs)


def run_phases(prewarm: Prewarm, jobs: contextlib.ExitStack) -> int:
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(title: str) -> None:
        print(f"== phase {title} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    phase("1: card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(dev)}, "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("2: build (one nvcc per source, all at once)")
    builds = {"K1": ehyb_stream.build_kernel, "RX": route_xcache.build_kernel,
              "K9": dia.build_kernel, "WC": ehyb_wincache.build_kernel}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(b) for k, b in builds.items()}
        built = {k: f.result() for k, f in futures.items()}
    for k, b in built.items():
        print(f"  {k}: built {b.path} in {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k} ptxas: {line.strip()}")

    phase("3: K1 vs plain version on small matrices")
    for name, m, cfg, nwin, kahan in kernel_cases():
        model = port.EhybSpmv(cfg, device=dev).setup(m)
        e = model.dev
        check(e.nwin == nwin and e.body_nnz > 0 and model.module.kahan == kahan
              and model.module.cells is not None and e.ell_val is None,
              f"{name}: layout nwin={e.nwin}, body nnz {e.body_nnz}, K1's "
              "plan on the card and no padded body")
        x = deterministic_x(m.dimension) if not kahan else np.ones(m.dimension)
        x_dev = model.prepare_x(x)
        check_k1_case(name, model.ehyb, x_dev.cpu().numpy(), kahan, dev,
                      model.module.cells)
        y = model.matvec(x)
        err = rel_np(y, oracle_spmv(m, x))
        check(err <= ORACLE_TOL,
              f"{name}: model vs oracle rel {err:.3e} <= {ORACLE_TOL}")
        if kahan:
            check(y[0] == 100.0, f"{name}: compensated row 0 = {y[0]!r}")
    m = generate.permuted(generate.poisson2d(96), seed=3)
    e32 = port.EhybPlainSpmv(port.EhybConfig(index_dtype="int32"),
                             device=dev).setup(m).ehyb
    check(e32.ell_col.dtype == np.int32, f"int32 columns: {e32.ell_col.dtype}")
    rng = np.random.default_rng(3)
    check_k1_case("int32 columns", e32, rng.standard_normal(
        e32.padded_x_rows), False, dev)
    e = edge_body()
    plan = build_stream_cells(e)
    width = np.diff(plan.piece[:plan.n_rb + 1, 0]) // 32
    check(plan.stats["split_rbs"] > 0 and np.any(width[4:8] == 0),
          f"edge body: {plan.stats['split_rbs']} row blocks cut, widths of "
          f"slice 1's row blocks {width[4:8].tolist()}")
    for kahan in (False, True):
        check_k1_case(f"edge body{' kahan' if kahan else ''}", e,
                      rng.standard_normal(e.padded_x_rows), kahan, dev)

    phase("4: the routed kernel vs its plain version and the plain K7/K8 "
          "pair on small matrices (slice, octet, column blocks, spill) and "
          "the split model")
    check_routed_small(dev)

    phase("5: K9 and the window cache vs plain versions on small matrices; "
          "K1 where the TPU runs K5 or K6")
    check_dia_small(dev)
    check_wincache_small(dev)
    check_k5_k6(dev)

    phase(f"6: main path 1 (python -m ehyb_spmv_torch {' '.join(MAIN_ARGS)})")
    res1, model1, launch1 = drive(MAIN_ARGS)
    print(f"  layout: {res1['layout']}")
    check(res1["engine"] == "EhybSpmv", f"engine {res1['engine']}")
    check(res1["dim"] == 262144 and res1["nnz"] > 1_000_000,
          f"full size: dim {res1['dim']}, nnz {res1['nnz']}")
    y = model1.apply(model1.prepare_x(deterministic_x(res1["dim"])))
    check(y.shape[0] >= res1["dim"] and bool(torch.isfinite(y).all()),
          f"finite padded y of {y.shape[0]} rows")
    check(launch1["K1"] > 0 and launch1["K9"] > 0,
          f"{K1['name']} launched {launch1['K1']} times, {K9['name']} "
          f"{launch1['K9']} times during main path 1")
    cells = model1.module.cells
    check(cells is not None and model1.dev.ell_val is None,
          f"K1's plan on the card ({nbytes(*cells.buffers())} B, built in "
          f"{res1['setup_seconds']['k1_plan']:.2f} s), no padded body "
          f"({cells.stats['body_bytes']} B)")

    phase("7: main path 2, the gather-wall row "
          f"(python -m ehyb_spmv_torch {' '.join(GATHER_ARGS)})")
    res2, model2, launch2 = drive(GATHER_ARGS)
    check(res2["engine"] == "RoutedSpmv",
          f"the gate delegated to {res2['engine']}")
    check(res2["dim"] == 1048576 and res2["nnz"] == 16769356,
          f"full size: dim {res2['dim']}, nnz {res2['nnz']}")
    print(f"  nnz_routed {res2['nnz_routed']}, nnz_spill {res2['nnz_spill']}")
    check(launch2["RX"] > 0, f"{RX['name']} launched {launch2['RX']} times "
                             "during main path 2")
    old = [f for f in os.listdir(BUILD_DIR)
           if f.startswith(("libroute_at", "libroute_b"))]
    check(not old, f"no K7/K8 library in the build directory {old}")

    phase("8: main path 3, the audikw-class FEM row "
          f"(python -m ehyb_spmv_torch {' '.join(FEM_ARGS)})")
    res3, model3, launch3 = drive(FEM_ARGS)
    print(f"  layout: {res3['layout']}; {len(model3.dev.dia_offsets)} "
          f"diagonals; TPU branch {model3.module.branch}")
    check(res3["engine"] == "EhybSpmv", f"engine {res3['engine']}")
    check(res3["dim"] == 943296
          and res3["layout"]["nnz_dia"] == res3["nnz"] == 74181672,
          f"full size, all DIA: dim {res3['dim']}, nnz {res3['nnz']}, "
          f"nnz_dia {res3['layout']['nnz_dia']}")
    check(launch3["K9"] > 0 and launch3["K1"] == launch3["WC"] == 0,
          f"{K9['name']} launched {launch3['K9']} times, the body kernels "
          f"{launch3['K1'] + launch3['WC']} times during main path 3")

    phase("9: main path 4, x past the TPU's residency limit "
          f"(python -m ehyb_spmv_torch {' '.join(HBM_ARGS)})")
    res4, model4, launch4 = drive(HBM_ARGS)
    # phase 19c's host setup (pp4096 in a float64 config), built on the
    # host from the corpus entry phase 9 cached while phases 10-19b run
    prebuild = jobs.enter_context(Prewarm(
        prewarm.cache_dir, "prebuild_f64", PREBUILD_F64_ARGS))
    plan = model4.module.wincache
    print(f"  layout: {res4['layout']}; TPU branch {model4.module.branch}; "
          f"setup {res4['setup_seconds']['total']:.1f} s")
    check(res4["engine"] == "EhybSpmv", f"engine {res4['engine']}")
    check(res4["dim"] == 16777216 and res4["nnz"] == 83869696,
          f"full size: dim {res4['dim']}, nnz {res4['nnz']}")
    check(plan is not None and launch4["WC"] > 0 and launch4["K9"] > 0
          and launch4["K1"] == 0,
          f"{WC['name']} launched {launch4['WC']} times, {K9['name']} "
          f"{launch4['K9']} times, K1 {launch4['K1']} times during main "
          "path 4")
    check(model4.dev.ell_val is None,
          f"the model holds {nbytes(*model4.dev.buffers())} B of artifact "
          f"and {nbytes(*plan.buffers())} B of window-cache plan on the "
          f"card, no padded body ({plan.stats['body_bytes']} B)")

    phase("10: kernels, plain versions and cuSPARSE at the main paths' "
          "shapes (device time, CUDA graph replay)")
    print("  K1 on permuted_poisson_512's body (main path 1):")
    k1 = time_k1(model1, res1, dev)
    print("  K1 on permuted_poisson_1024 on its own resident path:")
    m6 = generate.load_corpus("permuted_poisson_1024")
    model6 = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m6)
    check(model6.module.branch == "streamed v3"
          and model6.module.cells is not None and model6.dev.ell_val is None,
          f"TPU branch {model6.module.branch}: K1 over its plan, built in "
          f"{model6.setup_seconds['k1_plan']:.2f} s")
    reset_launches()
    x6 = deterministic_x(m6.dimension)
    err = rel_np(model6.matvec(x6), oracle_spmv(m6, x6))
    check(err <= ORACLE_TOL and ehyb_stream.stream_body.launches == 1,
          f"permuted_poisson_1024 model vs oracle rel {err:.3e}, K1 "
          f"launched {ehyb_stream.stream_body.launches} times")
    time_k1(model6, {"dim": m6.dimension}, dev, n_plain=10, n_eager=20)
    rx = time_routed(model2, res2, model2.m, dev)
    k9 = time_dia(model3, res3, dev)
    print("  K9 on permuted_poisson_4096's diagonal:")
    time_dia(model4, res4, dev, n=20)
    print("  K1 on permuted_poisson_4096's body, its plan built for it (the "
          "TPU's K2 regime; L2 instead of the window cache):")
    t0 = time.perf_counter()
    c4 = build_stream_cells(model4.ehyb).to_torch(dev)
    print(f"  K1's plan built and uploaded in {time.perf_counter() - t0:.1f} "
          f"s")
    k1_big = time_k1(model4, res4, dev, c4, n=20, n_plain=2, n_eager=20)
    print("  the window cache on permuted_poisson_4096's body:")
    wc = time_wincache(model4, res4, dev, k1_big, c4)
    del c4
    print("  permuted_poisson_1024 forced past the residency limit "
          "in-process (the TPU's K3 branch): K1, then the window cache")
    with patched(X_RESIDENT_BYTES=1024):
        m5 = generate.load_corpus("permuted_poisson_1024")
        model5 = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m5)
    check(model5.module.branch == "streamed hbm"
          and model5.module.wincache is not None,
          f"TPU branch {model5.module.branch}: the window cache runs")
    res5 = {"dim": m5.dimension}
    c5 = build_stream_cells(model5.ehyb).to_torch(dev)
    time_wincache(model5, res5, dev, time_k1(model5, res5, dev, c5,
                                             n_plain=10, n_eager=20), c5)
    del model5, c5
    for res in (res1, res2, res3, res4):
        print(f"  {res['matrix']}: {res['gflops']:.2f} GFLOP/s end to end "
              f"({res['iters']} iterations in {res['seconds']:.4f} s, "
              f"{1e3 * res['seconds'] / res['iters']:.4f} ms each); "
              f"{res['card']}")

    rows = ((res1, model1), (res2, model2), (res3, model3), (res4, model4))
    phase("11: the chained loop as CUDA-graph replays against the eager "
          "loop, in turns")
    loop_s = {res["matrix"]: check_loop(res, model, dev)
              for res, model in rows}

    phase("12: where the device time goes per iteration under the graph")
    for res, model in rows:
        profile_path(res["matrix"], res, model,
                     loop_s[res["matrix"]]["graph"])

    phase(f"13: CG on {res1['matrix']} through the flagship (K1 and K9 in "
          "the graph)")
    check_cg(model1, dev)

    phase(f"14: power iteration on {res1['matrix']}")
    check_power(model1)

    phase(f"15: the baselines on {res1['matrix']} through the CLI")
    base = {}
    for name in ("csr", "bcoo", "hyb"):
        res, model, _ = drive(BASELINE_ARGS + [name])
        check(res["engine"] == type(model).__name__ == {
            "csr": "CsrSpmv", "bcoo": "BcooSpmv", "hyb": "HybSpmv"}[name],
            f"--model {name} ran {res['engine']}")
        base[name] = res["gflops"]
        del model
    print(f"  {res1['matrix']}: ehyb {res1['gflops']:.2f} GFLOP/s, "
          + ", ".join(f"{k} {v:.2f}" for k, v in base.items())
          + " GFLOP/s (the CLI's graph loop, 500 iterations each)")

    phase(f"16: the sharded path: K1 with a row-block list, then "
          f"ShardedEhybSpmv at 1, 2 and 4 ranks on {SHARDED_MATRIX}, and "
          "the sharded routed and degree-split engines")
    print("  16a: K1 with a row-block list vs its plain version")
    check_k1_lists(dev)
    sk1 = check_sharded(m6, model6, model2.m, dev, card)
    del model6, m6

    t17 = time.perf_counter()
    phase("17: the precision mode: K1 and K9 in f64 against their f64 plain "
          "versions, pp512 and fem3d_68 with --dword through the CLI, and "
          "the f64 kernels timed")
    print("  17a: the f64 kernels vs their f64 plain versions on small "
          "matrices")
    check_f64_small(dev)
    print(f"  17b: python -m ehyb_spmv_torch {' '.join(DWORD_ARGS)}")
    res7, model7, launch7 = drive(DWORD_ARGS)
    print(f"  layout: {res7['layout']}; TPU branch {model7.module.branch}")
    check(res7["engine"] == "EhybSpmv" and res7["dim"] == 262144
          and res7["nnz"] == res1["nnz"],
          f"full size in the precision mode: dim {res7['dim']}, nnz "
          f"{res7['nnz']}, engine {res7['engine']}")
    check(res7["rel_error"] <= F64_TOL,
          f"f64 rel error vs the oracle {res7['rel_error']:.3e} <= {F64_TOL}")
    check(launch7["K1"] > 0 and launch7["K9"] > 0 and launch7["WC"] == 0
          and launch7["RX"] == 0
          and model7.module.cells.cell_val.dtype == torch.float64,
          f"{K1F64['name']} launched {launch7['K1']} times, {K9F64['name']} "
          f"{launch7['K9']} times, the window cache {launch7['WC']} times")
    print(f"  {res7['matrix']}: {res7['gflops']:.2f} GFLOP/s in f64 beside "
          f"{res1['gflops']:.2f} in f32 (phase 6), both the CLI's graph "
          f"loop of {res7['iters']} iterations; {card}")
    print(f"  17c: python -m ehyb_spmv_torch {' '.join(DWORD_FEM_ARGS)}")
    res8, model8, launch8 = drive(DWORD_FEM_ARGS)
    lay = res8["layout"]
    print(f"  layout: {lay}; {len(model8.dev.dia_offsets)} diagonals "
          f"(nnz_dia {lay['nnz_dia']} of {res8['nnz']}), TPU branch "
          f"{model8.module.branch}")
    check(res8["dim"] == 943296 and res8["rel_error"] <= F64_TOL
          and launch8["K9"] > 0 and launch8["WC"] == 0,
          f"fem3d_68 in f64: rel {res8['rel_error']:.3e}, {K9F64['name']} "
          f"launched {launch8['K9']} times, K1 {launch8['K1']} times; "
          f"{res8['gflops']:.2f} GFLOP/s beside {res3['gflops']:.2f} in "
          "f32 (phase 8)")
    print(f"  17d: K1 in f64 on pp512's precision-mode body ({card}):")
    k1f64 = time_k1(model7, res7, dev, n_eager=50)
    print(f"  K9 in f64 on fem3d_68's precision-mode DIA part ({card}):")
    k9f64 = time_dia(model8, res8, dev, n=20)
    print("  K9 in f64 at fem3d_68's 99 diagonals (phase 8's DIA part, its "
          f"values in f64; {card}):")
    e99 = types.SimpleNamespace(dia_offsets=model3.dev.dia_offsets,
                                dia_val=model3.dev.dia_val.double())
    time_dia_part(e99, model3.prepare_x(
        deterministic_x(res3["dim"])).double(), dev, n=10)
    del e99, model8
    t18 = time.perf_counter()
    phase("18: the small gate on the card: "
          + ", ".join(SMALL_GATE_MATRICES) + " and stencil3d(24, 27)")
    gates = check_small_gate(dev, card)
    t19 = time.perf_counter()
    del rows, model1, model2, model3, model4, model7, plan
    phase("19: a float64 config where the reference answers: "
          "permuted_poisson_512 --compensated (K1 f64 Kahan), "
          "permuted_poisson_4096 (the window cache in f64) and "
          f"ehyb_sharded on {SHARDED_MATRIX}, at full size")
    f64k = check_f64_paths(dev, card, prebuild)
    t20 = time.perf_counter()
    phase("20: the bench surface: bench_torch's headline, its precision "
          "mode, and scripts_torch/sweep.py on " + ", ".join(SWEEP_ROWS))
    check_bench_surface(prewarm, res1)
    t_end = time.perf_counter()
    print(f"  phase 17 {t18 - t17:.1f} s, phase 18 {t19 - t18:.1f} s, phase "
          f"19 {t20 - t19:.1f} s, phase 20 {t_end - t20:.1f} s; script wall "
          f"{t_end - t_start:.1f} s")

    print(json.dumps({"small_gate": gates}))
    print(json.dumps({"kernels": [
        dict(K1, launches=launch1["K1"], **k1),
        dict(RX, launches=launch2["RX"], **rx),
        dict(K9, launches=launch3["K9"], **k9),
        dict(WC, launches=launch4["WC"], **wc),
        dict(SK1, **sk1),
        dict(K1F64, launches=launch7["K1"], **k1f64),
        dict(K9F64, launches=launch8["K9"], **k9f64),
        f64k["k1k"], f64k["sk1"], f64k["wc"], f64k["wck"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
