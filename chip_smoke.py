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
range, bit for bit where Kahan is off; K1's split variant, over the plan
form of heavy-tailed bodies whose long row blocks are cut into chunks, on
a synthetic long body and powerlaw_small at a small split and the shipped
one, bit for bit, its combine also under CUDA-graph replays; K9 at every
built variant, in both of its x modes, on cases that reach its tile and x
edges, its spread form (the small parts' variant) and the geometry its
rule picks also bit for bit with the plain version run on the CPU, in the
write and the accumulate mode and at an x base; and K1 where the JAX
package would run K5 or K6, timed there), then
drives four main paths end to end through the CLI and checks each against
the exact-f64 oracle:

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
``permuted_poisson_1024`` on its own resident path; K1 and the window
cache both on ``permuted_poisson_1024`` forced past the residency limit,
where the TPU runs K3), beside one cuSPARSE call
(``torch.sparse_csr_tensor`` matvec) as
a yardstick, with K1 and K9 also in their other x mode, in turns (K9
also at the three DIA rows too small to fill the card at its default
geometry, ``stencil27_24``, ``poisson2d_512`` and ``fem3d_32``, in turns
with the default where its rule takes the spread form), and
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

Last, the sharded path (``ehyb_spmv_torch/parallel/``), whose rank's
apply is K1 over its interior row blocks, K1 over the rest and K9 with an
x base adding the diagonals into K1's y (the shard's plan holds its ER
and long rows): K1 with a row-block list against its plain version (a
sharded stencil's interior, boundary, both and empty lists, row blocks
cut for the 16-bit range, Kahan, at every built variant), its split
variants over lists of work items (a heavy-tailed matrix's shards in f32
and f64, plain and Kahan), K9 with an x base (both modes, f32 and f64);
``ShardedEhybSpmv`` at one rank on ``permuted_poisson_1024`` with no
process group, through the graph loop (its launch counts set to 0 before
it and read after: K1 and K9 once an apply; against the oracle, the
flagship and, in turns, the flagship's graph loop; a step profiled: K1,
K9 and the chain add, nothing else); two and four gloo ranks on the one
card (``parallel/launch.py``; NCCL refuses two ranks on one device), each
rank's interior and boundary row blocks, its K1 and K9 launches an apply,
the exchange size and its eager µs per apply (the ranks share the card:
not scaling); the sharded K1 per rank and list, timed on its own; the
sharded routed engine at one rank on ``random_1m`` and, with the sharded
degree split, at two ranks on small matrices; last (16e)
``ShardedDegreeSplitSpmv`` at one rank on ``powerlaw_1m`` at full size,
its host setup built in the background from phase 1 on
(``scripts_torch/prewarm.py --models ehyb_split_sharded``), against the
oracle, its graph loop and its dense rows' K1 over a list of work items
timed.  The ``kernels`` line lists the sharded K1 (also on powerlaw_1m's
dense rows) and K9 with an x base beside the others.

Then the precision mode (``--dword``: f64 values, x, y and sums; phase 17):
K1 and K9 in f64 against their f64 plain versions (rel <= 1e-12) on the
f64 layouts of the K1 cases, the edge body, the stress matrix of
``tests/test_dword.py`` and K9's cases with odd and negative offsets, and
K1 f64 over each plan form (the table form, direct columns, grouped rows;
``ops/stream_cells.py``) on scattered, mixed and cancellation bodies, bit
for bit; ``permuted_poisson_512 --dword`` at full size through the CLI
(rel <= 1e-12 against the oracle, K1 f64 launched, the window cache not)
beside the f32 row; ``fem3d_68_audikw_class --dword`` (K9 f64 on its DIA
part, K1 f64 on the rest); then K1 f64 timed at both shapes (at pp512 also
over the table form in body order, in turns with the shipped plan) and K9
f64 (also at fem3d_68's 99 diagonals) beside both bounds at 8-byte values,
their plain versions and cuSPARSE in f64.  Last
the small gate (phase 18): ``ehyb`` on ``random_16k`` and
``powerlaw_16k``, each with a fresh cache, times the candidate engine
against the body through the graph loop and keeps the one the 5% rule
picks; a warm setup reads the verdict without measuring, and
``stencil3d(24, 27)`` keeps the body without measuring; then K1 on
powerlaw_16k's body, its small form (hub rows apart) against its parent
split form in turns, and powerlaw_16k's step under the graph loop split
by kernel (``profile_path``).  The ``kernels`` line gains
``ehyb_stream_body (f64)`` at both shapes and ``dia (f64)``.

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
rel error, setup and wall; random_4m must launch the routed kernel once a
product.  Then K1 on powerlaw_1m's dense sub-matrix (the degree split's
EHYB part, from the prewarmed cache), plain and compensated, and (20e)
the routed kernel on random_4m's one plan over its four column blocks
(a direct plan), against its plain version, bit for bit twice, timed
beside cuSPARSE over the same entries, and its graph loop profiled.

The routed kernel's plans: phase 4 holds it over staged plans at two part
counts and over direct plans (x read through L2, the rule's choice at
random_4m's density), bit for bit against the CPU replay of its order of
sums (``route_xcache.route_xcache_replay``).

Last, K1's split variants in float64 and compensated (phase 21): against
their plain versions on small bodies that reach chunked table and direct
pieces, a grouped plan and a row block at the threshold (bit for bit in
float64, within KERNEL_TOL in float32 with Kahan), with the cancellation
rows only they keep; the split form's small form (``check_k1_small``:
hub rows apart, short items, a fixed fold) against its plain version on
small bodies that reach hubs of one chunk and of many, a fold past 32
partials, table and direct pieces, cut row blocks and a grouped row map
(bit for bit, float32 Kahan within KERNEL_TOL), also under CUDA-graph
replays; powerlaw_16k in ``--dword``, ``--dtype float64
[--compensated]`` and ``--compensated`` (each against the oracle, K1 over
its small form against the parent split form in turns and cuSPARSE in its
type);
and ``powerlaw_1m --dword`` at full size through the CLI (its host
artifact built in the background by ``scripts_torch/prewarm.py --dword``,
as is fem3d_68 ``--dword``'s for phase 17c).  The ``kernels`` line ends
with K1 on the heavy-tailed bodies.

Where K1 runs, its plan holds the EHYB tail (ER, long-row and hub-split
entries as cells of their true rows, ``stream_cells.k1_folded_plan``) and
K9 adds the diagonals into K1's y.  Phase 10 holds both against their
plain versions on small artifacts with such rows (the whole apply bit for
bit against the CPU) and K9's accumulate mode at pp512 (timed beside its
write mode); phase 12 fails if a step of the flagship at pp512 launches
any kernel but K1, K9 and the chain add; 21c reports powerlaw_1m
``--dword`` with its tail inside K1.  The ``kernels`` line gains the apply
at pp512 (its step, the kernels a step launches, ``bcoo``'s step) and K9's
accumulate mode.

Imports only the port (never JAX or the JAX package).  Exits non-zero when
any phase fails or no CUDA device is present.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import copy
import dataclasses
import json
import math
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
from ehyb_spmv_torch.models.hybrid import degree_split_stats
from ehyb_spmv_torch.models.solver import CgSolver, PowerIteration
from ehyb_spmv_torch.ops import dia, ehyb_stream, ehyb_wincache, route
from ehyb_spmv_torch.ops import route_xcache, stream_plan
from ehyb_spmv_torch.ops.build import BUILD_DIR
from ehyb_spmv_torch.ops import stream_cells
from ehyb_spmv_torch.ops.stream_cells import (DIRECT_BELOW, ITEM_PIECE,
                                              PIECE_CELL, PIECE_RB,
                                              PIECE_ROW, build_stream_cells,
                                              k1_folded_plan, k1_options,
                                              list_items, small, split)
from ehyb_spmv_torch.parallel import launch
from ehyb_spmv_torch.parallel.comm import rank_device
from ehyb_spmv_torch.parallel.hybrid import ShardedDegreeSplitSpmv
from ehyb_spmv_torch.parallel.routed import ShardedRoutedSpmv
from ehyb_spmv_torch.parallel.shard_cells import build_shard_cells
from ehyb_spmv_torch.parallel.spmv import (ShardedEhybSpmv, plan_sharded,
                                           shard_matrix)
from ehyb_spmv_torch.ops.torch_ops import (body_gather_index, combine_ehyb,
                                           ehyb_body, ehyb_er, ehyb_long)
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
#: The flagship's apply at permuted_poisson_512 as a whole: K1 over the
#: plan with the EHYB tail folded in, then K9 adding the diagonals into
#: its y (where the TPU runs K1, K9 and the XLA ER, long-row and combine
#: phases).
_XLA = "ehyb_spmv_gpu_tpu/ops/xla_ops.py"
APPLY = {"name": "ehyb apply (K1 with the tail, then K9 into its y)",
         "route": "cuda",
         "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu, "
                   "ehyb_spmv_torch/csrc/dia.cu",
         "replaces": f"{_PALLAS}:148 (K1), ehyb_spmv_gpu_tpu/ops/"
                     f"dia_pallas.py:68 (K9), {_XLA}:142 (ER), {_XLA}:157 "
                     f"(long rows), {_XLA}:170 (combine)"}
#: A step of the chained loop before K1 took the tail (PERF.md, the graph
#: loop on an H100 at 700 W): us per iteration, the lowest and highest.
PARENT_STEP_US = {"permuted_poisson_512": (26.53, 26.84),
                  "fem3d_68_audikw_class": (152.87, 155.09),
                  "permuted_poisson_4096": (566.62, 581.52),
                  "powerlaw_1m --dword": (1420.0, 1420.0)}
#: A step of ``ehyb_sharded`` at one rank on permuted_poisson_1024 before
#: its apply took the tail into K1 and the diagonals into K9 (PERF.md, the
#: graph loop on an H100 at 700 W): us.
PARENT_SHARDED_STEP_US = 64.63
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
#: K1's split variant on powerlaw_1m's dense sub-matrix (the degree split's
#: EHYB part, phase 20), and its small form on powerlaw_16k's body (phase
#: 18; hub rows apart).
K1_LONG_1M = dict(K1, name="ehyb_stream_body (long rows, powerlaw_1m split)")
K1_LONG_16K = dict(K1, name="ehyb_stream_body (small form, powerlaw_16k)")
#: The heavy-tailed test body of phase 3 (``tests/conftest.py``'s
#: powerlaw_small).
POWERLAW_SMALL = dict(dim=3000, avg_nnz_per_row=16, seed=5, power_law=0.8)
#: K1 f64 at the precision mode's second shape: fem3d_68's body.
K1F64_FEM = dict(K1F64, name="ehyb_stream_body (f64, fem3d_68 --dword)")
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
#: K1's small form in float64 and compensated (phase 21b): at
#: powerlaw_16k in each config of ``HEAVY_CONFIGS``; and the split variant
#: at powerlaw_1m in the precision mode.
K1_SPLIT = {
    "--dword": dict(K1F64, name="ehyb_stream_body (f64, small form, "
                                "powerlaw_16k --dword)"),
    "--dtype float64": dict(K1F64, name="ehyb_stream_body (f64, small "
                                        "form, powerlaw_16k --dtype "
                                        "float64)"),
    "--dtype float64 --compensated": dict(
        K1F64K, name="ehyb_stream_body (f64, Kahan, small form, "
                     "powerlaw_16k --dtype float64 --compensated)"),
    "--compensated": dict(
        K1, name="ehyb_stream_body (Kahan, small form, powerlaw_16k "
                 "--compensated)",
        replaces=f"{_PALLAS}:148 (K1, kahan=True)")}
K1_SPLIT_1M = dict(K1F64, name="ehyb_stream_body (f64, long rows, "
                               "powerlaw_1m --dword)")
#: The sharded K1 over a heavy-tailed shard: powerlaw_1m's dense rows
#: (``ehyb_split_sharded`` at one rank, phase 16e), its split form through
#: a list of work items, the tail folded in.
SK1_SPLIT_1M = dict(SK1, name="ehyb_stream_body (work-item list, "
                              "powerlaw_1m dense rows, ehyb_split_sharded "
                              "world 1)")
#: K9 with an x base: the sharded apply's diagonals (phase 16b), where the
#: JAX sharded path runs its DIA in XLA.
K9_BASE = {"name": "dia (x base, ehyb_sharded permuted_poisson_1024 D=1)",
           "route": "cuda", "source": "ehyb_spmv_torch/csrc/dia.cu",
           "replaces": "ehyb_spmv_gpu_tpu/ops/dia_pallas.py:68 (K9); the "
                       "JAX sharded path's DIA is XLA "
                       "(ehyb_spmv_gpu_tpu/parallel/spmv.py:652)"}
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
#: The corpus's DIA rows whose default K9 grid leaves the card short of
#: one wave (K9 their only kernel), timed in phase 10.
SMALL_DIA_ROWS = ("stencil27_24", "poisson2d_512", "fem3d_32")
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
#: Phase 21b: powerlaw_16k in the configs whose K1 variants read the split
#: form besides plain float32 (the CLI's flags → config fields).
HEAVY_CONFIGS = {"--dword": dict(dword_values=True),
                 "--dtype float64": dict(dtype="float64"),
                 "--dtype float64 --compensated": dict(
                     dtype="float64", compensated_sum=True),
                 "--compensated": dict(compensated_sum=True)}
#: Phase 21c: powerlaw_1m in the precision mode at full size.  17c's host
#: artifact (fem3d_68 --dword) is built in the background from phase 9
#: on, 21c's from 17c on.
DWORD_1M_ARGS = ["-g", "powerlaw_1m", "--model", "ehyb", "-i", "50",
                 "--json", "--device", "cuda", "--dword"]
PREBUILD_FEM_ARGS = ("--models", "ehyb", "--dword", "fem3d_68_audikw_class")
#: Phase 16e's host setup: powerlaw_1m's sharded degree split at one rank,
#: in the sharded path's config (1024-row windows).
PREBUILD_SHARDED_ARGS = ("--models", "ehyb_split_sharded", "--window-rows",
                         "1024", "powerlaw_1m")
PREBUILD_DWORD_ARGS = ("--models", "ehyb", "--dword", "powerlaw_1m")
#: fem3d_68 --dword's K1 plan with its 1,865,876 ER entries folded in, as
#: the fold first built it (its widest row block, 80 steps, is not past
#: ``SPLIT_STEPS_F64``, so it takes no split form; the body alone, before
#: the fold: 78 steps, 137 table rows, 65,648,544 cells): the plan must
#: not move.
FEM_DWORD_PLAN = dict(n_rb=29480, n_pieces=29480, max_width=80,
                      max_table_rows=191, compact_cells=68224608,
                      cell_bytes=682246080, map_bytes=2823964)
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


def long_body(steps: int, seed: int = 5) -> port.EhybMatrix:
    """A synthetic ``sell_mw`` body (nwin 1) that reaches the edges of K1's
    split form at ``split_steps = steps``: in slice 0 a row block exactly
    ``steps`` wide (kept whole), one ``steps + 1`` wide (two chunks), one
    with no cell and one of short rows, some empty; slice 1 is ragged (its
    last 55 rows hold nothing); the last slice's last row block holds a hub
    row ``5 steps + 3`` wide in its last row, beside rows of random lengths
    up to it.  Every step reads a window of 1,024 columns at a random,
    unaligned start (up to 9 x rows of 128), so past ~60 steps a row
    block's table outgrows 16 bits and the hub block's chain is cut there
    too; each of its chunks but the last ends inside the chain."""
    rng = np.random.default_rng(seed)
    win, n_win = 1024, 512
    hub = 5 * steps + 3
    widths = (steps + 1, steps, hub)
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    n_steps = int(offs[-1])
    step_win = rng.integers(0, (n_win - 1) * win, n_steps).astype(np.int32)
    ell_col = rng.integers(0, win, (n_steps, 128)).astype(np.int16)
    length = np.zeros((3, 128), np.int64)
    length[0, :32] = rng.integers(0, steps + 1, 32)
    length[0, 0] = steps                        # the row block at the limit
    length[0, 32:64] = rng.integers(0, steps + 1, 32)
    length[0, 32] = steps + 1                   # just past it: two chunks
    length[0, 96:] = rng.integers(0, steps // 2 + 1, 32)
    length[0, 100:104] = 0                      # rows 64-95 and these: empty
    length[1, :73] = rng.integers(0, steps + 1, 73)
    length[1, 0] = steps
    length[2, :96] = rng.integers(0, 3, 96)
    length[2, 96:] = rng.integers(0, hub + 1, 32)
    length[2, 127] = hub                        # the hub, the last row
    ell_val = np.zeros((n_steps, 128), np.float32)
    for s, w in enumerate(widths):
        on = np.arange(w)[:, None] < length[s][None, :]
        ell_val[offs[s]:offs[s + 1]] = np.where(
            on, rng.standard_normal((w, 128)), 0.0)
    nnz = int(np.count_nonzero(ell_val))
    i32, f32 = np.int32, np.float32
    return port.EhybMatrix(
        dim=n_win * win, nnz_total=nnz, window_rows=win, n_parts=1,
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


def padded_k1(e, x: torch.Tensor, kahan: bool, fold: bool) -> torch.Tensor:
    """What K1 computes over artifact ``e`` (on x's device), from the padded
    body's plain version: the body's sums, and with ``fold`` the EHYB tail
    added as the combine adds it (the body's rows)."""
    y = ehyb_body(e, x, compensated=kahan)
    if not fold:
        return y
    return combine_ehyb(e, y, ehyb_er(e, x), ehyb_long(e, x))[:y.shape[0]]


def check_k1_case(name: str, e, x: np.ndarray, kahan: bool, dev,
                  cells=None, table: bool = False) -> None:
    """K1 over the compact plan of body ``e`` (an EhybMatrix, f32 or f64
    values) at every geometry of :func:`k1_geometries` for its type:
    against its plain version and the padded body's within KERNEL_TOL
    (F64_TOL in f64), and bit for bit against the plain version on the CPU
    (which adds in the kernel's order) where Kahan is off or the type is
    f64 (whose plain version compensates in the kernel's order).  In f64
    both plain versions run on the CPU: on the card they add with atomics
    in no fixed order, and a naive f64 sum of the cancellation matrix
    depends on the order.  ``cells``, the plan on the card, defaults to a
    fresh build of ``e``'s (``k1_options``: in f64, direct pieces and grouped
    rows where the body is scattered; the split form where a row block is
    wider than the threshold of its type, at the split variants'
    geometries; with ``table``, the table form whatever the widths).  A
    flagship's plan (``cells`` folded: ``k1_folded_plan``) holds the EHYB
    tail, and is held to the padded body's sums with the tail added."""
    f64 = e.ell_val.dtype == np.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    exact = f64 or not kahan
    fold = cells is not None and cells.stats["folded"]
    plan = build_stream_cells(e, fold=fold,
                              **({} if table else k1_options(e)))
    p = plan.to_torch(dev) if cells is None else cells
    x_dev = torch.as_tensor(
        x, dtype=torch.float64 if f64 else torch.float32, device=dev)
    y_cpu = ehyb_stream.stream_body_plain(plan.to_torch(), x_dev.cpu(),
                                          kahan)
    on = "cpu" if f64 else dev
    y_p = y_cpu.to(on) if f64 else ehyb_stream.stream_body_plain(p, x_dev,
                                                                 kahan)
    y_pad = padded_k1(e.to_torch(device=on), x_dev.to(on), kahan, fold)
    worst, same = 0.0, True
    geometries = split_geometries() if split(p) else k1_geometries(f64)
    for g in geometries:
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
          f"{st['split_rbs']} cut into pieces, max width "
          f"{st['max_width']}; {st['compact_cells']} of {st['padded_cells']} "
          f"cells, {st['tail_cells']} of them the tail's"
          f"{', f64' if f64 else ''}{', Kahan' if kahan else ''}): "
          f"{len(geometries)} geometries, vs plain and the padded "
          f"body rel <= {worst:.3e} <= {tol}"
          + ("; bit for bit with the plain version on the CPU" if exact
             else ""))


def split_geometries():
    """The split variant's geometries (it is built at one row a thread, x
    through L1/L2) at 128 threads, and the shipped one."""
    return [ehyb_stream.StreamGeometry(threads=128),
            ehyb_stream.SPLIT_GEOMETRY]


def replay_split(p, x_cpu: list, dev, g, kahan: bool = False) -> bool:
    """K1's split variant (compensated where ``kahan``) at geometry ``g``
    captured in one CUDA graph over plan ``p`` and replayed once for each x
    of ``x_cpu``: whether every replay's y equals the plain version on the
    CPU bit for bit (the in-launch combine puts its counters back to 0, so
    each replay starts clean)."""
    p_cpu = copy.deepcopy(p).cpu()
    x_buf = x_cpu[0].to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        ehyb_stream._launch(p, x_buf, kahan, g)
        with torch.cuda.graph(graph, stream=side):
            y_buf = ehyb_stream._launch(p, x_buf, kahan, g)
    torch.cuda.synchronize()
    same = True
    for x in x_cpu:
        x_buf.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(
            y_buf.cpu(), ehyb_stream.stream_body_plain(p_cpu, x, kahan))
    del graph
    return same


def check_k1_split(dev) -> None:
    """Phase 3's split form: K1's split variant on the synthetic long body
    (``long_body``) and on powerlaw_small's flagship body, each at a small
    ``split_steps`` (4) and at the shipped ``SPLIT_STEPS``, at every built
    split geometry, bit for bit against the plain version on the CPU and
    within KERNEL_TOL of the padded body's; then each geometry replayed in
    a CUDA graph over three x (the in-launch combine's counters are back at
    0 after each); then the powerlaw_small flagship (the split form as
    shipped) against the oracle, K1 launched."""
    rng = np.random.default_rng(11)
    shipped = stream_cells.SPLIT_STEPS
    m = generate.random_general(**POWERLAW_SMALL)
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    cells = model.module.cells
    check(split(cells) and model.dev.ell_val is None,
          f"powerlaw_small's flagship body in the split form: "
          f"{cells.stats['chunked_rbs']} row blocks in "
          f"{cells.stats['n_chunks']} chunks of at most "
          f"{cells.stats['split_steps']} steps")
    for steps in (4, shipped):
        with patched_split(steps):
            for name, e in ((f"long body {steps}", long_body(steps)),
                            (f"powerlaw_small {steps}", model.ehyb)):
                x = rng.standard_normal(e.padded_x_rows)
                check_k1_case(name, e, x, False, dev,
                              cells if e is model.ehyb and steps == shipped
                              else None)
                # the split form itself (a small body's shipped plan
                # takes its small form, check_k1_small's)
                st = build_stream_cells(e, **k1_options(e, lists=True)).stats
                check(st["chunked_rbs"] > 0
                      and st["max_item_steps"] <= steps,
                      f"{name}: {st['chunked_rbs']} row blocks in "
                      f"{st['n_chunks']} chunks, {st['n_items']} work "
                      f"items of at most {st['max_item_steps']} steps")
        plan = build_stream_cells(long_body(steps), split_steps=steps)
        p = plan.to_torch(dev)
        xs = [torch.from_numpy(rng.standard_normal(
            plan.stats["x_rows"]).astype(np.float32)) for _ in range(3)]
        for g in split_geometries():
            check(replay_split(p, xs, dev, g),
                  f"long body {steps} at {g}: three CUDA-graph replays bit "
                  "for bit with the plain version on the CPU")
    reset_launches()
    x = deterministic_x(m.dimension)
    err = rel_np(model.matvec(x), oracle_spmv(m, x))
    check(err <= ORACLE_TOL and ehyb_stream.stream_body.launches == 1,
          f"powerlaw_small flagship vs oracle rel {err:.3e} <= {ORACLE_TOL}, "
          f"K1 launched {ehyb_stream.stream_body.launches} times")


#: The split form's thresholds and chunk lengths (``ops/stream_cells.py``).
SPLIT_NAMES = ("SPLIT_STEPS", "SPLIT_STEPS_F64")


@contextlib.contextmanager
def patched_split(steps: int):
    """Every split threshold and chunk length of ``stream_cells`` at
    ``steps`` for the length of a ``with`` block."""
    old = {k: getattr(stream_cells, k) for k in SPLIT_NAMES}
    for k in SPLIT_NAMES:
        setattr(stream_cells, k, steps)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(stream_cells, k, v)


def f64_body(e, seed: int):
    """Body ``e`` with float64 values in place of its own (random where a
    cell is real)."""
    e = copy.copy(e)
    rng = np.random.default_rng(seed)
    e.ell_val = np.where(e.ell_val != 0, rng.standard_normal(
        e.ell_val.shape), 0.0)
    return e


def split_variant_bodies():
    """Phase 21a's bodies, (name, body, steps): each reaches a form of the
    split variants at ``split_steps = steps`` (every threshold patched)."""
    m = generate.random_general(**POWERLAW_SMALL)
    f64 = port.EhybSpmv(port.EhybConfig(dtype="float64"),
                        device="cpu").setup(m).ehyb
    dword = port.EhybSpmv(port.EhybConfig(dword_values=True), device="cpu") \
        .setup(generate.permuted(generate.poisson2d(96), seed=3)).ehyb
    shipped = stream_cells.SPLIT_STEPS_F64
    return [("powerlaw_small f64 (table pieces) 4", f64, 4),
            ("long body f64 (direct pieces) 4", f64_body(long_body(4), 8), 4),
            (f"long body f64 {shipped}", f64_body(long_body(shipped), 9),
             shipped),
            ("pp96 --dword (grouped rows) 2", dword, 2),
            ("long body 4", long_body(4), 4),
            (f"long body {stream_cells.SPLIT_STEPS}",
             long_body(stream_cells.SPLIT_STEPS), stream_cells.SPLIT_STEPS),
            ("powerlaw_small 4", port.EhybSpmv(port.EhybConfig(
                routed_delegate="never"), device="cpu").setup(m).ehyb, 4)]


def check_k1_split_variants(dev) -> None:
    """Phase 21a: the split variants in float64 (plain and Neumaier) and
    the compensated one in float32 against their plain versions through
    :func:`check_k1_case`, bit for bit in float64 and within KERNEL_TOL in
    float32 with Kahan, on bodies that reach a chunked table piece, a
    chunked direct piece, a chunked grouped row block (y through the row
    map) and a row block exactly at the threshold (kept whole); each
    variant replayed in a CUDA graph over three x; then the cancellation
    rows, which only the compensated split variants keep."""
    rng = np.random.default_rng(21)
    reached = set()
    for name, e, steps in split_variant_bodies():
        with patched_split(steps):
            plan = build_stream_cells(e, **k1_options(e))
            f64 = plan.cell_val.dtype == np.float64
            piece = plan.piece.astype(np.int64)
            chunked = np.flatnonzero(plan.piece_slot >= 0)
            tables = np.diff(piece[:, 1])[chunked]
            cells = np.diff(piece[:, 0])[chunked]
            width = np.bincount(piece[:-1, PIECE_RB],
                                weights=np.diff(piece[:, 0]) // 32,
                                minlength=plan.n_rb)
            at_limit = np.flatnonzero(width == steps)
            forms = {"table": bool(np.any(tables > 0)),
                     "direct": bool(np.any((tables == 0) & (cells > 0))),
                     "grouped": bool(plan.row_map.size),
                     "at the limit": bool(at_limit.size) and not np.any(
                         np.isin(at_limit, plan.chunk_rb))}
            reached |= {f"{'f64' if f64 else 'f32'} {k}"
                        for k, v in forms.items() if v}
            check(split(plan), f"{name}: {plan.stats['chunked_rbs']} row "
                               f"blocks in {plan.stats['n_chunks']} chunks "
                               f"of at most {steps} steps; reaches "
                               f"{[k for k, v in forms.items() if v]}")
            x = rng.standard_normal(e.padded_x_rows)
            for kahan in (False, True) if f64 else (True,):
                check_k1_case(f"{name}{' kahan' if kahan else ''}", e, x,
                              kahan, dev)
                if not f64:
                    continue
                # the float32 Kahan variant is the same template: its
                # combine's counters are held here, in float64
                p = plan.to_torch(dev)
                xs = [torch.from_numpy(rng.standard_normal(e.padded_x_rows))
                      for _ in range(3)]
                check(replay_split(p, xs, dev, ehyb_stream.geometry_of(p),
                                   kahan),
                      f"{name}{' kahan' if kahan else ''}: three CUDA-graph "
                      "replays bit for bit with the plain version on the CPU")
    want = {"f64 table", "f64 direct", "f64 grouped", "f64 at the limit",
            "f32 table", "f32 at the limit"}
    check(want <= reached, f"the bodies reach {sorted(reached)}")
    for f64, m in ((True, cancellation_matrix_f64()),
                   (False, cancellation_matrix())):
        cfg = port.EhybConfig(body_layout="sell_rx", relax_body="never",
                              compensated_sum=True,
                              dtype="float64" if f64 else "float32")
        with patched_split(4):
            model = port.EhybSpmv(cfg, device=dev).setup(m)
        p = model.module.cells
        r0 = int(model.reordering.old_to_new[0])
        # the body row's exact sum (x all ones)
        s, lane = divmod(r0, 128)
        offs = model.ehyb.slice_offset
        exact = math.fsum(model.ehyb.ell_val[offs[s]:offs[s + 1],
                                             lane].tolist())
        x = torch.ones(p.stats["x_rows"], device=dev,
                       dtype=torch.float64 if f64 else torch.float32)
        got = {k: float(ehyb_stream.stream_body(p, x, k)[r0])
               for k in (False, True)}
        check(split(p) and r0 // 32 in p.chunk_rb.tolist()
              and got[True] == exact and got[False] != exact,
              f"cancellation row in {'f64' if f64 else 'f32'}, its row "
              f"block in chunks of 4 steps: the compensated split variant "
              f"{got[True]!r} == {exact}, the plain one {got[False]!r}")
    for kahan, f64 in ((True, False), (False, True), (True, True)):
        g = ehyb_stream.SPLIT_GEOMETRY
        blocks = ehyb_stream.resident_blocks(g, kahan, dev, f64, split=True)
        print(f"  split variant {'f64' if f64 else 'f32'}"
              f"{' Kahan' if kahan else ''}: "
              f"{ehyb_stream.registers(g, kahan, f64, split=True)} "
              f"registers, {blocks} blocks of {g.threads} threads resident "
              "on an SM")


@contextlib.contextmanager
def patched_module(module, **values):
    """``module``'s attributes set to ``values`` for the length of a
    ``with`` block."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def small_cases():
    """Phase 21a's bodies of K1's small form, (name, body, patches of
    ``stream_cells``): powerlaw_small in float32 (as shipped: hub chunks
    of 16 steps; then chunks of one step, its widest hub's fold of 51
    partials), in float64 (table and direct pieces) and in the precision
    mode, pp96 with three dense rows in the precision mode (direct
    pieces, the dense rows its hubs, a fold of 145 partials at one-step
    chunks), pp96 in the precision mode, its rows of more than two cells
    hubs (grouped rows: y through the row map), and the long body at 128
    steps with hubs past 100 cells (row blocks cut into pieces between
    their steps, each piece with a 16-bit table)."""
    m = generate.random_general(**POWERLAW_SMALL)
    body = lambda cfg, mat=m: port.EhybSpmv(  # noqa: E731
        port.EhybConfig(routed_delegate="never", **cfg),
        device="cpu").setup(mat).ehyb
    f32 = body({})
    return [("powerlaw_small", f32, {}),
            ("powerlaw_small, hub chunks of 1", f32, {"HUB_STEPS": 1}),
            ("powerlaw_small f64", body({"dtype": "float64"}), {}),
            ("powerlaw_small --dword", body({"dword_values": True}), {}),
            ("pp96 with three dense rows --dword", body(
                {"dword_values": True}, generate.with_dense_rows(
                    generate.permuted(generate.poisson2d(96), seed=3), 3,
                    0.5)), {"HUB_STEPS": 1}),
            ("pp96 --dword", body({"dword_values": True}, generate.permuted(
                generate.poisson2d(96), seed=3)),
             {"SPLIT_STEPS_F64": 3, "SMALL_STEPS": 2}),
            ("long body 128", long_body(128),
             {"SPLIT_STEPS": 128, "SMALL_STEPS": 100})]


def check_k1_small(dev) -> None:
    """K1's small form (``stream_cells.small``) against its plain version
    on the CPU, bit for bit (within KERNEL_TOL in float32 with Kahan), at
    128 and 512 threads and the shipped geometry, plain and Kahan, in
    float32 and float64, on bodies that reach hubs apart, hub chunks of
    one step and of several, a fold past 32 partials, table and direct
    pieces, row blocks of several pieces and a grouped row map; each
    variant also replayed in a CUDA graph over three x (the counters back
    at 0 after each), and a list refused."""
    rng = np.random.default_rng(3)
    reached = set()
    for name, e, patch in small_cases():
        with patched_module(stream_cells, **patch):
            plan = build_stream_cells(e, **k1_options(e))
        st = plan.stats
        f64 = plan.cell_val.dtype == np.float64
        tables = np.diff(plan.piece[:, PIECE_ROW]) > 0
        forms = {"hubs": st["n_hubs"] > 0, "one-step chunks":
                 st["hub_steps"] == 1, "longer chunks": st["hub_steps"] > 1,
                 "fold past 32": st["max_fold"] > 32,
                 "table pieces": bool(tables.any()),
                 "direct pieces": st["direct_pieces"] > 0,
                 "cut row blocks": st["split_rbs"] > 0,
                 "grouped": st["grouped"]}
        reached |= {k for k, v in forms.items() if v}
        check(small(plan), f"{name}: the small form ({st['n_hubs']} hubs, "
                           f"{st['hub_items']} hub items of at most "
                           f"{st['hub_steps']} steps, widest fold "
                           f"{st['max_fold']}, {st['n_items']} items; "
                           f"{[k for k, v in forms.items() if v]})")
        p = plan.to_torch(dev)
        p_cpu = plan.to_torch()
        dt = torch.float64 if f64 else torch.float32
        x = torch.from_numpy(rng.standard_normal(st["x_rows"])).to(dt)
        for kahan in (False, True):
            want = ehyb_stream.stream_body_plain(p_cpu, x, kahan)
            exact = f64 or not kahan
            for g in small_geometries():
                y = ehyb_stream._launch(p, x.to(dev), kahan, g).cpu()
                ok = torch.equal(y, want) if exact else \
                    rel(y, want) <= KERNEL_TOL
                check(ok, f"{name}{' Kahan' if kahan else ''} at {g}: "
                          + ("bit for bit with" if exact else
                             f"rel {rel(y, want):.3e} from")
                          + " the plain version on the CPU")
            if exact:
                xs = [torch.from_numpy(rng.standard_normal(
                    st["x_rows"])).to(dt) for _ in range(3)]
                check(replay_split(p, xs, dev, ehyb_stream.SMALL_GEOMETRY,
                                   kahan),
                      f"{name}{' Kahan' if kahan else ''}: three CUDA-graph "
                      "replays bit for bit with the plain version on the "
                      "CPU")
    want = {"hubs", "one-step chunks", "longer chunks", "fold past 32",
            "table pieces", "direct pieces", "cut row blocks", "grouped"}
    check(want <= reached, f"the small bodies reach {sorted(reached)}")
    try:
        ehyb_stream.stream_body(p, x.to(dev), rb_list=torch.zeros(
            1, dtype=torch.int32, device=dev))
        refused = False
    except ValueError:
        refused = True
    check(refused, "a list over a plan in the small form is refused")
    for kahan, f64 in itertools.product((False, True), (False, True)):
        g = ehyb_stream.SMALL_GEOMETRY
        print(f"  small form {'f64' if f64 else 'f32'}"
              f"{' Kahan' if kahan else ''}: "
              f"{ehyb_stream.small_registers(kahan, f64)} registers, "
              f"{ehyb_stream.small_resident_blocks(g, kahan, dev, f64)} "
              f"blocks of {g.threads} threads resident on an SM")


def small_geometries():
    """The small form's geometries checked: 128 and 512 threads a block,
    and the shipped one."""
    return [ehyb_stream.StreamGeometry(threads=t, blocks_per_sm=4)
            for t in (128, 512)] + [ehyb_stream.SMALL_GEOMETRY]


def time_k1_split(name: str, model, dev, x_dev: torch.Tensor,
                  table: bool = True, kahan: bool = None,
                  library_ms: float = None) -> dict:
    """K1 on a heavy-tailed body (``model``'s, in the split form; with
    ``kahan``, None for the model's, its compensated variant): the shipped
    plan, in turns where ``table`` against its parent (a plan in the small
    form: the split form without it, ``k1_options(e, lists=True)``; else
    the table form, the plan without the split form, each row block walked
    by one warp),
    held to the plain version on the CPU (bit for bit, or within
    KERNEL_TOL in float32 with Kahan) and to the float64 sums (the plan's
    plain version in float64) at the suite's bound; beside the
    plain version's time on the card, cuSPARSE over the body's entries in
    the body's type (``library_ms`` where given) and both bounds."""
    p = model.module.cells
    st = p.stats
    kahan = model.module.kahan if kahan is None else kahan
    f64 = p.cell_val.dtype == torch.float64
    tol = F64_TOL if f64 else ORACLE_TOL
    what = f"{'f64 ' if f64 else ''}{'Kahan ' if kahan else ''}"
    check(split(p) and st["n_items"] > 0,
          f"{name}: K1's plan in the split form ({st['chunked_rbs']} row "
          f"blocks in {st['n_chunks']} chunks of at most "
          f"{st['split_steps']} steps, {st['n_hubs']} hub rows apart, "
          f"{st['n_items']} work items)")
    t0 = time.perf_counter()
    # a plan in the small form is held to its parent, the split form
    # (k1_options' plan for lists); any other to the table form
    parent = small(p)
    opts = k1_options(model.ehyb, lists=True) if parent else {}
    what_walk = "the parent split form" if parent else "the table form"
    walk = build_stream_cells(model.ehyb, fold=st["folded"],
                              **opts).to_torch(dev) if table else None
    t_build = time.perf_counter() - t0
    y_k = ehyb_stream.stream_body(p, x_dev, kahan)
    p_cpu, x_cpu = copy.deepcopy(p).cpu(), x_dev.cpu()
    y_cpu = ehyb_stream.stream_body_plain(p_cpu, x_cpu, kahan)
    if f64 or not kahan:
        check(torch.equal(y_k.cpu(), y_cpu), f"{name}: the {what}split "
              "variant bit for bit with the plain version on the CPU")
    else:
        err = rel(y_k.cpu(), y_cpu)
        check(err <= KERNEL_TOL, f"{name}: the {what}split variant vs the "
                                 f"plain version rel {err:.3e}")
    max_abs = float((y_k.cpu() - y_cpu).abs().max())
    # the float64 sums: the plan's plain version on the CPU in float64 (the
    # card's plain version adds hub rows of ~1e5 entries with atomics in
    # no fixed order, so it is timed, not held to)
    exact = y_cpu if f64 and not kahan else ehyb_stream.stream_body_plain(
        p_cpu, x_cpu.double())
    del p_cpu
    err_k = rel(y_k.cpu(), exact)
    err_t = rel(ehyb_stream.stream_body(walk, x_dev, kahan).cpu(),
                exact) if table else 0.0
    check(max(err_k, err_t) <= tol,
          f"{name}: the {'small' if parent else 'split'} form rel "
          f"{err_k:.3e}" + (f", {what_walk} rel {err_t:.3e}" if table
                            else "") + f" from the float64 sums <= {tol}")
    t_check = time.perf_counter() - t0 - t_build
    kernel = lambda: ehyb_stream.stream_body(p, x_dev, kahan)  # noqa: E731

    def calls(fn, budget_ms: float = 20.0) -> int:
        t = ms_per_call(fn, 1)
        return max(2, min(100, int(budget_ms / max(t, 1e-3))))

    if table:
        walk_fn = lambda: ehyb_stream.stream_body(walk, x_dev,  # noqa: E731
                                                  kahan)
        ms, table_ms, turns = in_turns(kernel, walk_fn, calls(kernel),
                                       calls(walk_fn))
    else:
        ms, table_ms = device_ms_per_call(kernel, calls(kernel)), None
        turns = (ms,)
    plain_ms = device_ms_per_call(
        lambda: ehyb_stream.stream_body_plain(p, x_dev, kahan), 3)
    lib_ms = body_library_ms(model, x_dev, dev) if library_ms is None \
        else library_ms
    nnz = st["real_cells"]
    b = bound(st["layout_bytes"], 2 * nnz, dev, f64)
    same = same_work_bound(nnz, 2, x_dev.numel(), y_k.numel(), dev,
                           8 if f64 else 4)
    t_time = time.perf_counter() - t0 - t_build - t_check
    g = ehyb_stream.geometry_of(p)
    form = (f"small form ({st['n_hubs']} hub rows apart in "
            f"{st['hub_items']} items of at most {st['hub_steps']} steps, "
            f"widest fold {st['max_fold']}, {st['compact_cells']} cells "
            f"for {st['real_cells']} entries, "
            if parent else
            f"split form ({st['split_steps']} steps a chunk, "
            f"{st['chunked_rbs']} of {st['n_rb']} row blocks in "
            f"{st['n_chunks']} chunks, ")
    ws = walk.stats if table else {}
    print(f"  K1 {what}at {name}: {form}"
          f"{st['n_items']} work items, longest {st['max_item_steps']} "
          f"steps, {st['n_pieces']} pieces, "
          f"{st['direct_pieces']} direct, "
          f"{'grouped' if st['grouped'] else 'body order'}; {g}; grid "
          f"{ehyb_stream.grid_of(p, g, kahan, dev)})"
          + ((f" against the parent split form ({ws['compact_cells']} "
              f"cells, {ws['n_items']} work items of at most "
              f"{ws['max_item_steps']} steps), device ms per call "
              f"(parent, small, small, parent): {turns}") if parent and table
             else (f" against the table form ({ws['n_pieces']} pieces, "
                   f"max width {ws['max_width']}), device ms per call "
                   f"(table, split, split, table): {turns}") if table else
             f", device ms per call {ms}")
          + f"; host seconds: {what_walk}'s build {t_build:.1f}, the "
          f"checks against the CPU {t_check:.1f}, the timing {t_time:.1f}")
    print("  " + ("" if not table else f"{what_walk} / the "
                  f"{'small' if parent else 'split'} form "
                  f"= {table_ms / ms:.2f}; ")
          + f"plain version {plain_ms:.4f} ms; cuSPARSE over its {nnz} "
          f"entries ({st['tail_cells']} of them the tail's; {x_dev.dtype}) "
          f"{lib_ms:.4f} ms (K1 / cuSPARSE = "
          f"{ms / lib_ms:.3f}); same-work bound {same['bound_ms']:.4f} ms "
          f"({same['bound_ms'] / ms:.3f} reached), layout bound "
          f"{b['bound_ms']:.4f} ms ({st['layout_bytes']} B: cells "
          f"{st['cell_bytes']}, maps {st['map_bytes']}, partials "
          f"{st['partial_bytes']}); {card_state()}")
    del walk
    out = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, **bounds(b, same))
    if table:
        out["parent_split_ms" if parent else "table_form_ms"] = table_ms
    if parent:
        out.update(cells=st["compact_cells"], items=st["n_items"],
                   longest_item=st["max_item_steps"],
                   widest_fold=st["max_fold"])
    return out


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


def check_plan(name: str, p, x: torch.Tensor) -> None:
    """The routed kernel over plan ``p`` against its plain version, bit for
    bit against the CPU replay of its fixed order of sums, and the same bits
    twice."""
    y_k = route_xcache.route_xcache(p, x)
    y_again = route_xcache.route_xcache(p, x)
    y_p = route_xcache.route_xcache_plain(p, x)
    torch.cuda.synchronize()
    err = rel(y_k, y_p)
    same = np.array_equal(y_k.cpu().numpy(),
                          route_xcache.route_xcache_replay(p, x))
    st = p.stats
    check(bool(torch.isfinite(y_k).all()) and err <= KERNEL_TOL and same
          and torch.equal(y_k, y_again),
          f"{name} ({'direct' if p.direct else 'staged'}: {st['n_tiles']} "
          f"tiles of {st['group_rows']} rows x {st['parts']} parts, "
          f"{p.chunk_cols} columns a chunk, {p.threads} threads; "
          f"{st['n_segs']} segments, {st['passes']} passes, "
          f"{st['entries']} entries): route_xcache vs plain rel {err:.3e}, "
          f"the CPU replay's bits {same}, the same bits twice")


def check_schedule(name: str, rm, ap, x: torch.Tensor) -> None:
    """The one-pass kernel on one schedule's plan against its plain version
    (and the replay of its order) and against the plain K7/K8 pair (the
    schedule's stage arrays uploaded for it), and the whole apply ``ap``
    against the pair's."""
    d = rm.to_torch(device=x.device)
    p = ap.plan
    check_plan(name, p, x)
    y_k = route_xcache.route_xcache(p, x)
    y_s = stages_plain(d, x)
    torch.cuda.synchronize()
    err_s = rel(y_k, y_s)
    check(err_s <= KERNEL_TOL, f"{name}: route_xcache vs the plain K7/K8 "
                               f"pair rel {err_s:.3e}")
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


def check_rx_geometries(dev) -> None:
    """The routed kernel over staged plans at two part and thread counts
    and over direct plans, against its plain version and bit for bit
    against the CPU replay, on a 131,072-row matrix cut into 16 groups;
    then the rule's own plans at random_1m's and random_4m's densities, on
    2^18 rows."""
    m = random_coo(1 << 17, 4, seed=29)
    model = port.RoutedSpmv(port.EhybConfig(), device=dev).setup(m)
    rm = model.blocks[0]
    x = model.prepare_x(deterministic_x(m.dimension))
    entries = route_xcache.decode_routed(rm)
    geometries = [dict(parts=1, threads=1024), dict(parts=2, threads=256),
                  dict(direct=True, chunk_windows=32, threads=256),
                  dict(direct=True, group_rows=1024, parts=2,
                       chunk_windows=64, threads=128)]
    for geometry in geometries:
        geometry = dict(dict(group_rows=8192, chunk_windows=4), **geometry)
        p = route_xcache.tile_entries(entries, rm.n_dst_rows,
                                      rm.padded_x_rows,
                                      **geometry).to_torch(dev)
        check_plan(f"{geometry}", p, x)
    n = 1 << 18
    rng = np.random.default_rng(31)
    for name, per_row, direct in (("random_1m", 4, False),
                                  ("random_4m", 0.5, True)):
        k = int(per_row * n)
        p = route_xcache.tile_entries(
            (np.sort(rng.integers(0, n, k)), rng.integers(0, n, k),
             rng.standard_normal(k).astype(np.float32)), n, n).to_torch(dev)
        kind = "direct" if p.direct else "staged"
        check(p.direct == direct, f"{name}'s density at {n} rows: the rule "
                                  f"picks a {kind} plan")
        check_plan(f"the rule at {name}'s density", p, torch.as_tensor(
            rng.standard_normal(n).astype(np.float32), device=dev))


def check_routed_small(dev) -> None:
    """Every layout of the TPU's routed schedule, on small matrices; the
    column blocks of one matrix in one plan; staged and direct plans."""
    cfg = port.EhybConfig()
    x_of = deterministic_x
    # slice layout, one block, identity dst
    m = generate.random_general(16384, 12, seed=3)
    model = port.RoutedSpmv(cfg, device=dev).setup(m)
    d = model.routed_apply.d
    check(len(model.blocks) == 1 and not model.blocks[0].octet and d.ident
          and isinstance(d, RoutedEpilogue),
          "slice: one block, slice layout, identity dst, no stage arrays on "
          "the card")
    check_schedule("slice", model.blocks[0], model.routed_apply,
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
    # column-block mode: the four blocks' entries in one plan
    m = random_coo(1 << 15, 8, seed=17)
    model = block_mode_model(m, dev)
    p = model.routed_apply.plan
    check(len(model.blocks) == 4 and p.stats["blocks"] == 4
          and p.n_ent == m.nnz,
          f"blocks: {len(model.blocks)} schedules, one plan over "
          f"{p.stats['blocks']} blocks and {p.n_ent} entries")
    x = model.prepare_x(x_of(m.dimension))
    check_plan("blocks", p, x)
    y_pair = sum(routed_plain(rm.to_torch(device=dev),
                              x[lo:lo + rm.padded_x_rows])
                 for rm, lo in zip(model.blocks, model._lo))
    reset_launches()
    y = model.apply(x)
    torch.cuda.synchronize()
    err = rel(y, y_pair)
    check(err <= KERNEL_TOL and route_xcache.route_xcache.launches == 1,
          f"blocks: the apply ({route_xcache.route_xcache.launches} launch) "
          f"vs the blocks' plain K7/K8 pairs added rel {err:.3e}")
    models.append(("blocks", m, model))
    # slice layout with a spill tail
    m = generate.random_general(4096, 12, seed=9, power_law=0.8)
    model = port.RoutedSpmv(cfg, device=dev).setup(m)
    spill = model.blocks[0].stats["nnz_spill"]
    check(spill > 0, f"spill: {spill} spilled entries")
    check_schedule("spill", model.blocks[0], model.routed_apply,
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
    print("  the routed kernel over staged plans at two part counts and "
          "over direct plans:")
    check_rx_geometries(dev)


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


#: K9's spread form as the small checks reach it: its default, tiles of
#: 32 rows in chunks of 8 diagonals (most cases take several chunks), and
#: tiles of 256 rows (one a thread) in chunks of 16.
SPREAD_CHECKS = (dia.SpreadGeometry(),
                 dia.SpreadGeometry(rows=32, chunk=8),
                 dia.SpreadGeometry(rows=256, chunk=16))


def dia_geometries(f64: bool = False):
    """Every built K9 variant (256 threads) in both x modes, the default
    geometry, and 128 and 512 threads; in f64 those of them built in f64
    (the default STEP and QUADS); the spread form at
    :data:`SPREAD_CHECKS`."""
    built = dia.BUILT_STEPS_F64 if f64 else dia.BUILT_STEPS
    out = [dia.DiaGeometry(threads=256, step=s, quads=q, x_mode=mode)
           for s, q in built for mode in dia.X_MODES]
    out += [dia.GEOMETRY]
    out += [dia.DiaGeometry(threads=t, x_mode=mode)
            for t in (128, 512) for mode in dia.X_MODES]
    return out + list(SPREAD_CHECKS)


def check_dia_exact(name: str, e, x: torch.Tensor) -> None:
    """K9's spread form at :data:`SPREAD_CHECKS`, and the geometry
    ``choose_geometry`` picks, bit for bit with the plain version run on
    the CPU, in the write mode and the accumulate mode, at x base 0 and 3
    (each an own plan)."""
    e_cpu = types.SimpleNamespace(dia_offsets=e.dia_offsets,
                                  dia_val=e.dia_val.cpu())
    x_cpu = x.cpu()
    dim_r = e.dia_val.shape[1]
    y0 = torch.as_tensor(np.random.default_rng(23).standard_normal(
        dim_r + 4), dtype=x.dtype)
    n_run = 0
    for base in (0, 3):
        want = dia.dia_body_plain(e_cpu, x_cpu, x_base=base)
        want_acc = dia.dia_body_plain(e_cpu, x_cpu, out=y0.clone(),
                                      x_base=base)
        for g in (*SPREAD_CHECKS, None):
            if g is not None:
                try:
                    dia.make_plan(e.dia_offsets, dim_r, g, 1,
                                  x.element_size(), x_base=base)
                except ValueError:
                    continue
            out = y0.clone().to(x.device)
            y = dia._launch(e, x, g, x_base=base)
            dia._launch(e, x, g, out=out, x_base=base)
            n_run += 1
            if not (torch.equal(y.cpu(), want)
                    and torch.equal(out.cpu(), want_acc)):
                check(False, f"K9 {name} at {g or 'the rule'}, x base "
                             f"{base}: vs the plain version on the CPU, "
                             f"rel {rel(y.cpu(), want):.3e} (write), "
                             f"{rel(out.cpu(), want_acc):.3e} (accumulate)")
    plan, _ = dia.device_plan(e.dia_offsets, dim_r, dim_r % 4 == 0,
                              x.device, None, x.element_size())
    check(True, f"K9 {name} ({x.dtype}): the spread form at {n_run} "
                f"plans (the rule picks {plan.geometry}) in the write and "
                "the accumulate mode, at x base 0 and 3, bit for bit with "
                "the plain version on the CPU")


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


def fold_cases():
    """(name, host artifact, kahan) of small artifacts whose tail reaches
    every part of K1's fold: a scrambled Poisson with three dense rows in
    the windowed layout (1,024-row windows: ER entries, long rows whose
    row blocks the tail makes wide enough for the split form, and one
    diagonal for K9), in f32, f64, f64 with Kahan and the precision mode;
    and powerlaw_small in the flagship's layout with hub-row splitting
    (overflow rows folded into their true rows)."""
    dense = generate.with_dense_rows(
        generate.permuted(generate.poisson2d(48), seed=11), 3, 0.5)
    windowed = dict(window_rows=1024, body_layout="sell")
    plain = lambda m, **kw: port.EhybPlainSpmv(  # noqa: E731
        port.EhybConfig(**kw), device="cpu").setup(m).ehyb
    hub = port.EhybSpmv(port.EhybConfig(row_split_threshold=4,
                                        routed_delegate="never"),
                        device="cpu").setup(
        generate.random_general(**POWERLAW_SMALL)).ehyb
    return [("dense rows", plain(dense, **windowed), False),
            ("dense rows f64", plain(dense, dtype="float64", **windowed),
             False),
            ("dense rows f64 Kahan", plain(dense, dtype="float64",
                                           **windowed), True),
            ("dense rows --dword", plain(dense, dword_values=True,
                                         window_rows=1024), False),
            ("hub-split rows", hub, False)]


def check_fold_small(dev) -> None:
    """Phase 10's small artifacts with a tail (:func:`fold_cases`): K1
    over the folded plan at every geometry against its plain version (bit
    for bit on the CPU, f32 Kahan within KERNEL_TOL) and the padded body
    with the tail added (:func:`check_k1_case`); then the flagship's apply
    on the card (K1, then K9 adding into its y) against the same apply's
    plain versions on the CPU, bit for bit, launching K1 and K9 once
    each."""
    reached = set()
    for name, e, kahan in fold_cases():
        st = e.stats
        plan = k1_folded_plan(e)
        pst = plan.stats
        reached |= {k for k, v in (("ER", st["nnz_er"]),
                                   ("long", st["nnz_long"]),
                                   ("hub-split", e.split_src.size),
                                   ("split form", split(plan)),
                                   ("direct", pst["direct_pieces"]),
                                   ("DIA", st["nnz_dia"])) if v}
        f64 = e.ell_val.dtype == np.float64
        x = np.random.default_rng(9).standard_normal(e.padded_x_rows)
        check_k1_case(name, e, x, kahan, dev, plan.to_torch(dev))
        x_dev = torch.as_tensor(x, dtype=torch.float64 if f64 else
                                torch.float32, device=dev)
        on_card = ehyb_stream.EhybStreamApply(
            e.to_torch(device=dev), kahan, cells=plan.to_torch(dev))
        on_cpu = ehyb_stream.EhybStreamApply(e.to_torch(), kahan,
                                             cells=plan.to_torch())
        reset_launches()
        y = on_card(x_dev)
        n = (ehyb_stream.stream_body.launches, dia.dia_body.launches)
        y_cpu = on_cpu(x_dev.cpu())
        exact = f64 or not kahan
        err = rel(y.cpu(), y_cpu)
        check(n == (1, int(bool(e.dia_offsets.size)))
              and (torch.equal(y.cpu(), y_cpu) if exact
                   else err <= KERNEL_TOL),
              f"{name}: the apply on the card (K1 {n[0]}, K9 {n[1]} "
              f"launches; {pst['tail_cells']} tail cells: {st['nnz_er']} "
              f"ER, {st['nnz_long']} long, {e.split_src.size} overflow "
              f"rows) vs its plain versions on the CPU: "
              + ("bit for bit" if exact else f"rel {err:.3e}"))
    check(reached == {"ER", "long", "hub-split", "split form", "direct",
                      "DIA"}, f"the fold's cases reached {sorted(reached)}")


def check_dia_small(dev, dtype=torch.float32) -> None:
    """K9 against its plain version at every variant of ``dtype``: one
    diagonal; rows not a multiple of 4 (the scalar value loads) with a
    ragged last tile; odd and negative offsets (the shifted 16-B loads);
    offsets past both ends of x (the guarded x reads, the zero-filled
    windows); a run wider than a tile; fem3d_16's 99 diagonals in 9 runs
    (in f64 through the precision mode); at each, the spread form and the
    rule's geometry bit for bit (:func:`check_dia_exact`)."""
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
        check_dia_exact(name, e, x)
    m = generate.fem3d(16)
    model = port.EhybSpmv(port.EhybConfig(dword_values=f64),
                          device=dev).setup(m)
    e = model.dev
    check(len(e.dia_offsets) == 99 and e.dia_val.dtype == dtype,
          f"fem3d_16: {len(e.dia_offsets)} diagonals, {e.dia_val.dtype}")
    check_dia_case("fem3d_16", e, model.prepare_x(
        deterministic_x(m.dimension)))
    check_dia_exact("fem3d_16", e, model.prepare_x(
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


def body_csr(e, n_rows: int, n_cols: int, dev,
             fold: bool = False) -> torch.Tensor:
    """The SELL body's own entries as CSR (row = slice * 128 + lane, the
    decoded column; reordered space): cuSPARSE's operand.  With ``fold``
    the entries of a folded K1 plan: the body's (the hub-split overflow
    rows' under their true rows), the ER tail's and the long rows'."""
    steps = e.ell_val.shape[0]
    step_slice = torch.searchsorted(
        e.slice_offset[1:], torch.arange(steps, dtype=torch.int32,
                                         device=dev), right=True)
    rows = step_slice.long()[:, None] * 128 \
        + torch.arange(128, device=dev)[None, :]
    keep = e.ell_val != 0
    rows, cols, vals = (rows[keep], body_gather_index(e).long()[keep],
                        e.ell_val[keep])
    if fold:
        rmap = torch.arange(n_rows, device=dev)
        rmap[e.split_src.long()] = e.split_dst.long()
        n_er = e.er_val.shape[1]
        er_step = torch.searchsorted(
            e.er_slice_offset[1:], torch.arange(
                e.er_val.shape[0], dtype=torch.int32, device=dev),
            right=True)
        er_row = e.er_rows.long()[er_step.long()[:, None] * n_er
                                  + torch.arange(n_er, device=dev)]
        er_keep = (e.er_val != 0) & (er_row < e.dim)
        rows = torch.cat([rmap[rows], er_row[er_keep],
                          e.long_rows.long()[e.long_seg.long()]])
        cols = torch.cat([cols, e.er_col.long()[er_keep],
                          e.long_col.long()])
        vals = torch.cat([vals, e.er_val[er_keep], e.long_val])
    return csr_of(rows, cols, vals, n_rows, n_cols)


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
    fold = p.stats["folded"]
    # the entries K1 sums: the body's, and the tail's in a folded plan
    body_nnz = p.stats["real_cells"]
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
    err = rel(y_k, padded_k1(e, x_dev, kahan, fold))
    check(err <= tol, f"K1 vs the padded body's plain version"
                      f"{' with the tail added' if fold else ''} rel "
                      f"{err:.3e}")
    a = body_csr(e, y_k.shape[0], x_dev.shape[0], dev, fold)
    del e
    y_l = torch.mv(a, x_dev)
    torch.cuda.synchronize()
    err = rel(y_l, y_p)
    check(err <= tol, f"cuSPARSE over K1's {a.values().numel()} "
                      f"{'body and tail' if fold else 'body'} entries "
                      f"({a.dtype}) vs plain rel {err:.3e}")
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
          f"{st['real_cells']} entries, {st['tail_cells']} of them the "
          f"tail's; {st['n_rb']} row blocks, {st['n_pieces']} pieces, "
          f"{st['split_rbs']} cut, max width {st['max_width']}, max table "
          f"{st['max_table_rows']} rows) device ms per call (plain, kernel, "
          f"kernel, plain): {turns}")
    print(f"  cuSPARSE over its entries {lib_ms:.4f} ms (K1 / cuSPARSE = "
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


def time_k1_forms(model, result, dev, n: int = 100) -> dict:
    """17d: K1 f64 over the precision mode's body in the plan forms of
    :func:`k1_forms`: the table form in the body's row order (the plan
    before direct columns and grouped rows) against the shipped plan in
    turns, then direct columns in body order; each read bit for bit
    against the others."""
    x = model.prepare_x(deterministic_x(result["dim"]))
    forms = {k: v.to_torch(dev) for k, v in k1_forms(
        model.ehyb, fold=True).items()}
    call = lambda p: lambda: ehyb_stream.stream_body(p, x)  # noqa: E731
    y = {k: call(p)() for k, p in forms.items()}
    check(all(torch.equal(v, y["table"]) for v in y.values()),
          "K1 f64 at pp512 --dword: every plan form's sums bit for bit "
          "the same")
    ms, table_ms, turns = in_turns(call(forms["shipped"]),
                                   call(forms["table"]), n, n)
    direct_ms = device_ms_per_call(call(forms["direct"]), n)
    st = forms["shipped"].stats
    print(f"  K1 f64 plan forms (table, shipped, shipped, table): {turns} "
          f"ms; direct in body order {direct_ms:.5f} ms; shipped: "
          f"{st['direct_pieces']} of {st['n_pieces']} pieces direct, rows "
          f"{'grouped' if st['grouped'] else 'in body order'} (sectors a "
          f"row block, body order and grouped: {st['sectors_per_rb']}); "
          f"the table form / shipped = {table_ms / ms:.3f}; {card_state()}")
    return dict(table_form_ms=table_ms, direct_form_ms=direct_ms)


def body_library_ms(model, x_dev: torch.Tensor, dev, n: int = 20) -> float:
    """cuSPARSE (``torch.mv`` on a CSR of x's type) over the entries K1's
    plan sums (the body's, and the tail's in a folded plan), from the
    padded body uploaded for it, device ms per call."""
    e = padded_body(model, dev)
    cells = model.module.cells
    a = body_csr(e, model.dev.slice_win_start.shape[0] * 128,
                 x_dev.shape[0], dev,
                 cells is not None and cells.stats["folded"])
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


def time_dia(model, result, dev, n: int = 50, acc: bool = False) -> dict:
    """K9 at a flagship path's shapes (:func:`time_dia_part` on the model's
    DIA part and its x; with ``acc`` also the accumulate mode, into the y
    the model's K1 writes)."""
    x = model.prepare_x(deterministic_x(result["dim"]))
    return time_dia_part(model.dev, x, dev, n, model.module.body(x)
                         if acc else None)


def time_dia_acc(e, x_dev: torch.Tensor, y0: torch.Tensor, n: int) -> dict:
    """K9's accumulate mode (adding into ``y0``, a copy a call) against its
    plain version on the CPU, bit for bit, and timed in turns with the
    write mode (write, add, add, write)."""
    out = y0.clone()
    dia.dia_body(e, x_dev, out=out)
    e_cpu = types.SimpleNamespace(dia_offsets=e.dia_offsets,
                                  dia_val=e.dia_val.cpu())
    want = dia.dia_body_plain(e_cpu, x_dev.cpu(), out=y0.cpu())
    check(torch.equal(out.cpu(), want),
          f"K9's accumulate mode ({y0.shape[0]} rows of y, "
          f"{e.dia_val.shape[1]} of diagonals) bit for bit with its plain "
          "version on the CPU")
    buf = y0.clone()
    acc_ms, write_ms, turns = in_turns(
        lambda: dia.dia_body(e, x_dev, out=buf),
        lambda: dia.dia_body(e, x_dev), n, n)
    print(f"  K9 accumulate mode vs the write mode, device ms per call "
          f"(write, add, add, write): {turns}; add / write = "
          f"{acc_ms / write_ms:.3f}; {card_state()}")
    return dict(acc_ms=acc_ms, write_ms=write_ms)


def time_dia_part(e, x_dev: torch.Tensor, dev, n: int = 50,
                  acc_into: torch.Tensor = None,
                  spread_ab: bool = False) -> dict:
    """K9 on the DIA part ``e`` (f32 or f64, as x): kernel (at the rule's
    geometry), plain version and cuSPARSE over the same DIA entries, both
    bounds, and the A/B of the two x modes (the default geometry with the
    other mode, in turns); where the rule takes the spread form, or with
    ``spread_ab``, the spread form and the default geometry in turns; with
    ``acc_into`` (a y to add into) also the accumulate mode
    (:func:`time_dia_acc`)."""
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
    ab = in_turns(lambda: dia._launch(e, x_dev, g0),
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
          f"{plan.geometry}; grid {st['grid']}, tiles of {st['tile_rows']} "
          f"rows, {st['smem_bytes']} B of shared memory) device ms per call "
          f"(plain, kernel, kernel, plain): {turns}")
    extra = {}
    if plan.spread or spread_ab:
        # the spread form (the rule's, or the one it would take) and the
        # default geometry in turns
        sg = plan.geometry if plan.spread else dia.spread_geometry(
            dim_r, torch.cuda.get_device_properties(dev).multi_processor_count,
            dia._per_sm(g0, e.dia_offsets, dim_r, dim_r % 4 == 0, dev, vb,
                        False, 0))
        y_s, y_d = dia._launch(e, x_dev, sg), dia._launch(e, x_dev, g0)
        check(torch.equal(y_d, y_k) and torch.equal(y_s, y_k),
              f"K9's default geometry and the spread form {sg} agree bit "
              "for bit")
        d_a, s_a, s_b, d_b = in_turns(lambda: dia._launch(e, x_dev, sg),
                                      lambda: dia._launch(e, x_dev, g0),
                                      n, n)[2]
        extra = dict(default_ms=(d_a + d_b) / 2, spread_ms=(s_a + s_b) / 2)
        print(f"  K9 the spread form vs the default geometry (default, "
              f"spread, spread, default): {(d_a, s_a, s_b, d_b)}; spread / "
              f"default = {(s_a + s_b) / (d_a + d_b):.3f}; the rule takes "
              f"{'the spread form' if plan.spread else 'the default'}")
    print(f"  cuSPARSE over its entries {lib_ms:.4f} ms (K9 / cuSPARSE = "
          f"{ms / lib_ms:.3f}); layout bound {b['bound_ms']:.4f} ms "
          f"({st['layout_bytes']} B, {b['bound_by']}; "
          f"{b['bound_ms'] / ms:.3f} of it reached); same-work bound "
          f"{same['bound_ms']:.4f} ms ({same['bytes']} B; "
          f"{same['bound_ms'] / ms:.3f} reached)")
    print(f"  x-mode A/B ({other.x_mode}, {g0.x_mode}, {g0.x_mode}, "
          f"{other.x_mode}): {ab}")
    if acc_into is not None:
        extra.update(time_dia_acc(e, x_dev, acc_into, n))
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(b, same), **extra)


def time_dia_small(dev) -> dict:
    """K9 at the corpus's DIA rows too small to fill the card at the
    default geometry (:data:`SMALL_DIA_ROWS`), each at full size and set up
    through the flagship as the CLI does: one product against the oracle
    (K9 launched once), then :func:`time_dia_part` (the rule's geometry
    beside its plain version, cuSPARSE and both bounds; the spread form and
    the default geometry in turns); returns matrix → its fields for the
    ``kernels`` line."""
    out = {}
    for name in SMALL_DIA_ROWS:
        t0 = time.perf_counter()
        m = generate.load_corpus(name)
        model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
        e = model.dev
        xh = deterministic_x(m.dimension)
        reset_launches()
        err = rel_np(model.matvec(xh), oracle_spmv(m, xh))
        n = (dia.dia_body.launches, ehyb_stream.stream_body.launches)
        check(model.ehyb.stats["nnz_dia"] == m.nnz and n == (1, 0)
              and err <= ORACLE_TOL,
              f"{name}: all {m.nnz} entries in {len(e.dia_offsets)} "
              f"diagonals of {m.dimension} rows, K9 launched {n[0]} time(s) "
              f"and K1 {n[1]} in a product, rel {err:.3e} vs the oracle "
              f"(set up in {time.perf_counter() - t0:.1f} s)")
        out[name] = time_dia_part(e, model.prepare_x(xh), dev, n=100,
                                  spread_ab=True)
        print(f"  {name} wall {time.perf_counter() - t0:.1f} s; "
              f"{card_state()}")
        del model, m
    return out


def time_dia_base(e, x_dev: torch.Tensor, base: int, y0: torch.Tensor, dev,
                  n: int = 100) -> dict:
    """K9 with an x base as the sharded apply runs it (the accumulate mode,
    adding into K1's y ``y0``): bit for bit with its plain version on the
    CPU, timed in turns with its plain version on the card (each adding
    into a buffer of its own), cuSPARSE over the same diagonal entries,
    both bounds (the accumulate mode reads y once more)."""
    f64 = x_dev.dtype == torch.float64
    vb = x_dev.element_size()
    tol = F64_TOL if f64 else KERNEL_TOL
    e_cpu = types.SimpleNamespace(dia_offsets=e.dia_offsets,
                                  dia_val=e.dia_val.cpu())
    out = y0.clone()
    dia.dia_body(e, x_dev, out=out, x_base=base)
    want = dia.dia_body_plain(e_cpu, x_dev.cpu(), out=y0.cpu(), x_base=base)
    torch.cuda.synchronize()
    max_abs = float((out.cpu() - want).abs().max())
    check(torch.equal(out.cpu(), want),
          f"K9 with x base {base} in its accumulate mode at the shard's "
          f"shape bit for bit with its plain version on the CPU")
    shifted = types.SimpleNamespace(
        dia_offsets=tuple(d + base for d in e.dia_offsets), dia_val=e.dia_val)
    a = dia_csr(shifted, x_dev.shape[0], dev)
    y_l = torch.mv(a, x_dev)
    err = rel(y_l, dia.dia_body_plain(e, x_dev, x_base=base))
    check(err <= tol, f"cuSPARSE over the {a.values().numel()} DIA entries "
                      f"vs plain rel {err:.3e}")
    buf, buf_p = y0.clone(), y0.clone()
    ms, plain_ms, turns = in_turns(
        lambda: dia.dia_body(e, x_dev, out=buf, x_base=base),
        lambda: dia.dia_body_plain(e, x_dev, out=buf_p, x_base=base),
        n, max(n // 10, 2))
    lib_ms = device_ms_per_call(lambda: torch.mv(a, x_dev), n)
    k, dim_r = e.dia_val.shape
    plan, _ = dia.device_plan(e.dia_offsets, dim_r, dim_r % 4 == 0, dev,
                              None, vb, True, base)
    layout = plan.stats["layout_bytes"] + vb * dim_r
    b = bound(layout, 2 * k * dim_r, dev, f64)
    # each entry's value, x and K1's y read once, y written once
    same = same_work_bound(a.values().numel(), 0, x_dev.numel() + dim_r,
                           dim_r, dev, vb)
    print(f"  K9 (x base {base}, {k} diagonals, {dim_r} rows, accumulate "
          f"mode) device ms per call (plain, kernel, kernel, plain): "
          f"{turns}; cuSPARSE {lib_ms:.4f} ms; layout bound "
          f"{b['bound_ms']:.4f} ms ({layout} B); same-work bound "
          f"{same['bound_ms']:.4f} ms ({same['bytes']} B); {card_state()}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(b, same))


def time_apply(model, result, dev, step_s: float, prof: dict,
               bcoo: dict, card: str, n: int = 100) -> dict:
    """The flagship's apply as a whole (K1 with the tail, then K9 into its
    y) at a main path's shapes: against its plain versions on the card
    (``stream_body_plain``, then ``dia_body_plain`` adding into its y), in
    turns, beside the step of the chained loop (phase 11: the apply and
    the chain add, graph replays), the kernels a step launches (phase 12)
    and cuSPARSE's step (``--model bcoo``, phase 15, the same loop).  The
    same-work bound: each entry's value once (a column of 2 B in the body,
    4 B in the tail, none on a diagonal), x and y once."""
    mod, e = model.module, model.dev
    x = model.prepare_x(deterministic_x(result["dim"]))
    plain = lambda: dia.dia_body_plain(  # noqa: E731
        e, x, out=ehyb_stream.stream_body_plain(mod.cells, x, mod.kahan))
    y_k, y_p = model.apply(x), plain()
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL, f"{result['matrix']}: the apply vs its plain "
                             f"versions on the card rel {err:.3e}")
    ms, plain_ms, turns = in_turns(lambda: model.apply(x), plain, n,
                                   max(n // 10, 2))
    st = model.ehyb.stats
    vb = x.element_size()
    n_bytes = st["nnz_dia"] * vb + st["nnz_ell"] * (vb + 2) \
        + (st["nnz_er"] + st["nnz_long"]) * (vb + 4) \
        + vb * (x.numel() + y_k.numel())
    b = bound(n_bytes, 2 * result["nnz"], dev, vb == 8)
    bcoo_ms = 1e3 * bcoo["seconds"] / bcoo["iters"]
    step_us = 1e6 * step_s
    lo, hi = PARENT_STEP_US[result["matrix"]]
    gflops = 2e-9 * result["nnz"] / step_s
    print(f"  {result['matrix']}: the apply device ms per call (plain, "
          f"apply, apply, plain): {turns}; same-work bound "
          f"{b['bound_ms']:.5f} ms ({n_bytes} B, {b['bound_ms'] / ms:.3f} "
          f"reached)")
    print(f"  {result['matrix']}: a step (the apply and the chain add) "
          f"{step_us:.2f} us, {gflops:.2f} GFLOP/s, "
          f"{prof['launches_per_step']:g} kernels, "
          f"{100 * prof['busy_share']:.1f}% busy; before K1 took the tail "
          f"{lo}-{hi} us (PERF.md); cuSPARSE (--model bcoo) "
          f"{1e3 * bcoo_ms:.2f} us, {bcoo['gflops']:.2f} GFLOP/s: "
          f"vs_baseline {bcoo_ms / (1e3 * step_s):.3f}; {card}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=bcoo_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], step_us=step_us,
                launches_per_step=prof["launches_per_step"],
                busy_share=prof["busy_share"], gflops=gflops,
                bcoo_us=1e3 * bcoo_ms, bcoo_gflops=bcoo["gflops"])


def rx_plan_line(p, plan_s: float) -> str:
    """The routed plan's geometry and what it stages, for the log."""
    st = p.stats
    return (f"plan: {'direct' if p.direct else 'staged'}, {st['n_tiles']} "
            f"blocks ({st['n_groups']} groups of {st['group_rows']} rows x "
            f"{st['parts']} parts), {p.chunk_cols} columns a chunk, "
            f"{p.threads} threads, {st['smem_bytes']} B of shared memory; "
            f"{st['n_segs']} segments ({st['mean_segment_entries']:.0f} "
            f"entries each), "
            f"{st['passes']} passes; {st['entries']} entries "
            f"({st['spilled']} spilled) from {st['blocks']} schedule(s), "
            f"largest tile {st['max_tile_entries']} (mean "
            f"{st['mean_tile_entries']:.0f}); staged from L2 "
            f"{st['staged_bytes']} B ({st['staged_bytes'] / st['entries']:.2f}"
            f" B an entry, {st['staged_bytes'] / st['x_bytes']:.3f} x x); "
            f"built in {plan_s:.2f} s")


def time_routed(model, result, m: MatrixCOO, dev, pair: bool = True) -> dict:
    """The one-pass routed kernel at the model's shapes against its plain
    version (and, where ``pair``, the plain K7/K8 pair of its one schedule),
    two launches bit for bit, and the whole routed apply; cuSPARSE over the
    same entries in dst order (the same function) and over the whole matrix
    in the original order.  Bounds: the same work in any layout (the
    kernel's ``bound_ms``), and the bytes of the plan's layout
    (``layout_bound_ms``: the same work plus the partials and maps); the L2
    bytes the plan stages stand beside them."""
    p = model.routed_apply.plan
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
    if pair:
        check(len(model.blocks) == 1, f"{result['matrix']} runs one "
                                      "routed schedule")
        d = model.blocks[0].to_torch(device=dev)
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
    # millions of columns need 32-bit column indices
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
    check(err <= ORACLE_TOL, f"cuSPARSE over {result['matrix']} vs oracle "
                             f"rel {err:.3e}")
    whole_ms = device_ms_per_call(lambda: torch.mv(a, x), 20)
    del a
    print(f"  route_xcache device ms (plain, kernel, kernel, plain): {turns}")
    print(f"  {rx_plan_line(p, result['setup_seconds']['route_plan'])}")
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
                library_ms=lib_ms, **bounds(lay, same),
                l2_staged_bytes=st["staged_bytes"],
                plan="direct" if p.direct else "staged")


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


#: The kernels a step of the flagship's chained loop may launch where K1
#: runs (name fragments as the profiler shows them): K1, K9 and the chain
#: add.
STEP_KERNELS = {"K1": "stream_body", "K9": "dia_kernel",
                "chain add": "add"}
#: Seconds a profiler window waits after it starts before the loop runs,
#: and after the loop before it stops.  ``torch.profiler`` on the H100 now
#: and then loses the kernel records at the start of a window of graph
#: replays (every record, or the first steps'; one K1 record of 20 in two
#: runs of this script); ``scripts_torch/profile_windows.py`` counts such
#: windows with and without this wait.
PROFILE_PAD_S = 0.01
#: Profiler windows the strict step check may take.  A replayed graph
#: launches the same kernels every step, so a window whose records do not
#: show the step exactly is printed with its counts and taken again; the
#: check fails when none of the windows shows it.
STRICT_WINDOWS = 5


def step_kernels(kernels: list, n: int) -> dict:
    """The kernels ``n`` chained steps launched once a step or more (the
    profiler's count over the steps; a call's copies of x in and y out
    come once a call), by name: launches a step."""
    return {e.key: e.count / n for e in kernels if e.count >= n}


def profile_path(name: str, result: dict, model, graph_s: float,
                 n: int = 20, strict: bool = False,
                 eager_fallback: bool = False) -> dict:
    """Device time by kernel over ``n`` iterations of a main path's graph
    loop (``torch.profiler``), the device's busy share of the unprofiled
    graph loop's time per iteration, the kernels a step launches, and
    ``phase_breakdown``'s device time per phase.  Where the profiler sees
    no kernel inside the graph replays, the split comes from the eager
    loop instead (said so); with ``eager_fallback`` also where what it sees
    of the replays is under half the step (a graph it does not trace: its
    x copy-in alone), and the busy share is then the eager loop's device
    time over the graph loop's wall.  With ``strict`` (a flagship row where
    K1 runs) a step must launch K1, K9 and the chain add once each and no
    other kernel: no torch scatter, fill or copy.  Returns the step's
    launches, busy share and what the profiler saw of the replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x_dev = model.prepare_x(deterministic_x(result["dim"]))

    def window(loop) -> list:
        loop(x_dev, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            loop(x_dev, n)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]

    def step_ok(kernels) -> tuple:
        steps = step_kernels(kernels, n)
        kinds = {key: next((w for w, frag in STEP_KERNELS.items()
                            if frag in key), None) for key in steps}
        return (sorted(kinds.values(), key=str) == sorted(STEP_KERNELS)
                and all(c == 1 for c in steps.values())), kinds

    source = "graph replays"
    for loop in (model.iterate, model.iterate_eager):
        kernels = window(loop)
        for attempt in range(1, STRICT_WINDOWS if strict else 1):
            if not kernels or step_ok(kernels)[0]:
                break
            print(f"  {name}: profiler window {attempt} of "
                  f"{STRICT_WINDOWS} does not show the step exactly, its "
                  "records by kernel (count over "
                  f"{n} steps): " + "; ".join(
                      f"{e.count} {e.key[:60]}" for e in kernels)
                  + "; taking another window")
            kernels = window(loop)
        if loop != model.iterate:
            break
        seen_us = sum(e.device_time_total for e in kernels) / n
        graph_seen = dict(us=seen_us, kernels=sum(
            e.count for e in kernels if "Memcpy" not in e.key) / n)
        if kernels and not (eager_fallback and seen_us < 0.5e6 * graph_s):
            break
        print(f"  {name}: the profiler saw {seen_us:.2f} us per iteration "
              f"of the graph replays ({graph_seen['kernels']:g} kernels a "
              "step); the split below is the eager loop's")
        source = ("the eager loop (the profiler did not trace the graph's "
                  "kernels)")
    busy_us = sum(e.device_time_total for e in kernels) / n
    wall_us = 1e6 * graph_s
    print(f"  {name}: device busy {busy_us:.2f} us per iteration "
          f"(torch.profiler over {source}, {n} iterations) of "
          f"{wall_us:.2f} us of the unprofiled graph loop: "
          f"{100 * busy_us / wall_us:.1f}% busy")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / n:10.2f} us  x{e.count / n:g}  "
              f"{e.key[:90]}")
    steps = step_kernels(kernels, n)
    print(f"  {name}: a step launches {sum(steps.values()):g} kernels "
          f"({len(steps)} kinds; {100 * busy_us / wall_us:.1f}% busy): "
          + "; ".join(f"x{c:g} {k[:60]}" for k, c in steps.items()))
    if strict:
        ok, kinds = step_ok(kernels)
        check(ok, f"{name}: a step of the flagship launches K1, K9 and the "
                  f"chain add once each and nothing else: {kinds}")
    phases = phase_breakdown(model, x_dev, iters=n)
    print("    phase_breakdown (device us per call, CUDA graph replay): "
          + ", ".join(f"{k} {1e6 * v:.2f}" for k, v in phases.items()))
    return dict(launches_per_step=sum(steps.values()),
                busy_share=busy_us / wall_us, graph_seen=graph_seen)


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

def rb_rows(rbs: torch.Tensor, p=None) -> torch.Tensor:
    """The y rows of row blocks ``rbs`` (of plan ``p``: through its row
    map where it has one)."""
    rows = (rbs.long()[:, None] * 32
            + torch.arange(32, device=rbs.device)).reshape(-1)
    if p is not None and p.row_map.numel():
        rows = p.row_map.to(rbs.device).long()[rows]
    return rows


def list_row_blocks(piece: np.ndarray, lst: np.ndarray) -> np.ndarray:
    """The row blocks a K1 list names (``piece``: its plan's piece array):
    the ids, or its work items' row blocks (each once)."""
    if lst.ndim == 1:
        return lst.astype(np.int64)
    return np.unique(piece[lst[:, ITEM_PIECE], PIECE_RB]).astype(np.int64)


def check_k1_list(name: str, plan, rbs: np.ndarray, x: np.ndarray,
                  kahan: bool, dev) -> None:
    """K1 over the row blocks ``rbs`` of ``plan`` (a host StreamCellsPlan,
    f32 or f64 values; over a plan in the split form their work items, at
    the split geometry) at every geometry of :func:`k1_geometries` for its
    type, into a y of sentinels: the listed rows (through the plan's row
    map where it has one) against the plain version on the card (within
    KERNEL_TOL, F64_TOL in f64) and on the CPU (bit for bit where Kahan is
    off or the type is f64), every other row untouched."""
    p, p_cpu = plan.to_torch(dev), plan.to_torch()
    f64 = plan.cell_val.dtype == np.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    exact = f64 or not kahan
    x_dev = torch.as_tensor(x, dtype=p.cell_val.dtype, device=dev)
    lst = torch.as_tensor(list_items(plan, rbs) if split(plan) else
                          np.ascontiguousarray(rbs, dtype=np.int32),
                          device=dev)
    fill = -7.0
    y_p = torch.full((p.n_rb * 32,), fill, dtype=x_dev.dtype, device=dev)
    ehyb_stream.stream_body_plain(p, x_dev, kahan, rb_list=lst, out=y_p)
    y_cpu = torch.full((p.n_rb * 32,), fill, dtype=x_dev.dtype)
    ehyb_stream.stream_body_plain(p_cpu, x_dev.cpu(), kahan,
                                  rb_list=lst.cpu(), out=y_cpu)
    rows = rb_rows(torch.as_tensor(np.asarray(rbs, np.int64), device=dev),
                   p)
    other = torch.ones(p.n_rb * 32, dtype=torch.bool, device=dev)
    other[rows] = False
    worst, same = 0.0, True
    geometries = ([ehyb_stream.SPLIT_GEOMETRY] if split(plan)
                  else k1_geometries(f64))
    for g in geometries:
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
    form = (f", {lst.shape[0]} work items of the split form"
            if split(plan) else "")
    check(not exact or same,
          f"K1 list {name} ({len(rbs)} of {p.n_rb} row blocks{form}, "
          f"{plan.stats['split_rbs']} of the plan's cut for the 16-bit "
          f"range{', f64' if f64 else ''}{', Kahan' if kahan else ''}): "
          f"{len(geometries)} geometries, listed rows vs plain rel "
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
        # [x_ext | recv]: the folded tail reads the exchanged values
        x = rng.standard_normal(sc.plan.stats["x_rows"])
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


def check_k1_split_lists(dev) -> None:
    """16a: K1's split variants over lists of work items against their
    plain versions: the heavy-tailed test matrix (powerlaw_small) sharded
    at two ranks in float32 and float64 (each config's plan in the split
    form, the tail folded in), each shard's interior, boundary and both
    lists and a chunked row block alone, plain and Kahan."""
    m = generate.random_general(**POWERLAW_SMALL)
    rng = np.random.default_rng(18)
    for dtype in ("float32", "float64"):
        sh = plan_sharded(m, port.EhybConfig(dtype=dtype, **SHARDED_CFG),
                          2).sharded
        for d in range(2):
            sc = build_shard_cells(shard_matrix(sh, d), sh)
            plan = sc.plan
            check(split(plan) and plan.stats["folded"],
                  f"powerlaw_small {dtype} shard {d}/2: the split form "
                  f"({plan.stats['chunked_rbs']} row blocks in "
                  f"{plan.stats['n_chunks']} chunks, {plan.stats['n_items']} "
                  f"work items), {plan.stats['tail_cells']} tail cells; "
                  f"{sc.interior.size} interior, {sc.boundary.size} boundary "
                  "row blocks")
            x = rng.standard_normal(plan.stats["x_rows"])
            lists = {"interior": sc.interior, "boundary": sc.boundary,
                     "both": np.concatenate([sc.interior, sc.boundary]),
                     "one chunked row block": plan.chunk_rb[:1]}
            for kind, rbs in lists.items():
                for kahan in (False, True):
                    check_k1_list(f"split shard {d} {kind} {dtype}"
                                  f"{' kahan' if kahan else ''}", plan,
                                  rng.permutation(rbs).astype(np.int32), x,
                                  kahan, dev)


#: K9's x-base cases: (offsets, rows, x values, base).  The sharded
#: apply's shape (a base of W = 1,024 past a halo of as many values), an
#: odd base, and a base with reads past both ends of x.
DIA_BASE_CASES = (((-1024, -1, 0, 1, 1024), 8192, 8192 + 2048, 1024),
                  ((-3, 0, 5), 4099, 4200, 3),
                  ((-40, -1, 0, 1, 40), 4096, 4096, 20))


def check_dia_base(dev) -> None:
    """16a: K9 with an x base (row i reads ``x[x_base + i + d_k]``, the
    sharded apply's diagonals) against its plain version on the CPU, bit
    for bit, at every built geometry of its type in the write mode and at
    the default one in the accumulate mode, in f32 and f64."""
    rng = np.random.default_rng(19)
    for offsets, dim_r, n_x, base in DIA_BASE_CASES:
        for dt in (torch.float32, torch.float64):
            val = torch.as_tensor(rng.standard_normal((len(offsets), dim_r)),
                                  dtype=dt)
            e = types.SimpleNamespace(dia_offsets=offsets,
                                      dia_val=val.to(dev))
            e_cpu = types.SimpleNamespace(dia_offsets=offsets, dia_val=val)
            x = torch.as_tensor(rng.standard_normal(n_x), dtype=dt)
            x_dev = x.to(dev)
            want = dia.dia_body_plain(e_cpu, x, x_base=base)
            y0 = torch.as_tensor(rng.standard_normal(dim_r + 8), dtype=dt)
            want_acc = dia.dia_body_plain(e_cpu, x, out=y0.clone(),
                                          x_base=base)
            same, n_run = True, 0
            for g in dia_geometries(dt == torch.float64):
                try:
                    dia.make_plan(offsets, dim_r, g, 1, x.element_size(),
                                  x_base=base)
                except ValueError:
                    continue
                n_run += 1
                y = dia._launch(e, x_dev, g, x_base=base)
                same = same and torch.equal(y.cpu(), want)
            out = y0.to(dev)
            dia.dia_body(e, x_dev, out=out, x_base=base)
            torch.cuda.synchronize()
            check(same and torch.equal(out.cpu(), want_acc),
                  f"K9 with x base {base} ({len(offsets)} diagonals, "
                  f"{dim_r} rows, x {n_x}, {dt}): {n_run} geometries in the "
                  "write mode and the accumulate mode, bit for bit with "
                  "the plain version on the CPU")


def plan_f64(plan):
    """A K1 host plan with its values in f64 (for the f64 list variants)."""
    return dataclasses.replace(plan, cell_val=plan.cell_val.astype(
        np.float64))


def list_work(p, lst: np.ndarray, n_x: int, dev) -> dict:
    """What K1 over the list ``lst`` (row-block ids, or a split plan's work
    items) of the plan ``p`` (on the card) must move: its cells (a table
    piece's with a 2-B index, a direct piece's with a 4-B column), pieces
    and table rows, the list, the x rows its cells read, its y rows and a
    split plan's partials (written and read once); the real entries
    (nonzero cells) with their decoded columns; and those entries as a CSR
    of the y rows (cuSPARSE's operand).  Values, x and y count the plan's
    value size."""
    vb = p.cell_val.element_size()
    piece = p.piece.cpu().numpy().astype(np.int64)
    table_rows = p.rows.cpu().numpy().astype(np.int64)
    cell_val = p.cell_val.cpu().numpy()
    cell_idx = p.cell_idx.cpu().numpy()
    cell_col = p.cell_col.cpu().numpy()
    row_map = p.row_map.cpu().numpy()
    rbs = list_row_blocks(piece, lst)
    sel = np.isin(piece[:-1, PIECE_RB], rbs)
    n_cells = np.diff(piece[:, PIECE_CELL])
    n_rows = np.diff(piece[:, PIECE_ROW])
    cell_sel = np.repeat(sel, n_cells)
    row_sel = np.repeat(sel, n_rows)
    pid = np.repeat(np.arange(len(piece) - 1), n_cells)
    cell = np.flatnonzero(cell_sel & (cell_val != 0))
    first = piece[pid[cell]]
    direct = n_rows[pid[cell]] == 0
    col = np.zeros(cell.size, np.int64)
    if cell_idx.size:
        t = ~direct
        idx = cell_idx[cell[t]].astype(np.int64) & 0xFFFF
        col[t] = table_rows[first[t, PIECE_ROW] + (idx >> 7)] * 128 \
            + (idx & 127)
    if cell_col.size:
        col[direct] = cell_col[cell[direct]]
    row = first[:, PIECE_RB] * 32 + (cell - first[:, PIECE_CELL]) % 32
    if row_map.size:
        row = row_map[row]
    n_sel = int(cell_sel.sum())
    n_direct = int(np.repeat(sel & (n_rows == 0), n_cells).sum())
    x_rows = np.union1d(table_rows[row_sel], col[direct] >> 7)
    n_chunks = int((lst[:, 2] >= 0).sum()) if lst.ndim == 2 else 0
    layout = (n_sel * vb + 2 * (n_sel - n_direct) + 4 * n_direct
              + int(sel.sum()) * 16 + int(row_sel.sum()) * 4 + lst.size * 4
              + x_rows.size * 128 * vb + rbs.size * 32 * vb
              + 2 * n_chunks * 32 * vb)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    a = csr_of(t(row), t(col), t(cell_val[cell]), p.n_rb * 32, n_x)
    return dict(layout_bytes=layout, nnz=int(cell.size),
                n_cols=int(np.unique(col).size), csr=a, rbs=rbs,
                direct_cells=n_direct, chunk_items=n_chunks)


def time_k1_list(p, lst: np.ndarray, x_dev: torch.Tensor, kahan: bool, dev,
                 n: int = 100, n_plain: int = 10) -> dict:
    """K1 over one list (row-block ids, or a split plan's work items) at its
    real shapes: kernel and plain version in turns, cuSPARSE over the same
    entries, the layout and same-work bounds."""
    f64 = x_dev.dtype == torch.float64
    tol = F64_TOL if f64 else KERNEL_TOL
    w = list_work(p, lst, x_dev.numel(), dev)
    lst = torch.as_tensor(np.ascontiguousarray(lst, dtype=np.int32),
                          device=dev)
    y = torch.zeros(p.n_rb * 32, dtype=x_dev.dtype, device=dev)
    y_p = torch.zeros(p.n_rb * 32, dtype=x_dev.dtype, device=dev)
    ehyb_stream.stream_body(p, x_dev, kahan, rb_list=lst, out=y)
    ehyb_stream.stream_body_plain(p, x_dev, kahan, rb_list=lst, out=y_p)
    y_l = torch.mv(w["csr"], x_dev)
    torch.cuda.synchronize()
    rows = rb_rows(torch.as_tensor(w["rbs"], device=dev), p)
    max_abs = float((y - y_p).abs().max())
    err = rel(y[rows], y_p[rows])
    check(err <= tol and rel(y_l[rows], y_p[rows]) <= tol,
          f"K1 over {len(w['rbs'])} listed row blocks"
          + (f" ({lst.shape[0]} work items)" if lst.dim() == 2 else "")
          + f" vs plain rel {err:.3e} (max abs {max_abs:.3e}); cuSPARSE "
          f"over their {w['nnz']} entries rel "
          f"{rel(y_l[rows], y_p[rows]):.3e}")
    ms, plain_ms, turns = in_turns(
        lambda: ehyb_stream.stream_body(p, x_dev, kahan, rb_list=lst, out=y),
        lambda: ehyb_stream.stream_body_plain(p, x_dev, kahan, rb_list=lst,
                                              out=y_p), n, n_plain)
    lib_ms = device_ms_per_call(lambda: torch.mv(w["csr"], x_dev), n)
    b = bound(w["layout_bytes"], 2 * w["nnz"], dev, f64)
    idx_bytes = 4 if w["direct_cells"] else 2
    same = same_work_bound(w["nnz"], idx_bytes, w["n_cols"], rows.numel(),
                           dev, x_dev.element_size())
    print(f"    device ms (plain, kernel, kernel, plain): {turns}; cuSPARSE "
          f"{lib_ms:.4f} ms; layout bound {b['bound_ms']:.4f} ms "
          f"({w['layout_bytes']} B, {b['bound_ms'] / ms:.3f} reached); "
          f"same-work bound {same['bound_ms']:.4f} ms ({same['bytes']} B)")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bounds(b, same),
                row_blocks=int(len(w["rbs"])), nnz=w["nnz"])


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
    and K9's launches in one apply, the eager chained loop against one
    apply, and the host-clock microseconds per eager apply; with ``extra``,
    the
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
    k9 = dia.dia_body.launches
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
               launches=launches, k9=k9,
               n_diag=len(model.sharded.dia_offsets), err_loop=err_loop,
               us_per_apply=us, y=y_host if rank == 0 else None)
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
    n_diag = len(model.sharded.dia_offsets)
    reset_launches()
    model.apply(xd)
    torch.cuda.synchronize(dev)
    one = (ehyb_stream.stream_body.launches, dia.dia_body.launches)
    check(one == (1, int(n_diag > 0)) and st["folded"],
          f"world 1: one apply launches K1 {one[0]} time(s) (the boundary "
          f"list; its plan holds the shard's {st['tail_cells']} ER and "
          f"long-row cells) and K9 {one[1]} (the {n_diag} diagonals, x base "
          f"{model.module.ex.W}, into K1's y): no torch ER, long-row, DIA "
          "or combine op")
    gf = time_graph_loops({"ehyb": model_flat, "ehyb_sharded D=1": model},
                          {"ehyb": model_flat.prepare_x(x),
                           "ehyb_sharded D=1": xd}, m.nnz, dev, card)
    step_s = 2e-9 * m.nnz / gf["ehyb_sharded D=1"]
    print(f"  ehyb_sharded D=1: a step {1e6 * step_s:.2f} us beside "
          f"{PARENT_SHARDED_STEP_US} us before its apply took the tail and "
          f"K9 (PERF.md); {card}")
    prof = profile_path(f"ehyb_sharded D=1 on {SHARDED_MATRIX}",
                        {"dim": m.dimension}, model, step_s, strict=True)
    print("    phase_breakdown on x_buf's own rows (no copy of x in; "
          "device us per call): " + ", ".join(
              f"{k} {1e6 * v:.2f}" for k, v in phase_breakdown(
                  model, model.module.ex.x_local, iters=20).items()))
    print(f"  the sharded K1 at D=1 over all {st['n_boundary']} row blocks "
          "(the boundary list):")
    sk1 = time_k1_list(cells.plan, cells.boundary.cpu().numpy(),
                       model.module.ex.x_buf, model.module.kahan, dev)
    sk1.update(gflops_d1=gf["ehyb_sharded D=1"], step_us=1e6 * step_s,
               launches_per_step=prof["launches_per_step"],
               busy_share=prof["busy_share"], k9_launches=one[1])
    print(f"  K9 with an x base at D=1 ({n_diag} diagonals of "
          f"{model.sharded.rows_per_dev} rows, base {model.module.ex.W}), "
          "adding into K1's y:")
    mod = model.module
    k9b = time_dia_base(mod.e, mod.ex.x_buf, mod.ex.W, mod.phases()[
        "body boundary"](mod.ex.x_local), dev) if n_diag else None
    y1 = y
    del model, mod

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
                  f"one apply {r['launches']}, K9 {r['k9']} ({r['n_diag']} "
                  f"diagonals); eager loop vs apply rel "
                  f"{r['err_loop']:.3e}; {r['us_per_apply']:.1f} us per "
                  "eager apply")
            check(r["interior"] > 0 and r["boundary"] > 0
                  and r["launches"] == 2 and r["k9"] == int(r["n_diag"] > 0)
                  and r["loop"] == "eager" and r["err_loop"] <= LOOP_TOL,
                  f"D={world} rank {r['rank']}: both kinds of row block, "
                  "two K1 launches and one K9 launch an apply, the eager "
                  "loop")
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
            t = time_k1_list(p, sc.kernel_list(getattr(sc, kind)), x_ext,
                             False, dev, n=50, n_plain=5)
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
    return dict(launches=launches, **sk1, d4_per_rank=per_rank,
                k9_base=k9b)


def check_split_sharded_1m(dev, card: str, prebuild: "Prewarm") -> dict:
    """16e: ``ShardedDegreeSplitSpmv`` at one rank on powerlaw_1m at full
    size, its host setup (the sharded setup, the rank's K1 plan, the
    routed schedules and plans) read from ``prebuild``'s cache, built in
    the background from phase 1 on: against the oracle within ORACLE_TOL;
    the dense rows' K1 plan in the split form with their tail folded in,
    launched once an apply over the boundary list's work items; the graph
    loop's GFLOP/s beside the flat degree split's (``BENCH_SWEEP_H100.md``);
    then the dense rows' K1 timed (:func:`time_k1_list`: both bounds, its
    plain version, cuSPARSE over the same entries).  Returns its kernels
    entry."""
    rc, since, out = prebuild.wait(PREWARM_TIMEOUT_S)
    print("".join(f"    {ln}\n" for ln in out.splitlines()), end="")
    check(rc == 0, f"the prebuild exited {rc} after {since:.1f} s")
    t0 = time.perf_counter()
    m = generate.load_corpus("powerlaw_1m")
    x = deterministic_x(m.dimension)
    with cache_dir(prebuild.cache_dir):
        want, hit = bench_torch.cached_oracle(m, x)
        model = ShardedDegreeSplitSpmv(
            port.EhybConfig(artifact_cache=True, **SHARDED_CFG),
            device=dev).setup(m)
    setup_s = time.perf_counter() - t0
    part = model.e
    cells = part.module.cells
    st = cells.stats
    check("cache_load" in part.setup_seconds,
          f"corpus, oracle ({'cached' if hit else 'computed'}) and setup "
          f"from the cache in {setup_s:.1f} s: {model.setup_seconds}")
    reset_launches()
    err = rel_np(model.matvec(x), want)
    n = (ehyb_stream.stream_body.launches, dia.dia_body.launches,
         route_xcache.route_xcache.launches)
    n_diag = len(part.sharded.dia_offsets)
    check(err <= ORACLE_TOL and split(cells.plan) and st["folded"]
          and n[:2] == (1, int(n_diag > 0)) and n[2] > 0
          and m.nnz == 25_138_615,
          f"ehyb_split_sharded at world 1 on powerlaw_1m ({m.nnz} entries, "
          f"{part.m.nnz} in the dense rows) vs oracle rel {err:.3e} <= "
          f"{ORACLE_TOL}; the dense rows' K1 plan in the split form "
          f"({st['chunked_rbs']} row blocks in {st['n_chunks']} chunks, "
          f"{st['n_items']} work items, {st['tail_cells']} tail cells); "
          f"one apply launches K1 {n[0]}, K9 {n[1]} ({n_diag} diagonals), "
          f"the routed kernel {n[2]}")
    gf = graph_loop_gflops(model, model.prepare_x(x), m.nnz, dev, n=200)
    print(f"  ehyb_split_sharded D=1 on powerlaw_1m: {gf:.2f} GFLOP/s "
          f"beside the flat degree split's 161.37 (BENCH_SWEEP_H100.md); "
          f"{card}; {card_state()}")
    print(f"  the dense rows' K1 over their {st['n_boundary']} row blocks "
          "(the boundary list's work items):")
    sk1 = time_k1_list(cells.plan, cells.boundary.cpu().numpy(),
                       part.module.ex.x_buf, part.module.kahan, dev, n=50,
                       n_plain=3)
    return dict(SK1_SPLIT_1M, launches=n[0], rel_error=err, gflops=gf,
                setup_s=setup_s, **sk1)


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
    check_k1_f64_forms(dev)
    check_dia_small(dev, torch.float64)


def k1_forms(e, fold: bool = False) -> dict:
    """The f64 kernel's plan forms of body ``e``: the table form and
    direct columns (where a piece holds fewer than DIRECT_BELOW cells a
    table row, and in every piece), both in the body's row order, and the
    shipped plan (``k1_options``: direct pieces and grouped rows where
    ``e`` is scattered); with ``fold`` each with the EHYB tail folded in (the
    shipped one is then the flagship's, ``k1_folded_plan``)."""
    return {"table": build_stream_cells(e, fold=fold),
            "direct": build_stream_cells(e, direct_below=DIRECT_BELOW,
                                         fold=fold),
            "all direct": build_stream_cells(e, direct_below=np.inf,
                                             fold=fold),
            "shipped": build_stream_cells(e, fold=fold, **k1_options(e))}


def check_k1_f64_forms(dev) -> None:
    """17a: the f64 kernel over each plan form of :func:`k1_forms`, plain
    and Kahan, at every f64 geometry, bit for bit with the table form's
    plain version run on the CPU (every form adds a row's products in the
    same order): a scrambled Poisson body in the precision mode (scattered:
    the shipped plan groups its rows), the stress matrix's (scattered), the
    edge body in f64 (cut and empty row blocks; its direct form mixes
    pieces with and without a table) and the f64 cancellation matrix's
    compensated flagship body (±1e17, x all ones); the all-direct forms
    and the grouped plans also with row-block lists (a grouped plan's
    rows through its row map)."""
    rng = np.random.default_rng(17)
    dword = port.EhybConfig(dword_values=True)
    edge = edge_body()
    edge.ell_val = np.where(edge.ell_val != 0, rng.standard_normal(
        edge.ell_val.shape), 0.0)
    cancel = port.EhybSpmv(f64_cases()[-1][2], device="cpu").setup(
        cancellation_matrix_f64()).ehyb
    cases = [
        ("scrambled poisson (precision mode)", port.EhybSpmv(
            dword, device="cpu").setup(generate.permuted(
                generate.poisson2d(96), seed=3)).ehyb, None),
        ("stress (precision mode)", port.EhybSpmv(
            dword, device="cpu").setup(stress_matrix()).ehyb, None),
        ("edge body f64", edge, None),
        ("cancel 1e17 f64", cancel, np.ones(cancel.padded_x_rows))]
    grouped = mixed = 0
    for name, e, x in cases:
        x = rng.standard_normal(e.padded_x_rows) if x is None else x
        x_dev = torch.as_tensor(x, dtype=torch.float64, device=dev)
        forms = k1_forms(e)
        want = {k: ehyb_stream.stream_body_plain(
            forms["table"].to_torch(), x_dev.cpu(), k) for k in (False, True)}
        for form, plan in forms.items():
            st = plan.stats
            grouped += st["grouped"]
            mixed += 0 < st["direct_pieces"] < st["n_pieces"] - int(
                (np.diff(plan.piece[:, PIECE_CELL]) == 0).sum())
            p = plan.to_torch(dev)
            same = True
            for kahan in (False, True):
                same = same and torch.equal(ehyb_stream.stream_body_plain(
                    plan.to_torch(), x_dev.cpu(), kahan), want[kahan])
                for g in k1_geometries(True):
                    y = ehyb_stream._launch(p, x_dev, kahan, g)
                    same = same and torch.equal(y.cpu(), want[kahan])
            check(same, f"K1 f64 {name}, {form} form ({st['direct_pieces']} "
                        f"of {st['n_pieces']} pieces direct, rows "
                        f"{'grouped' if st['grouped'] else 'in body order'}"
                        f"): plain and Kahan at {len(k1_geometries(True))} "
                        "geometries, bit for bit with the table form's "
                        "plain version on the CPU")
            if st["grouped"]:
                # a list names the plan's row blocks, written through the
                # row map (a sharded float64 plan may be grouped)
                rbs = rng.permutation(plan.n_rb)[: max(plan.n_rb // 3, 1)]
                for kahan in (False, True):
                    check_k1_list(f"{name} {form} (grouped) list"
                                  f"{' kahan' if kahan else ''}", plan,
                                  rbs.astype(np.int32), x, kahan, dev)
        direct = forms["all direct"]
        rbs = rng.permutation(direct.n_rb)[: max(direct.n_rb // 3, 1)]
        for kahan in (False, True):
            check_k1_list(f"{name} direct{' kahan' if kahan else ''}",
                          direct, rbs.astype(np.int32), x, kahan, dev)
    check(grouped > 0 and mixed > 0,
          f"the forms reached grouped rows ({grouped} plans) and pieces "
          f"with and without a table in one plan ({mixed} plans)")


def check_small_gate(dev, card: str) -> dict:
    """The small gate on the card: ``ehyb`` on each of SMALL_GATE_MATRICES
    with a fresh cache directory: the A/B's verdict, both GFLOP/s, the
    engine returned (the one the 5% rule picks from those numbers) and its
    error against the oracle; a warm setup reads the verdict without
    measuring.  Then stencil3d(24, 27) keeps the body without measuring.
    Returns each matrix's record (with the K1 launches of one product
    through the engine returned); ``card`` (the card's name and power
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
            reset_launches()
            err = rel_np(model.matvec(x), oracle_spmv(m, x))
            k1_launches = ehyb_stream.stream_body.launches
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
        out[name] = dict(g, engine=engine, rel_error=err,
                         k1_launches=k1_launches)
    check(out["powerlaw_16k"]["k1_launches"] > 0,
          f"powerlaw_16k's product through {out['powerlaw_16k']['engine']} "
          f"launched K1 {out['powerlaw_16k']['k1_launches']} times")
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
    where it has DIA entries, K1 or the window cache where it has body, ER
    or long-row entries (K1 folds the last two in), and neither where it
    has none."""
    la = r["launches"]
    body = la["K1"] + la["WC"]
    rest = r["nnz_ell"] + r["nnz_er"] + r["nnz_long"]
    check(r["engine"] == "EhybSpmv" and (la["K9"] > 0) == (r["nnz_dia"] > 0)
          and (body > 0) == (rest > 0) and la["RX"] == 0,
          f"{r['matrix']}: {r['engine']}, K9 {la['K9']} launches for "
          f"{r['nnz_dia']} DIA entries, K1 {la['K1']} and the window cache "
          f"{la['WC']} for {r['nnz_ell']} body, {r['nnz_er']} ER and "
          f"{r['nnz_long']} long-row entries")


def check_routed_row(r: dict) -> None:
    la = r["launches"]
    check(r["engine"] == "RoutedSpmv" and la["RX"] > 0
          and r["nnz_routed"] > 0
          and r["nnz_routed"] + r["nnz_spill"] == r["nnz"],
          f"{r['matrix']}: {r['engine']} over {r['routed_blocks']} column "
          f"block(s), {RX['name']} launched {la['RX']} times, "
          f"{r['nnz_routed']} entries routed + {r['nnz_spill']} spilled = "
          f"{r['nnz']}")


def check_bench_surface(prewarm: Prewarm, res1: dict, card: str) -> tuple:
    """Phase 20: the default headline through ``bench_torch``, its
    precision mode, and ``scripts_torch/sweep.py --models ehyb`` over the
    rows no earlier phase drives; every child in its own process with
    ``artifact_cache=True``, reading the cache the prewarm filled.  Then
    K1 on powerlaw_1m's dense body (the degree split's EHYB part, set up
    in this process from that cache) timed by :func:`time_k1_split`, plain
    and compensated; returns its kernels entry, with the launches of the
    sweep's powerlaw_1m run, 20e's entry, and the K9 launches of the
    sweep's runs of :data:`SMALL_DIA_ROWS`."""
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
        # one product is one launch of K9 on the all-DIA poisson2d_512
        products = swept["poisson2d_512"]["ehyb"]["launches"]["K9"]
        if r4["engine"] == "RoutedSpmv":
            check_routed_row(r4)
            check(r4["launches"]["RX"] == products,
                  f"random_4m: {r4['launches']['RX']} {RX['name']} launches "
                  f"for {products} products ({r4['routed_blocks']} column "
                  "blocks in one plan)")
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
        check(rp["launches"]["K1"] > 0,
              f"powerlaw_1m: K1 launched {rp['launches']['K1']} times")
        print(f"  20d: K1 on powerlaw_1m's dense body, from the prewarmed "
              f"cache ({card})")
        t1 = time.perf_counter()
        with cache_dir(prewarm.cache_dir):
            m = generate.load_corpus("powerlaw_1m")
            dense, _ = degree_split_stats(m)
            keep = dense[m.row]
            md = MatrixCOO(m.n_rows, m.n_cols, m.row[keep], m.col[keep],
                           m.val[keep])
            del m
            model = port.EhybSpmv(port.EhybConfig(
                routed_delegate="never", artifact_cache=True),
                device="cuda").setup(md)
        print(f"  setup {time.perf_counter() - t1:.1f} s "
              f"({model.setup_seconds})")
        x = model.prepare_x(deterministic_x(md.dimension))
        # the table form's walk (23.45 ms, PERF.md) is not rebuilt here
        k1 = time_k1_split("powerlaw_1m's dense body", model, model.device,
                           x, table=False)
        k1k = time_k1_split("powerlaw_1m's dense body", model, model.device,
                            x, table=False, kahan=True,
                            library_ms=k1["library_ms"])
        k1.update(kahan_ms=k1k["ms"], kahan_plain_ms=k1k["plain_ms"],
                  kahan_max_abs_err=k1k["max_abs_err"])
        del model, md, x
        print(f"  20d wall {time.perf_counter() - t1:.1f} s")
        print(f"  20e: {RX['name']} on random_4m's one plan over its four "
              f"column blocks, from the prewarmed cache ({card})")
        t1 = time.perf_counter()
        with cache_dir(prewarm.cache_dir):
            m4 = generate.load_corpus("random_4m")
            model = port.RoutedSpmv(port.EhybConfig(artifact_cache=True),
                                    device="cuda").setup(m4)
        print(f"  setup {time.perf_counter() - t1:.1f} s "
              f"({model.setup_seconds}); {len(model.blocks)} schedules")
        check(len(model.blocks) == 4
              and model.routed_apply.plan.stats["blocks"] == 4,
              f"random_4m: {len(model.blocks)} column blocks, one plan")
        res = dict(matrix="random_4m", dim=m4.dimension, nnz=m4.nnz,
                   iters=100, setup_seconds=model.setup_seconds)
        rx4 = time_routed(model, res, m4, model.device, pair=False)
        rx4["launches"] = r4["launches"]["RX"]
        loop = check_loop(res, model, model.device)
        profile_path("random_4m", res, model, loop["graph"],
                     eager_fallback=True)
        del model, m4
        rx4["wall_s"] = time.perf_counter() - t1
        print(f"  20e wall {rx4['wall_s']:.1f} s")
    print(f"  phase 20 wall {time.perf_counter() - t0:.1f} s")
    k9_launches = {mat: swept[mat]["ehyb"]["launches"]["K9"]
                   for mat in SMALL_DIA_ROWS}
    return dict(k1, launches=rp["launches"]["K1"]), rx4, k9_launches


# ---------------------------------------------------------------------------
# Phase 21: K1's split variants in float64 and compensated.
# ---------------------------------------------------------------------------

def check_heavy_16k(dev) -> list:
    """21b: powerlaw_16k through ``EhybSpmv`` in each config of
    ``HEAVY_CONFIGS``: against the oracle (F64_TOL in float64, ORACLE_TOL
    in float32), K1 launched once a product over a plan in the small form,
    then K1 timed by :func:`time_k1_split` (against the parent split form
    in turns, cuSPARSE in the config's type); returns the kernels
    entries."""
    m = generate.load_corpus("powerlaw_16k")
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    out = []
    for flags, kw in HEAVY_CONFIGS.items():
        t0 = time.perf_counter()
        model = port.EhybSpmv(port.EhybConfig(**kw), device=dev).setup(m)
        f64 = model.module.cells.cell_val.dtype == torch.float64
        reset_launches()
        err = rel_np(model.matvec(x), want)
        n = ehyb_stream.stream_body.launches
        st = model.module.cells.stats
        tol = F64_TOL if f64 else ORACLE_TOL
        check(err <= tol and n == 1 and small(model.module.cells),
              f"powerlaw_16k {flags}: rel {err:.3e} <= {tol}, K1 launched "
              f"{n} time(s) over {st['n_items']} work items of the small "
              f"form ({st['n_hubs']} hubs in {st['hub_items']} items)")
        k = time_k1_split(f"powerlaw_16k {flags}", model, dev,
                          model.prepare_x(x))
        out.append(dict(K1_SPLIT[flags], launches=n, rel_error=err, **k))
        del model
        print(f"  powerlaw_16k {flags} wall {time.perf_counter() - t0:.1f} s")
    return out


def check_dword_1m(dev, prebuild: "Prewarm") -> dict:
    """21c: ``powerlaw_1m --dword`` at full size through the CLI, its host
    artifact and K1's plan from ``prebuild``'s cache: within F64_TOL of the
    oracle, K1 f64 launched over a plan in the split form that holds the ER
    tail and the long rows (its build seconds on the host, its load, and
    the step beside the parent's), the peak device memory of the run; then
    K1 timed by :func:`time_k1_split` (no table form: its walk is
    ``chip_k1_sweep.py --long --f64``'s); returns its kernels entry."""
    rc, since, out = prebuild.wait(PREWARM_TIMEOUT_S)
    print("".join(f"    {ln}\n" for ln in out.splitlines()), end="")
    check(rc == 0, f"the prebuild exited {rc} after {since:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"  python -m ehyb_spmv_torch {' '.join(DWORD_1M_ARGS)} --cache "
          f"(the cache at {prebuild.cache_dir})")
    with cache_dir(prebuild.cache_dir):
        res, model, launches = drive(DWORD_1M_ARGS + ["--cache"], F64_TOL)
    peak = torch.cuda.max_memory_allocated(dev)
    p = model.module.cells
    st = p.stats
    lay = res["layout"]
    step_us = 1e6 * res["seconds"] / res["iters"]
    lo, hi = PARENT_STEP_US["powerlaw_1m --dword"]
    check(st["folded"] and st["tail_cells"] == lay["nnz_er"]
          + lay["nnz_long"] and st["real_cells"] == lay["nnz_ell"]
          + lay["nnz_er"] + lay["nnz_long"] and launches["K1"] > 0,
          f"powerlaw_1m --dword: K1's plan holds the tail ({lay['nnz_er']} "
          f"ER and {lay['nnz_long']} long-row entries beside "
          f"{lay['nnz_ell']} of the body: {st['real_cells']} cells, "
          f"{st['compact_cells']} with padding), built in "
          f"{st['build_seconds']:.1f} s on the host, loaded from the cache "
          f"in {res['setup_seconds']['k1_plan']:.1f} s; a step {step_us:.1f} "
          f"us ({res['gflops']:.2f} GFLOP/s) beside {lo:g} us before K1 "
          "took the tail (PERF.md)")
    check(res["engine"] == "EhybSpmv" and res["dim"] == 1 << 20
          and "cache_load" in res["setup_seconds"] and launches["K1"] > 0
          and split(p) and p.cell_val.dtype == torch.float64,
          f"powerlaw_1m --dword at full size: dim {res['dim']}, nnz "
          f"{res['nnz']}, K1 f64 launched {launches['K1']} times over "
          f"{st['n_items']} work items ({st['chunked_rbs']} row blocks in "
          f"{st['n_chunks']} chunks, {st['direct_pieces']} direct pieces, "
          f"{'grouped' if st['grouped'] else 'body order'}), layout "
          f"{res['layout']}, peak device memory {peak} B")
    k = time_k1_split("powerlaw_1m --dword", model, dev, model.prepare_x(
        deterministic_x(res["dim"])), table=False)
    return dict(K1_SPLIT_1M, launches=launches["K1"], peak_bytes=peak,
                gflops=res["gflops"], step_us=step_us,
                plan_seconds=st["build_seconds"],
                plan_load_seconds=res["setup_seconds"]["k1_plan"], **k)


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
        # 16e's host setup (powerlaw_1m's sharded degree split at one rank)
        sharded = jobs.enter_context(
            Prewarm(cache, "prebuild_sharded", PREBUILD_SHARDED_ARGS))
        return run_phases(prewarm, sharded, jobs)


def run_phases(prewarm: Prewarm, prebuild_sharded: Prewarm,
               jobs: contextlib.ExitStack) -> int:
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
                      rng.standard_normal(e.padded_x_rows), kahan, dev,
                      table=True)
    # its 80-step row blocks past SPLIT_STEPS
    if split(build_stream_cells(e, **k1_options(e))):
        check_k1_case("edge body (split form)", e,
                      rng.standard_normal(e.padded_x_rows), False, dev)
    print("  K1's split form (heavy-tailed bodies: long row blocks in chunks)")
    check_k1_split(dev)

    phase("4: the routed kernel vs its plain version, its CPU replay and the "
          "plain K7/K8 pair on small matrices (slice, octet, column blocks "
          "in one plan, spill), the split model, staged and direct plans")
    t4 = time.perf_counter()
    check_routed_small(dev)
    t4 = time.perf_counter() - t4
    print(f"  phase 4 wall {t4:.1f} s")

    phase("5: K9 and the window cache vs plain versions on small matrices; "
          "K1 where the TPU runs K5 or K6")
    t5 = time.perf_counter()
    check_dia_small(dev)
    check_wincache_small(dev)
    check_k5_k6(dev)
    t5 = time.perf_counter() - t5

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
    check(not split(cells), f"K1's plan of {res1['matrix']} is the table "
                            f"form: no row block over "
                            f"{cells.stats['split_steps']} steps (widest "
                            f"{cells.stats['max_width']})")

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
    # phase 17c's host setup (fem3d_68 in the precision mode)
    prebuild_fem = jobs.enter_context(Prewarm(
        prewarm.cache_dir, "prebuild_fem", PREBUILD_FEM_ARGS))
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
    t10 = time.perf_counter()
    print("  K1 with the tail folded in and K9 adding into its y, on small "
          "artifacts with ER, long-row and hub-split rows:")
    check_fold_small(dev)
    print(f"  (the fold's small artifacts {time.perf_counter() - t10:.1f} "
          "s)")
    print("  K1 on permuted_poisson_512's body and tail (main path 1):")
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
    print("  K9 on permuted_poisson_512's diagonal (main path 1), in both "
          "modes:")
    k9_512 = time_dia(model1, res1, dev, n=100, acc=True)
    t10s = time.perf_counter()
    print("  K9 at the DIA rows too small to fill the card at its default "
          "geometry (" + ", ".join(SMALL_DIA_ROWS) + "):")
    k9_small = time_dia_small(dev)
    t10s = time.perf_counter() - t10s
    print(f"  (the small DIA rows {t10s:.1f} s)")
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
    t10 = time.perf_counter() - t10
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
    for res, _ in rows:
        lo, hi = PARENT_STEP_US.get(res["matrix"], (None, None))
        if lo is not None:
            step_us = 1e6 * loop_s[res["matrix"]]["graph"]
            print(f"  {res['matrix']}: a step {step_us:.2f} us, beside "
                  f"{lo}-{hi} us before K1 took the tail (PERF.md)")

    phase("12: where the device time goes per iteration under the graph")
    prof = {res["matrix"]: profile_path(
        res["matrix"], res, model, loop_s[res["matrix"]]["graph"],
        strict=model is model1) for res, model in rows}
    # the graphs above were captured before the profiler first ran in this
    # process; capture random_1m's again now, after it, and profile them
    model2._chains.clear()
    again = profile_path(f"{res2['matrix']} (graphs captured after a "
                         "profile)", res2, model2,
                         loop_s[res2["matrix"]]["graph"])
    print(f"  FINDING: graphs captured after the profiler has run: it saw "
          f"{again['graph_seen']['kernels']:g} kernels a step of "
          f"{res2['matrix']}'s replays ({again['graph_seen']['us']:.2f} us), "
          f"against {prof[res2['matrix']]['graph_seen']['kernels']:g} "
          f"({prof[res2['matrix']]['graph_seen']['us']:.2f} us) for the "
          "graphs captured before")

    phase(f"13: CG on {res1['matrix']} through the flagship (K1 and K9 in "
          "the graph)")
    check_cg(model1, dev)

    phase(f"14: power iteration on {res1['matrix']}")
    check_power(model1)

    phase(f"15: the baselines on {res1['matrix']} through the CLI")
    base, base_res = {}, {}
    for name in ("csr", "bcoo", "hyb"):
        res, model, _ = drive(BASELINE_ARGS + [name])
        check(res["engine"] == type(model).__name__ == {
            "csr": "CsrSpmv", "bcoo": "BcooSpmv", "hyb": "HybSpmv"}[name],
            f"--model {name} ran {res['engine']}")
        base[name], base_res[name] = res["gflops"], res
        del model
    print(f"  {res1['matrix']}: ehyb {res1['gflops']:.2f} GFLOP/s, "
          + ", ".join(f"{k} {v:.2f}" for k, v in base.items())
          + " GFLOP/s (the CLI's graph loop, 500 iterations each)")
    apply = time_apply(model1, res1, dev, loop_s[res1["matrix"]]["graph"],
                       prof[res1["matrix"]], base_res["bcoo"], card)

    phase(f"16: the sharded path: K1 with a row-block list, then "
          f"ShardedEhybSpmv at 1, 2 and 4 ranks on {SHARDED_MATRIX}, and "
          "the sharded routed and degree-split engines")
    t16 = time.perf_counter()
    print("  16a: K1 with a row-block list vs its plain version; its split "
          "variants over lists of work items; K9 with an x base")
    check_k1_lists(dev)
    check_k1_split_lists(dev)
    check_dia_base(dev)
    sk1 = check_sharded(m6, model6, model2.m, dev, card)
    k9_base = sk1.pop("k9_base")
    del model6, m6
    t16e = time.perf_counter()
    print(f"  16e: ehyb_split_sharded at world 1 on powerlaw_1m at full size "
          f"({card})")
    sk1_1m = check_split_sharded_1m(dev, card, prebuild_sharded)
    print(f"  16e wall {time.perf_counter() - t16e:.1f} s; phase 16 "
          f"{time.perf_counter() - t16:.1f} s")

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
    rc, since, out = prebuild_fem.wait(PREWARM_TIMEOUT_S)
    print("".join(f"    {ln}\n" for ln in out.splitlines()), end="")
    check(rc == 0, f"the prebuild exited {rc} after {since:.1f} s")
    # phase 21c's host setup (powerlaw_1m in the precision mode)
    prebuild_dword = jobs.enter_context(Prewarm(
        prewarm.cache_dir, "prebuild_dword", PREBUILD_DWORD_ARGS))
    print(f"  17c: python -m ehyb_spmv_torch {' '.join(DWORD_FEM_ARGS)} "
          f"--cache (the cache at {prewarm.cache_dir})")
    with cache_dir(prewarm.cache_dir):
        res8, model8, launch8 = drive(DWORD_FEM_ARGS + ["--cache"])
    lay = res8["layout"]
    print(f"  layout: {lay}; {len(model8.dev.dia_offsets)} diagonals "
          f"(nnz_dia {lay['nnz_dia']} of {res8['nnz']}), TPU branch "
          f"{model8.module.branch}")
    st = model8.module.cells.stats
    got = {k: st[k] for k in FEM_DWORD_PLAN}
    check(got == FEM_DWORD_PLAN and not split(model8.module.cells)
          and st["folded"] and st["tail_cells"] == lay["nnz_er"]
          + lay["nnz_long"] and st["real_cells"] == lay["nnz_ell"]
          + lay["nnz_er"] + lay["nnz_long"],
          f"fem3d_68 --dword's K1 plan with its tail ({st['tail_cells']} "
          f"cells) folded in, as the fold first built it, no row block past "
          f"SPLIT_STEPS_F64 {stream_cells.SPLIT_STEPS_F64}: {got}")
    check(res8["dim"] == 943296 and res8["rel_error"] <= F64_TOL
          and launch8["K9"] > 0 and launch8["WC"] == 0,
          f"fem3d_68 in f64: rel {res8['rel_error']:.3e}, {K9F64['name']} "
          f"launched {launch8['K9']} times, K1 {launch8['K1']} times; "
          f"{res8['gflops']:.2f} GFLOP/s beside {res3['gflops']:.2f} in "
          "f32 (phase 8)")
    print(f"  17d: K1 in f64 on pp512's precision-mode body ({card}):")
    k1f64 = time_k1(model7, res7, dev, n_eager=50)
    k1f64.update(time_k1_forms(model7, res7, dev))
    print(f"  K1 in f64 on fem3d_68's precision-mode body (17c's model; "
          f"{card}):")
    k1f64_fem = time_k1(model8, res8, dev, n=20, n_plain=3, n_eager=10)
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
    print(f"  K1 on powerlaw_16k's body (the body the gate weighs; {card}):")
    m16 = generate.load_corpus("powerlaw_16k")
    model16 = port.EhybSpmv(port.EhybConfig(routed_delegate="never"),
                            device=dev).setup(m16)
    k1_16k = time_k1_split("powerlaw_16k", model16, dev, model16.prepare_x(
        deterministic_x(m16.dimension)))
    # its step by kernel under the graph loop (PERF.md, where the time goes)
    res16 = dict(matrix="powerlaw_16k", dim=m16.dimension, nnz=m16.nnz,
                 iters=300)
    loop16 = check_loop(res16, model16, dev)
    profile_path("powerlaw_16k", res16, model16, loop16["graph"])
    del model16, m16
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
    k1_1m, rx4, k9_small_launches = check_bench_surface(prewarm, res1, card)
    t21 = time.perf_counter()
    phase("21: K1's split variants in float64 and compensated, and the "
          "small form: small "
          "bodies, powerlaw_16k in four configs, powerlaw_1m --dword")
    print("  21a: the split variants vs their plain versions on small "
          "bodies")
    check_k1_split_variants(dev)
    print("  21a: the small form vs its plain version on small bodies")
    check_k1_small(dev)
    print(f"  21a wall {time.perf_counter() - t21:.1f} s")
    print(f"  21b: powerlaw_16k with {', '.join(HEAVY_CONFIGS)} ({card})")
    heavy = check_heavy_16k(dev)
    t1 = time.perf_counter()
    print(f"  21c: powerlaw_1m --dword at full size ({card})")
    k1_1m_dword = check_dword_1m(dev, prebuild_dword)
    print(f"  21c wall {time.perf_counter() - t1:.1f} s")
    t_end = time.perf_counter()
    print(f"  phase 4 {t4:.1f} s, phase 5 {t5:.1f} s, phase 10 {t10:.1f} "
          f"s (the small DIA rows {t10s:.1f} s), phase 17 {t18 - t17:.1f} s, "
          "phase 18 "
          f"{t19 - t18:.1f} s, phase 19 {t20 - t19:.1f} s, phase 20 "
          f"{t21 - t20:.1f} s (20e {rx4.pop('wall_s'):.1f} s), phase 21 "
          f"{t_end - t21:.1f} s; script wall {t_end - t_start:.1f} s")

    print(json.dumps({"small_gate": gates}))
    print(json.dumps({"kernels": [
        dict(K1, launches=launch1["K1"], **k1),
        dict(RX, launches=launch2["RX"], **rx),
        dict(RX, name="route_xcache@random_4m", **rx4),
        dict(K9, launches=launch3["K9"], **k9),
        dict(K9, name="dia (accumulate mode, permuted_poisson_512)",
             launches=launch1["K9"], **dict(k9_512, ms=k9_512["acc_ms"])),
        *(dict(K9, name=f"dia (small rows, {mat})",
               launches=k9_small_launches[mat], **k9_small[mat])
          for mat in SMALL_DIA_ROWS),
        dict(APPLY, launches=launch1["K1"], **apply),
        dict(WC, launches=launch4["WC"], **wc),
        dict(SK1, **sk1),
        sk1_1m,
        *([dict(K9_BASE, launches=sk1["k9_launches"], **k9_base)]
          if k9_base is not None else []),
        dict(K1F64, launches=launch7["K1"], **k1f64),
        dict(K1F64_FEM, launches=launch8["K1"], **k1f64_fem),
        dict(K9F64, launches=launch8["K9"], **k9f64),
        f64k["k1k"], f64k["sk1"], f64k["wc"], f64k["wck"],
        dict(K1_LONG_1M, **k1_1m),
        dict(K1_LONG_16K, launches=gates["powerlaw_16k"]["k1_launches"],
             **k1_16k), *heavy, k1_1m_dword]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
