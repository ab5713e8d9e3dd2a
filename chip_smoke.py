"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from ``ehyb_spmv_torch/csrc/`` (one
``nvcc`` each, all started together): K1, the streamed SELL body; K7 and K8,
the routed engine's two stages; K9, the DIA body; and the x-window-cache
body that serves the TPU's K3/K4.  Checks each against its plain PyTorch
version on small matrices that land on every layout it serves (and K1
where the JAX package would run K5 or K6), then drives four main paths end
to end through the CLI and checks each against the exact-f64 oracle:

* the flagship on ``permuted_poisson_512`` (262,144 rows, ~1.3M nnz), which
  runs K1 and K9;
* the gather-wall row: ``ehyb`` on ``random_1m`` (1,048,576 rows, 16,769,356
  nnz), which the flagship's delegation gate hands to the routed engine
  (K7, K8);
* the audikw-class FEM row ``fem3d_68_audikw_class`` (943,296 rows,
  74,181,672 nnz, all DIA), which runs K9 alone;
* ``permuted_poisson_4096`` (16,777,216 rows, 83,869,696 nnz), whose x is
  past the TPU's residency limit: the window-cache body and K9.

Each path runs with the launch counts set to 0 just before it and read just
after, to show it went through its kernels.  Then it times every kernel and
its plain version at its main path's shapes (K1 also on
permuted_poisson_4096's body, beside the window cache, and both on
``permuted_poisson_1024`` forced past the residency limit, where the TPU
runs K3), beside one cuSPARSE call (``torch.sparse_csr_tensor`` matvec) as
a yardstick, and prints one JSON line of kernels with two bounds each:
the bytes of the kernel's own layout, and the same work in any layout (each
entry's value and column, x and y once).

Imports only the port (never JAX or the JAX package).  Exits non-zero when
any phase fails or no CUDA device is present.  The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.core.coo import MatrixCOO, deterministic_x, oracle_spmv
from ehyb_spmv_torch.core.route import build_routed
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.models import routed as routed_model
from ehyb_spmv_torch.ops import dia, ehyb_stream, ehyb_wincache, route
from ehyb_spmv_torch.ops import stream_plan
from ehyb_spmv_torch.ops.torch_ops import body_gather_index
from ehyb_spmv_torch.utils.timing import detect_hbm_bw

#: Kernel vs plain version, f32 both: only the summation order differs.
KERNEL_TOL = 1e-6
#: End to end vs the exact-f64 oracle: the suite's bound.
ORACLE_TOL = 5e-6
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
_PALLAS = "ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py"
K1 = {"name": "ehyb_stream_body", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/ehyb_stream.cu",
      "replaces": f"{_PALLAS}:148 (K1); also serves {_PALLAS}:615 (K2), "
                  f"{_PALLAS}:84 (K5), {_PALLAS}:109 (K6)"}
K7 = {"name": "route_at", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/route_at.cu",
      "replaces": "ehyb_spmv_gpu_tpu/ops/route_pallas.py:56"}
K8 = {"name": "route_b", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/route_b.cu",
      "replaces": "ehyb_spmv_gpu_tpu/ops/route_pallas.py:87"}
K9 = {"name": "dia", "route": "cuda", "source": "ehyb_spmv_torch/csrc/dia.cu",
      "replaces": "ehyb_spmv_gpu_tpu/ops/dia_pallas.py:68 (K9, inner "
                  "kernels :115 and :131)"}
WC = {"name": "ehyb_wincache_body", "route": "cuda",
      "source": "ehyb_spmv_torch/csrc/ehyb_wincache.cu",
      "replaces": f"{_PALLAS}:293 (K3), {_PALLAS}:489 (K4)"}
#: float32 peak outside the tensor cores (NVIDIA's data sheets), matched like
#: the bandwidth table of utils/timing.py: the first key in the name wins.
PEAK_F32 = {"h100 pcie": 51e12, "h100": 67e12}


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


def bound(n_bytes: int, n_ops: int, dev: torch.device) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the f32 operations over its peak rate."""
    name = torch.cuda.get_device_name(dev).lower()
    bw = detect_hbm_bw(dev)
    peak = next((v for k, v in PEAK_F32.items() if k in name), None)
    if bw is None or peak is None:
        raise RuntimeError(f"no memory or f32 peak rate for {name!r}")
    t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def same_work_bound(nnz: int, idx_bytes: int, n_x: int, n_y: int,
                    dev: torch.device) -> dict:
    """The bound of the same product in any layout: each entry's f32 value
    and ``idx_bytes`` of column once, x once and y once (f32)."""
    n_bytes = nnz * (4 + idx_bytes) + 4 * (n_x + n_y)
    return dict(bound(n_bytes, 2 * nnz, dev), bytes=n_bytes)


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


def reset_launches() -> None:
    for fn in (ehyb_stream.stream_body, route.route_at, route.route_b,
               dia.dia_body, ehyb_wincache.wincache_body):
        fn.launches = 0


def routed_plain(d, x: torch.Tensor) -> torch.Tensor:
    """The routed apply of one schedule through the kernels' plain
    versions."""
    y_dst = route.route_b_plain(d, route.route_at_plain(d, x))
    return route.to_input_space(d, route.spill_tail(d, x, y_dst))


def check_schedule(name: str, d, x: torch.Tensor) -> None:
    """K7, K8 and the full apply of one schedule against their plain
    versions on the card."""
    t_k = route.route_at(d, x)
    t_p = route.route_at_plain(d, x)
    torch.cuda.synchronize()
    check(torch.equal(t_k, t_p), f"{name}: K7 equals its plain version "
                                 f"({t_k.numel()} products)")
    y_k = route.route_b(d, t_p)
    y_p = route.route_b_plain(d, t_p)
    torch.cuda.synchronize()
    err = rel(y_k, y_p)
    check(bool(torch.isfinite(y_k).all()) and err <= KERNEL_TOL,
          f"{name}: K8 vs plain rel {err:.3e} <= {KERNEL_TOL}")
    y_k = route.RoutedApply(d)(x)
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
    """Every layout K7 and K8 serve, on small matrices."""
    cfg = port.EhybConfig()
    x_of = deterministic_x
    # slice layout, one block, identity dst
    m = generate.random_general(16384, 12, seed=3)
    model = port.RoutedSpmv(cfg, device=dev).setup(m)
    d = model.applies[0].d
    check(len(model.blocks) == 1 and not d.octet and d.ident,
          "slice: one block, slice layout, identity dst")
    check_schedule("slice", d, model.prepare_x(x_of(m.dimension)))
    models = [("slice", m, model)]
    # octet layout, permuted dst (built as the JAX suite builds it)
    m = random_coo(1 << 17, 1, seed=41)
    rm = build_routed(m, R=4096, P=64)
    d = rm.to_torch(device=dev)
    check(d.octet, f"octet: octet layout ({rm.stats['b_steps']} B steps)")
    x = np.zeros(rm.padded_x_rows, np.float32)
    x[:m.dimension] = x_of(m.dimension)
    x = torch.as_tensor(x, device=dev)
    check_schedule("octet", d, x)
    y = route.RoutedApply(d)(x).cpu().numpy()[:m.dimension]
    err = rel_np(y, oracle_spmv(m, x_of(m.dimension)))
    check(err <= ORACLE_TOL, f"octet: apply vs oracle rel {err:.3e} <= "
                             f"{ORACLE_TOL}")
    # column-block mode
    m = random_coo(1 << 15, 8, seed=17)
    model = block_mode_model(m, dev)
    check(len(model.blocks) == 4, f"blocks: {len(model.blocks)} blocks")
    x = model.prepare_x(x_of(m.dimension))
    for i, (ap, lo) in enumerate(zip(model.applies, model._lo)):
        check_schedule(f"block {i}", ap.d, x[lo:lo + ap.d.padded_x_rows])
    models.append(("blocks", m, model))
    # slice layout with a spill tail
    m = generate.random_general(4096, 12, seed=9, power_law=0.8)
    model = port.RoutedSpmv(cfg, device=dev).setup(m)
    spill = model.blocks[0].stats["nnz_spill"]
    check(spill > 0, f"spill: {spill} spilled entries")
    check_schedule("spill", model.applies[0].d,
                   model.prepare_x(x_of(m.dimension)))
    models.append(("spill", m, model))
    # the degree-split hybrid (K1 beside K7/K8)
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


def check_dia_small(dev) -> None:
    """K9 against its plain version: one diagonal; fem3d_16's 99; offsets
    past the block edges both ways with rows that are not a multiple of
    the block; a span too wide to stage."""
    rng = np.random.default_rng(5)
    cases = [("K=1", (0,), 100_003),
             ("edges", (-5000, -2049, -1, 0, 1, 2047, 2048, 5000), 12_345),
             ("wide span", (-40_000, -3, 0, 3, 40_000), 100_000)]
    for name, offs, dim_r in cases:
        e = types.SimpleNamespace(dia_offsets=offs, dia_val=torch.as_tensor(
            rng.standard_normal((len(offs), dim_r)), dtype=torch.float32,
            device=dev))
        x = torch.as_tensor(rng.standard_normal(dim_r - 77),
                            dtype=torch.float32, device=dev)
        y_k, y_p = dia.dia_body(e, x), dia.dia_body_plain(e, x)
        torch.cuda.synchronize()
        err = rel(y_k, y_p)
        check(bool(torch.isfinite(y_k).all()) and err <= KERNEL_TOL,
              f"K9 {name} ({'staged' if dia.stages_x(offs) else '__ldg'}): "
              f"vs plain rel {err:.3e} <= {KERNEL_TOL}")
    m = generate.fem3d(16)
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    e = model.dev
    x_dev = model.prepare_x(deterministic_x(m.dimension))
    y_k, y_p = dia.dia_body(e, x_dev), dia.dia_body_plain(e, x_dev)
    torch.cuda.synchronize()
    err = rel(y_k, y_p)
    check(len(e.dia_offsets) == 99 and err <= KERNEL_TOL,
          f"K9 fem3d_16 ({len(e.dia_offsets)} diagonals): vs plain rel "
          f"{err:.3e} <= {KERNEL_TOL}")
    x = deterministic_x(m.dimension)
    err = rel_np(model.matvec(x), oracle_spmv(m, x))
    check(err <= ORACLE_TOL, f"fem3d_16 model vs oracle rel {err:.3e}")


def padded_body(model, dev):
    """The model's artifact on the card with the padded SELL body that K1
    reads: a model whose body runs through the window cache keeps only the
    plan's compact cells there."""
    return model.ehyb.to_torch(dtype=model.config.dtype, device=dev)


def check_wincache_plan(name: str, e, p, x_dev, kahan: bool) -> None:
    """The window-cache kernel on one plan against its plain version and
    against K1 on the same body; prints the largest difference from K1
    (0 where the summation order is kept, as it is for finite x)."""
    y_w = ehyb_wincache.wincache_body(e, p, x_dev, kahan)
    y_p = ehyb_wincache.wincache_body_plain(e, p, x_dev, kahan)
    y_1 = ehyb_stream.stream_body(e, x_dev, kahan)
    torch.cuda.synchronize()
    err_p, err_1 = rel(y_w, y_p), rel(y_w, y_1)
    st = p.stats
    check(bool(torch.isfinite(y_w).all()) and err_p <= KERNEL_TOL
          and err_1 <= KERNEL_TOL,
          f"{name} ({st['n_blocks']} blocks, {st['chunked_slices']} chunked "
          f"slices, {st['compact_cells']} of {st['padded_cells']} cells): "
          f"window cache vs plain rel {err_p:.3e}, vs K1 rel {err_1:.3e}, "
          f"max abs from K1 {float((y_w - y_1).abs().max()):.3e}")


def check_wincache_small(dev) -> None:
    """The window-cache kernel against its plain version and against K1
    at nwin 1/2/4 and Kahan, forced past the residency limit in-process,
    with a slot budget so tight that slices overflow a stage, and with 1
    and 4 groups."""
    for name, m, cfg, nwin, kahan in kernel_cases():
        with patched(X_RESIDENT_BYTES=1024):
            model = port.EhybSpmv(cfg, device=dev).setup(m)
        e, plan = padded_body(model, dev), model.module.wincache
        check(e.nwin == nwin and plan is not None
              and model.module.branch.startswith("streamed hbm")
              and model.dev.ell_val is None,
              f"{name}: branch {model.module.branch}, nwin={e.nwin}, no "
              f"padded body on the card")
        x = deterministic_x(m.dimension) if not kahan else np.ones(m.dimension)
        x_dev = model.prepare_x(x)
        check_wincache_plan(name, e, plan, x_dev, kahan)
        tight = ehyb_wincache.build_wincache_plan(model.ehyb, slot_rows=32)
        if tight.stats["chunked_slices"]:
            check_wincache_plan(f"{name} tight", e, tight.to_torch(dev),
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
    e = padded_body(model, dev)
    for groups in (1, 4):
        p = ehyb_wincache.build_wincache_plan(model.ehyb, slot_rows=64,
                                              groups=groups)
        check(p.stats["chunked_slices"] > 0, "scattered 32k quad: slices "
                                             "overflow 64 slot rows")
        check_wincache_plan(f"scattered 32k quad, {groups} groups", e,
                            p.to_torch(dev), x_dev, False)


def check_k5_k6(dev) -> None:
    """K1 where the JAX package would run K5 (the stream turned off) or K6
    (x past residency, no window-cache geometry, 1024-aligned windows):
    the flagship takes the TPU's branch and launches K1."""
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


def drive(args):
    """One main path through the CLI with the launch counts set to 0 just
    before it; returns (result, model, launches, wall seconds)."""
    reset_launches()
    t0 = time.perf_counter()
    code, result, model = cli.run(cli.build_parser().parse_args(args))
    wall = time.perf_counter() - t0
    launches = {"K1": ehyb_stream.stream_body.launches,
                "K7": route.route_at.launches, "K8": route.route_b.launches,
                "K9": dia.dia_body.launches,
                "WC": ehyb_wincache.wincache_body.launches}
    print(json.dumps(result))
    check(code == 0 and result is not None, f"CLI exit code {code}")
    print(f"  wall {wall:.1f} s; setup seconds per phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      result["setup_seconds"].items()))
    check(result["rel_error"] <= ORACLE_TOL,
          f"rel error vs exact-f64 oracle {result['rel_error']:.3e} "
          f"<= {ORACLE_TOL}")
    print(f"  launches during the run: {launches}")
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


def time_k1(model, result, dev, e=None, n: int = 100, n_plain: int = 20,
            n_eager: int = 200) -> dict:
    """K1 at a flagship path's shapes: kernel, plain version and cuSPARSE
    over the body's own entries.  ``e``, the artifact on the card, defaults
    to the model's own."""
    e = model.dev if e is None else e
    kahan = model.module.kahan
    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    y_k = ehyb_stream.stream_body(e, x_dev, kahan)
    y_p = ehyb_stream.stream_body_plain(e, x_dev, kahan)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL, f"K1 vs plain rel {err:.3e} <= {KERNEL_TOL} "
                             f"(max abs {max_abs:.3e}, "
                             f"{e.ell_val.shape[0]} steps)")
    a = body_csr(e, y_k.shape[0], x_dev.shape[0], dev)
    y_l = torch.mv(a, x_dev)
    torch.cuda.synchronize()
    err = rel(y_l, y_p)
    check(err <= KERNEL_TOL, f"cuSPARSE over K1's {a.values().numel()} body "
                             f"entries vs plain rel {err:.3e}")
    del y_l
    kernel = lambda: ehyb_stream.stream_body(e, x_dev, kahan)  # noqa: E731
    plain = lambda: ehyb_stream.stream_body_plain(e, x_dev, kahan)  # noqa
    ms, plain_ms, turns = in_turns(kernel, plain, n, n_plain)
    lib_ms = device_ms_per_call(lambda: torch.mv(a, x_dev), n)
    n_bytes = nbytes(e.ell_col, e.ell_val, e.slice_offset,
                     *[e.step_win, e.step_win_b, e.step_win_c,
                       e.step_win_d][:e.nwin], x_dev, y_k)
    b = bound(n_bytes, 2 * e.body_nnz, dev)
    same = same_work_bound(e.body_nnz, 2, x_dev.numel(), y_k.numel(), dev)
    print(f"  K1 device ms per call (plain, kernel, kernel, plain): "
          f"{turns}; cuSPARSE over its body {lib_ms:.4f} ms; layout bound "
          f"{b['bound_ms']:.4f} ms ({n_bytes} B, {b['bound_by']}); "
          f"same-work bound {same['bound_ms']:.4f} ms ({same['bytes']} B)")
    print(f"  eager calls back to back (host launch cost included): "
          f"K1 {ms_per_call(kernel, n_eager):.4f} ms, full apply "
          f"{ms_per_call(lambda: model.apply(x_dev), n_eager):.4f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **b, same_work_bound_ms=same["bound_ms"])


def time_wincache(model, result, dev, k1: dict, e) -> dict:
    """The window-cache body at a path's shapes against its plain version,
    beside K1 on the same body and cuSPARSE over the same entries (``k1``,
    from :func:`time_k1` on ``e``, the artifact with its padded body), with
    the cells it reads against the padded body's and both bounds: the bytes
    its layout moves, and the same work in any layout."""
    d, p = model.dev, model.module.wincache
    kahan = model.module.kahan
    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    y_k = ehyb_wincache.wincache_body(d, p, x_dev, kahan)
    y_p = ehyb_wincache.wincache_body_plain(d, p, x_dev, kahan)
    y_1 = ehyb_stream.stream_body(e, x_dev, kahan)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL, f"window cache vs plain rel {err:.3e} <= "
                             f"{KERNEL_TOL} (max abs {max_abs:.3e})")
    err = rel(y_k, y_1)
    check(err <= KERNEL_TOL, f"window cache vs K1 rel {err:.3e}, max abs "
                             f"{float((y_k - y_1).abs().max()):.3e}")
    del y_p, y_1
    ms, plain_ms, turns = in_turns(
        lambda: ehyb_wincache.wincache_body(d, p, x_dev, kahan),
        lambda: ehyb_wincache.wincache_body_plain(d, p, x_dev, kahan), 20, 2)
    st = p.stats
    check(st["compact_cells"] <= 1.1 * e.body_nnz,
          f"compact cells {st['compact_cells']} of {st['padded_cells']} "
          f"padded ({st['real_cells']} real; body nnz {e.body_nnz}): "
          f"{st['compact_cells'] / e.body_nnz:.5f} x the body's entries")
    lay = bound(st["layout_bytes"], 2 * e.body_nnz, dev)
    same = same_work_bound(e.body_nnz, 2, x_dev.numel(), y_k.numel(), dev)
    print(f"  window cache device ms per call (plain, kernel, kernel, "
          f"plain): {turns}; K1 on the same body {k1['ms']:.4f} ms; "
          f"cuSPARSE over the body {k1['library_ms']:.4f} ms")
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
                library_ms=k1["library_ms"], **lay,
                same_work_bound_ms=same["bound_ms"])


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
    """K9 at a flagship path's shapes: kernel, plain version and cuSPARSE
    over the same DIA entries."""
    e = model.dev
    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    y_k = dia.dia_body(e, x_dev)
    y_p = dia.dia_body_plain(e, x_dev)
    torch.cuda.synchronize()
    max_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL, f"K9 vs plain rel {err:.3e} <= {KERNEL_TOL} "
                             f"(max abs {max_abs:.3e}, "
                             f"{len(e.dia_offsets)} diagonals)")
    a = dia_csr(e, x_dev.shape[0], dev)
    y_l = torch.mv(a, x_dev)
    torch.cuda.synchronize()
    err = rel(y_l, y_p)
    check(err <= KERNEL_TOL, f"cuSPARSE over the {a.values().numel()} DIA "
                             f"entries vs plain rel {err:.3e}")
    ms, plain_ms, turns = in_turns(lambda: dia.dia_body(e, x_dev),
                                   lambda: dia.dia_body_plain(e, x_dev),
                                   n, max(n // 10, 2))
    lib_ms = device_ms_per_call(lambda: torch.mv(a, x_dev), n)
    k, dim_r = e.dia_val.shape
    n_bytes = (k * dim_r + 2 * dim_r) * 4
    b = bound(n_bytes, 2 * k * dim_r, dev)
    # the diagonals carry no column: each entry's value, x and y once
    same = same_work_bound(a.values().numel(), 0, x_dev.numel(), dim_r, dev)
    staged = dia.stages_x(e.dia_offsets)
    print(f"  K9 ({k} diagonals, {dim_r} rows, x "
          f"{'staged' if staged else 'through __ldg'}) device ms per call "
          f"(plain, kernel, kernel, plain): {turns}; cuSPARSE over its "
          f"entries {lib_ms:.4f} ms; layout bound {b['bound_ms']:.4f} ms "
          f"({n_bytes} B, {b['bound_by']}); same-work bound "
          f"{same['bound_ms']:.4f} ms ({same['bytes']} B)")
    if staged:
        # the A/B of staging: the same kernel reading x through __ldg
        limit, dia.STAGE_LIMIT_BYTES = dia.STAGE_LIMIT_BYTES, 0
        try:
            ldg_ms = device_ms_per_call(lambda: dia.dia_body(e, x_dev), n)
        finally:
            dia.STAGE_LIMIT_BYTES = limit
        print(f"  K9 with x through __ldg instead: {ldg_ms:.4f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **b, same_work_bound_ms=same["bound_ms"])


def time_routed(model, m: MatrixCOO, dev) -> tuple:
    """K7, K8 and the whole routed apply at random_1m's shapes, and one
    cuSPARSE matvec over the whole matrix.  Neither stage alone computes
    the product, so both carry the whole apply's same-work bound."""
    check(len(model.applies) == 1, "random_1m runs one routed block")
    d = model.applies[0].d
    x_dev = model.prepare_x(deterministic_x(m.dimension))
    t_k = route.route_at(d, x_dev)
    t_p = route.route_at_plain(d, x_dev)
    y_k = route.route_b(d, t_p)
    y_p = route.route_b_plain(d, t_p)
    torch.cuda.synchronize()
    at_abs = float((t_k - t_p).abs().max())
    check(torch.equal(t_k, t_p), "K7 equals its plain version at full size")
    b_abs = float((y_k - y_p).abs().max())
    err = rel(y_k, y_p)
    check(err <= KERNEL_TOL, f"K8 vs plain rel {err:.3e} <= {KERNEL_TOL} "
                             f"(max abs {b_abs:.3e})")
    del t_k, y_k, y_p
    at_ms, at_plain, at_turns = in_turns(
        lambda: route.route_at(d, x_dev),
        lambda: route.route_at_plain(d, x_dev), 50, 5)
    b_ms, b_plain, b_turns = in_turns(
        lambda: route.route_b(d, t_p),
        lambda: route.route_b_plain(d, t_p), 50, 5)
    apply_ms = device_ms_per_call(lambda: model.apply(x_dev), 20)
    apply_plain = device_ms_per_call(lambda: routed_plain(d, x_dev), 5)
    nnz_routed = int(model.blocks[0].stats["nnz_routed"])
    b_at = bound(nbytes(d.a_col, d.a_val, d.a_win) + 4 * d.padded_x_rows
                 + 4 * t_p.numel(), nnz_routed, dev)
    b_b = bound(nbytes(d.b_idx, d.b_gmap, d.b_boff, d.seg_first, d.seg_last,
                       t_p) + 4 * d.n_dst_rows, nnz_routed, dev)
    # the yardstick: one cuSPARSE CSR matvec over the whole matrix, in the
    # original ordering
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
    lib_ms = device_ms_per_call(lambda: torch.mv(a, x), 20)
    a_bytes = nbytes(a.crow_indices(), a.col_indices(), a.values(), x) \
        + 4 * m.n_rows
    lib_bound = bound(a_bytes, 2 * m.nnz, dev)
    # 1M columns need 32-bit column indices
    same = same_work_bound(m.nnz, 4, m.dimension, m.n_rows, dev)
    print(f"  K7 device ms (plain, kernel, kernel, plain): {at_turns}; "
          f"bound {b_at['bound_ms']:.4f} ms ({b_at['bound_by']})")
    print(f"  K8 device ms (plain, kernel, kernel, plain): {b_turns}; "
          f"bound {b_b['bound_ms']:.4f} ms ({b_b['bound_by']})")
    print(f"  routed apply (K7 + K8 + spill tail + epilogue) {apply_ms:.4f} "
          f"ms device time, through the plain versions {apply_plain:.4f} "
          f"ms; cuSPARSE CSR matvec over the whole matrix {lib_ms:.4f} ms "
          f"(bound {lib_bound['bound_ms']:.4f} ms, {a_bytes} B; same-work "
          f"bound {same['bound_ms']:.4f} ms, {same['bytes']} B): routed / "
          f"cuSPARSE = {apply_ms / lib_ms:.3f}; the apply's device "
          f"GFLOP/s {2e-6 * m.nnz / apply_ms:.2f}, cuSPARSE's "
          f"{2e-6 * m.nnz / lib_ms:.2f}")
    return (dict(max_abs_err=at_abs, ms=at_ms, plain_ms=at_plain,
                 library_ms=None, **b_at, same_work_bound_ms=same["bound_ms"]),
            dict(max_abs_err=b_abs, ms=b_ms, plain_ms=b_plain,
                 library_ms=None, **b_b, same_work_bound_ms=same["bound_ms"]))


def profile_path(name: str, result: dict, model, n: int = 20) -> None:
    """Device time by kernel over ``n`` iterations of a main path
    (``torch.profiler``), and the device's busy share of the unprofiled
    wall time per iteration the CLI measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x_dev = model.prepare_x(deterministic_x(result["dim"]))
    model.iterate(x_dev, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.iterate(x_dev, n)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels) / n
    wall_us = 1e6 * result["seconds"] / result["iters"]
    print(f"  {name}: device busy {busy_us:.2f} us per iteration "
          f"(torch.profiler, {n} iterations) of {wall_us:.2f} us wall "
          f"unprofiled: {100 * busy_us / wall_us:.1f}% busy")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / n:10.2f} us  x{e.count / n:g}  "
              f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
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
    builds = {"K1": ehyb_stream.build_kernel, "K7": route.build_route_at,
              "K8": route.build_route_b, "K9": dia.build_kernel,
              "WC": ehyb_wincache.build_kernel}
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
        err = rel_np(y, oracle_spmv(m, x))
        check(err <= ORACLE_TOL,
              f"{name}: model vs oracle rel {err:.3e} <= {ORACLE_TOL}")
        if kahan:
            check(y[0] == 100.0, f"{name}: compensated row 0 = {y[0]!r}")

    phase("4: K7 and K8 vs plain versions on small matrices (slice, octet, "
          "column blocks, spill) and the split model")
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

    phase("7: main path 2, the gather-wall row "
          f"(python -m ehyb_spmv_torch {' '.join(GATHER_ARGS)})")
    res2, model2, launch2 = drive(GATHER_ARGS)
    check(res2["engine"] == "RoutedSpmv",
          f"the gate delegated to {res2['engine']}")
    check(res2["dim"] == 1048576 and res2["nnz"] == 16769356,
          f"full size: dim {res2['dim']}, nnz {res2['nnz']}")
    print(f"  nnz_routed {res2['nnz_routed']}, nnz_spill {res2['nnz_spill']}")
    for k in ("K7", "K8"):
        check(launch2[k] > 0, f"{k} launched {launch2[k]} times during main "
                              "path 2")

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
    k1 = time_k1(model1, res1, dev)
    k7, k8 = time_routed(model2, model2.m, dev)
    k9 = time_dia(model3, res3, dev)
    print("  K9 on permuted_poisson_4096's diagonal:")
    time_dia(model4, res4, dev, n=20)
    print("  K1 on permuted_poisson_4096's padded body, uploaded for it "
          "(the TPU's K2 regime; L2 instead of the window cache):")
    e4 = padded_body(model4, dev)
    k1_big = time_k1(model4, res4, dev, e4, n=20, n_plain=2, n_eager=20)
    print("  the window cache on permuted_poisson_4096's body:")
    wc = time_wincache(model4, res4, dev, k1_big, e4)
    del e4
    print("  permuted_poisson_1024 forced past the residency limit "
          "in-process (the TPU's K3 branch): K1, then the window cache")
    with patched(X_RESIDENT_BYTES=1024):
        m5 = generate.load_corpus("permuted_poisson_1024")
        model5 = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m5)
    check(model5.module.branch == "streamed hbm"
          and model5.module.wincache is not None,
          f"TPU branch {model5.module.branch}: the window cache runs")
    res5 = {"dim": m5.dimension}
    e5 = padded_body(model5, dev)
    time_wincache(model5, res5, dev, time_k1(model5, res5, dev, e5,
                                             n_plain=10, n_eager=20), e5)
    del model5, e5
    for res in (res1, res2, res3, res4):
        print(f"  {res['matrix']}: {res['gflops']:.2f} GFLOP/s end to end "
              f"({res['iters']} iterations in {res['seconds']:.4f} s, "
              f"{1e3 * res['seconds'] / res['iters']:.4f} ms each)")

    phase("11: where the device time goes per iteration")
    for res, model in ((res1, model1), (res2, model2), (res3, model3),
                       (res4, model4)):
        profile_path(res["matrix"], res, model)
    print(f"  script wall {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        dict(K1, launches=launch1["K1"], **k1),
        dict(K7, launches=launch2["K7"], **k7),
        dict(K8, launches=launch2["K8"], **k8),
        dict(K9, launches=launch3["K9"], **k9),
        dict(WC, launches=launch4["WC"], **wc)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
