"""Geometry sweep of the window-cache body on one CUDA GPU.

    python3 chip_wincache_sweep.py

Builds ``permuted_poisson_4096`` through the flagship (x past the TPU's
residency limit, so its body runs the window-cache kernel) and
``permuted_poisson_1024`` with the limit forced down in-process (the TPU's
K3 branch).  For each plan geometry (x rows staged per stage, groups of 128
threads per block, most slices per stage) it builds the plan, checks the
kernel against K1 on the same body, and prints the device time per call
(CUDA graph replay) beside K1's, the plan's staged bytes against x and the
bytes the kernel moves.  It is how the defaults of ``ops/ehyb_wincache.py``
were chosen.

Imports only the port and ``chip_smoke.py``'s helpers.  Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

import chip_smoke as cs
import ehyb_spmv_torch as port
from ehyb_spmv_torch.core.coo import deterministic_x
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import ehyb_stream, ehyb_wincache
from ehyb_spmv_torch.ops.stream_cells import build_stream_cells

#: (slot rows, groups, most slices per stage): the default, and smaller and
#: larger stages.
GEOMETRIES = [(160, 8, 128), (160, 8, 64), (128, 4, 64), (96, 4, 48),
              (192, 8, 192), (256, 8, 256)]
#: permuted_poisson_1024 has 8,192 slices: the default cuts them into 64
#: stages, fewer than the 132 SMs; smaller stages make more blocks.
GEOMETRIES_1024 = [(160, 8, 128), (160, 8, 32), (160, 8, 16), (96, 4, 16)]


def sweep(name: str, model, geometries) -> None:
    e = model.dev
    c = build_stream_cells(model.ehyb).to_torch(e.slice_offset.device)
    x = model.prepare_x(deterministic_x(model.m.dimension))
    y1 = ehyb_stream.stream_body(c, x)
    k1 = cs.device_ms_per_call(lambda: ehyb_stream.stream_body(c, x), 20)
    print(f"{name}: TPU branch {model.module.branch}; K1 {k1:.4f} ms",
          flush=True)
    for rows, groups, run in geometries:
        t0 = time.perf_counter()
        p = ehyb_wincache.build_wincache_plan(
            model.ehyb, slot_rows=rows, groups=groups, max_run_slices=run)
        plan_s = time.perf_counter() - t0
        pd = p.to_torch(e.slice_offset.device)
        y = ehyb_wincache.wincache_body(e, pd, x)
        torch.cuda.synchronize()
        err = cs.rel(y, y1)
        cs.check(err <= cs.KERNEL_TOL,
                 f"{rows} rows, {groups} groups, run {run}: vs K1 rel "
                 f"{err:.3e}, max abs {float((y - y1).abs().max()):.3e}")
        ms = cs.device_ms_per_call(
            lambda: ehyb_wincache.wincache_body(e, pd, x), 20)
        st = p.stats
        print(f"  rows {rows} groups {groups} run {run}: {ms:.4f} ms (K1 "
              f"{k1:.4f}); {st['n_blocks']} "
              f"blocks, {st['n_stages']} stages, {st['chunked_slices']} "
              f"chunked slices; staged {st['staged_bytes'] / st['x_bytes']:.3f}"
              f" x the padded x; {st['layout_bytes']} B moved "
              f"({st['compact_cells']} cells of {st['padded_cells']}); plan "
              f"{plan_s:.1f} s", flush=True)
        del pd


def main() -> int:
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    ehyb_stream.build_kernel()
    ehyb_wincache.build_kernel()
    with cs.patched(X_RESIDENT_BYTES=1024):
        m = generate.load_corpus("permuted_poisson_1024")
        model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    sweep("permuted_poisson_1024", model, GEOMETRIES_1024)
    del model
    t0 = time.perf_counter()
    m = generate.load_corpus("permuted_poisson_4096")
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    cs.check(model.module.wincache is not None,
             f"TPU branch {model.module.branch}: the window cache runs")
    print(f"permuted_poisson_4096 setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    sweep("permuted_poisson_4096", model, GEOMETRIES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
