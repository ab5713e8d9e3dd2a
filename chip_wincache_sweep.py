"""Geometry sweep of the window-cache body on one CUDA GPU.

    python3 chip_wincache_sweep.py

Builds ``permuted_poisson_4096`` through the flagship (x past the TPU's
residency limit, so its body runs the window-cache kernel), then for each
plan geometry (x rows staged per block, groups of 128 threads per block,
most slices per stage) builds the plan, checks the kernel against K1 on the
same body, and prints the device time per call (CUDA graph replay) beside
K1's and the plan's staged bytes against x and against the body's col/val
bytes.  It is how the defaults of ``ops/ehyb_wincache.py`` were chosen.

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

#: (slot rows, groups, most slices per stage): the first design (64 rows,
#: one group), around the defaults, and past them.
GEOMETRIES = [(64, 1, 64), (128, 2, 256), (112, 4, 64), (256, 4, 256),
              (96, 8, 128), (128, 8, 128), (160, 8, 128), (192, 8, 256)]


def main() -> int:
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    ehyb_stream.build_kernel()
    ehyb_wincache.build_kernel()
    m = generate.load_corpus("permuted_poisson_4096")
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    cs.check(model.module.wincache is not None,
             f"TPU branch {model.module.branch}: the window cache runs")
    e = model.dev
    x = model.prepare_x(deterministic_x(m.dimension))
    y1 = ehyb_stream.stream_body(e, x)
    k1 = cs.device_ms_per_call(lambda: ehyb_stream.stream_body(e, x), 20)
    print(f"setup {time.perf_counter() - t0:.1f} s; K1 {k1:.4f} ms",
          flush=True)
    for rows, groups, run in GEOMETRIES:
        p = ehyb_wincache.build_wincache_plan(
            model.ehyb, slot_rows=rows, groups=groups, max_run_slices=run)
        pd = p.to_torch(dev)
        y = ehyb_wincache.wincache_body(e, pd, x)
        torch.cuda.synchronize()
        err = cs.rel(y, y1)
        cs.check(err <= cs.KERNEL_TOL, f"{rows} rows, {groups} groups: vs "
                                       f"K1 rel {err:.3e}")
        ms = cs.device_ms_per_call(
            lambda: ehyb_wincache.wincache_body(e, pd, x), 20)
        st = p.stats
        print(f"  rows {rows} groups {groups} run {run}: {ms:.4f} ms "
              f"(K1 {k1:.4f}); {st['n_blocks']} blocks, {st['n_stages']} "
              f"stages, {st['chunked_slices']} chunked slices; staged "
              f"{st['staged_bytes'] / st['x_bytes']:.3f} x the padded x, "
              f"{st['staged_bytes'] / st['body_bytes']:.3f} x the body",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
