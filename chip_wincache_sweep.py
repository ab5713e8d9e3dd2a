"""Geometry sweep of the window-cache body on one CUDA GPU.

    python3 chip_wincache_sweep.py [--f64]

Builds ``permuted_poisson_4096`` through the flagship (x past the TPU's
residency limit, so its body runs the window-cache kernel) and
``permuted_poisson_1024`` with the limit forced down in-process (the TPU's
K3 branch).  For each plan geometry (x rows staged per stage, groups of 128
threads per block, most slices per stage) it builds the plan, checks the
kernel against K1 on the same body, and prints the device time per call
(CUDA graph replay) beside K1's, the plan's staged bytes against x and the
bytes the kernel moves.  It is how the defaults of ``ops/ehyb_wincache.py``
were chosen.  With ``--f64`` it builds ``permuted_poisson_4096`` in a
float64 config only and sweeps the float64 plan's geometries, plain and
Kahan (``SLOT_ROWS_F64``, ``GROUPS_F64``).

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
#: The float64 plan: a staged row takes 1 KB, so two blocks an SM hold at
#: most ~112 rows each; the double kernel takes blocks of up to 512
#: threads (64 registers at two blocks an SM).
GEOMETRIES_F64 = [(80, 4, 128), (96, 4, 128), (112, 4, 128), (160, 4, 128)]


def sweep(name: str, model, geometries, kahans=(False,)) -> None:
    e = model.dev
    c = build_stream_cells(model.ehyb).to_torch(e.slice_offset.device)
    x = model.prepare_x(deterministic_x(model.m.dimension))
    tol = cs.F64_KERNEL_TOL if x.dtype == torch.float64 else cs.KERNEL_TOL
    y1, k1 = {}, {}
    for kahan in kahans:
        y1[kahan] = ehyb_stream.stream_body(c, x, kahan)
        k1[kahan] = cs.device_ms_per_call(
            lambda: ehyb_stream.stream_body(c, x, kahan), 20)
    print(f"{name} ({x.dtype}): TPU branch {model.module.branch}; K1 "
          + ", ".join(f"{'Kahan' if k else 'plain'} {v:.4f} ms"
                      for k, v in k1.items()), flush=True)
    for rows, groups, run in geometries:
        t0 = time.perf_counter()
        p = ehyb_wincache.build_wincache_plan(
            model.ehyb, slot_rows=rows, groups=groups, max_run_slices=run)
        plan_s = time.perf_counter() - t0
        pd = p.to_torch(e.slice_offset.device)
        for kahan in kahans:
            y = ehyb_wincache.wincache_body(e, pd, x, kahan)
            torch.cuda.synchronize()
            err = cs.rel(y, y1[kahan])
            what = f"rows {rows} groups {groups} run {run}" + (
                " Kahan" if kahan else "")
            cs.check(err <= tol,
                     f"{what}: vs K1 rel {err:.3e}, max abs "
                     f"{float((y - y1[kahan]).abs().max()):.3e}")
            ms = cs.device_ms_per_call(
                lambda: ehyb_wincache.wincache_body(e, pd, x, kahan), 20)
            st = p.stats
            print(f"  {what}: {ms:.4f} ms (K1 {k1[kahan]:.4f}; "
                  f"{ehyb_wincache.resident_blocks(pd, kahan, x.device)} "
                  f"blocks an SM, {ehyb_wincache.registers(pd, kahan)} "
                  f"registers); {st['n_blocks']} blocks, {st['n_stages']} "
                  f"stages, {st['chunked_slices']} chunked slices; staged "
                  f"{st['staged_bytes'] / st['x_bytes']:.3f} x the padded x;"
                  f" {st['layout_bytes']} B moved ({st['compact_cells']} "
                  f"cells of {st['padded_cells']}); plan {plan_s:.1f} s",
                  flush=True)
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
    if "--f64" in sys.argv[1:]:
        t0 = time.perf_counter()
        m = generate.load_corpus("permuted_poisson_4096")
        model = port.EhybSpmv(port.EhybConfig(dtype="float64"),
                              device=dev).setup(m)
        cs.check(model.module.wincache is not None,
                 f"TPU branch {model.module.branch}: the window cache runs "
                 "in f64")
        print(f"permuted_poisson_4096 in f64: setup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        sweep("permuted_poisson_4096", model, GEOMETRIES_F64, (False, True))
        return 0
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
