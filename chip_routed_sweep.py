"""Geometry sweep of the one-pass routed kernel on one CUDA GPU.

    python3 chip_routed_sweep.py

Builds ``random_1m``'s routed schedule (1,048,576 rows, 16,769,356 nnz; the
gather-wall row that the flagship's gate hands to the routed engine),
decodes it once, and tiles its entries for each plan geometry: dst rows per
group, parts the x chunks are cut into, 1024-column windows per staged
chunk, threads per block.  For each it checks the kernel against the plain
version of the default plan, and prints the blocks, the x staged from L2
against x, the MB the kernel moves through device memory and the device
time per call (CUDA graph replay), beside cuSPARSE over the same entries.
It also prints the shared-memory atomics in the compiled kernel
(``cuobjdump -sass``; none are expected: a pass holds a row at most once, so
the sums need no ``atomicAdd``, which this card runs on shared f32 as a
compare-and-swap loop, ``ATOMS.CAST.SPIN``).  It is how the defaults of
``ops/route_xcache.py`` were chosen.

Imports only the port and ``chip_smoke.py``'s helpers.  Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import time

import torch

import chip_smoke as cs
import ehyb_spmv_torch as port
from ehyb_spmv_torch.core.coo import deterministic_x
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import route_xcache as rx
from ehyb_spmv_torch.ops.build import find_nvcc

#: (group rows, parts, windows per chunk); each runs at every THREADS.
GEOMETRIES = [(g, p, 8) for g in (8192, 16384, 32768, 49152)
              for p in (1, 2, 4, 8)] + [(16384, 4, 4), (32768, 4, 4),
                                         (32768, 4, 2)]
THREADS = (256, 512, 1024)


def sass_atomics(path: str) -> dict:
    """Opcodes of the shared-memory atomics in a built library."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300).stdout
    return dict(collections.Counter(re.findall(r"\bATOMS\.[A-Z0-9.]+", out)))


def main() -> int:
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    built = rx.build_kernel()
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    print(f"shared-memory atomics in the SASS: {sass_atomics(built.path)}")
    t0 = time.perf_counter()
    m = generate.load_corpus("random_1m")
    model = port.RoutedSpmv(port.EhybConfig(), device=dev).setup(m)
    rm, p0 = model.blocks[0], model.applies[0].plan
    print(f"random_1m setup {time.perf_counter() - t0:.1f} s "
          f"({model.setup_seconds})", flush=True)
    x = model.prepare_x(deterministic_x(m.dimension))
    want = rx.route_xcache_plain(p0, x)
    row, col = rx.plan_rows_cols(p0)
    a = cs.csr_of(row, col, p0.ent_val, p0.n_rows, p0.n_x)
    del row, col
    lib_ms = cs.device_ms_per_call(lambda: torch.mv(a, x), 20)
    del a
    t0 = time.perf_counter()
    entries = rx.decode_routed(rm)
    print(f"cuSPARSE over the same entries {lib_ms:.4f} ms; decode "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for group_rows, parts, chunk in GEOMETRIES:
        t0 = time.perf_counter()
        plan = rx.tile_entries(entries, rm.n_dst_rows, rm.padded_x_rows,
                               group_rows, parts, chunk)
        tile_s = time.perf_counter() - t0
        pd = plan.to_torch(dev)
        st = plan.stats
        for threads in THREADS:
            y = rx._launch(pd, x, threads)
            torch.cuda.synchronize()
            err = cs.rel(y, want)
            cs.check(err <= cs.KERNEL_TOL,
                     f"{group_rows} rows, {st['parts']} parts, "
                     f"{st['chunk_windows']} windows, {threads} threads: "
                     f"vs plain rel {err:.3e}")
            ms = cs.device_ms_per_call(
                lambda: rx._launch(pd, x, threads), 20)
            print(f"  rows {group_rows} parts {st['parts']} windows "
                  f"{st['chunk_windows']} threads {threads}: {ms:.4f} ms "
                  f"(cuSPARSE {lib_ms:.4f}); {st['n_tiles']} blocks, largest "
                  f"tile {st['max_tile_entries']} entries (mean "
                  f"{st['mean_tile_entries']:.0f}); staged "
                  f"{st['staged_bytes'] / st['x_bytes']:.3f} x x; "
                  f"{st['layout_bytes'] / 1e6:.1f} MB moved; tiling "
                  f"{tile_s:.1f} s", flush=True)
        del pd
    return 0


if __name__ == "__main__":
    sys.exit(main())
