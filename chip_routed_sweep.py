"""Geometry sweep of the one-pass routed kernel on one CUDA GPU.

    python3 chip_routed_sweep.py [MATRIX ...]
    python3 chip_routed_sweep.py --remainder [MATRIX]

For each corpus matrix (default: ``random_1m``, 1,048,576 rows, 16,769,356
nnz, the gather-wall row that the flagship's gate hands to the routed
engine, and ``random_4m``, 4,194,304 rows, 33,550,394 nnz, whose schedule
the host builds in four 1M-column blocks and the model runs in one plan)
it sets up the routed model, decodes its schedules once, and tiles their
entries for each plan geometry: dst rows per group, parts the x chunks are
cut into, 1024-column windows per chunk, and whether the plan stages its
chunks in shared memory or reads x[col] through L2 (``direct``); each at
the listed threads per block.  For each it checks the kernel against the
plain version of the model's own plan, and prints
the blocks, the L2 bytes staged per entry, the MB the kernel moves through
device memory and the device time per call (CUDA graph replay), beside
cuSPARSE over the same entries.  It also prints the shared-memory atomics
in the compiled kernel (``cuobjdump -sass``; none are expected: a pass
holds a row at most once, so the sums need no ``atomicAdd``, which this
card runs on shared f32 as a compare-and-swap loop, ``ATOMS.CAST.SPIN``).
It is how the defaults and the geometry rule of ``ops/route_xcache.py``
were chosen.  The last line is one JSON object: the fastest reading of each
matrix.

``--remainder`` (default ``powerlaw_1m``) sets up ``DegreeSplitSpmv`` on
the matrix and times the routed kernel on the rows it gives the routed
engine (the remainder after its dense rows), as the model plans it:
``chip_smoke.time_routed`` (against its plain version in turns, beside
cuSPARSE over the same entries and both bounds), with the kernel's
launches in one product of the model.

Imports only the port and ``chip_smoke.py``'s helpers.  Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import collections
import json
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


def staged(group_rows, parts, threads, windows=8):
    """A staged plan: chunks of ``windows`` in shared memory."""
    return dict(group_rows=group_rows, parts=parts, chunk_windows=windows,
                direct=False), threads


def direct(group_rows, windows, threads):
    """A direct plan: one part, nothing staged, chunks of ``windows``."""
    return dict(group_rows=group_rows, parts=1, chunk_windows=windows,
                direct=True), threads


#: Per matrix: (plan geometry, threads per block).
GEOMETRIES = {
    "random_1m": [
        staged(32768, 4, (1024,)),
        direct(4096, 128, (256, 512)),
        direct(8192, 64, (512, 1024)),
        direct(2048, 256, (256,)),
    ],
    "random_4m": [
        staged(32768, 4, (1024,)),
        staged(32768, 1, (512, 1024)),
        direct(32768, 8, (512,)),
        direct(16384, 32, (512,)),
        direct(8192, 64, (256, 512)),
        direct(4096, 128, (128, 256, 512)),
        direct(4096, 64, (256,)),
        direct(2048, 256, (128, 256)),
    ],
}


def sass_atomics(path: str) -> dict:
    """Opcodes of the shared-memory atomics in a built library."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300).stdout
    return dict(collections.Counter(re.findall(r"\bATOMS\.[A-Z0-9.]+", out)))


def sweep(name: str, dev) -> dict:
    """Every geometry of ``GEOMETRIES[name]`` on the matrix; the fastest
    reading."""
    t0 = time.perf_counter()
    m = generate.load_corpus(name)
    model = port.RoutedSpmv(port.EhybConfig(), device=dev).setup(m)
    p0 = model.routed_apply.plan
    print(f"{name} setup {time.perf_counter() - t0:.1f} s "
          f"({model.setup_seconds}); the model's plan: "
          f"{'direct' if p0.direct else 'staged'}, {p0.group_rows} rows, "
          f"{p0.parts} parts, {p0.chunk_cols} columns a chunk, "
          f"{p0.threads} threads", flush=True)
    x = model.prepare_x(deterministic_x(m.dimension))
    want = rx.route_xcache_plain(p0, x)
    row, col = rx.plan_rows_cols(p0)
    a = cs.csr_of(row, col, p0.ent_val, p0.n_rows, p0.n_x)
    del row, col
    lib_ms = cs.device_ms_per_call(lambda: torch.mv(a, x), 20)
    del a
    t0 = time.perf_counter()
    entries = rx.decode_blocks(model.blocks, model._lo)
    print(f"{name}: cuSPARSE over the same entries {lib_ms:.4f} ms; decode "
          f"{time.perf_counter() - t0:.1f} s; {cs.card_state()}", flush=True)
    best = None
    for g, threads_list in GEOMETRIES[name]:
        t0 = time.perf_counter()
        plan = rx.tile_entries(entries, p0.n_rows, p0.n_x, **g)
        tile_s = time.perf_counter() - t0
        pd = plan.to_torch(dev)
        st = plan.stats
        for threads in threads_list:
            tag = (f"  {'direct' if st['direct'] else 'staged'}: rows "
                   f"{st['group_rows']} parts {st['parts']} windows "
                   f"{st['chunk_windows']} threads {threads}:")
            y = rx._launch(pd, x, threads)
            torch.cuda.synchronize()
            err = cs.rel(y, want)
            cs.check(err <= cs.KERNEL_TOL, f"{tag} vs plain rel {err:.3e}")
            ms = cs.device_ms_per_call(lambda: rx._launch(pd, x, threads),
                                       20)
            print(f"{tag} {ms:.4f} ms (cuSPARSE {lib_ms:.4f}); "
                  f"{st['n_tiles']} blocks; {st['n_segs']} segments, "
                  f"{st['mean_segment_entries']:.0f} entries each, "
                  f"{st['passes']} passes; largest tile "
                  f"{st['max_tile_entries']} entries; from L2 "
                  f"{st['staged_bytes'] / st['entries']:.2f} B an entry "
                  f"staged; {st['layout_bytes'] / 1e6:.1f} MB moved; tiling "
                  f"{tile_s:.1f} s", flush=True)
            if best is None or ms < best["ms"]:
                best = dict(g, threads=threads, ms=ms, library_ms=lib_ms)
        del pd, plan
    print(f"{name}: fastest {best}; {cs.card_state()}", flush=True)
    return best


def remainder(name: str, dev) -> dict:
    """``route_xcache`` on the degree split's routed remainder of ``name``
    (see the module docstring); its kernels entry."""
    t0 = time.perf_counter()
    m = generate.load_corpus(name)
    model = port.DegreeSplitSpmv(port.EhybConfig(), device=dev).setup(m)
    r = model.r
    print(f"{name}: degree split setup {time.perf_counter() - t0:.1f} s "
          f"({model.setup_seconds}); the remainder {r.m.nnz} entries of "
          f"{m.nnz}", flush=True)
    x = model.prepare_x(deterministic_x(m.dimension))
    cs.reset_launches()
    model.apply(x)
    torch.cuda.synchronize()
    launches = rx.route_xcache.launches
    res = dict(matrix=f"{name} remainder", dim=m.dimension, nnz=r.m.nnz,
               setup_seconds=r.setup_seconds)
    out = cs.time_routed(r, res, r.m, dev, pair=False)
    out = dict(name=f"route_xcache@{name} remainder", launches=launches,
               **out)
    print(f"{name}: route_xcache launched {launches} time(s) a product; "
          f"{cs.card_state()}", flush=True)
    return out


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
    if sys.argv[1:2] == ["--remainder"]:
        names = sys.argv[2:] or ["powerlaw_1m"]
        print(json.dumps({name: remainder(name, dev) for name in names}))
        return 0
    names = sys.argv[1:] or list(GEOMETRIES)
    print(json.dumps({name: sweep(name, dev) for name in names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
