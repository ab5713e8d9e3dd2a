"""Geometry sweep of the streamed SELL body kernel (K1) on one CUDA GPU, and
its A/B.

    python3 chip_k1_sweep.py            # the geometry sweep
    python3 chip_k1_sweep.py --ab TAG [SHAPE ...]  # K1 as shipped, its rows

Sets up ``permuted_poisson_512`` (262,144 rows) and
``permuted_poisson_1024`` (1,048,576 rows) through the flagship, as the CLI
does: both take the TPU's ``streamed v3`` branch, so K1 over its compact
plan.  For every geometry (threads per block; rows per thread, so row
blocks a warp takes at once; blocks per SM; x mode: through L1/L2 or
staged in shared memory per piece) it checks the kernel against the plain
version and prints one line: the device time per call (CUDA graph
replay), the grid, registers and shared memory it got, and the rate over
the bytes the plan moves (cells, pieces, tables, x and y).  Each shape
ends with its fastest geometries and the default's rank; the choice is
the fastest at permuted_poisson_1024 that is within 3% of the fastest at
permuted_poisson_512: ``ops/ehyb_stream.py::GEOMETRY``.

``--ab TAG`` compares two checkouts on one card: for both shapes (or the
``SHAPE`` names given after ``TAG``) it times the body kernel as the
checkout ships it (three CUDA-graph readings) and the whole apply, checks
the kernel against its plain version, drives ``permuted_poisson_512``
through the CLI, and prints one JSON line per measurement, tagged ``TAG``,
with the card's state.  It takes K1's plan
where the checkout's flagship has one (``model.module.cells``) and the
padded body where it does not, so it runs in an older checkout too: copy
this file to the root of the other checkout and run it from the root of
each, in turns (A, B, B, A), in one call.

Imports only the port and ``chip_smoke.py``'s helpers.  Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs
import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.core.coo import deterministic_x
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import ehyb_stream

SHAPES = ("permuted_poisson_512", "permuted_poisson_1024")
THREADS = (128, 256, 512)
BLOCKS_PER_SM = (1, 2, 4, 8, 16)
#: What the card runs at, beside every reading.  ``chip_smoke.py`` has its
#: own reader; the A/B runs against older ones too.
CARD = ("clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active,"
        "power.limit")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def geometries():
    for t, r, b, mode in itertools.product(
            THREADS, ehyb_stream.BUILT_ROWS, BLOCKS_PER_SM,
            ehyb_stream.X_MODES):
        yield ehyb_stream.StreamGeometry(threads=t, rows=r, blocks_per_sm=b,
                                         x_mode=mode)


def flagship(name: str, dev):
    """The flagship on one corpus matrix, set up as the CLI does, and its
    padded x."""
    t0 = time.perf_counter()
    m = generate.load_corpus(name)
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    print(f"{name}: setup {time.perf_counter() - t0:.1f} s, TPU branch "
          f"{model.module.branch}", flush=True)
    return model, model.prepare_x(deterministic_x(m.dimension))


def sweep(name: str, dev, n: int = 100) -> dict:
    """One line per geometry; returns geometry → ms."""
    model, x = flagship(name, dev)
    p, kahan = model.module.cells, model.module.kahan
    cs.check(p is not None, f"{name}: K1 runs over its plan")
    st = p.stats
    print(f"== {name}: {st['n_rb']} row blocks, {st['n_pieces']} pieces, "
          f"max width {st['max_width']}, max table {st['max_table_rows']} "
          f"rows; {st['layout_bytes']} B moved", flush=True)
    y_p = ehyb_stream.stream_body_plain(p, x, kahan)
    ms_of = {}
    for g in geometries():
        try:
            grid = ehyb_stream.grid_of(p, g, kahan, dev)
        except RuntimeError as exc:
            print(f"  {g}: not run ({exc})")
            continue
        y = ehyb_stream._launch(p, x, kahan, g)
        torch.cuda.synchronize()
        err = cs.rel(y, y_p)
        cs.check(err <= cs.KERNEL_TOL, f"{name} {g}: vs plain rel {err:.3e}")
        ms = cs.device_ms_per_call(
            lambda: ehyb_stream._launch(p, x, kahan, g), n)
        ms_of[g] = ms
        print(f"  threads {g.threads} rows {g.rows} blocks/SM "
              f"{g.blocks_per_sm} x {g.x_mode}: {ms * 1e3:.3f} us; grid "
              f"{grid} ({grid / 132:.2f}/SM), "
              f"{ehyb_stream.registers(g, kahan)} registers, "
              f"{ehyb_stream.smem_bytes(g)} B shared; "
              f"{st['layout_bytes'] / ms / 1e9:.3f} TB/s", flush=True)
    best = sorted(ms_of, key=ms_of.get)
    for v in ehyb_stream.X_MODES:
        mine = [g for g in best if g.x_mode == v]
        for g in mine[:3]:
            print(f"  fastest with x_mode {v}: {g} {ms_of[g] * 1e3:.3f} us")
    g0 = ehyb_stream.GEOMETRY
    rank = best.index(g0) + 1 if g0 in ms_of else None
    print(f"  default {g0}: {ms_of.get(g0, float('nan')) * 1e3:.3f} us, rank "
          f"{rank} of {len(best)}; card: {CARD} = {smi(CARD)}", flush=True)
    return ms_of


def run_sweep(dev) -> int:
    built = ehyb_stream.build_kernel()
    print(f"built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    small, big = (sweep(name, dev) for name in SHAPES)
    ok = [g for g in big if g in small
          and small[g] <= 1.03 * min(small.values())]
    pick = min(ok, key=big.get)
    print(f"choice: {pick}: {SHAPES[0]} {small[pick] * 1e3:.3f} us, "
          f"{SHAPES[1]} {big[pick] * 1e3:.3f} us")
    return 0


def run_ab(tag: str, dev, shapes=SHAPES) -> int:
    def out(**row):
        print(json.dumps({"tree": tag, **row, "card": smi(CARD)}),
              flush=True)

    for name in shapes:
        model, x = flagship(name, dev)
        kahan = model.module.kahan
        body = getattr(model.module, "cells", None)
        body = model.dev if body is None else body
        err = cs.rel(ehyb_stream.stream_body(body, x, kahan),
                     ehyb_stream.stream_body_plain(body, x, kahan))
        cs.check(err <= cs.KERNEL_TOL, f"K1 at {name}: vs plain rel "
                                       f"{err:.3e}")
        out(kernel=f"K1 at {name}", rel_vs_plain=err, ms=[
            cs.device_ms_per_call(
                lambda: ehyb_stream.stream_body(body, x, kahan), 100)
            for _ in range(3)],
            apply_ms=cs.device_ms_per_call(lambda: model.apply(x), 50))
        del model, x, body
    code, res, _ = cli.run(cli.build_parser().parse_args(
        ["-g", SHAPES[0], "-i", "500", "--device", "cuda"]))
    if code != 0:
        return code
    out(matrix=res["matrix"], gflops=res["gflops"],
        us_per_iter=1e6 * res["seconds"] / res["iters"],
        rel_error=res["rel_error"], roofline_frac=res.get("roofline_frac"))
    return 0


def main() -> int:
    args = sys.argv[1:]
    ab = args[:2] if args[:1] == ["--ab"] else None
    shapes = tuple(args[2:]) or SHAPES
    if (ab is None and args) or (ab is not None and (
            len(ab) != 2 or not set(shapes) <= set(SHAPES))):
        print(f"usage: chip_k1_sweep.py [--ab TAG [SHAPE ...]], SHAPE one "
              f"of {', '.join(SHAPES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"), flush=True)
    return run_ab(ab[1], dev, shapes) if ab else run_sweep(dev)

if __name__ == "__main__":
    sys.exit(main())
