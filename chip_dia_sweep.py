"""Geometry sweep of the DIA kernel (K9) on one CUDA GPU, and its A/B.

    python3 chip_dia_sweep.py            # the geometry sweep
    python3 chip_dia_sweep.py --ab TAG   # K9 as shipped, and its two rows

Times K9 at the two DIA shapes of the main paths: ``fem3d_68_audikw_class``
(943,296 rows, all DIA: 99 diagonals in 9 runs of 11, set up through the
flagship as the CLI does) and ``permuted_poisson_4096``'s one diagonal
(16,777,216 rows, offset 0; random values of that shape, since the kernel's
work does not depend on them, and without the ~3.5 min of that matrix's host
setup).  For every geometry (threads, quads per thread, so tile rows;
diagonals per step; blocks per SM; x mode: through L1/L2 or staged per run)
it checks the kernel against the plain version and prints one line: the
device time per call (CUDA graph replay), the grid and shared memory it got,
and the MB it moves through device memory (values, x, y) beside the MB of x
it stages from L2.  Each shape ends with its fastest geometries and the
default's rank.  It is how ``ops/dia.py::GEOMETRY`` was chosen: the fastest
at fem3d_68 that does not lose at pp4096.

``--ab TAG`` compares two checkouts on one card: it times ``dia_body`` as
the checkout ships it at both shapes (three CUDA-graph readings each),
checks the first against the plain version, drives
``fem3d_68_audikw_class`` and ``permuted_poisson_512`` through the CLI, and
prints one JSON line per measurement, tagged ``TAG``, with the card's state.
It uses only ``dia_body``, ``dia_body_plain``, ``cli.run`` and
``chip_smoke.py``'s ``device_ms_per_call``, so it runs in an older checkout
too: copy this file to the root of the other checkout and run it from the
root of each, in turns (A, B, B, A), in one call.

Imports only the port and ``chip_smoke.py``'s helpers.  Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
import types

import torch

import chip_smoke as cs
import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.core.coo import deterministic_x
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import dia

THREADS = (128, 256, 512)
BLOCKS_PER_SM = (1, 2, 4, 8)
#: What the card runs at, beside every reading.  ``chip_smoke.py`` has its
#: own reader; the A/B runs against older ones too.
CARD = ("clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active,"
        "power.limit")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def geometries():
    for t, (s, q), b, mode in itertools.product(
            THREADS, dia.BUILT_STEPS, BLOCKS_PER_SM, dia.X_MODES):
        yield dia.DiaGeometry(threads=t, quads=q, step=s, blocks_per_sm=b,
                              x_mode=mode)


def sweep(name: str, e, x: torch.Tensor, n: int) -> dict:
    """One line per geometry; returns geometry → ms."""
    k, dim_r = e.dia_val.shape
    y_p = dia.dia_body_plain(e, x)
    ms_of = {}
    print(f"== {name}: {k} diagonals in {len(dia.offset_runs(e.dia_offsets))}"
          f" runs, {dim_r} rows, x {x.shape[0]}", flush=True)
    for g in geometries():
        try:
            plan, _ = dia.device_plan(e.dia_offsets, dim_r, True, x.device, g)
        except (ValueError, RuntimeError) as exc:
            print(f"  {g}: not run ({exc})")
            continue
        y = dia._launch(e, x, g)
        torch.cuda.synchronize()
        err = cs.rel(y, y_p)
        cs.check(err <= cs.KERNEL_TOL, f"{name} {g}: vs plain rel {err:.3e}")
        ms = cs.device_ms_per_call(lambda: dia._launch(e, x, g), n)
        st = plan.stats
        ms_of[g] = ms
        print(f"  threads {g.threads} quads {g.quads} (tile {g.tile_rows} "
              f"rows) step {g.step} blocks/SM {g.blocks_per_sm} x "
              f"{g.x_mode}: {ms:.4f} ms; grid {st['grid']} "
              f"({st['grid'] / 132:.2f}/SM), {st['smem_bytes']} B shared; "
              f"{st['layout_bytes'] / 1e6:.1f} MB moved, "
              f"{st['staged_bytes'] / 1e6:.1f} MB staged from L2; "
              f"{st['layout_bytes'] / ms / 1e9:.3f} TB/s", flush=True)
    best = sorted(ms_of, key=ms_of.get)
    for v in dia.X_MODES:
        g = min((g for g in best if g.x_mode == v), key=ms_of.get)
        print(f"  fastest with x_mode {v}: {g} {ms_of[g]:.4f} ms")
    rank = best.index(dia.GEOMETRY) + 1 if dia.GEOMETRY in ms_of else None
    print(f"  default {dia.GEOMETRY}: "
          f"{ms_of.get(dia.GEOMETRY, float('nan')):.4f} ms, rank {rank} of "
          f"{len(best)}", flush=True)
    return ms_of


def fem3d_68(dev):
    """fem3d_68's DIA part and x, set up through the flagship as the CLI
    does."""
    t0 = time.perf_counter()
    m = generate.load_corpus("fem3d_68_audikw_class")
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    print(f"fem3d_68 setup {time.perf_counter() - t0:.1f} s", flush=True)
    return model.dev, model.prepare_x(deterministic_x(m.dimension))


def pp4096_diagonal(dev):
    """permuted_poisson_4096's one diagonal: random values of its shape."""
    dim = 4096 * 4096
    gen = torch.Generator(device=dev).manual_seed(13)
    e = types.SimpleNamespace(dia_offsets=(0,), dia_val=torch.randn(
        1, dim, generator=gen, device=dev))
    return e, torch.randn(dim, generator=gen, device=dev)


def run_sweep(dev) -> int:
    built = dia.build_kernel()
    print(f"built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    for (s, q), mode in itertools.product(dia.BUILT_STEPS, dia.X_MODES):
        g = dia.DiaGeometry(step=s, quads=q, x_mode=mode)
        print(f"step {s} quads {q} x {mode}: {dia.registers(g, True)} "
              "registers a thread")
    fem = sweep("fem3d_68_audikw_class", *fem3d_68(dev), 50)
    print(f"card: {CARD} = {smi(CARD)}")
    pp = sweep("permuted_poisson_4096's diagonal (its shape)",
               *pp4096_diagonal(dev), 20)
    print(f"card: {CARD} = {smi(CARD)}")
    # the fastest at fem3d_68 that does not lose at pp4096 (within 3% of
    # the fastest there)
    ok = [g for g in fem if g in pp and pp[g] <= 1.03 * min(pp.values())]
    pick = min(ok, key=fem.get)
    print(f"choice: {pick}: fem3d_68 {fem[pick]:.4f} ms, pp4096 "
          f"{pp[pick]:.4f} ms")
    return 0


def run_ab(tag: str, dev) -> int:
    def out(**row):
        print(json.dumps({"tree": tag, **row, "card": smi(CARD)}),
              flush=True)

    for name, shape, n in (("K9 at fem3d_68", fem3d_68, 50),
                           ("K9 at pp4096's diagonal", pp4096_diagonal, 20)):
        e, x = shape(dev)
        err = cs.rel(dia.dia_body(e, x), dia.dia_body_plain(e, x))
        cs.check(err <= cs.KERNEL_TOL, f"{name}: vs plain rel {err:.3e}")
        out(kernel=name, rel_vs_plain=err, ms=[
            cs.device_ms_per_call(lambda: dia.dia_body(e, x), n)
            for _ in range(3)])
        del e, x
    for args in (["-g", "fem3d_68_audikw_class", "-i", "200"],
                 ["-g", "permuted_poisson_512", "-i", "500"]):
        code, res, _ = cli.run(cli.build_parser().parse_args(
            args + ["--device", "cuda"]))
        if code != 0:
            return code
        out(matrix=res["matrix"], gflops=res["gflops"],
            us_per_iter=1e6 * res["seconds"] / res["iters"],
            rel_error=res["rel_error"])
    return 0


def main() -> int:
    ab = sys.argv[1:3] if sys.argv[1:2] == ["--ab"] else None
    if len(sys.argv) != (3 if ab else 1):
        print("usage: chip_dia_sweep.py [--ab TAG]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"), flush=True)
    return run_ab(ab[1], dev) if ab else run_sweep(dev)


if __name__ == "__main__":
    sys.exit(main())
