"""Geometry sweep of the DIA kernel (K9) on one CUDA GPU, and its A/B.

    python3 chip_dia_sweep.py            # the geometry sweep
    python3 chip_dia_sweep.py --small    # the spread form at six shapes
    python3 chip_dia_sweep.py --ab TAG   # K9 as shipped, and its rows

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

``--small`` sweeps the spread form (``ops/dia.py::SpreadGeometry``: tile
rows, diagonals a chunk) at the six shapes its choice rule
(``ops/dia.py::choose_geometry``) was set from, each geometry timed in
turns with the default (default, spread, spread, default; device time a
call under graph replay) after a bit-for-bit check against the plain
version run on the CPU: the three DIA rows of the corpus too small to
fill the card with the default grid (``stencil27_24``, ``poisson2d_512``,
``fem3d_32``, set up through the flagship as the CLI does), the
flagship's diagonal at ``permuted_poisson_512`` in the accumulate mode,
the sharded apply's diagonal at ``permuted_poisson_1024`` D=1 (x base
1,024, accumulate mode) and ``fem3d_68_audikw_class``'s 99 diagonals (the
last three random values of their shapes).  Each shape ends with the
fastest spread geometries and the rule's spread form beside the default.
Then the same at the two rows where the rule takes the spread form
(``stencil27_24``, ``fem3d_32``) in float64, in the accumulate mode in
float32, and in float64 in the accumulate mode at an x base of 3; and,
for the rule's fewest diagonals, the rule's spread form alone against the
default at four shapes between those in diagonals and rows.

``--ab TAG`` compares two checkouts on one card: it times ``dia_body`` as
the checkout ships it at fem3d_68, pp4096's diagonal and the three small
rows (three CUDA-graph readings each), checks each against the plain
version, drives ``fem3d_68_audikw_class``, ``permuted_poisson_512`` and
the three small rows through the CLI (the small rows with
``phase_breakdown``'s device time a phase), and prints one JSON line per
measurement, tagged ``TAG``, with the card's state.
It uses only ``dia_body``, ``dia_body_plain``, ``cli.run``,
``phase_breakdown`` and ``chip_smoke.py``'s ``device_ms_per_call``, so it
runs in an older checkout too: copy this file to the root of the other
checkout and run it from the root of each, in turns (A, B, B, A), in one
call.

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
from ehyb_spmv_torch.utils.profiling import phase_breakdown

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


#: The corpus rows whose DIA part leaves the card short of one wave at the
#: default geometry (K9 their only kernel).
SMALL_ROWS = ("stencil27_24", "poisson2d_512", "fem3d_32")
SPREAD_CHUNKS = (16, 32, 64, 128)


def spread_geometries(n_diag: int):
    """The spread form at every built tile size and chunk, a chunk counted
    once where it holds every diagonal."""
    seen = set()
    for r, c in itertools.product(dia.SPREAD_ROWS, SPREAD_CHUNKS):
        if (r, min(c, n_diag)) not in seen:
            seen.add((r, min(c, n_diag)))
            yield dia.SpreadGeometry(rows=r, chunk=c)


def small_row(name: str, dev):
    """A corpus row's DIA part and x, set up through the flagship."""
    t0 = time.perf_counter()
    m = generate.load_corpus(name)
    model = port.EhybSpmv(port.EhybConfig(), device=dev).setup(m)
    print(f"{name} setup {time.perf_counter() - t0:.1f} s", flush=True)
    return model.dev, model.prepare_x(deterministic_x(m.dimension))


def random_part(offsets: tuple, dim_r: int, n_x: int, dev, seed: int):
    """Random values and x of a DIA part's shape."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    e = types.SimpleNamespace(dia_offsets=offsets, dia_val=torch.randn(
        len(offsets), dim_r, generator=gen, device=dev))
    return e, torch.randn(n_x, generator=gen, device=dev)


def fem_offsets(n: int) -> tuple:
    """fem3d(n)'s 99 diagonals: 9 runs of 11 (the 27-point node stencil,
    3 DOFs a node)."""
    return tuple(sorted({3 * (dx * n * n + dy * n) + e for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for e in range(-5, 6)}))


def small_shapes(dev):
    """(name, DIA part, x, y to add into or None, x base, calls a graph)
    of the six shapes the choice rule was set from."""
    for name in SMALL_ROWS:
        e, x = small_row(name, dev)
        yield name, e, x, None, 0, 100
    n = 512 * 512
    e, x = random_part((0,), n, n + 1024, dev, 5)
    yield ("permuted_poisson_512's diagonal, accumulate mode", e, x,
           torch.randn(n + 1024, device=dev), 0, 100)
    n, w = 1024 * 1024, 1024
    e, x = random_part((0,), n, n + 2 * w, dev, 7)
    yield ("permuted_poisson_1024 D=1's diagonal, x base 1024, accumulate "
           "mode", e, x, torch.randn(n, device=dev), w, 100)
    n = 3 * 68 ** 3
    e, x = random_part(fem_offsets(68), n, n, dev, 9)
    yield "fem3d_68_audikw_class's diagonals", e, x, None, 0, 20


def mode_shapes(dev):
    """(name, DIA part, x, y to add into or None, x base, calls a graph)
    of the rows where the rule takes the spread form, in the modes the
    six shapes leave out: float64, the accumulate mode, an x base."""
    for name in ("stencil27_24", "fem3d_32"):
        e, x = small_row(name, dev)
        e64 = types.SimpleNamespace(dia_offsets=e.dia_offsets,
                                    dia_val=e.dia_val.double())
        x64 = x.double()
        gen = torch.Generator(device=dev).manual_seed(3)
        y0 = torch.randn(x.shape[0], generator=gen, device=dev)
        yield f"{name}, float64", e64, x64, None, 0, 100
        yield f"{name}, accumulate mode", e, x, y0, 0, 100
        yield (f"{name}, float64, accumulate mode, x base 3", e64, x64,
               y0.double(), 3, 100)


def threshold_shapes(dev):
    """Shapes between the six in diagonals and rows, for the rule's
    ``SPREAD_MIN_DIAGONALS`` (random values of their shapes): 5 diagonals
    at 65,536 rows (poisson2d(256)), 7 at 32,768 (stencil3d(32, 7)), 9 and
    13 at 262,144 (9- and 13-point stencils on 512 x 512)."""
    shapes = (("poisson2d(256)", (-256, -1, 0, 1, 256), 65536),
              ("stencil3d(32, 7)", (-1024, -32, -1, 0, 1, 32, 1024), 32768),
              ("9 diagonals at 512 x 512", tuple(
                  dy * 512 + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1)),
               262144),
              ("13 diagonals at 512 x 512", (-1024, -513, -512, -511, -2,
                                              -1, 0, 1, 2, 511, 512, 513,
                                              1024), 262144))
    for seed, (name, offs, n) in enumerate(shapes):
        e, x = random_part(offs, n, n, dev, 11 + seed)
        yield name, e, x, None, 0, 100


def sweep_small_shape(name, e, x, out0, base, n, every: bool = True) -> dict:
    """The spread form at every geometry at one shape (or only at
    ``spread_geometry``'s where not ``every``), in turns with the default;
    returns geometry → (spread ms, default ms)."""
    k, dim_r = e.dia_val.shape
    vb, acc, vec = e.dia_val.element_size(), out0 is not None, dim_r % 4 == 0
    e_cpu = types.SimpleNamespace(dia_offsets=e.dia_offsets,
                                  dia_val=e.dia_val.cpu())
    want = dia.dia_body_plain(e_cpu, x.cpu(), None if out0 is None
                              else out0.cpu().clone(), base)
    buf = None if out0 is None else out0.clone()

    def call(g, fresh: bool = False):
        # the timed calls add into buf again and again: a copy a call
        # would be timed with them
        if fresh and buf is not None:
            buf.copy_(out0)
        return dia._launch(e, x, g, buf, base)

    g0 = dia.GEOMETRY
    p0, _ = dia.device_plan(e.dia_offsets, dim_r, vec, x.device, g0, vb, acc,
                            base)
    print(f"== {name}: {k} diagonals, {dim_r} rows, x {x.shape[0]}; the "
          f"default's grid {p0.grid} ({p0.grid / 132:.2f}/SM)", flush=True)
    cs.check(torch.equal(call(g0, True).cpu(), want),
             f"{name}: the default geometry bit for bit with the plain "
             "version on the CPU")
    ms_of = {}

    def time_spread(g):
        plan, _ = dia.device_plan(e.dia_offsets, dim_r, vec, x.device, g, vb,
                                  acc, base)
        same = torch.equal(call(g, True).cpu(), want)
        cs.check(same, f"{name} {g}: bit for bit with the plain version")
        d_a, s_a, s_b, d_b = cs.in_turns(lambda: call(g), lambda: call(g0),
                                         n, n)[2]
        ms_of[g] = ((s_a + s_b) / 2, (d_a + d_b) / 2)
        print(f"  rows {g.rows} chunk {plan.chunk}: grid {plan.grid} "
              f"({plan.grid / 132:.2f}/SM), {plan.smem_bytes} B shared; "
              f"(default, spread, spread, default) {d_a:.5f} {s_a:.5f} "
              f"{s_b:.5f} {d_b:.5f} ms; spread / default "
              f"{(s_a + s_b) / (d_a + d_b):.3f}", flush=True)

    # the rule's pick as a call without a geometry takes it, and the
    # spread form it would take
    pick = dia.device_plan(e.dia_offsets, dim_r, vec, x.device, None, vb,
                           acc, base)[0].geometry
    candidate = pick if pick != g0 else dia.spread_geometry(
        dim_r, 132, dia._per_sm(g0, e.dia_offsets, dim_r, vec, x.device, vb,
                                acc, base))
    for g in spread_geometries(k) if every else []:
        time_spread(g)
    best = sorted(ms_of, key=lambda g: ms_of[g][0])
    for g in best[:3]:
        print(f"  fastest: {g} {ms_of[g][0]:.5f} ms (default "
              f"{ms_of[g][1]:.5f})")
    # the sweep's geometry that runs as the candidate (the same chunk), or
    # the candidate timed on its own
    candidate = next((g for g in ms_of if (g.rows, min(g.chunk, k)) == (
        candidate.rows, min(candidate.chunk, k))), candidate)
    if candidate not in ms_of:
        time_spread(candidate)
        best = sorted(ms_of, key=lambda g: ms_of[g][0])
    got = ms_of[candidate]
    print(f"  the rule's spread form {candidate}: {got[0]:.5f} ms against "
          f"the default's {got[1]:.5f} (ratio {got[0] / got[1]:.3f}), rank "
          f"{best.index(candidate) + 1} of {len(best)}; the rule picks "
          f"{'the default' if pick == g0 else 'it'}", flush=True)
    return ms_of


def run_small(dev) -> int:
    built = dia.build_kernel()
    print(f"built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "spread" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    g = dia.SpreadGeometry()
    print(f"spread, {g.threads} threads: {dia.registers(g, True)} registers "
          f"a thread (f32), {dia.registers(g, True, 8, True)} (f64, "
          "accumulate)")
    for shape in itertools.chain(small_shapes(dev), mode_shapes(dev)):
        sweep_small_shape(*shape)
        print(f"card: {CARD} = {smi(CARD)}", flush=True)
    for shape in threshold_shapes(dev):
        sweep_small_shape(*shape, every=False)
    print(f"card: {CARD} = {smi(CARD)}", flush=True)
    return 0


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

    shapes = [("K9 at fem3d_68", fem3d_68, 50),
              ("K9 at pp4096's diagonal", pp4096_diagonal, 20)]
    shapes += [(f"K9 at {name}", lambda d, name=name: small_row(name, d),
                100) for name in SMALL_ROWS]
    for name, shape, n in shapes:
        e, x = shape(dev)
        err = cs.rel(dia.dia_body(e, x), dia.dia_body_plain(e, x))
        cs.check(err <= cs.KERNEL_TOL, f"{name}: vs plain rel {err:.3e}")
        out(kernel=name, rel_vs_plain=err, ms=[
            cs.device_ms_per_call(lambda: dia.dia_body(e, x), n)
            for _ in range(3)])
        del e, x
    rows = [["-g", "fem3d_68_audikw_class", "-i", "200"],
            ["-g", "permuted_poisson_512", "-i", "500"]]
    rows += [["-g", name, "-i", "300"] for name in SMALL_ROWS]
    for args in rows:
        code, res, model = cli.run(cli.build_parser().parse_args(
            args + ["--device", "cuda"]))
        if code != 0:
            return code
        row = dict(matrix=res["matrix"], gflops=res["gflops"],
                   us_per_iter=1e6 * res["seconds"] / res["iters"],
                   rel_error=res["rel_error"])
        if res["matrix"] in SMALL_ROWS:
            # device us a call of each phase, and of the whole apply
            x = model.prepare_x(deterministic_x(res["dim"]))
            row["phase_us"] = {k: 1e6 * v for k, v in phase_breakdown(
                model, x, iters=200).items()}
        out(**row)
        del model
    return 0


def main() -> int:
    ab = sys.argv[1:3] if sys.argv[1:2] == ["--ab"] else None
    small = sys.argv[1:] == ["--small"]
    if len(sys.argv) != (3 if ab else 2 if small else 1):
        print("usage: chip_dia_sweep.py [--small | --ab TAG]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"), flush=True)
    if ab:
        return run_ab(ab[1], dev)
    return run_small(dev) if small else run_sweep(dev)


if __name__ == "__main__":
    sys.exit(main())
