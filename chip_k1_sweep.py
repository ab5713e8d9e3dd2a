"""Geometry sweep of the streamed SELL body kernel (K1) on one CUDA GPU, and
its A/B.

    python3 chip_k1_sweep.py            # the geometry sweep
    python3 chip_k1_sweep.py --ab TAG [SHAPE ...]  # K1 as shipped, its rows
    python3 chip_k1_sweep.py --f64      # K1 f64: plan forms x geometries
    python3 chip_k1_sweep.py --ab TAG --f64 [CASE ...]  # K1 f64 as shipped
    python3 chip_k1_sweep.py --long     # the split form at heavy tails
    python3 chip_k1_sweep.py --long --f64  # ... in float64 and compensated
    python3 chip_k1_sweep.py --small    # the split form's small form
    python3 chip_k1_sweep.py --layout   # powerlaw_1m's plan, hubs apart

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

``--ab TAG`` compares two checkouts on one card: for the ``AB_SHAPES`` (or
the ``SHAPE`` names given after ``TAG``) it times the body kernel as the
checkout ships it (three CUDA-graph readings) and the whole apply, checks
the kernel against its plain version, drives ``permuted_poisson_512``
(and each heavy-tailed shape named) through the CLI, and prints one JSON
line per measurement, tagged ``TAG``, with the card's state.  The
heavy-tailed shapes are K1's bodies on their main paths: powerlaw_1m's
dense sub-matrix (the rows ``DegreeSplitSpmv`` gives the flagship) and
powerlaw_16k's whole body (the small gate keeps it), set up through
``EhybSpmv`` with the gate off and the artifact cached
(``EHYB_TORCH_CACHE_DIR``), and random_16k's body set up the same way
(the split form must leave it as it is); their lines add both bounds,
cuSPARSE over the body's entries and the plan's shape.  It takes K1's plan
where the checkout's flagship has one (``model.module.cells``) and the
padded body where it does not, so it runs in an older checkout too: copy
this file to the root of the other checkout and run it from the root of
each, in turns (A, B, B, A), in one call.

``--long`` sweeps the split form (``ops/stream_cells.py``, ``split_steps``)
at the two heavy-tailed shapes: it first reads the widest row block of
the ``FLOOR_SHAPES``' flagship bodies (the split form must leave those
plans as they are), then, for every ``SPLIT_SWEEP`` value, builds the
plan (its build seconds, chunks and work items) and times the split
variant (built with x through L1/L2) at every threads and blocks per SM,
each held bit for bit to the plain version run on the CPU, beside the
table form (the plan without the split form, which K1 walks one row
block a warp), both bounds and cuSPARSE.  The choice,
``stream_cells.SPLIT_STEPS`` and ``ehyb_stream.SPLIT_GEOMETRY``, is the
one with ``split_steps`` no less than that widest row block whose times
over the fastest such at the two shapes sum the least (powerlaw_16k's time is its longest chunk's walk, so it favours
short chunks; powerlaw_1m's is the cells' stream, which favours fewer
partials).

``--long --f64`` sweeps the split form of the float64 variants: it
first reads the widest row block of the ``FLOOR_F64`` bodies' float64
plans (the float64 bodies on the card's paths; the split form must leave
their plans as they are) and times K1 f64 on fem3d_68 --dword's, then, at
each ``LONG_F64`` shape (powerlaw_16k in the precision mode and in
float64 plain and compensated; powerlaw_1m in the precision mode and in
float64), times the plan without the split form once and, for every
``split_steps`` of ``SPLIT_SWEEP_F64`` (``SPLIT_SWEEP_F64_BIG`` at
powerlaw_1m --dtype float64, whose plan builds take the longest), builds
the plan (its build seconds, chunks and work items) and times the split
variant at every threads and blocks per SM, held bit for bit to the plain
version run on the CPU, beside both bounds and cuSPARSE in float64.  The
choice, ``stream_cells.SPLIT_STEPS_F64`` at a geometry (the float64
variants share ``ehyb_stream.SPLIT_GEOMETRY``), is the one, no less than
that widest row block, whose times over the fastest such at every shape
sum the least.  Last, the float32 compensated variant, which reads the float32
plan (``SPLIT_STEPS``) at ``SPLIT_GEOMETRY``: at both ``LONG_SHAPES`` it
times that plan with and without compensation at every threads and
blocks per SM (``KAHAN_F32``), held to the plain version run on the CPU
(within 1e-6 with Kahan, bit for bit without); it chooses nothing.

``--f64`` sweeps the float64 kernel on ``permuted_poisson_512`` in the
precision mode (``--dword``), whose unordered body is scattered: the plan
in each form (the table form, direct columns in body order, direct
columns with rows grouped in parts of 32 to 2,048 rows; see
``ops/stream_cells.py``) at every block size and blocks per SM, each held
bit for bit to the plain version run on the CPU, then what the shipped
plan's scattered accesses cost (the kernel over copies without the row
map, with x read at each cell's own row, and both: timing only), then
every geometry on the float64 config's compensated flagship plan (pp512
``--dtype float64 --compensated``, the table form) with Kahan.  It prints
each time beside the same-work and layout bounds and names the fastest.  ``--ab TAG --f64``
times K1 f64 as the checkout ships it on the ``F64_CASES`` (or those
named): pp512 and fem3d_68 in the precision mode, pp512's compensated
float64 flagship and the sharded engine's boundary list at one rank on
permuted_poisson_1024 in float64 (``powerlaw_1m_dword``, powerlaw_1m in
the precision mode, only where named: its plan takes minutes to build),
then drives pp512 ``--dword`` through the CLI; it too runs in an older
checkout.

``--small`` sweeps the split form's small form (``ops/stream_cells.py``:
hub rows apart, short hub items, a fixed fold; ``small_steps``,
``hub_steps``) at powerlaw_16k in ``SMALL_CONFIGS`` (float32 plain and
compensated, float64 plain and compensated, the precision mode): it first
runs ``chip_smoke.check_k1_small`` (every variant bit for bit against its
plain version on small bodies), then, per config, times the parent (the
split form, ``k1_options(e, lists=True)``) and the small form at every
``SMALL_SWEEP`` hub threshold x ``HUB_SWEEP`` chunk (a hub chunk's
steps) x ``SMALL_THREADS`` at the most resident blocks, each held to the
plain version on the CPU (bit for bit; float32 Kahan within 1e-6), beside
both bounds and cuSPARSE in the config's type.  The choice,
``stream_cells.SMALL_STEPS``, ``stream_cells.HUB_STEPS`` and
``ehyb_stream.SMALL_GEOMETRY``, is the one whose times over the fastest
at each config sum the least.  Last it reads the rule's floor shapes
(``FLOOR_SHAPES``' flagship bodies, in float32 and float64: they must
keep their plans, neither split nor small) and prints the rule's inputs.

``--layout`` reads, on the host, what laying hub rows apart would make of
powerlaw_1m's plans in ``LAYOUT_CASES`` (the precision mode and
``--dtype float64``; the rule keeps their split form, whose items are
tens of thousands): the shipped plan's cells, items and longest item
beside the small form's layout built with the same options
(``stream_cells._build`` with ``SMALL_STEPS`` and ``HUB_STEPS``), and the
entries.  It times nothing.

Imports only the port and ``chip_smoke.py``'s helpers.  Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import copy
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli
from ehyb_spmv_torch.core.coo import MatrixCOO, deterministic_x
from ehyb_spmv_torch.io import generate
from ehyb_spmv_torch.ops import ehyb_stream
from ehyb_spmv_torch.ops.stream_cells import build_stream_cells

SHAPES = ("permuted_poisson_512", "permuted_poisson_1024")
#: The heavy-tailed shapes: K1 on powerlaw_1m's dense sub-matrix and on
#: powerlaw_16k's body.
LONG_SHAPES = ("powerlaw_1m", "powerlaw_16k")
#: A flagship body the split form must leave as it is (its widest row
#: block, 46 steps, is the float threshold's floor), timed by ``--ab``.
FLOOR_BODY = "random_16k"
AB_SHAPES = SHAPES + LONG_SHAPES + (FLOOR_BODY,)
#: ``--long``'s split_steps values.
SPLIT_SWEEP = (48, 64, 96, 128)
#: The flagship rows whose float bodies K1 reads in the table form: the
#: split form must leave them as they are, so ``--long`` takes no
#: split_steps below their widest row block.
FLOOR_SHAPES = ("permuted_poisson_512", "random_16k")
#: ``--long --f64``'s split_steps values, and those of them timed at
#: powerlaw_1m --dtype float64.
SPLIT_SWEEP_F64 = (80, 96, 128)
SPLIT_SWEEP_F64_BIG = (80, 96)
#: The float64 bodies K1 reads on the card's paths: ``--long --f64`` takes
#: no split_steps below their widest row block.
FLOOR_F64 = {"permuted_poisson_512 --dword": ("permuted_poisson_512",
                                              dict(dword_values=True)),
             "permuted_poisson_512 --dtype float64": (
                 "permuted_poisson_512", dict(dtype="float64")),
             "random_16k --dtype float64": ("random_16k",
                                            dict(dtype="float64")),
             "fem3d_68_audikw_class --dword": ("fem3d_68_audikw_class",
                                               dict(dword_values=True))}
#: ``--long --f64``'s heavy-tailed shapes: name → (matrix, config).
LONG_F64 = {"powerlaw_16k --dword": ("powerlaw_16k",
                                     dict(dword_values=True)),
            "powerlaw_16k --dtype float64": ("powerlaw_16k",
                                             dict(dtype="float64")),
            "powerlaw_16k --dtype float64 --compensated": (
                "powerlaw_16k", dict(dtype="float64",
                                     compensated_sum=True)),
            "powerlaw_1m --dword": ("powerlaw_1m", dict(dword_values=True)),
            "powerlaw_1m --dtype float64": ("powerlaw_1m",
                                            dict(dtype="float64"))}
THREADS = (128, 256, 512)
BLOCKS_PER_SM = (1, 2, 4, 8, 16)
#: ``--small``'s configs of powerlaw_16k (the CLI's flags → config).
SMALL_CONFIGS = {"float32": {},
                 "--compensated": dict(compensated_sum=True),
                 "--dtype float64": dict(dtype="float64"),
                 "--dtype float64 --compensated": dict(
                     dtype="float64", compensated_sum=True),
                 "--dword": dict(dword_values=True)}
#: ``--small``'s hub thresholds (a row of more cells is a hub; the row
#: blocks hold at most as many steps), hub chunks (steps of 32 entries)
#: and threads a block.
SMALL_SWEEP = (16, 32, 40)
HUB_SWEEP = (8, 16, 32)
SMALL_THREADS = (128, 256, 512)
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


def heavy_body(name: str, dev):
    """K1's body at a heavy-tailed shape as its main path sets it up (see
    the module docstring), and its padded x."""
    from ehyb_spmv_torch.models.hybrid import degree_split_stats

    t0 = time.perf_counter()
    m = generate.load_corpus(name)
    if name == "powerlaw_1m":
        dense, _ = degree_split_stats(m)
        keep = dense[m.row]
        m = MatrixCOO(m.n_rows, m.n_cols, m.row[keep], m.col[keep],
                      m.val[keep])
    model = port.EhybSpmv(port.EhybConfig(routed_delegate="never",
                                          artifact_cache=True),
                          device=dev).setup(m)
    print(f"{name}: {m.nnz} body entries, setup "
          f"{time.perf_counter() - t0:.1f} s ({model.setup_seconds})",
          flush=True)
    return model, model.prepare_x(deterministic_x(m.dimension))


def calls_for(fn, budget_ms: float = 30.0) -> int:
    """Calls a CUDA-graph reading of ``fn`` takes: about ``budget_ms`` of
    device time, 3 to 100."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return max(3, min(100, int(budget_ms / max(start.elapsed_time(end),
                                               1e-3))))


def body_yardsticks(model, x: torch.Tensor, p, dev) -> dict:
    """Both bounds of K1 over plan ``p`` of the model's body (ms) and
    cuSPARSE over the body's entries (device ms a call)."""
    nnz = model.dev.body_nnz
    same = cs.same_work_bound(nnz, 2, x.numel(), p.n_rb * 32, dev)
    layout = cs.bound(p.stats["layout_bytes"], 2 * nnz, dev)
    return dict(bound_ms=same["bound_ms"], layout_bound_ms=layout["bound_ms"],
                cusparse_ms=cs.body_library_ms(model, x, dev))


def run_ab(tag: str, dev, shapes=AB_SHAPES) -> int:
    def out(**row):
        print(json.dumps({"tree": tag, **row, "card": smi(CARD)}),
              flush=True)

    for name in shapes:
        heavy = name in LONG_SHAPES or name == FLOOR_BODY
        model, x = heavy_body(name, dev) if heavy else flagship(name, dev)
        kahan = model.module.kahan
        body = getattr(model.module, "cells", None)
        body = model.dev if body is None else body
        y = ehyb_stream.stream_body(body, x, kahan)
        if heavy:
            # hub rows of ~1e5 entries: the plain version on the card adds
            # with atomics in no fixed order; the CPU's adds in K1's
            same = torch.equal(y.cpu(), ehyb_stream.stream_body_plain(
                copy.deepcopy(body).cpu(), x.cpu(), kahan))
            cs.check(same, f"K1 at {name}: bit for bit with the plain "
                           "version on the CPU")
            err = 0.0
        else:
            err = cs.rel(y, ehyb_stream.stream_body_plain(body, x, kahan))
            cs.check(err <= cs.KERNEL_TOL, f"K1 at {name}: vs plain rel "
                                           f"{err:.3e}")
        kernel = lambda: ehyb_stream.stream_body(body, x, kahan)  # noqa
        n = calls_for(kernel)
        extra = {}
        if heavy:
            st = body.stats
            extra = dict(body_yardsticks(model, x, body, dev),
                         plan={k: st.get(k) for k in (
                             "n_rb", "n_pieces", "split_rbs", "max_width",
                             "chunked_rbs", "n_chunks", "n_items",
                             "split_steps", "compact_cells", "real_cells")})
        out(kernel=f"K1 at {name}", rel_vs_plain=err, calls=n, ms=[
            cs.device_ms_per_call(kernel, n) for _ in range(3)],
            apply_ms=cs.device_ms_per_call(lambda: model.apply(x),
                                           max(3, n // 2)), **extra)
        del model, x, body
    # powerlaw_1m loads its cached artifacts (its gate verdict is the
    # structural one); powerlaw_16k's small gate measures afresh
    for name in (SHAPES[0],) + tuple(s for s in shapes if s in LONG_SHAPES):
        code, res, _ = cli.run(cli.build_parser().parse_args(
            ["-g", name, "-i", "500" if name == SHAPES[0] else "300",
             "--device", "cuda"] + (["--cache"] if name == "powerlaw_1m"
                                    else [])))
        if code != 0:
            return code
        out(matrix=res["matrix"], engine=res.get("engine"),
            small_gate=res.get("small_gate"), gflops=res["gflops"],
            us_per_iter=1e6 * res["seconds"] / res["iters"],
            rel_error=res["rel_error"], roofline_frac=res.get("roofline_frac"))
    return 0


def long_geometries():
    for t, b in itertools.product(THREADS, (2, 4, 8, 16)):
        yield ehyb_stream.StreamGeometry(threads=t, blocks_per_sm=b)


def widest_row_block(name: str, dev) -> int:
    """The widest row block (the sum of its pieces' widths) of K1's table
    form over the flagship body of corpus matrix ``name``."""
    m = generate.load_corpus(name)
    model = port.EhybSpmv(port.EhybConfig(routed_delegate="never"),
                          device=dev).setup(m)
    widest = int(plan_widths(build_stream_cells(model.ehyb)).max())
    print(f"{name}: the flagship body's widest row block {widest} steps",
          flush=True)
    return widest


def sweep_long(name: str, dev) -> dict:
    """One heavy-tailed shape: the table form at the shipped geometry, then
    every (split_steps, geometry, combine); returns (split_steps, geometry)
    → ms."""
    from ehyb_spmv_torch.ops.stream_cells import SPLIT_STEPS

    model, x = heavy_body(name, dev)
    e = model.ehyb
    x_cpu = x.cpu()
    table = build_stream_cells(e).to_torch(dev)
    ys = body_yardsticks(model, x, table, dev)
    kernel = lambda: ehyb_stream.stream_body(table, x)  # noqa: E731
    t_ms = cs.device_ms_per_call(kernel, calls_for(kernel))
    st = table.stats
    print(f"== {name}: the table form ({st['n_rb']} row blocks, "
          f"{st['n_pieces']} pieces, max width {st['max_width']}): "
          f"{t_ms * 1e3:.2f} us at {ehyb_stream.GEOMETRY}; same-work bound "
          f"{ys['bound_ms'] * 1e3:.2f} us, cuSPARSE "
          f"{ys['cusparse_ms'] * 1e3:.2f} us", flush=True)
    del table
    ms_of = {}
    for steps in SPLIT_SWEEP:
        t0 = time.perf_counter()
        plan = build_stream_cells(e, split_steps=steps)
        secs = time.perf_counter() - t0
        want = ehyb_stream.stream_body_plain(plan.to_torch(), x_cpu)
        p = plan.to_torch(dev)
        st = plan.stats
        layout = cs.bound(st["layout_bytes"], 2 * model.dev.body_nnz, dev)
        shipped = " (shipped)" if steps == SPLIT_STEPS else ""
        print(f"== {name}, split_steps {steps}{shipped}: "
              f"built in {secs:.2f} s; {st['chunked_rbs']} row blocks in "
              f"{st['n_chunks']} chunks, {st['n_items']} work items, "
              f"{st['n_pieces']} pieces, {st['compact_cells']} cells; "
              f"layout bound {layout['bound_ms'] * 1e3:.2f} us", flush=True)
        for g in long_geometries():
            try:
                grid = ehyb_stream.grid_of(p, g, False, dev)
            except RuntimeError as exc:
                print(f"  {g}: not run ({exc})")
                continue
            y = ehyb_stream._launch(p, x, False, g)
            cs.check(torch.equal(y.cpu(), want),
                     f"{name} {steps} {g}: bit for bit with the CPU plain "
                     "version")
            fn = lambda: ehyb_stream._launch(p, x, False, g)  # noqa: E731
            ms = cs.device_ms_per_call(fn, calls_for(fn))
            ms_of[(steps, g)] = ms
            print(f"  threads {g.threads} blocks/SM {g.blocks_per_sm} x "
                  f"{g.x_mode}: {ms * 1e3:.2f} us (grid {grid}, "
                  f"{ehyb_stream.registers(g, split=True)} registers); "
                  f"{ys['bound_ms'] / ms:.3f} of the same-work bound, "
                  f"{t_ms / ms:.1f}x the table form", flush=True)
        del p
    for k in sorted(ms_of, key=ms_of.get)[:5]:
        print(f"  fastest at {name}: split_steps {k[0]} at {k[1]}: "
              f"{ms_of[k] * 1e3:.2f} us")
    print(f"  card: {CARD} = {smi(CARD)}", flush=True)
    del model, x
    return ms_of


def run_long(dev) -> int:
    built = ehyb_stream.build_kernel()
    print(f"built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    floor = max(widest_row_block(name, dev) for name in FLOOR_SHAPES)
    big, small = (sweep_long(name, dev) for name in LONG_SHAPES)
    ok = [k for k in big if k in small and k[0] >= floor]
    b0, s0 = min(big[k] for k in ok), min(small[k] for k in ok)
    pick = min(ok, key=lambda k: big[k] / b0 + small[k] / s0)
    print(f"choice (split_steps at least {floor}): split_steps {pick[0]} at "
          f"{pick[1]}: {LONG_SHAPES[0]} {big[pick] * 1e3:.2f} us, "
          f"{LONG_SHAPES[1]} {small[pick] * 1e3:.2f} us")
    return 0


def plan_widths(p) -> np.ndarray:
    """Each row block's width (the sum of its pieces') of K1's plan ``p``."""
    from ehyb_spmv_torch.ops.stream_cells import PIECE_CELL, PIECE_RB

    piece = p.piece.cpu().numpy() if torch.is_tensor(p.piece) else p.piece
    return np.bincount(piece[:-1, PIECE_RB], minlength=p.n_rb,
                       weights=np.diff(piece[:, PIECE_CELL]) // 32)


def long_f64_floor(dev) -> int:
    """The widest row block of the ``FLOOR_F64`` bodies' plans (each held
    out of the split form as shipped), and K1 f64 timed on fem3d_68's."""
    from ehyb_spmv_torch.ops.stream_cells import split

    floor = 0
    for name, (matrix, cfg) in FLOOR_F64.items():
        model, x = f64_model(matrix, dev, **cfg)
        p = model.module.cells
        widest = int(plan_widths(p).max())
        cs.check(not split(p), f"{name}: the shipped plan is not split "
                               f"(widest row block {widest} steps)")
        floor = max(floor, widest)
        if matrix.startswith("fem3d"):
            kernel = lambda: ehyb_stream.stream_body(p, x)  # noqa: E731
            ms = [cs.device_ms_per_call(kernel, 20) for _ in range(3)]
            print(f"  K1 f64 at {name} as shipped: {ms} ms", flush=True)
        del model, x, p
    return floor


def split_options(model) -> dict:
    """``build_stream_cells``'s options of ``k1_plan`` for the float64 body
    of ``model`` but the split form's (a grouping weighed only where the
    shipped plan kept one)."""
    from ehyb_spmv_torch.ops import stream_cells as sc

    grouped = model.module.cells.stats["grouped"]
    return dict(direct_below=sc.DIRECT_BELOW,
                group_rows=sc.GROUP_ROWS if grouped else 0)


def sweep_long_f64(name: str, dev) -> dict:
    """One ``LONG_F64`` shape: the plan without the split form once, then
    every split_steps x geometry; returns (split_steps, geometry) → ms."""
    matrix, cfg = LONG_F64[name]
    model, x = f64_model(matrix, dev, **cfg)
    e, kahan = model.ehyb, model.module.kahan
    x_cpu = x.cpu()
    opts = split_options(model)
    t0 = time.perf_counter()
    table = build_stream_cells(e, **opts).to_torch(dev)
    secs = time.perf_counter() - t0
    nnz = model.dev.body_nnz
    same = cs.same_work_bound(nnz, 2, x.numel(), table.n_rb * 32, dev,
                              8)["bound_ms"]
    lib = cs.body_library_ms(model, x, dev)
    kernel = lambda: ehyb_stream.stream_body(table, x, kahan)  # noqa: E731
    t_ms = cs.device_ms_per_call(kernel, calls_for(kernel))
    st = table.stats
    print(f"== {name}: the plan without the split form (built in "
          f"{secs:.1f} s; {st['n_rb']} row blocks, {st['n_pieces']} pieces, "
          f"{st['direct_pieces']} direct, max width {st['max_width']}, "
          f"widest row block {int(plan_widths(table).max())}): "
          f"{t_ms * 1e3:.2f} us at {ehyb_stream.GEOMETRY}; same-work bound "
          f"{same * 1e3:.2f} us, cuSPARSE ({x.dtype}) {lib * 1e3:.2f} us",
          flush=True)
    del table
    big = name == "powerlaw_1m --dtype float64"
    ms_of = {}
    for steps in SPLIT_SWEEP_F64_BIG if big else SPLIT_SWEEP_F64:
        t0 = time.perf_counter()
        plan = build_stream_cells(e, **opts, split_steps=steps)
        secs = time.perf_counter() - t0
        want = ehyb_stream.stream_body_plain(plan.to_torch(), x_cpu, kahan)
        p = plan.to_torch(dev)
        st = plan.stats
        layout = cs.bound(st["layout_bytes"], 2 * nnz, dev, True)
        print(f"== {name}, split_steps {steps}: built in {secs:.1f} s; "
              f"{st['chunked_rbs']} row blocks in {st['n_chunks']} chunks, "
              f"{st['n_items']} work items, {st['n_pieces']} pieces "
              f"({st['direct_pieces']} direct), widest item "
              f"{st['max_item_steps']} steps; layout bound "
              f"{layout['bound_ms'] * 1e3:.2f} us", flush=True)
        checked = False
        for g in long_geometries():
            try:
                grid = ehyb_stream.grid_of(p, g, kahan, dev)
            except RuntimeError as exc:
                print(f"  {g}: not run ({exc})")
                continue
            if not checked:
                y = ehyb_stream._launch(p, x, kahan, g).cpu()
                cs.check(torch.equal(y, want), f"{name} ({steps}) at {g}: "
                         "bit for bit with the CPU plain version")
                checked = True
            fn = lambda: ehyb_stream._launch(p, x, kahan, g)  # noqa: E731
            ms = cs.device_ms_per_call(fn, calls_for(fn))
            ms_of[(steps, g)] = ms
            print(f"  threads {g.threads} blocks/SM {g.blocks_per_sm}: "
                  f"{ms * 1e3:.2f} us (grid {grid}, "
                  f"{ehyb_stream.registers(g, kahan, True, split=True)} "
                  f"registers); {same / ms:.3f} of the same-work bound, "
                  f"{t_ms / ms:.1f}x the plan without the split form, "
                  f"{lib / ms:.2f}x cuSPARSE", flush=True)
        del p, want
    for k in sorted(ms_of, key=ms_of.get)[:5]:
        print(f"  fastest at {name}: split_steps {k[0]} at {k[1]}: "
              f"{ms_of[k] * 1e3:.2f} us")
    print(f"  card: {CARD} = {smi(CARD)}", flush=True)
    del model, x
    return ms_of


def sweep_kahan_f32(name: str, dev) -> None:
    """K1 over the float32 plan as shipped (``SPLIT_STEPS``) at a
    ``LONG_SHAPES`` body, compensated and plain, at every geometry."""
    from ehyb_spmv_torch.ops.stream_cells import SPLIT_STEPS

    model, x = heavy_body(name, dev)
    plan = build_stream_cells(model.ehyb, split_steps=SPLIT_STEPS)
    ys = body_yardsticks(model, x, plan, dev)
    p = plan.to_torch(dev)
    x_cpu = x.cpu()
    want = {k: ehyb_stream.stream_body_plain(plan.to_torch(), x_cpu, k)
            for k in (False, True)}
    print(f"== {name}, float32 split_steps {SPLIT_STEPS} (shipped), "
          f"compensated and plain at {ehyb_stream.SPLIT_GEOMETRY} shipped: "
          f"same-work bound {ys['bound_ms'] * 1e3:.2f} us, cuSPARSE "
          f"{ys['cusparse_ms'] * 1e3:.2f} us", flush=True)
    ms_of = {}
    for g in long_geometries():
        row = []
        for kahan in (True, False):
            try:
                grid = ehyb_stream.grid_of(p, g, kahan, dev)
            except RuntimeError as exc:
                row.append(f"{'Kahan' if kahan else 'plain'} not run ({exc})")
                continue
            y = ehyb_stream._launch(p, x, kahan, g).cpu()
            cs.check(cs.rel(y, want[kahan]) <= cs.KERNEL_TOL if kahan
                     else torch.equal(y, want[kahan]),
                     f"{name} f32{' Kahan' if kahan else ''} at {g}: against "
                     "the CPU plain version")
            fn = lambda: ehyb_stream._launch(p, x, kahan, g)  # noqa: E731
            ms = cs.device_ms_per_call(fn, calls_for(fn))
            ms_of[(kahan, g)] = ms
            row.append(f"{'Kahan' if kahan else 'plain'} {ms * 1e3:.2f} us "
                       f"(grid {grid}, "
                       f"{ehyb_stream.registers(g, kahan, split=True)} "
                       "registers)")
        print(f"  threads {g.threads} blocks/SM {g.blocks_per_sm}: "
              + "; ".join(row), flush=True)
    for kahan in (True, False):
        best = min((k for k in ms_of if k[0] == kahan), key=ms_of.get)
        print(f"  fastest {'Kahan' if kahan else 'plain'} at {name}: "
              f"{best[1]}: {ms_of[best] * 1e3:.2f} us; at "
              f"{ehyb_stream.SPLIT_GEOMETRY}: "
              f"{ms_of[(kahan, ehyb_stream.SPLIT_GEOMETRY)] * 1e3:.2f} us")
    print(f"  card: {CARD} = {smi(CARD)}", flush=True)
    del model, x, p


def run_long_f64(dev) -> int:
    built = ehyb_stream.build_kernel()
    print(f"built in {built.seconds:.1f} s")
    floor = long_f64_floor(dev)
    print(f"the float64 bodies' widest row block: {floor} steps", flush=True)
    runs = {name: sweep_long_f64(name, dev) for name in LONG_F64}
    ok = [k for k in runs["powerlaw_1m --dtype float64"] if k[0] >= floor
          and all(k in r for r in runs.values())]
    best = {name: min(r[k] for k in ok) for name, r in runs.items()}
    pick = min(ok, key=lambda k: sum(r[k] / best[n]
                                     for n, r in runs.items()))
    print(f"choice (split_steps at least {floor}): split_steps {pick[0]} at "
          f"{pick[1]}: "
          + ", ".join(f"{n} {r[pick] * 1e3:.2f} us" for n, r in runs.items()))
    for n, r in runs.items():
        for steps in sorted({k[0] for k in r}):
            t = min(v for k, v in r.items() if k[0] == steps)
            print(f"  {n}: split_steps {steps} best {t * 1e3:.2f} us")
    for name in LONG_SHAPES:
        sweep_kahan_f32(name, dev)
    return 0


def f64_model(name: str, dev, **cfg):
    """A flagship on one corpus matrix in the precision mode (or the
    config ``cfg`` gives), its artifact cached across runs, and its padded
    x."""
    t0 = time.perf_counter()
    m = generate.load_corpus(name)
    cfg = cfg or dict(dword_values=True)
    model = port.EhybSpmv(port.EhybConfig(artifact_cache=True, **cfg),
                          device=dev).setup(m)
    print(f"{name} {cfg}: setup {time.perf_counter() - t0:.1f} s, TPU "
          f"branch {model.module.branch}", flush=True)
    return model, model.prepare_x(deterministic_x(m.dimension))


def f64_bounds(p, nnz: int, x: torch.Tensor, dev) -> tuple:
    """The same-work and layout bounds (ms) of K1 f64 over plan ``p``."""
    same = cs.same_work_bound(nnz, 2, x.numel(), p.n_rb * 32, dev, 8)
    layout = cs.bound(p.stats["layout_bytes"], 2 * nnz, dev, True)
    return same["bound_ms"], layout["bound_ms"]


def f64_geometries():
    for t, b in itertools.product(THREADS, BLOCKS_PER_SM):
        yield ehyb_stream.StreamGeometry(threads=t, blocks_per_sm=b)


#: ``--f64``'s plan forms on pp512 in the precision mode: name →
#: ``build_stream_cells`` options.
F64_FORMS = {"table": {}, "direct": {"direct_below": 8.0}}
F64_FORMS.update({f"direct, grouped {g}": {"direct_below": 8.0,
                                           "group_rows": g}
                  for g in (32, 128, 512, 2048)})


def diagnose_f64(p, x: torch.Tensor, dev, n: int = 200) -> None:
    """What the scattered accesses of a grouped direct plan ``p`` cost:
    the kernel over copies of ``p`` without the row map (y in plan order),
    with every cell reading x at its own plan row (x coalesced), and both.
    Timing only: the altered plans' sums are wrong."""
    rb = torch.repeat_interleave(torch.arange(p.n_pieces, device=dev),
                                 torch.diff(p.piece.long()[:, 0]))
    at_row = (rb * 32 + (torch.arange(p.n_cells, device=dev)
                         - p.piece.long()[rb, 0]) % 32).int()

    def altered(row_map: bool, coalesced: bool):
        q = copy.deepcopy(p)
        if not row_map:
            q.row_map = q.row_map[:0]
        if coalesced:
            q.cell_col = at_row.clone()
        return q

    for row_map, coalesced in ((True, False), (False, False), (True, True),
                               (False, True)):
        q = altered(row_map, coalesced)
        ms = [cs.device_ms_per_call(
            lambda: ehyb_stream.stream_body(q, x), n) for _ in range(2)]
        print(f"  timing only: row map {'on' if row_map else 'off'}, x "
              f"{'at the plan row' if coalesced else 'as the plan reads it'}"
              f": {', '.join(f'{t * 1e3:.3f}' for t in ms)} us", flush=True)


def sweep_f64(dev, n: int = 100) -> int:
    model, x = f64_model(SHAPES[0], dev)
    e, nnz = model.ehyb, model.dev.body_nnz
    shipped = model.module.cells
    x_cpu = x.cpu()
    want = ehyb_stream.stream_body_plain(build_stream_cells(e).to_torch(),
                                         x_cpu)
    ms_of = {}
    for form, kw in F64_FORMS.items():
        t0 = time.perf_counter()
        plan = build_stream_cells(e, **kw)
        secs = time.perf_counter() - t0
        st = plan.stats
        p = plan.to_torch(dev)
        same, layout = f64_bounds(p, nnz, x, dev)
        print(f"== {form}: built in {secs:.2f} s; {st['direct_pieces']} of "
              f"{st['n_pieces']} pieces direct, rows "
              f"{'grouped' if st['grouped'] else 'in body order'} "
              f"(sectors a row block, body order and grouped: "
              f"{st['sectors_per_rb']}), {st['table_rows']} table rows, "
              f"{st['layout_bytes']} B moved; same-work bound "
              f"{same * 1e3:.3f} us, layout bound {layout * 1e3:.3f} us",
              flush=True)
        for g in f64_geometries():
            y = ehyb_stream._launch(p, x, False, g)
            cs.check(torch.equal(y.cpu(), want),
                     f"{form} {g}: bit for bit with the CPU plain version")
            ms = cs.device_ms_per_call(
                lambda: ehyb_stream._launch(p, x, False, g), n)
            ms_of[(form, g)] = ms
            print(f"  threads {g.threads} blocks/SM {g.blocks_per_sm}: "
                  f"{ms * 1e3:.3f} us (grid "
                  f"{ehyb_stream.grid_of(p, g, False, dev)}); "
                  f"{same / ms:.3f} of the same-work bound", flush=True)
        yk = ehyb_stream._launch(p, x, True)
        cs.check(torch.equal(yk.cpu(), ehyb_stream.stream_body_plain(
            plan.to_torch(), x_cpu, True)), f"{form} Kahan: bit for bit")
        del p
    best = sorted(ms_of, key=ms_of.get)
    for k in best[:5]:
        print(f"  fastest: {k[0]} at {k[1]}: {ms_of[k] * 1e3:.3f} us")
    g0 = ehyb_stream.GEOMETRY
    st = shipped.stats
    y = ehyb_stream.stream_body(shipped, x)
    cs.check(torch.equal(y.cpu(), want), "the shipped plan: bit for bit")
    print(f"  shipped (k1_plan, {st['direct_pieces']} direct pieces, "
          f"grouped {st['grouped']}) at {g0}: "
          f"{cs.device_ms_per_call(lambda: ehyb_stream.stream_body(shipped, x), n) * 1e3:.3f}"
          f" us; card: {CARD} = {smi(CARD)}", flush=True)
    if st["grouped"]:
        diagnose_f64(shipped, x, dev)
    del model, x, shipped
    model, x = f64_model(SHAPES[0], dev, dtype="float64",
                           compensated_sum=True)
    p = model.module.cells
    st = p.stats
    same, layout = f64_bounds(p, model.dev.body_nnz, x, dev)
    want = ehyb_stream.stream_body_plain(copy.deepcopy(p).cpu(), x.cpu(),
                                         True)
    print(f"== the compensated float64 flagship's plan ({st['n_pieces']} "
          f"pieces, {st['direct_pieces']} direct, {st['table_rows']} table "
          f"rows): same-work bound {same * 1e3:.3f} us, layout bound "
          f"{layout * 1e3:.3f} us", flush=True)
    for g in f64_geometries():
        y = ehyb_stream._launch(p, x, True, g)
        cs.check(torch.equal(y.cpu(), want), f"Kahan {g}: bit for bit")
        ms = cs.device_ms_per_call(
            lambda: ehyb_stream._launch(p, x, True, g), n)
        print(f"  Kahan threads {g.threads} blocks/SM {g.blocks_per_sm}: "
              f"{ms * 1e3:.3f} us", flush=True)
    print(f"card: {CARD} = {smi(CARD)}")
    return 0


#: ``--ab --f64``'s rows: name → (corpus matrix, config).
F64_CASES = {
    "pp512_dword": ("permuted_poisson_512", dict(dword_values=True)),
    "fem3d_68_dword": ("fem3d_68_audikw_class", dict(dword_values=True)),
    "pp512_f64_kahan": ("permuted_poisson_512",
                        dict(dtype="float64", compensated_sum=True)),
    "pp1024_f64_list": ("permuted_poisson_1024",
                        dict(dtype="float64", window_rows=1024)),
    "powerlaw_1m_dword": ("powerlaw_1m", dict(dword_values=True)),
}


def run_ab_f64(tag: str, dev, cases) -> int:
    from ehyb_spmv_torch.parallel.spmv import ShardedEhybSpmv, plan_sharded

    def out(**row):
        print(json.dumps({"tree": tag, **row, "card": smi(CARD)}),
              flush=True)

    for name in cases:
        matrix, cfg = F64_CASES[name]
        lst = y = None
        if name.endswith("_list"):
            m = generate.load_corpus(matrix)
            c = port.EhybConfig(**cfg)
            model = ShardedEhybSpmv(c, device=dev).setup(
                m, plan_sharded(m, c, 1))
            cells = model.module.cells
            p, x, kahan = cells.plan, model.module.ex.x_buf, False
            x.copy_(torch.randn(x.shape, dtype=x.dtype, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(
                                    0)))
            lst = cells.boundary
            y = torch.zeros(p.n_rb * 32, dtype=x.dtype, device=dev)
        else:
            model, x = f64_model(matrix, dev, **cfg)
            p, kahan = model.module.cells, model.module.kahan
        kernel = lambda: ehyb_stream.stream_body(  # noqa: E731
            p, x, kahan, rb_list=lst, out=y)
        got = kernel().clone()
        plain = ehyb_stream.stream_body_plain(p, x, kahan, rb_list=lst,
                                              out=None if y is None
                                              else torch.zeros_like(y))
        err = cs.rel(got, plain)
        cs.check(err <= cs.F64_TOL, f"K1 f64 at {name}: vs plain rel "
                                    f"{err:.3e}")
        st = p.stats
        out(kernel=f"K1 f64 at {name}", rel_vs_plain=err,
            direct_pieces=st.get("direct_pieces", 0),
            grouped=st.get("grouped", False), n_pieces=st["n_pieces"],
            ms=[cs.device_ms_per_call(kernel, 100) for _ in range(3)])
        del model, p, x, got, plain
    code, res, _ = cli.run(cli.build_parser().parse_args(
        ["-g", SHAPES[0], "-i", "500", "--device", "cuda", "--dword"]))
    if code != 0:
        return code
    out(matrix=res["matrix"], dword=True, gflops=res["gflops"],
        us_per_iter=1e6 * res["seconds"] / res["iters"],
        rel_error=res["rel_error"], roofline_frac=res.get("roofline_frac"))
    return 0


def small_geometries():
    for t in SMALL_THREADS:
        yield ehyb_stream.StreamGeometry(threads=t, blocks_per_sm=16)


def sweep_small(name: str, dev) -> dict:
    """One ``SMALL_CONFIGS`` config of powerlaw_16k: the parent split form
    once, then every hub threshold x hub chunk x geometry of the small
    form; returns (hub threshold, hub chunk, geometry) → ms."""
    from ehyb_spmv_torch.ops import stream_cells as sc

    m = generate.load_corpus("powerlaw_16k")
    t0 = time.perf_counter()
    model = port.EhybSpmv(port.EhybConfig(
        routed_delegate="never", artifact_cache=True, **SMALL_CONFIGS[name]),
        device=dev).setup(m)
    print(f"== powerlaw_16k {name}: setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    x = model.prepare_x(deterministic_x(m.dimension))
    e, kahan = model.ehyb, model.module.kahan
    f64 = x.dtype == torch.float64
    x_cpu = x.cpu()
    fold = model.module.cells.stats["folded"]
    nnz = model.module.cells.stats["real_cells"]
    lib = cs.body_library_ms(model, x, dev)
    same = cs.same_work_bound(nnz, 2, x.numel(), e.slice_offset.shape[0]
                              * 128 - 128, dev, 8 if f64 else 4)["bound_ms"]
    parent = build_stream_cells(e, fold=fold, **sc.k1_options(e, lists=True))
    pp = parent.to_torch(dev)
    fn = lambda: ehyb_stream.stream_body(pp, x, kahan)  # noqa: E731
    p_ms = [cs.device_ms_per_call(fn, calls_for(fn)) for _ in range(2)]
    st = parent.stats
    print(f"  parent split form: {st['compact_cells']} cells, "
          f"{st['chunked_rbs']} row blocks in {st['n_chunks']} chunks, "
          f"{st['n_items']} items of at most {st['max_item_steps']} steps, "
          f"widest fold {int(np.diff(parent.chunk_first).max())}: "
          f"{[round(t * 1e3, 2) for t in p_ms]} us at "
          f"{ehyb_stream.SPLIT_GEOMETRY}; same-work bound {same * 1e3:.3f} "
          f"us, cuSPARSE ({x.dtype}) {lib * 1e3:.2f} us", flush=True)
    ms_of = {}
    for ss, hs in itertools.product(SMALL_SWEEP, HUB_SWEEP):
        t0 = time.perf_counter()
        plan = build_stream_cells(e, fold=fold, **dict(
            sc.k1_options(e), small_steps=ss, hub_steps=hs))
        secs = time.perf_counter() - t0
        st = plan.stats
        cs.check(sc.small(plan), f"{name}: the small form at hub chunk {hs}")
        want = ehyb_stream.stream_body_plain(plan.to_torch(), x_cpu, kahan)
        p = plan.to_torch(dev)
        layout = cs.bound(st["layout_bytes"], 2 * nnz, dev, f64)["bound_ms"]
        print(f"  small form, hubs past {ss} cells, hub chunk {hs} (got "
              f"{st['hub_steps']}): built "
              f"in {secs:.1f} s; {st['compact_cells']} cells "
              f"({st['hub_cells']} of {st['n_hubs']} hubs), "
              f"{st['n_items']} items ({st['hub_items']} hub), longest "
              f"{st['max_item_steps']} steps, widest fold {st['max_fold']}, "
              f"{st['direct_pieces']} direct "
              f"pieces, {'grouped' if st['grouped'] else 'body order'}; "
              f"layout bound {layout * 1e3:.3f} us", flush=True)
        for g in small_geometries():
            try:
                grid = ehyb_stream.grid_of(p, g, kahan, dev)
            except RuntimeError as exc:
                print(f"    {g}: not run ({exc})")
                continue
            y = ehyb_stream._launch(p, x, kahan, g).cpu()
            ok = torch.equal(y, want) if f64 or not kahan else \
                cs.rel(y, want) <= cs.KERNEL_TOL
            cs.check(ok, f"{name} ({ss}, {hs}) at {g}: the plain version "
                         "on the CPU")
            fn = lambda: ehyb_stream._launch(p, x, kahan, g)  # noqa: E731
            ms = cs.device_ms_per_call(fn, calls_for(fn))
            ms_of[(ss, hs, g)] = ms
            regs = ehyb_stream.small_registers(kahan, f64)
            print(f"    threads {g.threads}: "
                  f"{ms * 1e3:.2f} us (grid {grid}, {regs} registers); "
                  f"{min(p_ms) / ms:.2f}x the parent, "
                  f"{lib / ms:.2f}x cuSPARSE, {same / ms:.3f} of the "
                  "same-work bound", flush=True)
        del p, want
    for k in sorted(ms_of, key=ms_of.get)[:5]:
        print(f"  fastest at {name}: hubs past {k[0]}, hub chunk {k[1]} at "
              f"{k[2]}: {ms_of[k] * 1e3:.2f} us")
    print(f"  card: {CARD} = {smi(CARD)}", flush=True)
    del model, x, pp
    return ms_of


def small_floor(dev) -> None:
    """The rule's floor shapes: ``FLOOR_SHAPES``' flagship bodies in float32
    and float64 keep their plans (neither split nor small), and the rule's
    inputs at powerlaw_16k's body (its parent's items against the wave)."""
    from ehyb_spmv_torch.ops import stream_cells as sc

    for name in FLOOR_SHAPES:
        for cfg in ({}, dict(dtype="float64")):
            model = port.EhybSpmv(port.EhybConfig(
                artifact_cache=True, routed_delegate="never", **cfg),
                device=dev).setup(generate.load_corpus(name))
            p = model.module.cells
            cs.check(not sc.split(p), f"{name} {cfg}: neither split nor "
                     f"small (widest row block {int(plan_widths(p).max())} "
                     "steps)")
            del model, p
    print(f"the rule: the small form where the split form chunks in chunks "
          f"longer than {sc.SMALL_STEPS} steps and its items are at most "
          f"{sc.SMALL_WAVE_SHARE} x {sc.WAVE_WARPS}", flush=True)


#: ``--layout``'s bodies: name → (matrix, config).
LAYOUT_CASES = {"powerlaw_1m --dword": ("powerlaw_1m",
                                        dict(dword_values=True)),
                "powerlaw_1m --dtype float64": ("powerlaw_1m",
                                                dict(dtype="float64"))}


def run_layout(dev) -> int:
    from ehyb_spmv_torch.ops import stream_cells as sc

    keys = ("compact_cells", "real_cells", "n_items", "max_item_steps",
            "chunked_rbs", "n_chunks", "n_hubs", "hub_cells", "hub_items",
            "max_fold", "grouped", "direct_pieces")
    for name, (matrix, cfg) in LAYOUT_CASES.items():
        model, _ = f64_model(matrix, dev, **cfg)
        e, st = model.ehyb, model.module.cells.stats
        opts = dict(sc.k1_options(e, lists=True), fold=st["folded"])
        t0 = time.perf_counter()
        hub = sc._build(e, None, opts.get("direct_below", 0.0),
                        opts.get("group_rows", 0), opts["split_steps"],
                        opts["fold"], sc.SMALL_STEPS, sc.HUB_STEPS).stats
        print(json.dumps({"case": name, "shipped": {k: st.get(k) for k in
                                                    keys},
                          "hubs_apart": {k: hub.get(k) for k in keys},
                          "hubs_apart_build_s": time.perf_counter() - t0,
                          "small_form_wanted": bool(st.get("small"))}),
              flush=True)
        del model, e
    return 0


def run_small(dev) -> int:
    built = ehyb_stream.build_kernel()
    print(f"built in {built.seconds:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.check_k1_small(dev)
    print(f"small bodies checked in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = {name: sweep_small(name, dev) for name in SMALL_CONFIGS}
    ok = [k for k in runs["float32"] if all(k in r for r in runs.values())]
    best = {name: min(r.values()) for name, r in runs.items()}
    pick = min(ok, key=lambda k: sum(r[k] / best[n]
                                     for n, r in runs.items()))
    print(f"choice: hubs past {pick[0]}, hub chunk {pick[1]} at {pick[2]}: "
          + ", ".join(f"{n} {r[pick] * 1e3:.2f} us" for n, r in runs.items()))
    small_floor(dev)
    return 0


def main() -> int:
    args = sys.argv[1:]
    f64, long = "--f64" in args, "--long" in args
    small, layout = "--small" in args, "--layout" in args
    args = [a for a in args
            if a not in ("--f64", "--long", "--small", "--layout")]
    ab = args[:2] if args[:1] == ["--ab"] else None
    names = AB_SHAPES if not f64 else tuple(F64_CASES)
    shapes = tuple(args[2:]) or (names if not f64 else tuple(
        k for k in F64_CASES if k != "powerlaw_1m_dword"))
    if (ab is None and args) or (ab is not None and (
            len(ab) != 2 or not set(shapes) <= set(names))) \
            or (long and ab is not None):
        print(f"usage: chip_k1_sweep.py [--long] [--f64] [--ab TAG "
              f"[SHAPE ...]], SHAPE one of {', '.join(AB_SHAPES)}; with "
              f"--f64, one of {', '.join(F64_CASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"), flush=True)
    if small:
        return run_small(dev)
    if layout:
        return run_layout(dev)
    if long:
        return run_long_f64(dev) if f64 else run_long(dev)
    if f64:
        return run_ab_f64(ab[1], dev, shapes) if ab else sweep_f64(dev)
    return run_ab(ab[1], dev, shapes) if ab else run_sweep(dev)

if __name__ == "__main__":
    sys.exit(main())
