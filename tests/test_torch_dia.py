"""The port's DIA body on the CPU: its plain version (the one the DIA
kernel's wrapper takes for CPU tensors) against the JAX Pallas DIA kernel K9
in interpret mode, in both of K9's variants and on a multi-run offset set,
the flagship on an all-DIA FEM matrix against the JAX flagship with K9
forced, and the kernel's host plan (offset runs, tiles, staged windows),
replayed in numpy as ``csrc/dia.cu`` walks it, also at an x base (the
sharded apply's).

Bounds: f32 rel <= 2e-6 in norm against the JAX kernel (the same products,
summed in another order); rel <= 5e-6 against the exact-f64 oracle (the
suite's bound)."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu as ref
import ehyb_spmv_gpu_tpu.models.ehyb as ref_ehyb
import ehyb_spmv_gpu_tpu.ops.dia_pallas as dp
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from ehyb_spmv_torch.io import generate as port_generate
from ehyb_spmv_torch.ops import dia, ehyb_stream, ehyb_wincache
from test_torch_parity import PORT, assert_same_ehyb, coo_for, rel

PARITY_TOL = 2e-6
ORACLE_TOL = 5e-6
OFFSETS = (-1024, -128, -1, 0, 1, 128, 1024)
DIM = 8192


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    val = rng.standard_normal((len(OFFSETS), DIM)).astype(np.float32)
    x = rng.standard_normal(DIM).astype(np.float32)
    return val, x


def _exact(val, x, offsets):
    want = np.zeros(val.shape[1])
    i = np.arange(val.shape[1])
    for k, d in enumerate(offsets):
        j = i + d
        ok = (j >= 0) & (j < x.shape[0])
        want[i[ok]] += val[k, i[ok]].astype(np.float64) * x[j[ok]]
    return want


@pytest.mark.parametrize("variant,block_rows", [
    ("resident", 8192), ("resident", 4096), ("streamed", 4096)])
def test_dia_plain_matches_pallas_interpret(variant, block_rows,
                                            monkeypatch):
    """K9 in interpret mode on pack_dia'd values, x resident or streamed as
    block pairs, against the port's DIA body on the (K, dim) values."""
    val, x = _inputs()
    if variant == "streamed":
        monkeypatch.setattr(dp, "X_RESIDENT_DIA_BYTES", 1024)
    packed, _ = dp.pack_dia(val, block_rows=block_rows)
    apply = dp.make_dia_pallas_apply(OFFSETS, DIM, "float32",
                                     block_rows=block_rows, interpret=True)
    want = np.asarray(apply(jnp.asarray(packed), jnp.asarray(x)))[:DIM]

    e = types.SimpleNamespace(dia_offsets=OFFSETS,
                              dia_val=torch.from_numpy(val))
    xt = torch.from_numpy(x)
    got = dia.dia_body(e, xt).numpy()
    assert got.shape == (DIM,) and got.dtype == np.float32
    assert rel(got, want) <= PARITY_TOL, rel(got, want)
    assert rel(got, _exact(val, x, OFFSETS)) <= PARITY_TOL
    # on a CPU tensor the wrapper IS the plain version
    assert torch.equal(dia.dia_body(e, xt), dia.dia_body_plain(e, xt))


def test_dia_reads_zero_outside_x():
    """An x index outside [0, len(x)) reads as zero, at both ends, with
    offsets past the edges and an x shorter than the rows."""
    rng = np.random.default_rng(3)
    offsets = (-3000, -5, 0, 7, 2999)
    val = rng.standard_normal((len(offsets), 2500)).astype(np.float32)
    x = rng.standard_normal(2300).astype(np.float32)
    e = types.SimpleNamespace(dia_offsets=offsets,
                              dia_val=torch.from_numpy(val))
    got = dia.dia_body(e, torch.from_numpy(x)).numpy()
    assert rel(got, _exact(val, x, offsets)) <= PARITY_TOL
    empty = types.SimpleNamespace(dia_offsets=(),
                                  dia_val=torch.zeros(0, 2500))
    assert dia.dia_body(empty, torch.from_numpy(x)).shape == (0,)


def test_flagship_all_dia_fem_matches_jax_with_k9(monkeypatch):
    """fem3d_16 goes all to DIA (99 diagonals): the port's flagship against
    the JAX flagship with K9 forced (a lowered VMEM_PRESTAGE_LIMIT puts it
    in args mode), each against the oracle; the same artifact, no body."""
    m = generate.fem3d(16)
    monkeypatch.setenv("EHYB_FORCE_PALLAS", "interpret")
    monkeypatch.setattr(ref_ehyb, "VMEM_PRESTAGE_LIMIT", 1024)
    kw = dict(artifact_cache=False, routed_delegate="never")
    jmodel = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(m)
    assert jmodel._args_mode and getattr(jmodel, "_dia_apply", None)
    assert jmodel._pallas_apply.__name__ == "apply_nobody"
    before = (dia.dia_body.launches, ehyb_stream.stream_body.launches,
              ehyb_wincache.wincache_body.launches)
    model = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(
        coo_for(PORT, m))
    assert_same_ehyb(model.ehyb, jmodel.ehyb)
    st = model.ehyb.stats
    assert st["nnz_dia"] == m.nnz and st["nnz_ell"] == 0
    assert len(model.dev.dia_offsets) == 99
    assert model.module.branch == "skipped"
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    got = model.matvec(x)
    jgot = jmodel.matvec(x)
    assert rel(got, want) <= ORACLE_TOL
    assert rel(jgot, want) <= ORACLE_TOL
    assert rel(got, jgot) <= PARITY_TOL
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (dia.dia_body.launches, ehyb_stream.stream_body.launches,
            ehyb_wincache.wincache_body.launches) == before


def _fem_offsets(n=16):
    """fem3d(n)'s diagonals: 27-point node stencil x 3 DOFs, 9 runs of 11."""
    m = port_generate.fem3d(n)
    return tuple(int(d) for d in np.unique(m.col - m.row)), m.n_rows


def test_dia_plain_matches_pallas_interpret_multi_run():
    """K9 in interpret mode on three runs of five offsets (fem3d's shape of
    offsets, smaller) against the port's DIA body."""
    offsets = tuple(b + j for b in (-600, 0, 600) for j in range(-2, 3))
    rng = np.random.default_rng(7)
    dim = 4096
    val = rng.standard_normal((len(offsets), dim)).astype(np.float32)
    x = rng.standard_normal(dim).astype(np.float32)
    packed, _ = dp.pack_dia(val, block_rows=4096)
    apply = dp.make_dia_pallas_apply(offsets, dim, "float32",
                                     block_rows=4096, interpret=True)
    want = np.asarray(apply(jnp.asarray(packed), jnp.asarray(x)))[:dim]
    assert len(dia.offset_runs(offsets)) == 3
    e = types.SimpleNamespace(dia_offsets=offsets,
                              dia_val=torch.from_numpy(val))
    got = dia.dia_body(e, torch.from_numpy(x)).numpy()
    assert rel(got, want) <= PARITY_TOL, rel(got, want)
    assert rel(got, _exact(val, x, offsets)) <= PARITY_TOL


# --- the kernel's host plan -------------------------------------------------

_FEM, _FEM_DIM = _fem_offsets()
#: (name, offsets, dim_r, x length)
PLAN_CASES = [
    ("fem3d_16", _FEM, _FEM_DIM, _FEM_DIM),
    ("one diagonal", (0,), 100_000, 100_000),
    ("wider than a tile", (-40_000, -3, 0, 3, 40_000), 100_000, 99_923),
    ("a run wider than a tile", tuple(range(-2000, 2001, 10)), 20_000,
     20_000),
    ("ragged rows", (-5, -1, 0, 2, 7), 10_003, 9_926),
]
G0 = dia.DiaGeometry(threads=256, quads=1, step=4, blocks_per_sm=4,
                     x_mode="staged")
GEOMETRIES = [G0, dataclasses.replace(G0, quads=2),
              dataclasses.replace(G0, threads=128, blocks_per_sm=2),
              dataclasses.replace(G0, threads=512),
              dataclasses.replace(dia.GEOMETRY, x_mode="staged")]


@pytest.mark.parametrize("name,offsets", [
    ("fem3d_16", _FEM), ("one diagonal", (0,)),
    ("wide", (-40_000, -3, 0, 3, 40_000)),
    ("gaps at the limit", (0, dia.RUN_GAP, 2 * dia.RUN_GAP + 1))])
def test_offset_runs_cover_every_offset_once(name, offsets):
    runs = dia.offset_runs(offsets)
    ks = [k for _, _, k0, k1 in runs for k in range(k0, k1)]
    assert ks == list(range(len(offsets)))
    for lo, hi, k0, k1 in runs:
        assert (lo, hi) == (offsets[k0], offsets[k1 - 1])
        assert all(b - a <= dia.RUN_GAP
                   for a, b in zip(offsets[k0:k1], offsets[k0 + 1:k1]))
    for (_, hi, _, _), (lo, _, _, _) in zip(runs, runs[1:]):
        assert lo - hi > dia.RUN_GAP
    if name == "fem3d_16":
        assert [k1 - k0 for _, _, k0, k1 in runs] == [11] * 9
    if name == "gaps at the limit":
        assert len(runs) == 2


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=["threads256", "quads2", "threads128",
                              "threads512", "default"])
@pytest.mark.parametrize("name,offsets,dim_r,n_x", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_staged_windows_cover_every_read(name, offsets, dim_r, n_x,
                                         geometry):
    """The blocks' tiles cover every row once; each run's window for a tile
    holds every x index its diagonals need there and every 16-B pair the
    kernel loads; the windows are 16-B aligned and apart in the buffer."""
    _check_windows(dia.make_plan(offsets, dim_r, geometry, blocks=4 * 132),
                   offsets, dim_r, geometry)


def _check_windows(plan, offsets, dim_r, geometry):
    """The checks of :func:`test_staged_windows_cover_every_read` on one
    plan, in its value size: a 16-B load holds ``plan.per_load`` values,
    and a quad's shifted x takes 4 + per_load of them."""
    a = plan.per_load
    assert plan.smem_bytes <= dia.SMEM_LIMIT_BYTES
    seen = np.zeros(dim_r, np.int64)
    per_block = [len(list(plan.tiles(b))) for b in range(plan.grid)]
    # every block has the same number of tiles, give or take one
    assert max(per_block) - min(per_block) <= 1
    for b in range(plan.grid):
        for t0, t1 in plan.tiles(b):
            assert t0 % 4 == 0 and 0 < t1 - t0 <= geometry.tile_rows
            seen[t0:t1] += 1
            last_quad = (t1 - 1) // 4 * 4
            for r, (lo, hi, k0, k1) in enumerate(plan.runs):
                start, stop = plan.window(r, t0)
                for d in offsets[k0:k1]:
                    # the function's reads, and the kernel's 16-B pairs
                    assert start <= t0 + d and t1 - 1 + d < stop
                    assert start <= t0 + (d & ~(a - 1))
                    assert last_quad + (d & ~(a - 1)) + 4 + a <= stop
    assert (seen == 1).all()
    ends = []
    for (base, wlo, width), (lo, hi, k0, k1) in zip(plan.windows, plan.runs):
        assert base % a == 0 and wlo % a == 0 and width % a == 0
        ends.append((base, base + width))
        for k in range(k0, k1):
            assert plan.xo[k] == base + (offsets[k] & ~(a - 1)) - wlo
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert ends[-1][1] == plan.stage_floats


def _replay(plan, val, x):
    """y as ``csrc/dia.cu`` computes it from the plan, in the values' type,
    each term added in order of k: staged windows zero-filled outside x, or
    x read through a guard."""
    n_x = x.shape[0]
    y = np.zeros(plan.dim_r, val.dtype)
    for b in range(plan.grid):
        for t0, t1 in plan.tiles(b):
            rows = np.arange(t0, t1)
            if plan.staged:
                buf = np.zeros(plan.stage_floats, val.dtype)
                for r, (base, _, width) in enumerate(plan.windows):
                    g = np.arange(*plan.window(r, t0))
                    ok = (g >= 0) & (g < n_x)
                    buf[base:base + width][ok] = x[g[ok]]
            for k, d in enumerate(plan.offsets):
                if plan.staged:
                    xv = buf[plan.xo[k] + (d & (plan.per_load - 1))
                             + rows - t0]
                else:
                    g = rows + d
                    ok = (g >= 0) & (g < n_x)
                    xv = np.where(ok, x[np.clip(g, 0, n_x - 1)], 0)
                y[t0:t1] = y[t0:t1] + val[k, t0:t1] * xv.astype(val.dtype)
    return y


@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("x_mode", dia.X_MODES)
@pytest.mark.parametrize("name,offsets,dim_r,n_x", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_replay_matches_plain(name, offsets, dim_r, n_x, x_mode,
                                   threads):
    """The kernel's walk of the plan (tiles of 512 or 1,024 rows), replayed
    in numpy, against the plain version and the exact sum."""
    rng = np.random.default_rng(11)
    val = rng.standard_normal((len(offsets), dim_r)).astype(np.float32)
    x = rng.standard_normal(n_x).astype(np.float32)
    plan = dia.make_plan(offsets, dim_r,
                         dataclasses.replace(G0, x_mode=x_mode,
                                             threads=threads))
    got = _replay(plan, val, x)
    e = types.SimpleNamespace(dia_offsets=offsets,
                              dia_val=torch.from_numpy(val))
    plain = dia.dia_body_plain(e, torch.from_numpy(x)).numpy()
    assert rel(got, plain) <= PARITY_TOL
    assert rel(got, _exact(val, x, offsets)) <= PARITY_TOL


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="step"):
        dia.make_plan((0,), 100, dataclasses.replace(G0, step=3))
    with pytest.raises(ValueError, match="sorted"):
        dia.make_plan((1, 0), 100)
    with pytest.raises(ValueError, match="shared memory"):
        # 200 runs of 1 offset: 200 windows of a tile each, two buffers
        dia.make_plan(tuple(range(0, 200 * 100, 100)), 100_000, G0)
    # the grid shrinks to the tiles there are, never below one block
    assert dia.make_plan((0,), 100, G0).grid == 1


#: The f64 kernel's geometries: the default (STEP, QUADS) in both x modes.
F64_GEOMETRIES = [G0, dataclasses.replace(G0, threads=128, blocks_per_sm=2)]


@pytest.mark.parametrize("geometry", F64_GEOMETRIES,
                         ids=["threads256", "threads128"])
@pytest.mark.parametrize("name,offsets,dim_r,n_x", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_f64_staged_windows_cover_every_read(name, offsets, dim_r, n_x,
                                             geometry):
    """The f64 plan: windows aligned to two doubles, and every read of the
    kernel's 16-B loads inside them."""
    plan = dia.make_plan(offsets, dim_r, geometry, blocks=4 * 132,
                         value_bytes=8)
    assert plan.per_load == 2 and plan.stats["layout_bytes"] == 8 * (
        len(offsets) * dim_r + 2 * dim_r)
    _check_windows(plan, offsets, dim_r, geometry)


@pytest.mark.parametrize("x_mode", dia.X_MODES)
@pytest.mark.parametrize("name,offsets,dim_r,n_x", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_f64_plan_replay_matches_plain(name, offsets, dim_r, n_x, x_mode):
    """The f64 kernel's walk of its plan, replayed in numpy, against the
    plain version in f64 (the same products in the same order) and the
    exact sum."""
    rng = np.random.default_rng(11)
    val = rng.standard_normal((len(offsets), dim_r))
    x = rng.standard_normal(n_x)
    plan = dia.make_plan(offsets, dim_r,
                         dataclasses.replace(G0, x_mode=x_mode),
                         value_bytes=8)
    got = _replay(plan, val, x)
    e = types.SimpleNamespace(dia_offsets=offsets,
                              dia_val=torch.from_numpy(val))
    plain = dia.dia_body_plain(e, torch.from_numpy(x)).numpy()
    assert plain.dtype == np.float64
    assert rel(got, plain) <= 1e-14
    assert rel(got, _exact(val, x, offsets)) <= 1e-14


def test_f64_plan_refuses_unbuilt_steps():
    with pytest.raises(ValueError, match="8-byte"):
        dia.make_plan((0,), 100, dataclasses.replace(G0, step=2),
                      value_bytes=8)
    with pytest.raises(ValueError, match="2-byte"):
        dia.make_plan((0,), 100, G0, value_bytes=2)


def test_f64_kernel_refuses_what_is_not_built():
    """Values and x of one type; in f64 only the default (STEP, QUADS):
    refused before any build."""
    e = types.SimpleNamespace(dia_offsets=(-1, 0, 3), dia_val=torch.zeros(
        3, 64, dtype=torch.float64))
    x = torch.zeros(64, dtype=torch.float64)
    with pytest.raises(ValueError, match="8-byte"):
        dia._launch(e, x, dataclasses.replace(dia.GEOMETRY, step=8))
    with pytest.raises(ValueError, match="x_pad's type"):
        dia._launch(e, x.float())


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_dia_out_adds_into_y(dtype):
    """K9's accumulate mode (``out``, the flagship's apply: K9 finishes the
    y K1 wrote): each row's diagonal sum is added once into ``out`` in
    place, bit for bit ``y + dia_body_plain(e, x)``, rows past the
    diagonals' untouched; the replay of the kernel's walk of its
    accumulate plan, added into y, within 1e-14 in f64; an ``out`` it
    cannot add into, and a geometry the mode is not built for, refused."""
    val, x = _inputs(3)
    val, x = val.astype(dtype), x.astype(dtype)
    e = types.SimpleNamespace(dia_offsets=OFFSETS,
                              dia_val=torch.from_numpy(val))
    xt = torch.from_numpy(x)
    y0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        DIM + 128).astype(dtype))
    out = y0.clone()
    got = dia.dia_body(e, xt, out=out)
    assert got is out
    want = y0[:DIM] + dia.dia_body_plain(e, xt)
    assert torch.equal(out[:DIM], want) and torch.equal(out[DIM:], y0[DIM:])
    assert torch.equal(dia.dia_body_plain(e, xt, out=y0.clone()), out)
    if dtype == np.float64:
        plan = dia.make_plan(OFFSETS, DIM, G0, value_bytes=8, acc=True)
        replay = y0.numpy()[:DIM] + _replay(plan, val, x)
        assert rel(out[:DIM].numpy(), replay) <= 1e-14
    with pytest.raises(ValueError, match="out must be"):
        dia.dia_body(e, xt, out=y0[:DIM - 4].clone())
    with pytest.raises(ValueError, match="out must be"):
        dia.dia_body(e, xt, out=y0.to(torch.float16))
    with pytest.raises(ValueError, match="accumulate"):
        dia.make_plan(OFFSETS, DIM, dataclasses.replace(G0, step=8),
                      acc=True)
    # without diagonals ``out`` comes back as it was
    none = types.SimpleNamespace(dia_offsets=(), dia_val=torch.zeros(
        0, DIM, dtype=torch.from_numpy(val).dtype))
    assert torch.equal(dia.dia_body(none, xt, out=y0.clone()), y0)


@pytest.mark.parametrize("x_mode", dia.X_MODES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("x_base", [0, 3, 1024])
def test_dia_x_base(x_base, dtype, x_mode):
    """K9 with an x base (the sharded apply's diagonals, which read a
    shard's ``x_ext`` past its left halo): row i reads ``x[x_base + i +
    d_k]``, an index outside x reading as zero.  The plain version against
    ``torch_ops.ehyb_dia(..., x_base=)`` (its terms fused: rel <= 2e-6 in
    f32, 1e-14 in f64) and the exact sum; its accumulate mode adds the same
    sums into ``out``; the plan at a base is the plan of the offsets
    shifted by it (at base 0 the plan it was), and the kernel's walk of it,
    replayed, equals the plain version bit for bit."""
    from ehyb_spmv_torch.ops.torch_ops import ehyb_dia

    rng = np.random.default_rng(17)
    n_x = DIM + 2 * 1024
    val = rng.standard_normal((len(OFFSETS), DIM)).astype(dtype)
    x = rng.standard_normal(n_x).astype(dtype)
    e = types.SimpleNamespace(dia_offsets=OFFSETS,
                              dia_val=torch.from_numpy(val))
    xt = torch.from_numpy(x)
    got = dia.dia_body(e, xt, x_base=x_base)
    tol = PARITY_TOL if dtype == np.float32 else 1e-14
    assert rel(got.numpy(), ehyb_dia(e, xt, x_base=x_base).numpy()) <= tol
    shifted = tuple(d + x_base for d in OFFSETS)
    assert rel(got.numpy(), _exact(val, x, shifted)) <= tol
    y0 = torch.from_numpy(rng.standard_normal(DIM).astype(dtype))
    out = dia.dia_body(e, xt, out=y0.clone(), x_base=x_base)
    assert torch.equal(out, y0 + got)
    geometry = dataclasses.replace(G0, x_mode=x_mode)
    vb = np.dtype(dtype).itemsize
    plan = dia.make_plan(OFFSETS, DIM, geometry, value_bytes=vb,
                         x_base=x_base)
    moved = dia.make_plan(shifted, DIM, geometry, value_bytes=vb)
    assert plan == dataclasses.replace(moved, x_base=x_base)
    assert plan.offsets == shifted
    if x_base == 0:
        assert plan == moved
    np.testing.assert_array_equal(_replay(plan, val, x), got.numpy())


# --- the spread form (small DIA parts) --------------------------------------

def _replay_spread(plan, val, x):
    """y as ``csrc/dia.cu``'s ``dia_kernel_spread`` computes it from the
    plan, in the values' type: each block's tiles of ``rows`` rows, the
    diagonals a chunk at a time, each product rounded alone into the
    chunk's ``[k][r]`` buffer, then row r's owner adding ``s[0][r] ..
    s[kn-1][r]`` in order of k into its sum, which starts from zero and
    carries across the chunks; an x index outside x reads as zero."""
    n_x, dim_r = x.shape[0], plan.dim_r
    rows_t, k_all = plan.geometry.rows, len(plan.offsets)
    y = np.full(dim_r, np.nan, val.dtype)
    for b in range(plan.grid):
        for t0, t1 in plan.tiles(b):
            assert t0 % rows_t == 0 and 0 < t1 - t0 <= rows_t
            rows = t0 + np.arange(rows_t)
            live = rows < dim_r
            at = np.minimum(rows, dim_r - 1)
            s = np.zeros(rows_t, val.dtype)
            for k0 in range(0, k_all, plan.chunk):
                kn = min(plan.chunk, k_all - k0)
                buf = np.empty((kn, rows_t), val.dtype)
                for kk in range(kn):
                    k = k0 + kk
                    g = rows + plan.offsets[k]
                    ok = live & (g >= 0) & (g < n_x)
                    v = np.where(live, val[k, at], 0).astype(val.dtype)
                    xv = np.where(ok, x[np.clip(g, 0, n_x - 1)],
                                  0).astype(val.dtype)
                    buf[kk] = v * xv
                for kk in range(kn):
                    s = s + buf[kk]
            y[t0:t1] = s[:t1 - t0]
    return y


def _small_parts():
    """(name, offsets, dim_r, x length) of the small DIA parts the spread
    form serves, scaled down: the corpus's stencil27, poisson2d and fem3d
    shapes, and offsets past both ends of an x shorter than the rows."""
    out = []
    for name, m in (("stencil3d(8, 27)", port_generate.stencil3d(8, 27)),
                    ("poisson2d(64)", port_generate.poisson2d(64)),
                    ("fem3d(4)", port_generate.fem3d(4))):
        offs = tuple(int(d) for d in np.unique(m.col - m.row))
        out.append((name, offs, m.n_rows, m.n_rows))
    out.append(("past both ends of x", (-3000, -70, -5, 0, 7, 2999), 2500,
                2300))
    return out


SMALL_PARTS = _small_parts()
#: The spread form at its default, in chunks of 8 diagonals over tiles of
#: 32 rows, and at tiles of 256 rows.
SPREAD = [dia.SpreadGeometry(),
          dia.SpreadGeometry(rows=32, chunk=8),
          dia.SpreadGeometry(rows=256, chunk=32)]
_jax_k9 = {}


def _jax_k9_f32(offsets, dim_r, val, x):
    """The JAX K9 in interpret mode (one block of rows), kept per input."""
    key = (offsets, dim_r, val.tobytes(), x.tobytes())
    if key not in _jax_k9:
        block = max(1024, -(-dim_r // 1024) * 1024)
        packed, _ = dp.pack_dia(val, block_rows=block)
        apply = dp.make_dia_pallas_apply(offsets, dim_r, "float32",
                                         block_rows=block, interpret=True)
        _jax_k9[key] = np.asarray(apply(jnp.asarray(packed),
                                        jnp.asarray(x)))[:dim_r]
    return _jax_k9[key]


@pytest.mark.parametrize("geometry", SPREAD,
                         ids=["default", "chunks-of-8", "rows-256"])
@pytest.mark.parametrize("acc", [False, True], ids=["write", "accumulate"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("x_base", [0, 5])
@pytest.mark.parametrize("name,offsets,dim_r,n_x", SMALL_PARTS,
                         ids=[c[0] for c in SMALL_PARTS])
def test_spread_replay_matches_plain(name, offsets, dim_r, n_x, x_base,
                                     dtype, acc, geometry):
    """K9's spread form: its walk of the plan (tiles, chunks, the [k][r]
    products, each row summed in order of k), replayed in numpy, equals
    the plain version bit for bit in f32 and f64, in the write mode and
    the accumulate mode (the row's sum added once into y), at an x base;
    in f32 it stands within PARITY_TOL of the JAX K9 in interpret mode on
    the offsets shifted by the base, and every value within it of the
    exact sum."""
    rng = np.random.default_rng(29)
    val = rng.standard_normal((len(offsets), dim_r)).astype(dtype)
    x = rng.standard_normal(n_x).astype(dtype)
    vb = np.dtype(dtype).itemsize
    plan = dia.make_plan(offsets, dim_r, geometry, blocks=7, value_bytes=vb,
                         acc=acc, x_base=x_base)
    assert plan.spread and plan.chunk == min(geometry.chunk, len(offsets))
    assert plan.smem_bytes == vb * plan.chunk * geometry.rows \
        + 4 * len(offsets)
    got = _replay_spread(plan, val, x)
    e = types.SimpleNamespace(dia_offsets=offsets,
                              dia_val=torch.from_numpy(val))
    xt = torch.from_numpy(x)
    want = dia.dia_body_plain(e, xt, x_base=x_base).numpy()
    np.testing.assert_array_equal(got, want)
    shifted = tuple(d + x_base for d in offsets)
    tol = PARITY_TOL if dtype == np.float32 else 1e-14
    assert rel(got, _exact(val, x, shifted)) <= tol
    if dtype == np.float32:
        jax_y = _jax_k9_f32(shifted, dim_r, val, x)
        assert rel(got, jax_y) <= PARITY_TOL, rel(got, jax_y)
    if acc:
        y0 = rng.standard_normal(dim_r + 8).astype(dtype)
        out = dia.dia_body_plain(e, xt, out=torch.from_numpy(y0.copy()),
                                 x_base=x_base).numpy()
        replay = y0.copy()
        replay[:dim_r] = replay[:dim_r] + got
        np.testing.assert_array_equal(replay, out)


#: The card's constants the rule was set on: an H100's 132 SMs, 8 blocks
#: of the default geometry resident on each.
N_SM, RESIDENT = 132, 8
#: (shape, rows, diagonals, the tile rows of the spread form the rule
#: picks, or None for the default geometry): the ten shapes
#: ``chip_dia_sweep.py --small`` timed, and pp4096's diagonal.
RULE_CASES = [("stencil27_24", 13_824, 27, 32),
              ("poisson2d_512", 262_144, 5, None),
              ("fem3d_32", 98_304, 99, 128),
              ("permuted_poisson_512's diagonal", 262_144, 1, None),
              ("permuted_poisson_1024 D=1's diagonal", 1_048_576, 1, None),
              ("fem3d_68_audikw_class", 943_296, 99, None),
              ("permuted_poisson_4096's diagonal", 16_777_216, 1, None),
              ("poisson2d(256)", 65_536, 5, None),
              ("stencil3d(32, 7)", 32_768, 7, 32),
              ("9 diagonals of 512 x 512", 262_144, 9, None),
              ("13 diagonals of 512 x 512", 262_144, 13, None)]


@pytest.mark.parametrize("name,dim_r,n_diag,rows", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_choose_geometry_at_the_measured_shapes(name, dim_r, n_diag, rows):
    """The choice rule at the card's constants: the spread form where the
    default grid fills at most a quarter of one wave and the diagonals are
    six or more, with the tile rows the sweep found fastest there
    (stencil27_24, fem3d_32, stencil3d(32, 7)); the default geometry
    elsewhere (fem3d_68, pp1024 and pp4096 fill the card; at 262,144 rows
    the default grid is half a wave, and the spread form lost there at 1,
    5, 9 and 13 diagonals; poisson2d(256)'s 5 lost too)."""
    g = dia.choose_geometry(dim_r, n_diag, N_SM, RESIDENT)
    if rows is None:
        assert g == dia.GEOMETRY
        return
    assert isinstance(g, dia.SpreadGeometry) and g.rows == rows
    plan = dia.make_plan(tuple(range(n_diag)), dim_r, g, N_SM * RESIDENT)
    # each resident block a tile, the tiles within one wave
    assert plan.grid == -(-dim_r // rows) <= N_SM * RESIDENT
    assert 4 * dia.make_plan(tuple(range(n_diag)), dim_r, dia.GEOMETRY,
                             N_SM * RESIDENT).grid <= N_SM * RESIDENT


@pytest.mark.parametrize("geometry,what", [
    (dia.SpreadGeometry(rows=48), "rows 48"),
    (dia.SpreadGeometry(rows=512), "rows 512"),
    (dia.SpreadGeometry(chunk=0), "chunk"),
    (dia.SpreadGeometry(rows=256, chunk=128), "shared memory"),
], ids=["rows", "rows-past-threads", "chunk", "shared-memory"])
def test_spread_plan_refuses_what_the_kernel_does_not_take(geometry, what):
    """A spread geometry the kernel does not take (tiles not a power of
    two, or more rows than its 256 threads), or whose chunk of products is
    past a block's shared memory (128 diagonals of 256 rows in f64: 256
    KiB), is refused before any launch."""
    with pytest.raises(ValueError, match=what):
        dia.make_plan(tuple(range(200)), 100_000, geometry, value_bytes=8)
