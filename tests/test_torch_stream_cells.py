"""K1's compact plan (``ops/stream_cells.py``) on the CPU: the plan applied
by the kernel's plain version against the padded body's plain version
(``ops/torch_ops.py::ehyb_body``) bit for bit, at nwin 1/2/4, int16 and
int32 columns and Kahan; a numpy replay of the plan and of the kernel's
walk; the cut of a row block past the 16-bit range; and the flagship's
K1 path: the plan replaces the padded body on the device and in the
roofline's bytes.

Bit equality holds because a row's cells keep their step order and the
dropped cells are zeros (finite x); the Kahan variant sums in float64 on
both sides.  Against the exact-f64 oracle: rel <= 5e-6 (the suite's
bound)."""
import numpy as np
import pytest
import torch

from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv

import ehyb_spmv_torch as port
from chip_smoke import edge_body
from ehyb_spmv_torch.ops import ehyb_stream, stream_cells
from ehyb_spmv_torch.ops.torch_ops import body_gather_index, ehyb_body
from test_torch_parity import (PORT, cancellation_matrix, config_for,
                               coo_for, host_pipeline, rel)

ORACLE_TOL = 5e-6
MAX = stream_cells.MAX_TABLE_ROWS

# (case, fixture, flagship layout or None for the plain config, windows per
#  sub-tile, extra config, kahan, a 2-D Poisson body)
CASES = [
    ("nwin1", "scrambled", "sell_mw", 2, {}, False, True),
    ("nwin2", "scrambled", "sell_rx", 2, {}, False, True),
    ("nwin4", "scrambled", "sell_rx", 4, {}, False, True),
    ("nwin4_powerlaw", "powerlaw_small", "sell_rx", 4, {}, False, False),
    ("hub_split", "powerlaw_small", "sell_rx", 2,
     {"row_split_threshold": 4}, False, False),
    ("int32", "scrambled", None, 2, {"index_dtype": "int32"}, False, True),
    ("kahan", "cancellation", "sell_rx", 2, {}, True, False),
    ("edges", "edges", None, 0, {}, False, False),
    ("edges_kahan", "edges", None, 0, {}, True, False),
]
IDS = [c[0] for c in CASES]


def _artifact(request, fixture, layout, wps, extra):
    if fixture == "edges":
        return edge_body()
    m = cancellation_matrix(PORT) if fixture == "cancellation" \
        else request.getfixturevalue(fixture)
    cfg = config_for(PORT, layout is not None, layout or "sell_mw", wps,
                     **extra)
    return host_pipeline(PORT, m, cfg)[2]


def _x(e, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        e.padded_x_rows).astype(np.float32))


def _replay(p):
    """Every cell of the plan: its piece, y row, place k in its row within
    the piece, x column and value."""
    piece = p.piece.astype(np.int64)
    cell_piece = np.repeat(np.arange(len(piece) - 1),
                           np.diff(piece[:, stream_cells.PIECE_CELL]))
    off = np.arange(piece[-1, 0]) - piece[cell_piece, 0]
    row = piece[cell_piece, stream_cells.PIECE_RB] * 32 + off % 32
    idx = p.cell_idx.view(np.uint16).astype(np.int64)
    slot = idx >> 7
    sizes = np.diff(piece[:, stream_cells.PIECE_ROW])
    assert np.all(slot < sizes[cell_piece]), "a cell reads past its table"
    col = p.rows[piece[cell_piece, 1] + slot].astype(np.int64) * 128 \
        + (idx & 127)
    return cell_piece, row, off // 32, col, p.cell_val


def _walk(n_rb: int, rows_per_thread: int, warps: int):
    """The kernel's walk over the row blocks (``csrc/ehyb_stream.cu``):
    ``warps`` warps in all (the grid's blocks times their warps), each
    taking groups of ``rows_per_thread`` row blocks round-robin.  Yields
    (warp, row block) in the order each warp takes them."""
    v = rows_per_thread
    n_groups = -(-n_rb // v)
    for w in range(warps):
        for j in range(w, n_groups, warps):
            for rb in range(j * v, min(j * v + v, n_rb)):
                yield w, rb


def _chains(p):
    """Each row block's pieces in the kernel's order (main, then ``next``)."""
    out = []
    for rb in range(p.n_rb):
        chain, q = [], rb
        while q >= 0:
            chain.append(q)
            q = int(p.piece[q, stream_cells.PIECE_NEXT])
        out.append(chain)
    return out


@pytest.mark.parametrize("case,fixture,layout,wps,extra,kahan,poisson",
                         CASES, ids=IDS)
def test_plan_plain_equals_padded_body(case, fixture, layout, wps, extra,
                                       kahan, poisson, request):
    """The plan applied by the kernel's plain version gives the padded
    body's plain answer bit for bit; on a CPU tensor the wrapper is the
    plain version and counts no launch."""
    e = _artifact(request, fixture, layout, wps, extra)
    if case == "int32":
        assert e.ell_col.dtype == np.int32
    d = e.to_torch()
    assert d.nwin == {0: 1, 2: 1 if layout in ("sell_mw", None) else 2,
                      4: 4}[wps]
    if case == "hub_split":
        assert e.split_src.size > 0
    p = stream_cells.build_stream_cells(e).to_torch()
    x = torch.ones(e.padded_x_rows) if fixture == "cancellation" else _x(e)
    want = ehyb_body(d, x, compensated=kahan)
    launches = ehyb_stream.stream_body.launches
    got = ehyb_stream.stream_body(p, x, kahan)
    assert ehyb_stream.stream_body.launches == launches
    assert torch.equal(got, ehyb_stream.stream_body_plain(p, x, kahan))
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,fixture,layout,wps,extra,kahan,poisson",
                         CASES, ids=IDS)
def test_plan_replay(case, fixture, layout, wps, extra, kahan, poisson,
                     request):
    """Replay the plan: the compact cells are the body's real cells, each
    once, in step order per row, each index inside its piece's table and
    decoding to ``body_gather_index``'s column; every width is its piece's
    longest row; the tables are sorted, distinct and within 16 bits;
    a row block's pieces chain in order; and the kernel's walk (every
    rows-per-thread, a few warp counts) takes every row block and so
    every cell once.  A Poisson body's compact cells are within 1.1x its
    nnz."""
    e = _artifact(request, fixture, layout, wps, extra)
    plan = stream_cells.build_stream_cells(e)
    piece, n_rb = plan.piece.astype(np.int64), plan.n_rb
    n_p = len(piece) - 1
    # chains: each piece once, of its own row block, later pieces in order
    chains = _chains(plan)
    flat = [q for c in chains for q in c]
    assert sorted(flat) == list(range(n_p))
    level = np.zeros(n_p, np.int64)
    for rb, c in enumerate(chains):
        assert c[0] == rb and c == sorted(c)
        assert np.all(piece[c, stream_cells.PIECE_RB] == rb)
        level[c] = np.arange(len(c))
    # the cells against the body's real cells, both in (row, step) order
    cell_piece, row, k, col, val = _replay(plan)
    real = val != 0
    offs = e.slice_offset.astype(np.int64)
    n_steps = int(offs[-1])
    st, ln = np.nonzero(e.ell_val[:n_steps] != 0)
    step_slice = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    want_row = step_slice[st] * 128 + ln
    want_col = body_gather_index(e.to_torch()).numpy()[st, ln]
    order = np.lexsort((k[real], level[cell_piece[real]], row[real]))
    want = np.lexsort((st, want_row))
    assert real.sum() == st.size == plan.stats["real_cells"]
    np.testing.assert_array_equal(row[real][order], want_row[want])
    np.testing.assert_array_equal(col[real][order], want_col[want])
    np.testing.assert_array_equal(val[real][order], e.ell_val[st, ln][want])
    # a row's real cells fill its first places; the width is the longest
    count = np.zeros((n_p, 32), np.int64)
    np.add.at(count, (cell_piece[real], row[real] % 32), 1)
    kmax = np.full((n_p, 32), -1)
    np.maximum.at(kmax, (cell_piece[real], row[real] % 32), k[real])
    np.testing.assert_array_equal(kmax, count - 1)
    np.testing.assert_array_equal(count.max(1), np.diff(piece[:, 0]) // 32)
    # tables: sorted, distinct, within 16 bits
    for q in range(n_p):
        t = plan.rows[piece[q, 1]:piece[q + 1, 1]]
        assert t.size <= MAX and np.all(np.diff(t) > 0)
    # the kernel's walk covers every row block once, so every cell once
    for v in ehyb_stream.BUILT_ROWS:
        for warps in (1, 3, 64):
            seen = np.zeros(plan.stats["compact_cells"], np.int64)
            rbs = [rb for _, rb in _walk(n_rb, v, warps)]
            assert sorted(rbs) == list(range(n_rb))
            for rb in rbs:
                for q in chains[rb]:
                    seen[piece[q, 0]:piece[q + 1, 0]] += 1
            assert np.all(seen == 1)
    st_ = plan.stats
    assert st_["compact_cells"] == piece[-1, 0] <= st_["padded_cells"]
    assert st_["n_pieces"] == n_p and st_["table_rows"] == plan.rows.size
    if poisson:
        assert st_["compact_cells"] <= 1.1 * e.stats["nnz_ell"]


def test_plan_cuts_row_blocks_past_16_bits():
    """A row block whose cells read more x rows than a 16-bit index
    addresses (512 rows of 128) is cut between its steps: the edge body's
    slice 0 reads 640 rows in each of its 4 row blocks, so each becomes two
    pieces; a zero-width row block and a ragged last slice come out as
    empty row blocks."""
    e = edge_body()
    plan = stream_cells.build_stream_cells(e)
    st = plan.stats
    assert st["split_rbs"] == 4 and st["n_pieces"] == plan.n_rb + 4
    assert st["max_table_rows"] <= MAX
    _, row, _, col, val = _replay(plan)
    for rb in range(4):
        mine = (row // 32 == rb) & (val != 0)
        assert np.unique(col[mine] >> 7).size > MAX
    width = np.diff(plan.piece[:plan.n_rb + 1, 0]) // 32
    assert width[5] == 0 and width[11] == 0      # slice 1's, the ragged end


def test_flagship_k1_runs_on_its_plan(scrambled):
    """Where the flagship runs K1, it uploads the plan, frees the padded
    cells on the device, and records the plan's build; the answer holds
    against the oracle, and equals the padded body's plain version."""
    m = coo_for(PORT, scrambled)
    model = port.EhybSpmv(port.EhybConfig(artifact_cache=False),
                          device="cpu").setup(m)
    apply = model.module
    assert apply.branch == "streamed v3" and apply.wincache is None
    assert apply.cells is not None
    assert model.dev.ell_col is None and model.dev.ell_val is None
    assert 0 < model.setup_seconds["k1_plan"] <= model.setup_seconds["upload"]
    x = deterministic_x(scrambled.dimension)
    assert rel(model.matvec(x), oracle_spmv(scrambled, x)) <= ORACLE_TOL
    x_dev = model.prepare_x(x)
    padded = model.ehyb.to_torch(dtype=model.config.dtype)
    assert torch.equal(ehyb_stream.stream_body(apply.cells, x_dev),
                       ehyb_body(padded, x_dev))
    with pytest.raises(ValueError, match="exactly one plan"):
        ehyb_stream.EhybStreamApply(padded)


def test_geometry_rejects_unbuilt_variants():
    """Only the built rows per thread and x modes, and block sizes a warp
    multiple up to 512, are accepted."""
    ehyb_stream.GEOMETRY.check()
    for bad in (dict(rows=3), dict(x_mode="tma"), dict(threads=48),
                dict(threads=1024), dict(blocks_per_sm=0)):
        with pytest.raises(ValueError):
            ehyb_stream.StreamGeometry(**bad).check()


def test_f64_plan_keeps_f64_values():
    """In the precision mode the plan keeps the body's f64 values (10 B a
    cell) and reads an f64 x: its plain version equals the padded body's
    bit for bit on the edge body (cut row blocks, a zero-width one, a
    ragged slice)."""
    e = edge_body()
    rng = np.random.default_rng(3)
    e.ell_val = np.where(e.ell_val != 0, rng.standard_normal(
        e.ell_val.shape), 0.0)
    plan = stream_cells.build_stream_cells(e)
    assert plan.cell_val.dtype == np.float64 and plan.stats["split_rbs"] > 0
    st = plan.stats
    assert st["cell_bytes"] == 10 * st["compact_cells"]
    assert st["x_bytes"] == 8 * st["x_rows"] == 8 * e.padded_x_rows
    p = plan.to_torch()
    x = torch.from_numpy(rng.standard_normal(e.padded_x_rows))
    got = ehyb_stream.stream_body(p, x)
    assert got.dtype == torch.float64
    assert torch.equal(got, ehyb_body(e.to_torch(), x))


def test_f64_kernel_refuses_what_is_not_built():
    """The f64 kernel is built for one row a thread, x through L1/L2 (plain
    or Kahan, with or without a list); the wrapper refuses the other
    geometries, saying which, and an x whose type is not the plan's,
    before any build."""
    e = edge_body()
    e.ell_val = e.ell_val.astype(np.float64)
    p = stream_cells.build_stream_cells(e).to_torch()
    x = torch.zeros(e.padded_x_rows, dtype=torch.float64)
    for g, what in [(ehyb_stream.StreamGeometry(rows=2), "rows=2"),
                    (ehyb_stream.StreamGeometry(x_mode="staged"),
                     "x_mode='staged'")]:
        for kahan in (False, True):
            with pytest.raises(ValueError, match=f"no float64 K1.*{what}"):
                ehyb_stream._launch(p, x, kahan, g)
    with pytest.raises(ValueError, match="x_pad's type"):
        ehyb_stream._launch(p, x.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_wrapper_takes_every_variant_the_models_ask(dtype):
    """Every (value type, Kahan, row-block list) a model can ask of K1 at
    the shipped geometry passes the wrapper's checks, which run before any
    build: the flagship (plain or compensated) and the sharded path's two
    lists, in float32 and float64."""
    e = edge_body()
    e.ell_val = e.ell_val.astype(
        np.float64 if dtype == torch.float64 else np.float32)
    p = stream_cells.build_stream_cells(e).to_torch()
    x = torch.zeros(e.padded_x_rows, dtype=dtype)
    lst = torch.arange(3, dtype=torch.int32)
    for kahan in (False, True):
        for rb_list in (None, lst):
            ehyb_stream._check(p, x)
            ehyb_stream.check_built(ehyb_stream.GEOMETRY, x.dtype)
            y = ehyb_stream._output(p, x, rb_list, None)
            assert y.dtype == dtype and y.shape == (p.n_rb * 32,)
            got = ehyb_stream.stream_body(p, x, kahan, rb_list=rb_list)
            assert got.dtype == dtype


def _f64_cancel_body():
    """The f64 cancellation matrix's artifact (the flagship's relaxed
    layout, f64 values) and its row 0's place in y."""
    from chip_smoke import cancellation_matrix_f64

    m = cancellation_matrix_f64()
    cfg = config_for(PORT, True, "sell_rx", 2, dtype="float64",
                     compensated_sum=True)
    _, r, e = host_pipeline(PORT, m, cfg)
    assert e.ell_val.dtype == np.float64
    return e, int(r.old_to_new[0])


def test_f64_neumaier_keeps_the_cancelled_row():
    """On a row of ±1e17 blocks and 100 ones (x all ones) the f64 plain
    version with compensation gives the body row's exact sum (math.fsum
    over its entries), as the padded body's compensated plain version
    does, where the uncompensated f64 sum loses it."""
    import math

    e, r0 = _f64_cancel_body()
    p = stream_cells.build_stream_cells(e).to_torch()
    x = torch.ones(e.padded_x_rows, dtype=torch.float64)
    s, lane = divmod(r0, 128)
    offs = e.slice_offset
    exact = math.fsum(e.ell_val[offs[s]:offs[s + 1], lane].tolist())
    assert exact == 99.0  # the diagonal 1 goes to the DIA part
    kahan = ehyb_stream.stream_body(p, x, True)
    assert float(kahan[r0]) == exact
    assert torch.equal(kahan, ehyb_body(e.to_torch(), x, compensated=True))
    naive = ehyb_stream.stream_body(p, x, False)
    assert float(naive[r0]) != exact


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
def test_f64_list_plain_equals_the_full_walk(kahan):
    """In f64, plain or compensated, a row-block list's plain version gives
    the full walk's rows for the listed row blocks (the cut ones among
    them) and leaves the others as they were."""
    e = edge_body()
    rng = np.random.default_rng(4)
    e.ell_val = np.where(e.ell_val != 0, rng.standard_normal(
        e.ell_val.shape), 0.0)
    plan = stream_cells.build_stream_cells(e)
    p = plan.to_torch()
    x = torch.from_numpy(rng.standard_normal(e.padded_x_rows))
    full = ehyb_stream.stream_body(p, x, kahan)
    cut = np.unique(plan.piece[plan.n_rb:-1, stream_cells.PIECE_RB])
    rbs = np.union1d(cut, [0, plan.n_rb - 1]).astype(np.int32)
    lst = torch.from_numpy(rng.permutation(rbs))
    y = torch.full((p.n_rb * 32,), -7.0, dtype=torch.float64)
    ehyb_stream.stream_body(p, x, kahan, rb_list=lst, out=y)
    rows = (torch.from_numpy(rbs).long()[:, None] * 32
            + torch.arange(32)).reshape(-1)
    assert torch.equal(y[rows], full[rows])
    other = torch.ones_like(y, dtype=torch.bool)
    other[rows] = False
    assert bool((y[other] == -7.0).all())
