"""K1's compact plan (``ops/stream_cells.py``) on the CPU: the plan applied
by the kernel's plain version against the padded body's plain version
(``ops/torch_ops.py::ehyb_body``) bit for bit, at nwin 1/2/4, int16 and
int32 columns and Kahan, and in float64 the plan forms of a scattered body
(direct columns, grouped rows under a row map, both kinds of piece in one
plan); a numpy replay of the plan and of the kernel's walk; the cut of a
row block past the 16-bit range; the split form of a heavy-tailed body
(chunks of at most ``SPLIT_STEPS`` steps, their partials added in chunk
order: bit for bit against a numpy replay of that order, and against the
JAX package's apply and the oracle); the split form's small form (hub
rows apart: its plan, its plain version bit for bit against a numpy
replay of the kernel's lanes, shuffle tree and fold, the apply in five
configs against the JAX package and the oracle, the rule and the
refusals); and the flagship's K1 path: the plan replaces the padded body
on the device and in the roofline's bytes.

Bit equality holds because a row's cells keep their step order and the
dropped cells are zeros (finite x); the Kahan variant sums in float64 on
both sides.  Against the exact-f64 oracle: rel <= 5e-6 (the suite's
bound)."""
import dataclasses

import numpy as np
import pytest
import torch

from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from chip_smoke import edge_body, long_body
from ehyb_spmv_torch.ops import ehyb_stream, stream_cells
from ehyb_spmv_torch.ops.torch_ops import body_gather_index, ehyb_body
from test_torch_parity import (PORT, body_rows, cancellation_matrix,
                               config_for, coo_for, host_pipeline, rel)

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
    # float64: the precision mode's scattered body (direct columns, rows
    # grouped), the edge body (pieces with and without a table in one
    # plan, plain and Kahan) and the flagship layout (the table form)
    ("dword_grouped", "scrambled", "dword", 0, {}, False, True),
    ("edges_f64_mixed", "edges_f64", None, 0, {}, False, False),
    ("edges_f64_mixed_kahan", "edges_f64", None, 0, {}, True, False),
    ("f64_flagship", "scrambled", "sell_rx", 2, {"dtype": "float64"}, False,
     True),
    # the split form, SPLIT_STEPS patched: the synthetic long body (a row
    # block at the limit, one past it, empty rows, a hub in the last row
    # block) and a heavy-tailed body in the flagship layout
    ("split_long4", "long", None, 0, {"split_steps": 4}, False, False),
    ("split_long128", "long", None, 0, {"split_steps": 128}, False, False),
    ("split_powerlaw4", "powerlaw_small", "sell_rx", 4, {"split_steps": 4},
     False, False),
    # the split form in float64 (table pieces, direct pieces, grouped rows)
    # and compensated, the thresholds patched
    ("split_f64_powerlaw4", "powerlaw_small", "sell_rx", 4,
     {"split_steps": 4, "dtype": "float64"}, False, False),
    ("split_f64_long4", "long_f64", None, 0, {"split_steps": 4}, False,
     False),
    ("split_f64_long4_kahan", "long_f64", None, 0, {"split_steps": 4}, True,
     False),
    ("split_dword_grouped2", "scrambled", "dword", 0, {"split_steps": 2},
     False, True),
    ("split_dword_grouped2_kahan", "scrambled", "dword", 0,
     {"split_steps": 2}, True, True),
    ("split_long4_kahan", "long", None, 0, {"split_steps": 4}, True, False),
]
IDS = [c[0] for c in CASES]


def _edge_f64():
    e = edge_body()
    rng = np.random.default_rng(3)
    e.ell_val = np.where(e.ell_val != 0, rng.standard_normal(
        e.ell_val.shape), 0.0)
    return e


def _dword(m, **extra):
    """The precision mode's artifact of ``m`` (f64 values, no ordering)."""
    return port.EhybSpmv(port.EhybConfig(
        dword_values=True, artifact_cache=False, **extra),
        device="cpu").setup(coo_for(PORT, m)).ehyb


def _body_plan(e):
    """K1's plan of the body of ``e`` alone, with the options of its value
    type (``stream_cells.k1_options``) in the forms a cell of the plan is
    a cell of a piece (the split form's small form, where hub rows leave
    their row blocks, is the small-form tests' below: ``lists=True``)."""
    return stream_cells.build_stream_cells(
        e, **stream_cells.k1_options(e, lists=True))


def _patch_split(monkeypatch, steps: int) -> None:
    """Every split threshold and chunk length of K1's plans at ``steps``."""
    for name in ("SPLIT_STEPS", "SPLIT_STEPS_F64"):
        monkeypatch.setattr(stream_cells, name, steps)


def _split_steps(extra: dict, monkeypatch) -> dict:
    """``extra`` without its ``split_steps``, which is patched in as every
    split threshold and chunk length of the plan builder."""
    extra = dict(extra)
    steps = extra.pop("split_steps", None)
    if steps is not None:
        _patch_split(monkeypatch, steps)
    return extra


def _long_f64():
    """The synthetic long body at ``SPLIT_STEPS`` with float64 values."""
    e = long_body(stream_cells.SPLIT_STEPS)
    rng = np.random.default_rng(6)
    e.ell_val = np.where(e.ell_val != 0, rng.standard_normal(
        e.ell_val.shape), 0.0)
    return e


def _artifact(request, fixture, layout, wps, extra):
    if fixture == "edges":
        return edge_body()
    if fixture == "long":
        return long_body(stream_cells.SPLIT_STEPS)
    if fixture == "long_f64":
        return _long_f64()
    if fixture == "edges_f64":
        return _edge_f64()
    m = cancellation_matrix(PORT) if fixture == "cancellation" \
        else request.getfixturevalue(fixture)
    if layout == "dword":
        return _dword(m, **extra)
    cfg = config_for(PORT, layout is not None, layout or "sell_mw", wps,
                     **extra)
    return host_pipeline(PORT, m, cfg)[2]


def _x(e, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        e.padded_x_rows).astype(e.ell_val.dtype))


def _replay(p):
    """Every cell of the plan: its piece, y row (through the row map where
    the plan has one), place k in its row within the piece, x column (from
    its piece's table, or its own in a piece with no table), value and row
    in its row block."""
    piece = p.piece.astype(np.int64)
    cell_piece = np.repeat(np.arange(len(piece) - 1),
                           np.diff(piece[:, stream_cells.PIECE_CELL]))
    off = np.arange(piece[-1, 0]) - piece[cell_piece, 0]
    row = piece[cell_piece, stream_cells.PIECE_RB] * 32 + off % 32
    if p.row_map.size:
        row = p.row_map.astype(np.int64)[row]
    sizes = np.diff(piece[:, stream_cells.PIECE_ROW])
    direct = sizes[cell_piece] == 0
    col = np.zeros(off.size, np.int64)
    if p.cell_idx.size:
        idx = p.cell_idx.view(np.uint16).astype(np.int64)[~direct]
        slot = idx >> 7
        assert np.all(slot < sizes[cell_piece[~direct]]), \
            "a cell reads past its table"
        col[~direct] = p.rows[piece[cell_piece[~direct], 1] + slot] \
            .astype(np.int64) * 128 + (idx & 127)
    if p.cell_col.size:
        col[direct] = p.cell_col[direct]
    return cell_piece, row, off // 32, col, p.cell_val, off % 32


def _entries(p):
    """Every cell of the plan, the small form's hub cells among them: its
    y row (through the row map where the plan has one), x column and
    value."""
    _, row, _, col, val, _ = _replay(p)
    if not stream_cells.small(p):
        return row, col, val
    hub_row = np.repeat(p.hub_row.astype(np.int64), np.diff(p.hub_cell))
    if p.row_map.size:
        hub_row = p.row_map.astype(np.int64)[hub_row]
    return (np.concatenate([row, hub_row]),
            np.concatenate([col, p.hub_col.astype(np.int64)]),
            np.concatenate([val, p.hub_val]))


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
                                       kahan, poisson, request, monkeypatch):
    """The plan applied by the kernel's plain version gives the padded
    body's plain answer bit for bit (a plan in the split form: its table
    form does, and the split form within 1e-6 and bit for bit a numpy
    replay of its chunk order); on a CPU tensor the wrapper is the plain
    version and counts no launch."""
    extra = _split_steps(extra, monkeypatch)
    e = _artifact(request, fixture, layout, wps, extra)
    if case == "int32":
        assert e.ell_col.dtype == np.int32
    d = e.to_torch()
    assert d.nwin == {0: 1, 2: 1 if layout in ("sell_mw", None) else 2,
                      4: 4}[wps]
    if case == "hub_split":
        assert e.split_src.size > 0
    plan = _body_plan(e)
    p = plan.to_torch()
    x = torch.ones(e.padded_x_rows) if fixture == "cancellation" else _x(e)
    want = ehyb_body(d, x, compensated=kahan)
    launches = ehyb_stream.stream_body.launches
    got = ehyb_stream.stream_body(p, x, kahan)
    assert ehyb_stream.stream_body.launches == launches
    assert torch.equal(got, ehyb_stream.stream_body_plain(p, x, kahan))
    if stream_cells.split(p) and not (kahan and x.dtype == torch.float32):
        # the split form adds a hub block's chunks as partials (its own
        # order, held bit for bit in test_split_plan_sums_in_chunk_order);
        # the table form keeps the padded body's; the edge body's 80-step
        # row blocks are past the shipped SPLIT_STEPS
        assert case in ("nwin4_powerlaw", "edges") or \
            case.startswith("split_")
        table = stream_cells.build_stream_cells(e).to_torch()
        assert torch.equal(ehyb_stream.stream_body(table, x, kahan), want)
        assert rel(got.numpy(), want.numpy()) <= 1e-6
        np.testing.assert_array_equal(
            got.numpy(), _chunk_order_replay(plan, x.numpy(), kahan))
    else:
        # a float32 x with kahan sums whole rows in float64, split or not
        assert torch.equal(got, want)


@pytest.mark.parametrize("case,fixture,layout,wps,extra,kahan,poisson",
                         CASES, ids=IDS)
def test_plan_replay(case, fixture, layout, wps, extra, kahan, poisson,
                     request, monkeypatch):
    """Replay the plan: the compact cells are the body's real cells, each
    once, in step order per row, each index inside its piece's table and
    decoding to ``body_gather_index``'s column; every width is its piece's
    longest row; the tables are sorted, distinct and within 16 bits;
    a row block's pieces chain in order; and the kernel's walk (every
    rows-per-thread, a few warp counts) takes every row block and so
    every cell once (a plan in the split form: its work items every piece
    once).  A Poisson body's compact cells are within 1.1x its nnz."""
    extra = _split_steps(extra, monkeypatch)
    e = _artifact(request, fixture, layout, wps, extra)
    plan = _body_plan(e)
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
    cell_piece, row, k, col, val, lane = _replay(plan)
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
    np.add.at(count, (cell_piece[real], lane[real]), 1)
    kmax = np.full((n_p, 32), -1)
    np.maximum.at(kmax, (cell_piece[real], lane[real]), k[real])
    np.testing.assert_array_equal(kmax, count - 1)
    np.testing.assert_array_equal(count.max(1), np.diff(piece[:, 0]) // 32)
    # tables: sorted, distinct, within 16 bits
    for q in range(n_p):
        t = plan.rows[piece[q, 1]:piece[q + 1, 1]]
        assert t.size <= MAX and np.all(np.diff(t) > 0)
    # the split variant's walk over the work items covers every piece once
    if stream_cells.split(plan):
        seen = np.zeros(n_p, np.int64)
        for q0, n, _, _ in plan.item:
            q = q0
            for _ in range(n):
                seen[q] += 1
                q = piece[q, stream_cells.PIECE_NEXT]
        assert np.all(seen == 1)
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
    # every body row is written once: the row map, where the plan has one,
    # is a permutation of the body's rows
    if plan.row_map.size:
        np.testing.assert_array_equal(np.sort(plan.row_map),
                                      np.arange(n_rb * 32))
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
    _, row, _, col, val, _ = _replay(plan)
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


def test_f64_neumaier_keeps_the_cancelled_row(monkeypatch):
    """On a row of ±1e17 blocks and 100 ones (x all ones) the f64 plain
    version with compensation gives the body row's exact sum (math.fsum
    over its entries), as the padded body's compensated plain version
    does, where the uncompensated f64 sum loses it; so does the split
    form's, its row block in chunks of 4 steps (each chunk's pair, then
    their fold)."""
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
    _patch_split(monkeypatch, 4)
    plan = _body_plan(e)
    assert r0 // 32 in plan.chunk_rb
    q = plan.to_torch()
    assert float(ehyb_stream.stream_body(q, x, True)[r0]) == exact
    assert float(ehyb_stream.stream_body(q, x, False)[r0]) != exact


def test_f32_compensated_split_keeps_the_cancelled_row(monkeypatch):
    """On a row of ±1e8 blocks and 100 ones (x all ones) a float32 split
    plan's compensated plain version (float64 sums, rounded once) gives
    the body row's exact sum (99: the diagonal 1 goes to the DIA part) and
    the plain float32 one loses it, its row block in chunks of
    ``SPLIT_STEPS`` or of 4 steps."""
    cfg = config_for(PORT, True, "sell_rx", 2)
    _, r, e = host_pipeline(PORT, cancellation_matrix(PORT), cfg)
    r0 = int(r.old_to_new[0])
    x = torch.ones(e.padded_x_rows)
    for steps in (stream_cells.SPLIT_STEPS, 4):
        _patch_split(monkeypatch, steps)
        plan = _body_plan(e)
        assert r0 // 32 in plan.chunk_rb
        p = plan.to_torch()
        assert float(ehyb_stream.stream_body(p, x, True)[r0]) == 99.0
        assert float(ehyb_stream.stream_body(p, x, False)[r0]) != 99.0


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


def _cells_by_row(plan):
    """(body row, place in the row over its pieces, x column, value) of
    every real cell, sorted by row and place."""
    cell_piece, row, k, col, val, _ = _replay(plan)
    piece = plan.piece.astype(np.int64)
    width = np.diff(piece[:, 0]) // 32
    # a piece's first place in its row: the widths of its earlier pieces
    first = np.zeros(len(width), np.int64)
    for chain in _chains(plan):
        first[chain] = np.cumsum(width[chain]) - width[chain]
    place = first[cell_piece] + k
    real = val != 0
    o = np.lexsort((place[real], row[real]))
    return row[real][o], col[real][o], val[real][o]


@pytest.mark.parametrize("group_rows", [32, 128, 512, 2048])
def test_grouped_plan_writes_every_row_once(group_rows, scrambled):
    """The precision mode's scrambled body grouped in parts of 32 to 2,048
    rows: the row map is a permutation and the kernel's walk writes every
    body row exactly once; each real cell keeps its row, value and global
    column (``decode_columns`` of its step) in the same order as the table
    form's; the plain version equals the table form's bit for bit, plain
    and Kahan."""
    e = _dword(scrambled)
    table = stream_cells.build_stream_cells(e)
    plan = stream_cells.build_stream_cells(
        e, direct_below=stream_cells.DIRECT_BELOW, group_rows=group_rows)
    st = plan.stats
    assert st["grouped"] and st["direct_pieces"] > 0
    assert st["sectors_per_rb"][1] < st["sectors_per_rb"][0]
    n = plan.n_rb * 32
    np.testing.assert_array_equal(np.sort(plan.row_map), np.arange(n))
    for v in ehyb_stream.BUILT_ROWS:
        written = np.zeros(n, np.int64)
        for _, rb in _walk(plan.n_rb, v, 5):
            written[plan.row_map[rb * 32:rb * 32 + 32]] += 1
        assert np.all(written == 1)
    # the table form's cells against the decoded body, then both forms
    offs = e.slice_offset.astype(np.int64)
    st_, ln = np.nonzero(e.ell_val[:offs[-1]] != 0)
    step_slice = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    want_row = step_slice[st_] * 128 + ln
    want_col = stream_cells.decode_columns(e, 0, int(offs[-1]))[st_, ln]
    o = np.lexsort((st_, want_row))
    rows_t, cols_t, vals_t = _cells_by_row(table)
    np.testing.assert_array_equal(rows_t, want_row[o])
    np.testing.assert_array_equal(cols_t, want_col[o])
    for got, want in zip(_cells_by_row(plan), (rows_t, cols_t, vals_t)):
        np.testing.assert_array_equal(got, want)
    x = _x(e)
    for kahan in (False, True):
        assert torch.equal(
            ehyb_stream.stream_body_plain(plan.to_torch(), x, kahan),
            ehyb_stream.stream_body_plain(table.to_torch(), x, kahan))


def test_grouped_plan_decodes_the_body_once(scrambled, monkeypatch):
    """Where a float64 plan weighs a grouping, the builder decodes each
    span of slices once (the weigh takes the first pass's cells), and the
    grouped plan does not depend on the spans."""
    e = _dword(scrambled)
    opts = dict(direct_below=stream_cells.DIRECT_BELOW,
                group_rows=stream_cells.GROUP_ROWS)
    want = stream_cells.build_stream_cells(e, **opts)
    calls = []
    decode = stream_cells._decode
    monkeypatch.setattr(stream_cells, "_decode",
                        lambda *a: calls.append(a[1:3]) or decode(*a))
    monkeypatch.setattr(stream_cells, "_CHUNK_STEPS", 64)
    got = stream_cells.build_stream_cells(e, **opts)
    assert got.stats["grouped"] and len(calls) > 1
    assert len(set(calls)) == len(calls)
    _same_plans(got, want)


def _dense_start_matrix(n: int = 8192, per_row: int = 8, dense: int = 512):
    """A body whose first ``dense`` rows keep each row block's cells in one
    x row and whose other rows are scattered over all of x: its first
    spans are not scattered, the whole body is."""
    rng = np.random.default_rng(12)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.concatenate([
        (r // 32 % (n // 128)) * 128 + rng.choice(128, per_row, False)
        if r < dense else rng.choice(n, per_row, False) for r in range(n)])
    return port.MatrixCOO(n, n, rows.astype(np.int32),
                          cols.astype(np.int32),
                          rng.standard_normal(rows.size).astype(np.float32))


def test_grouped_plan_decodes_again_after_a_dense_start(monkeypatch):
    """Where the first spans are not scattered, the builder drops their
    decoded cells; where the whole body is scattered after all, it decodes
    every span again for the weigh, and the plan is the one built from
    whole spans, byte for byte."""
    e = port.EhybSpmv(port.EhybConfig(
        dword_values=True, artifact_cache=False), device="cpu").setup(
        _dense_start_matrix()).ehyb
    opts = dict(direct_below=stream_cells.DIRECT_BELOW,
                group_rows=stream_cells.GROUP_ROWS)
    want = stream_cells.build_stream_cells(e, **opts)
    calls, real, keys = [], [], []
    decode, units = stream_cells._decode, stream_cells._units

    def count_units(*a):
        u = units(*a)
        real.append(a[5].size)
        keys.append(u[-1])
        return u

    monkeypatch.setattr(stream_cells, "_decode",
                        lambda *a: calls.append(a[1:3]) or decode(*a))
    monkeypatch.setattr(stream_cells, "_units", count_units)
    monkeypatch.setattr(stream_cells, "_CHUNK_STEPS", 1)
    got = stream_cells.build_stream_cells(e, **opts)
    n_spans = len(set(calls))
    assert real[0] >= stream_cells.DIRECT_BELOW * keys[0]
    assert sum(real[:n_spans]) < stream_cells.DIRECT_BELOW * sum(
        keys[:n_spans])
    assert n_spans > 1 and len(calls) == 2 * n_spans
    assert got.stats["sectors_per_rb"] is not None
    _same_plans(got, want)


def test_mixed_plan_decodes_like_the_table_form():
    """On the edge body in f64 the shipped plan holds pieces with and
    without a table (cut row blocks, an empty one, a ragged slice): every
    real cell decodes to the table form's column, row and value in the
    same order, the direct pieces' columns stay inside x, and the index
    arrays hold every cell."""
    e = _edge_f64()
    table = stream_cells.build_stream_cells(e)
    plan = _body_plan(e)
    st = plan.stats
    width = np.diff(plan.piece[:, 0])
    empty = int((width == 0).sum())
    assert 0 < st["direct_pieces"] < st["n_pieces"] - empty
    assert not st["grouped"] and plan.row_map.size == 0
    assert plan.cell_idx.size == plan.cell_col.size == st["compact_cells"]
    assert plan.cell_col.max() < e.padded_x_rows
    cells = np.diff(plan.piece[:, 0])
    assert st["direct_cells"] == cells[np.diff(plan.piece[:, 1]) == 0].sum()
    for got, want in zip(_cells_by_row(plan), _cells_by_row(table)):
        np.testing.assert_array_equal(got, want)


def test_f64_flagship_plan_keeps_the_table_form(scrambled):
    """The flagship layout in float64 reads many cells a table row: its
    plan keeps the 16-bit table form in the body's row order (no direct
    piece, no row map, no grouping weighed), byte for byte the plan the
    table form builds; float32 plans never take the options."""
    cfg = config_for(PORT, True, "sell_rx", 2, dtype="float64")
    e = host_pipeline(PORT, coo_for(PORT, scrambled), cfg)[2]
    assert e.ell_val.dtype == np.float64
    plan, table = _body_plan(e), stream_cells.build_stream_cells(e)
    st = plan.stats
    assert st["real_cells"] >= stream_cells.DIRECT_BELOW * st["table_rows"]
    assert st["direct_pieces"] == 0 and not st["grouped"]
    assert st["sectors_per_rb"] is None
    assert plan.row_map.size == 0 and plan.cell_col.size == 0
    for f in ("piece", "rows", "cell_val", "cell_idx"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(table, f))
    e32 = _artifact(None, "edges", None, 0, {})
    p32 = _body_plan(e32)
    assert p32.stats["direct_pieces"] == 0 and p32.cell_col.size == 0


def test_wrapper_refuses_what_the_kernels_do_not_read(scrambled):
    """A float32 plan with direct pieces or a row map is refused before
    any build.  A row-block list over a grouped plan names the plan's row
    blocks, whose rows are written through the row map (the float64 list
    kernel reads the map: a sharded float64 plan may be grouped); a list
    of work items over it (a plan in the table form) is refused."""
    e32 = edge_body()
    bad = stream_cells.build_stream_cells(e32, direct_below=8.0).to_torch()
    x32 = torch.zeros(e32.padded_x_rows)
    with pytest.raises(ValueError, match="table form only"):
        ehyb_stream._check(bad, x32)
    grouped = _body_plan(_dword(scrambled))
    assert grouped.stats["grouped"] and not stream_cells.split(grouped)
    p = grouped.to_torch()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        p.stats["x_rows"]))
    full = ehyb_stream.stream_body(p, x)
    lst = torch.tensor([0, p.n_rb - 1], dtype=torch.int32)
    rows = p.row_map.long()[(lst.long()[:, None] * 32
                             + torch.arange(32)).reshape(-1)]
    other = torch.ones_like(full, dtype=torch.bool)
    other[rows] = False
    for fn in (ehyb_stream.stream_body, ehyb_stream.stream_body_plain):
        y = torch.full_like(full, -1.0)
        fn(p, x, rb_list=lst, out=y)
        assert torch.equal(y[rows], full[rows])
        assert bool((y[other] == -1.0).all())
        with pytest.raises(ValueError, match="row-block list"):
            fn(p, x, rb_list=torch.zeros((1, 4), dtype=torch.int32))


# --- the split form (heavy-tailed bodies) ---------------------------------

# (case, body, SPLIT_STEPS patched in)
SPLIT_CASES = [("long4", "long", 4), ("long32", "long", 32),
               ("long128", "long", 128), ("powerlaw4", "powerlaw_small", 4),
               ("powerlaw16", "powerlaw_small", 16),
               # float64: table pieces, direct pieces, grouped rows
               ("f64_powerlaw4", "powerlaw_f64", 4),
               ("f64_long32", "long_f64", 32),
               ("dword_grouped2", "scrambled_dword", 2)]
SPLIT_IDS = [c[0] for c in SPLIT_CASES]


#: The split cases' bodies: (fixture, layout, windows per sub-tile, extra).
SPLIT_BODIES = {"long": ("long", None, 0, {}),
                "long_f64": ("long_f64", None, 0, {}),
                "powerlaw_small": ("powerlaw_small", "sell_rx", 4, {}),
                "powerlaw_f64": ("powerlaw_small", "sell_rx", 4,
                                 {"dtype": "float64"}),
                "scrambled_dword": ("scrambled", "dword", 0, {})}


def _split_plan(request, body, steps, monkeypatch):
    """The body's artifact and its K1 plan with every split threshold and
    chunk length at ``steps``."""
    _patch_split(monkeypatch, steps)
    e = _artifact(request, *SPLIT_BODIES[body])
    return e, _body_plan(e)


def _k1_options(e) -> dict:
    """``stream_cells.k1_options`` for ``e``'s value type but the split
    form's."""
    if e.ell_val.dtype == np.float64:
        return dict(direct_below=stream_cells.DIRECT_BELOW,
                    group_rows=stream_cells.GROUP_ROWS)
    return {}


def _item_pieces(plan, it):
    """The pieces work item ``it`` walks, in order."""
    out, q = [], int(it[stream_cells.ITEM_PIECE])
    for _ in range(int(it[stream_cells.ITEM_PIECES])):
        out.append(q)
        q = int(plan.piece[q, stream_cells.PIECE_NEXT])
    return out


def _neumaier(s, c, v):
    """One Neumaier step in numpy, in the arrays' type."""
    t = s + v
    return t, c + np.where(np.abs(s) >= np.abs(v), (s - t) + v, (v - t) + s)


def _chunk_order_replay(plan, x: np.ndarray, kahan: bool = False):
    """The split variants' sums in numpy, in the plan's value type: each
    work item's rows over its pieces' cells in order from 0 (with ``kahan``
    as (sum, compensation) pairs under Neumaier's step), into y or its slot
    of partials; then each chunked row block's partials in chunk order from
    0 (with ``kahan`` the fold of ``csrc/ehyb_stream.cu``), into y, through
    the row map where the plan has one."""
    dt = plan.cell_val.dtype
    piece = plan.piece.astype(np.int64)
    y = np.zeros(plan.n_rb * 32, dt)
    part = np.zeros((int(plan.chunk_first[-1]), 2, 32), dt)
    for it in plan.item:
        s, c = np.zeros(32, dt), np.zeros(32, dt)
        for q in _item_pieces(plan, it):
            a, b = piece[q], piece[q + 1]
            for k in range(a[0], b[0], 32):
                if a[1] == b[1]:
                    col = plan.cell_col[k:k + 32].astype(np.int64)
                else:
                    idx = plan.cell_idx[k:k + 32].view(np.uint16).astype(
                        np.int64)
                    col = plan.rows[a[1] + (idx >> 7)].astype(np.int64) \
                        * 128 + (idx & 127)
                v = plan.cell_val[k:k + 32] * x[col]
                if kahan:
                    s, c = _neumaier(s, c, v)
                else:
                    s = s + v
        rb, slot = piece[it[0], stream_cells.PIECE_RB], it[2]
        if slot < 0:
            y[rb * 32:rb * 32 + 32] = s + c if kahan else s
        else:
            part[slot] = s, c
    for i, rb in enumerate(plan.chunk_rb):
        t, tc = np.zeros(32, dt), np.zeros(32, dt)
        for slot in range(plan.chunk_first[i], plan.chunk_first[i + 1]):
            if kahan:
                t, tc = _neumaier(t, tc, part[slot, 0])
                tc = tc + part[slot, 1]
            else:
                t = t + part[slot, 0]
        y[rb * 32:rb * 32 + 32] = t + tc if kahan else t
    if plan.row_map.size:
        out = np.empty_like(y)
        out[plan.row_map] = y
        y = out
    return y


@pytest.mark.parametrize("case,body,steps", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_plan_work_items(case, body, steps, request, monkeypatch):
    """The split form at SPLIT_STEPS = ``steps``: exactly the row blocks
    wider than it are chunked, every work item walks at most ``steps``
    steps, the items come longest first and walk every piece once, a
    chunked row block's slots follow its chain, and K1's plan is the builder
    with ``split_steps``.  The long body reaches a row block exactly at the
    limit (kept whole), one just past it (two chunks), empty rows, a hub in
    the last row block and chunks that end inside a piece chain; a
    heavy-tailed body in the relaxed layout a chunk of several pieces.  In
    float64 the chunks are of table pieces (the flagship layout), of direct
    pieces (the long body) and of a grouped plan's row blocks, written
    through its row map (the precision mode's scrambled body)."""
    e, plan = _split_plan(request, body, steps, monkeypatch)
    built = stream_cells.build_stream_cells(e, split_steps=steps,
                                            **_k1_options(e))
    for f in ("piece", "rows", "cell_val", "cell_idx", "cell_col", "row_map",
              "item", "chunk_first", "chunk_rb", "piece_slot", "hub_val",
              "hub_col", "hub_cell", "hub_first", "hub_row", "hub_item"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(built, f))
    assert stream_cells.split(plan)
    piece = plan.piece.astype(np.int64)
    width = np.diff(piece[:, 0]) // 32
    rb_width = np.bincount(piece[:-1, stream_cells.PIECE_RB], weights=width,
                           minlength=plan.n_rb)
    np.testing.assert_array_equal(plan.chunk_rb,
                                  np.flatnonzero(rb_width > steps))
    steps_of = [int(width[_item_pieces(plan, it)].sum()) for it in plan.item]
    assert max(steps_of) == plan.stats["max_item_steps"] <= steps
    assert steps_of == sorted(steps_of, reverse=True)
    seen = np.zeros(len(width), np.int64)
    ends_inside = multi = 0
    for it in plan.item:
        qs = _item_pieces(plan, it)
        seen[qs] += 1
        np.testing.assert_array_equal(plan.piece_slot[qs], it[2])
        assert (it[2] < 0) == (it[3] < 0)
        if it[2] < 0:      # a whole row block: its main piece, all its chain
            assert it[0] < plan.n_rb and piece[qs[-1], 2] == -1
        else:
            ends_inside += int(piece[qs[-1], 2] >= 0)
            multi += int(len(qs) > 1)
    assert np.all(seen == 1)
    for i, rb in enumerate(plan.chunk_rb):
        chain = [q for q in range(len(width))
                 if piece[q, stream_cells.PIECE_RB] == rb]
        slots = plan.piece_slot[chain]
        np.testing.assert_array_equal(np.unique(slots), np.arange(
            plan.chunk_first[i], plan.chunk_first[i + 1]))
        assert np.all(np.diff(slots) >= 0)
    st = plan.stats
    assert st["chunked_rbs"] == plan.chunk_rb.size and st["n_chunks"] == \
        plan.chunk_first[-1] and st["n_items"] == len(plan.item) == \
        plan.n_rb + st["n_chunks"] - st["chunked_rbs"]
    assert ends_inside >= 1
    # the pieces of the chunked row blocks: with and without a table
    chunked_pieces = np.flatnonzero(plan.piece_slot >= 0)
    tables = np.diff(piece[:, 1])[chunked_pieces]
    cells = np.diff(piece[:, 0])[chunked_pieces]
    assert plan.row_map.size == (body == "scrambled_dword") * plan.n_rb * 32
    f64 = e.ell_val.dtype == np.float64
    assert np.any((tables == 0) & (cells > 0)) == f64
    assert np.any(tables > 0) or body != "powerlaw_f64"
    if body.startswith("long"):
        assert rb_width[0] == steps and 0 not in plan.chunk_rb
        assert 1 in plan.chunk_rb and plan.chunk_first[1] == 2
        assert rb_width[2] == 0 and plan.n_rb - 1 in plan.chunk_rb
        hub = plan.n_rb - 1
        hub_pieces = np.flatnonzero(piece[:-1, stream_cells.PIECE_RB] == hub)
        tables = np.diff(piece[:, 1])[hub_pieces]
        if steps == 128:   # its chain is cut for the 16-bit range too
            assert tables.max() > stream_cells.MAX_TABLE_ROWS - 16
    elif body.startswith("powerlaw"):
        assert multi >= 1


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
@pytest.mark.parametrize("case,body,steps", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_plan_sums_in_chunk_order(case, body, steps, kahan, request,
                                        monkeypatch):
    """The plain version of a split plan adds each chunk's products from 0
    in cell order and a chunked row block's partials in chunk order: bit
    for bit a numpy replay of that order, and within 1e-6 of the padded
    body's plain version; in float64 with ``kahan`` each chunk's
    (sum, compensation) pairs under Neumaier's step, then the kernel's fold
    of the pairs in chunk order, bit for bit the replay; in float32 with
    ``kahan`` the table form's float64 sums rounded once.  The wrapper on a
    CPU tensor is the plain version and counts no launch."""
    e, plan = _split_plan(request, body, steps, monkeypatch)
    p = plan.to_torch()
    x = _x(e)
    launches = ehyb_stream.stream_body.launches
    got = ehyb_stream.stream_body(p, x, kahan)
    assert ehyb_stream.stream_body.launches == launches
    if kahan and x.dtype == torch.float32:
        table = stream_cells.build_stream_cells(e, **_k1_options(e))
        assert torch.equal(got, ehyb_stream.stream_body(table.to_torch(), x,
                                                        True))
    else:
        np.testing.assert_array_equal(
            got.numpy(), _chunk_order_replay(plan, x.numpy(), kahan))
    # (float64 without compensation: a hub row costs the compensated plain
    # version a pass a place)
    want = ehyb_body(e.to_torch(), x,
                     compensated=kahan and x.dtype == torch.float32)
    assert rel(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("steps", [4, 16])
def test_split_apply_matches_jax_and_oracle(steps, powerlaw_small,
                                            monkeypatch):
    """The flagship's apply over a split plan of the JAX host layer's
    artifact (powerlaw_small in the relaxed layout) against the JAX
    package's XLA apply of the same artifact and the exact-f64 oracle of
    the reordered matrix, at rel 5e-6."""
    from ehyb_spmv_gpu_tpu.ops import xla_ops
    import jax.numpy as jnp

    from test_torch_parity import REF, port_from_ref

    monkeypatch.setattr(stream_cells, "SPLIT_STEPS", steps)
    cfg = config_for(REF, True, "sell_rx", 4)
    _, r, e_ref = host_pipeline(REF, powerlaw_small, cfg)
    e_pt = port_from_ref(e_ref)
    apply = ehyb_stream.make_stream_apply(e_pt, e_pt.to_torch())
    assert stream_cells.split(apply.cells)
    dim = powerlaw_small.dimension
    x = np.zeros(e_ref.padded_x_rows, np.float32)
    x[:dim] = np.random.default_rng(1).standard_normal(dim)
    got = apply(torch.from_numpy(x)).numpy()
    want = np.asarray(xla_ops.ehyb_apply_xla(e_ref.to_jax(), jnp.asarray(x)))
    assert rel(got, body_rows(got, want)) <= ORACLE_TOL
    m_perm = r.apply_to_matrix(coo_for(REF, powerlaw_small))
    assert rel(got[:dim], oracle_spmv(m_perm, x[:dim].astype(np.float64))) \
        <= ORACLE_TOL


#: The configs a heavy-tailed body meets besides plain float32 and the
#: precision mode (``tests/test_torch_dword.py``): the JAX package's
#: ``dtype="float64"`` computes in float32 (no x64), so it is held to the
#: suite's bound there, the port to the oracle at 1e-12 in float64.
HEAVY_CONFIGS = {"f64": dict(dtype="float64"),
                 "f64_compensated": dict(dtype="float64",
                                         compensated_sum=True),
                 "compensated": dict(compensated_sum=True)}


@pytest.mark.parametrize("config", sorted(HEAVY_CONFIGS))
def test_heavy_tail_configs_match_jax_and_oracle(config, powerlaw_small):
    """powerlaw_small through ``EhybSpmv`` in float64, float64 compensated
    and float32 compensated: K1's plan as shipped takes the split form;
    the product within 5e-6 of the JAX package's model and of the
    exact-f64 oracle, and in float64 within 1e-12 of the oracle."""
    from test_torch_parity import REF
    import ehyb_spmv_gpu_tpu as ref

    kw = dict(artifact_cache=False, **HEAVY_CONFIGS[config])
    m = powerlaw_small
    model = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(
        coo_for(PORT, m))
    cells = model.module.cells
    assert stream_cells.split(cells) and cells.stats["n_items"] > 0
    x = deterministic_x(m.dimension)
    got = model.matvec(x)
    want = oracle_spmv(m, x)
    f64 = kw.get("dtype") == "float64"
    assert rel(got, want) <= (1e-12 if f64 else ORACLE_TOL)
    jmodel = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(coo_for(REF, m))
    assert rel(got, jmodel.matvec(x)) <= ORACLE_TOL


FLOAT_CASES = [c for c in CASES if c[0] in (
    "nwin1", "nwin2", "nwin4", "hub_split", "int32", "kahan", "edges",
    "edges_kahan", "dword_grouped", "edges_f64_mixed",
    "edges_f64_mixed_kahan", "f64_flagship")]


def _widest_row_block(plan) -> int:
    """The widest row block of ``plan``: the sum of its pieces' widths."""
    piece = plan.piece.astype(np.int64)
    return int(np.bincount(piece[:-1, stream_cells.PIECE_RB],
                           weights=np.diff(piece[:, 0]) // 32).max())


def _parent_units(rb, lane, k, step, col, val, n_rb, n_xrows, direct_below,
                  split_steps=0):
    """``stream_cells._units`` as it was before the split form: a row block
    past the 16-bit range cut step by step (``_greedy_cut``), and a row's
    rank restarted in each piece by a loop over the pieces; with
    ``split_steps`` the split form's cut (a row block wider than that cut
    at most that many steps a piece) by the same step-by-step cut and
    loop."""
    LANES, ROWS = stream_cells.LANES, stream_cells.BLOCK_ROWS
    xrow = col >> 7
    ukey = np.unique(rb * n_xrows + xrow)
    n_distinct = np.bincount(ukey // n_xrows, minlength=n_rb)
    unit = rb.copy()
    extra_rb = []
    over = np.flatnonzero(n_distinct > MAX)
    order = np.argsort(rb, kind="stable")
    starts = np.searchsorted(rb[order], np.arange(n_rb), side="left")
    ends = np.searchsorted(rb[order], np.arange(n_rb), side="right")
    max_steps = {r: 0 for r in over.tolist()}
    if split_steps:
        for r in range(n_rb):
            cells = order[starts[r]:ends[r]]
            pc = _greedy_cut(step[cells], xrow[cells], 0)
            rows_ = lane[cells] % ROWS
            width = sum(np.bincount(rows_[pc == q], minlength=ROWS).max()
                        for q in range(int(pc.max()) + 1)) if cells.size \
                else 0
            if width > split_steps:
                max_steps[r] = split_steps
    for r in sorted(max_steps):
        cells = order[starts[r]:ends[r]]
        pc = _greedy_cut(step[cells], xrow[cells], max_steps[r])
        row = lane[cells] % ROWS
        first = np.zeros(cells.size, np.int64)
        for p in range(1, int(pc.max()) + 1):
            in_p = pc == p
            before = np.bincount(row[pc < p], minlength=ROWS)
            first[in_p] = before[row[in_p]]
        k[cells] -= first
        unit[cells] = np.where(pc == 0, r, n_rb + len(extra_rb) + pc - 1)
        extra_rb += [r] * int(pc.max())
    n_units = n_rb + len(extra_rb)
    row_cells = np.bincount(unit * ROWS + lane % ROWS,
                            minlength=n_units * ROWS)
    width = row_cells.reshape(n_units, ROWS).max(axis=1)
    start = np.zeros(n_units + 1, np.int64)
    np.cumsum(width * ROWS, out=start[1:])
    pos = start[unit] + k * ROWS + lane % ROWS
    key, inv = np.unique(unit * n_xrows + xrow, return_inverse=True)
    inv = inv.reshape(-1)
    key_unit = key // n_xrows
    t_size = np.bincount(key_unit, minlength=n_units)
    direct = (width > 0) & (width * ROWS
                            < direct_below * np.maximum(t_size, 1))
    t_size[direct] = 0
    in_table = ~direct[key_unit]
    t_start = np.zeros(n_units + 1, np.int64)
    np.cumsum(t_size, out=t_start[1:])
    slot = (np.cumsum(in_table) - 1)[inv] - t_start[unit]
    cell_val = np.zeros(int(start[-1]), val.dtype)
    cell_val[pos] = val
    cell_idx = np.zeros(int(start[-1]), np.uint16)
    tab = ~direct[unit]
    cell_idx[pos[tab]] = slot[tab] * LANES + (col[tab] & (LANES - 1))
    cell_col = None
    if direct.any():
        cell_col = np.zeros(int(start[-1]), np.int64)
        cell_col[pos[~tab]] = col[~tab]
    return (width, t_size, key[in_table] % n_xrows, cell_val, cell_idx,
            cell_col, direct, np.asarray(extra_rb, np.int64), int(key.size))


def _same_plans(a, b) -> None:
    """Plans ``a`` and ``b`` byte for byte, and their stats."""
    for f in ("piece", "rows", "cell_val", "cell_idx", "cell_col", "row_map",
              "item", "chunk_first", "chunk_rb", "piece_slot", "hub_val",
              "hub_col", "hub_cell", "hub_first", "hub_row", "hub_item"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert a.stats == b.stats


@pytest.mark.parametrize("case,fixture,layout,wps,extra,kahan,poisson",
                         FLOAT_CASES, ids=[c[0] for c in FLOAT_CASES])
def test_float_plans_unchanged_by_the_split_form(case, fixture, layout, wps,
                                                 extra, kahan, poisson,
                                                 request, monkeypatch):
    """The fixtures with no row block wider than the split form's threshold
    for their type (SPLIT_STEPS in float32, SPLIT_STEPS_F64 in float64;
    compensated or not: the plan does not depend on it) get from K1's plan,
    as shipped, the plan the builder made before the split form
    (``_parent_units``: the step-by-step cut and the per-piece rank loop;
    in float64 with direct pieces and the grouping weighed), byte for byte.
    The edge body's row blocks reach that cut and that rank restart; being
    80 steps wide, past SPLIT_STEPS, they are split by K1's plan in float32,
    so there the builder's table form (no split_steps) is held to it (so is
    any fixture wider than its threshold that K1's plan splits)."""
    e = _artifact(request, fixture, layout, wps, extra)
    plan = _body_plan(e)
    opts = _k1_options(e)
    with monkeypatch.context() as mp:
        mp.setattr(stream_cells, "_units", _parent_units)
        parent = stream_cells.build_stream_cells(e, **opts)
    limit = stream_cells.SPLIT_STEPS_F64 if opts else stream_cells.SPLIT_STEPS
    wide = _widest_row_block(parent) > limit
    assert wide == (fixture in ("edges", "cancellation"))
    assert stream_cells.split(plan) == wide
    if not wide:
        # the small form's options leave a plan that is not split as it is
        _same_plans(stream_cells.build_stream_cells(
            e, **stream_cells.k1_options(e)), plan)
    if stream_cells.split(plan):
        plan = stream_cells.build_stream_cells(e)
    assert not stream_cells.split(plan) and plan.stats["chunked_rbs"] == 0
    if fixture.startswith("edges"):
        assert parent.stats["split_rbs"] > 0
    plan.stats.pop("split_steps")
    parent.stats.pop("split_steps")
    _same_plans(plan, parent)


@pytest.mark.parametrize("case,body,steps", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_plans_keep_the_old_rank_loop(case, body, steps, request,
                                            monkeypatch):
    """The split form's cut and rank restart in ``_units`` (numpy over
    doubling windows, one argsort for every cut row block's ranks) give
    the plan that the step-by-step cut and the per-piece rank loop give
    (``_parent_units`` with the same thresholds), byte for byte, in float32
    and float64, grouped or not."""
    e, plan = _split_plan(request, body, steps, monkeypatch)
    with monkeypatch.context() as mp:
        mp.setattr(stream_cells, "_units", _parent_units)
        parent = _body_plan(e)
    assert stream_cells.split(plan)
    _same_plans(plan, parent)


def test_wrapper_refuses_split_plans_it_cannot_read():
    """A plan in the split form is read by the split variants at one row a
    thread with x through L1/L2, in float32 and float64, plain or Kahan,
    with or without a list of its work items: with a row-block list, at
    another rows-per-thread and with x staged, the wrapper raises (on the
    CPU too, before any build); every value type and Kahan passes its
    checks, and the compensated plan is the plain one."""
    e = long_body(4)
    p = stream_cells.build_stream_cells(e, split_steps=4).to_torch()
    x = torch.zeros(e.padded_x_rows)
    lst = torch.arange(2, dtype=torch.int32)
    for fn in (ehyb_stream.stream_body, ehyb_stream.stream_body_plain,
               ehyb_stream._launch):
        with pytest.raises(ValueError, match="split form.*row-block list"):
            fn(p, x, rb_list=lst)
    e64 = long_body(4)
    e64.ell_val = e64.ell_val.astype(np.float64)
    p64 = stream_cells.build_stream_cells(e64, split_steps=4).to_torch()
    x64 = torch.zeros(e64.padded_x_rows, dtype=torch.float64)
    for q, xq in ((p, x), (p64, x64)):
        for kahan in (False, True):
            ehyb_stream._check(q, xq)
            ehyb_stream._check_split(q, None)
            ehyb_stream._check_split(q, q.item)
            ehyb_stream.check_built(ehyb_stream.SPLIT_GEOMETRY, xq.dtype,
                                    True)
            assert ehyb_stream.stream_body(q, xq, kahan).dtype == xq.dtype
    with pytest.raises(ValueError, match="no split K1.*rows=2"):
        ehyb_stream._launch(p, x, geometry=ehyb_stream.StreamGeometry(rows=2))
    with pytest.raises(ValueError, match="no split K1.*x_mode='staged'"):
        ehyb_stream._launch(p, x, geometry=ehyb_stream.StreamGeometry(
            x_mode="staged"))
    wide = long_body(stream_cells.SPLIT_STEPS)
    assert stream_cells.split(_body_plan(wide))
    assert p.partial.numel() == 2 * p.n_chunks * 32


def test_split_form_takes_spans_with_no_cells(monkeypatch):
    """The builder decodes the body a span of slices at a time; where a
    span holds no cell (a run of empty slices, as a degree split's dense
    sub-matrix has), the split form is built all the same, and the plan
    does not depend on the spans."""
    e = long_body(4)
    n_empty = 6
    e.slice_offset = np.concatenate([e.slice_offset, np.full(
        n_empty, e.slice_offset[-1], np.int32)])
    e.slice_win_start = np.concatenate([e.slice_win_start, np.zeros(
        n_empty, np.int32)])
    e.dim = (len(e.slice_offset) - 1) * 128 * 512
    want = stream_cells.build_stream_cells(e, split_steps=4)
    monkeypatch.setattr(stream_cells, "_CHUNK_STEPS", 8)
    got = stream_cells.build_stream_cells(e, split_steps=4)
    assert got.n_rb == want.n_rb == 4 * (3 + n_empty)
    for f in ("piece", "rows", "cell_val", "cell_idx", "item", "chunk_first",
              "chunk_rb", "piece_slot"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    x = _x(e)
    np.testing.assert_array_equal(
        ehyb_stream.stream_body(got.to_torch(), x).numpy(),
        _chunk_order_replay(got, x.numpy()))


def _greedy_cut(step, xrow, max_steps):
    """The cut's definition, step by step: a piece closes before the step
    whose x rows take its table past 16 bits, or once it holds
    ``max_steps`` steps."""
    piece = np.zeros(step.size, np.int64)
    cur, n, held = set(), 0, 0
    bounds = np.flatnonzero(np.diff(step)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, step.size]):
        new = set(xrow[lo:hi].tolist())
        if cur and (len(cur | new) > MAX or held == max_steps):
            n, cur, held = n + 1, set(), 0
        cur |= new
        held += 1
        piece[lo:hi] = n
    return piece


@pytest.mark.parametrize("max_steps", [0, 1, 4, 96])
def test_cut_pieces_is_the_greedy_cut(max_steps):
    """``_cut_pieces`` (numpy over doubling windows of steps) cuts a row
    block where the step-by-step greedy cut does, on row blocks of 1 to
    32 cells a step over x ranges below and far past a table, one at a
    time and all of them in one call."""
    rng = np.random.default_rng(max_steps)
    blocks = []
    for n_x in (40, 600, 5000, 100000):
        n_st = int(rng.integers(200, 1500))
        step = np.repeat(np.sort(rng.choice(8 * n_st, n_st, replace=False)),
                         rng.integers(1, 33, n_st))
        xrow = rng.integers(0, n_x, step.size)
        want = _greedy_cut(step, xrow, max_steps)
        np.testing.assert_array_equal(
            stream_cells._cut_pieces(step, xrow, max_steps), want)
        blocks.append((step, xrow, want))
    step, xrow, want = (np.concatenate(a) for a in zip(*blocks))
    group = np.repeat(np.arange(len(blocks)), [b[0].size for b in blocks])
    np.testing.assert_array_equal(
        stream_cells._cut_pieces(step, xrow, max_steps, group), want)


#: The folded plan (``k1_folded_plan``: the body and the EHYB tail in one
#: plan) on small artifacts with a tail, in each form: (case, fixture,
#: config, build options (None: the shipped ``k1_folded_plan``), kahan,
#: the form the plan must take).  The fixtures: "scrambled" in the plain
#: windowed layout (1,024-row windows) has ER entries and one diagonal;
#: "dense_rows" (scrambled with three rows of 1,152 entries,
#: ``generate.with_dense_rows``) adds long rows, whose row blocks the tail
#: makes wide enough for the split form; "powerlaw_small" in the
#: flagship's relaxed layout with ``row_split_threshold=4`` has hub-split
#: overflow rows (and one ER entry).  "dword" is the precision mode's host
#: config with the same windows (f64 values).
FOLD_CASES = [
    ("f32_table", "scrambled", "f32", None, False, "table"),
    ("f32_split", "dense_rows", "f32", None, False, "split"),
    ("f32_hub_split", "powerlaw_small", "hub", None, False, "split"),
    ("f64_table", "scrambled", "f64", None, False, "table"),
    ("f64_direct_dword", "dense_rows", "dword", None, False,
     "split direct"),
    ("f64_grouped_dword", "scrambled", "dword",
     dict(direct_below=np.inf, group_rows=256), False, "grouped direct"),
    ("f64_split", "dense_rows", "f64", None, False, "split direct"),
    ("f64_kahan_split", "dense_rows", "f64", None, True, "split direct"),
    ("f64_kahan_grouped_split", "scrambled", "dword",
     dict(direct_below=np.inf, group_rows=256, split_steps=2), True,
     "grouped direct split"),
]


def _fold_config(kind: str, pkg: str = PORT):
    import importlib

    cfg = importlib.import_module(f"{pkg}.config")
    if kind == "hub":
        return config_for(pkg, True, "sell_rx", 2, row_split_threshold=4)
    if kind == "dword":
        return dataclasses.replace(
            cfg.EhybConfig(window_rows=1024), dtype="float64",
            row_split_threshold=0, relax_body="never")
    return cfg.EhybConfig(window_rows=1024, body_layout="sell",
                          dtype="float64" if kind == "f64" else "float32")


def _tail_entries(e):
    """Every body, ER and long-row entry of ``e`` as (true row, column,
    value), the hub-split overflow rows' entries under their true rows,
    and the count of those."""
    offs = e.slice_offset.astype(np.int64)
    n_steps = int(offs[-1])
    st, ln = np.nonzero(e.ell_val[:n_steps] != 0)
    row = np.repeat(np.arange(len(offs) - 1), np.diff(offs))[st] * 128 + ln
    col = body_gather_index(e.to_torch()).numpy()[st, ln]
    rmap = np.arange(len(offs) * 128)
    rmap[e.split_src] = e.split_dst
    er_offs = e.er_slice_offset.astype(np.int64)
    est, eln = np.nonzero(e.er_val[:int(er_offs[-1])] != 0)
    er_row = e.er_rows[np.repeat(np.arange(len(er_offs) - 1),
                                 np.diff(er_offs))[est] * 128 + eln]
    rows = np.concatenate([rmap[row], er_row, e.long_rows[e.long_seg]])
    cols = np.concatenate([col, e.er_col[est, eln], e.long_col])
    vals = np.concatenate([e.ell_val[st, ln], e.er_val[est, eln],
                           e.long_val])
    return rows.astype(np.int64), cols.astype(np.int64), vals, int(
        np.isin(row, e.split_src).sum())


@pytest.mark.parametrize("case,fixture,kind,opts,kahan,form", FOLD_CASES,
                         ids=[c[0] for c in FOLD_CASES])
def test_folded_plan_holds_the_tail(case, fixture, kind, opts, kahan, form,
                                    request):
    """The folded plan (1) holds every body, ER and long-row entry exactly
    once, the hub-split rows' entries under their true rows and nothing in
    the overflow rows; (2) walked by K1's plain version, then K9's plain
    version adding the diagonals into its y, gives ``combine_ehyb`` of the
    four phases (f32 rel <= 1e-6, f64 1e-14), with y the body's rows; and
    (3) the flagship's apply on it matches the JAX package's
    ``ehyb_apply_xla`` of the same artifact at rel <= 2e-6 in f32, and the
    exact-f64 oracle of the reordered matrix at 1e-12 in f64."""
    from ehyb_spmv_gpu_tpu.ops import xla_ops
    import jax.numpy as jnp

    from ehyb_spmv_torch.ops import dia
    from ehyb_spmv_torch.ops.torch_ops import combine_ehyb, ehyb_er, ehyb_long
    from test_torch_parity import REF, port_from_ref

    m = request.getfixturevalue("scrambled" if fixture == "dense_rows"
                                else fixture)
    if fixture == "dense_rows":
        m = generate.with_dense_rows(m, 3, 0.5)
    f64 = kind != "f32" and kind != "hub"
    if f64:
        _, r, e = host_pipeline(PORT, m, _fold_config(kind))
    else:
        _, r, e_ref = host_pipeline(REF, m, _fold_config(kind, REF))
        e = port_from_ref(e_ref)
    st = e.stats
    assert st["nnz_er"] > 0 and (st["nnz_long"] > 0) == (
        fixture == "dense_rows") and bool(e.split_src.size) == (
        kind == "hub") and (st["nnz_dia"] > 0) == (fixture != "powerlaw_small")
    plan = stream_cells.k1_folded_plan(e) if opts is None else \
        stream_cells.build_stream_cells(e, fold=True, **dict(
            stream_cells.k1_options(e), **opts))
    pst = plan.stats
    assert pst["folded"] and ("split" in form) == stream_cells.split(plan)
    assert ("direct" in form) == (pst["direct_pieces"] > 0)
    assert ("grouped" in form) == pst["grouped"]
    # (1) every entry once, each where it belongs
    row, col, val = _entries(plan)
    real = val != 0
    n_all = st["nnz_ell"] + st["nnz_er"] + st["nnz_long"]
    assert real.sum() == pst["real_cells"] == n_all
    want_r, want_c, want_v, n_moved = _tail_entries(e)
    assert pst["tail_cells"] == st["nnz_er"] + st["nnz_long"] + n_moved
    assert (n_moved > 0) == (kind == "hub")
    got_k = np.lexsort((val[real], col[real], row[real]))
    want_k = np.lexsort((want_v, want_c, want_r))
    np.testing.assert_array_equal(row[real][got_k], want_r[want_k])
    np.testing.assert_array_equal(col[real][got_k], want_c[want_k])
    np.testing.assert_array_equal(val[real][got_k], want_v[want_k])
    assert not np.isin(row[real], e.split_src).any()
    # (2) the plain walks against the combine of the four phases
    d = e.to_torch()
    p = plan.to_torch()
    x = _x(e)
    y = dia.dia_body_plain(d, x, out=ehyb_stream.stream_body_plain(
        p, x, kahan))
    assert y.shape == (plan.n_rb * 32,)
    want = combine_ehyb(d, ehyb_body(d, x, kahan), ehyb_er(d, x),
                        ehyb_long(d, x), dia.dia_body_plain(d, x)).numpy()
    assert rel(y.numpy(), body_rows(y.numpy(), want)) <= (
        1e-14 if f64 else 1e-6)
    # (3) the flagship's apply against JAX (f32) or the oracle (f64)
    apply = ehyb_stream.EhybStreamApply(e.to_torch(), kahan=kahan, cells=p)
    got = apply(x).numpy()
    dim = e.dim
    if f64:
        m_perm = r.apply_to_matrix(coo_for(PORT, m))
        want = oracle_spmv(m_perm, x.numpy()[:dim])
        assert rel(got[:dim], want) <= 1e-12
    else:
        want = np.asarray(xla_ops.ehyb_apply_xla(e_ref.to_jax(),
                                                 jnp.asarray(x.numpy())))
        assert rel(got, body_rows(got, want)) <= 2e-6


@pytest.mark.parametrize("dword", [False, True], ids=["f32", "dword"])
def test_folded_plan_is_cached_beside_the_artifact(scrambled, powerlaw_small,
                                                   dword, tmp_path,
                                                   monkeypatch):
    """With the artifact cache on, the flagship's K1 plan with its tail
    folded in is written beside the artifact with its build's seconds, and
    a second setup loads it: the same plan byte for byte, the same y; K1's
    options key the file, so a changed split threshold builds and caches
    another.  The tails: powerlaw_small in the relaxed layout with hub-row
    splitting (ER entries and hub-split rows); in the precision mode the
    scrambled Poisson with dense rows in 1,024-row windows (ER entries and
    long rows)."""
    if dword:
        m = coo_for(PORT, generate.with_dense_rows(scrambled, 3, 0.5))
        extra = dict(dword_values=True, window_rows=1024)
    else:
        m = coo_for(PORT, powerlaw_small)
        extra = dict(body_layout="sell_rx", row_split_threshold=4)
    cfg = port.EhybConfig(artifact_cache=True, cache_dir=str(tmp_path),
                          **extra)
    first = port.EhybSpmv(cfg, device="cpu").setup(m)
    files = sorted(tmp_path.glob("*.k1-*.npz"))
    a = first.module.cells
    assert len(files) == 1 and a.stats["folded"] and a.stats["tail_cells"]
    second = port.EhybSpmv(cfg, device="cpu").setup(m)
    b = second.module.cells
    assert "cache_load" in second.setup_seconds
    assert b.stats == a.stats and b.stats["build_seconds"] > 0
    buffers = dict(b.named_buffers())
    for name, buf in a.named_buffers():
        assert torch.equal(buf, buffers[name]), name
    x = deterministic_x(m.dimension)
    np.testing.assert_array_equal(first.matvec(x), second.matvec(x))
    monkeypatch.setattr(stream_cells, "SPLIT_STEPS_F64" if dword
                        else "SPLIT_STEPS", 4)
    third = port.EhybSpmv(cfg, device="cpu").setup(m)
    assert len(list(tmp_path.glob("*.k1-*.npz"))) == 2
    assert stream_cells.split(third.module.cells)


# ---------------------------------------------------------------------------
# The split form's small form: hub rows apart, short items, a fixed fold.
# ---------------------------------------------------------------------------

#: Bodies that reach the small form: (case, fixture, layout, windows per
#: sub-tile, extra config, patches of ``stream_cells``).  powerlaw_small
#: takes it as shipped (hub chunks of 16 steps), and with chunks of one
#: step (its widest hub then folds 51 partials); the long body and its
#: float64 copy with the thresholds patched small; the long body at 128
#: steps with hubs past 100 cells (its row blocks cut into pieces between
#: their steps); the precision mode's scattered body with rows of more
#: than two cells as hubs (grouped rows).
SMALL_CASES = [
    ("powerlaw", "powerlaw_small", "sell_rx", 4, {}, {}),
    ("powerlaw_chunks1", "powerlaw_small", "sell_rx", 4, {},
     {"HUB_STEPS": 1}),
    ("powerlaw_f64", "powerlaw_small", "sell_rx", 4, {"dtype": "float64"},
     {}),
    ("long", "long", None, 0, {}, {"SPLIT_STEPS": 8, "SMALL_STEPS": 4}),
    ("long_f64", "long_f64", None, 0, {},
     {"SPLIT_STEPS_F64": 8, "SMALL_STEPS": 4}),
    ("long_cut", "long", None, 0, {},
     {"SPLIT_STEPS": 128, "SMALL_STEPS": 100}),
    ("dword_grouped", "scrambled", "dword", 0, {},
     {"SPLIT_STEPS_F64": 3, "SMALL_STEPS": 2}),
]
SMALL_IDS = [c[0] for c in SMALL_CASES]


def _small_plan(request, monkeypatch, fixture, layout, wps, extra, patch):
    """The body of the case and its plan as shipped (``k1_options``) under
    the case's patches, and the parent: its split form."""
    for k, v in patch.items():
        monkeypatch.setattr(stream_cells, k, v)
    e = _artifact(request, fixture, layout, wps, extra)
    plan = stream_cells.build_stream_cells(e, **stream_cells.k1_options(e))
    parent = _body_plan(e)
    return e, plan, parent


@pytest.mark.parametrize("case,fixture,layout,wps,extra,patch", SMALL_CASES,
                         ids=SMALL_IDS)
def test_small_plan_replay(case, fixture, layout, wps, extra, patch,
                           request, monkeypatch):
    """The small form's plan: the rule grants it where the split form
    chunks a row block; every row of more than SMALL_STEPS cells is a hub,
    apart (no real cell in a piece, its lane masked in its row block's
    item), the others keep their row blocks at most SMALL_STEPS wide; the
    hub items cover each hub's steps once, in order, in chunks of at most
    hub_steps, a slot a chunk where a hub has more than one; the items
    count every row block and hub chunk; and the plan's cells, hubs among
    them, are the parent's real cells, each once."""
    e, plan, parent = _small_plan(request, monkeypatch, fixture, layout, wps,
                                  extra, patch)
    st, small_steps = plan.stats, stream_cells.SMALL_STEPS
    assert stream_cells.split(parent) and parent.stats["chunked_rbs"] > 0
    assert stream_cells.small(plan) and stream_cells.split(plan)
    assert st["small"] and st["chunked_rbs"] == 0 and not plan.chunk_rb.size
    assert st["grouped"] == (case == "dword_grouped")
    # every entry once: the pieces' real cells and the hubs' against the
    # parent's
    got = _entries(plan)
    want = _entries(parent)
    real_g, real_w = got[2] != 0, want[2] != 0
    assert real_g.sum() == real_w.sum() == st["real_cells"]
    key = lambda r: np.lexsort((r[2][r[2] != 0], r[1][r[2] != 0],  # noqa
                               r[0][r[2] != 0]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[real_g][key(got)],
                                      b[real_w][key(want)])
    # hubs apart: more than small_steps cells each, none in a piece
    n_hub = np.diff(plan.hub_cell)
    count = np.array([np.count_nonzero(plan.hub_val[a:b]) for a, b in zip(
        plan.hub_cell[:-1], plan.hub_cell[1:])])
    assert np.all(count > small_steps) and np.all(n_hub % 32 == 0)
    assert np.all(-(-count // 32) * 32 == n_hub)
    for h, (a, b) in enumerate(zip(plan.hub_cell[:-1], plan.hub_cell[1:])):
        assert not plan.hub_val[a + count[h]:b].any()
    hub_rows = plan.hub_row.astype(np.int64)
    _, row, _, _, val, _ = _replay(plan)
    out = plan.row_map.astype(np.int64)[hub_rows] if plan.row_map.size \
        else hub_rows
    assert not np.isin(row[val != 0], out).any()
    widths = np.bincount(plan.piece[:-1, stream_cells.PIECE_RB],
                         weights=np.diff(plan.piece[:, 0]) // 32,
                         minlength=plan.n_rb)
    # a row block's pieces together hold at most small_steps steps
    assert widths.max() <= small_steps
    assert (st["split_rbs"] > 0) == (case == "long_cut")
    # the row-block items: every row block once, its hub lanes masked
    item = plan.item.astype(np.int64)
    assert sorted(item[:, 0]) == list(range(plan.n_rb))
    chains = _chains(plan)
    np.testing.assert_array_equal(item[:, 1],
                                  [len(chains[r]) for r in item[:, 0]])
    assert np.all(item[:, stream_cells.ITEM_SLOT] == -1)
    mask = np.zeros(plan.n_rb, np.int64)
    np.add.at(mask, hub_rows // 32, 1 << (hub_rows % 32))
    np.testing.assert_array_equal(item[:, 3].astype(np.uint32),
                                  mask[item[:, 0]].astype(np.uint32))
    # ... and its main piece's cells and table (-1: direct)
    pc = plan.piece.astype(np.int64)
    np.testing.assert_array_equal(item[:, 4], pc[item[:, 0], 0])
    np.testing.assert_array_equal(item[:, 5], pc[item[:, 0] + 1, 0])
    np.testing.assert_array_equal(item[:, 6], np.where(
        pc[item[:, 0] + 1, 1] == pc[item[:, 0], 1], -1, pc[item[:, 0], 1]))
    # the hub items: each hub's steps once, in order; slots in order
    hub_item = plan.hub_item.astype(np.int64)
    hs = st["hub_steps"]
    assert hub_item[:, 1].max() <= hs and hub_item[:, 1].min() >= 1
    n_slots = np.diff(plan.hub_first)
    for h in range(len(hub_rows)):
        mine = hub_item[hub_item[:, 3] == h]
        assert mine[0, 0] == plan.hub_cell[h]
        np.testing.assert_array_equal(
            mine[:, 0], plan.hub_cell[h] + 32 * np.r_[0, np.cumsum(
                mine[:-1, 1])])
        assert mine[:, 1].sum() * 32 == n_hub[h]
        # each item carries its hub's slots and y row
        assert np.all(mine[:, 4:7] == [plan.hub_first[h],
                                       plan.hub_first[h + 1], out[h]])
        if len(mine) == 1:
            assert n_slots[h] == 0 and mine[0, 2] == -1
        else:
            np.testing.assert_array_equal(
                mine[:, 2], plan.hub_first[h] + np.arange(len(mine)))
    assert st["n_items"] == plan.n_rb + len(hub_item)
    assert st["hub_items"] == len(hub_item) and st["n_hubs"] == len(hub_rows)
    assert st["max_fold"] == n_slots.max()
    assert st["max_item_steps"] == max(int(widths.max()),
                                       int(hub_item[:, 1].max()))
    assert st["compact_cells"] == plan.piece[-1, 0] + plan.hub_val.size
    assert case != "powerlaw" or hs == stream_cells.HUB_STEPS
    assert case != "powerlaw_chunks1" or (hs == 1 and st["max_fold"] == 51)


def _neumaier_step(s, c, v):
    """One Neumaier step on numpy scalars."""
    t = s + v
    return t, c + ((s - t) + v if abs(s) >= abs(v) else (v - t) + s)


def _small_replay(plan, x: np.ndarray, kahan: bool) -> np.ndarray:
    """The small form's sums in numpy, in its kernel's order: a row block's
    rows by piece, then place (Neumaier steps where ``kahan``); a hub's chunks,
    lane l adding entries l, l + 32, ... of its chunk, the 32 lanes in the
    tree (k = 16, 8, 4, 2, 1: lane l < k takes lane l + k's pair), a hub
    of several chunks its slots lane by lane (slot l, l + 32, ...) and the
    tree again; a row is S + C with ``kahan``."""
    dt = plan.cell_val.dtype.type
    zero = dt(0)

    def combine(a, b):
        if not kahan:
            return (a[0] + b[0], zero)
        s, c = _neumaier_step(a[0], a[1], b[0])
        return (s, c + b[1])

    def tree(pairs):
        pairs = list(pairs)
        for k in (16, 8, 4, 2, 1):
            pairs = [combine(pairs[i], pairs[i + k]) for i in range(k)]
        return pairs[0]

    n = plan.n_rb * 32
    y = np.zeros(n, dt)
    cell_piece, row, k, col, val, _ = _replay(plan)
    sums = {}
    # a row's cells by piece (main, then later pieces in chain order), then
    # place
    for i in np.lexsort((k, cell_piece, row)):
        r = int(row[i])
        s, c = sums.get(r, (zero, zero))
        v = val[i] * x[col[i]]
        sums[r] = _neumaier_step(s, c, v) if kahan else (s + v, zero)
    for r, (s, c) in sums.items():
        y[r] = s + c if kahan else s
    prod = plan.hub_val * x[plan.hub_col.astype(np.int64)]
    part = {}
    hub_out = plan.row_map.astype(np.int64)[plan.hub_row] \
        if plan.row_map.size else plan.hub_row.astype(np.int64)
    for first, steps, slot, h in plan.hub_item[:, :4].astype(np.int64):
        lanes = []
        for lane in range(32):
            s = c = zero
            for q in range(steps):
                v = prod[first + 32 * q + lane]
                s, c = _neumaier_step(s, c, v) if kahan else (s + v, zero)
            lanes.append((s, c))
        pair = tree(lanes)
        if slot < 0:
            y[hub_out[h]] = pair[0] + pair[1] if kahan else pair[0]
        else:
            part[slot] = pair
    for h in range(len(plan.hub_row)):
        a, b = plan.hub_first[h], plan.hub_first[h + 1]
        if a == b:
            continue
        lanes = []
        for lane in range(32):
            acc = (zero, zero)
            for q in range(a + lane, b, 32):
                acc = combine(acc, part[q])
            lanes.append(acc)
        pair = tree(lanes)
        y[hub_out[h]] = pair[0] + pair[1] if kahan else pair[0]
    return y


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
@pytest.mark.parametrize("case,fixture,layout,wps,extra,patch", SMALL_CASES,
                         ids=SMALL_IDS)
def test_small_plain_matches_its_fold_order(case, fixture, layout, wps,
                                            extra, patch, kahan, request,
                                            monkeypatch):
    """The small form's plain version (``stream_body_plain``, its hubs by
    ``hub_sums_plain``) bit for bit against a numpy replay of the kernel's
    order (``_small_replay``: the lanes, the shuffle tree, the fold of the
    partials lane by lane), plain and Kahan in float64, plain in float32;
    a float32 x with Kahan (float64 sums, rounded once) within 1e-6 of it;
    every form within 1e-6 (float32) or 1e-14 (float64) of the parent's
    split form and, where the wrapper takes a CPU tensor, the plain
    version, counting no launch."""
    e, plan, parent = _small_plan(request, monkeypatch, fixture, layout, wps,
                                  extra, patch)
    p = plan.to_torch()
    x = _x(e, 5)
    launches = ehyb_stream.stream_body.launches
    got = ehyb_stream.stream_body(p, x, kahan)
    assert ehyb_stream.stream_body.launches == launches
    assert torch.equal(got, ehyb_stream.stream_body_plain(p, x, kahan))
    f64 = x.dtype == torch.float64
    want = _small_replay(plan, x.numpy(), kahan and f64)
    if f64 or not kahan:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert rel(got.numpy(), want) <= 1e-6
    ref = ehyb_stream.stream_body_plain(parent.to_torch(), x, kahan)
    assert rel(got.numpy(), ref.numpy()) <= (1e-14 if f64 else 1e-6)


#: The configs of the small form's apply on powerlaw_small (the CLI's
#: flags → config fields): every K1 variant it reads.
SMALL_CONFIGS = {"f32": {}, "compensated": dict(compensated_sum=True),
                 "f64": dict(dtype="float64"),
                 "f64_compensated": dict(dtype="float64",
                                         compensated_sum=True),
                 "dword": dict(dword_values=True)}


@pytest.mark.parametrize("config", sorted(SMALL_CONFIGS))
def test_small_apply_matches_jax_and_oracle(config, powerlaw_small):
    """powerlaw_small through ``EhybSpmv`` in each of the five configs:
    K1's plan as shipped takes the small form, and the product lies within
    5e-6 of the JAX package's model (its XLA apply, ``ehyb_apply_xla``,
    on the same artifact in float32) and of the exact-f64 oracle, and in
    float64 within 1e-12 of the oracle."""
    from ehyb_spmv_gpu_tpu.ops import xla_ops
    import jax.numpy as jnp
    import ehyb_spmv_gpu_tpu as ref

    from test_torch_parity import REF, port_from_ref

    kw = dict(artifact_cache=False, **SMALL_CONFIGS[config])
    m = powerlaw_small
    model = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(
        coo_for(PORT, m))
    assert stream_cells.small(model.module.cells)
    x = deterministic_x(m.dimension)
    got = model.matvec(x)
    f64 = config in ("f64", "f64_compensated", "dword")
    assert rel(got, oracle_spmv(m, x)) <= (1e-12 if f64 else ORACLE_TOL)
    jmodel = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(coo_for(REF, m))
    assert rel(got, jmodel.matvec(x)) <= ORACLE_TOL
    if config == "f32":
        # the flagship's apply on the JAX host layer's artifact, against
        # the JAX package's XLA apply of it
        cfg = config_for(REF, True, "sell_rx", 4)
        _, _, e_ref = host_pipeline(REF, m, cfg)
        e_pt = port_from_ref(e_ref)
        apply = ehyb_stream.make_stream_apply(e_pt, e_pt.to_torch())
        assert stream_cells.small(apply.cells)
        xp = np.zeros(e_ref.padded_x_rows, np.float32)
        xp[:m.dimension] = np.random.default_rng(1).standard_normal(
            m.dimension)
        y = apply(torch.from_numpy(xp)).numpy()
        want = np.asarray(xla_ops.ehyb_apply_xla(e_ref.to_jax(),
                                                 jnp.asarray(xp)))
        assert rel(y, body_rows(y, want)) <= ORACLE_TOL


def test_small_form_refusals_and_rule(powerlaw_small, monkeypatch):
    """What the small form's kernel does not read is refused, on the CPU
    as on the card: a list (a row-block list or work items, and
    ``list_items`` of its plan), a geometry of more rows a thread or x
    staged, hub cells of another type; a plan walked through lists
    (``k1_options(e, lists=True)``, the sharded apply's) keeps the split
    form; and the rule refuses the small form where the split form's items
    would fill more than SMALL_WAVE_SHARE of the wave or its chunks are no
    longer than SMALL_STEPS, leaving the split form's plan byte for byte,
    as does a body with no row past SMALL_STEPS."""
    e = port.EhybSpmv(port.EhybConfig(routed_delegate="never"),
                      device="cpu").setup(coo_for(PORT, powerlaw_small)).ehyb
    plan = stream_cells.build_stream_cells(e, **stream_cells.k1_options(e))
    listed = _body_plan(e)
    assert stream_cells.small(plan) and not stream_cells.small(listed)
    assert stream_cells.split(listed)
    p = plan.to_torch()
    x = _x(e)
    for lst in (torch.zeros(2, dtype=torch.int32),
                torch.from_numpy(stream_cells.list_items(listed, [0]))):
        with pytest.raises(ValueError, match="small form takes no list"):
            ehyb_stream.stream_body(p, x, rb_list=lst)
    with pytest.raises(ValueError, match="small form takes no list"):
        stream_cells.list_items(plan, [0])
    for g in (ehyb_stream.StreamGeometry(rows=2),
              ehyb_stream.StreamGeometry(x_mode="staged")):
        with pytest.raises(ValueError, match="small-form K1"):
            ehyb_stream.check_built(g, torch.float32, True, True)
    ehyb_stream.check_built(ehyb_stream.SMALL_GEOMETRY, torch.float64, True,
                            True)
    bad = plan.to_torch()
    bad.hub_col = bad.hub_col.long()
    with pytest.raises(ValueError, match="hub cells"):
        ehyb_stream._check(bad, x)
    assert ehyb_stream.geometry_of(p) == ehyb_stream.SMALL_GEOMETRY
    assert ehyb_stream.geometry_of(listed.to_torch()) == \
        ehyb_stream.SPLIT_GEOMETRY
    # a body the rule grants whose rows are none past small_steps (its
    # row blocks wide by their tables' cuts alone) keeps its split form
    with monkeypatch.context() as mp:
        mp.setattr(stream_cells, "small_form_wanted", lambda *a: True)
        _same_plans(stream_cells.build_stream_cells(
            e, **dict(stream_cells.k1_options(e), small_steps=1 << 20)),
            listed)
    for k, v in (("SMALL_WAVE_SHARE", 1e-3),
                 ("SMALL_STEPS", stream_cells.SPLIT_STEPS)):
        with monkeypatch.context() as mp:
            mp.setattr(stream_cells, k, v)
            _same_plans(stream_cells.build_stream_cells(
                e, **stream_cells.k1_options(e)), listed)

