"""The HBM-scale body of the port on the CPU: the stream-plan host code
against the JAX package's, the flagship's branch decisions against the JAX
flagship's (Pallas interpret mode), the GPU window-cache plan's replay
invariants, and the window-cache kernel's plain version against the JAX
hbm / hbm-big kernels in interpret mode.

Bounds: f32 rel <= 2e-6 against the JAX applies (the same products summed
in another order); rel <= 5e-6 against the exact-f64 oracle (the suite's
bound).  A float64 config: the JAX package runs it in f32 (it never turns
on x64), so the port is held to the JAX model's product at the f32 bound
and to the oracle at rel <= 1e-12 (the precision mode's bound)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu as ref
import ehyb_spmv_gpu_tpu.ops.ehyb_pallas as ep
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from ehyb_spmv_torch.ops import ehyb_stream, ehyb_wincache, stream_plan
from ehyb_spmv_torch.ops.torch_ops import body_gather_index, ehyb_body
from test_torch_parity import (PORT, REF, assert_same_ehyb,
                               cancellation_matrix, config_for, coo_for,
                               host_pipeline, port_from_ref, rel)

PARITY_TOL = 2e-6
ORACLE_TOL = 5e-6
F64_ORACLE_TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX apply function → the TPU branch name the port reports.
JAX_BRANCH = {
    "apply_nobody": "skipped", "apply_stream": "streamed v3",
    "apply_stream_big": "streamed big", "apply_stream_hbm": "streamed hbm",
    "apply_stream_hbm_big": "streamed hbm-big", "apply_xla_rx": "xla rx",
    "apply_xla_body": "xla body", "apply_xla_slide": "xla slide",
}


def _set_both(monkeypatch, name, value):
    monkeypatch.setattr(ep, name, value)
    monkeypatch.setattr(stream_plan, name, value)


# --- the stream-plan host code --------------------------------------------

@pytest.mark.parametrize("wps", [2, 4], ids=["dual", "quad"])
def test_plan_hbm_stream_matches_jax(scrambled, wps):
    """S, nslot, n_tiles, the stream maps and every plan array equal the
    JAX package's on one artifact."""
    cfg = config_for(REF, True, "sell_rx", wps)
    e_ref = host_pipeline(REF, scrambled, cfg)[2]
    want = ep._plan_hbm_stream(e_ref)
    got = stream_plan._plan_hbm_stream(port_from_ref(e_ref))
    assert want.keys() == got.keys()
    for k in ("S", "nslot", "n_tiles", "smem_bytes"):
        assert got[k] == want[k], k
    for k in ("sub_slice", "reset", "last_sub"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["sub_wins"]) == len(want["sub_wins"]) == wps
    for a, b in zip(got["sub_wins"], want["sub_wins"]):
        np.testing.assert_array_equal(a, b)
    (p_g, *rest_g), (p_w, *rest_w) = got["plan"], want["plan"]
    assert len(p_g) == len(p_w)
    for a, b in zip(p_g + rest_g[:4], p_w + rest_w[:4]):
        np.testing.assert_array_equal(a, b)
    assert rest_g[4:] == rest_w[4:]          # kmax0, kmax, n_loads


# (case, config overrides, patches on both packages, env, port branch)
BRANCH_CASES = [
    ("v3", {}, {}, {}, "streamed v3"),
    ("big", {}, {"_SMEM_PREFETCH_BUDGET": 8}, {}, "streamed big"),
    ("hbm", {}, {"X_RESIDENT_BYTES": 1024}, {}, "streamed hbm"),
    ("hbm_big", {}, {"X_RESIDENT_BYTES": 1024, "_SMEM_PREFETCH_BUDGET": 8},
     {}, "streamed hbm-big"),
    # K5: the stream is off, so the relaxed layout is refused
    ("resident_x", {}, {}, {"EHYB_STREAM_BODY": "0"}, "resident-x"),
    # x past residency and no window-cache geometry schedules: the relaxed
    # layout is refused; sliding windows leave the TPU its XLA body, and
    # 1024-aligned ones its windowed kernel K6
    ("xla_slide", {}, {"X_RESIDENT_BYTES": 1024, "NSLOT": 8, "HBM_NSLOT": 8},
     {}, "xla slide"),
    ("windowed", {"sliding_windows": False},
     {"X_RESIDENT_BYTES": 1024, "NSLOT": 8, "HBM_NSLOT": 8}, {}, "windowed"),
]


@pytest.mark.parametrize("case,cfg_kw,patches,env,branch", BRANCH_CASES,
                         ids=[c[0] for c in BRANCH_CASES])
def test_flagship_branch_matches_jax(case, cfg_kw, patches, env, branch,
                                     scrambled, monkeypatch):
    """Port and JAX flagship take the same decisions under each setting:
    the same layout and artifact, the same TPU branch, and the body kernel
    the branch asks for (the window cache for K3/K4, K1 elsewhere)."""
    for k, v in patches.items():
        _set_both(monkeypatch, k, v)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("EHYB_FORCE_PALLAS", "interpret")
    kw = dict(artifact_cache=False, routed_delegate="never", **cfg_kw)
    jmodel = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(scrambled)
    model = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(
        coo_for(PORT, scrambled))
    assert model.config.body_layout == jmodel.config.body_layout
    assert model.config.sliding_windows == jmodel.config.sliding_windows
    assert model.dev.nwin == (1 if not jmodel.ehyb.step_win_b.size else
                              4 if jmodel.ehyb.step_win_c.size else 2)
    assert_same_ehyb(model.ehyb, jmodel.ehyb)
    jname = jmodel._pallas_apply.__name__
    if jname == "apply":      # the per-slice kernels share one closure name
        jbranch = "resident-x" if ep.X_RESIDENT_BYTES > 1024 else "windowed"
    else:
        jbranch = JAX_BRANCH[jname]
    assert model.module.branch == jbranch == branch
    k34 = stream_plan.BRANCH_KERNEL[branch] in ("K3", "K4")
    assert (model.module.wincache is not None) == k34
    x = deterministic_x(scrambled.dimension)
    got = model.matvec(x)
    assert rel(got, oracle_spmv(scrambled, x)) <= ORACLE_TOL
    assert rel(got, jmodel.matvec(x)) <= PARITY_TOL


_SUBPROCESS = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import ehyb_spmv_gpu_tpu as ref
import ehyb_spmv_torch as port
from ehyb_spmv_gpu_tpu.io import generate
from test_torch_parity import PORT, assert_same_ehyb, coo_for

m = generate.permuted(generate.poisson2d(48), seed=11)
kw = dict(artifact_cache=False, routed_delegate="never")
jm = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(m)
pm = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(coo_for(PORT, m))
assert pm.config.sliding_windows == jm.config.sliding_windows
assert pm.config.body_layout == jm.config.body_layout == "sell_mw", (
    pm.config.body_layout, jm.config.body_layout)
assert_same_ehyb(pm.ehyb, jm.ehyb)
jname = jm._pallas_apply.__name__
assert pm.module.branch == {"apply_xla_slide": "xla slide",
                            "apply": "windowed"}[jname], jname
print("SAME")
"""


def test_x_resident_bytes_env_override_matches_jax():
    """Both packages read EHYB_X_RESIDENT_BYTES (and the slot-count
    overrides) at import: lowered, they make the same sliding-window and
    layout decisions and land the same artifact."""
    env = dict(os.environ, EHYB_X_RESIDENT_BYTES="1024", EHYB_NSLOT="8",
               EHYB_HBM_NSLOT="8", EHYB_FORCE_PALLAS="interpret",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SAME" in proc.stdout


def test_flagship_reads_residency_through_its_module(scrambled,
                                                     monkeypatch):
    """A value set on ``stream_plan`` after import reaches the flagship's
    sliding-window rule and its branch."""
    m = coo_for(PORT, scrambled)
    cfg = port.EhybConfig(artifact_cache=False)
    assert port.EhybSpmv(cfg, device="cpu").setup(m).module.branch \
        == "streamed v3"
    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    model = port.EhybSpmv(cfg, device="cpu").setup(m)
    assert model.module.branch == "streamed hbm"
    assert model.config.sliding_windows is True


# --- the GPU window-cache plan --------------------------------------------

def _scattered():
    return generate.random_general(8192, 24, seed=3)


# (case, matrix, layout, windows per sub-tile, slot rows)
PLAN_CASES = [
    ("dual", "scrambled", "sell_rx", 2, ehyb_wincache.SLOT_ROWS),
    ("quad", "scrambled", "sell_rx", 4, ehyb_wincache.SLOT_ROWS),
    ("mw", "scrambled", "sell_mw", 2, ehyb_wincache.SLOT_ROWS),
    ("dual_tight", "scattered", "sell_rx", 2, 32),
    ("quad_overflow", "scattered", "sell_rx", 4, 40),
]


def _port_artifact(request, fixture, layout, wps):
    m = _scattered() if fixture == "scattered" \
        else request.getfixturevalue(fixture)
    return host_pipeline(PORT, m, config_for(PORT, True, layout, wps))[2]


def _replay_cells(p):
    """Every compact cell of the plan: (y row, stage, place k in its row
    within the stage, x column, value), and the row blocks' first y rows."""
    rb = np.repeat(np.arange(len(p.rb_cell) - 1), np.diff(p.rb_cell))
    rb_stage = np.repeat(np.arange(len(p.stage_rb) - 1), np.diff(p.stage_rb))
    rb_first = (np.arange(rb_stage.size) - p.stage_rb[rb_stage]
                + 4 * p.stage_slice[rb_stage, 0]) * 32
    c = np.arange(p.rb_cell[-1])
    k = (c - p.rb_cell[rb]) // 32
    row = rb_first[rb] + c % 32
    stage = rb_stage[rb]
    idx = p.cell_idx.view(np.uint16).astype(np.int64)
    slot = idx // 128
    sizes = np.diff(p.stage_row_ptr)
    assert np.all(slot < sizes[stage]), "a cell reads past its stage's rows"
    col = p.stage_rows[p.stage_row_ptr[stage] + slot] * 128 + idx % 128
    return row, stage, k, col, p.cell_val


@pytest.mark.parametrize("case,fixture,layout,wps,slot_rows", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_wincache_plan_replay(case, fixture, layout, wps, slot_rows,
                              request):
    """Replay the plan: stages and blocks partition the body, no slice is
    cut across blocks, every stage fits the slot budget; the compact cells
    are the body's real cells, each once, in step order per row, each
    index inside its stage's rows and decoding to ``body_gather_index``'s
    column; every width is its block's longest row; and the plain version
    through the plan equals K1's plain version."""
    e = _port_artifact(request, fixture, layout, wps)
    p = ehyb_wincache.build_wincache_plan(e, slot_rows=slot_rows)
    offs = e.slice_offset.astype(np.int64)
    n_slices, n_steps = offs.shape[0] - 1, int(offs[-1])
    # stages partition the steps in order; blocks partition the stages
    assert p.stage_step[0] == 0 and p.stage_step[-1] == n_steps
    assert np.all(np.diff(p.stage_step) >= 0)
    n_stages = len(p.stage_step) - 1
    assert p.block_stage[0] == 0 and p.block_stage[-1] == n_stages
    assert np.all(np.diff(p.block_stage) > 0)
    lo, hi = p.stage_slice[:, 0], p.stage_slice[:, 1]
    assert lo[0] == 0 and hi[-1] == n_slices and np.all(hi > lo)
    assert np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)
    assert np.all(hi - lo <= ehyb_wincache.MAX_RUN_SLICES)
    owner = np.full(n_slices, -1)
    for b in range(len(p.block_stage) - 1):
        t0, t1 = p.block_stage[b], p.block_stage[b + 1]
        if t1 - t0 == 1:
            # one stage of whole slices: exactly their steps
            assert p.stage_step[t0] == offs[lo[t0]]
            assert p.stage_step[t1] == offs[hi[t0]]
        else:
            # one slice past the budget, walked in stages of its steps
            assert np.all(lo[t0:t1] == lo[t0]) and np.all(hi[t0:t1]
                                                           == lo[t0] + 1)
            assert p.stage_step[t0] == offs[lo[t0]]
            assert p.stage_step[t1] == offs[lo[t0] + 1]
        # no slice is cut across blocks
        assert np.all(owner[lo[t0]:hi[t1 - 1]] == -1)
        owner[lo[t0]:hi[t1 - 1]] = b
    assert np.all(owner >= 0)
    sizes = np.diff(p.stage_row_ptr)
    assert sizes.max() <= slot_rows
    assert p.stats["chunked_slices"] == int(np.sum(np.diff(p.block_stage)
                                                   > 1))
    if case in ("dual_tight", "quad_overflow"):
        assert p.stats["chunked_slices"] > 0, "no slice overflowed a stage"
    # four row blocks per slice of each stage
    np.testing.assert_array_equal(np.diff(p.stage_rb), 4 * (hi - lo))
    # the compact cells against the body's real cells, both in row order
    # and, within a row, in stage then cell order against step order
    row, stage, k, col, val = _replay_cells(p)
    real = val != 0
    st, ln = np.nonzero(e.ell_val[:n_steps] != 0)
    step_slice = np.repeat(np.arange(n_slices), np.diff(offs))
    want_row = step_slice[st] * 128 + ln
    want_stage = np.searchsorted(p.stage_step[1:], st, side="right")
    want_col = body_gather_index(port_from_ref(e).to_torch()).numpy()[st, ln]
    order = np.lexsort((k[real], stage[real], row[real]))
    want = np.lexsort((st, want_row))
    assert real.sum() == st.size == p.stats["real_cells"]
    np.testing.assert_array_equal(row[real][order], want_row[want])
    np.testing.assert_array_equal(stage[real][order], want_stage[want])
    np.testing.assert_array_equal(col[real][order], want_col[want])
    np.testing.assert_array_equal(val[real][order], e.ell_val[st, ln][want])
    # a row's real cells fill its first places; the width is the longest
    rb = np.repeat(np.arange(len(p.rb_cell) - 1), np.diff(p.rb_cell))
    n_rb = len(p.rb_cell) - 1
    count = np.zeros((n_rb, 32), np.int64)
    np.add.at(count, (rb[real], row[real] % 32), 1)
    kmax = np.full((n_rb, 32), -1)
    np.maximum.at(kmax, (rb[real], row[real] % 32), k[real])
    np.testing.assert_array_equal(kmax, count - 1)
    np.testing.assert_array_equal(count.max(1), np.diff(p.rb_cell) // 32)
    st_ = p.stats
    assert st_["compact_cells"] == p.rb_cell[-1] <= st_["padded_cells"]
    if case == "quad_overflow":
        assert st_["compact_cells"] < st_["padded_cells"]
    # the plan's staged reads give K1's plain answer exactly: the same
    # products added in the same order (the dropped cells add zeros)
    d = port_from_ref(e).to_torch()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        e.padded_x_rows).astype(np.float32))
    got = ehyb_wincache.wincache_body(d, p.to_torch(), x)
    assert torch.equal(got, ehyb_body(d, x))


def test_wincache_compacts_poisson_to_four_cells_per_row(monkeypatch):
    """A scrambled 2-D Poisson grid forced past residency takes the window
    cache, and its compact body holds at most 4 cells per row (the diagonal
    goes to DIA): the ratio pp4096's prediction rests on."""
    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    m = generate.permuted(generate.poisson2d(96), seed=3)
    model = port.EhybSpmv(port.EhybConfig(artifact_cache=False),
                          device="cpu").setup(coo_for(PORT, m))
    st = model.module.wincache.stats
    assert model.module.branch.startswith("streamed hbm")
    assert st["max_width"] <= 4
    assert st["real_cells"] <= st["compact_cells"] \
        <= 4 * 128 * (model.ehyb.slice_offset.shape[0] - 1)
    assert st["compact_cells"] < st["padded_cells"]
    x = deterministic_x(m.dimension)
    assert rel(model.matvec(x), oracle_spmv(m, x)) <= ORACLE_TOL


def test_wincache_flagship_keeps_no_padded_body(scrambled, monkeypatch):
    """Where the window cache runs, the flagship's device mirror gives up
    the padded cells (the plan holds the body), as it does where K1 runs
    over its own plan; the host artifact still has them, and the padded
    body's plain version on their upload equals the plan's answer."""
    m = coo_for(PORT, scrambled)
    cfg = port.EhybConfig(artifact_cache=False)
    k1_model = port.EhybSpmv(cfg, device="cpu").setup(m)
    assert k1_model.module.wincache is None
    assert k1_model.module.cells is not None
    assert k1_model.dev.ell_val is None
    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    model = port.EhybSpmv(cfg, device="cpu").setup(m)
    plan = model.module.wincache
    assert plan is not None
    assert model.dev.ell_col is None and model.dev.ell_val is None
    x = model.prepare_x(deterministic_x(scrambled.dimension))
    padded = model.ehyb.to_torch(dtype=model.config.dtype)
    assert torch.equal(ehyb_wincache.wincache_body(model.dev, plan, x),
                       ehyb_body(padded, x))


def test_bytes_model_counts_the_window_cache_plan(scrambled, monkeypatch,
                                                  tmp_path):
    """Past residency the card reads the window-cache plan's compact cells
    and staged rows, not the padded body it dropped at upload: the
    roofline's bytes count the plan's ``layout_bytes`` for the body, and
    the DIA, ER, long-row, x and y bytes as before.  The CLI reports that
    count."""
    from ehyb_spmv_torch import cli
    from ehyb_spmv_torch.io import write_mtx
    from ehyb_spmv_torch.utils.timing import spmv_bytes_model

    m = coo_for(PORT, scrambled)
    cfg = port.EhybConfig(artifact_cache=False)
    k1_model = port.EhybSpmv(cfg, device="cpu").setup(m)
    ib = np.dtype(k1_model.config.index_dtype).itemsize
    assert k1_model.module.wincache is None
    # K1's own plan stands in for the padded body there
    # (test_bytes_model_counts_the_k1_plan)
    k1_st = k1_model.ehyb.stats
    assert k1_model.bytes_model() == spmv_bytes_model(
        k1_st, dim=m.dimension, value_bytes=4, ell_index_bytes=ib) \
        - (k1_st["nnz_ell"] + k1_st["waste_ell"]) * (4 + ib) \
        + k1_model.module.cells.stats["stream_bytes"]
    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    model = port.EhybSpmv(cfg, device="cpu").setup(m)
    plan_st = model.module.wincache.stats
    st = model.ehyb.stats
    assert st["nnz_ell"] > 0 and st["nnz_dia"] > 0
    padded = spmv_bytes_model(st, dim=m.dimension, value_bytes=4,
                              ell_index_bytes=ib)
    body = (st["nnz_ell"] + st["waste_ell"]) * (4 + ib)
    assert plan_st["layout_bytes"] == plan_st["cell_bytes"] \
        + plan_st["staged_bytes"] + plan_st["y_bytes"]
    assert model.bytes_model() == padded - body + plan_st["layout_bytes"]
    assert plan_st["cell_bytes"] < body
    path = str(tmp_path / "scrambled.mtx")
    write_mtx(path, m)
    code, result, cli_model = cli.run(cli.build_parser().parse_args(
        ["-m", path, "-i", "2", "--warmup", "1", "--device", "cpu"]))
    assert code == 0 and cli_model.module.wincache is not None
    assert result["bytes_model"] == model.bytes_model()
    # a float64 config: the plan's cells, staged rows, x and y count 8-byte
    # values, and so does the rest of the roofline's count
    model = port.EhybSpmv(dataclasses.replace(cfg, dtype="float64"),
                          device="cpu").setup(m)
    p64 = model.module.wincache.stats
    n_y = (model.ehyb.slice_offset.shape[0] - 1) * 128
    assert p64["cell_bytes"] == 10 * p64["compact_cells"]
    assert p64["staged_bytes"] == 8 * 128 * p64["staged_rows"]
    assert p64["y_bytes"] == 8 * n_y
    assert p64["x_bytes"] == 8 * model.ehyb.padded_x_rows
    assert p64["layout_bytes"] == p64["cell_bytes"] \
        + p64["staged_bytes"] + p64["y_bytes"]
    st = model.ehyb.stats
    padded = spmv_bytes_model(st, dim=m.dimension, value_bytes=8,
                              ell_index_bytes=ib)
    body = (st["nnz_ell"] + st["waste_ell"]) * (8 + ib)
    assert model.bytes_model() == padded - body + p64["layout_bytes"]
    code, result, cli_model = cli.run(cli.build_parser().parse_args(
        ["-m", path, "-i", "2", "--warmup", "1", "--device", "cpu",
         "--dtype", "float64"]))
    assert code == 0 and cli_model.module.wincache is not None
    assert result["bytes_model"] == model.bytes_model()


def test_bytes_model_counts_the_k1_plan(scrambled, tmp_path):
    """Where K1 runs, the card reads K1's compact plan (cells, pieces and
    tables), not the padded body it dropped at upload: the roofline's bytes
    count the plan's ``stream_bytes`` for the body, and the DIA, ER,
    long-row, x and y bytes as before.  The CLI reports that count."""
    from ehyb_spmv_torch import cli
    from ehyb_spmv_torch.io import write_mtx
    from ehyb_spmv_torch.utils.timing import spmv_bytes_model

    m = coo_for(PORT, scrambled)
    model = port.EhybSpmv(port.EhybConfig(artifact_cache=False),
                          device="cpu").setup(m)
    plan_st = model.module.cells.stats
    st = model.ehyb.stats
    ib = np.dtype(model.config.index_dtype).itemsize
    assert model.module.branch == "streamed v3"
    assert st["nnz_ell"] > 0 and st["nnz_dia"] > 0
    padded = spmv_bytes_model(st, dim=m.dimension, value_bytes=4,
                              ell_index_bytes=ib)
    body = (st["nnz_ell"] + st["waste_ell"]) * (4 + ib)
    assert plan_st["stream_bytes"] == plan_st["cell_bytes"] \
        + plan_st["map_bytes"]
    assert plan_st["cell_bytes"] == plan_st["compact_cells"] * 6
    assert model.bytes_model() == padded - body + plan_st["stream_bytes"]
    assert plan_st["stream_bytes"] < body
    path = str(tmp_path / "scrambled.mtx")
    write_mtx(path, m)
    code, result, cli_model = cli.run(cli.build_parser().parse_args(
        ["-m", path, "-i", "2", "--warmup", "1", "--device", "cpu"]))
    assert code == 0 and cli_model.module.cells is not None
    assert result["bytes_model"] == model.bytes_model()


# --- the window-cache kernel's plain version against the JAX kernels -------

# (case, fixture, windows per sub-tile, TPU variant, compensated, dtype)
HBM_CASES = [
    ("hbm_dual", "scrambled", 2, "hbm", False, "float32"),
    ("hbm_big_dual", "scrambled", 2, "hbm-big", False, "float32"),
    ("hbm_quad", "powerlaw_small", 4, "hbm", False, "float32"),
    ("hbm_big_quad", "powerlaw_small", 4, "hbm-big", False, "float32"),
    ("hbm_kahan", "cancellation", 2, "hbm", True, "float32"),
    ("hbm_f64", "powerlaw_small", 2, "hbm", False, "float64"),
    ("hbm_f64_kahan", "powerlaw_small", 2, "hbm", True, "float64"),
]


def _f64_models(m, kahan, monkeypatch):
    """The JAX and the port flagship in a float64 config past x residency
    (X_RESIDENT_BYTES lowered in both packages): the JAX one as its CLI
    answers on the CPU (its model's matvec), the port's on the CPU."""
    _set_both(monkeypatch, "X_RESIDENT_BYTES", 1024)
    kw = dict(artifact_cache=False, routed_delegate="never",
              dtype="float64", compensated_sum=kahan)
    jmodel = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(m)
    model = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(
        coo_for(PORT, m))
    return jmodel, model


@pytest.mark.parametrize("case,fixture,wps,variant,kahan,dtype", HBM_CASES,
                         ids=[c[0] for c in HBM_CASES])
def test_wincache_plain_matches_pallas_hbm(case, fixture, wps, variant,
                                           kahan, dtype, request,
                                           monkeypatch):
    if dtype == "float64":
        # the JAX package runs a float64 config through its model (an f64
        # Pallas apply built by hand does not trace); the port's window
        # cache in f64, plain or with Neumaier compensation
        m = request.getfixturevalue(fixture)
        jmodel, model = _f64_models(m, kahan, monkeypatch)
        plan = model.module.wincache
        assert model.module.branch == f"streamed {variant}"
        assert model.dev.nwin == wps and model.module.kahan == kahan
        assert plan.cell_val.dtype == torch.float64
        x = deterministic_x(m.dimension)
        got = model.matvec(x)
        assert rel(got, jmodel.matvec(x)) <= PARITY_TOL
        assert rel(got, oracle_spmv(m, x)) <= F64_ORACLE_TOL
        return
    monkeypatch.setattr(ep, "X_RESIDENT_BYTES", 1024)
    if variant == "hbm-big":
        monkeypatch.setattr(ep, "_SMEM_PREFETCH_BUDGET", 8)
    m = cancellation_matrix(REF) if kahan \
        else request.getfixturevalue(fixture)
    cfg = config_for(REF, True, "sell_rx", wps, compensated_sum=kahan)
    _, r_ref, e_ref = host_pipeline(REF, m, cfg)
    assert e_ref.stats["nnz_ell"] > 0
    apply = ep.make_ehyb_pallas_apply(e_ref, cfg, interpret=True,
                                      streaming=True)
    name = {"hbm": "apply_stream_hbm", "hbm-big": "apply_stream_hbm_big"}
    assert apply.__name__ == name[variant]
    col_p, val_p = ep.pad_stream_arrays(e_ref)
    d_ref = dataclasses.replace(e_ref.to_jax(), ell_col=jnp.asarray(col_p),
                                ell_val=jnp.asarray(val_p))
    x = np.ones(e_ref.padded_x_rows, np.float32) if kahan else \
        np.random.default_rng(1).standard_normal(
            e_ref.padded_x_rows).astype(np.float32)
    want = np.asarray(jax.jit(apply)(d_ref, jnp.asarray(x)))

    e_pt = port_from_ref(e_ref)
    d_pt = e_pt.to_torch()
    assert d_pt.nwin == wps
    plan = ehyb_wincache.build_wincache_plan(e_pt).to_torch()
    xt = torch.from_numpy(x)
    got = ehyb_stream.EhybStreamApply(d_pt, kahan=kahan,
                                      wincache=plan)(xt).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= PARITY_TOL, rel(got, want)
    if kahan:
        r0 = int(r_ref.old_to_new[0])
        assert got[r0] == want[r0] == 100.0
        naive = ehyb_stream.EhybStreamApply(d_pt, wincache=plan)(xt).numpy()
        assert abs(naive[r0] - 100.0) > 1e-4   # the stress has teeth


def test_wincache_counts_no_launch_on_cpu(scrambled, monkeypatch):
    """On CPU tensors the wrapper is the plain version: no kernel launch is
    counted, for the body or the DIA part."""
    from ehyb_spmv_torch.ops import dia

    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    before = (ehyb_wincache.wincache_body.launches,
              ehyb_stream.stream_body.launches, dia.dia_body.launches)
    model = port.EhybSpmv(port.EhybConfig(artifact_cache=False),
                          device="cpu").setup(coo_for(PORT, scrambled))
    assert model.module.wincache is not None and model.dev.dia_offsets
    model.matvec(deterministic_x(scrambled.dimension))
    assert (ehyb_wincache.wincache_body.launches,
            ehyb_stream.stream_body.launches,
            dia.dia_body.launches) == before


def test_f64_flagship_past_residency_runs_the_window_cache(scrambled,
                                                           monkeypatch):
    """A float64 config past x residency takes the window cache with a
    float64 plan (its own slot budget and block, its stats in 8-byte
    values); its product equals the JAX model's (which on the CPU pins no
    Pallas layout, so its artifact is another) at the f32 bound and the
    oracle at rel <= 1e-12."""
    jmodel, model = _f64_models(scrambled, False, monkeypatch)
    assert model.ehyb.ell_val.dtype == np.float64
    plan = model.module.wincache
    assert model.module.branch.startswith("streamed hbm")
    assert plan.cell_val.dtype == torch.float64
    assert plan.slot_rows == ehyb_wincache.SLOT_ROWS_F64
    assert plan.groups == ehyb_wincache.GROUPS_F64
    st = plan.stats
    assert st["cell_bytes"] == 10 * st["compact_cells"]
    assert st["x_bytes"] == 8 * model.ehyb.padded_x_rows
    x = deterministic_x(scrambled.dimension)
    got = model.matvec(x)
    assert rel(got, jmodel.matvec(x)) <= PARITY_TOL
    assert rel(got, oracle_spmv(scrambled, x)) <= F64_ORACLE_TOL


def test_f64_wincache_neumaier_keeps_the_cancelled_row(monkeypatch):
    """On the f64 cancellation matrix past residency (row 0: 100 ones among
    ±1e17 blocks, x all ones) the compensated window cache's plain version
    gives row 0 exactly, as the padded body's compensated plain version
    does, bit for bit; the uncompensated f64 product loses it."""
    from chip_smoke import cancellation_matrix_f64

    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    m = cancellation_matrix_f64()
    x = np.ones(m.dimension)
    for kahan in (False, True):
        model = port.EhybSpmv(port.EhybConfig(
            artifact_cache=False, dtype="float64", compensated_sum=kahan),
            device="cpu").setup(m)
        plan = model.module.wincache
        assert plan is not None and plan.cell_val.dtype == torch.float64
        y = model.matvec(x)
        assert (y[0] == 100.0) == kahan, y[0]
        x_dev = model.prepare_x(x)
        padded = model.ehyb.to_torch(dtype="float64")
        assert torch.equal(
            ehyb_wincache.wincache_body(model.dev, plan, x_dev, kahan),
            ehyb_body(padded, x_dev, compensated=kahan))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_wincache_check_takes_both_types(scrambled, monkeypatch, dtype):
    """The wrapper's checks, which run before any build, take a plan and x
    of either type the models use (the kernel's Kahan flag is a launch
    argument), and refuse an x whose type is not the plan's.  The double
    kernel is built for blocks of up to 512 threads, the float one 1024: a
    plan of more groups is refused where it is built, and by the wrapper
    when its groups were raised after."""
    monkeypatch.setattr(stream_plan, "X_RESIDENT_BYTES", 1024)
    name = "float64" if dtype == torch.float64 else "float32"
    for kahan in (False, True):
        model = port.EhybSpmv(port.EhybConfig(
            artifact_cache=False, dtype=name, compensated_sum=kahan),
            device="cpu").setup(coo_for(PORT, scrambled))
        plan = model.module.wincache
        x = model.prepare_x(deterministic_x(scrambled.dimension))
        assert x.dtype == plan.cell_val.dtype == dtype
        ehyb_wincache._check(model.dev, plan, x)
        other = torch.float32 if dtype == torch.float64 else torch.float64
        with pytest.raises(ValueError, match="x_pad's type"):
            ehyb_wincache._check(model.dev, plan, x.to(other))
    most = ehyb_wincache.MAX_GROUPS_F64 if dtype == torch.float64 \
        else ehyb_wincache.MAX_GROUPS
    assert (most, ehyb_wincache.build_wincache_plan(
        model.ehyb, groups=most).groups) == ((4, 4) if name == "float64"
                                             else (8, 8))
    with pytest.raises(ValueError, match=f"1 to {most} for a {name} body"):
        ehyb_wincache.build_wincache_plan(model.ehyb, groups=most + 1)
    plan.groups = most + 1
    with pytest.raises(ValueError, match=f"takes 1 to {most} groups"):
        ehyb_wincache._check(model.dev, plan, x)

