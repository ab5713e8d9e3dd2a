"""``bench_torch.py``, the port's headline benchmark, on the CPU at small
corpus rows: the child's phase split against the ``EhybMatrix.stats`` of
the JAX host layer, its answer against the JAX oracle (rel <= 5e-6, the
suite's bound), the routed engine's schedule split against the JAX
``RoutedSpmv``, the whole script in one subprocess, no fallback under the
headline, no silent CPU run, the oracle cache in the port's namespace, and
the precision mode (rel <= 1e-12; the baseline runs in f32).  The children
run in-process where the protocol is not what is tested."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu.models.routed as ref_routed
from ehyb_spmv_gpu_tpu.config import EhybConfig as RefConfig
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate as ref_generate

import bench_torch
from ehyb_spmv_torch.core import cache as port_cache
from ehyb_spmv_torch.core import coo as port_coo
from ehyb_spmv_torch.io import generate as port_generate
from test_torch_parity import REF, config_for, host_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_TOL = 5e-6
DWORD_TOL = 1e-12
SPLIT_KEYS = ("ell_steps", "nnz_ell", "nnz_dia", "nnz_er", "nnz_long")
#: Stage-B sub-tiles for the JAX routed builds (test_torch_route.py).
SB_SMALL = "8"
#: corpus row -> the layout the port's flagship settles on there (the JAX
#: host config of that layout is what the phase split is held to).
PARITY_ROWS = {"poisson2d_64": ("sell_mw", 2), "fem3d_16": ("sell_mw", 2),
               "random_16k": ("sell_rx", 4)}


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("corpus"))


def _use_caches(mp, corpus_dir: str, root) -> str:
    """Point the corpus cache, the port's cache namespace and HOME into
    ``root``; returns the port's cache directory."""
    cache = os.path.join(str(root), "ehyb_torch")
    mp.setenv("EHYB_CORPUS_CACHE", corpus_dir)
    mp.setenv("EHYB_TORCH_CACHE_DIR", cache)
    mp.setenv("HOME", os.path.join(str(root), "home"))
    mp.setattr(port_cache, "DEFAULT_CACHE_DIR", cache)
    return cache


@pytest.fixture
def caches(corpus_dir, tmp_path, monkeypatch):
    return _use_caches(monkeypatch, corpus_dir, tmp_path)


@pytest.fixture(scope="module")
def parity_runs(corpus_dir, tmp_path_factory):
    """row -> (the child's result, the oracle it cached) for PARITY_ROWS."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        cache = _use_caches(mp, corpus_dir, tmp_path_factory.mktemp("runs"))
        for name in PARITY_ROWS:
            r = bench_torch.run_model("ehyb", name, 3, "cpu")
            fp = port_cache.matrix_fingerprint(port_generate.load_corpus(name))
            out[name] = (r, np.load(os.path.join(cache, f"{fp}-oracle.npy")))
    return out


@pytest.mark.parametrize("name", list(PARITY_ROWS))
def test_phase_split_matches_the_jax_host_layer(name, parity_runs):
    r, _ = parity_runs[name]
    layout, wps = PARITY_ROWS[name]
    e = host_pipeline(REF, ref_generate.CORPUS[name](),
                      config_for(REF, True, layout, wps))[2]
    assert r["engine"] == "EhybSpmv" and r["backend"] == "cpu"
    assert {k: r[k] for k in SPLIT_KEYS} == {k: int(e.stats.get(k, 0))
                                             for k in SPLIT_KEYS}
    # the CPU runs the plain versions: no kernel launch is counted
    assert r["launches"] == {"K1": 0, "RX": 0, "K9": 0, "WC": 0}
    assert r["card"] is None and r["roofline_frac"] is None


@pytest.mark.parametrize("name", list(PARITY_ROWS))
def test_child_meets_the_jax_oracle(name, parity_runs):
    """The child held its answer at 5e-6 to the oracle it cached, and that
    oracle is the JAX package's."""
    r, y_cached = parity_runs[name]
    m = ref_generate.CORPUS[name]()
    want = oracle_spmv(m, deterministic_x(m.dimension))
    assert np.array_equal(y_cached, want)
    assert 0 <= r["rel_error"] <= ORACLE_TOL
    assert r["gflops"] > 0 and r["iters"] == 3 and r["dword"] is False


def test_routed_stats_match_the_jax_routed_engine(caches, monkeypatch):
    monkeypatch.setenv("EHYB_ROUTE_SB_MAX", SB_SMALL)
    r = bench_torch.run_model("ehyb_routed", "random_16k", 3, "cpu")
    jmodel = ref_routed.RoutedSpmv(RefConfig()).setup(
        ref_generate.CORPUS["random_16k"]())
    assert r["engine"] == "RoutedSpmv" and r["routed_blocks"] == 1
    assert r["nnz_routed"] == sum(b.stats["nnz_routed"]
                                  for b in jmodel.blocks)
    assert r["nnz_spill"] == sum(b.stats["nnz_spill"] for b in jmodel.blocks)
    assert r["nnz_routed"] + r["nnz_spill"] == r["nnz"]
    assert r["rel_error"] <= ORACLE_TOL


def test_whole_script_prints_one_tail(corpus_dir, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(EHYB_CORPUS_CACHE=corpus_dir,
               EHYB_TORCH_CACHE_DIR=str(tmp_path / "ehyb_torch"),
               HOME=str(tmp_path / "home"), EHYB_BENCH_MATRIX="poisson2d_64",
               EHYB_BENCH_SECONDARY="fem3d_16", EHYB_BENCH_GATHER="random_16k",
               EHYB_BENCH_GATHER_MODEL="ehyb_routed", EHYB_BENCH_ITERS="3")
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    tail = json.loads(lines[0])
    assert set(tail) == {"metric", "value", "unit", "vs_baseline",
                         "baseline_model", "gather_wall", "card"}
    assert tail["metric"] == "spmv_gflops_poisson2d_64_cpu"
    assert tail["value"] > 0 and tail["vs_baseline"] > 0
    assert tail["unit"] == "GFLOP/s" and tail["baseline_model"] == "bcoo"
    assert tail["card"] is None
    gw = tail["gather_wall"]
    assert gw["matrix"] == "random_16k" and gw["engine"] == "RoutedSpmv"
    assert gw["nnz_routed"] + gw["nnz_spill"] > 0 and gw["gflops"] > 0


def test_failed_flagship_has_no_fallback(caches, monkeypatch, capsys):
    """An unknown matrix fails the flagship: value 0.0 and exit 1, and no
    other model runs under the headline."""
    monkeypatch.setenv("EHYB_BENCH_MATRIX", "no_such_matrix")
    calls = []
    run_child = bench_torch.run_child

    def record(model, matrix, *a, **kw):
        calls.append((model, matrix))
        return run_child(model, matrix, *a, **kw)

    monkeypatch.setattr(bench_torch, "run_child", record)
    assert bench_torch.main(["--device", "cpu"]) == 1
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tail["value"] == 0.0 and "no_such_matrix" in tail["error"]
    assert calls == [("ehyb", "no_such_matrix")]


def test_no_silent_cpu_run(caches, capsys):
    """Without a card and without ``--device cpu`` the script exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card run would start")
    assert bench_torch.main([]) == 1
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tail["value"] == 0.0 and "backend unavailable" in tail["error"]


def test_oracle_cache_is_the_ports(caches, tmp_path, monkeypatch):
    r1 = bench_torch.run_model("ehyb", "poisson2d_64", 2, "cpu")

    def no_oracle(*a):
        raise AssertionError("the oracle was computed again")

    monkeypatch.setattr(port_coo, "oracle_spmv", no_oracle)
    r2 = bench_torch.run_model("ehyb", "poisson2d_64", 2, "cpu")
    assert (r1["oracle_hit"], r2["oracle_hit"]) == (False, True)
    assert any(f.endswith("-oracle.npy") for f in os.listdir(caches))
    assert not os.path.exists(tmp_path / "home" / ".cache" / "ehyb")


def test_dword_flagship_and_f32_baseline(caches, monkeypatch):
    monkeypatch.setenv("EHYB_BENCH_DWORD", "1")
    fl = bench_torch.run_model("ehyb", "random_16k", 3, "cpu")
    base = bench_torch.run_model("bcoo", "random_16k", 3, "cpu")
    assert fl["dword"] is True and fl["rel_error"] <= DWORD_TOL
    assert fl["nnz_ell"] > 0
    assert base["dword"] is False and base["rel_error"] <= ORACLE_TOL
