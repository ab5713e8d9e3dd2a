"""The port's corpus sweep on the CPU: ``scripts_torch/sweep.py`` over two
tiny rows writes its table (and leaves the TPU's ``BENCH_SWEEP.md`` as it
was), ``scripts_torch/sweep_table.py`` rebuilds the same rows from the
sweep's log, the sweep refuses to run on the CPU unasked, and
``scripts_torch/prewarm.py`` reports MISS then HIT and writes no
small-gate verdict on the CPU."""
import glob
import hashlib
import os
import subprocess
import sys

import pytest
import torch

import ehyb_spmv_torch as port
from ehyb_spmv_torch.core import cache as port_cache
from ehyb_spmv_torch.io import generate as port_generate
from scripts_torch import prewarm, sweep, sweep_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("diag4k", "poisson2d_64")


def _digest(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _table_rows(text):
    """The table's data rows (its header row dropped)."""
    return [ln for ln in text.splitlines() if ln.startswith("| ")][1:]


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """(stdout of a sweep over ROWS, the table it wrote, the TPU's table
    and the repo's H100 table before and after)."""
    tmp = tmp_path_factory.mktemp("sweep")
    records = [os.path.join(REPO, f) for f in ("BENCH_SWEEP.md",
                                               "BENCH_SWEEP_H100.md")]
    before = [_digest(p) for p in records]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(EHYB_CORPUS_CACHE=str(tmp / "corpus"),
               EHYB_TORCH_CACHE_DIR=str(tmp / "ehyb_torch"),
               HOME=str(tmp / "home"), EHYB_BENCH_ITERS="3")
    out = tmp / "table.md"
    proc = subprocess.run(
        [sys.executable, "scripts_torch/sweep.py", "--device", "cpu",
         "--models", "ehyb,bcoo", "--out", str(out), *ROWS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, out.read_text(), before, [_digest(p) for p in records]


def test_sweep_writes_its_table_and_leaves_the_tpus(swept):
    _, table, before, after = swept
    assert after == before
    rows = _table_rows(table)
    assert [r.split("|")[1].strip() for r in rows] == list(ROWS)
    for r in rows:
        cells = [c.strip() for c in r.split("|")[1:-1]]
        assert cells[2] == "EhybSpmv" and float(cells[3]) > 0
        assert cells[8:11] == ["-", "-", "-"]          # routed, split, csr
        assert float(cells[11]) >= 0                   # bcoo
    assert "FAIL" not in table


def test_sweep_table_rebuilds_the_rows(swept, tmp_path):
    log_text, table, _, _ = swept
    log = tmp_path / "sweep.log"
    log.write_text(log_text)
    out = tmp_path / "rebuilt.md"
    assert sweep_table.main([str(log), str(out)]) == 0
    assert _table_rows(out.read_text()) == _table_rows(table)
    assert len(sweep_table.parse(str(log))) == len(ROWS)


def test_sweep_refuses_the_cpu_unasked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweep would run")
    out = tmp_path / "table.md"
    assert sweep.main(["--out", str(out), "diag4k"]) == 1
    assert not out.exists()


def test_sweep_columns():
    assert sweep.row_models("random_4m", sweep.COLUMNS) == [
        "ehyb", "csr", "bcoo", "ehyb_routed"]
    assert sweep.row_models("powerlaw_1m", ["ehyb", "ehyb_split"]) == [
        "ehyb", "ehyb_split"]
    assert sweep.row_models("fem3d_32", ["ehyb_routed"]) == []
    assert len(sweep.DEFAULT) == 12


def test_prewarm_miss_then_hit_without_a_gate_verdict(tmp_path, monkeypatch,
                                                      capsys):
    """random_16k is scattered enough for the small gate to time its
    engines on a card; on the CPU it does not, so no verdict is cached."""
    cache = str(tmp_path / "ehyb_torch")
    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path / "corpus"))
    monkeypatch.setattr(port_cache, "DEFAULT_CACHE_DIR", cache)
    for status in ("MISS", "HIT"):
        assert prewarm.main(["random_16k"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].split()[-1] == status          # the oracle
        assert [ln.split()[1] for ln in lines[1:]] == ["ehyb:", "ehyb_routed:"]
        assert all(f" {status} [" in ln for ln in lines[1:]), lines
    assert glob.glob(os.path.join(cache, "*gate*")) == []
    model = port.EhybSpmv(port.EhybConfig(artifact_cache=True),
                          device="cpu").setup(
        port_generate.load_corpus("random_16k"))
    est, floor = model.small_gate["est"], model.small_gate["floor"]
    assert est > model._SMALL_EST_K * floor and not model._can_measure()
    assert glob.glob(os.path.join(cache, "*gate*")) == []
