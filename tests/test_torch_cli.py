"""The port's CLI on the CPU: every flag of the JAX package's CLI but
``--platform`` (the port's ``--device``), the same argv → EhybConfig
mapping, all seven models, and ``--dword`` (the precision mode) held to
the JAX mode's bound against the exact-f64 oracle."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

import ehyb_spmv_gpu_tpu as ref
from ehyb_spmv_gpu_tpu import cli as ref_cli

import ehyb_spmv_torch as port
from ehyb_spmv_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_holds_every_reference_flag():
    want = _options(ref_cli.build_parser()) - {"--platform"}
    assert want <= _options(cli.build_parser())
    assert set(cli.build_parser().parse_args(["-g", "x"]).__dict__) >= {
        a.dest for a in ref_cli.build_parser()._actions
        if a.dest not in ("help", "platform")}


class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", [
    [],
    ["--window", "2048", "--dtype", "float64", "--partitioner", "blocks"],
    ["--no-reorder", "--no-sort", "--no-dia", "--cache"],
    ["--layout", "sell_rx", "--windows-per-subtile", "4", "--no-relax"],
    ["--compensated", "--layout", "sell_cs"],
    ["--dword"],
])
def test_config_mapping_matches_the_reference_cli(argv, monkeypatch):
    """The JAX CLI builds its config inline; a stand-in model records it."""
    seen = []

    class Record:
        def __init__(self, cfg):
            seen.append(cfg)
            raise _Captured

    monkeypatch.setitem(ref.MODELS, "ehyb_xla", Record)
    with pytest.raises(_Captured):
        ref_cli.main(["-g", "diag4k", "--model", "ehyb_xla", *argv])
    got = cli.config_from_args(cli.build_parser().parse_args(
        ["-g", "diag4k", *argv]))
    assert dataclasses.asdict(got) == dataclasses.asdict(seen[0])


@pytest.mark.parametrize("name", sorted(ref.MODELS))
def test_every_model_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path))
    assert name in port.MODELS
    assert cli.main(["-g", "poisson2d_64", "-i", "3", "--device", "cpu",
                     "--model", name, "--json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["valid"] and res["model"] == name and res["device"] == "cpu"


def test_dword_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path))
    assert cli.main(["-g", "poisson2d_64", "-i", "3", "--device", "cpu",
                     "--dword", "--json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["valid"] and res["rel_error"] <= 1e-12, res["rel_error"]


def test_list_corpus(capsys):
    assert cli.main(["--list-corpus"]) == 0
    out = capsys.readouterr().out.split()
    assert "fem3d_32" in out and "permuted_poisson_512" in out


def test_profile_and_trace_dir(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path))
    assert cli.main(["-g", "poisson2d_64", "-i", "2", "--device", "cpu",
                     "--model", "ehyb_xla", "--profile", "--trace-dir",
                     str(tmp_path / "tr")]) == 0
    out = capsys.readouterr().out
    assert "roofline audit" in out and "phase breakdown" in out
    assert os.listdir(tmp_path / "tr")


def test_module_entry_with_reference_flags(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["EHYB_CORPUS_CACHE"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "ehyb_spmv_torch", "-g", "diag4k", "-i", "2",
         "--device", "cpu", "--model", "hyb", "--no-dia", "--window", "4096",
         "--dtype", "float64"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PASS" in proc.stdout
