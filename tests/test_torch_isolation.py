"""The port stands alone: it, chip_smoke.py, bench_torch.py and
scripts_torch/ import neither JAX nor the JAX package, it compiles its own
copies of the C++ sources, the smoke script refuses to run without a CUDA
device, CUDA requests raise where there is none, and the CLI runs on the
CPU when asked."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from ehyb_spmv_torch import EhybConfig, EhybSpmv, RoutedSpmv, cli, native
from ehyb_spmv_torch.ops import dia, ehyb_stream, ehyb_wincache, route_xcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ehyb_spmv_gpu_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import ehyb_spmv_torch
for mod in pkgutil.walk_packages(ehyb_spmv_torch.__path__,
                                 "ehyb_spmv_torch."):
    importlib.import_module(mod.name)
import chip_smoke
import chip_wincache_sweep
import chip_routed_sweep
import chip_dia_sweep
import chip_k1_sweep
import chip_sharded_ab
import bench_torch
import scripts_torch.sweep
import scripts_torch.sweep_table
import scripts_torch.prewarm
for name in ("ops.stream_plan", "ops.dia", "ops.ehyb_wincache",
             "ops.route_xcache", "ops.stream_cells"):
    assert f"ehyb_spmv_torch.{name}" in sys.modules, name
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "ehyb_spmv_gpu_tpu")]
assert not bad, bad
print("IMPORTS OK")
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_smoke_import_without_jax():
    proc = _run(["-c", _BLOCKED_IMPORTS], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTS OK" in proc.stdout


def _code_lines(path):
    """The file's lines with ``//`` comments and trailing blanks dropped."""
    with open(path) as f:
        return [ln.split("//")[0].rstrip() for ln in f]


@pytest.mark.parametrize("stem", ["partition", "rcm", "diaextract",
                                  "mtxparse", "routecolor"])
def test_native_sources_are_the_ports_own_copies(stem):
    """The port compiles its own copy of each C++ source, kept equal in code
    to the JAX package's file (comments may differ), so both pack the same
    artifacts and drift is caught here."""
    pkg = os.path.join(REPO, "ehyb_spmv_torch")
    src_dir = os.path.realpath(native.SRC_DIR)
    assert os.path.commonpath([src_dir, os.path.realpath(pkg)]) \
        == os.path.realpath(pkg)
    ours = os.path.join(src_dir, f"{stem}.cpp")
    ref = os.path.join(REPO, "ehyb_spmv_gpu_tpu", "native", f"{stem}.cpp")
    assert _code_lines(ours) == _code_lines(ref)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke script would run")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cuda_requests_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for build in (ehyb_stream.build_kernel, route_xcache.build_kernel,
                  dia.build_kernel, ehyb_wincache.build_kernel):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    for model in (EhybSpmv, RoutedSpmv):
        with pytest.raises(RuntimeError, match="CUDA"):
            model(EhybConfig())          # the card is the default device


def test_cli_device_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path))
    assert cli.main(["-g", "poisson2d_64", "-i", "5", "--device", "cpu",
                     "--json"]) == 0
    assert '"device": "cpu"' in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert cli.main(["-g", "poisson2d_64", "-i", "5"]) != 0
