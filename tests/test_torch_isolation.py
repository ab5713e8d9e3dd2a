"""The port stands alone: it and chip_smoke.py import neither JAX nor the JAX
package, the smoke script refuses to run without a CUDA device, CUDA
requests raise where there is none, and the CLI runs on the CPU when asked."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from ehyb_spmv_torch import EhybConfig, EhybSpmv, cli
from ehyb_spmv_torch.ops import ehyb_stream

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
    with pytest.raises(RuntimeError, match="CUDA"):
        ehyb_stream.build_kernel()
    with pytest.raises(RuntimeError, match="CUDA"):
        EhybSpmv(EhybConfig(), device="cuda")


def test_cli_device_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EHYB_CORPUS_CACHE", str(tmp_path))
    assert cli.main(["-g", "poisson2d_64", "-i", "5", "--device", "cpu",
                     "--json"]) == 0
    assert '"device": "cpu"' in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert cli.main(["-g", "poisson2d_64", "-i", "5"]) != 0
