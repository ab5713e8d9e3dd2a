"""Build the port's CUDA kernels with ``nvcc`` into a ctypes-loadable library.

Each library is compiled at first use from the sources in
``ehyb_spmv_torch/csrc/`` (a plain C entry point, no PyTorch headers, so a
build takes seconds) for ``sm_90a``, into ``ehyb_spmv_torch/build/``.  The
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded; the build writes a temporary
file and renames it into place, so concurrent processes never load a
half-written library.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuiltLibrary:
    path: str
    #: Seconds the nvcc run took in this process (0.0 when already built).
    seconds: float
    #: nvcc's output (ptxas register and shared-memory report).
    log: str


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    the PATH; raises when none exists."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build_cuda_library(name: str, sources: Sequence[str]) -> BuiltLibrary:
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library and return where it is."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return BuiltLibrary(lib, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuiltLibrary(lib, time.perf_counter() - t0,
                        proc.stdout + proc.stderr)
