"""ehyb_spmv_torch — the EHYB SpMV framework on PyTorch and CUDA (Hopper).

Port of the JAX/Pallas package ``ehyb_spmv_gpu_tpu``, which stays beside it
as the reference.  This package imports ``torch`` and never ``jax``: the
host layer (I/O, planner, partition + RCM ordering, two-level reorder, EHYB
conversion) is a copy of the reference's, and its C++ sources are compiled
from the reference's ``native/`` directory by path.  The streamed SELL body
runs as a hand-written CUDA kernel (``csrc/ehyb_stream.cu``); the ER tail,
long rows, DIA and combine are torch ops.
"""
from .config import EhybConfig, Features
from .core.coo import MatrixCOO, deterministic_x, oracle_spmv
from .core.ehyb import EhybDevice, EhybMatrix, ehyb_from_arrays
from .models.ehyb import EhybPlainSpmv, EhybSpmv
from .utils.validate import compare, rel_error

MODELS = {m.name: m for m in (EhybPlainSpmv, EhybSpmv)}
