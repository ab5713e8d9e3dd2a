"""ehyb_spmv_torch — the EHYB SpMV framework on PyTorch and CUDA (Hopper).

Port of the JAX/Pallas package ``ehyb_spmv_gpu_tpu``, which stays beside it
as the reference.  This package imports ``torch`` and never ``jax``: the
host layer (I/O, planner, partition + RCM ordering, two-level reorder, EHYB
conversion, routed schedules) is a copy of the reference's, and so are its
C++ sources (``native/*.cpp``).  The streamed SELL body runs as a
hand-written CUDA kernel (``csrc/ehyb_stream.cu``); the ER tail, long rows,
DIA and combine are torch ops.  Gather-wall matrices go to the routed engine,
whose two stages are CUDA kernels too (``csrc/route_at.cu``,
``csrc/route_b.cu``).
"""
from .config import EhybConfig, Features
from .core.coo import MatrixCOO, deterministic_x, oracle_spmv
from .core.ehyb import EhybDevice, EhybMatrix, ehyb_from_arrays
from .models.ehyb import EhybPlainSpmv, EhybSpmv
from .models.hybrid import DegreeSplitSpmv
from .models.routed import RoutedSpmv
from .utils.validate import compare, rel_error

MODELS = {m.name: m for m in (EhybPlainSpmv, EhybSpmv, RoutedSpmv,
                              DegreeSplitSpmv)}
