"""ehyb_spmv_torch — the EHYB SpMV framework on PyTorch and CUDA (Hopper).

Port of the JAX/Pallas package ``ehyb_spmv_gpu_tpu``, which stays beside it
as the reference.  This package imports ``torch`` and never ``jax``: the
host layer (I/O, planner, partition + RCM ordering, two-level reorder, EHYB
conversion, routed schedules) is a copy of the reference's, and so are its
C++ sources (``native/*.cpp``).  The streamed SELL body runs as a
hand-written CUDA kernel (``csrc/ehyb_stream.cu``); the ER tail, long rows
and combine are torch ops, DIA a CUDA kernel (``csrc/dia.cu``), and a body
past the TPU's x residency runs through an x-window cache
(``csrc/ehyb_wincache.cu``).  Gather-wall matrices go to the routed engine,
whose schedule runs as one CUDA kernel over x chunks staged in shared
memory (``csrc/route_xcache.cu``); below 65,536 rows the flagship's gate
decides by timing both engines on the card.  The precision mode
(``dword_values``, ``ops/dword.py``; ``ehyb``, ``ehyb_xla`` and ``hyb``)
runs the body and DIA kernels in f64.  The baselines (``csr``, ``bcoo``,
``hyb``), the CG and power-iteration solvers (``models/solver.py``) and the
chained benchmark loop run over any model; on a card every loop replays
CUDA graphs of the apply.  On the CPU every kernel's wrapper takes its
plain PyTorch version.
"""
from .config import EhybConfig, Features
from .core.coo import MatrixCOO, MatrixCSR, deterministic_x, oracle_spmv
from .core.convert import coo_to_ehyb
from .core.ehyb import EhybDevice, EhybMatrix, ehyb_from_arrays
from .core.planner import Plan, make_plan
from .core.reorder import Reordering, two_level_reorder
from .models.csr import BcooSpmv, CsrSpmv
from .models.ehyb import EhybPlainSpmv, EhybSpmv, HybSpmv
from .models.hybrid import DegreeSplitSpmv
from .models.routed import RoutedSpmv
from .utils.validate import compare, rel_error

MODELS = {m.name: m for m in
          (CsrSpmv, BcooSpmv, EhybPlainSpmv, EhybSpmv, HybSpmv, RoutedSpmv,
           DegreeSplitSpmv)}
