"""SpMV model base: the prepare → apply → recover pipeline contract.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/base.py``.  ``setup`` does the
one-time host preprocessing and the device upload; ``prepare_x`` and
``recover_y`` are the vector permutations outside the timed region
(``vectorReorder``/``vectorRecover``, ``solver_test.c:376,383``); ``apply``
runs the device apply module, the only thing inside the benchmark loop.

The model runs on the device it is given; a CUDA request without a CUDA
device raises.  PyTorch runs eagerly, so there is no jit and no
const-vs-args operand mode (that exists only for TPU VMEM prestaging).
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np
import torch

from ..config import EhybConfig
from ..core.coo import MatrixCOO


class SpmvModel(abc.ABC):
    """Base class for SpMV strategies."""

    name: str = "base"

    def __init__(self, config: Optional[EhybConfig] = None, *,
                 device):
        self.config = config or EhybConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{self.name}: device {self.device} requested "
                               "but CUDA is not available")
        self.m: Optional[MatrixCOO] = None
        #: The device apply: ``module(x_dev)`` → y in the model's layout.
        self.module: Optional[torch.nn.Module] = None

    # -- one-time host preprocessing ---------------------------------------
    @abc.abstractmethod
    def setup(self, m: MatrixCOO) -> "SpmvModel":
        """Plan/partition/reorder/convert + device upload.  Returns self."""

    # -- vector in/out ------------------------------------------------------
    def prepare_x(self, x: np.ndarray) -> torch.Tensor:
        """Host x (original ordering) → device tensor in the model's layout."""
        return torch.as_tensor(np.asarray(x, dtype=self.config.dtype),
                               device=self.device)

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        """Device y (model layout) → host f64 vector in the original ordering."""
        return y.detach().cpu().numpy().astype(np.float64)[: self.m.n_rows]

    # -- the timed device op ------------------------------------------------
    @torch.no_grad()
    def apply(self, x_dev: torch.Tensor) -> torch.Tensor:
        """One SpMV in the model's layout."""
        return self.module(x_dev)

    # -- conveniences -------------------------------------------------------
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """End-to-end y = A·x (original ordering, host in/out)."""
        return self.recover_y(self.apply(self.prepare_x(x)))

    @torch.no_grad()
    def iterate(self, x_dev: torch.Tensor, n_iters: int,
                eps: float = 0.0) -> torch.Tensor:
        """``n_iters`` chained SpMVs for benchmarking: y_k = A·(x + eps·y_{k-1}).

        With eps = 0 the result equals a single A·x, but every iteration
        reads the previous one's y, so no iteration can be skipped — the
        honest launch loop of the reference (``spmv.cu:110-116``)."""
        y = self.apply(x_dev)
        for _ in range(n_iters - 1):
            y = self.apply(torch.add(x_dev, _resize_like(y, x_dev),
                                     alpha=eps))
        return y


def _resize_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pad/trim y's last axis to x's (models emit a padded y whose length
    differs from the padded x)."""
    n, m = x.shape[-1], y.shape[-1]
    if m == n:
        return y
    if m > n:
        return y[..., :n]
    return torch.nn.functional.pad(y, (0, n - m))
