"""Baseline SpMV models: a COO gather + scatter-add, and the vendor library.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/csr.py``.  They play the role
of the reference's cuSPARSE comparison paths (``spmvGeneric``
``spmv.cu:135-281``, ``solverGPuUnprecondCUSPARSE`` ``spmv.cu:282-437``):
simple formats, no reordering, no windows — the numbers EHYB has to beat.
Neither is a Pallas kernel in the JAX package (plain XLA, and
``jax.experimental.sparse``), so plain torch and the library are their
counterparts here.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.coo import MatrixCOO
from ..ops.torch_ops import coo_spmv
from .base import SpmvModel


class CsrSpmv(SpmvModel):
    """Row-sorted COO SpMV: gather x by column, ``index_add_`` by row."""

    name = "csr"

    def setup(self, m: MatrixCOO) -> "CsrSpmv":
        t0 = time.perf_counter()
        self.m = m
        ms = m.sorted_by_row()
        dev = self.device
        self._row = torch.as_tensor(ms.row.astype(np.int32), device=dev)
        self._col = torch.as_tensor(ms.col.astype(np.int32), device=dev)
        self._val = torch.as_tensor(ms.val.astype(self.config.dtype),
                                    device=dev)
        self.setup_seconds = {"upload": time.perf_counter() - t0}
        return self

    @torch.no_grad()
    def apply(self, x_dev: torch.Tensor) -> torch.Tensor:
        return coo_spmv(self._row, self._col, self._val, x_dev,
                        self.m.n_rows)

    def roofline_phases(self) -> dict:
        vb = np.dtype(self.config.dtype).itemsize
        return {"x/y vectors": (0, (self.m.n_cols + self.m.n_rows) * vb),
                "entries": (2 * self.m.nnz, self.m.nnz * (vb + 8))}


class BcooSpmv(SpmvModel):
    """A ``torch.sparse_csr_tensor`` matvec — the vendor baseline: cuSPARSE
    on a card, as ``jax.experimental.sparse`` is on the TPU."""

    name = "bcoo"

    def setup(self, m: MatrixCOO) -> "BcooSpmv":
        t0 = time.perf_counter()
        self.m = m
        csr = m.to_csr()
        self._mat = torch.sparse_csr_tensor(
            torch.as_tensor(csr.row_ptr.astype(np.int32)),
            torch.as_tensor(csr.col.astype(np.int32)),
            torch.as_tensor(csr.val.astype(self.config.dtype)),
            size=(m.n_rows, m.n_cols)).to(self.device)
        self.setup_seconds = {"upload": time.perf_counter() - t0}
        return self

    @torch.no_grad()
    def apply(self, x_dev: torch.Tensor) -> torch.Tensor:
        return torch.mv(self._mat, x_dev)

    def roofline_phases(self) -> dict:
        vb = np.dtype(self.config.dtype).itemsize
        return {"x/y vectors": (0, (self.m.n_cols + self.m.n_rows) * vb),
                "csr": (2 * self.m.nnz,
                        self.m.nnz * (vb + 4) + (self.m.n_rows + 1) * 4)}
