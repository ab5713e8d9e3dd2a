"""Sharded degree-split hybrid — the heavy-tail engine over
``torch.distributed``.

Port counterpart of ``ehyb_spmv_gpu_tpu/parallel/hybrid.py``: rows of
degree >= the split form a dense sub-matrix driven by the sharded EHYB
body (``parallel/spmv.py``); the bounded-degree remainder — rebuilt in the
EHYB reordering's PERMUTED space so both engines share one output space —
runs the sharded routed engine (``parallel/routed.py``).  Both engines cut
the rows into the same spans (``round_up(cdiv(dim, D), 128)`` rows a
rank), so each rank adds its two slices, and ``recover_y`` gathers the
ranks' slices and returns to the original order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import EhybConfig
from ..core.coo import MatrixCOO
from ..models.base import SpmvModel, _resize_like
from ..models.hybrid import degree_split_stats
from ..utils.log import get_logger
from .comm import all_gather_rows, group_rank_world, rank_device
from .routed import ShardedRoutedSpmv
from .spmv import ShardedEhybSpmv

log = get_logger(__name__)


class ShardedDegreeSplitSpmv(SpmvModel):
    """One rank of the sharded EHYB body on dense rows plus the sharded
    routed tail on the rest, added in the shared permuted space.  ``group``
    and ``device`` as in :class:`~.spmv.ShardedEhybSpmv`."""

    name = "ehyb_split_sharded"

    def __init__(self, config: Optional[EhybConfig] = None, *, group=None,
                 device=None):
        self.group, self.rank, self.n_dev = group_rank_world(group)
        super().__init__(config, device=rank_device(device, self.rank))
        self.loop = "eager"

    def setup(self, m: MatrixCOO,
              threshold: Optional[int] = None) -> "ShardedDegreeSplitSpmv":
        self.m = m
        self.setup_seconds = {}
        self.ehyb = None
        t0 = time.perf_counter()
        dense, frac = degree_split_stats(m, threshold)
        dmask = dense[m.row]
        log.info("sharded degree split: %d dense rows carry %.1f%% of nnz",
                 int(dense.sum()), 100 * frac)
        md = MatrixCOO(m.n_rows, m.n_cols, m.row[dmask], m.col[dmask],
                       m.val[dmask])
        ms = MatrixCOO(m.n_rows, m.n_cols, m.row[~dmask], m.col[~dmask],
                       m.val[~dmask])
        # the sub-model must not re-enter the delegation gate
        cfg_e = dataclasses.replace(self.config, routed_delegate="never")
        self.e = ShardedEhybSpmv(cfg_e, group=self.group,
                                 device=self.device).setup(md)
        perm = self.e.reordering.old_to_new
        msp = MatrixCOO(m.n_rows, m.n_cols,
                        perm[ms.row.astype(np.int64)].astype(np.int32),
                        perm[ms.col.astype(np.int64)].astype(np.int32),
                        ms.val)
        self.r = ShardedRoutedSpmv(self.config, group=self.group,
                                   device=self.device).setup(msp)
        if self.r.r_sh != self.e.sharded.rows_per_dev:
            raise ValueError(f"row spans differ: EHYB "
                             f"{self.e.sharded.rows_per_dev}, routed "
                             f"{self.r.r_sh}")
        for part in (self.e, self.r):
            for k, v in part.setup_seconds.items():
                self.setup_seconds[k] = self.setup_seconds.get(k, 0.0) + v
        self.setup_seconds["total"] = time.perf_counter() - t0
        self.loop = self.e.loop
        log.info("%s rank %d ready: body %.1f%% of nnz, routed %.1f%% "
                 "(spill %d)", self.name, self.rank, 100 * frac,
                 100 * (1 - frac),
                 sum(rm.stats.get("nnz_spill", 0) for rm, _ in self.r.blocks))
        return self

    # -- vector plumbing (shared permuted space) ----------------------------
    def prepare_x(self, x: np.ndarray):
        xp = self.e.reordering.vector_reorder(np.asarray(x))
        return (self.e.prepare_x(x), self.r.prepare_x(xp))

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        y_all = all_gather_rows(self.group, self.n_dev, y)
        y_np = y_all.detach().cpu().numpy().astype(
            np.float64)[: self.m.n_rows]
        return self.e.reordering.vector_recover(y_np)

    @torch.no_grad()
    def apply(self, x_dev) -> torch.Tensor:
        x_e, x_r = x_dev
        # disjoint rows of one span; padding rows are zeros on both sides
        y_e = self.e.apply(x_e)
        return y_e + _resize_like(self.r.apply(x_r), y_e)

    @torch.no_grad()
    def iterate(self, x_dev, n_iters: int, eps: float = 0.0) -> torch.Tensor:
        if self.loop == "eager":
            return self.iterate_eager(x_dev, n_iters, eps)
        return super().iterate(x_dev, n_iters, eps)

    def roofline_phases(self) -> dict:
        return {f"{part.name} {k}": v
                for part in (self.e, self.r)
                for k, v in part.roofline_phases().items()}
