"""Degree-split hybrid — each engine takes exactly the regime it is best at.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/hybrid.py``.  A heavy-tailed
gather-wall matrix (power-law row degrees over uniform random columns)
defeats both single engines: the EHYB body's (slice, window) fill collapses
only when rows are sparse, and the routed engine wants bounded row degrees
(degree dispersion overflows its cells into the spill tail).  So split by
ROW DEGREE where the two collapse conditions cross (deg >= 48 <=> pooled
fill >= 6, the delegation gate): the dense rows form an EHYB sub-matrix run
by the flagship (K1), the bounded-degree remainder routes (the one-pass
routed kernel, ``csrc/route_xcache.cu``).  The
routed sub-matrix is built in the EHYB reordering's permuted space, so both
engines consume the same permuted x and emit permuted y, and one device add
combines them.  Rows are disjoint, so the sum is exact.

No kernel of its own: it composes :class:`~.ehyb.EhybSpmv` and
:class:`~.routed.RoutedSpmv`.  ``iterate`` is the base class's eager loop,
which chains y into both engines' x forms.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.coo import MatrixCOO
from ..utils.log import get_logger
from .base import SpmvModel

log = get_logger(__name__)

#: Row-degree split point: pooled (slice, window) fill = deg * 128/1024,
#: so deg >= 48 puts a slice of such rows at fill >= 6 — exactly the
#: delegation gate's body-collapse bound.  EHYB_DEGREE_SPLIT overrides.
DEGREE_SPLIT = 48

#: Minimum nnz fraction in dense rows for the split to be worth two
#: engines (below this the routed engine alone is the right answer).
MIN_DENSE_FRAC = 0.15


def degree_split_stats(m: MatrixCOO, threshold: int = None):
    """(dense_row_mask, nnz_dense_fraction) for the gate's split decision."""
    t = threshold or int(os.environ.get("EHYB_DEGREE_SPLIT", DEGREE_SPLIT))
    counts = np.bincount(m.row, minlength=m.dimension)
    dense = counts >= t
    frac = float(counts[dense].sum()) / max(m.nnz, 1)
    return dense, frac


class DegreeSplitSpmv(SpmvModel):
    """EHYB body for rows of degree >= the split, routed engine for the
    bounded-degree remainder; one device add in the shared permuted space."""

    name = "ehyb_split"

    def setup(self, m: MatrixCOO,
              threshold: Optional[int] = None) -> "DegreeSplitSpmv":
        from .ehyb import EhybSpmv
        from .routed import RoutedSpmv

        self.m = m
        self.setup_seconds = {}
        self.ehyb = None  # callers take the bytes_model() branch
        t0 = time.perf_counter()
        dense, frac = degree_split_stats(m, threshold)
        dmask = dense[m.row]
        log.info("degree split: %d dense rows carry %.1f%% of nnz",
                 int(dense.sum()), 100 * frac)
        md = MatrixCOO(m.n_rows, m.n_cols, m.row[dmask], m.col[dmask],
                       m.val[dmask])
        ms = MatrixCOO(m.n_rows, m.n_cols, m.row[~dmask], m.col[~dmask],
                       m.val[~dmask])
        # the sub-model must not re-enter the delegation gate
        cfg_e = dataclasses.replace(self.config, routed_delegate="never")
        self.e = EhybSpmv(cfg_e, device=self.device).setup(md)
        perm = self.e.reordering.old_to_new
        msp = MatrixCOO(m.n_rows, m.n_cols,
                        perm[ms.row.astype(np.int64)].astype(np.int32),
                        perm[ms.col.astype(np.int64)].astype(np.int32),
                        ms.val)
        # external_order: the hybrid's shared space IS the EHYB permutation;
        # the routed sub-engine builds identity-dst on it so both outputs
        # combine with one add and no per-iteration scatter
        self.r = RoutedSpmv(self.config, external_order=True,
                            device=self.device).setup(msp)
        for part in (self.e, self.r):
            for k, v in part.setup_seconds.items():
                self.setup_seconds[k] = self.setup_seconds.get(k, 0.0) + v
        self.setup_seconds["total"] = time.perf_counter() - t0
        log.info("%s ready: body %.1f%% of nnz (ELL waste %.0f%%), routed "
                 "%.1f%% (spill %d)", self.name, 100 * frac,
                 100 * self.e.ehyb.stats["waste_ell"]
                 / max(self.e.ehyb.stats["nnz_ell"]
                       + self.e.ehyb.stats["waste_ell"], 1),
                 100 * (1 - frac),
                 sum(b.stats.get("nnz_spill", 0) for b in self.r.blocks))
        return self

    # -- vector plumbing (shared permuted space) ----------------------------
    def prepare_x(self, x: np.ndarray):
        xp = self.e.reordering.vector_reorder(np.asarray(x))
        return (self.e.prepare_x(x), self.r.prepare_x(xp))

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        y_np = y.detach().cpu().numpy().astype(np.float64)[: self.m.n_rows]
        return self.e.reordering.vector_recover(y_np)

    @torch.no_grad()
    def apply(self, x_dev) -> torch.Tensor:
        x_e, x_r = x_dev
        n = self.m.n_rows
        return self.e.apply(x_e)[:n] + self.r.apply(x_r)[:n]

    def bytes_model(self) -> int:
        return self.e.bytes_model() + self.r.bytes_model()
