"""The EHYB model family — the framework's flagship.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/ehyb.py``.  Pipeline per
``setup`` (mirrors ``main`` → ``matrixReorder`` → ``spmvGPuEHYB``,
``solver_test.c:267-389``): plan → ordering (partition + RCM) → two-level
reorder → ``coo_to_ehyb`` with the mw → rx → quad layout switches → device
upload.

Variants:
  * :class:`EhybPlainSpmv` (``ehyb_xla``) — the plain-torch apply
    (``ops/torch_ops.py``) on whatever plan the config requests;
  * :class:`EhybSpmv` (``ehyb``) — the flagship: it pins the layout the TPU
    flagship pins for its Pallas kernel and runs the SELL body through the
    hand-written CUDA kernel (``ops/ehyb_stream.py``).  It pins that layout
    on every device, so the CPU runs the same artifact through the kernel's
    plain version.

The layout switches use the TPU's per-vreg cycle constants, kept here so that
both packages land on the same ``EhybMatrix``; re-deriving them for the H100
is ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..config import LANES, WINDOW_ALIGN, round_up
from ..core.coo import MatrixCOO
from ..core.convert import coo_to_ehyb
from ..core.ehyb import EhybMatrix
from ..core.planner import Plan, make_plan
from ..core.reorder import Reordering, identity_reordering, two_level_reorder
from ..ops.ehyb_stream import (SUBTILES, TILE_STEPS, X_RESIDENT_BYTES,
                               EhybStreamApply, stream_body_fits)
from ..ops.torch_ops import EhybApply
from ..partition import partition_rows
from ..utils.log import get_logger
from .base import SpmvModel

log = get_logger(__name__)

#: Measured TPU (v5e) full-apply cost per (8,128) body vreg: chunk-sync vs
#: relaxed dual-window vs relaxed quad-window.  Layout arbitration only.
_CYC_MW_VREG = 17.8
_CYC_RX_VREG = 19.9
_CYC_RX4_VREG = 21.2
#: Chunk-sync padding fraction above which the relaxed conversion is tried.
_RELAX_WASTE_GATE = 0.25
#: Relaxed-body padding fraction above which the quad conversion is tried.
_QUAD_WASTE_GATE = 0.35


class EhybPlainSpmv(SpmvModel):
    """EHYB pipeline with the plain-torch apply (reference semantics)."""

    name = "ehyb_xla"

    def _rx_supported(self, e_rx: EhybMatrix) -> bool:
        """Whether this model can run the relaxed layout (the plain model
        always can; the flagship overrides)."""
        return True

    def _post_order_hook(self, m: MatrixCOO) -> None:
        """Called once the reordering is decided, before any conversion
        (the flagship's routed-delegation gate)."""

    def _make_module(self):
        return EhybApply(self.dev)

    def setup(self, m: MatrixCOO) -> "EhybPlainSpmv":
        cfg = self.config
        if cfg.dword_values:
            raise NotImplementedError(
                "double-word precision is not ported yet (ROADMAP Queue 1 "
                "item 8)")
        self.m = m
        dim = m.dimension
        #: Host preprocessing wall-times per phase.
        self.setup_seconds = {}
        _t0 = time.perf_counter()

        self.plan: Plan = make_plan(dim, cfg)
        # cache key = the config AS GIVEN (the layout switches below are
        # deterministic for (matrix, config))
        cfg_key = cfg
        if cfg.artifact_cache:
            from ..core.cache import load_artifacts

            hit = load_artifacts(m, cfg, cfg.cache_dir)
            if hit is not None:
                self.ehyb, self.reordering = hit
                self._post_order_hook(m)
                if self.ehyb.step_win_b.size and cfg.body_layout != "sell_rx":
                    self.config = cfg = dataclasses.replace(
                        cfg, body_layout="sell_rx")
                if self.ehyb.step_win_c.size \
                        and cfg.windows_per_subtile != 4:
                    self.config = cfg = dataclasses.replace(
                        cfg, windows_per_subtile=4)
                self.setup_seconds["cache_load"] = time.perf_counter() - _t0
                self._upload(cfg)
                return self
        if cfg.body_layout in ("sell_mw", "sell_rx") and cfg.features.reorder:
            from ..core.ordering import pick_ordering

            self.reordering: Reordering = pick_ordering(
                m, self.plan, cfg, cfg.ordering)
        elif cfg.features.reorder and self.plan.n_parts > 1:
            labels = partition_rows(m, self.plan.n_parts, cfg.partitioner,
                                    cfg.partition_imbalance)
            self.reordering = two_level_reorder(
                m, labels, self.plan, sort_rows=cfg.features.sort_rows,
                sort_mode=cfg.features.sort_mode)
        else:
            bounds = np.arange(self.plan.n_parts + 1) * self.plan.window_rows
            bounds = np.minimum(bounds, dim)
            bounds[-1] = dim
            self.reordering = identity_reordering(dim, bounds)
            if cfg.features.sort_rows and self.plan.n_parts > 1:
                labels = np.searchsorted(bounds, np.arange(dim),
                                         side="right") - 1
                self.reordering = two_level_reorder(
                    m, labels.astype(np.int32), self.plan, sort_rows=True)

        self.setup_seconds["order"] = time.perf_counter() - _t0
        self._post_order_hook(m)
        _t1 = time.perf_counter()
        m_r = self.reordering.apply_to_matrix(m)
        if (cfg.body_layout == "sell_mw" and cfg.relax_body == "auto"
                and m.nnz > 2_000_000):
            # pre-decide mw vs rx from the sampled estimator instead of
            # paying a chunk-sync conversion the waste gate would discard
            from ..core.ordering import SAMPLE_CAP, estimate_mw_steps

            rr, cc, frac = m_r.row, m_r.col, 1.0
            if m.nnz > SAMPLE_CAP:
                frac = SAMPLE_CAP / m.nnz
                keep_s = np.random.default_rng(0).random(m.nnz) < frac
                rr, cc = rr[keep_s], cc[keep_s]
            est = estimate_mw_steps(
                rr, cc, dim, cfg.slice_rows,
                max(1, int(round(cfg.min_window_group_nnz * frac))))
            if est > 2.2 * (rr.size / 128.0):
                log.info("mw conversion skipped: sampled estimate %.1fx the "
                         "ideal step count — converting relaxed directly",
                         est / (rr.size / 128.0))
                self.config = cfg = dataclasses.replace(
                    cfg, body_layout="sell_rx")
        self.ehyb: EhybMatrix = coo_to_ehyb(m_r, self.reordering, self.plan,
                                            cfg)
        if cfg.body_layout == "sell_mw" and cfg.relax_body == "auto":
            st = self.ehyb.stats
            cells = st["nnz_ell"] + st["waste_ell"]
            if st["nnz_ell"] > 0 and st["waste_ell"] > _RELAX_WASTE_GATE * cells:
                cfg_rx = dataclasses.replace(cfg, body_layout="sell_rx")
                e_rx = coo_to_ehyb(m_r, self.reordering, self.plan, cfg_rx)
                # keep the cheaper body by the per-vreg cycle model
                if (e_rx.stats["ell_steps"] * _CYC_RX_VREG
                        < st["ell_steps"] * _CYC_MW_VREG
                        and self._rx_supported(e_rx)):
                    log.info("relaxed body wins: %d → %d ell steps",
                             st["ell_steps"], e_rx.stats["ell_steps"])
                    self.ehyb = e_rx
                    self.config = cfg = cfg_rx
        if (cfg.body_layout == "sell_rx" and cfg.relax_body == "auto"
                and cfg.windows_per_subtile == 2):
            # quad-window upgrade when the dual-window body still pads
            # heavily (low lane fill)
            st = self.ehyb.stats
            cells = st["nnz_ell"] + st["waste_ell"]
            if st["nnz_ell"] > 0 and st["waste_ell"] > _QUAD_WASTE_GATE * cells:
                cfg4 = dataclasses.replace(cfg, windows_per_subtile=4)
                e4 = coo_to_ehyb(m_r, self.reordering, self.plan, cfg4)
                if (e4.stats["ell_steps"] * _CYC_RX4_VREG
                        < st["ell_steps"] * _CYC_RX_VREG
                        and self._rx_supported(e4)):
                    log.info("quad windows win: %d → %d ell steps",
                             st["ell_steps"], e4.stats["ell_steps"])
                    self.ehyb = e4
                    self.config = cfg = cfg4
        self.setup_seconds["convert"] = time.perf_counter() - _t1
        if cfg.artifact_cache:
            from ..core.cache import save_artifacts

            save_artifacts(m, cfg_key, self.ehyb, self.reordering,
                           cfg.cache_dir)
        _t2 = time.perf_counter()
        self._upload(cfg)
        self.setup_seconds["upload"] = time.perf_counter() - _t2
        self.setup_seconds["total"] = time.perf_counter() - _t0
        log.info("%s ready on %s: %s | setup %s | stats=%s", self.name,
                 self.device, self.plan.describe(),
                 {k: round(v, 2) for k, v in self.setup_seconds.items()},
                 self.ehyb.stats)
        return self

    def _upload(self, cfg) -> None:
        self.dev = self.ehyb.to_torch(dtype=cfg.dtype, device=self.device)
        self.module = self._make_module()

    # x/y move through the reordered space (vectorReorder / vectorRecover,
    # solver_test.c:376,383) — outside the timed region, like the reference.
    def prepare_x(self, x: np.ndarray):
        xr = self.reordering.vector_reorder(np.asarray(x))
        return super().prepare_x(self.ehyb.pad_x(xr.astype(self.config.dtype)))

    def recover_y(self, y) -> np.ndarray:
        y_np = y.detach().cpu().numpy().astype(np.float64)[: self.m.n_rows]
        return self.reordering.vector_recover(y_np)


class EhybSpmv(EhybPlainSpmv):
    """Flagship: EHYB with the hand-written streamed SELL-body kernel.

    Pins the layout of the TPU flagship's Pallas mode (1024-row windows, a
    multi-window SELL packing, int16 columns, sliding windows, slice widths
    in multiples of ``SUBTILES * TILE_STEPS``), runs the same layout
    switches, and applies through :class:`~..ops.ehyb_stream.EhybStreamApply`.
    """

    name = "ehyb"

    #: Post-reorder (slice, window) group fill below which the TPU flagship
    #: hands the matrix to the routed engine.
    _ROUTED_FILL_GATE = 6.0
    #: Below this dimension the TPU flagship decides by a measured A/B
    #: instead (not ported yet: the body is kept there).
    _SMALL_GATE_DIM = 1 << 16

    def _rx_supported(self, e_rx: EhybMatrix) -> bool:
        return stream_body_fits(e_rx, np.dtype(self.config.dtype).itemsize)

    def _make_module(self):
        if self.ehyb.stats.get("nnz_ell", 0) > 0 \
                and not stream_body_fits(self.ehyb):
            raise NotImplementedError(
                "this body breaks the stream-map invariants; the per-slice "
                "TPU bodies that serve it are not ported yet (ROADMAP Queue "
                "2, K5/K6, Queue 1 item 7)")
        return EhybStreamApply(self.dev, kahan=self.config.compensated_sum)

    def _gate_preconditions(self, m: MatrixCOO) -> bool:
        cfg = self.config
        if cfg.routed_delegate != "auto":
            return False
        if (np.dtype(cfg.dtype) != np.float32 or cfg.dword_values
                or cfg.compensated_sum or m.n_rows != m.n_cols):
            return False
        if m.dimension < self._SMALL_GATE_DIM and (
                m.dimension < (1 << 13) or m.nnz < (1 << 18)):
            return False  # tiny matrices: any engine is microseconds
        return m.nnz >= (1 << 18)

    def _post_order_hook(self, m: MatrixCOO) -> None:
        """The structural fill sample of the TPU flagship's routed gate.
        Where the TPU would hand the matrix to the routed or degree-split
        engine, raise: those engines are not ported yet."""
        if not self._gate_preconditions(m):
            return
        if m.dimension < self._SMALL_GATE_DIM:
            return  # the measured small-matrix A/B gate: not ported yet
        # mean fill of sampled post-reorder (128-row slice, 1024-col window)
        # groups: every 97th slice, all of its entries
        o2n = self.reordering.old_to_new
        r_new = o2n[m.row.astype(np.int64)]
        pick = (r_new // LANES) % 97 == 0
        r_s = r_new[pick]
        c_s = o2n[m.col[pick].astype(np.int64)]
        gkey = (r_s // LANES) * (m.dimension // 1024 + 1) + c_s // 1024
        fill = r_s.shape[0] / max(np.unique(gkey).shape[0], 1)
        if fill > self._ROUTED_FILL_GATE:
            return
        raise NotImplementedError(
            f"gather-wall structure (post-reorder group fill {fill:.1f} <= "
            f"{self._ROUTED_FILL_GATE}): the routed and degree-split engines "
            "are not ported yet (ROADMAP Queue 1 item 5); pass "
            "routed_delegate='never' to keep the EHYB body")

    def setup(self, m: MatrixCOO) -> "EhybSpmv":
        cfg = self.config
        layout = cfg.body_layout \
            if cfg.body_layout in ("sell_cs", "sell_rx") else "sell_mw"
        feats = cfg.features
        if layout == "sell_mw" and feats.sort_mode == "density":
            feats = dataclasses.replace(feats, sort_mode="pattern")
        # window-local columns fit int16 (the reference's own choice,
        # spmv.h:46), halving the index stream
        idx_dtype = cfg.index_dtype
        if idx_dtype == "int32" and WINDOW_ALIGN <= 32768:
            idx_dtype = "int16"
        sliding = cfg.sliding_windows
        if sliding is None:
            # the TPU's rule, so both packages pick the same windows (the
            # CUDA kernel takes 128-aligned windows at any x size)
            x_bytes = (round_up(m.dimension, LANES) + WINDOW_ALIGN) \
                * np.dtype(cfg.dtype).itemsize
            est_sub_bytes = 4 * int(1.5 * m.nnz / (LANES * 8))
            sliding = (x_bytes <= X_RESIDENT_BYTES
                       or est_sub_bytes <= 800 * 1024)
        self.config = dataclasses.replace(
            cfg, window_rows=WINDOW_ALIGN, body_layout=layout,
            width_align=SUBTILES * TILE_STEPS, index_dtype=idx_dtype,
            sliding_windows=sliding, features=feats)
        return super().setup(m)
