"""The EHYB model family — the framework's flagship.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/ehyb.py``.  Pipeline per
``setup`` (mirrors ``main`` → ``matrixReorder`` → ``spmvGPuEHYB``,
``solver_test.c:267-389``): plan → ordering (partition + RCM) → two-level
reorder → ``coo_to_ehyb`` with the mw → rx → quad layout switches → device
upload.

Variants:
  * :class:`EhybPlainSpmv` (``ehyb_xla``) — the plain-torch apply
    (``ops/torch_ops.py``) on whatever plan the config requests;
  * :class:`HybSpmv` (``hyb``) — the same apply on one whole-matrix window
    without reordering (the plain HYB ablation);
  * :class:`EhybSpmv` (``ehyb``) — the flagship: it pins the layout the TPU
    flagship pins for its Pallas kernels, takes its decisions (the relaxed
    layout only where a streamed body schedules; the TPU branch of the
    apply, ``ops/stream_plan.py``) and runs the SELL body through a
    hand-written CUDA kernel: K1 (``ops/ehyb_stream.py``), or the x-window
    cache (``ops/ehyb_wincache.py``) where the TPU streams x from HBM; the
    DIA part through the DIA kernel (``ops/dia.py``).  It pins that layout
    on every device, so the CPU runs the same artifact through the kernels'
    plain versions.  Its delegation gate hands gather-wall matrices to the
    routed engine (``models/routed.py``) or, with a heavy row-degree tail,
    to the degree-split hybrid (``models/hybrid.py``), as the JAX flagship
    does; below 65,536 rows it decides by a measured A/B on the card.

All three take the precision mode (``dword_values``, ``ops/dword.py``):
the JAX package's host side in f64, with no layout pinned, and the body and
DIA kernels in f64.

The layout switches use the TPU's per-vreg cycle constants, kept here so that
both packages land on the same ``EhybMatrix``; re-deriving them for the H100
is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from ..config import LANES, WINDOW_ALIGN, cdiv, round_up
from ..core.coo import MatrixCOO
from ..core.convert import coo_to_ehyb
from ..core.ehyb import EhybMatrix
from ..core.planner import Plan, make_plan
from ..core.reorder import Reordering, identity_reordering, two_level_reorder
from ..ops import stream_plan
from ..ops.dword import dword_config, make_dword_apply
from ..ops.ehyb_stream import make_stream_apply
from ..ops.stream_plan import SUBTILES, TILE_STEPS
from ..ops.torch_ops import EhybApply
from ..partition import partition_rows
from ..utils.log import get_logger
from ..utils.timing import phase_roofline
from .base import SpmvModel

log = get_logger(__name__)


class _DelegateToRouted(Exception):
    """Control-flow carrier: the gate decided for another engine;
    ``EhybSpmv.setup`` catches it and returns ``model``."""

    def __init__(self, model):
        super().__init__("gather-wall delegation")
        self.model = model


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
    takes_dword = True

    def _rx_supported(self, e_rx: EhybMatrix) -> bool:
        """Whether this model can run the relaxed layout (the plain model
        always can; the flagship overrides)."""
        return True

    def _post_order_hook(self, m: MatrixCOO) -> None:
        """Called once the reordering is decided, before any conversion
        (the flagship's routed-delegation gate)."""

    def _pre_order_hook(self, m: MatrixCOO) -> None:
        """Called before the artifact load and the ordering chain (the
        flagship's cached-verdict delegation)."""

    def _make_module(self):
        return EhybApply(self.dev)

    def setup(self, m: MatrixCOO) -> "EhybPlainSpmv":
        if self.config.dword_values:
            # the precision mode plans in f64, as the JAX package does
            self.config = dword_config(self.config)
        cfg = self.config
        self.m = m
        dim = m.dimension
        #: Host preprocessing wall-times per phase.
        self.setup_seconds = {}
        _t0 = time.perf_counter()

        self.plan: Plan = make_plan(dim, cfg)
        # cache key = the config AS GIVEN (the layout switches below are
        # deterministic for (matrix, config))
        cfg_key = cfg
        #: The artifact's cache path without its suffix, beside which K1's
        #: plan is cached (None: no cache).
        self.plan_cache = None
        # a cached gather-wall verdict fires before the EHYB artifact load
        # and the ordering chain, both of which it would throw away
        self._pre_order_hook(m)
        if cfg.artifact_cache:
            from ..core.cache import cache_paths, load_artifacts

            self.plan_cache = cache_paths(m, cfg, cfg.cache_dir)[0][
                :-len(".ehyb.npz")]

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
        if cfg.dword_values:
            self.module = make_dword_apply(self.ehyb, self.dev,
                                           self.plan_cache)
            self.setup_seconds["k1_plan"] = self.module.plan_seconds
        else:
            self.module = self._make_module()

    # x/y move through the reordered space (vectorReorder / vectorRecover,
    # solver_test.c:376,383) — outside the timed region, like the reference.
    def prepare_x(self, x: np.ndarray):
        xr = self.reordering.vector_reorder(np.asarray(x))
        return super().prepare_x(self.ehyb.pad_x(xr.astype(self.config.dtype)))

    def recover_y(self, y) -> np.ndarray:
        y_np = y.detach().cpu().numpy().astype(np.float64)[: self.m.n_rows]
        return self.reordering.vector_recover(y_np)

    def roofline_phases(self) -> dict:
        """(flops, device-memory bytes) per iteration of each phase: the
        artifact's streams, x once and y once.  Where the body runs through
        a plan the card reads the plan's compact cells, not the padded body
        it dropped at upload: the window cache's ``layout_bytes`` (cells
        and staged rows) or K1's ``stream_bytes`` (cells, pieces and
        tables) stand in for the body's cells.  K1's plan holds the ER and
        long-row entries too, so where it runs they are counted once, in
        the body's phase, and have no phase of their own."""
        cfg = self.config
        phases = phase_roofline(
            self.ehyb.stats, dim=self.m.dimension,
            value_bytes=np.dtype(cfg.dtype).itemsize,
            ell_index_bytes=np.dtype(cfg.index_dtype).itemsize)
        module = getattr(self, "module", None)
        wincache = getattr(module, "wincache", None)
        cells = getattr(module, "cells", None)
        if wincache is not None:
            phases["body"] = (phases["body"][0],
                              wincache.stats["layout_bytes"])
        elif cells is not None:
            flops = phases["body"][0]
            if cells.stats.get("folded"):
                flops += phases.pop("er")[0] + phases.pop("long")[0]
            phases["body"] = (flops, cells.stats["stream_bytes"])
        return phases


class HybSpmv(EhybPlainSpmv):
    """Plain HYB ablation: no windows (one window over the whole matrix),
    no reordering, the plain-torch apply.  The reference's CACHE=off
    (``spmv.h:10``); port of ``ehyb_spmv_gpu_tpu/models/ehyb.py:856-872``."""

    name = "hyb"

    def setup(self, m: MatrixCOO) -> "HybSpmv":
        self.config = dataclasses.replace(
            self.config,
            window_rows=round_up(m.dimension, 1024),
            min_parts=1,
            features=dataclasses.replace(self.config.features,
                                         reorder=False, cache=False),
        )
        return super().setup(m)


class EhybSpmv(EhybPlainSpmv):
    """Flagship: EHYB with the hand-written body and DIA kernels.

    Pins the layout of the TPU flagship's Pallas mode (1024-row windows, a
    multi-window SELL packing, int16 columns, sliding windows, slice widths
    in multiples of ``SUBTILES * TILE_STEPS``), runs the same layout
    switches, and applies through :func:`~..ops.ehyb_stream.make_stream_apply`.
    In the precision mode it pins nothing (the JAX flagship runs no Pallas
    kernel there) and applies through :func:`~..ops.dword.make_dword_apply`.
    """

    name = "ehyb"

    #: Post-reorder (slice, window) group fill below which the TPU flagship
    #: hands the matrix to the routed engine.
    _ROUTED_FILL_GATE = 6.0
    #: Below this dimension the gate decides by a measured A/B on the card
    #: (:meth:`_maybe_delegate_small`) instead of the fill signal.
    _SMALL_GATE_DIM = 1 << 16
    #: Estimated body cost (the ordering cost model, ``core/ordering.py``,
    #: with the TPU's cycle constants) over the perfect-fill floor above
    #: which a small matrix counts as scattered and the A/B runs; the JAX
    #: gate's constant.
    _SMALL_EST_K = 3.0
    #: The small gate's record where it ran: its estimate and floor, and
    #: after an A/B the candidate's kind and both GFLOP/s.  An engine the
    #: gate returns carries it too.
    small_gate: Optional[dict] = None

    def _rx_supported(self, e_rx: EhybMatrix) -> bool:
        """The relaxed layout runs only on a streamed body, as in the JAX
        flagship: not with ``EHYB_STREAM_BODY=0``, and past
        ``X_RESIDENT_BYTES`` only where the window-cache plan schedules."""
        if not stream_plan.stream_body_enabled():
            return False
        return stream_plan.stream_body_fits(
            e_rx, np.dtype(self.config.dtype).itemsize)

    def _make_module(self):
        module = make_stream_apply(self.ehyb, self.dev,
                                   kahan=self.config.compensated_sum,
                                   value_bytes=np.dtype(
                                       self.config.dtype).itemsize,
                                   cache=self.plan_cache)
        # the body plan's build, a part of the upload phase
        if module.wincache is not None:
            self.setup_seconds["wincache_plan"] = module.plan_seconds
        elif module.cells is not None:
            self.setup_seconds["k1_plan"] = module.plan_seconds
        return module

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
        routed = self._maybe_delegate_routed(m)
        if routed is not None:
            raise _DelegateToRouted(routed)

    def _pre_order_hook(self, m: MatrixCOO) -> None:
        """Cached-verdict fast path before the ordering chain: a matrix the
        gate already judged gather-wall delegates at once instead of paying
        the partition + RCM ordering the routed engine never uses."""
        if not self._gate_preconditions(m):
            return
        verdict = self._load_gate_decision(m)
        if verdict not in ("routed", "split"):
            return
        log.info("cached gate verdict: %s — delegating without paying the "
                 "ordering chain", verdict)
        from .hybrid import DegreeSplitSpmv
        from .routed import RoutedSpmv

        engine = DegreeSplitSpmv if verdict == "split" else RoutedSpmv
        try:
            model = engine(self.config, device=self.device).setup(m)
        except ValueError as exc:
            # the gate contract: keep the EHYB body when routed cannot run,
            # never crash setup (a stale marker must not wedge warm runs)
            log.warning("cached %s verdict but the build failed (%s); "
                        "keeping the EHYB body", verdict, exc)
            self._save_gate_decision(m, False)
            return
        raise _DelegateToRouted(model)

    def _gate_decision_path(self, m: MatrixCOO) -> Optional[str]:
        if not self.config.artifact_cache:
            return None
        from ..core.cache import DEFAULT_CACHE_DIR, matrix_fingerprint

        d = self.config.cache_dir or DEFAULT_CACHE_DIR
        sp = os.environ.get("EHYB_ROUTE_SPILL_MAX", "0.10")
        return os.path.join(
            d, f"{matrix_fingerprint(m)}"
               f"-gate{self._ROUTED_FILL_GATE:g}v3-sp{sp}.json")

    def _load_gate_decision(self, m: MatrixCOO):
        """Cached gate verdict: "routed" / "split" = delegate to that
        engine, False = keep the EHYB body, None = not decided yet (or
        caching disabled)."""
        path = self._gate_decision_path(m)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)["delegate"]
        except (OSError, ValueError, KeyError, TypeError):
            return None  # unreadable marker: decide again

    def _save_gate_decision(self, m: MatrixCOO, delegate) -> None:
        path = self._gate_decision_path(m)
        if path is None:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"delegate": delegate}, f)
        os.replace(tmp, path)  # atomic against concurrent runs

    def _maybe_delegate_routed(self, m: MatrixCOO):
        """Return the routed or degree-split model when the post-reorder
        structure shows the gather-wall regime, else None (keep the EHYB
        body).  Runs right after the ordering is decided and before any
        conversion (a scrambled stencil recovers under RCM and must not
        delegate; a random matrix must not pay a conversion it never uses).

        The flagship always pins ``sell_mw``/``sell_rx``, so its ordering is
        ``pick_ordering``'s, which already considered RCM: the JAX gate's
        re-sample under RCM for the partition-ordered XLA path is never
        reached here and is not ported.
        """
        if not self._gate_preconditions(m):
            return None
        if m.dimension < self._SMALL_GATE_DIM:
            return self._maybe_delegate_small(m)
        # mean fill of sampled post-reorder (128-row slice, 1024-col window)
        # groups — what a window-gather sub-tile can hope to serve; whole
        # slices are sampled (every 97th, all of its entries)
        o2n = self.reordering.old_to_new
        r_new = o2n[m.row.astype(np.int64)]
        pick = (r_new // LANES) % 97 == 0
        r_s = r_new[pick]
        c_s = o2n[m.col[pick].astype(np.int64)]
        gkey = (r_s // LANES) * (m.dimension // 1024 + 1) + c_s // 1024
        fill = r_s.shape[0] / max(np.unique(gkey).shape[0], 1)
        if fill > self._ROUTED_FILL_GATE:
            # the sample saw a bandwidth-recovered ordering: final, cached
            self._save_gate_decision(m, False)
            return None
        if self._load_gate_decision(m) is False:
            return None  # cached keep-body verdict (e.g. the spill veto)
        from ..core.route import _choose_params
        from .hybrid import DegreeSplitSpmv, MIN_DENSE_FRAC, degree_split_stats
        from .routed import RoutedSpmv

        try:
            # block-width feasibility: column-block mode lifts the dim cap,
            # so only the per-row density can disqualify the router
            _choose_params(m.dimension, min(m.dimension, 1 << 20),
                           m.nnz // max(cdiv(m.dimension, 1 << 20), 1),
                           None, None)
            # heavy tail → degree-split hybrid: dense rows pack the EHYB
            # body at pooled-slice fill, the bounded-degree rest routes
            _, dense_frac = degree_split_stats(m)
            if dense_frac >= MIN_DENSE_FRAC:
                log.info("gather-wall with a heavy tail (fill %.1f, %.0f%% "
                         "of nnz in dense rows): degree-split hybrid",
                         fill, 100 * dense_frac)
                model = DegreeSplitSpmv(self.config,
                                        device=self.device).setup(m)
                self._save_gate_decision(m, "split")
                return model
            log.info("gather-wall structure (post-reorder (slice,window) "
                     "group fill %.1f): delegating to the routed engine",
                     fill)
            routed = RoutedSpmv(self.config, device=self.device).setup(m)
            # schedule-quality veto: spilled entries ride the torch gather
            # tail the routed engine exists to avoid
            nnz_spill = sum(b.stats.get("nnz_spill", 0)
                            for b in routed.blocks)
            spill_max = float(os.environ.get("EHYB_ROUTE_SPILL_MAX", "0.10"))
            if nnz_spill > spill_max * max(m.nnz, 1):
                log.info("routed schedule spills %.1f%% of nnz (> %.0f%% "
                         "veto) — keeping the EHYB body",
                         100 * nnz_spill / m.nnz, 100 * spill_max)
                self._save_gate_decision(m, False)
                return None
            # saved only once the build succeeded
            self._save_gate_decision(m, "routed")
            return routed
        except ValueError as exc:            # too dense for the router
            log.info("gather-wall structure (group fill %.1f) but routed "
                     "infeasible (%s); keeping the EHYB body", fill, exc)
            self._save_gate_decision(m, False)
            return None

    def _can_measure(self) -> bool:
        """Whether the small gate may run its A/B: a hardware measurement,
        so only on a card (the JAX gate runs it only in Pallas mode
        ``"1"``).  Tests patch it on the instance."""
        return self.device.type == "cuda"

    def _small_gate_cost(self, m: MatrixCOO):
        """(est, floor): the ordering cost model's estimate of the body
        under the decided ordering, and the perfect-fill floor of the same
        entries, in the TPU's cycle units (the JAX gate's formula)."""
        from ..core.ordering import (_CYC_DIA_VREG, _CYC_SELL_VREG,
                                     estimate_cost, estimate_mw_steps)

        cfg = self.config
        o2n = self.reordering.old_to_new
        r_new = o2n[m.row.astype(np.int64)]
        c_new = o2n[m.col.astype(np.int64)]
        if cfg.features.dia:
            return (estimate_cost(r_new, c_new, m.dimension, cfg),
                    m.nnz / 1024.0 * _CYC_DIA_VREG)
        est = (estimate_mw_steps(r_new, c_new, m.dimension, cfg.slice_rows,
                                 cfg.min_window_group_nnz,
                                 sliding=bool(cfg.sliding_windows))
               / 8.0 * _CYC_SELL_VREG)
        return est, m.nnz / 1024.0 * _CYC_SELL_VREG

    def _measured_gflops(self, model, m: MatrixCOO) -> float:
        """GFLOP/s of ``model``'s chained loop (``iterate``, CUDA-graph
        replays once its graphs are captured by a first call), timed with
        CUDA events: 512 iterations, four times as many until a run takes
        at least 50 ms, as the JAX gate escalates."""
        from ..core.coo import deterministic_x
        from ..utils.timing import timed_seconds

        x_dev = model.prepare_x(deterministic_x(m.dimension))
        model.iterate(x_dev, 1)
        it = 512
        while True:
            sec = timed_seconds(lambda: model.iterate(x_dev, it),
                                model.device)
            if sec >= 0.05 or it >= (1 << 16):
                return 2.0 * m.nnz * it / max(sec, 1e-12) / 1e9
            it *= 4

    def _maybe_delegate_small(self, m: MatrixCOO):
        """The gate below ``_SMALL_GATE_DIM`` rows: a measured A/B in place
        of the fill signal (port of the JAX ``_maybe_delegate_small``).

        x is small enough there to stay in cache for every engine, so the
        group fill says little; the ordering cost model's estimate against
        the perfect-fill floor tells structured matrices (kept at once)
        from scattered ones, which build the candidate (the degree-split
        hybrid with a heavy tail, else the routed engine) and a body and
        time both.  The candidate is taken only when it is more than 5%
        faster; the verdict is cached by matrix fingerprint.  The estimate,
        and the A/B's numbers where it ran, are kept in ``small_gate``.
        """
        cfg = self.config
        if self._load_gate_decision(m) is not None:
            # "routed"/"split" delegated in _pre_order_hook; False = a body
            # win (or a veto): keep the body without measuring again
            return None
        est, floor = self._small_gate_cost(m)
        self.small_gate = {"est": est, "floor": floor}
        if est <= self._SMALL_EST_K * floor:
            return None  # structured: the body is the engine
        if not self._can_measure():
            return None
        # the A/B pays two builds and two short runs inside setup: past the
        # budget (an estimate of ~4 us of host packing an entry) the body
        # stays, and the verdict is cached so the estimate is paid once
        budget_s = float(os.environ.get("EHYB_SMALL_GATE_BUDGET", "60"))
        est_build_s = 2 * m.nnz * 4e-6 + 2.0
        if est_build_s > budget_s:
            log.info("small gate: estimated A/B cost %.1f s exceeds budget "
                     "%.0f s (EHYB_SMALL_GATE_BUDGET); keeping the body",
                     est_build_s, budget_s)
            self._save_gate_decision(m, False)
            return None
        t_gate = time.perf_counter()
        from ..core.route import _choose_params
        from .hybrid import DegreeSplitSpmv, MIN_DENSE_FRAC, degree_split_stats
        from .routed import RoutedSpmv

        try:
            _choose_params(m.dimension, min(m.dimension, 1 << 20),
                           m.nnz // max(cdiv(m.dimension, 1 << 20), 1),
                           None, None)
            _, dense_frac = degree_split_stats(m)
            if dense_frac >= MIN_DENSE_FRAC:
                cand = DegreeSplitSpmv(cfg, device=self.device).setup(m)
                kind = "split"
            else:
                cand = RoutedSpmv(cfg, device=self.device).setup(m)
                kind = "routed"
                nnz_spill = sum(b.stats.get("nnz_spill", 0)
                                for b in cand.blocks)
                spill_max = float(
                    os.environ.get("EHYB_ROUTE_SPILL_MAX", "0.10"))
                if nnz_spill > spill_max * max(m.nnz, 1):
                    self._save_gate_decision(m, False)
                    return None
        except ValueError as exc:
            log.info("small gate: candidate infeasible (%s); body", exc)
            self._save_gate_decision(m, False)
            return None
        body = EhybSpmv(dataclasses.replace(cfg, routed_delegate="never"),
                        device=self.device).setup(m)
        g_cand = self._measured_gflops(cand, m)
        g_body = self._measured_gflops(body, m)
        gate_s = time.perf_counter() - t_gate
        self.setup_seconds["small_gate"] = gate_s
        self.small_gate.update(kind=kind, candidate_gflops=g_cand,
                               body_gflops=g_body)
        log.info("small-gate A/B (est %.1fx floor, %.1f s): %s %.2f vs body "
                 "%.2f GFLOP/s", est / floor, gate_s, kind, g_cand, g_body)
        # 5% hysteresis: a tie keeps the body (the simpler engine, and the
        # one every mode takes)
        if g_cand > 1.05 * g_body:
            self._save_gate_decision(m, kind)
            return cand
        self._save_gate_decision(m, False)
        return body  # already built: reuse it

    def setup(self, m: MatrixCOO) -> "EhybSpmv":
        if self.config.dword_values:
            # the precision mode pins no layout, as the JAX flagship runs
            # no Pallas kernel in it: the plain model's artifact, applied
            # through the f64 kernels
            return super().setup(m)
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
            # CUDA kernels take 128-aligned windows at any x size)
            x_bytes = (round_up(m.dimension, LANES) + WINDOW_ALIGN) \
                * np.dtype(cfg.dtype).itemsize
            est_sub_bytes = 4 * int(1.5 * m.nnz / (LANES * 8))
            sliding = (x_bytes <= stream_plan.X_RESIDENT_BYTES
                       or est_sub_bytes <= 800 * 1024)
        self.config = dataclasses.replace(
            cfg, window_rows=WINDOW_ALIGN, body_layout=layout,
            width_align=SUBTILES * TILE_STEPS, index_dtype=idx_dtype,
            sliding_windows=sliding, features=feats)
        t0 = time.perf_counter()
        try:
            return super().setup(m)
        except _DelegateToRouted as d:
            # the delegated engine's setup also counts the ordering the gate
            # paid for before it decided, and carries the small gate's
            # numbers where it ran
            d.model.setup_seconds = {**self.setup_seconds,
                                     **d.model.setup_seconds,
                                     "total": time.perf_counter() - t0}
            if self.small_gate is not None:
                d.model.small_gate = self.small_gate
            return d.model
