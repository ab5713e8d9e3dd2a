"""Row-sharded EHYB SpMV over ``torch.distributed``: one process per rank.

Port counterpart of ``ehyb_spmv_gpu_tpu/parallel/spmv.py``.  The JAX module
runs one SPMD program over a device mesh; here every rank is a process of
its own, holds its own shard on its own device and talks to the others
through a process group:

  * rows (in the reordered space) are cut into equal ``R``-row spans, one a
    rank, partition-aligned because the reorderer already grouped
    tightly-coupled rows contiguously;
  * the SELL **body** reads x rows of the rank's ``x_ext = [left halo W |
    local R | right halo W]``: the halos come from the ring neighbours
    (the JAX path's ``ppermute``), and the body runs K1
    (``csrc/ehyb_stream.cu``) twice over one plan of the shard
    (``parallel/shard_cells.py``), first over the row blocks that read only
    local rows (while the halos are in flight), then over the rest;
  * the **ER tail + long rows** read columns anywhere, served by one
    compressed ``all_to_all`` of per-(owner, requester) request lists
    computed at conversion time, received after ``x_ext`` in one buffer
    (``parallel/comm.py``);
  * the **DIA** part reads ``x_ext`` with base W through the torch op
    (``ops/torch_ops.py::ehyb_dia``), as the JAX path runs it in XLA.

The host half (:func:`build_sharded` and the layout decisions of
:func:`plan_sharded`) is a copy of the JAX package's, so both packages cut
the same shards byte for byte; the TPU's stream maps (its interior/boundary
tile groups for Pallas) are left out, since the port splits K1's own plan
instead.  Every rank may convert the whole matrix itself, or a launcher
converts once and hands each rank the result (:class:`ShardedSetup`).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import EhybConfig, LANES, WINDOW_ALIGN, cdiv, round_up
from ..core.convert import convert_core
from ..core.coo import MatrixCOO
from ..core.ehyb import EhybMatrix
from ..core.planner import Plan, make_plan
from ..core.reorder import Reordering, identity_reordering, two_level_reorder
from ..models.base import SpmvModel
from ..models.ehyb import (_CYC_MW_VREG, _CYC_RX4_VREG, _CYC_RX_VREG,
                           _QUAD_WASTE_GATE, _RELAX_WASTE_GATE)
from ..ops.ehyb_stream import stream_body
from ..ops.torch_ops import combine_ehyb, ehyb_dia, ehyb_er, ehyb_long
from ..partition import partition_rows
from ..utils.log import get_logger
from ..utils.timing import phase_roofline
from .comm import (ShardExchange, all_gather_rows, group_rank_world,
                   rank_device)
from .shard_cells import ShardCellsDevice, build_shard_cells

log = get_logger(__name__)


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``a`` to length n with ``fill``."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


@dataclasses.dataclass
class ShardedEhyb:
    """Stacked per-shard EHYB arrays (leading axis = shard)."""

    dim: int            # true rows
    rows_per_dev: int   # R (multiple of LANES)
    window_rows: int    # W <= R
    n_dev: int

    ell_col: np.ndarray          # (D, steps, C)
    ell_val: np.ndarray
    slice_offset: np.ndarray     # (D, R/C + 1)
    slice_win_start: np.ndarray  # (D, R/C)  — offsets into the EXTENDED x
    step_win: np.ndarray         # (D, steps) — per-step window starts (ext x)
    step_win_b: np.ndarray       # (D, steps) — rx second windows (or 0s)
    er_col: np.ndarray           # (D, er_steps, C) — into [x_ext | recv]
    er_val: np.ndarray
    er_slice_offset: np.ndarray  # (D, n_er_slices + 1)
    er_rows: np.ndarray          # (D, n_er_slices*C) — LOCAL rows, dump = R
    long_col: np.ndarray         # (D, L) — into [x_ext | recv]
    long_val: np.ndarray
    long_seg: np.ndarray         # (D, L)
    long_rows: np.ndarray        # (D, n_long) — LOCAL rows, dump = R

    #: Union of all shards' diagonal offsets; a shard missing an offset
    #: carries an all-zero dia_val row.
    dia_offsets: tuple = ()
    dia_val: np.ndarray = None   # (D, K_union, R)

    #: (D, D, S) int32 — send_idx[o, d] = LOCAL x indices owner o sends to
    #: requester d (padded with 0; padding values are ignored by the
    #: remapped ER/long columns).  S = max request size over all (d, o)
    #: pairs; S == 0 means every ER/long column is within the ±W halo and
    #: no exchange is needed.
    send_idx: np.ndarray = None
    exchange_slots: int = 0      # S

    #: (D, steps) third and fourth window starts of the quad layout (empty
    #: (D, 0) otherwise).  The JAX package keeps them only inside its
    #: stream maps; the port's body plan decodes them.
    step_win_c: np.ndarray = None
    step_win_d: np.ndarray = None

    stats: dict = dataclasses.field(default_factory=dict)


def _refine_within_shards(m: MatrixCOO, reordering: Reordering, R: int,
                          n_dev: int, config: EhybConfig) -> Reordering:
    """Compose a per-shard-local RCM on top of the global partition reorder
    when it reduces the estimated body steps.

    Shard membership (and therefore the cut / exchange plan) is unchanged —
    rows permute within their own ``R``-row span only.  Kept only where the
    sampled step estimate improves by >20%% (banded structure hiding under
    the scramble); identity otherwise (e.g. DIA-dominated FEM shards, where
    RCM would perturb the diagonal structure for nothing).
    """
    from ..core.ordering import estimate_mw_steps, rcm_order

    dim = m.dimension
    new_to_old = reordering.new_to_old
    old_to_new = reordering.old_to_new
    row1 = old_to_new[m.row]
    col1 = old_to_new[m.col]
    local_perm = np.arange(dim, dtype=np.int64)  # final-new → current-new
    changed = False
    _SAMPLE = 5_000_000
    for d in range(n_dev):
        b0, b1 = d * R, min((d + 1) * R, dim)
        if b1 <= b0:
            break
        sel = (row1 >= b0) & (row1 < b1) & (col1 >= b0) & (col1 < b1)
        if not sel.any():
            continue
        r_l = row1[sel] - b0
        c_l = col1[sel] - b0
        n_l = b1 - b0
        if r_l.size > _SAMPLE:
            # pre-gate on a sample: skip the (expensive) local RCM when the
            # partition ordering is already tight
            rng = np.random.default_rng(d)
            pick = rng.random(r_l.size) < _SAMPLE / r_l.size
            est_s = estimate_mw_steps(r_l[pick], c_l[pick],
                                      n_l, config.slice_rows,
                                      max(1, config.min_window_group_nnz))
            ideal_s = max(1, int(pick.sum()) // config.slice_rows)
            if est_s < 3 * ideal_s:
                continue  # padding already low; RCM can't win 20%
        est_id = estimate_mw_steps(r_l, c_l, n_l, config.slice_rows,
                                   config.min_window_group_nnz)
        sub = MatrixCOO(n_l, n_l, r_l, c_l, np.ones(r_l.shape[0]))
        order = rcm_order(sub)                    # local new → local current
        inv = np.empty(n_l, dtype=np.int64)
        inv[order] = np.arange(n_l, dtype=np.int64)
        est_rcm = estimate_mw_steps(inv[r_l], inv[c_l], n_l,
                                    config.slice_rows,
                                    config.min_window_group_nnz)
        if est_rcm < 0.8 * est_id:
            local_perm[b0:b1] = b0 + order
            changed = True
            log.info("shard %d: local RCM cuts estimated steps %d → %d",
                     d, est_id, est_rcm)
    if not changed:
        return reordering
    final_new_to_old = new_to_old[local_perm]
    final_old_to_new = np.empty(dim, dtype=np.int64)
    final_old_to_new[final_new_to_old] = np.arange(dim, dtype=np.int64)
    # partition sub-boundaries inside a shard are meaningless after a local
    # re-sort; keep a uniform 1024-row grid
    bounds = np.arange(0, dim + 1024, 1024, dtype=np.int64)
    bounds = np.unique(np.minimum(bounds, dim))
    return Reordering(new_to_old=final_new_to_old,
                      old_to_new=final_old_to_new, boundaries=bounds)


def build_sharded(m_r: MatrixCOO, reordering: Reordering, window_rows: int,
                  n_dev: int, config: EhybConfig) -> ShardedEhyb:
    """Slice the reordered matrix into D row spans and convert each span with
    shard-local row/window coordinates; pad + stack to uniform shapes."""
    dim = m_r.dimension
    R = round_up(cdiv(dim, n_dev), LANES)
    W = min(window_rows, R)  # halo is one neighbor deep: window ≤ shard span

    # Hub-row splitting is a single-device mechanism: the shard apply
    # carries no fold-back maps and truncates y to R rows.  Disable per
    # shard.
    if config.row_split_threshold:
        log.info("sharded path: hub-row splitting disabled per shard")
        config = dataclasses.replace(config, row_split_threshold=0)

    shards = []
    for d in range(n_dev):
        b0, b1 = d * R, min((d + 1) * R, dim)
        sel = (m_r.row >= b0) & (m_r.row < b1)
        row_l = m_r.row[sel] - b0
        col_l = m_r.col[sel] - b0  # off-shard cols go negative / beyond R
        val_l = m_r.val[sel]

        # Local partition boundaries: global boundaries restricted to this
        # span, in local coords; the boundary just below b0 is kept (negative)
        # so rows of a straddling partition keep their true window start —
        # clamped to -W so every window fits inside the ±W halo.
        gb = reordering.boundaries.astype(np.int64)
        below = gb[gb <= b0]
        first = max(below.max() - b0, -W) if below.size else 0
        inside = gb[(gb > b0) & (gb < b1)] - b0
        bounds_l = np.concatenate([[first], inside, [R]])

        # DIA offsets are bounded to ±W, and multi-window body columns to the
        # [-W, R+W) halo span, so every x access stays inside the
        # [halo_W | local_R | halo_W] extended vector (x_base = W); columns
        # further off-shard go to the exchanged ER tail.
        e = convert_core(row_l, col_l, val_l, dim=R, boundaries=bounds_l,
                         window_rows=W, n_parts=len(bounds_l) - 1,
                         config=config, dia_off_range=(-W, W),
                         body_col_range=(-W, R + W))
        # Window starts into the extended x [halo_W | local_R | halo_W].
        e.slice_win_start = (e.slice_win_start.astype(np.int64)
                             + W).astype(np.int32)
        e.step_win = (e.step_win.astype(np.int64) + W).astype(np.int32)
        if e.step_win_b.size:
            e.step_win_b = (e.step_win_b.astype(np.int64)
                            + W).astype(np.int32)
        if e.step_win_c.size:  # quad windows shift with the ext x too
            e.step_win_c = (e.step_win_c.astype(np.int64)
                            + W).astype(np.int32)
            e.step_win_d = (e.step_win_d.astype(np.int64)
                            + W).astype(np.int32)
        # ER/long columns back to global coordinates (padding cells have
        # val == 0, so the shifted padding gather is harmless).
        e.er_col = (e.er_col.astype(np.int64) + b0).astype(np.int32)
        e.long_col = (e.long_col.astype(np.int64) + b0).astype(np.int32)
        shards.append(e)

    # ---- compressed exchange plan: per-(requester, owner) request lists
    # whose size is the actual cut ----
    XLEN = R + 2 * W
    needs = []
    for d, s in enumerate(shards):
        b0 = d * R
        cols = []
        if s.er_col.size:
            cols.append(s.er_col[np.asarray(s.er_val) != 0].astype(np.int64))
        if s.long_col.size:
            cols.append(s.long_col[np.asarray(s.long_val) != 0]
                        .astype(np.int64))
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        off = cols[(cols < b0 - W) | (cols >= b0 + R + W)]
        needs.append(np.unique(off))
    # owner-major plan build, linear in the total requests; ``needs[d]`` is
    # sorted, so each owner's run is contiguous within it
    all_d = np.concatenate([np.full(n.size, d, dtype=np.int64)
                            for d, n in enumerate(needs)]) \
        if n_dev else np.zeros(0, np.int64)
    all_col = np.concatenate(needs) if needs else np.zeros(0, np.int64)
    all_owner = all_col // R
    req_sizes = np.bincount(all_d * n_dev + all_owner,
                            minlength=n_dev * n_dev) \
        .reshape(n_dev, n_dev).astype(np.int64)
    S = int(req_sizes.max(initial=0))
    send_idx = np.zeros((n_dev, n_dev, max(S, 1)), dtype=np.int32)
    if all_col.size:
        key = all_d * n_dev + all_owner
        run_first = np.empty(key.size, dtype=bool)
        run_first[0] = True
        np.not_equal(key[1:], key[:-1], out=run_first[1:])
        starts = np.flatnonzero(run_first)
        rank = np.arange(key.size, dtype=np.int64) \
            - np.repeat(starts, np.diff(np.append(starts, key.size)))
        send_idx.reshape(-1)[
            (all_owner * n_dev + all_d) * max(S, 1) + rank] = \
            (all_col - all_owner * R).astype(np.int32)
    # owner-run starts within each shard's sorted needs (for remapping)
    owner_starts = [np.searchsorted(needs[d], np.arange(n_dev + 1) * R)
                    for d in range(n_dev)]

    def remap_cols(col_arr: np.ndarray, d: int) -> np.ndarray:
        """Global columns → indices into [x_ext (R+2W) | recv (D*S)]."""
        b0 = d * R
        c = col_arr.astype(np.int64)
        out = c - b0 + W
        off_m = (c < b0 - W) | (c >= b0 + R + W)
        if off_m.any():
            co = c[off_m]
            o = co // R
            pos = np.searchsorted(needs[d], co) - owner_starts[d][o]
            out[off_m] = XLEN + o * S + pos
        return out.astype(np.int32)

    for d, s in enumerate(shards):
        s.er_col = remap_cols(s.er_col, d)
        s.long_col = remap_cols(s.long_col, d)

    # ---- pad to common shapes + stack ----
    steps = max(max(s.ell_col.shape[0] for s in shards), 1)
    er_steps = max(max(s.er_col.shape[0] for s in shards), 1)
    n_er_slices = max(max(s.n_er_slices for s in shards), 1)
    n_long = max(max(s.n_long for s in shards), 1)
    n_long_entries = max(max(s.long_col.shape[0] for s in shards), 1)

    def stack(field_fn):
        return np.stack([field_fn(s) for s in shards], axis=0)

    # Union of DIA offsets across shards → one offset list for every shard.
    union = sorted({int(d) for s in shards for d in s.dia_offsets})
    K = len(union)
    rank = {d: k for k, d in enumerate(union)}
    dia_val = np.zeros((n_dev, max(K, 0), R),
                       dtype=shards[0].dia_val.dtype if shards else np.float32)
    for i, s in enumerate(shards):
        for k, d in enumerate(s.dia_offsets):
            dia_val[i, rank[int(d)], : s.dia_val.shape[1]] = s.dia_val[k]

    def pad_offsets(off: np.ndarray, n_slices_target: int, total: int):
        off = off.astype(np.int32)
        out = _pad_rows(off, n_slices_target + 1, fill=off[-1])
        out[-1] = total  # extend the final slice over the padded steps
        return out

    quad = any(s.step_win_c.size for s in shards)

    def quad_wins(field: str):
        if not quad:
            return np.zeros((n_dev, 0), dtype=np.int32)
        return stack(lambda s: _pad_rows(
            getattr(s, field) if getattr(s, field).size else
            np.zeros_like(s.step_win), steps, fill=0))

    sh = ShardedEhyb(
        dim=dim, rows_per_dev=R, window_rows=W, n_dev=n_dev,
        ell_col=stack(lambda s: _pad_rows(s.ell_col, steps)),
        ell_val=stack(lambda s: _pad_rows(s.ell_val, steps)),
        slice_offset=stack(lambda s: pad_offsets(s.slice_offset,
                                                 s.n_slices, steps)),
        slice_win_start=stack(lambda s: s.slice_win_start),
        step_win=stack(lambda s: _pad_rows(s.step_win, steps, fill=0)),
        step_win_b=stack(lambda s: _pad_rows(
            s.step_win_b if s.step_win_b.size else
            np.zeros_like(s.step_win), steps, fill=0)),
        er_col=stack(lambda s: _pad_rows(s.er_col, er_steps, fill=W)),
        er_val=stack(lambda s: _pad_rows(s.er_val, er_steps)),
        er_slice_offset=stack(lambda s: pad_offsets(s.er_slice_offset,
                                                    n_er_slices, er_steps)),
        er_rows=stack(lambda s: _pad_rows(
            s.er_rows, n_er_slices * config.er_slice_rows, fill=R)),
        long_col=stack(lambda s: _pad_rows(s.long_col, n_long_entries,
                                           fill=W)),
        long_val=stack(lambda s: _pad_rows(s.long_val, n_long_entries)),
        long_seg=stack(lambda s: _pad_rows(s.long_seg, n_long_entries,
                                           fill=n_long - 1)),
        long_rows=stack(lambda s: _pad_rows(s.long_rows, n_long, fill=R)),
        dia_offsets=tuple(union), dia_val=dia_val,
        send_idx=send_idx, exchange_slots=S,
        step_win_c=quad_wins("step_win_c"),
        step_win_d=quad_wins("step_win_d"),
        stats={"per_dev": [s.stats for s in shards], "R": R, "W": W,
               "exchange_slots": S, "req_sizes": req_sizes.tolist(),
               "layout": config.body_layout},
    )
    return sh


def shard_matrix(sh: ShardedEhyb, d: int) -> EhybMatrix:
    """Shard ``d`` of ``sh`` as an :class:`EhybMatrix` of R rows whose
    windows, ER and long columns index its ``[x_ext | recv]`` vector."""
    rx = sh.stats.get("layout") == "sell_rx"
    empty = np.zeros(0, dtype=np.int32)
    st = sh.stats["per_dev"][d]
    return EhybMatrix(
        dim=sh.rows_per_dev, nnz_total=int(st.get("nnz", 0)),
        window_rows=sh.window_rows, n_parts=1,
        ell_col=sh.ell_col[d], ell_val=sh.ell_val[d],
        slice_offset=sh.slice_offset[d],
        slice_win_start=sh.slice_win_start[d], step_win=sh.step_win[d],
        step_win_b=sh.step_win_b[d] if rx else empty,
        step_win_c=sh.step_win_c[d] if rx else empty,
        step_win_d=sh.step_win_d[d] if rx else empty,
        er_col=sh.er_col[d], er_val=sh.er_val[d],
        er_slice_offset=sh.er_slice_offset[d], er_rows=sh.er_rows[d],
        long_col=sh.long_col[d], long_val=sh.long_val[d],
        long_seg=sh.long_seg[d], long_rows=sh.long_rows[d],
        dia_offsets=np.asarray(sh.dia_offsets, dtype=np.int64),
        dia_val=sh.dia_val[d], stats=dict(st))


# ---------------------------------------------------------------------------
# Host setup: the layout decisions the TPU takes, then the shards.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedSetup:
    """What every rank of one sharded model shares: the reordering, the
    final config (after the layout switches), the plan and the stacked
    shards.  A launcher may make it once and hand it to each rank."""

    reordering: Reordering
    config: EhybConfig
    plan: Plan
    sharded: ShardedEhyb
    #: Host seconds per phase of :func:`plan_sharded`.
    seconds: dict


def plan_sharded(m: MatrixCOO, config: EhybConfig,
                 n_dev: int) -> ShardedSetup:
    """Order, convert and shard ``m`` for ``n_dev`` ranks, taking the
    layout decisions of the JAX ``ShardedEhybSpmv.setup`` as the TPU takes
    them when its body runs the Pallas kernel (a 1024-row window): the
    multi-window layout with 16-bit columns, the relaxed-layout probe and
    the quad upgrade, each decided over all shards at once.  With a
    narrower window (shards under 1024 rows) the TPU runs its XLA body on
    the layout as configured, and so does this plan; the card runs K1 over
    either."""
    t0 = time.perf_counter()
    cfg = config
    dim = m.dimension
    # a window must fit inside one shard's rows (± one-neighbor halo)
    R = round_up(cdiv(dim, n_dev), LANES)
    base_plan = make_plan(dim, cfg)
    W = min(base_plan.window_rows, R)
    pallas = W == WINDOW_ALIGN
    if pallas and cfg.body_layout not in ("sell_mw", "sell_cs", "sell_rx"):
        idx_dtype = cfg.index_dtype
        if idx_dtype == "int32":
            idx_dtype = "int16"  # window-local cols < 1024
        cfg = dataclasses.replace(cfg, body_layout="sell_mw",
                                  index_dtype=idx_dtype)
    n_parts = max(n_dev, cdiv(dim, W))
    plan = Plan(dim=dim, n_parts=n_parts, window_rows=W, part_align=LANES,
                padded_dim=round_up(dim, LANES) + W)
    if cfg.features.reorder and plan.n_parts > 1:
        labels = partition_rows(m, plan.n_parts, cfg.partitioner,
                                cfg.partition_imbalance)
        reordering = two_level_reorder(m, labels, plan,
                                       sort_rows=cfg.features.sort_rows)
    else:
        bounds = np.minimum(np.arange(plan.n_parts + 1) * plan.window_rows,
                            dim)
        bounds[-1] = dim
        reordering = identity_reordering(dim, bounds)
    # within-shard local ordering refinement: rows permute within their
    # span only, so the cut (and the exchange plan) is unaffected
    if cfg.features.reorder and cfg.body_layout in ("sell_mw", "sell_rx",
                                                    "sell"):
        reordering = _refine_within_shards(m, reordering, R, n_dev, cfg)
    seconds = {"order": time.perf_counter() - t0}
    t1 = time.perf_counter()
    m_r = reordering.apply_to_matrix(m)

    def totals(sh):
        per = sh.stats["per_dev"]
        return (sum(s["nnz_ell"] for s in per),
                sum(s["waste_ell"] for s in per),
                sum(s["ell_steps"] for s in per))

    sh = None
    if cfg.body_layout == "sell_mw" and cfg.relax_body == "auto" and pallas:
        # convert chunk-sync first; where the padding is high over all
        # shards, reconvert every shard with the relaxed layout
        sh = build_sharded(m_r, reordering, W, n_dev, cfg)
        nnz_ell, waste, steps_mw = totals(sh)
        if nnz_ell > 0 and waste > _RELAX_WASTE_GATE * (nnz_ell + waste):
            cfg_rx = dataclasses.replace(cfg, body_layout="sell_rx")
            sh_rx = build_sharded(m_r, reordering, W, n_dev, cfg_rx)
            if totals(sh_rx)[2] * _CYC_RX_VREG < steps_mw * _CYC_MW_VREG:
                log.info("sharded relaxed body wins: %d → %d ell steps",
                         steps_mw, totals(sh_rx)[2])
                cfg, sh = cfg_rx, sh_rx
    if (cfg.body_layout == "sell_rx" and cfg.relax_body == "auto"
            and cfg.windows_per_subtile == 2 and pallas):
        if sh is None or sh.stats["layout"] != "sell_rx":
            sh = build_sharded(m_r, reordering, W, n_dev, cfg)
        nnz_ell, waste, steps_rx = totals(sh)
        if nnz_ell > 0 and waste > _QUAD_WASTE_GATE * (nnz_ell + waste):
            cfg4 = dataclasses.replace(cfg, windows_per_subtile=4)
            sh4 = build_sharded(m_r, reordering, W, n_dev, cfg4)
            if totals(sh4)[2] * _CYC_RX4_VREG < steps_rx * _CYC_RX_VREG:
                log.info("sharded quad windows win: %d → %d ell steps",
                         steps_rx, totals(sh4)[2])
                cfg, sh = cfg4, sh4
    if sh is None:
        sh = build_sharded(m_r, reordering, W, n_dev, cfg)
    seconds["convert"] = time.perf_counter() - t1
    seconds["total"] = time.perf_counter() - t0
    return ShardedSetup(reordering=reordering, config=cfg, plan=plan,
                        sharded=sh, seconds=seconds)


# ---------------------------------------------------------------------------
# Device half: one rank's apply.
# ---------------------------------------------------------------------------

class ShardedEhybApply(torch.nn.Module):
    """One rank's apply (the JAX path's ``_shard_body``):
    ``forward(x_local)`` → the rank's R rows of y.

    Per call: start the halo and ER exchanges; run K1 over the interior row
    blocks (local x rows only); complete the exchanges; run K1 over the
    boundary row blocks into the same y; the ER and long rows on
    ``[x_ext | recv]``; DIA on ``x_ext`` with base W; combine and truncate
    to R rows."""

    def __init__(self, e, cells: Optional[ShardCellsDevice],
                 ex: ShardExchange, kahan: bool = False):
        super().__init__()
        self.e = e
        self.cells = cells
        self.ex = ex
        self.kahan = kahan

    def body_split(self, y: torch.Tensor, part: str) -> None:
        """K1 over the ``part`` ("interior" or "boundary") row blocks of the
        shard's plan, into their rows of ``y``."""
        c = self.cells
        rbs = c.interior if part == "interior" else c.boundary
        if c.plan.n_cells and rbs.shape[0]:
            stream_body(c.plan, self.ex.x_buf, self.kahan, rb_list=rbs,
                        out=y)

    def forward(self, x_local: torch.Tensor) -> torch.Tensor:
        e, ex = self.e, self.ex
        R = ex.R
        if x_local.data_ptr() != ex.x_local.data_ptr():
            ex.x_local.copy_(x_local)
        pending = ex.start()
        n_body = e.slice_win_start.shape[0] * LANES
        if self.cells is None:
            y_body = ex.x_buf.new_zeros(n_body)
        else:
            y_body = ex.x_buf.new_empty(n_body)
            self.body_split(y_body, "interior")
        ex.finish(pending)
        if self.cells is not None:
            self.body_split(y_body, "boundary")
        x = ex.x_buf
        y = combine_ehyb(e, y_body, ehyb_er(e, x), ehyb_long(e, x),
                         ehyb_dia(e, x, x_base=ex.W))
        return y[:R]


class ShardedEhybSpmv(SpmvModel):
    """One rank of the row-sharded EHYB model: global partition + reorder,
    uniform row shards, halo'd window body in two K1 launches, compressed
    ER exchange.

    ``group`` is the ``torch.distributed`` process group of the ranks
    (None: the default group where one is initialized, else a world of one
    rank, which runs no collective at all).  ``device`` defaults to
    ``cuda:{rank % device_count}``; the CPU only where asked.  On a card a
    world of one rank replays CUDA graphs in :meth:`iterate`; a larger
    world runs the same step eagerly (``self.loop``), since its collectives
    cannot be captured.  Every rank of the group calls ``setup``,
    ``apply`` and ``recover_y`` together (the last two exchange)."""

    name = "ehyb_sharded"

    def __init__(self, config: Optional[EhybConfig] = None, *, group=None,
                 device=None):
        self.group, self.rank, self.n_dev = group_rank_world(group)
        super().__init__(config, device=rank_device(device, self.rank))
        #: How :meth:`iterate` runs on this rank: "graph" or "eager".
        self.loop = "eager"

    def setup(self, m: MatrixCOO,
              host: Optional[ShardedSetup] = None) -> "ShardedEhybSpmv":
        """Convert (or take ``host``, made by :func:`plan_sharded` for this
        world size) and upload this rank's shard."""
        self.m = m
        if host is None:
            host = plan_sharded(m, self.config, self.n_dev)
        if host.sharded.n_dev != self.n_dev:
            raise ValueError(f"setup made for {host.sharded.n_dev} ranks, "
                             f"the group has {self.n_dev}")
        self.config = cfg = host.config
        self.reordering = host.reordering
        self.plan = host.plan
        self.sharded = sh = host.sharded
        self.setup_seconds = dict(host.seconds)
        t1 = time.perf_counter()
        e = shard_matrix(sh, self.rank)
        self.ehyb = e
        dev = e.to_torch(dtype=cfg.dtype, device=self.device)
        ex = ShardExchange(self.group, self.rank, self.n_dev,
                           sh.rows_per_dev, sh.window_rows,
                           sh.send_idx[self.rank], sh.exchange_slots,
                           self.device, cfg.dtype)
        t2 = time.perf_counter()
        cells = None
        if dev.body_nnz:
            cells = build_shard_cells(
                e, sh, force_boundary=os.environ.get(
                    "EHYB_FORCE_BOUNDARY", "") == "1").to_torch(self.device)
            dev.ell_col = dev.ell_val = None
        self.setup_seconds["k1_plan"] = time.perf_counter() - t2
        self.module = ShardedEhybApply(dev, cells, ex,
                                       kahan=bool(cfg.compensated_sum))
        self.setup_seconds["upload"] = time.perf_counter() - t1
        self.setup_seconds["total"] = (host.seconds["total"]
                                       + time.perf_counter() - t1)
        self.loop = ("graph" if self.device.type == "cuda"
                     and self.n_dev == 1 else "eager")
        if self.device.type == "cuda" and self.n_dev > 1:
            log.info("rank %d: %d ranks — iterate runs eagerly (the "
                     "exchanges cannot be captured in a CUDA graph)",
                     self.rank, self.n_dev)
        st = cells.stats if cells is not None else {}
        log.info("rank %d/%d on %s: R=%d W=%d layout=%s S=%d, %d interior "
                 "and %d boundary row blocks", self.rank, self.n_dev,
                 self.device, sh.rows_per_dev, sh.window_rows,
                 sh.stats["layout"], sh.exchange_slots,
                 st.get("n_interior", 0), st.get("n_boundary", 0))
        return self

    # -- vector plumbing ---------------------------------------------------
    def prepare_x(self, x: np.ndarray) -> torch.Tensor:
        """Host x (original order) → this rank's R rows, written into the
        middle of its ``x_ext`` buffer (the returned tensor is that view)."""
        R = self.sharded.rows_per_dev
        xr = self.reordering.vector_reorder(np.asarray(x))
        lo = self.rank * R
        part = np.zeros(R, dtype=self.config.dtype)
        mine = xr[lo:lo + R]
        part[: mine.shape[0]] = mine
        xl = self.module.ex.x_local
        xl.copy_(torch.from_numpy(part))
        return xl

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        """Every rank's R rows (gathered over the group) → host f64 y in the
        original order."""
        y_all = all_gather_rows(self.group, self.n_dev, y)
        y_np = y_all.detach().cpu().numpy().astype(np.float64)
        return self.reordering.vector_recover(y_np[: self.m.n_rows])

    @torch.no_grad()
    def iterate(self, x_dev, n_iters: int, eps: float = 0.0) -> torch.Tensor:
        if self.loop == "eager":
            return self.iterate_eager(x_dev, n_iters, eps)
        return super().iterate(x_dev, n_iters, eps)

    def roofline_phases(self) -> dict:
        """(flops, device-memory bytes) per apply of this rank: its plan's
        cells and tables (in place of the padded body), the union DIA, the
        ER and long streams, ``x_ext`` and ``recv`` read once and y written
        once."""
        sh = self.sharded
        R, W, S, D = (sh.rows_per_dev, sh.window_rows, sh.exchange_slots,
                      sh.n_dev)
        vb = np.dtype(self.config.dtype).itemsize
        phases = phase_roofline(
            self.ehyb.stats, value_bytes=vb,
            ell_index_bytes=np.dtype(self.config.index_dtype).itemsize)
        phases["x/y vectors"] = (0, (R + 2 * W + D * S + R) * vb)
        phases["dia"] = (phases["dia"][0], len(sh.dia_offsets) * R * vb)
        cells = self.module.cells if self.module is not None else None
        if cells is not None:
            phases["body"] = (phases["body"][0],
                              cells.plan.stats["stream_bytes"])
        return phases
