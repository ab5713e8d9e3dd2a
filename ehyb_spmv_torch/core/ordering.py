"""Row-ordering strategies + the ordering auto-selector.

The reference has exactly one ordering strategy: METIS partition grouping +
in-partition density sort (``reordering.c:231-378``), because its kernel cost
model is fixed (shared-memory windows + warp work-stealing).  The TPU
multi-window SELL body has a *measurable* host-side cost function — the total
number of packed width-steps (= streamed bytes) — so the framework treats
ordering as a planned choice:

  * ``natural``   — identity (optimal for matrices generated/stored banded);
  * ``rcm``       — reverse Cuthill-McKee (pseudo-RCM: level-set BFS with
    degree-sorted levels), the classic bandwidth-minimizing ordering;
  * ``partition`` — the reference's graph-partition grouping + in-partition
    sort (best for matrices with cluster structure but no band);
  * ``auto``      — estimate the packed-step count for each candidate with
    :func:`estimate_mw_steps` and keep the cheapest.

All orderings return a :class:`~.reorder.Reordering` so downstream conversion
and the x/y permutations are uniform.

Port copy of ``ehyb_spmv_gpu_tpu/core/ordering.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import EhybConfig, cdiv, round_up
from ..core.coo import MatrixCOO
from ..core.planner import Plan
from ..core.reorder import Reordering, identity_reordering, two_level_reorder
from ..utils.log import get_logger

log = get_logger(__name__)

_WSPAN = 1024
_TILE = 8
#: Above this nnz the ordering auto-selector estimates on a uniform entry
#: subsample (module-level so tests can exercise the sampled path).
#: 2M (was 8M): the per-candidate estimate sorts dominate above this, and the
#: ranking is preserved by the uniform subsample — measured on
#: permuted_poisson_1024 (5.2M nnz): top pick identical at full/2M/1M caps,
#: the only movement a #2/#3 swap between candidates 0.3% apart (round-4
#: cold-setup work).
SAMPLE_CAP = 2_000_000


def rcm_order(m: MatrixCOO, adj=None) -> np.ndarray:
    """Pseudo-RCM: BFS level sets from a min-degree seed, each level sorted by
    degree, order reversed.  Returns ``new_to_old``.  Vectorized per level.

    ``adj``: optional precomputed ``adjacency_csr(m)`` (shared with the
    partitioner by the auto-selector — it is the order phase's largest
    single cost at audikw scale).

    The traversal runs native by default (``native/rcm.cpp``, bit-identical
    output — equivalence pinned by tests): the per-level NumPy formulation
    below cost ~190 s on permuted_poisson_4096 (16.7M vertices, thousands of
    shallow levels, a full unique() sort each); ``EHYB_NATIVE_RCM=0`` or a
    missing toolchain falls back to it."""
    from ..partition import adjacency_csr

    xadj, adjncy = adj if adj is not None else adjacency_csr(m)
    dim = m.dimension
    if os.environ.get("EHYB_NATIVE_RCM", "1") != "0":
        try:
            from ..native import rcm_native

            return rcm_native(xadj, adjncy)
        except Exception as exc:              # pragma: no cover - no g++
            log.warning("native rcm unavailable (%s); NumPy fallback", exc)
    deg = np.diff(xadj)
    visited = np.zeros(dim, dtype=bool)
    order = np.empty(dim, dtype=np.int64)
    pos = 0

    deg_order = np.argsort(deg, kind="stable")  # seeds by ascending degree
    seed_ptr = 0
    while pos < dim:
        while seed_ptr < dim and visited[deg_order[seed_ptr]]:
            seed_ptr += 1
        if seed_ptr >= dim:
            rest = np.flatnonzero(~visited)
            order[pos:pos + rest.size] = rest
            pos += rest.size
            break
        frontier = np.array([deg_order[seed_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            order[pos:pos + frontier.size] = frontier
            pos += frontier.size
            counts = (xadj[frontier + 1] - xadj[frontier]).astype(np.int64)
            if counts.sum() == 0:
                break
            flat = (np.repeat(xadj[frontier].astype(np.int64), counts)
                    + np.arange(int(counts.sum()))
                    - np.repeat(np.cumsum(counts) - counts, counts))
            nbrs = adjncy[flat].astype(np.int64)
            nbrs = np.unique(nbrs)
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size == 0:
                break
            visited[nbrs] = True
            frontier = nbrs[np.argsort(deg[nbrs], kind="stable")]
    return order[::-1].copy()  # the "reverse" in RCM


def reordering_from_order(new_to_old: np.ndarray, dim: int,
                          chunk: int = _WSPAN) -> Reordering:
    """Wrap a bare permutation as a Reordering with uniform chunk boundaries
    (the multi-window body ignores partition windows; uniform boundaries keep
    the windowed layouts and stats well-defined)."""
    old_to_new = np.empty(dim, dtype=np.int64)
    old_to_new[new_to_old] = np.arange(dim, dtype=np.int64)
    bounds = np.arange(0, dim + chunk, chunk, dtype=np.int64)
    bounds = np.unique(np.minimum(bounds, dim))
    return Reordering(new_to_old=np.asarray(new_to_old, dtype=np.int64),
                      old_to_new=old_to_new, boundaries=bounds)


#: Measured VPU cost per (8,128) vreg on v5e: DIA shifted-slice FMA vs the
#: SELL two-stage dynamic_gather body (see scripts/profile_kernel.py).
_CYC_DIA_VREG = 4.0
_CYC_SELL_VREG = 22.0
#: Measured XLA global-gather ER cost per ELEMENT on v5e (~65M elem/s ≈ 14
#: cycles each — the TPU gather wall; see git history "ER-everything" probe).
#: In body width-steps: one 128-entry ER step ≈ 14·128 / (22/8) cyc-per-step.
_ER_STEP_EQUIV = 14.0 * 128.0 / (_CYC_SELL_VREG / 8.0)


def estimate_cost(row_new: np.ndarray, col_new: np.ndarray, dim: int,
                  config: EhybConfig, step_scale: float = 1.0) -> float:
    """Estimated device cost (VPU cycle units) of the multi-window EHYB apply
    under a given ordering, DIA extraction included.

    Diagonals above the extraction threshold are charged at the gather-free
    DIA rate; remaining entries at the SELL-body rate via
    :func:`estimate_mw_steps`.
    """
    d = col_new.astype(np.int64) - row_new.astype(np.int64)
    counts = np.bincount(d + (dim - 1), minlength=2 * dim - 1)
    min_count = max(1, int(np.ceil(config.dia_threshold * dim)))
    cand = np.flatnonzero(counts >= min_count)
    if cand.size > config.max_diagonals:
        cand = cand[np.argsort(-counts[cand], kind="stable")
                    [:config.max_diagonals]]
    n_dia = cand.size
    if n_dia:
        is_dia = np.zeros(2 * dim - 1, dtype=bool)
        is_dia[cand] = True
        rest = ~is_dia[d + (dim - 1)]
        row_new, col_new = row_new[rest], col_new[rest]
    steps = estimate_mw_steps(row_new, col_new, dim, config.slice_rows,
                              config.min_window_group_nnz,
                              sliding=bool(config.sliding_windows))
    # step_scale rescales only the nnz-proportional SELL term (sampled
    # estimates); the DIA vreg cost depends on dim alone.
    return (n_dia * cdiv(dim, 1024) * _CYC_DIA_VREG
            + step_scale * steps / 8.0 * _CYC_SELL_VREG)


def estimate_mw_steps(row_new: np.ndarray, col_new: np.ndarray, dim: int,
                      slice_rows: int = 128, min_group_nnz: int = 4,
                      sliding: bool = False) -> int:
    """Device-cost estimate in *body-width-step equivalents* for the
    multi-window layout under a given ordering (rows/cols already permuted).

    Counting only (no scatter): Σ over kept (slice, window) groups of
    Σ_c max_lane count, tile-padded.  Rejected-group entries would stream
    through the XLA global-gather ER tail, measured ~650x slower per step
    than the body — they are charged at ``_ER_STEP_EQUIV`` step-equivalents
    per 128 entries, so the return value is a relative cost, NOT a byte
    count.  Compare values only against other calls of this function.
    """
    from ..core.convert import _assign_windows

    C = slice_rows
    sl = row_new // C
    wc = _assign_windows(sl, col_new // 128, sliding)
    NW = int(wc.max(initial=0)) + 1
    gkey = sl * NW + wc
    uniq, ginv, gcount = np.unique(gkey, return_inverse=True,
                                   return_counts=True)
    keep = gcount >= min_group_nnz
    body = keep[ginv]
    K = int(keep.sum())
    # ER entries are charged at the measured global-gather rate, expressed in
    # equivalent body width-steps so the return value stays one number.
    er_steps = int(((~body).sum() / C) * _ER_STEP_EQUIV)
    if K == 0:
        return er_steps
    kmap = np.full(uniq.shape[0], -1, dtype=np.int64)
    kmap[keep] = np.arange(K)
    kidx = kmap[ginv][body]
    lane = (row_new % C)[body]
    ch = (col_new // 128 - wc)[body]  # window-local chunk ∈ [0, 8)
    # Sparse run-length counting (same scheme as _sell_pack_multiwindow): a
    # dense bincount would be K·C·8 cells — tens of GB when millions of small
    # groups are kept on an audikw-scale scrambled matrix.
    key2 = (kidx * C + lane) * 8 + ch
    key_s = np.sort(key2, kind="stable")
    new_run = np.empty(key_s.shape[0], dtype=bool)
    new_run[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=new_run[1:])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, key_s.shape[0]))
    u = key_s[run_start]
    w_kc = np.zeros((K, 8), dtype=np.int64)
    np.maximum.at(w_kc, (u // (C * 8), u % 8), run_len)
    gw = w_kc.sum(axis=1)
    gwp = (-(-gw // _TILE)) * _TILE
    return int(gwp.sum()) + er_steps


def pick_ordering(m: MatrixCOO, plan: Plan, config: EhybConfig,
                  mode: str = "auto") -> Reordering:
    """Return the Reordering for the requested (or estimated-best) strategy."""
    from ..partition import partition_rows

    dim = m.dimension
    shared = {}  # expensive intermediates reused across candidates
    # (auto mode previously ran the partitioner twice and the RCM BFS three
    # times; on permuted_poisson_4096 that alone was most of a 798 s order
    # phase — preprocessing is supposed to be cheap)

    def get_adj():
        if "adj" not in shared:
            from ..partition import adjacency_csr

            shared["adj"] = adjacency_csr(m)
        return shared["adj"]

    def get_labels():
        if "labels" not in shared:
            shared["labels"] = partition_rows(
                m, plan.n_parts, config.partitioner,
                config.partition_imbalance, adj=get_adj())
        return shared["labels"]

    def get_rcm_base():
        if "rcm" not in shared:
            shared["rcm"] = rcm_order(m, adj=get_adj())
        return shared["rcm"]

    def natural():
        return reordering_from_order(np.arange(dim, dtype=np.int64), dim)

    def rcm():
        return reordering_from_order(get_rcm_base(), dim)

    def rcm_pattern():
        # RCM for bandwidth, then rows re-sorted inside 1024-row locality
        # buckets by (first-chunk, density): rows sharing a 128-row SELL
        # slice then use the same column chunks, which is what the
        # per-(slice, chunk) max-over-lanes padding actually depends on.
        base = get_rcm_base()
        pos_of_old = np.empty(dim, dtype=np.int64)
        pos_of_old[base] = np.arange(dim, dtype=np.int64)
        col1 = pos_of_old[m.col]
        row1 = pos_of_old[m.row]
        min_col = np.full(dim, dim, dtype=np.int64)
        np.minimum.at(min_col, row1, col1)
        counts = np.bincount(row1, minlength=dim)
        bucket = np.arange(dim, dtype=np.int64) // 1024
        order = np.lexsort((-counts, min_col // 128, bucket))
        return reordering_from_order(base[order], dim)

    def partition():
        return two_level_reorder(m, get_labels(), plan, sort_rows=True,
                                 sort_mode="pattern")

    def partition_rcm():
        # Composition: partition grouping first, THEN RCM on the regrouped
        # matrix.  Measured 1.2-1.5x fewer relaxed-body steps than direct
        # RCM on scrambled stencils (the grouping changes RCM's BFS seeds
        # and level structure); ~equal elsewhere.
        r1 = two_level_reorder(m, get_labels(), plan, sort_rows=True,
                               sort_mode="pattern")
        m1 = r1.apply_to_matrix(m)
        order2 = rcm_order(m1)
        return reordering_from_order(r1.new_to_old[order2], dim)

    candidates = {"natural": natural, "rcm": rcm,
                  "rcm_pattern": rcm_pattern, "partition": partition,
                  "partition_rcm": partition_rcm}
    if mode in candidates:
        return candidates[mode]()
    if mode != "auto":
        raise ValueError(f"unknown ordering {mode!r}")

    # Lower bound: every nnz lands in a perfectly-filled DIA vreg.  If a
    # candidate is already within 1.5x of it, stop evaluating (RCM/partition
    # construction is minutes of host time on audikw_1-scale matrices).
    floor = m.nnz / 1024.0 * (_CYC_DIA_VREG if config.features.dia
                              else _CYC_SELL_VREG)
    # Sampled estimates above the cap: a uniform entry
    # subsample preserves the candidates' RANKING (counts scale by frac;
    # thresholds are scaled to match) at a fraction of the sort cost.
    if m.nnz > SAMPLE_CAP:
        frac = SAMPLE_CAP / m.nnz
        rng = np.random.default_rng(0)
        sample = rng.random(m.nnz) < frac
        s_row, s_col = m.row[sample], m.col[sample]
        import dataclasses as _dc

        est_cfg = _dc.replace(
            config, dia_threshold=config.dia_threshold * frac,
            min_window_group_nnz=max(
                1, int(round(config.min_window_group_nnz * frac))))
        scale = 1.0 / frac
        log.info("ordering estimates sampled: %d of %d nnz", s_row.size,
                 m.nnz)
    else:
        s_row, s_col, est_cfg, scale = m.row, m.col, config, 1.0
    best_name, best_r, best_cost = None, None, None
    nat_cost = None
    # Partition-futility gate: the graph partitioner is by far the most
    # expensive candidate to BUILD (261 s on the powerlaw_1m split body,
    # where it then won over rcm_pattern by 1.1% estimated cost).  Skip the
    # partition candidates only when BOTH hold:
    #   * the best RCM-family candidate is still far above the perfect-fill
    #     floor (skip_k, default 32x), AND
    #   * RCM did not materially beat the natural ordering (< 4x) — i.e.
    #     BFS found nothing recoverable, the true gather-wall signature.
    # The second condition is the discriminator the floor multiple alone
    # lacks: a large scrambled stencil (permuted_poisson_1024) sits at 82x
    # the floor under RCM yet RCM is 46x better than natural — structure IS
    # recoverable and partition grouping takes the measured body from 31 to
    # ~40 GFLOP/s; a structureless matrix (random/powerlaw 1m) has
    # RCM ≈ natural, and there the partitioner is minutes of host time for
    # ~1% estimated gain (the routed engine owns that regime).
    skip_k = float(os.environ.get("EHYB_ORDER_PART_SKIP", "32"))
    for name, fn in candidates.items():
        if (name.startswith("partition") and "labels" not in shared
                and best_cost is not None and skip_k > 0
                and best_cost > skip_k * floor
                and (nat_cost is None or best_cost * 4.0 > nat_cost)):
            log.info("ordering %s skipped: best %.0f is %.0fx the nnz floor "
                     "— grouping cannot close a gather-wall fill gap "
                     "(EHYB_ORDER_PART_SKIP=0 forces evaluation)",
                     name, best_cost, best_cost / floor)
            continue
        r = fn()
        if config.features.dia:
            cost = estimate_cost(r.old_to_new[s_row], r.old_to_new[s_col],
                                 dim, est_cfg, step_scale=scale)
        else:
            cost = scale * (estimate_mw_steps(r.old_to_new[s_row],
                                              r.old_to_new[s_col], dim,
                                              est_cfg.slice_rows,
                                              est_cfg.min_window_group_nnz)
                            / 8.0 * _CYC_SELL_VREG)
        log.info("ordering %s: estimated cost %.0f cyc-units", name, cost)
        if name == "natural":
            nat_cost = cost
        if best_cost is None or cost < best_cost:
            best_name, best_r, best_cost = name, r, cost
        if best_cost <= 1.5 * floor:
            log.info("ordering %s within 1.5x of the nnz floor; stopping",
                     best_name)
            break
    log.info("ordering auto → %s (cost %.0f)", best_name, best_cost)
    return best_r
