"""COO → EHYB-TPU conversion.

TPU re-design of ``convert.c`` (``COO2EHYB``, ``convert.c:316-369``).  The
reference walks partitions row-by-row in C (``vecsGenBlockELL`` ``convert.c:61-146``,
``vecsGenER`` ``convert.c:148-168``, ``COO2EHYBCore`` ``convert.c:170-311``);
here every pass is a vectorized NumPy scatter over all nnz at once:

  1. classify every entry: in-window (→ SELL body) vs out-of-window; rows whose
     out-of-window count exceeds the long-row threshold divert those entries to
     the long-row stream (cf. ``convert.c:92-101``, but keyed on ER count — see
     ``core/ehyb.py`` docstring for why);
  2. SELL body: per-slice width = max in-window row nnz in the 128-row slice,
     padded to the width alignment; prefix-sum slice offsets; one flat scatter
     of (value, local column) into the (steps, 128) arrays (role of
     ``COO2EHYBCore``'s in-window branch, ``convert.c:247-250``);
  3. ER tail: rows globally density-sorted by ER count (role of
     ``sortRordrListFull`` ``convert.c:8-31``), SELL-packed with global columns
     (role of ``convert.c:264-265``) and the ``rowVecER`` scatter-back map;
  4. long rows: entries sorted by row into a stream with segment ids.

Conversion invariants (checked by ``verify_conversion`` and unit tests, not by
``exit()`` like the reference's inline checks at ``convert.c:226-304``):
  * nnz conservation: ELL + ER + long = total (cf. ``convert.c:140``);
  * per-slice width ≥ every member row's in-window count;
  * padding accounted via ``stats['waste_ell']`` (role of ``wasteElement``,
    ``convert.c:310``).

Port copy of ``ehyb_spmv_gpu_tpu/core/convert.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..config import EhybConfig, LANES, cdiv, round_up
from ..core.coo import MatrixCOO
from ..core.ehyb import EhybMatrix
from ..core.planner import Plan
from ..core.reorder import Reordering
from ..utils.log import get_logger

log = get_logger(__name__)


def _sell_pack(row: np.ndarray, col: np.ndarray, val: np.ndarray,
               n_rows_padded: int, slice_rows: int, width_align: int,
               col_dtype, val_dtype) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack (row, col, val) into SELL slices of ``slice_rows`` rows.

    ``row`` must already be the *packed* row index (dense in [0, n_rows_padded)).
    Returns (col_arr, val_arr, slice_offset, waste) where col/val have shape
    (total_steps, slice_rows), and waste counts zero-padded cells.
    """
    n_slices = max(1, cdiv(n_rows_padded, slice_rows))
    counts = np.bincount(row, minlength=n_slices * slice_rows).astype(np.int64)
    widths = counts.reshape(n_slices, slice_rows).max(axis=1)
    widths = (cdiv_arr(widths, width_align) * width_align).astype(np.int64)
    # Every slice gets >= one width-step tile so the Pallas tile grid visits
    # (and initializes) every output block, even all-empty slices.
    widths = np.maximum(widths, width_align)
    slice_offset = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(widths, out=slice_offset[1:])
    total_steps = int(slice_offset[-1])

    col_arr = np.zeros((total_steps, slice_rows), dtype=col_dtype)
    val_arr = np.zeros((total_steps, slice_rows), dtype=val_dtype)

    if row.size:
        # Rank of each entry within its row (entries assumed grouped by row via
        # stable sort below).
        order = np.argsort(row, kind="stable")
        row_s, col_s, val_s = row[order], col[order], val[order]
        row_ptr = np.zeros(n_slices * slice_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        rank = np.arange(row_s.size, dtype=np.int64) - row_ptr[row_s]
        sl = row_s // slice_rows
        lane = row_s - sl * slice_rows
        step = slice_offset[sl] + rank
        flat = step * slice_rows + lane
        col_arr.reshape(-1)[flat] = col_s.astype(col_dtype)
        val_arr.reshape(-1)[flat] = val_s.astype(val_dtype)

    waste = int(total_steps * slice_rows - row.size)
    return col_arr, val_arr, slice_offset.astype(np.int32), waste


def _sell_pack_chunk_sync(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                          n_rows_padded: int, slice_rows: int, width_align: int,
                          window_rows: int, col_dtype, val_dtype
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Chunk-synchronized SELL packing — the layout the Pallas two-stage-gather
    kernel requires.

    TPU ``tpu.dynamic_gather`` composes an arbitrary window gather out of a
    sublane gather (pick window chunk) followed by a lane gather (pick element
    within the 128-wide chunk) **only if every lane of a width-step reads from
    the same window chunk** (``hi = col >> 7`` constant per step).  This packer
    provides that guarantee: within each slice, entries are grouped by window
    chunk; per-(slice, chunk) width = max over member rows of that row's count
    in the chunk.  Padding cells carry ``col = chunk * 128`` so their ``hi``
    matches the step's chunk (their value is 0, so the gathered element is
    multiplied away).

    Costs extra padding versus plain SELL (sum-of-chunk-maxes ≥ max-of-sums);
    the in-partition density sort keeps member rows structurally similar, which
    keeps the delta small on mesh-like matrices.  Same return convention as
    :func:`_sell_pack`.
    """
    assert window_rows % slice_rows == 0 or window_rows <= slice_rows
    n_chunks = max(1, cdiv(window_rows, 128))
    n_slices = max(1, cdiv(n_rows_padded, slice_rows))
    chunk = (col // 128).astype(np.int64)  # ∈ [0, n_chunks)

    # counts[row, chunk]
    key = row * n_chunks + chunk
    counts = np.bincount(key, minlength=n_slices * slice_rows * n_chunks)
    counts = counts.reshape(n_slices, slice_rows, n_chunks).astype(np.int64)
    w_sc = counts.max(axis=1)                       # (n_slices, n_chunks)
    widths = w_sc.sum(axis=1)
    widths_padded = cdiv_arr(widths, width_align) * width_align
    widths_padded = np.maximum(widths_padded, width_align)  # no empty slices

    # step offset of chunk c within slice s
    choff = np.zeros((n_slices, n_chunks + 1), dtype=np.int64)
    np.cumsum(w_sc, axis=1, out=choff[:, 1:])
    slice_offset = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(widths_padded, out=slice_offset[1:])
    total_steps = int(slice_offset[-1])

    # Paint every cell's column with its step's chunk base so padding cells
    # satisfy the chunk-sync invariant (hi == step chunk).
    step_chunk = np.zeros(total_steps, dtype=np.int64)
    for c in range(n_chunks):  # n_chunks ≤ 8 for the native window
        starts = slice_offset[:-1] + choff[:, c]
        ends = slice_offset[:-1] + choff[:, c + 1]
        mask = np.zeros(total_steps + 1, dtype=np.int64)
        np.add.at(mask, starts, 1)
        np.add.at(mask, ends, -1)
        inside = np.cumsum(mask[:-1]) > 0
        step_chunk[inside] = c
    col_arr = np.broadcast_to((step_chunk * 128)[:, None],
                              (total_steps, slice_rows)).astype(col_dtype).copy()
    val_arr = np.zeros((total_steps, slice_rows), dtype=val_dtype)

    if row.size:
        # rank within (row, chunk)
        order = np.argsort(key, kind="stable")
        row_s, col_s, val_s, key_s = row[order], col[order], val[order], key[order]
        key_ptr = np.zeros(counts.size + 1, dtype=np.int64)
        np.cumsum(counts.reshape(-1), out=key_ptr[1:])
        rank = np.arange(row_s.size, dtype=np.int64) - key_ptr[key_s]
        sl = row_s // slice_rows
        lane = row_s - sl * slice_rows
        c_s = key_s % n_chunks
        step = slice_offset[sl] + choff[sl, c_s] + rank
        flat = step * slice_rows + lane
        col_arr.reshape(-1)[flat] = col_s.astype(col_dtype)
        val_arr.reshape(-1)[flat] = val_s.astype(val_dtype)

    waste = int(total_steps * slice_rows - row.size)
    return col_arr, val_arr, slice_offset.astype(np.int32), waste


def cdiv_arr(a: np.ndarray, b: int) -> np.ndarray:
    return -(-a // b)


#: Width-steps per kernel tile; group widths pad to this (must match
#: ops.ehyb_pallas.TILE_STEPS).
_TILE = 8


def _assign_windows(sl: np.ndarray, ch: np.ndarray, sliding: bool
                    ) -> np.ndarray:
    """Per-entry x-window start (in 128-col chunks) for the multi-window body.

    ``sliding=False``: windows are 1024-aligned (``ch//8*8``) — required by the
    windowed (non-VMEM-resident) kernel's BlockSpec granularity.
    ``sliding=True``: per-slice greedy cover with arbitrary 128-aligned starts
    — the resident kernel selects windows per sub-tile with a dynamic sublane
    slice, so only chunk alignment is needed.  For banded matrices (e.g. RCM
    ordered) this halves the group count: a band straddling a 1024 boundary no
    longer splits into two half-empty windows.
    """
    if not sliding:
        return (ch // 8) * 8
    NC = int(ch.max(initial=0)) + 1
    key = sl * NC + ch
    uniq = np.unique(key)
    sl_u, ch_u = uniq // NC, uniq % NC
    n = uniq.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # Vectorized greedy cover (the scalar scan stalled for
    # minutes on audikw-scale banded matrices).  Each round advances every
    # slice's pointer to its next window head via ONE global searchsorted on
    # the (slice, chunk) key (chunks ascend within a slice segment); the
    # head chunks are then forward-filled to the covered members.  Rounds =
    # max windows per slice; each is O(active log n).
    starts = np.flatnonzero(np.r_[True, sl_u[1:] != sl_u[:-1]])
    head = np.zeros(n, dtype=bool)
    ptr = starts.copy()
    while ptr.size:
        head[ptr] = True
        orig = sl_u[ptr]
        target = orig * NC + ch_u[ptr] + 8       # first chunk beyond window
        ptr = np.searchsorted(uniq, target)
        keep = ptr < n
        ptr, orig = ptr[keep], orig[keep]
        keep = sl_u[ptr] == orig                 # still inside own slice
        ptr = ptr[keep]
    hidx = np.where(head, np.arange(n), 0)
    np.maximum.accumulate(hidx, out=hidx)        # forward-fill head chunks
    win_u = ch_u[hidx]
    return win_u[np.searchsorted(uniq, key)]


def _sell_pack_multiwindow(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                           n_rows_padded: int, slice_rows: int,
                           config: EhybConfig, col_dtype, val_dtype,
                           sliding: bool = False,
                           col_range: Tuple[Optional[int], Optional[int]]
                           = (None, None)):
    """Multi-window chunk-synchronized SELL packing.

    The key generalization over the partition-window formats: each 8-step tile
    carries its *own* 1024-row x window (the Pallas kernel's x BlockSpec index
    is scalar-prefetched per tile, so this is free at run time).  Entries are
    grouped per (slice, 1024-window); groups with at least
    ``config.min_window_group_nnz`` entries are packed chunk-synchronized into
    whole tiles; smaller groups spill to the ER tail.  This is what shrinks
    the reference's ER fraction (out-of-window entries, ``convert.c:128-134``)
    to true stragglers: the body no longer requires columns near the diagonal
    block, only *clustered* columns.

    ``col`` is the full (global) column index.  Returns
    (col_arr local-in-window, val_arr, slice_offset, step_win, waste, body_mask).
    """
    C = slice_rows
    n_slices = max(1, cdiv(n_rows_padded, C))

    sl = row // C
    lane = row - sl * C

    # Entries with columns outside col_range cannot be represented by any
    # in-range window (the sharded converter passes device-local coordinates
    # bounded by the ±W halo; anything further off-device must go to the
    # globally-gathered ER tail).
    lo_c, hi_c = col_range
    valid = np.ones(row.shape[0], dtype=bool)
    if lo_c is not None:
        valid &= col >= lo_c
    if hi_c is not None:
        valid &= col < hi_c

    body_mask = np.zeros(row.shape[0], dtype=bool)

    def degenerate():
        slice_offset = (np.arange(n_slices + 1) * _TILE).astype(np.int32)
        total = n_slices * _TILE
        return (np.zeros((total, C), dtype=col_dtype),
                np.zeros((total, C), dtype=val_dtype),
                slice_offset, np.zeros(total, dtype=np.int32),
                total * C, body_mask)

    if not valid.any():
        return degenerate()

    # Window assignment (chunks may be negative in shard-local coordinates:
    # shift to 0-based for the greedy/bincount machinery, shift back after).
    ch_v = col[valid] // 128
    ch_min = min(int(ch_v.min(initial=0)), 0)
    wc_v = _assign_windows(sl[valid], ch_v - ch_min, sliding) + ch_min
    wc = np.zeros(row.shape[0], dtype=np.int64)
    wc[valid] = wc_v
    wc_min = min(int(wc_v.min(initial=0)), 0)
    NW = int(wc_v.max(initial=0)) - wc_min + 1
    gkey_v = sl[valid] * NW + (wc_v - wc_min)
    uniq, ginv, gcount = np.unique(gkey_v, return_inverse=True,
                                   return_counts=True)
    keep = gcount >= max(1, config.min_window_group_nnz)
    body_mask[valid] = keep[ginv]

    K = int(keep.sum())
    if K == 0:
        return degenerate()  # everything spills to ER

    kmap = np.full(uniq.shape[0], -1, dtype=np.int64)
    kmap[keep] = np.arange(K)
    kidx_valid = kmap[ginv]          # per-valid-entry compact group (-1 = ER)
    g_sl = (uniq[keep] // NW).astype(np.int64)
    g_wc = (uniq[keep] % NW).astype(np.int64) + wc_min  # window start chunk

    b = body_mask
    kidx = kidx_valid[keep[ginv]]    # per-body-entry compact group id
    lane_b = lane[b]
    chunk_b = col[b] // 128 - wc[b]              # local chunk ∈ [0, 8)
    val_b = val[b]
    lcol_b = (col[b] - wc[b] * 128).astype(np.int64)  # window-local column

    # Per-(group, lane, chunk) counts → per-(group, chunk) widths.  Counted
    # sparsely over sorted keys: a dense bincount would be K·C·8 cells — tens
    # of GB when min_window_group_nnz keeps millions of small groups.
    key2 = (kidx * C + lane_b) * 8 + chunk_b
    order = np.argsort(key2, kind="stable")
    key_s = key2[order]
    new_run = np.empty(key_s.shape[0], dtype=bool)
    new_run[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=new_run[1:])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, key_s.shape[0]))
    u = key_s[run_start]
    w_kc = np.zeros((K, 8), dtype=np.int64)
    np.maximum.at(w_kc, (u // (C * 8), u % 8), run_len)
    gw = w_kc.sum(axis=1)
    gwp = cdiv_arr(gw, _TILE) * _TILE            # whole tiles per group

    # Per-slice widths, aligned to the kernel tile size (empty slices get one
    # dummy tile; tail padding steps carry window 0 / col 0 / val 0).
    walign = max(_TILE, config.width_align)
    widths = np.zeros(n_slices, dtype=np.int64)
    np.add.at(widths, g_sl, gwp)
    widths = np.maximum(cdiv_arr(widths, walign) * walign, walign)
    slice_offset = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(widths, out=slice_offset[1:])
    total_steps = int(slice_offset[-1])

    # Group start steps: groups are sorted by (slice, window); exclusive
    # within-slice cumsum of padded widths + the slice base.
    gcum = np.cumsum(gwp) - gwp
    first_of_slice = np.zeros(K, dtype=bool)
    first_of_slice[0] = True
    first_of_slice[1:] = g_sl[1:] != g_sl[:-1]
    base = gcum[first_of_slice][np.cumsum(first_of_slice) - 1]
    grp_step = slice_offset[g_sl] + (gcum - base)

    # chunk offsets within each group
    choff = np.zeros((K, 9), dtype=np.int64)
    np.cumsum(w_kc, axis=1, out=choff[:, 1:])

    # Paint per-step window starts and chunk bases.
    step_win = np.zeros(total_steps, dtype=np.int64)
    spans = np.repeat(np.arange(K), gwp)
    pos = np.arange(spans.shape[0]) - np.repeat(np.cumsum(gwp) - gwp, gwp)
    step_idx = grp_step[spans] + pos
    step_win[step_idx] = g_wc[spans] * 128

    step_chunk = np.zeros(total_steps, dtype=np.int64)
    for c in range(8):
        wcc = w_kc[:, c]
        sel = np.repeat(np.arange(K), wcc)           # group of each painted step
        intra = (np.arange(sel.shape[0], dtype=np.int64)
                 - np.repeat(np.cumsum(wcc) - wcc, wcc))  # 0..w-1 within region
        step_chunk[grp_step[sel] + choff[sel, c] + intra] = c

    col_arr = np.broadcast_to((step_chunk * 128)[:, None],
                              (total_steps, C)).astype(col_dtype).copy()
    val_arr = np.zeros((total_steps, C), dtype=val_dtype)

    # Scatter entries: rank within (group, lane, chunk) = position inside the
    # sorted key run (order/run_start computed with the widths above).
    rank = (np.arange(key_s.shape[0], dtype=np.int64)
            - np.repeat(run_start, run_len))
    kidx_s = kidx[order]
    lane_s = lane_b[order]
    chunk_s = chunk_b[order]
    step = grp_step[kidx_s] + choff[kidx_s, chunk_s] + rank
    flat = step * C + lane_s
    col_arr.reshape(-1)[flat] = lcol_b[order].astype(col_dtype)
    val_arr.reshape(-1)[flat] = val_b[order].astype(val_dtype)

    waste = int(total_steps * C - int(b.sum()))
    return (col_arr, val_arr, slice_offset.astype(np.int32),
            step_win.astype(np.int32), waste, body_mask)


def _pack_steps_relaxed(pairid: np.ndarray, lane: np.ndarray,
                        slot: np.ndarray, hcls: np.ndarray,
                        order_hint: np.ndarray = None,
                        ncls: int = 16) -> np.ndarray:
    """Greedy round-based step assignment under the RELAXED lo-slot constraint.

    Per (pair, step): at most one entry per lane, and every used lo-slot maps
    to a single chunk class (sel·8+hi).  This is the exact feasibility
    condition of the two-stage ``tpu.dynamic_gather`` (verified on hardware,
    scripts/probe_wide_gather.py): ``g[s,l] = win[hi[s, lo[s,l]], lo[s,l]]``
    only requires the *hi stored at lane position j* to be consistent for all
    entries whose lo == j — NOT a single chunk per step, which is what the
    chunk-sync packers over-enforce (and what costs 80-95%% padding on
    scattered matrices).

    Each round assigns one step to every pair simultaneously: the first
    unassigned entry per (pair, lane) is a candidate; per (pair, slot) the
    chunk class with the MOST candidates wins (live majority — a
    first-leader rule left ~1.45x headroom on random_16k), and losing lanes get retry passes with their next entries that
    match an already-elected winner.  Rounds = max step count over pairs;
    each round is vectorized NumPy.  Returns the per-entry step index
    within its pair.
    """
    n = pairid.shape[0]
    step = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return step
    C = 128
    cshift = ncls.bit_length() - 1           # ncls is a power of two
    # ONE global sort: entries grouped into (pair, lane) runs, hint order
    # within each run.  Rounds then walk per-run head pointers — O(active
    # lanes) per round instead of re-sorting the whole remainder (the round-2
    # formulation cost O(rounds x rem log rem): 10+ minutes of the
    # permuted_poisson_4096 conversion).
    k1_e = pairid * C + lane
    o = np.lexsort((order_hint, k1_e)) if order_hint is not None \
        else np.argsort(k1_e, kind="stable")
    k1s = k1_e[o]
    first = np.empty(n, dtype=bool)
    first[0] = True
    np.not_equal(k1s[1:], k1s[:-1], out=first[1:])
    run_start = np.flatnonzero(first)
    run_end = np.append(run_start[1:], n)
    head = run_start.copy()                  # next unassigned, per run
    active = np.flatnonzero(head < run_end)  # run ids with entries left
    r = 0
    while active.size:
        cand_pos = head[active]              # positions in o
        cand = o[cand_pos]                   # entry ids
        # elect, per (pair, slot), the chunk class with most candidates
        k3 = ((pairid[cand] * C + slot[cand]) << cshift) + hcls[cand]
        o2 = np.argsort(k3, kind="stable")
        k3o = k3[o2]
        rlead = np.empty(o2.size, dtype=bool)
        rlead[0] = True
        np.not_equal(k3o[1:], k3o[:-1], out=rlead[1:])
        rstart = np.flatnonzero(rlead)
        rlen = np.diff(np.append(rstart, k3o.size))
        rk2 = k3o[rstart] >> cshift          # (pair, slot) of each class run
        rhc = k3o[rstart] & (ncls - 1)
        o3 = np.lexsort((rhc, -rlen, rk2))   # per slot: biggest class first
        firstg = np.empty(o3.size, dtype=bool)
        firstg[0] = True
        rk2s = rk2[o3]
        np.not_equal(rk2s[1:], rk2s[:-1], out=firstg[1:])
        win_runs = o3[firstg]
        winner = np.zeros(rlen.size, dtype=bool)
        winner[win_runs] = True
        rid3 = np.cumsum(rlead) - 1
        taken = np.zeros(active.size, dtype=bool)
        taken[o2[winner[rid3]]] = True
        step[cand[taken]] = r
        # retry depth 1: a losing lane's NEXT entry joins the step when it
        # matches an elected (pair, slot) -> class winner (summation order
        # within a lane is free); the chosen entry is swapped to the head
        # position so the pointer discipline survives.
        win_k2 = rk2[win_runs]               # ascending
        win_hc = rhc[win_runs]
        lose = np.flatnonzero(~taken)
        lr = active[lose]
        has_next = head[lr] + 1 < run_end[lr]
        lr = lr[has_next]
        lose = lose[has_next]
        if lr.size and win_k2.size:
            e2 = o[head[lr] + 1]
            ks2 = pairid[e2] * C + slot[e2]
            pos2 = np.searchsorted(win_k2, ks2)
            pos2c = np.minimum(pos2, win_k2.size - 1)
            match = (win_k2[pos2c] == ks2) & (hcls[e2] == win_hc[pos2c])
            sel_runs = lr[match]
            if sel_runs.size:
                hh = head[sel_runs]
                tmp = o[hh].copy()
                o[hh] = o[hh + 1]
                o[hh + 1] = tmp
                step[o[hh]] = r
                taken[lose[match]] = True
        head[active[taken]] += 1
        active = active[head[active] < run_end[active]]
        r += 1
        if r > 1 << 20:      # can't happen: every round drains >=1 per pair
            raise RuntimeError("relaxed packer failed to converge")
    return step


def _sell_pack_relaxed(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                       n_rows_padded: int, slice_rows: int,
                       config: EhybConfig, col_dtype, val_dtype,
                       col_range: Tuple[Optional[int], Optional[int]]
                       = (None, None)):
    """Relaxed lo-slot SELL packing with dual-window sub-tiles (``sell_rx``).

    Layout contract (consumed by ``_sell_body_kernel_stream_rx`` and the XLA
    emulation in ``ops/xla_ops.ehyb_body_xla``):

      * ``ell_col[s, l]`` packs ``(sel << 10) | (hi << 7) | lo`` where
        ``(sel, hi)`` describe LO-SLOT ``l`` of step ``s`` (which window chunk
        lane position ``l`` is gathered from) and ``lo`` is the low 7 column
        bits of the ENTRY stored at lane ``l`` (if any; padding lanes carry
        ``lo = 0`` with ``val = 0``);
      * each 8-step sub-tile carries TWO 1024-aligned x windows
        (``step_win`` / ``step_win_b`` row starts, constant per sub-tile);
        ``sel`` picks between them;
      * entries pinned to lane ``row %% 128``; per step each used slot has one
        (sel, hi) — the feasibility condition of the two-stage dynamic_gather.

    Grouping per (slice, 1024-window) mirrors :func:`_sell_pack_multiwindow`
    (min_window_group_nnz spill to ER); kept groups of a slice are then
    PAIRED (two-pointer over descending size) so a sub-tile serves two
    windows — a sparse window rides along with a dense one instead of
    burning its own 8-step quantum.

    ROW SPLITTING: a hub row's entries within one window all compete for a
    single lane, serializing its pair's steps at a few-percent fill (the
    lane bound; powerlaw-style matrices).  Per-(row, window) groups larger
    than ``config.row_split_threshold`` move their surplus to synthetic
    overflow rows in extra slices appended after the real ones; the caller
    scatter-adds the overflow results back (``split_src``/``split_dst`` —
    the same compacted-row mechanism as the ER scatter-back,
    ``kernel.cu:69-77``, applied inside the body).

    Returns (col_arr, val_arr, slice_offset, step_win, step_win_b,
    step_win_c, step_win_d, waste, body_mask, split_src, split_dst);
    ``step_win_c/d`` are empty for windows_per_subtile=2 and the third/fourth
    per-step window starts for 4 (``sel`` then has two bits).
    """
    C = slice_rows
    split_T = int(getattr(config, "row_split_threshold", 0) or 0)
    if getattr(config, "compensated_sum", False):
        # splitting re-sums a row's pieces through plain f32 adds in the
        # combine scatter — catastrophic for the cancellation-heavy inputs
        # compensated_sum exists for; keep the whole row in one Kahan chain
        split_T = 0
    n_real_padded = n_rows_padded
    split_src = np.zeros(0, dtype=np.int32)
    split_dst = np.zeros(0, dtype=np.int32)
    if split_T > 0 and row.size:
        # fused (row, window) key; exact multiplier (a fixed 1<<25 would
        # alias rows beyond 33M)
        woff = 1 - min(int(col.min(initial=0)) // 1024, 0)  # windows >= 1
        wspan = int(col.max(initial=0)) // 1024 + woff + 2
        wkey = row.astype(np.int64) * wspan + (col // 1024) + woff
        order_w = np.argsort(wkey, kind="stable")
        ws = wkey[order_w]
        run_start = np.flatnonzero(np.r_[True, ws[1:] != ws[:-1]])
        run_len = np.diff(np.append(run_start, ws.shape[0]))
        rank = np.arange(ws.shape[0], dtype=np.int64) \
            - np.repeat(run_start, run_len)
        over = rank // split_T          # 0 = stays; k>0 = overflow piece k
        n_pieces = np.maximum(run_len - 1, 0) // split_T  # extra rows per run
        if int(n_pieces.sum()) > 0:
            piece_base = np.cumsum(n_pieces) - n_pieces  # exclusive
            syn_of_entry = np.full(ws.shape[0], -1, dtype=np.int64)
            ov = over > 0
            syn_of_entry[ov] = n_rows_padded \
                + np.repeat(piece_base, run_len)[ov] + over[ov] - 1
            new_row = row.copy()
            new_row[order_w[ov]] = syn_of_entry[ov]
            n_syn = int(n_pieces.sum())
            split_dst = np.repeat(row[order_w[run_start]].astype(np.int32),
                                  n_pieces)
            split_src = (np.arange(n_syn, dtype=np.int32) + n_rows_padded)
            row = new_row
            n_rows_padded = round_up(n_rows_padded + n_syn, C)
    n_slices = max(1, cdiv(n_rows_padded, C))
    sl = row // C
    lane = row - sl * C

    lo_c, hi_c = col_range
    valid = np.ones(row.shape[0], dtype=bool)
    if lo_c is not None:
        valid &= col >= lo_c
    if hi_c is not None:
        valid &= col < hi_c
    body_mask = np.zeros(row.shape[0], dtype=bool)

    def degenerate():
        slice_offset = (np.arange(n_slices + 1) * _TILE).astype(np.int32)
        total = n_slices * _TILE
        wps_d = int(getattr(config, "windows_per_subtile", 2) or 2)
        empty_w = np.zeros(0, dtype=np.int32)
        zw = np.zeros(total, dtype=np.int32)
        return (np.zeros((total, C), dtype=col_dtype),
                np.zeros((total, C), dtype=val_dtype),
                slice_offset, zw, zw.copy(),
                zw.copy() if wps_d >= 4 else empty_w,
                zw.copy() if wps_d >= 4 else empty_w,
                total * C, body_mask,
                split_src[:0], split_dst[:0])

    if not valid.any():
        return degenerate()

    # --- window groups (1024-aligned; sliding adds nothing once windows pair)
    ch_v = col[valid] // 128
    ch_min = min(int(ch_v.min(initial=0)), 0)
    wc_v = ((ch_v - ch_min) // 8) * 8 + ch_min          # window start chunk
    wc_min = min(int(wc_v.min(initial=0)), 0)
    NW = int(wc_v.max(initial=0)) - wc_min + 1
    gkey_v = sl[valid] * NW + (wc_v - wc_min)
    uniq, ginv, gcount = np.unique(gkey_v, return_inverse=True,
                                   return_counts=True)
    keep = gcount >= max(1, config.min_window_group_nnz)
    body_mask[valid] = keep[ginv]
    K = int(keep.sum())
    if K == 0:
        return degenerate()

    g_sl = (uniq[keep] // NW).astype(np.int64)
    g_wc = (uniq[keep] % NW).astype(np.int64) + wc_min
    g_cnt = gcount[keep].astype(np.int64)

    # --- group (slice, window) groups into W-window sub-tile sets -----------
    # Wps windows share each 8-step sub-tile (``sel`` has log2(Wps) bits):
    # bigger sets amortize the per-set ceil-to-8 padding AND tighten the
    # lane-occupancy bound (instrumented on random_16k: at Wps=2 the padding
    # amplified 10.8k packed steps to 16.1k).  Groups are dealt into sets by
    # descending size, snake order, so set totals stay balanced.
    Wps = int(getattr(config, "windows_per_subtile", 2) or 2)
    if Wps not in (2, 4):
        raise ValueError(f"windows_per_subtile must be 2 or 4, got {Wps}")
    pair_of_group = np.empty(K, dtype=np.int64)
    order_g = np.lexsort((-g_cnt, g_sl))      # by slice, then count desc
    slice_start = np.zeros(K, dtype=bool)
    slice_start[0] = True
    gs = g_sl[order_g]
    slice_start[1:] = gs[1:] != gs[:-1]
    starts = np.flatnonzero(slice_start)
    ends = np.append(starts[1:], K)
    # rank within slice (0-based) over the desc-count order
    rank_in_slice = np.arange(K) - np.repeat(starts, ends - starts)
    size_in_slice = np.repeat(ends - starts, ends - starts)
    # sets per slice and snake-dealt local set id: rank r goes to bin
    # d if d < B else 2B-1-d where d = r mod 2B (largest first, reverse on
    # each pass — the Wps=2 case reproduces two-pointer pairing exactly)
    pps_all = -(-(size_in_slice) // Wps)
    B2 = 2 * pps_all
    d = rank_in_slice % B2
    pair_local = np.minimum(d, B2 - 1 - d)
    pps = pps_all[starts]                           # sets per slice
    pair_base_slice = np.cumsum(pps) - pps          # exclusive cumsum
    pair_of_group[order_g] = np.repeat(pair_base_slice, ends - starts) \
        + pair_local
    n_pairs = int(pps.sum())
    pg = pair_of_group[order_g]
    # slot of each group within its set = arrival order (desc-count stable)
    og = np.argsort(pg, kind="stable")
    run_first = np.zeros(K, dtype=bool)
    run_first[0] = True
    pgo = pg[og]
    run_first[1:] = pgo[1:] != pgo[:-1]
    group_slot_sorted = np.arange(K) - np.repeat(
        np.flatnonzero(run_first),
        np.diff(np.append(np.flatnonzero(run_first), K)))
    group_slot = np.empty(K, dtype=np.int64)
    group_slot[og] = group_slot_sorted
    assert group_slot.max(initial=0) < Wps
    # the set's window list (missing slots duplicate the first window)
    pair_wins = np.zeros((n_pairs, Wps), dtype=np.int64)
    g_slot = np.empty(K, dtype=np.int64)
    g_slot[order_g] = group_slot
    pair_wins[pg, group_slot] = g_wc[order_g]
    first_win = pair_wins[:, 0]
    for w in range(1, Wps):
        unset = np.zeros(n_pairs, dtype=bool)
        unset[:] = True
        unset[pg[group_slot == w]] = False
        pair_wins[unset, w] = first_win[unset]
    pair_sl = np.zeros(n_pairs, dtype=np.int64)
    pair_sl[pg] = g_sl[order_g]

    # --- per-entry attributes -----------------------------------------------
    b = body_mask
    kmap = np.full(uniq.shape[0], -1, dtype=np.int64)
    kmap[keep] = np.arange(K)
    kidx = kmap[ginv][keep[ginv]]            # per-body-entry group id
    pair_e = pair_of_group[kidx]
    lane_e = lane[b]
    col_e = col[b].astype(np.int64)
    lo_e = col_e % 128
    ch_e = col_e // 128
    sel_e = g_slot[kidx]                     # the entry's group's set slot
    hi_e = ch_e - g_wc[kidx]                 # chunk within its own window
    assert hi_e.min(initial=0) >= 0 and hi_e.max(initial=0) < 8
    hcls_e = sel_e * 8 + hi_e

    # order hint: big (pair, slot, hcls) classes first — lanes whose head
    # candidates share a column class pack into the same round (election) /
    # ride the same slot-class early (native greedy)
    ncls = 8 * Wps
    ckey = (pair_e * 128 + lo_e) * ncls + hcls_e
    cu, cinv, ccnt = np.unique(ckey, return_inverse=True, return_counts=True)
    hint = np.lexsort((ckey, -ccnt[cinv], pair_e))

    # Native greedy packer by default (routecolor.cpp::ehyb_pack_relaxed):
    # same feasibility condition, sequential lowest-free-color instead of
    # the round election — measured both FASTER (the election cost 245 s of
    # permuted_poisson_4096's 655 s convert) and TIGHTER (the greedy
    # backfills steps the election's one-per-round discipline leaves open).
    # EHYB_NATIVE_PACK=0 or a missing toolchain falls back to the election.
    step_in_pair = None
    if os.environ.get("EHYB_NATIVE_PACK", "1") != "0":
        try:
            from ..native import pack_relaxed_native

            step_in_pair = pack_relaxed_native(pair_e, lane_e, lo_e, hcls_e,
                                               hint)
        except Exception as exc:              # pragma: no cover - no g++
            log.warning("native relaxed packer unavailable (%s); falling "
                        "back to the round election", exc)
    if step_in_pair is None:
        hint_rank = np.empty(hint.shape[0], dtype=np.int64)
        hint_rank[hint] = np.arange(hint.shape[0])
        step_in_pair = _pack_steps_relaxed(pair_e, lane_e, lo_e, hcls_e,
                                           order_hint=hint_rank, ncls=ncls)

    # --- steps per pair, padded to whole sub-tiles --------------------------
    S = np.zeros(n_pairs, dtype=np.int64)
    np.maximum.at(S, pair_e, step_in_pair + 1)
    S = np.maximum(cdiv_arr(S, _TILE) * _TILE, _TILE)

    widths = np.zeros(n_slices, dtype=np.int64)
    np.add.at(widths, pair_sl, S)
    widths = np.maximum(widths, _TILE)       # empty slices get a dummy subtile
    slice_offset = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(widths, out=slice_offset[1:])
    total_steps = int(slice_offset[-1])

    # pair step base: pairs laid out by (slice, pair id) — pair ids are
    # already slice-contiguous ascending by construction
    pair_order = np.argsort(pair_sl, kind="stable")
    Ssorted = S[pair_order]
    cum = np.cumsum(Ssorted) - Ssorted
    first = np.empty(n_pairs, dtype=bool)
    psl = pair_sl[pair_order]
    first[0] = True
    first[1:] = psl[1:] != psl[:-1]
    base = cum[first][np.cumsum(first) - 1]
    pair_step_base = np.empty(n_pairs, dtype=np.int64)
    pair_step_base[pair_order] = slice_offset[psl] + (cum - base)

    # --- paint per-step window starts (incl. pair padding steps) ------------
    step_wins = np.zeros((Wps, total_steps), dtype=np.int64)
    spans = np.repeat(np.arange(n_pairs), S)
    pos = np.arange(spans.shape[0], dtype=np.int64) \
        - np.repeat(np.cumsum(S) - S, S)
    sidx = pair_step_base[spans] + pos
    for w in range(Wps):
        step_wins[w, sidx] = pair_wins[spans, w] * 128

    # --- scatter ------------------------------------------------------------
    step_abs = pair_step_base[pair_e] + step_in_pair
    col_arr = np.zeros((total_steps, C), dtype=col_dtype)
    val_arr = np.zeros((total_steps, C), dtype=val_dtype)
    attr = ((sel_e << 10) + (hi_e << 7)).astype(np.int64)
    flat_slot = step_abs * C + lo_e
    flat_lane = step_abs * C + lane_e
    ca = col_arr.reshape(-1)
    # 1) slot attributes at (step, lo); duplicates write identical values
    ca[flat_slot] = attr.astype(col_dtype)
    # 2) entry lo bits at (step, lane)
    np.bitwise_or.at(ca, flat_lane, lo_e.astype(col_dtype))
    val_arr.reshape(-1)[flat_lane] = val[b].astype(val_dtype)

    waste = int(total_steps * C - int(b.sum()))
    empty_w = np.zeros(0, dtype=np.int32)
    return (col_arr, val_arr, slice_offset.astype(np.int32),
            step_wins[0].astype(np.int32), step_wins[1].astype(np.int32),
            step_wins[2].astype(np.int32) if Wps >= 4 else empty_w,
            step_wins[3].astype(np.int32) if Wps >= 4 else empty_w,
            waste, body_mask, split_src, split_dst)


def coo_to_ehyb(m_reordered: MatrixCOO, reordering: Reordering, plan: Plan,
                config: EhybConfig) -> EhybMatrix:
    """Convert a *reordered* COO matrix into :class:`EhybMatrix`.

    ``m_reordered`` must already carry the two-level permutation
    (``Reordering.apply_to_matrix``); this mirrors the reference, where
    ``COO2EHYB`` runs after ``matrixReorder`` (``solver_test.c:370`` →
    ``spmv.cu:73``).
    """
    return convert_core(
        row=m_reordered.row, col=m_reordered.col, val=m_reordered.val,
        dim=m_reordered.dimension, boundaries=reordering.boundaries,
        window_rows=plan.window_rows, n_parts=plan.n_parts, config=config,
        nnz_label=m_reordered.nnz)


def extract_diagonals(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                      dim: int, threshold: float, max_k: int, val_dtype,
                      off_lo: Optional[int] = None, off_hi: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Find diagonals d = col - row carrying at least ``threshold * dim``
    entries and densify them.

    Returns (offsets (K,) int64 ascending, dia_val (K, round_up(dim, LANES)),
    keep_mask over entries — True = extracted to DIA).  ``off_lo``/``off_hi``
    bound eligible offsets (the sharded converter restricts them to the ±halo
    range so the shifted x slice stays inside the extended shard vector).

    TPU-native extension (no reference analog — see core/ehyb.py docstring).
    """
    lo = -(dim - 1) if off_lo is None else max(off_lo, -(dim - 1))
    hi = (dim - 1) if off_hi is None else min(off_hi, dim - 1)
    empty = (np.zeros(0, dtype=np.int64),
             np.zeros((0, round_up(max(dim, 1), LANES)), dtype=val_dtype),
             np.zeros(row.shape[0], dtype=bool))
    if row.shape[0] == 0 or threshold <= 0 or max_k <= 0 or lo > hi:
        return empty

    use_native = os.environ.get("EHYB_NATIVE_DIA", "1") != "0"
    native_mod = None
    if use_native:
        from .. import native as native_mod_  # deferred: compiles on first use
        native_mod = native_mod_

    # --- pass 1: per-offset counts over the band ---------------------------
    d = None
    if native_mod is not None:
        try:
            counts = native_mod.dia_count_native(row, col, lo, hi)
        except (native_mod.NativeCompileError, OSError):
            native_mod = None
    if native_mod is None:
        d = col.astype(np.int64) - row.astype(np.int64)
        if lo == -(dim - 1) and hi == dim - 1:
            de = d  # full band: every entry eligible, skip the mask pass
            eligible = None
        else:
            eligible = (d >= lo) & (d <= hi)
            if not eligible.any():
                return empty
            de = d[eligible]
        counts = np.bincount(de - lo, minlength=hi - lo + 1)

    min_count = max(1, int(np.ceil(threshold * dim)))
    cand = np.flatnonzero(counts >= min_count)
    if cand.size == 0:
        return empty
    if cand.size > max_k:
        cand = cand[np.argsort(-counts[cand], kind="stable")[:max_k]]
        cand.sort()
    offsets = cand.astype(np.int64) + lo
    K = offsets.shape[0]
    dim_r = round_up(max(dim, 1), LANES)

    off_rank = np.full(hi - lo + 1, -1, dtype=np.int32)
    off_rank[offsets - lo] = np.arange(K, dtype=np.int32)

    # --- pass 2: scatter-add into the dense (K, dim_r) block ---------------
    # Accumulate (not assign): tolerates duplicate COO entries, matching
    # dense semantics.
    if native_mod is not None:
        dia, keep = native_mod.dia_fill_native(row, col, val, lo, hi,
                                               off_rank, dim_r, K)
        return offsets, dia.astype(val_dtype), keep

    if eligible is None:
        keep = off_rank[d - lo] >= 0
    else:
        keep = np.zeros(row.shape[0], dtype=bool)
        keep[eligible] = off_rank[de - lo] >= 0
    k_of = off_rank[d[keep] - lo].astype(np.int64)
    # bincount instead of np.add.at — the ufunc scatter costs tens of
    # seconds on a 74M-nnz audikw-class extraction.
    flat = k_of * dim_r + row[keep]
    acc = np.bincount(flat, weights=val[keep], minlength=K * dim_r)
    dia_val = acc.reshape(K, dim_r).astype(val_dtype)
    return offsets, dia_val, keep


def convert_core(row: np.ndarray, col: np.ndarray, val: np.ndarray, dim: int,
                 boundaries: np.ndarray, window_rows: int, n_parts: int,
                 config: EhybConfig, nnz_label: int = -1,
                 dia_off_range: Optional[Tuple[int, int]] = None,
                 body_col_range: Tuple[Optional[int], Optional[int]]
                 = (None, None)) -> EhybMatrix:
    """Core conversion on raw triples.

    Row indices must lie in [0, dim); ``boundaries`` partitions the row space.
    Column indices may lie outside [0, dim) (the multi-chip shard converter
    passes device-local column coordinates, where off-device columns are
    negative or beyond the local range — they classify as out-of-window, or,
    for the multi-window layout, are forced to the ER tail by
    ``body_col_range`` since no in-range x window can cover them).
    """
    W = window_rows
    C = config.slice_rows
    vdt = config.np_dtype()
    cdt = config.np_index_dtype()
    if nnz_label < 0:
        nnz_label = row.shape[0]
    nnz_total = row.shape[0]

    # --- 0. DIA extraction (before everything else) -------------------------
    if config.features.dia:
        rng = dia_off_range or (None, None)
        dia_offsets, dia_val, dia_keep = extract_diagonals(
            row, col, val, dim, config.dia_threshold, config.max_diagonals,
            vdt, off_lo=rng[0], off_hi=rng[1])
    else:
        dia_offsets = np.zeros(0, dtype=np.int64)
        dia_val = np.zeros((0, round_up(max(dim, 1), LANES)), dtype=vdt)
        dia_keep = np.zeros(row.shape[0], dtype=bool)
    nnz_dia = int(dia_keep.sum())
    if nnz_dia:
        rest = ~dia_keep
        row, col, val = row[rest], col[rest], val[rest]

    # --- 1+2. classification + SELL body ------------------------------------
    # (With features.cache off, models pass a single-partition plan whose window
    # spans the matrix, so everything lands in-window with win_start = 0 and the
    # format degenerates to plain HYB — no special case needed here.  The
    # multi-window layout classifies inside the packer instead, so the
    # partition-window pass only runs for the windowed layouts.)
    n_rows_padded = round_up(max(dim, 1), C)
    step_win_mw = None
    step_win_b = np.zeros(0, dtype=np.int32)
    step_win_c = np.zeros(0, dtype=np.int32)
    step_win_d = np.zeros(0, dtype=np.int32)
    split_src = np.zeros(0, dtype=np.int32)
    split_dst = np.zeros(0, dtype=np.int32)
    if config.body_layout not in ("sell_mw", "sell_rx"):
        part_of_row = np.searchsorted(boundaries, row, side="right") - 1
        win_start = boundaries[part_of_row]
        in_win = (col >= win_start) & (col < win_start + W)

        er_mask = ~in_win
        er_counts = np.bincount(row[er_mask], minlength=dim)
        long_row_mask_per_row = er_counts > config.long_row_threshold  # [dim]
        is_long_entry = er_mask & long_row_mask_per_row[row]
        er_only = er_mask & ~long_row_mask_per_row[row]

    if config.body_layout in ("sell_mw", "sell_rx"):
        # Dense rows STAY in the body: the density sort clusters them into
        # shared slices whose groups pack densely, and the long-row stream's
        # XLA global gather costs ~14 cyc/element (measured powerlaw_16k
        # regression: 5.1 -> 0.95 GFLOP/s when rows >512 nnz were
        # pre-extracted).  The reference extracts long rows before ELL
        # (convert.c:92-101) because ITS width cost is per-32-row-block; here
        # only rows whose entries FAIL body grouping in large numbers (ER
        # census below) go long — that protects the ER slices, which is the
        # only place a dense row still hurts.
        long_pre_per_row = np.zeros(dim, dtype=bool)
        long_pre = np.zeros(row.shape[0], dtype=bool)
        body_in = ~long_pre
        # Multi-window: the packer itself decides body vs ER per
        # (slice, window) group; re-derive the masks from its decision.
        if config.body_layout == "sell_rx":
            (ell_col, ell_val, slice_offset, step_win_mw, step_win_b,
             step_win_c, step_win_d, waste_ell, body_mask_in, split_src,
             split_dst) = \
                _sell_pack_relaxed(
                    row[body_in], col[body_in], val[body_in], n_rows_padded,
                    C, config, cdt, vdt, col_range=body_col_range)
        else:
            (ell_col, ell_val, slice_offset, step_win_mw, waste_ell,
             body_mask_in) = _sell_pack_multiwindow(
                row[body_in], col[body_in], val[body_in], n_rows_padded, C,
                config, cdt, vdt, sliding=bool(config.sliding_windows),
                col_range=body_col_range)
        body_mask = np.zeros(row.shape[0], dtype=bool)
        body_mask[body_in] = body_mask_in
        er_mask = ~body_mask & ~long_pre
        er_counts = np.bincount(row[er_mask], minlength=dim)
        long_row_mask_per_row = (er_counts > config.long_row_threshold) \
            | long_pre_per_row
        is_long_entry = (er_mask & long_row_mask_per_row[row]) | long_pre
        er_only = er_mask & ~long_row_mask_per_row[row]
        in_win = body_mask
    elif config.body_layout == "sell_cs":
        ell_local_col = (col[in_win] - win_start[in_win]).astype(np.int64)
        ell_col, ell_val, slice_offset, waste_ell = _sell_pack_chunk_sync(
            row[in_win], ell_local_col, val[in_win],
            n_rows_padded, C, config.width_align, W, cdt, vdt)
    elif config.body_layout == "sell":
        ell_local_col = (col[in_win] - win_start[in_win]).astype(np.int64)
        ell_col, ell_val, slice_offset, waste_ell = _sell_pack(
            row[in_win], ell_local_col, val[in_win],
            n_rows_padded, C, config.width_align, cdt, vdt)
    else:
        raise ValueError(f"unknown body_layout {config.body_layout!r}")
    n_slices = slice_offset.shape[0] - 1

    # Window start per slice: interior partition boundaries are aligned to
    # plan.part_align (== C), so each slice lies in exactly one partition.
    slice_start_rows = np.arange(n_slices, dtype=np.int64) * C
    slice_part = np.searchsorted(boundaries, np.minimum(slice_start_rows, dim - 1),
                                 side="right") - 1
    slice_win_start = boundaries[slice_part].astype(np.int32)
    if step_win_mw is not None:
        step_win = step_win_mw
    else:
        widths = np.diff(slice_offset.astype(np.int64))
        step_win = np.repeat(slice_win_start.astype(np.int32), widths)

    # --- 3. ER tail --------------------------------------------------------
    er_row = row[er_only]
    er_counts_only = np.bincount(er_row, minlength=dim)
    er_row_ids = np.flatnonzero(er_counts_only)          # rows with ER entries
    # Global density sort, descending (convert.c:148-168); stable for ties.
    er_sort = np.argsort(-er_counts_only[er_row_ids], kind="stable")
    er_row_ids = er_row_ids[er_sort]
    n_er_rows = er_row_ids.shape[0]
    n_er_rows_padded = round_up(max(n_er_rows, 0), config.er_slice_rows) \
        if n_er_rows else 0

    if n_er_rows:
        packed_of_row = np.full(dim, -1, dtype=np.int64)
        packed_of_row[er_row_ids] = np.arange(n_er_rows)
        # ER runs through the XLA global gather, which prices every padded
        # cell at the measured ~14 cyc/element — pack with width_align=1
        # (no kernel tiling constraint applies to the ER arrays; measured
        # 33 us/iter burned on gathering padding at width_align=32).
        er_col, er_val, er_slice_offset, waste_er = _sell_pack(
            packed_of_row[er_row], col[er_only].astype(np.int64), val[er_only],
            n_er_rows_padded, config.er_slice_rows, 1, np.int32, vdt)
        er_rows = np.full(n_er_rows_padded, dim, dtype=np.int32)  # dump row pad
        er_rows[:n_er_rows] = er_row_ids.astype(np.int32)
    else:
        er_col = np.zeros((0, config.er_slice_rows), dtype=np.int32)
        er_val = np.zeros((0, config.er_slice_rows), dtype=vdt)
        er_slice_offset = np.zeros(1, dtype=np.int32)
        er_rows = np.zeros(0, dtype=np.int32)
        waste_er = 0

    # --- 4. long-row stream ------------------------------------------------
    long_rows = np.flatnonzero(long_row_mask_per_row).astype(np.int32)
    if long_rows.size:
        seg_of_row = np.full(dim, -1, dtype=np.int64)
        seg_of_row[long_rows] = np.arange(long_rows.size)
        lorder = np.argsort(row[is_long_entry], kind="stable")
        long_col = col[is_long_entry][lorder].astype(np.int32)
        long_val = val[is_long_entry][lorder].astype(vdt)
        long_seg = seg_of_row[row[is_long_entry][lorder]].astype(np.int32)
    else:
        long_col = np.zeros(0, dtype=np.int32)
        long_val = np.zeros(0, dtype=vdt)
        long_seg = np.zeros(0, dtype=np.int32)

    nnz_ell = int(in_win.sum())
    nnz_er = int(er_only.sum())
    nnz_long = int(is_long_entry.sum())

    if nnz_ell == 0 and n_slices > 0:
        # Empty SELL body (everything went to DIA/ER/long): drop the dummy
        # tiles — the applies skip the body, so the padded arrays would only
        # waste device memory.  n_slices is kept (it sizes padded y).
        ell_col = np.zeros((0, C), dtype=cdt)
        ell_val = np.zeros((0, C), dtype=vdt)
        slice_offset = np.zeros(n_slices + 1, dtype=np.int32)
        step_win = np.zeros(0, dtype=np.int32)
        step_win_b = step_win_b[:0]
        step_win_c = step_win_c[:0]
        step_win_d = step_win_d[:0]
        waste_ell = 0
    assert nnz_dia + nnz_ell + nnz_er + nnz_long == nnz_total, \
        "nnz conservation violated (cf. convert.c:140)"

    stats = {
        "nnz_total": nnz_total,
        "nnz_dia": nnz_dia,
        "nnz_ell": nnz_ell,
        "nnz_er": nnz_er,                # the reference's `toER` (convert.c:140)
        "nnz_long": nnz_long,
        "waste_ell": waste_ell,          # the reference's wasteElement (convert.c:310)
        "waste_er": waste_er,
        "waste_dia": int(dia_val.size - nnz_dia),
        "n_diagonals": int(dia_offsets.shape[0]),
        "n_slices": int(n_slices),
        "n_er_rows": int(n_er_rows),
        "n_long_rows": int(long_rows.size),
        "ell_steps": int(ell_col.shape[0]),
        "er_steps": int(er_col.shape[0]),
        "window_rows": W,
        "n_parts": n_parts,
        "layout": config.body_layout,
    }
    log.info("COO2EHYB: nnz=%d → DIA %d (%.1f%%, %d diags) | ELL %d (%.1f%%, "
             "waste %.1f%%) | ER %d | long %d (rows: %d slices, %d ER rows, "
             "%d long)",
             nnz_total, nnz_dia, 100.0 * nnz_dia / max(1, nnz_total),
             dia_offsets.shape[0],
             nnz_ell, 100.0 * nnz_ell / max(1, nnz_total),
             100.0 * waste_ell / max(1, nnz_ell + waste_ell),
             nnz_er, nnz_long, n_slices, n_er_rows, long_rows.size)

    return EhybMatrix(
        dim=dim, nnz_total=nnz_total, window_rows=W, n_parts=n_parts,
        ell_col=ell_col, ell_val=ell_val,
        slice_offset=slice_offset.astype(np.int32),
        slice_win_start=slice_win_start,
        step_win=step_win.astype(np.int32),
        step_win_b=step_win_b.astype(np.int32),
        step_win_c=step_win_c.astype(np.int32),
        step_win_d=step_win_d.astype(np.int32),
        split_src=split_src, split_dst=split_dst,
        er_col=er_col, er_val=er_val,
        er_slice_offset=er_slice_offset.astype(np.int32), er_rows=er_rows,
        long_col=long_col, long_val=long_val, long_seg=long_seg,
        long_rows=long_rows, dia_offsets=dia_offsets, dia_val=dia_val,
        stats=stats)


def ehyb_to_dense(e: EhybMatrix) -> np.ndarray:
    """Reconstruct the dense (reordered) matrix from an EHYB instance — the
    inverse mapping used by conversion round-trip tests (the reference has no
    such check; its conversion is validated only end-to-end)."""
    dim = e.dim
    A = np.zeros((dim + 1, dim), dtype=np.float64)  # +1 = ER dump row safety
    C = e.ell_col.shape[1] if e.ell_col.ndim == 2 else 0

    rx = e.step_win_b.size > 0
    rmap = None
    if e.split_src.size:
        top = int(e.split_src.max()) + 1
        rmap = np.arange(max(top, dim + 1))
        rmap[e.split_src] = e.split_dst
    for s in range(e.n_slices):
        lo, hi = int(e.slice_offset[s]), int(e.slice_offset[s + 1])
        for k in range(lo, hi):
            win = int(e.step_win[k])
            for lane in range(C):
                v = float(e.ell_val[k, lane])
                if v != 0.0:
                    r = s * C + lane
                    if rmap is not None and r < rmap.size:
                        r = int(rmap[r])
                    if rx:
                        # relaxed lo-slot layout: the entry's lo bits live at
                        # its lane; the (sel, hi) bits live at lane == lo
                        lo_bits = int(e.ell_col[k, lane]) & 127
                        attr = int(e.ell_col[k, lo_bits])
                        sel = attr >> 10
                        base = (win, int(e.step_win_b[k]),
                                int(e.step_win_c[k]) if e.step_win_c.size
                                else 0,
                                int(e.step_win_d[k]) if e.step_win_d.size
                                else 0)[sel]
                        c = base + (((attr >> 7) & 7) << 7) + lo_bits
                    else:
                        c = win + int(e.ell_col[k, lane])
                    A[r, c] += v

    CE = e.er_col.shape[1] if e.er_col.ndim == 2 else 0
    for s in range(e.n_er_slices):
        lo, hi = int(e.er_slice_offset[s]), int(e.er_slice_offset[s + 1])
        for k in range(lo, hi):
            for lane in range(CE):
                v = float(e.er_val[k, lane])
                if v != 0.0:
                    packed = s * CE + lane
                    r = int(e.er_rows[packed])
                    A[r, int(e.er_col[k, lane])] += v

    for i in range(e.long_col.shape[0]):
        r = int(e.long_rows[int(e.long_seg[i])])
        A[r, int(e.long_col[i])] += float(e.long_val[i])

    for k in range(e.dia_offsets.shape[0]):
        d = int(e.dia_offsets[k])
        for r in range(max(0, -d), min(dim, dim - d)):
            v = float(e.dia_val[k, r])
            if v != 0.0:
                A[r, r + d] += v
    return A[:dim]


def verify_conversion(m_reordered: MatrixCOO, e: EhybMatrix,
                      atol: float = 0.0) -> None:
    """Exact structural check: EHYB reconstructs the reordered matrix.

    Raises AssertionError on mismatch.  Cost O(dense) — tests only.
    """
    dense_ref = np.zeros((m_reordered.n_rows, m_reordered.n_cols))
    np.add.at(dense_ref, (m_reordered.row, m_reordered.col), m_reordered.val)
    # Conversion quantizes values to the configured dtype.
    dense_ref = dense_ref.astype(e.ell_val.dtype).astype(np.float64)
    dense_got = ehyb_to_dense(e)
    if atol == 0.0:
        assert np.array_equal(dense_ref, dense_got), "EHYB reconstruction mismatch"
    else:
        np.testing.assert_allclose(dense_got, dense_ref, atol=atol)
