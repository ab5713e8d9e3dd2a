"""Host schedule of the streamed SELL body: the stream maps, the TPU's HBM
window-cache plan, and the predicate that picks the body's branch.

Port copy of the host part of ``ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py``
(``build_stream_maps``, ``build_hbm_cache_plan``, ``_plan_hbm_stream``,
``stream_body_fits`` and the constants they read, with the same environment
overrides read at import).  The machine with the GPU has no JAX, so the
copy lives here; keep the two in step.

The flagship reads these to take the TPU flagship's decisions: which layout
it may keep (the relaxed layout needs a streamed body that schedules) and
which TPU branch the apply takes (:func:`tpu_body_branch`).  The TPU's LRU
plan itself drives no CUDA kernel (CUDA blocks run in no order); the GPU's
window cache has its own plan, ``ops/ehyb_wincache.py``.

Module attributes are read at call time, so a caller (or a test) that sets
``X_RESIDENT_BYTES``, ``NSLOT`` or ``HBM_NSLOT`` here changes every decision
that depends on them.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from ..config import LANES, SUBLANES_F32, WINDOW_ALIGN
from ..core.ehyb import EhybMatrix

#: Width-steps per TPU sub-tile (one (8,128) vreg of nnz).
TILE_STEPS = SUBLANES_F32
#: TPU sub-tiles per grid step of the per-slice bodies; the flagship pins
#: slice widths to multiples of SUBTILES * TILE_STEPS.
SUBTILES = 4
#: TPU sub-tiles per streamed grid step (the geometry of the stream maps).
STREAM_SUBTILES = 32
#: The TPU's x-residency limit (``EHYB_X_RESIDENT_BYTES`` overrides, as in
#: the JAX package).  The GPU keeps x in device memory at any size; past
#: this limit the flagship takes the TPU's HBM branch and runs the explicit
#: x-window cache.
X_RESIDENT_BYTES = int(os.environ.get("EHYB_X_RESIDENT_BYTES",
                                      64 * 1024 * 1024))
#: The TPU's scalar-prefetch (SMEM) budget: it picks the small-map or the
#: big-meta variant of each streamed kernel.
_SMEM_PREFETCH_BUDGET = 900 * 1024
#: Window-cache slots of the resident stream geometry (max 512, the slot-id
#: bit budget).
NSLOT = min(512, int(os.environ.get("EHYB_NSLOT", "320")))
_SLOT_BITS = 9
#: The HBM geometry tried first: sub-tiles per grid step and cache slots.
HBM_STREAM_SUBTILES = min(128, int(os.environ.get("EHYB_HBM_SUBTILES",
                                                  "64")))
HBM_NSLOT = min(512, int(os.environ.get("EHYB_HBM_NSLOT", "512")))
#: Window rows of the x2d = x.reshape(-1, 128) view (a window is 8 rows).
WIN_ROWS = WINDOW_ALIGN // LANES

#: TPU branch name → the Pallas kernel the JAX package runs there (None:
#: no kernel, or the XLA body formulation).  The port serves K3/K4 with the
#: window-cache kernel and every other body with K1.
BRANCH_KERNEL = {
    "skipped": None, "streamed v3": "K1", "streamed big": "K2",
    "streamed hbm": "K3", "streamed hbm-big": "K4", "resident-x": "K5",
    "windowed": "K6", "xla rx": None, "xla body": None, "xla slide": None,
}


def build_stream_maps(e: EhybMatrix, spt: int = None):
    """Host metadata for the streamed body: per-sub-tile window rows and the
    sub-tile → slice segment ids (padding sub-tiles map to the dump slice
    ``n_slices``).  Steps are padded to a whole number of stream tiles.

    Returns (sub_wins, sub_slice, reset, last_sub, n_tiles); ``sub_wins`` is
    a LIST of per-sub-tile window-row maps — one entry for the chunk-sync
    layouts, two for dual-window ``sell_rx``, four for quad
    (windows_per_subtile=4); ``reset`` flags each slice's first sub-tile
    (for the in-kernel cumulative accumulator); ``last_sub[s]`` is the
    sub-tile whose emitted running sum is slice s's finished total.
    """
    widths = np.diff(e.slice_offset.astype(np.int64))
    if not np.all(widths % TILE_STEPS == 0):
        raise ValueError("slice widths must be multiples of 8")
    n_sub = e.step_win.shape[0] // TILE_STEPS
    spt = spt or STREAM_SUBTILES
    n_tiles = max(1, -(-n_sub // spt))
    sub_wins = []
    win_arrays = [e.step_win, e.step_win_b, e.step_win_c, e.step_win_d]
    for a in win_arrays:
        if a is None or not a.size:
            break
        sw = a.astype(np.int64).reshape(-1, TILE_STEPS)
        if not np.all(sw == sw[:, :1]):
            raise ValueError(
                "window must be constant within each 8-step sub-tile")
        m = np.zeros(n_tiles * spt, dtype=np.int32)
        m[:n_sub] = (sw[:, 0] // LANES).astype(np.int32)
        sub_wins.append(m)
    sub_slice = np.full(n_tiles * spt, e.n_slices, dtype=np.int32)  # dump
    step_slice = np.repeat(np.arange(e.n_slices, dtype=np.int32),
                           widths // TILE_STEPS)
    sub_slice[:n_sub] = step_slice
    reset = np.zeros(n_tiles * spt, dtype=np.int32)
    reset[0] = 1
    reset[1:] = sub_slice[1:] != sub_slice[:-1]
    last_sub = np.searchsorted(sub_slice, np.arange(e.n_slices),
                               side="right").astype(np.int32) - 1
    return sub_wins, sub_slice, reset, last_sub, n_tiles


def build_hbm_cache_plan(sub_wins, reset, n_tiles: int, S: int = None,
                         nslot: int = None):
    """The TPU's schedule for its HBM-streamed body's x-window cache.

    Simulates an ``nslot``-slot LRU cache over the per-grid-step window sets
    and emits exact load lists: a window first needed at grid step t is
    loaded at step t (issued at t-1).  The evicted slot is the least
    recently used window that is in neither step t's nor step t-1's working
    set.  Feasible whenever ``nslot`` covers two full consecutive working
    sets (at most ``2 * nwin * S`` windows).

    Returns ``(packed_words, load_off, load_cnt, load_src, load_dst, kmax0,
    kmax, n_loads)`` — ``packed_words`` is a list of per-sub-tile int32
    words: word 0 packs ``slot_0 | slot_1 << 9 | reset << 18``, word 1
    (quad only) packs ``slot_2 | slot_3 << 9``.  Loads are flattened
    wait-step-major.
    """
    S = S or STREAM_SUBTILES
    nslot = nslot or NSLOT
    nwin = len(sub_wins)
    ws = [np.asarray(a, dtype=np.int64) for a in sub_wins]
    if nwin == 1:
        ws = ws * 2  # slot_b mirrors slot_a for chunk-sync layouts
    if 2 * nwin * S > nslot:
        raise RuntimeError("nslot cannot cover two working sets")
    cache: "OrderedDict[int, int]" = OrderedDict()  # win -> slot, LRU first
    free = list(range(nslot - 1, -1, -1))
    loads = [[] for _ in range(n_tiles)]
    slots = [np.zeros(n_tiles * S, dtype=np.int32) for _ in ws]
    prev_need: set = set()
    for t in range(n_tiles):
        seg = np.concatenate([a[t * S:(t + 1) * S] for a in ws])
        need: set = set()
        order = []
        for w in seg.tolist():
            if w not in need:
                need.add(w)
                order.append(w)
        for w in order:
            if w in cache:
                cache.move_to_end(w)
                continue
            if free:
                s = free.pop()
            else:
                victim = next((cw for cw in cache
                               if cw not in need and cw not in prev_need),
                              None)
                if victim is None:  # can't happen per the nslot check above
                    raise RuntimeError("hbm window cache thrash")
                s = cache.pop(victim)
            cache[w] = s
            cache.move_to_end(w)
            loads[t].append((w, s))
        for j, a in enumerate(ws):
            for i in range(S):
                slots[j][t * S + i] = cache[int(a[t * S + i])]
        prev_need = need
    cnt = np.array([len(l) for l in loads], dtype=np.int32)
    off = np.zeros(n_tiles, dtype=np.int32)
    off[1:] = np.cumsum(cnt)[:-1]
    flat = [p for l in loads for p in l] or [(0, 0)]
    src = np.array([w for w, _ in flat], dtype=np.int32)
    dst = np.array([s for _, s in flat], dtype=np.int32)
    kmax0 = int(cnt[0])
    kmax = int(cnt[1:].max()) if n_tiles > 1 else 0
    packed = [slots[0] | (slots[1] << _SLOT_BITS)
              | (np.asarray(reset, dtype=np.int32) << (2 * _SLOT_BITS))]
    if nwin > 2:
        packed.append(slots[2] | (slots[3] << _SLOT_BITS))
    return packed, off, cnt, src, dst, kmax0, kmax, int(cnt.sum())


def _plan_hbm_stream(e: EhybMatrix) -> dict:
    """Schedule the TPU's HBM window-cache body, trying the big geometry
    first.

    Returns a dict with the chosen ``S``/``nslot``, the stream maps, the
    cache plan, and ``smem_bytes`` (the small-variant scalar-prefetch cost,
    which picks small vs big meta).  Raises ValueError when no candidate
    geometry schedules.
    """
    last = None
    for S, nslot in dict.fromkeys([(HBM_STREAM_SUBTILES, HBM_NSLOT),
                                   (STREAM_SUBTILES, NSLOT)]):
        try:
            (sub_wins, sub_slice, reset, last_sub,
             n_tiles) = build_stream_maps(e, S)
            plan = build_hbm_cache_plan(sub_wins, reset, n_tiles,
                                        S=S, nslot=nslot)
            packed, off, cnt, src, dst, kmax0, kmax, n_loads = plan
            smem_bytes = sum(p.nbytes for p in packed) + off.nbytes \
                + cnt.nbytes + src.nbytes + dst.nbytes
            if smem_bytes > _SMEM_PREFETCH_BUDGET and (
                    S > 128 or kmax0 > 128 or kmax > 128):
                # big-meta variant: S slot words and each tile's load list
                # must fit one 128-lane meta row
                raise RuntimeError(
                    f"big-meta row budget: S={S} kmax0={kmax0} kmax={kmax}")
            return dict(S=S, nslot=nslot, sub_wins=sub_wins,
                        sub_slice=sub_slice, reset=reset, last_sub=last_sub,
                        n_tiles=n_tiles, plan=plan, smem_bytes=smem_bytes)
        except (ValueError, RuntimeError) as exc:
            last = exc
    raise ValueError(f"hbm stream geometry infeasible: {last}")


def x_resident(e: EhybMatrix, value_bytes: int = 4) -> bool:
    """Whether the TPU would keep this matrix's padded x resident."""
    return e.padded_x_rows * value_bytes <= X_RESIDENT_BYTES


def stream_body_fits(e: EhybMatrix, value_bytes: int = 4) -> bool:
    """True iff a streamed body (resident, or the HBM window-cache variant)
    can be scheduled for this matrix: the stream-map invariants hold, the
    body is not empty and, past ``X_RESIDENT_BYTES``, the window-cache plan
    schedules."""
    if e.stats.get("nnz_ell", 1) == 0:
        return False
    if x_resident(e, value_bytes):
        try:
            build_stream_maps(e)
        except ValueError:
            return False
        return True
    try:
        _plan_hbm_stream(e)
    except (ValueError, RuntimeError):
        return False
    return True


def stream_body_enabled() -> bool:
    """``EHYB_STREAM_BODY=0`` turns the streamed bodies off, as in the JAX
    flagship."""
    return os.environ.get("EHYB_STREAM_BODY", "") != "0"


def tpu_body_branch(e: EhybMatrix, value_bytes: int = 4) -> str:
    """The branch the JAX flagship's apply takes for this artifact (the
    name its log line gives, a key of :data:`BRANCH_KERNEL`): the flagship's
    streaming gate (``models/ehyb.py:807``) followed by the selection of
    ``make_ehyb_pallas_apply``."""
    if e.stats.get("nnz_ell", 1) == 0:
        return "skipped"
    resident = x_resident(e, value_bytes)
    nwin = 1 if not e.step_win_b.size else 4 if e.step_win_c.size else 2
    if stream_body_enabled() and e.stats.get("nnz_ell", 0) > 0:
        if resident:
            try:
                n_sub = build_stream_maps(e)[0][0].shape[0]
            except ValueError:
                pass                  # not streamed: the per-slice bodies
            else:
                return "streamed v3" if n_sub * 4 * (nwin + 1) \
                    <= _SMEM_PREFETCH_BUDGET else "streamed big"
        else:
            try:
                geom = _plan_hbm_stream(e)
            except (ValueError, RuntimeError):
                pass
            else:
                return "streamed hbm" if geom["smem_bytes"] \
                    <= _SMEM_PREFETCH_BUDGET else "streamed hbm-big"
    if e.step_win_b.size:
        return "xla rx"
    n_steps = int(e.ell_col.shape[0])
    spt_res = SUBTILES * TILE_STEPS
    prefetch_bytes = 4 * (n_steps // TILE_STEPS
                          + 2 * max(n_steps // spt_res, 1))
    if prefetch_bytes > _SMEM_PREFETCH_BUDGET:
        return "xla body"
    if resident:
        return "resident-x"
    if not np.all(e.step_win.astype(np.int64) % WINDOW_ALIGN == 0):
        return "xla slide"
    return "windowed"
