"""Product-routing engine for the gather-wall regime (fully unstructured
matrices, e.g. 1M rows x 16 random nnz/row).

Why it exists: the SELL body's (slice, window) grouping collapses on matrices
with no recoverable structure — per-(128-row slice, 1024-col window) groups
hold ~2 entries, so the relaxed body runs at ~99% padding, and the only
alternative was the measured ~14 cyc/element XLA gather (the "gather wall").
The reference GPU kernel survives this regime because its phase-2 ER loop
does hardware global-memory gathers at near-full DRAM bandwidth
(the reference's ``kernel.cu:169-194``); the TPU has no hardware gather from
HBM, so the movement is *routed* through structured stages instead:

  stage A   products in COLUMN-grouped order: every (8,128) vreg of entries
            shares one 1024-element x window, so the proven two-stage VPU
            gather runs at high lane fill (the column view of a random
            matrix is dense even though the row view is not);
  stage T   one static 4D transpose (XLA, HBM bandwidth): products move from
            (window, stripe, band) order to (band, window, stripe) order —
            after which every band's products are CONTIGUOUS;
  stage B   per-band-group gather + reset-cumulative row reduction: each dst
            vreg pulls its sources from its band's (n_win*P)-element group,
            VMEM-served via a select chain over <=16 sub-windows, and rows
            reduce in-lane exactly like the streamed SELL body.

Placement freedoms make both gathers feasible:

  * stage A: an entry of matrix cell (window w, band rb) may occupy any of
    the P "stripe" slots of its cell; the P slots are STRIDED across the
    window's step stream, one per stripe, so they land in P different
    (8,128) steps — the per-step lo->hi consistency condition of the
    two-stage gather then becomes *exactly* the relaxed packer's election
    problem (:func:`~.convert._pack_steps_relaxed`), reused verbatim with
    pair=(window, band-row), lane=band%%128, slot=lo, class=hi.
  * stage B: a row's products may be consumed in any order across the row's
    dst steps — the same packer runs again with pair=dst-slice,
    lane=dst-row%%128, slot=the product's lane inside the band group,
    class=(sel, sublane).

Entries that lose both games (cell overflow past P, or unresolvable slot
conflicts) SPILL to a small XLA gather tail, like the ER tail of the main
format.  Reference parity: this subsumes the reference's ER phase for the
unstructured regime (``kernel.cu:169-194``) with a TPU-native mechanism.

Scale: the stage-B select chain is bounded at 16 sub-windows, so
n_win * P <= 16384 — with the Poisson slack P >= 2*mu a SINGLE instance
covers up to ~2M columns at 16 nnz/row.  Beyond that the model layer
(models/routed.py) splits the matrix into 1M-column vertical blocks, one
routed instance each (the band side is unconstrained, and the chooser
scales R up to keep the cells ~half full at the thinner per-block row
density), and sums the blocks' input-space outputs — no size cliff.

Port copy of ``ehyb_spmv_gpu_tpu/core/route.py``: the machine with the GPU
has no JAX, so the host layer lives in both packages and builds
byte-identical schedules.  Keep the two in step.  :meth:`RoutedMatrix.to_torch`
takes the place of ``to_jax``: it uploads the schedule as a
:class:`RoutedDevice` for the CUDA kernels of ``ops/route.py``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import LANES, cdiv, round_up
from ..core.coo import MatrixCOO
from ..utils.log import get_logger

log = get_logger(__name__)

#: Width-steps per sub-tile (one (8,128) f32 vreg of entries).
TS = 8
#: x window served per stage-A sub-tile (1024 x elements = 8 sublane rows).
WIN = 1024
#: Hard bound on the stage-B select chain (sel field = 4 bits of the int16).
MAX_CHAIN = 16
#: Sub-tiles per grid step of the stage-A kernel (amortizes the measured
#: ~240 ns flat per-grid-step cost of streamed Pallas bodies; A's grid is
#: uniform so bigger is simply better until the ~1.3 MB/tile VMEM footprint).
S_A = 64
#: Default stage-B sub-tiles per grid step (overridden per matrix by
#: :func:`_choose_group_geometry`).
S_B = 32
#: One grid step's flat cost expressed in (8,128) B steps (240 ns vs
#: ~2.8 ns/step of stream+select work) — the exchange rate the group
#: geometry search uses between padding and tile count.
FLAT_STEP_EQ = 85
#: Max bands per stage-B block, VMEM-gated per matrix in
#: :func:`_choose_group_geometry` (block bytes = c * n_win*P * 4, double-
#: buffered by the pipeline).  Bigger blocks cut the grid-quantum padding —
#: each group pads its steps to s_b*TS, so the padding FRACTION scales as
#: quantum / (c * median band steps): on the random_1m geometry c=6 left
#: ~18% of the B stream as group padding where c=32 leaves ~4%.
MAX_BANDS_PER_BLOCK = 64
#: VMEM budget for one stage-B block (double-buffered ~2x this in flight;
#: the idx stream + out block are small next to it).
BLOCK_VMEM_BYTES = 4 << 20
#: Mean slice width below which the OCTET stage-B layout engages (8 slices
#: per sub-tile, one sublane row each): thin widths waste most of a
#: slice-per-sub-tile stream on the ceil-to-8 floor.
OCTET_WIDTH_GATE = 12.0


def _round_up_arr(a: np.ndarray, m: int) -> np.ndarray:
    return -(-a // m) * m


@dataclasses.dataclass
class RoutedMatrix:
    """Host-side routed format + static schedules (device mirror via
    :meth:`to_torch`)."""

    dim: int
    n_win: int           # 1024-col x windows
    P: int               # stripe slots per (window, band) cell
    R: int               # rows per band
    n_bands: int
    n_bg: int            # band rows of the A layout = ceil(n_bands / 128)
    bands_per_block: int  # stage-B block covers this many consecutive bands
    s_b: int             # stage-B sub-tiles per grid step (searched)
    out_rows: int        # input-space output length (== padded_x_rows when
    #                      square; the full-matrix row padding for blocks)
    octet: int           # 1 = octet B layout (8 slices/sub-tile; b_last in
    #                      rows), 0 = slice layout (b_last in sub-tiles)
    # stage A (gather-multiply)
    a_col: np.ndarray    # int16 (hi<<7)|lo, slot-attr layout [a_steps_pad,128]
    a_val: np.ndarray    # f32 same shape
    a_win: np.ndarray    # int32 [a_subtiles] x2d window row (= window * 8)
    a_real_steps: int    # steps that participate in the transpose
    # stage B (route + reduce)
    b_idx: np.ndarray    # int16 (mask<<14)|(sel<<10)|(srow<<7)|lane
    b_gmap: np.ndarray   # int32 [b_grid] band-group of each grid step
    b_boff: np.ndarray   # int32 [b_subtiles] sublane-row offset of the
    #                      sub-tile's band inside its block (multiple of gr)
    b_reset: np.ndarray  # int32 [b_subtiles] 1 = dst slice starts here
    b_last: np.ndarray   # int32 [n_dst_slices] sub-tile holding the slice sum
    # spill tail (XLA gather) + dst permutation
    sp_dst: np.ndarray   # int32 dst-space row of each spilled entry
    sp_col: np.ndarray   # int32 global column
    sp_val: np.ndarray   # f32
    dst_rows: np.ndarray  # int32 [n_dst_rows] orig row at each dst position
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def group_rows(self) -> int:
        """(…,128)-rows of one band's contiguous T group."""
        return self.n_win * self.P // LANES

    @property
    def chain(self) -> int:
        return self.n_win * self.P // WIN

    @property
    def padded_x_rows(self) -> int:
        return self.n_win * WIN

    @property
    def n_dst_rows(self) -> int:
        return self.n_bands * self.R

    def to_torch(self, dtype: str = "float32",
                 device: Any = "cpu") -> "RoutedDevice":
        """Upload the schedule (the role of ``to_jax``); ``dtype`` casts the
        value arrays."""
        return RoutedDevice(self, dtype=dtype).to(device)


class RoutedDevice(torch.nn.Module):
    """Device-side mirror of :class:`RoutedMatrix`.  Array fields are
    buffers, so ``to(device)`` uploads all of them; the geometry stays plain
    Python.

    Stage B's running sum is carried per SEGMENT (a dst slice in the slice
    layout, an octet of 8 slices in the octet layout): ``seg_first`` and
    ``seg_last`` are the first and last stage-B sub-tiles of each segment,
    derived here once from ``b_reset``/``b_last``, so a kernel block can
    walk its segment without the TPU's sequential reset-carry and final
    ``take``.  The epilogue's scatter maps are empty when the dst space is
    the input space (identity dst)."""

    def __init__(self, rm: RoutedMatrix, dtype: str = "float32"):
        super().__init__()
        self.dim = rm.dim
        self.n_bg = rm.n_bg
        self.gr = rm.group_rows
        self.chain = rm.chain
        self.bands_per_block = rm.bands_per_block
        self.s_b = rm.s_b
        self.octet = bool(rm.octet)
        self.padded_x_rows = rm.padded_x_rows
        self.n_dst_rows = rm.n_dst_rows
        self.out_rows = rm.out_rows
        if rm.a_col.shape[0] != rm.a_real_steps:
            # the chooser guarantees it (n_win*P % 1024 == 0); the fused
            # A+T tiling of the stream relies on it
            raise ValueError(f"A stream padded past real ({rm.a_col.shape[0]}"
                             f" != {rm.a_real_steps})")
        n_groups = cdiv(rm.n_bands, rm.bands_per_block)
        if n_groups * rm.bands_per_block > rm.n_bg * LANES:
            raise ValueError("stage-B grouping exceeds the T stream (rebuild "
                             "the schedule)")
        b_last = rm.b_last.astype(np.int64)
        if rm.octet:
            # b_last holds rows: slice s sits at row s % 8 of its octet's
            # last sub-tile
            oct_last = b_last.reshape(-1, TS)
            if not np.array_equal(oct_last,
                                  oct_last[:, :1] + np.arange(TS)):
                raise ValueError("octet b_last rows are not consecutive")
            seg_last = oct_last[:, 0] // TS
        else:
            seg_last = b_last
        resets = np.flatnonzero(rm.b_reset)
        seg_first = resets[np.searchsorted(resets, seg_last,
                                           side="right") - 1]
        #: Sub-tiles summed over all segments (sizes the plain version's
        #: index arrays without a device sync).
        self.seg_subtiles = int((seg_last - seg_first + 1).sum())
        self.ident = bool(np.array_equal(
            rm.dst_rows[:rm.dim], np.arange(rm.dim, dtype=rm.dst_rows.dtype)))
        if self.ident:
            scat_src = scat_dst = np.zeros(0, dtype=np.int64)
        else:
            scat_src = np.flatnonzero(rm.dst_rows < rm.dim)
            scat_dst = rm.dst_rows[scat_src].astype(np.int64)
        arrays = {
            "a_col": rm.a_col, "a_val": rm.a_val.astype(dtype),
            "a_win": rm.a_win.astype(np.int32),
            "b_idx": rm.b_idx, "b_gmap": rm.b_gmap.astype(np.int32),
            "b_boff": rm.b_boff.astype(np.int32),
            "seg_first": seg_first.astype(np.int32),
            "seg_last": seg_last.astype(np.int32),
            "sp_dst": rm.sp_dst.astype(np.int64),
            "sp_col": rm.sp_col.astype(np.int64),
            "sp_val": rm.sp_val.astype(dtype),
            "scat_src": scat_src.astype(np.int64), "scat_dst": scat_dst,
        }
        for name, a in arrays.items():
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(a).copy()))

    @property
    def n_segs(self) -> int:
        return self.seg_first.shape[0]


def _choose_params(n_rows: int, n_cols: int, nnz: int,
                   R: Optional[int], P: Optional[int]):
    """Pick (R rows/band, P stripes): cell occupancy mu = R*(nnz/n_rows)/
    n_win wants ~P/2 Poisson slack against cell overflow, under the chain
    bound n_win*P <= 16*1024 and the alignment constraints (P*n_bg % 8 == 0
    via P % 8 == 0; n_win*P % WIN == 0, satisfied by rounding n_win or P
    UP, whichever yields the smaller chain).

    Among the feasible candidates the chooser maximizes the A fill mu/P,
    tie-broken toward larger mu (the absolute Poisson overflow tail shrinks
    with mu at equal slack ratio).  The upward R ladder matters for
    COLUMN-BLOCK instances (wide row side, narrow column side): per-block
    row density is k/n_blocks, and only a large R keeps the cells
    occupied."""
    n_win0 = cdiv(n_cols, WIN)
    r_candidates = ([R] if R is not None
                    else [LANES, 256, 384, 512, 1024, 2048, 4096,
                          8192, 16384, 32768])
    last_err = None
    best = None     # (fill, mu, -chain, n_win, r, p)
    for r in r_candidates:
        r = max(LANES, round_up(min(r, round_up(n_rows, LANES)), LANES))
        mu = r * (nnz / max(n_rows, 1)) / n_win0
        if P is None:
            # 1.9x, not 2.0x: P rounds up to a multiple of 8 anyway, and an
            # exact-2x rule makes mu = 8.0001 jump P 16 -> 24 (chain
            # infeasible or 50% extra A padding) over a rounding hair
            p = round_up(int(np.ceil(1.9 * max(mu, 1.0))), 8)
        else:
            p = round_up(max(P, 8), 8)
        # n_win*P must be a whole number of 1024-element B sub-windows
        # (stage-T/B group tiling granularity).
        q = WIN // int(np.gcd(p, WIN))
        cand = [(round_up(n_win0, q), p)]
        pq = WIN // int(np.gcd(n_win0, WIN))
        cand.append((n_win0, round_up(p, pq)))
        n_win, p = min(cand, key=lambda t: t[0] * t[1])
        chain = n_win * p // WIN
        if chain > MAX_CHAIN:
            last_err = (f"R={r} P={p} n_win={n_win} -> chain={chain} "
                        f"(cap {MAX_CHAIN})")
            continue
        n_bg_c = cdiv(cdiv(round_up(n_rows, LANES), r), LANES)
        key = (min(mu, p) / p, -n_win * p * n_bg_c, mu, -chain)
        if best is None or key > best[0]:
            best = (key, n_win, r, p)
    if best is not None:
        return best[1], best[2], best[3]
    raise ValueError(
        f"routed format infeasible: {last_err}; matrix too dense for the "
        f"single-level router (needs nnz/row <~ {MAX_CHAIN * WIN // 256})")


#: Stage-B step budget per dst slice (the colorer's single-uint64 mask width;
#: also bounds the widths and so the idx stream size).
MAX_COLORS = 64


def _choose_group_geometry(band_steps: np.ndarray, group_rows: int = 0,
                           bands_cap: int = 0):
    """Search (c bands/block, S_B sub-tiles/grid-step) minimizing
    ``padding + FLAT_STEP_EQ * n_tiles`` — every group pads its steps up to
    the S_B*TS grid quantum, and every grid step costs a flat ~240 ns.

    A fixed (2, 32) wasted 28%% of random_1m's stage-B stream in group
    padding; the search typically lands on larger blocks whose quantum sits
    just above c·median(band_steps).

    ``bands_cap`` (when > 0) rejects c where ``ceil(n_bands/c)·c`` exceeds
    it: stage T produces exactly ``n_bg·128`` band rows (the free 2D-view
    transpose), and a stage-B grouping that addresses more would force a
    pad — a full extra HBM pass over the product stream (measured as the
    ``pad.clone`` op that cost random_1m ~0.2 ms/iter before round 5).
    """
    # kernel bodies unroll s_b sub-tiles; cap available for compile-time
    # experiments (the searched optimum on random_1m is 80)
    try:
        sb_max = int(os.environ.get("EHYB_ROUTE_SB_MAX", "96"))
    except ValueError:
        log.warning("ignoring malformed EHYB_ROUTE_SB_MAX")
        sb_max = 96
    sb_max = min(96, max(8, sb_max))
    n_bands = band_steps.shape[0]
    # VMEM gate: one block (c bands of group_rows (…,128) f32 rows) must fit
    # the budget; group_rows=0 (unknown) keeps the full range.
    # EHYB_ROUTE_BANDS_MAX caps c for hardware A/B runs (cache-keyed).
    try:
        c_env = int(os.environ.get("EHYB_ROUTE_BANDS_MAX", "0"))
    except ValueError:
        log.warning("ignoring malformed EHYB_ROUTE_BANDS_MAX")
        c_env = 0
    c_max = c_env if c_env > 0 else MAX_BANDS_PER_BLOCK
    if group_rows > 0:
        c_max = max(1, min(c_max,
                           BLOCK_VMEM_BYTES // (group_rows * LANES * 4)))
    c_max = min(c_max, max(n_bands, 1))
    best = (1, min(S_B, sb_max))
    best_cost = None
    for c in range(1, c_max + 1):
        n_groups = cdiv(n_bands, c)
        if bands_cap and n_groups * c > bands_cap:
            continue  # would force a pad pass over the T stream (c=1 is
            # always feasible: n_bands <= bands_cap by construction)
        pad_n = n_groups * c - n_bands
        gs = np.pad(band_steps, (0, pad_n)).reshape(n_groups, c).sum(axis=1)
        for s_b in range(8, sb_max + 1, 8):  # multiples of 8: the out
            # block's sublane dim is s_b — keep it layout-aligned
            q = s_b * TS
            gp = _round_up_arr(gs, q)
            tiles = int((gp // q).sum())
            cost = int(gp.sum() - gs.sum()) + FLAT_STEP_EQ * tiles
            # Copy-burst stall: each group's first tile waits for its block
            # copy (c*group_rows (…,128) f32 rows at ~819 GB/s) minus the
            # one-tile compute the pipeline overlaps it with (~27.5 ns per
            # sub-tile of chain-select work).  Measured on random_1m: the
            # padding-optimal c=52 (3.3 MB blocks) ran 13.23 GFLOP/s vs
            # 13.79 at c=6 — ~4%, matching this term's prediction; without
            # it the search overbuys block size.
            if group_rows > 0:
                copy_ns = c * group_rows * LANES * 4 / 819.0
                stall_ns = max(0.0, copy_ns - s_b * 27.5)
                cost += int(n_groups * stall_ns / 2.8)
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = (c, s_b)
    return best


def _assign_steps_a(pair: np.ndarray, lane: np.ndarray, slot: np.ndarray,
                    cls: np.ndarray, n_pairs: int, P: int,
                    win: Optional[np.ndarray] = None,
                    dslice: Optional[np.ndarray] = None,
                    sperm: Optional[np.ndarray] = None,
                    n_dslices: int = 0) -> np.ndarray:
    """Stage-A stripe per entry via class-aware edge coloring; -1 = spill.

    Heaviest-endpoint-first order (max of the entry's cell load and its
    (pair, lo)-slot load, descending).  When (win, dslice, sperm) are given,
    the native colorer additionally balances the B-side slot loads the
    stripe choice induces.  Falls back to the vectorized round election when
    the native colorer is unavailable (more spill, same correctness —
    spilled entries ride the XLA tail).
    """
    cell_load = np.zeros((n_pairs, LANES), dtype=np.int32)
    np.add.at(cell_load, (pair, lane), 1)
    slot_load = np.zeros((n_pairs, LANES), dtype=np.int32)
    np.add.at(slot_load, (pair, slot), 1)
    key = np.maximum(cell_load[pair, lane], slot_load[pair, slot])
    order = np.argsort(-key, kind="stable")
    if P <= 64:  # the colorer's single-uint64 mask; small-dim geometries
        # get huge P, where per-cell load is tiny and the round election
        # spills ~nothing anyway
        try:
            if win is not None:
                from ..native import color_edges_cls_bal_native

                return color_edges_cls_bal_native(
                    pair.astype(np.int32), lane.astype(np.int16),
                    slot.astype(np.int16), cls.astype(np.int16),
                    win.astype(np.int32), dslice.astype(np.int32),
                    sperm.reshape(-1).astype(np.int16), order,
                    n_pairs, n_dslices, P).astype(np.int64)
            from ..native import color_edges_cls_native

            return color_edges_cls_native(
                pair.astype(np.int32), lane.astype(np.int16),
                slot.astype(np.int16), cls.astype(np.int16), order,
                n_pairs, P).astype(np.int64)
        except Exception as exc:              # pragma: no cover - no g++
            log.warning("native class colorer unavailable (%s); falling back "
                        "to the round election (more spill)", exc)
    from .convert import _pack_steps_relaxed

    ckey = (pair * LANES + slot) * 8 + cls
    _, cinv, ccnt = np.unique(ckey, return_inverse=True, return_counts=True)
    hint = np.lexsort((ckey, -ccnt[cinv], pair))
    rank = np.empty(hint.shape[0], dtype=np.int64)
    rank[hint] = np.arange(hint.shape[0])
    step = _pack_steps_relaxed(pair, lane, slot, cls,
                               order_hint=rank, ncls=8)
    return np.where(step < P, step, -1)


def _assign_steps_b(dslice: np.ndarray, dlane: np.ndarray,
                    b_lane: np.ndarray, hcls_b: np.ndarray,
                    n_dst_slices: int) -> np.ndarray:
    """Stage-B step per entry via bipartite edge coloring; -1 = spill.

    Processing order: heaviest endpoint first (max of the entry's dst-lane
    and source-lane loads, descending) — the classic largest-first heuristic,
    which colors the Δ-load vertices' edges before the masks fragment.
    """
    lload = np.zeros((n_dst_slices, LANES), dtype=np.int32)
    np.add.at(lload, (dslice, dlane), 1)
    sload = np.zeros((n_dst_slices, LANES), dtype=np.int32)
    np.add.at(sload, (dslice, b_lane), 1)
    key = np.maximum(lload[dslice, dlane], sload[dslice, b_lane])
    order = np.argsort(-key, kind="stable")
    try:
        from ..native import color_edges_native

        return color_edges_native(dslice, dlane, b_lane, order,
                                  n_dst_slices, MAX_COLORS).astype(np.int64)
    except Exception as exc:                  # pragma: no cover - no g++
        log.warning("native edge colorer unavailable (%s); falling back to "
                    "the round election (more spill)", exc)
        from .convert import _pack_steps_relaxed

        hkey = (b_lane - dlane) % LANES       # stagger candidate slots
        hint = np.lexsort((hkey, dslice))
        rank = np.empty(hint.shape[0], dtype=np.int64)
        rank[hint] = np.arange(hint.shape[0])
        step = _pack_steps_relaxed(dslice, dlane, b_lane, hcls_b,
                                   order_hint=rank, ncls=LANES)
        return np.where(step < MAX_COLORS, step, -1)


def routed_row_perm(row: np.ndarray, n_rows: int, R: int) -> np.ndarray:
    """The dst row order as a standalone permutation: within each band of
    ``R`` consecutive rows, rows sorted by nnz count descending (stable).

    This is exactly the order :func:`build_routed` would impose internally;
    callers that PRE-permute the matrix by it (rows and, for square
    chainable use, columns) can then build with ``identity_dst=True`` and
    the engine's output needs NO element-granular scatter back to input
    space — measured on v5e, that scatter (an XLA arbitrary gather over
    ~dim elements) was 12.3 of random_1m's 14.6 ms/iter, i.e. the gather
    wall re-entering at the pipe's own output.

    Returns int64 ``perm`` of length ``n_bands*R`` with ``perm[p]`` = the
    original row at dst position ``p``.  All real rows land at positions
    ``< n_rows`` (synthetic count-0 tail rows sort last in the last band),
    so ``perm[:n_rows]`` is a bijection on ``[0, n_rows)``.
    """
    n_bands = cdiv(round_up(n_rows, LANES), R)
    n_dst = n_bands * R
    counts = np.bincount(np.asarray(row), minlength=n_dst).astype(np.int64)
    return np.argsort(
        (np.arange(n_dst, dtype=np.int64) // R) * (counts.max() + 2)
        - counts, kind="stable")


def build_routed(m: MatrixCOO, R: Optional[int] = None,
                 P: Optional[int] = None,
                 out_rows: Optional[int] = None,
                 group_geometry: Optional[tuple] = None,
                 octet_override: Optional[bool] = None,
                 identity_dst: bool = False) -> RoutedMatrix:
    """Build the routed format + static schedules from an (un-reordered) COO
    matrix.  Entries that overflow their stage-A cell (past P) or exhaust the
    stage-B step budget (MAX_COLORS) spill to the XLA tail.

    Rectangular matrices are supported (column-block instances of a big
    square SpMV): rows drive the band side, columns the window side.
    ``out_rows`` sizes the input-space output vector (defaults to the
    padded x rows — correct for square single-level use, where output and
    input share the space).
    """
    dim = m.n_rows
    n_win, R, P = _choose_params(m.n_rows, m.n_cols, m.nnz, R, P)
    n_bands = cdiv(round_up(dim, LANES), R)
    n_bg = cdiv(n_bands, LANES)
    gr = n_win * P // LANES          # sublane rows per band group

    row = m.row.astype(np.int64)
    col = m.col.astype(np.int64)
    val = np.asarray(m.val)
    band = row // R
    bg = band // LANES
    blane = band % LANES
    w = col // WIN
    hi = (col % WIN) // LANES
    lo = col % LANES

    # ---- dst row order: density sort within each band (decided BEFORE
    # stage A so the colorer can balance B-side slot loads; counts include
    # the soon-to-spill 0.1%, which cannot move a sort by integer counts
    # far) ------------------------------------------------------------------
    n_dst_rows = n_bands * R
    if identity_dst:
        # Caller pre-permuted the matrix by routed_row_perm (or accepts the
        # given row order): dst space == row space, and the apply's epilogue
        # degenerates to a slice (no element-granular scatter).
        order_in_band = np.arange(n_dst_rows, dtype=np.int64)
    else:
        counts = np.bincount(row, minlength=n_dst_rows).astype(np.int64)
        order_in_band = np.argsort(
            (np.arange(n_dst_rows, dtype=np.int64) // R) * (counts.max() + 2)
            - counts, kind="stable")           # band-major, count desc
    dst_rows = order_in_band.astype(np.int32)  # dst position -> orig row
    dst_of_row = np.empty(n_dst_rows, dtype=np.int64)
    dst_of_row[order_in_band] = np.arange(n_dst_rows)
    n_dst_slices = n_dst_rows // LANES

    # Stripe scramble (see the scatter comment below) — built up front so
    # the balance-aware colorer can price each stripe's resulting B slot.
    sperm = np.argsort(
        np.random.default_rng(0xE4B).random((n_win, P)), axis=1)

    # ---- stage A packing: pair=(w, bg), lane=blane, slot=lo, class=hi ----
    # The election condition is the relaxed packer's (two entries share a
    # (stripe, lo) slot iff their hi agrees), but run as the sequential
    # class-aware lowest-free-color greedy: the vectorized round election
    # left 210k of 16.7M entries unplaced on random_1m where the structural
    # (Poisson cell-overflow) floor is ~25k — and every spilled entry costs
    # the measured ~14 cyc/element XLA tail.  Among feasible stripes the
    # colorer picks the one minimizing the dst slice's B-slot load: stage
    # B's widths bind on the MAX source-lane load (Poisson max ~2x mean on
    # random matrices), and the stripe choice is exactly the slot choice.
    pair_a = w * n_bg + bg
    step_a = _assign_steps_a(pair_a, blane, lo, hi, n_win * n_bg, P,
                             win=w, dslice=dst_of_row[row] // LANES,
                             sperm=sperm, n_dslices=n_dst_slices)
    # lane == band here, so step_a IS the entry's stripe within its cell;
    # stripes past P (or unplaceable) overflow the cell -> spill
    kept = step_a >= 0
    n_spill_a = int((~kept).sum())

    # ---- stage A scatter: step index = bg*(n_win*P) + (w*P + p) ----------
    # BAND-GROUP-MAJOR since format v11: the fused A+T kernel computes one
    # (bg, gr-chunk) of products per grid step and writes them through an
    # in-register tile transpose, so each grid step's col/val block must be
    # a contiguous run of flat_g for ONE bg.  (v10 and earlier used
    # flat_g-major with a separate transpose kernel — two extra full HBM
    # passes over the product stream.)
    a_real_steps = n_win * P * n_bg
    a_steps_pad = round_up(a_real_steps, S_A * TS)
    a_col = np.zeros((a_steps_pad, LANES), dtype=np.int16)
    a_val = np.zeros((a_steps_pad, LANES), dtype=np.float32)
    ks, kw, kbg, kbl = step_a[kept], w[kept], bg[kept], blane[kept]
    khi, klo = hi[kept], lo[kept]
    # Scramble stripe labels with a per-window random permutation: the greedy
    # election concentrates entries in LOW stripes, and stage B's source lane
    # is flat_g % 128 with flat_g = w*P + stripe — a skewed stripe histogram
    # becomes a skewed slot histogram and the B election then loses ~2/3 of
    # its per-round throughput to slot collisions (measured: 45 rounds for a
    # 24-step budget).  Relabeling whole (w, stripe) step groups is free —
    # both sides derive their address from the same flat position.  (The
    # balance-aware colorer already priced stripes THROUGH this map.)
    ks = sperm[kw, ks]
    sidx = kbg * (n_win * P) + kw * P + ks
    flat_slot = sidx * LANES + klo
    flat_lane = sidx * LANES + kbl
    ca = a_col.reshape(-1)
    ca[flat_slot] = (khi << 7).astype(np.int16)
    np.bitwise_or.at(ca, flat_lane, klo.astype(np.int16))
    a_val.reshape(-1)[flat_lane] = val[kept].astype(np.float32)
    # per-sub-tile window rows (P % 8 == 0 keeps every sub-tile inside one
    # window; padding tail sub-tiles read window 0 with val 0)
    a_win = np.zeros(a_steps_pad // TS, dtype=np.int32)
    a_win[: a_real_steps // TS] = np.tile(np.repeat(
        np.arange(n_win, dtype=np.int32), P // TS), n_bg) * (WIN // LANES)

    # ---- stage B packing: pair=dst slice, lane=dst row, slot=product lane.
    # Every (slot, class) pair is unique (it names one stage-A cell), so the
    # feasibility condition degenerates to "per (slice, step): each dst lane
    # and each source lane at most once" — proper bipartite edge coloring.
    # König guarantees Δ = max(lane load, slot load) steps suffice; the
    # native lowest-free-color greedy lands within ~1 of Δ where the
    # vectorized round election plateaued at ~1.5Δ (13% spill).
    kr = row[kept]
    dst = dst_of_row[kr]
    dslice = dst // LANES
    dlane = dst % LANES
    flat_g = kw * P + ks                      # address inside the band group
    b_sel = flat_g // WIN
    b_srow = (flat_g % WIN) // LANES
    b_lane = flat_g % LANES
    step_b = _assign_steps_b(dslice, dlane, b_lane, b_sel * TS + b_srow,
                             n_dst_slices)
    kept_b = step_b >= 0
    n_spill_b = int((~kept_b).sum())
    # true slice widths FROM the coloring
    mxc = np.full(n_dst_slices, 0, dtype=np.int64)
    np.maximum.at(mxc, dslice[kept_b], step_b[kept_b] + 1)

    # ---- dst step layout: bands -> fixed-size band groups ---------------
    # Two layouts share the group machinery (band_steps in ROWS either way):
    #
    # * normal: a sub-tile's 8 sublane rows are 8 consecutive STEPS of one
    #   slice (reduce = cross-sublane sum) — per-slice rows round up to 8;
    # * OCTET (thin-width regime, slices_per_band >= 8): a sub-tile's 8
    #   rows are 8 consecutive SLICES at one step (reduce = elementwise
    #   accumulate over an (8,128) scratch) — an octet of 8 width-sorted
    #   slices costs max-width*8 rows instead of 8 * round8(width), a
    #   2-4x stream cut when widths sit at 2-4 (the column-block regime,
    #   where every slice holds only nnz/n_blocks-thinned rows but paid a
    #   full sub-tile).
    #
    # (c bands/block, S_B sub-tiles/grid step) are searched jointly: every
    # group pads to the S_B*TS grid quantum, and every grid step pays the
    # measured ~240 ns flat streamed-kernel cost (~FLAT_STEP_EQ steps'
    # worth), so a fixed quantum wastes up to ~28% of the stage-B stream
    # (random_1m, c=2/S_B=32: groups of ~184 steps padded to 256).
    slices_per_band = R // LANES
    spb = slices_per_band
    env_oct = os.environ.get("EHYB_ROUTE_OCTET", "")
    octet = (spb >= 8 and spb % 8 == 0
             and (env_oct == "1"
                  or (env_oct != "0"
                      and float(mxc.mean()) < OCTET_WIDTH_GATE)))
    if octet_override is not None:      # sharded builds pin shard-0's choice
        octet = bool(octet_override) and spb >= 8 and spb % 8 == 0
    if octet:
        opb = spb // 8                       # octets per band
        # slices within a band are density-sorted, so consecutive groups of
        # 8 have near-equal widths; the octet pays its max
        w_oct = np.maximum(
            mxc.reshape(n_bands, opb, 8).max(axis=2), 1)
        wb = w_oct * 8                       # rows per octet
        segs_per_band = opb
    else:
        wb = np.maximum(_round_up_arr(mxc, TS), TS) \
            .reshape(n_bands, spb)           # rows per slice
        segs_per_band = spb
    band_steps = wb.sum(axis=1)               # multiples of 8
    bands_cap = n_bg * LANES                  # band rows stage T produces
    c, s_b = (group_geometry if group_geometry is not None
              else _choose_group_geometry(band_steps, gr,
                                          bands_cap=bands_cap))
    # pinned geometries (sharded builds, caches from older versions) must
    # honor the cap too — clamp deterministically (identical inputs give
    # identical clamps across shards)
    while cdiv(n_bands, c) * c > bands_cap:
        c -= 1
    n_groups = cdiv(n_bands, c)
    assert n_groups * c <= bands_cap, "stage-B grouping exceeds the T stream"
    grp_of_band = np.arange(n_bands) // c
    grp_steps = np.zeros(n_groups, dtype=np.int64)
    np.add.at(grp_steps, grp_of_band, band_steps)
    grp_steps_pad = _round_up_arr(grp_steps, s_b * TS)
    grp_base = np.concatenate([[0], np.cumsum(grp_steps_pad)[:-1]])
    # band base inside its group
    for_first = np.flatnonzero(np.r_[True, grp_of_band[1:]
                                     != grp_of_band[:-1]])
    cum_b = np.cumsum(band_steps) - band_steps
    within_g = cum_b - np.repeat(cum_b[for_first],
                                 np.diff(np.append(for_first, n_bands)))
    band_base = grp_base[grp_of_band] + within_g
    within_b = np.cumsum(wb, axis=1) - wb
    seg_base = (band_base[:, None] + within_b).reshape(-1)

    b_steps_pad = int(grp_steps_pad.sum())
    b_idx = np.full((b_steps_pad, LANES), 1 << 14, dtype=np.int16)
    kk = kept_b
    if octet:
        swb = dslice[kk] % spb
        seg_of = (dslice[kk] // spb) * segs_per_band + swb // TS
        dstep = seg_base[seg_of] + step_b[kk] * TS + swb % TS
    else:
        dstep = seg_base[dslice[kk]] + step_b[kk]
    fl_slot = dstep * LANES + b_lane[kk]
    fl_lane = dstep * LANES + dlane[kk]
    bi = b_idx.reshape(-1)
    bi[fl_lane] = 0
    np.bitwise_or.at(
        bi, fl_slot,
        ((b_sel[kk] << 10) | (b_srow[kk] << 7)).astype(np.int16))
    np.bitwise_or.at(bi, fl_lane, b_lane[kk].astype(np.int16))

    # ---- per-sub-tile maps ----------------------------------------------
    n_bsub = b_steps_pad // TS
    n_segs = n_bands * segs_per_band
    seg_rows = wb.reshape(-1)
    step_band = np.full(b_steps_pad, -1, dtype=np.int64)
    band_spans = np.repeat(np.arange(n_bands), band_steps)
    pos = np.concatenate([
        np.arange(int(b0), int(b0) + int(bs))
        for b0, bs in zip(band_base, band_steps)]) \
        if n_bands else np.zeros(0, dtype=np.int64)
    step_band[pos] = band_spans
    step_seg = np.full(b_steps_pad, -1, dtype=np.int64)
    step_seg[pos] = np.repeat(np.arange(n_segs), seg_rows)
    sub_band = step_band.reshape(-1, TS)[:, 0]
    assert np.all((step_band.reshape(-1, TS) == sub_band[:, None])
                  | (step_band.reshape(-1, TS) < 0)), \
        "dst sub-tile straddles a band"
    if octet:
        assert np.all((step_seg.reshape(-1, TS)
                       == step_seg.reshape(-1, TS)[:, :1])
                      | (step_seg.reshape(-1, TS) < 0)), \
            "octet sub-tile straddles an octet"
    # padding sub-tiles: attribute to the group's first band (mask rows)
    b_grid = b_steps_pad // (s_b * TS)
    step_grp = np.searchsorted(grp_base, np.arange(b_steps_pad),
                               side="right") - 1
    sub_grp = step_grp.reshape(-1, TS)[:, 0]
    sub_band = np.where(sub_band < 0, sub_grp * c, sub_band)
    b_gmap = sub_grp.reshape(b_grid, s_b)[:, 0].astype(np.int32)
    b_boff = ((sub_band - b_gmap.repeat(s_b) * c) * gr).astype(np.int32)
    assert b_boff.min(initial=0) >= 0 \
        and b_boff.max(initial=0) <= (c - 1) * gr, "boff out of block"
    sub_seg = step_seg.reshape(-1, TS)[:, 0]
    b_reset = np.zeros(n_bsub, dtype=np.int32)
    b_reset[0] = 1
    b_reset[1:] = sub_seg[1:] != sub_seg[:-1]
    if octet:
        # b_last holds ROW indices into the (b_steps_pad, 128) y stream:
        # slice s's total sits at its octet's final step, sublane s%8
        sl = np.arange(n_dst_slices, dtype=np.int64)
        seg_of_sl = (sl // spb) * segs_per_band + (sl % spb) // TS
        b_last = (seg_base[seg_of_sl] + seg_rows[seg_of_sl] - TS
                  + (sl % spb) % TS).astype(np.int32)
    else:
        # b_last holds SUB-TILE indices into the (n_bsub, 128) y stream
        b_last = ((seg_base + seg_rows) // TS - 1).astype(np.int32)

    # ---- spill tail ------------------------------------------------------
    sp_rows = np.concatenate([row[~kept], kr[~kept_b]])
    sp_cols = np.concatenate([col[~kept], col[kept][~kept_b]])
    sp_vals = np.concatenate([val[~kept], val[kept][~kept_b]])
    sp_dst = dst_of_row[sp_rows].astype(np.int32)
    # dst-sorted so the apply's scatter-add can carry the
    # indices_are_sorted hint (detected from the array content, so caches
    # built before this change stay valid without one)
    sp_ord = np.argsort(sp_dst, kind="stable")
    sp_dst, sp_cols, sp_vals = sp_dst[sp_ord], sp_cols[sp_ord], sp_vals[sp_ord]

    stats = {
        "nnz": m.nnz,
        "nnz_routed": int(kept_b.sum()),
        "nnz_spill": int(sp_rows.shape[0]),
        "spill_a": n_spill_a,
        "spill_b": n_spill_b,
        "a_steps": a_real_steps,
        "a_fill": float(kept.sum() / max(a_real_steps * LANES, 1)),
        "b_steps": b_steps_pad,
        "b_fill": float(kept_b.sum() / max(b_steps_pad * LANES, 1)),
        "chain": n_win * P // WIN,
        "P": P, "R": R, "n_win": n_win, "n_bands": n_bands,
        "bands_per_block": c, "s_b": s_b, "octet": int(octet),
    }
    log.info("routed format: %s", {k: (round(v, 4) if isinstance(v, float)
                                       else v) for k, v in stats.items()})
    return RoutedMatrix(
        dim=dim, n_win=n_win, P=P, R=R, n_bands=n_bands, n_bg=n_bg,
        bands_per_block=c, s_b=s_b, octet=int(octet),
        out_rows=int(out_rows if out_rows is not None else n_win * WIN),
        a_col=a_col, a_val=a_val, a_win=a_win, a_real_steps=a_real_steps,
        b_idx=b_idx, b_gmap=b_gmap, b_boff=b_boff, b_reset=b_reset,
        b_last=b_last, sp_dst=sp_dst, sp_col=sp_cols.astype(np.int32),
        sp_val=sp_vals.astype(np.float32), dst_rows=dst_rows, stats=stats)
