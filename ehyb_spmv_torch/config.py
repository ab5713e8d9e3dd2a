"""Hardware constants, feature flags, and the EHYB configuration dataclass.

TPU-native re-design of the reference's compile-time tuning constants
(``kernel.h:20-28``: warpSize/smSize/maxSharedMem/threadELL/threadLongVec) and its
``cb_s`` boolean feature-flag struct (``spmv.h:7-15`` with defaults in ``init_cb``
``spmv.h:65-73``).  On TPU the "explicit cache" is a VMEM-resident window of the
input vector x, so the central planner input is a VMEM byte budget instead of the
94 KB shared-memory budget (``kernel.cu:350``).

Port copy of ``ehyb_spmv_gpu_tpu/config.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# TPU hardware constants (analog of kernel.h:20-28).
# ---------------------------------------------------------------------------

LANES = 128          # VPU lane count; last-dim tile size for every dtype.
SUBLANES_F32 = 8     # float32 sublane count: min f32 tile is (8, 128).

#: Rows per SELL slice.  The TPU analog of the reference's 32-row ELL block
#: (``convert.c:107``): rows live on VPU *lanes*, so a slice is LANES rows wide and
#: the ELL width dimension runs along sublanes.  This is the SELL-C-sigma format
#: with C = 128 and sigma = the partition size (density sort is per partition).
SLICE_ROWS = LANES

#: Width granularity: slice ELL widths are padded up to a multiple of this so the
#: width dimension tiles cleanly onto f32 (8, 128) registers.
WIDTH_ALIGN = SUBLANES_F32

#: Per-core VMEM (bytes).  ~16 MB on v4/v5; keep a conservative default.
VMEM_BYTES = 16 * 1024 * 1024

#: Default VMEM budget for the cached x window (the analog of
#: ``maxSharedMem = 93*1024`` at ``kernel.h:23``).  The kernel additionally needs
#: double-buffered ELL tiles + y tile, so the window gets a fraction of VMEM.
DEFAULT_WINDOW_BUDGET_BYTES = 2 * 1024 * 1024

#: Window sizes must be a multiple of this many rows so window starts stay aligned
#: to full (sublane, lane) tiles of x.  (Reference rounds the cache to multiples of
#: threadELL=1024 rows, ``solver_test.c:55,160``.)
WINDOW_ALIGN = LANES * SUBLANES_F32  # 1024 — same granularity as the reference.

#: In-window nnz beyond which a row at the head of a partition is split out into
#: the long-row path (reference: threadLongVec = 512, ``kernel.h:26``,
#: ``convert.c:92-101``).  On TPU long rows mostly matter for the ER tail (rows
#: with huge out-of-window counts); in-window widths are bounded by the window.
DEFAULT_LONG_ROW_THRESHOLD = 512

#: Chunk length for the long-row chunked reduction (reference uses one 512-thread
#: block per long row, ``kernel.cu:43-67``; we use reshape-and-sum chunks).
LONG_ROW_CHUNK = 1024


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


# ---------------------------------------------------------------------------
# Feature flags — the cb_s analog (spmv.h:7-15).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Features:
    """Feature flags mirroring the reference's ``cb_s`` struct (``spmv.h:7-15``).

    The reference hard-requires RODR && CACHE && BLOCK (``solver_test.c:322-325``);
    here every combination is runnable (off-flags select simpler fallback paths).
    """

    reorder: bool = True   # RODR: METIS partition + two-level row reorder.
    cache: bool = True     # CACHE: window x caching in VMEM (EHYB vs plain HYB).
    block: bool = True     # BLOCK: blocked/SELL ELL body (vs plain CSR).
    sort_rows: bool = True  # in-partition sort (reordering.c:18-39).
    #: DIA sub-format: extract high-fill diagonals into dense offset vectors
    #: *before* SELL packing.  TPU-native extension with no reference analog:
    #: on TPU a dense diagonal is a *static shifted slice* of x — a pure VPU
    #: FMA with no gather (measured ~4x cheaper per element than the SELL
    #: two-stage dynamic_gather path) — the analog of how the reference splits
    #: regular work (blockELL) from irregular work (ER) by what the hardware
    #: executes well (kernel.cu:150-168 vs 169-194).
    dia: bool = True
    #: "density" (reference behavior) or "pattern" (column-structure grouping,
    #: best for the multi-window layout — see core/reorder.py).
    sort_mode: str = "density"


# ---------------------------------------------------------------------------
# The main configuration object.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EhybConfig:
    """Tuning + planning configuration for the EHYB pipeline.

    Replaces the scattered compile-time constants of the reference with one
    serializable config (see SURVEY.md §5 "Config / flag system").
    """

    # Value dtype for device compute.  TPU has no native f64; float32 is the
    # production dtype (validated at the reference's 1% tolerance and usually
    # ~1e-6); float64 is available for CPU correctness runs.
    dtype: str = "float32"
    # Column-index dtype inside the window-local ELL body.  The reference uses
    # int16 window-local columns (spmv.h:46); int32 is the compatible default,
    # int16 halves index bandwidth when the window fits.
    index_dtype: str = "int32"

    # --- planner inputs (analog of solver_test.c:53-77 heuristic inputs) ---
    window_budget_bytes: int = DEFAULT_WINDOW_BUDGET_BYTES
    #: Force a specific x-window size in rows (multiple of WINDOW_ALIGN);
    #: None → planner picks from the budget.
    window_rows: Optional[int] = None
    #: Minimum number of partitions (nParts); planner may raise it so windows
    #: fit in the budget.
    min_parts: int = 1

    # --- format shape ---
    #: SELL body packing: 'sell' = plain width-step packing (XLA path);
    #: 'sell_cs' = chunk-synchronized packing required by the Pallas
    #: two-stage-gather kernel (see convert._sell_pack_chunk_sync);
    #: 'sell_mw' = multi-window chunk-sync; 'sell_rx' = relaxed lo-slot
    #: packing with dual-window sub-tiles (convert._sell_pack_relaxed).
    body_layout: str = "sell"
    #: Relaxed-layout auto-switch: with body_layout 'sell_mw', 'auto' converts
    #: both ways when chunk-sync padding is high and keeps the cheaper body by
    #: the measured per-vreg cycle model; 'never' disables the second attempt.
    relax_body: str = "auto"
    #: Gather-wall delegation: 'auto' lets EhybSpmv.setup return the routed
    #: model (models/routed.py) when the converted body's waste exceeds
    #: ~97% — the regime where EVERY window-cached layout collapses and the
    #: reference leans on hardware global gathers (kernel.cu:169-194);
    #: 'never' keeps the EHYB body regardless.  One flagship model then
    #: covers every regime, like the reference's single entry point.
    routed_delegate: str = "auto"
    #: Hub-row splitting (sell_rx): per-(row, 1024-window) entry groups
    #: larger than this move their surplus to synthetic overflow rows that
    #: fold back at combine time — without it a hub row serializes its
    #: pair's steps at a few-percent lane fill (powerlaw-style matrices are
    #: lane-bound).  OFF by default (0): measured on v5e, the combine's
    #: scatter-add of the pieces (~14 cyc/element, the gather wall) costs
    #: more than the saved body steps at 16k-row scale (powerlaw_16k:
    #: -22%% steps but +70%% wall).  A knob for matrices whose hub rows
    #: dominate harder.
    row_split_threshold: int = 0
    #: Compensated (Neumaier two-sum) accumulation in the streamed Pallas
    #: body: f32 summation-order error of long slice chains collapses to ~1
    #: ulp — the TPU realization of the reference's f64 precision contract
    #: (spmv.h:46; the hardware has no f64 VPU).  Costs extra VPU ops; off
    #: by default.
    compensated_sum: bool = False
    #: The precision mode: the reference's f64 value contract
    #: (spmv.h:46).  The JAX package carries (hi, lo) f32 pairs, since the
    #: TPU has no f64; the port stores values, x and y in f64 and sums in
    #: f64, the body (K1) and DIA (K9) kernels in their f64 variants on the
    #: card (ops/dword.py).  Taken by ehyb, ehyb_xla and hyb, which plan
    #: with dtype float64, row_split_threshold=0 and relax_body='never' (the
    #: flagship pins no layout in this mode); every other model refuses it.
    #: Held to rel <= 1e-12 against the exact-f64 oracle.
    dword_values: bool = False
    #: Multi-window layout: minimum entries a (slice, window) group needs to be
    #: packed into body tiles; smaller groups spill to the ER tail.  Measured
    #: break-even on v5e: a kept group costs ≤8 width-steps (~22 VPU cyc), an
    #: ER element ~14 cyc through the XLA global gather → keep groups of ≥2.
    min_window_group_nnz: int = 2
    #: Relaxed layout (sell_rx): x windows served per 8-step sub-tile — 2
    #: (dual, one ``sel`` bit) or 4 (quad, two ``sel`` bits).  More windows
    #: per sub-tile merge more (slice, window) groups into one step chain:
    #: the per-group ceil-to-8 padding amortizes over bigger groups AND the
    #: lane-occupancy bound tightens (entries/lane averages up), at the cost
    #: of extra sublane gathers + selects per vreg (~+2 cyc for 4).  On
    #: scattered matrices (random_16k-class) 4 cuts packed steps ~1.5-2x;
    #: 'auto' (via relax_body) converts both ways and keeps the cheaper by
    #: the cycle model.
    windows_per_subtile: int = 2
    #: Multi-window layout: sliding (greedy, 128-row-aligned) x-window starts
    #: instead of fixed 1024-aligned ones.  Only valid with the VMEM-resident
    #: Pallas kernel (the windowed-BlockSpec fallback needs 1024 alignment);
    #: None/False = fixed.  Set automatically by the flagship model.
    sliding_windows: Optional[bool] = None
    #: Row-ordering strategy for the multi-window layout: 'auto' | 'natural' |
    #: 'rcm' | 'partition' (see core/ordering.py).  Windowed layouts always use
    #: 'partition' (the reference pipeline).
    ordering: str = "auto"
    slice_rows: int = SLICE_ROWS
    width_align: int = WIDTH_ALIGN
    long_row_threshold: int = DEFAULT_LONG_ROW_THRESHOLD
    #: DIA extraction: a diagonal is extracted when its nnz count is at least
    #: ``dia_threshold * dim``.  Break-even vs the SELL gather body is where
    #: dia VPU cost (~5 cyc per 1024 slots) matches gather cost (~22 cyc per
    #: 1024 nnz): count/dim ≳ 0.23; default slightly below to favor the
    #: gather-free path (diagonal storage also beats SELL bytes at that fill).
    dia_threshold: float = 0.2
    #: Hard cap on extracted diagonals (bounds compile time of the unrolled
    #: shifted-slice sum and the (K, dim) dense storage).
    max_diagonals: int = 256
    #: ER tail slice height (rows per ER slice, density-sorted; the analog of the
    #: reference's per-32-row ER warps, convert.c:148-168).
    er_slice_rows: int = SLICE_ROWS

    features: Features = dataclasses.field(default_factory=Features)

    # --- partitioner ---
    #: 'native' = C++ multilevel k-way; 'blocks' = contiguous-chunk fallback;
    #: 'auto' = native when available else blocks.
    partitioner: str = "auto"
    partition_imbalance: float = 1.03

    # --- artifact caching (improvement over the reference, which rebuilds the
    #     format from .mtx every run — SURVEY.md §5) ---
    artifact_cache: bool = False
    cache_dir: Optional[str] = None

    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    def np_index_dtype(self) -> np.dtype:
        return np.dtype(self.index_dtype)
