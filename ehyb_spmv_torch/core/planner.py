"""The cache-window / partition-count planner.

TPU re-design of the reference's central EHYB sizing heuristic, which is
duplicated inline in both matrix readers (``solver_test.c:53-77`` and
``solver_test.c:158-187``): pick the number of graph partitions ``nParts`` and
the x-window size ``vectorCacheSize`` so that each partition's slice of the input
vector fits in the explicit cache.  On the GPU the cache is 93 KB of shared
memory (``kernel.h:23``); on TPU it is a VMEM-resident window, so the budget is
``EhybConfig.window_budget_bytes`` and alignment follows (sublane, lane) tiling
instead of the 1024-thread block size.

Differences from the reference (deliberate):
  * No ``kernelPerPart`` cooperative-block factor (``solver_test.c:57-66``) — a
    Pallas grid is already load-balanced over SELL slices, so small matrices do
    not need multiple blocks per partition.
  * The window may be larger than a partition: windows start at (aligned)
    partition boundaries and always span ``window_rows`` rows, padding x instead
    of clamping, which keeps every kernel shape static.

Port copy of ``ehyb_spmv_gpu_tpu/core/planner.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import EhybConfig, LANES, WINDOW_ALIGN, cdiv, round_up


@dataclasses.dataclass(frozen=True)
class Plan:
    """Planner output — the analog of the (nParts, vectorCacheSize,
    kernelPerPart) triple the reference readers compute."""

    dim: int
    n_parts: int
    #: x-window rows per partition (the VMEM "explicit cache" size); multiple of
    #: WINDOW_ALIGN.  Role of ``vectorCacheSize`` (``spmv.h:22``) — but int64,
    #: unlike the reference's int16 trap (see SURVEY.md appendix).
    window_rows: int
    #: Partition boundaries are rounded to this many rows so window starts stay
    #: tile-aligned for the x DMA.
    part_align: int
    #: Rows in the padded/reordered row space: ``padded_dim >= dim`` and every
    #: window [b_p, b_p + window_rows) stays in range.
    padded_dim: int

    @property
    def window_bytes(self) -> int:
        return self.window_rows * 4  # planner reasons in f32

    def describe(self) -> str:
        return (f"Plan(dim={self.dim}, nParts={self.n_parts}, "
                f"window={self.window_rows} rows = {self.window_bytes/1024:.0f} KiB)")


def make_plan(dim: int, config: EhybConfig) -> Plan:
    """Compute (n_parts, window_rows) from the VMEM budget.

    Mirrors the *intent* of ``solver_test.c:53-77``: grow the partition count
    until one partition's x slice fits the cache budget, keeping the window a
    multiple of the alignment quantum.
    """
    itemsize = np.dtype(config.dtype).itemsize
    budget_rows = max(WINDOW_ALIGN, config.window_budget_bytes // itemsize)
    budget_rows = (budget_rows // WINDOW_ALIGN) * WINDOW_ALIGN

    if config.window_rows is not None:
        window = int(config.window_rows)
        if window % WINDOW_ALIGN:
            raise ValueError(
                f"window_rows={window} not a multiple of {WINDOW_ALIGN}")
    else:
        window = min(budget_rows, round_up(dim, WINDOW_ALIGN))

    n_parts = max(config.min_parts, cdiv(dim, window))
    # Re-derive the window from the actual partition count so balanced METIS
    # partitions (± imbalance) still fit inside one window.
    if config.window_rows is None:
        per_part = cdiv(dim, n_parts)
        window = round_up(
            int(per_part * config.partition_imbalance) + LANES, WINDOW_ALIGN)
        window = min(window, round_up(dim, WINDOW_ALIGN))

    padded_dim = round_up(dim, LANES) + window  # slack so windows never clamp
    # Boundaries align to WINDOW_ALIGN so window starts land on whole x blocks
    # for the Pallas kernel's BlockSpec (block = WINDOW_ALIGN elements of x).
    return Plan(dim=dim, n_parts=n_parts, window_rows=window,
                part_align=WINDOW_ALIGN, padded_dim=padded_dim)
