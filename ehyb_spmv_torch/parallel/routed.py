"""Sharded routed SpMV — the gather-wall engine over ``torch.distributed``.

Port counterpart of ``ehyb_spmv_gpu_tpu/parallel/routed.py``.  The routed
pipeline shards by ROWS: each rank runs its own complete routed instance
over its row slice with x REPLICATED (a fully unstructured matrix touches
every window anyway, so a halo scheme would degenerate to an all-gather),
and the global y is the concatenation of the ranks' slices.  Here each rank
holds its R rows of x, gathers the whole x with one
``all_gather_into_tensor`` per apply, and runs the routed kernel
(``csrc/route_xcache.cu``, over the plan decoded from its shard's schedule
by ``ops/route_xcache.py``) once per column block, summing the blocks.

The geometry of each column block is pinned from shard 0, as in the JAX
package (its SPMD program needs uniform shapes; here it keeps the ranks'
schedules the JAX ones, shard for shard).  No size cliff: past the
single-level chain bound — which binds EARLIER sharded than on one device,
because r_sh < dim shrinks R and stretches the chain — the columns split
into vertical blocks like the single-device column-block mode.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EhybConfig, LANES, cdiv, round_up
from ..core.coo import MatrixCOO
from ..core.route import WIN, RoutedMatrix, _choose_params, build_routed
from ..models.base import SpmvModel
from ..models.routed import BLOCK_COLS, _block_ranges
from ..ops.route import RoutedApply
from ..utils.log import get_logger
from .comm import all_gather_rows, group_rank_world, rank_device

log = get_logger(__name__)


def build_sharded_routed(m: MatrixCOO, n_devices: int,
                         block_cols: Optional[int] = None,
                         shards: Optional[Sequence[int]] = None):
    """Per-(shard, column-block) routed builds with geometry pinned per
    block from shard 0.

    ``block_cols`` overrides the split width (tests force small blocks);
    ``shards`` limits the builds to those shards (shard 0 is always built:
    it pins the geometry).  Returns (list over blocks of ({shard:
    RoutedMatrix}, col_lo), rows_per_shard, padded x length)."""
    dim = m.dimension
    D = n_devices
    want = set(range(D) if shards is None else shards) | {0}
    r_sh = round_up(cdiv(dim, D), LANES)      # rows per shard
    row = np.asarray(m.row)
    col = np.asarray(m.col)
    val = np.asarray(m.val)
    order = np.argsort(row // r_sh, kind="stable")
    row, col, val = row[order], col[order], val[order]
    bounds = np.searchsorted(row // r_sh, np.arange(D + 1))

    bc = block_cols or BLOCK_COLS
    single = block_cols is None
    if single:
        try:
            _choose_params(r_sh, dim, max(
                int(np.max(np.diff(bounds), initial=1)), 1), None, None)
        except ValueError:
            single = False
    if single:
        ranges = [(0, dim)]
    else:
        ranges = _block_ranges(dim, bc)
        log.info("sharded routed: chain bound at rows/shard=%d dim=%d — "
                 "COLUMN-BLOCK mode, %d blocks of <=%d cols",
                 r_sh, dim, len(ranges), bc)

    nb = len(ranges)
    if nb > 1:
        # one bucketing pass over nnz: sort entries by (shard, block) once,
        # then every (d, i) sub-matrix is a slice
        shard_of = np.repeat(np.arange(D), np.diff(bounds))
        key = shard_of * nb + np.minimum(col // bc, nb - 1)
        order2 = np.argsort(key, kind="stable")
        row, col, val, key = row[order2], col[order2], val[order2], \
            key[order2]
        bounds_sb = np.searchsorted(key, np.arange(D * nb + 1))
        nnz_sb = np.diff(bounds_sb).reshape(D, nb)
    else:
        bounds_sb = bounds
        nnz_sb = np.diff(bounds).astype(np.int64).reshape(D, 1)

    blocks = []
    L = round_up(dim, WIN)
    for i, (lo_c, hi_c) in enumerate(ranges):
        nnz_sh = nnz_sb[:, i]
        if nb > 1 and int(nnz_sh.sum()) == 0 and len(blocks) + (
                nb - 1 - i) > 0:
            continue  # an empty block contributes nothing — skip it
        _, r0, p0 = _choose_params(
            r_sh, hi_c - lo_c, max(int(nnz_sh.max(initial=1)), 1),
            None, None)
        built: Dict[int, RoutedMatrix] = {}
        geo = None
        for d in range(D):
            if d not in want:
                continue
            lo, hi = (bounds_sb[d * nb + i], bounds_sb[d * nb + i + 1]) \
                if nb > 1 else (bounds[d], bounds[d + 1])
            sub = MatrixCOO(
                n_rows=r_sh, n_cols=hi_c - lo_c,
                row=(row[lo:hi] - d * r_sh).astype(np.int32),
                col=(col[lo:hi] - lo_c).astype(np.int32),
                val=val[lo:hi])
            if geo is None:
                rm = build_routed(sub, R=r0, P=p0, out_rows=r_sh)
                geo = ((rm.bands_per_block, rm.s_b), bool(rm.octet))
                # the build may round n_win up for alignment — size the
                # shared x from the realized geometry, not the chooser's
                L = max(L, lo_c + rm.n_win * WIN)
            else:
                rm = build_routed(sub, R=r0, P=p0, out_rows=r_sh,
                                  group_geometry=geo[0],
                                  octet_override=geo[1])
            built[d] = rm
        blocks.append((built, lo_c))
    return blocks, r_sh, L


class ShardedRoutedSpmv(SpmvModel):
    """One rank of the row-sharded routed SpMV: its own routed instance per
    column block over its rows, x gathered whole per apply, the ranks' y
    slices concatenated.  ``group`` and ``device`` as in
    :class:`~.spmv.ShardedEhybSpmv`."""

    name = "ehyb_routed_sharded"

    def __init__(self, config: Optional[EhybConfig] = None, *, group=None,
                 device=None):
        self.group, self.rank, self.n_dev = group_rank_world(group)
        super().__init__(config, device=rank_device(device, self.rank))
        self.loop = "eager"

    def setup(self, m: MatrixCOO,
              block_cols: Optional[int] = None) -> "ShardedRoutedSpmv":
        self.m = m
        self.setup_seconds = {}
        self.ehyb = None
        t0 = time.perf_counter()
        blocks, r_sh, L = build_sharded_routed(
            m, self.n_dev, block_cols=block_cols, shards=[self.rank])
        self.r_sh = r_sh
        #: Length of the gathered x: every block's windows and every rank's
        #: rows.
        self._x_rows = max(L, self.n_dev * r_sh)
        self.setup_seconds["convert"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        #: (schedule of this rank, column offset) per column block.
        self.blocks: List[Tuple[RoutedMatrix, int]] = [
            (built[self.rank], lo) for built, lo in blocks]
        self.applies = [RoutedApply.of(rm, self.device)
                        for rm, _ in self.blocks]
        self.routed = self.blocks[0][0]
        self.x_full = torch.zeros(self._x_rows, dtype=torch.float32,
                                  device=self.device)
        self.setup_seconds["route_plan"] = time.perf_counter() - t1
        self.setup_seconds["total"] = time.perf_counter() - t0
        self.loop = ("graph" if self.device.type == "cuda"
                     and self.n_dev == 1 else "eager")
        log.info("%s rank %d/%d ready on %s: rows/shard=%d blocks=%d "
                 "spill=%d", self.name, self.rank, self.n_dev, self.device,
                 r_sh, len(self.blocks),
                 sum(rm.stats.get("nnz_spill", 0) for rm, _ in self.blocks))
        return self

    def prepare_x(self, x: np.ndarray) -> torch.Tensor:
        """Host x → this rank's r_sh rows of it."""
        xp = np.zeros(self.n_dev * self.r_sh, dtype=np.float32)
        xp[: self.m.dimension] = np.asarray(x, dtype=np.float32)
        lo = self.rank * self.r_sh
        return torch.as_tensor(xp[lo:lo + self.r_sh], device=self.device)

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        y_all = all_gather_rows(self.group, self.n_dev, y)
        return y_all.detach().cpu().numpy().astype(
            np.float64)[: self.m.n_rows]

    def gather_x(self, x_local: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of x into ``x_full`` (one all-gather; a copy
        in a world of one rank)."""
        n = self.n_dev * self.r_sh
        self.x_full[:n].copy_(all_gather_rows(self.group, self.n_dev,
                                              x_local))
        return self.x_full

    @torch.no_grad()
    def apply(self, x_dev: torch.Tensor) -> torch.Tensor:
        """This rank's r_sh rows of y: the routed kernel of every column
        block over its slice of the gathered x, summed."""
        x_full = self.gather_x(x_dev)
        y = None
        for ap, (_, lo) in zip(self.applies, self.blocks):
            xs = (x_full if len(self.applies) == 1
                  else x_full[lo:lo + ap.d.padded_x_rows])
            yb = ap(xs)
            y = yb if y is None else y + yb
        return y

    @torch.no_grad()
    def iterate(self, x_dev, n_iters: int, eps: float = 0.0) -> torch.Tensor:
        if self.loop == "eager":
            return self.iterate_eager(x_dev, n_iters, eps)
        return super().iterate(x_dev, n_iters, eps)

    def roofline_phases(self) -> dict:
        """(flops, device-memory bytes) per apply of this rank: each block's
        plan (entries, maps, its x and y once) and the gathered x written
        once."""
        nnz = sum(rm.stats.get("nnz", 0) for rm, _ in self.blocks)
        return {"routed": (2 * nnz, sum(
            ap.plan.stats["layout_bytes"] for ap in self.applies)),
            "x gather": (0, self._x_rows * 4)}
