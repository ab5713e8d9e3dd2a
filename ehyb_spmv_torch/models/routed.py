"""RoutedSpmv — the product-routing model for the gather-wall regime.

Port counterpart of ``ehyb_spmv_gpu_tpu/models/routed.py``.  It covers the
matrices where the EHYB window machinery has nothing to cache (fully
unstructured sparsity, e.g. random_1m): the schedule of ``core/route.py``
runs through the two kernels of ``ops/route.py`` (K7: gather-multiply into
band-major products; K8: route and reduce) plus a torch spill tail.

Beyond the single-level router's select-chain bound (~2M columns at
16 nnz/row) the model switches to COLUMN-BLOCK mode: the matrix splits into
1M-column vertical blocks, each block runs its own routed instance, and the
blocks' input-space outputs sum.

The engine exists because the TPU has no hardware gather from HBM; the H100
has one, and whether the routed engine pays there at all is measured beside
one cuSPARSE matvec by ``chip_smoke.py`` (ROADMAP Queue 1 item 12).  Scope:
f32 values, square matrices, one device.  A CUDA device runs the kernels; a
CPU device runs their plain versions.
"""
from __future__ import annotations

import ast
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import LANES, cdiv, round_up
from ..core.coo import MatrixCOO
from ..core.route import (WIN, RoutedMatrix, _choose_params, build_routed,
                          routed_row_perm)
from ..ops.route import RoutedApply
from ..utils.log import get_logger
from .base import SpmvModel

log = get_logger(__name__)

#: Bump on any route-builder semantic change (the JAX package's version: both
#: builders emit the same schedule).
ROUTE_FORMAT_VERSION = 11

#: Column width of one block in block mode (chain stays <= 16 regardless of
#: dimension; per-block R scales to keep the A cells ~half full).
BLOCK_COLS = 1 << 20


def _cache_path(m: MatrixCOO, cache_dir: Optional[str],
                block: str = "") -> str:
    from ..core.cache import DEFAULT_CACHE_DIR, matrix_fingerprint

    d = cache_dir or DEFAULT_CACHE_DIR
    # experiment env knobs change the built schedule — key them so an A/B
    # run never loads the other arm's artifact
    env = ""
    for var, tag in (("EHYB_ROUTE_SB_MAX", "sb"), ("EHYB_ROUTE_OCTET", "oc"),
                     ("EHYB_ROUTE_BANDS_MAX", "bm")):
        v = os.environ.get(var, "")
        if v:
            env += f"-{tag}{v}"
    return os.path.join(
        d,
        f"{matrix_fingerprint(m)}-route{ROUTE_FORMAT_VERSION}{env}{block}"
        ".npz")


_ARRAY_FIELDS = ("a_col", "a_val", "a_win", "b_idx", "b_gmap", "b_boff",
                 "b_reset", "b_last", "sp_dst", "sp_col", "sp_val",
                 "dst_rows")
_SCALAR_FIELDS = ("dim", "n_win", "P", "R", "n_bands", "n_bg",
                  "bands_per_block", "s_b", "out_rows", "octet",
                  "a_real_steps")


def _save_routed(rm: RoutedMatrix, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    np.savez(tmp, **{f: getattr(rm, f) for f in _ARRAY_FIELDS},
             **{f: np.int64(getattr(rm, f)) for f in _SCALAR_FIELDS},
             stats=np.array([repr(rm.stats)], dtype=object))
    os.replace(tmp + ".npz", path)
    log.info("cached routed artifacts → %s", path)


def _load_routed(path: str) -> Optional[RoutedMatrix]:
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path, allow_pickle=True)
        stats = ast.literal_eval(str(z["stats"][0]))
        rm = RoutedMatrix(
            **{f: int(z[f]) for f in _SCALAR_FIELDS},
            **{f: z[f] for f in _ARRAY_FIELDS}, stats=stats)
        log.info("loaded cached routed artifacts ← %s", path)
        return rm
    except Exception as exc:
        log.warning("routed cache load failed (%s); rebuilding", exc)
        return None


def _block_ranges(dim: int, block_cols: int = None) -> List[tuple]:
    """Column ranges [(lo, hi), ...] of the vertical blocks."""
    bc = block_cols or BLOCK_COLS
    n_blocks = cdiv(dim, bc)
    return [(b * bc, min((b + 1) * bc, dim)) for b in range(n_blocks)]


class RoutedSpmv(SpmvModel):
    """Routed SpMV (gather-multiply + band-major write → route-reduce),
    column-blocked past the single-level chain bound.

    ``external_order=True`` skips the internal dst row permutation and
    builds identity-dst on the row order AS GIVEN — for composers (the
    degree-split hybrid) whose engines share one vector space and do their
    own ordering.
    """

    name = "ehyb_routed"

    def __init__(self, config=None, external_order: bool = False, *,
                 device="cuda"):
        super().__init__(config, device=device)
        self._external_order = external_order

    def setup(self, m: MatrixCOO) -> "RoutedSpmv":
        self.m = m
        self.setup_seconds = {}
        self.ehyb = None  # no EHYB stats container: callers use bytes_model()
        dim = m.dimension
        try:
            _choose_params(dim, dim, m.nnz, None, None)
            single = True
        except ValueError:
            single = False
        if single:
            self._setup_blocks(m, [(0, dim)])
        else:
            ranges = _block_ranges(dim)
            log.info("routed: chain bound exceeded at dim=%d — COLUMN-BLOCK "
                     "mode, %d blocks of <=%d cols", dim, len(ranges),
                     BLOCK_COLS)
            self._setup_blocks(m, ranges)
        log.info("%s ready on %s: setup %s", self.name, self.device,
                 {k: round(v, 2) for k, v in self.setup_seconds.items()})
        return self

    def _setup_blocks(self, m: MatrixCOO, ranges: List[tuple]) -> None:
        cfg = self.config
        t0 = time.perf_counter()
        dim = m.dimension
        n_blocks = len(ranges)
        # artifact cache keys stay on the matrix AS GIVEN (the permuted
        # build is a deterministic function of it)
        self._cache_m = m

        # ---- pre-permute by the dst row order (identity-dst build) --------
        # The engine's dst space becomes the model's input space: x is
        # permuted once on the host (prepare_x) and the per-iteration output
        # epilogue is a slice instead of an element scatter.  Rows and
        # columns permute together (y' = P·A·Pᵀ·x'), so solvers chain in the
        # permuted space like the EHYB models chain in theirs.
        if self._external_order:
            self._perm = np.arange(dim, dtype=np.int64)
            self._r_shared = None
            self._setup_blocks_inner(m, ranges, t0)
            return
        perm_path = (_cache_path(m, cfg.cache_dir, "-perm")
                     if cfg.artifact_cache else None)
        self._perm = None
        if perm_path is not None and os.path.exists(perm_path):
            try:
                z = np.load(perm_path)
                self._perm, r_shared = z["perm"], int(z["R"])
            except Exception as exc:  # pragma: no cover - corrupt cache
                log.warning("perm cache load failed (%s); rebuilding", exc)
        if self._perm is None:
            # shared row-band size: every block's bands must match the one
            # global perm, so pin the most conservative per-block choice
            r_shared = None
            col0 = np.asarray(m.col)
            for lo, hi in ranges:
                sel_n = (int(((col0 >= lo) & (col0 < hi)).sum())
                         if n_blocks > 1 else m.nnz)
                _, r_i, _ = _choose_params(m.n_rows, hi - lo, sel_n,
                                           None, None)
                r_shared = r_i if r_shared is None else min(r_shared, r_i)
            self._perm = routed_row_perm(m.row, dim, r_shared)[:dim]
            if perm_path is not None:
                os.makedirs(os.path.dirname(perm_path), exist_ok=True)
                tmp = perm_path + f".tmp{os.getpid()}"
                np.savez(tmp, perm=self._perm, R=np.int64(r_shared))
                os.replace(tmp + ".npz", perm_path)
        self._r_shared = r_shared
        inv = np.empty(dim, dtype=np.int64)
        inv[self._perm] = np.arange(dim)
        m = MatrixCOO(m.n_rows, m.n_cols,
                      inv[np.asarray(m.row, dtype=np.int64)],
                      inv[np.asarray(m.col, dtype=np.int64)],
                      np.asarray(m.val))
        self._setup_blocks_inner(m, ranges, t0)

    def _setup_blocks_inner(self, m: MatrixCOO, ranges: List[tuple],
                            t0: float) -> None:
        cfg = self.config
        dim = m.dimension
        n_blocks = len(ranges)
        col = np.asarray(m.col)
        if n_blocks > 1:
            # The shared in/out vector length must cover every block's
            # padded window span (the chooser may round a block's n_win up
            # for the n_win*P % 1024 alignment) — precompute each block's
            # geometry to size it, and pin the same (R, P) at build time.
            los = np.array([lo for lo, _ in ranges])
            nnz_b = np.bincount(
                np.searchsorted(los, col, side="right") - 1,
                minlength=n_blocks)
            geo = []
            L = round_up(dim, WIN)
            for i, (lo, hi) in enumerate(ranges):
                n_win_i, r_i, p_i = _choose_params(
                    m.n_rows, hi - lo, int(nnz_b[i]), self._r_shared, None)
                geo.append((r_i, p_i))
                L = max(L, lo + n_win_i * WIN)
            self._x_rows = L
            out_rows = L
        else:
            geo = [(self._r_shared, None)]
            self._x_rows = None
            out_rows = None  # builder default (square case)
        self.blocks: List[RoutedMatrix] = []
        self.applies: List[RoutedApply] = []
        self._lo = []
        convert_s = upload_s = 0.0
        ext = "-ext" if self._external_order else ""
        for i, (lo, hi) in enumerate(ranges):
            tag = ext + (f"-b{i}of{n_blocks}" if n_blocks > 1 else "")
            path = _cache_path(self._cache_m, cfg.cache_dir, tag)
            rm = _load_routed(path) if cfg.artifact_cache else None
            if rm is None:
                t1 = time.perf_counter()
                if n_blocks > 1:
                    sel = (col >= lo) & (col < hi)
                    sub = MatrixCOO(
                        n_rows=m.n_rows, n_cols=hi - lo,
                        row=np.asarray(m.row)[sel],
                        col=col[sel] - lo,
                        val=np.asarray(m.val)[sel])
                    rm = build_routed(sub, R=geo[i][0], P=geo[i][1],
                                      out_rows=out_rows, identity_dst=True)
                else:
                    rm = build_routed(m, R=geo[i][0], out_rows=out_rows,
                                      identity_dst=True)
                convert_s += time.perf_counter() - t1
                if cfg.artifact_cache:
                    _save_routed(rm, path)
            t2 = time.perf_counter()
            self.blocks.append(rm)
            self.applies.append(RoutedApply(
                rm.to_torch(dtype="float32", device=self.device)))
            self._lo.append(lo)
            upload_s += time.perf_counter() - t2
        if convert_s:
            self.setup_seconds["convert"] = convert_s
        else:
            self.setup_seconds["cache_load"] = time.perf_counter() - t0
        self.setup_seconds["upload"] = upload_s
        self.routed = self.blocks[0]   # introspection convenience
        self.setup_seconds["total"] = time.perf_counter() - t0

    @property
    def _padded_x_rows(self) -> int:
        return (self._x_rows if self._x_rows is not None
                else self.blocks[0].padded_x_rows)

    def prepare_x(self, x: np.ndarray) -> torch.Tensor:
        # into the engine's (dst-ordered) space — host-side, once, outside
        # the timed region, like the EHYB models' vector_reorder
        xp = np.zeros(self._padded_x_rows, dtype=np.float32)
        xp[: self.m.dimension] = np.asarray(x, dtype=np.float32)[self._perm]
        return torch.as_tensor(xp, device=self.device)

    def recover_y(self, y: torch.Tensor) -> np.ndarray:
        # apply returns dst-space y == the permuted input space: un-permute
        # on the host (reordering.c:386-391 recovers the same way)
        out = np.empty(self.m.n_rows, dtype=np.float64)
        out[self._perm] = y.detach().cpu().numpy().astype(
            np.float64)[: self.m.n_rows]
        return out

    def bytes_model(self) -> int:
        """Modeled device-memory bytes per iteration (roofline denominator):
        the A stream (2 + 4 B per slot), the product array written by K7 and
        read by K8, the B index stream, the y stream, the spill tail and x —
        the JAX package's model, so both report the same denominator.
        """
        total = self._padded_x_rows * (4 + 8 * len(self.blocks))
        for rm in self.blocks:
            a_slots = rm.a_col.shape[0] * LANES
            b_slots = rm.b_idx.shape[0] * LANES
            prod = rm.n_bg * LANES * rm.group_rows * LANES * 4
            total += int(a_slots * (2 + 4)     # a_col + a_val
                         + prod                # fused A+T product write
                         + prod                # B block reads (1x per group)
                         + b_slots * 2         # b_idx
                         # y stream: every row (octet) vs one row/sub-tile
                         + (b_slots * 4 if rm.octet else b_slots // 8 * 4)
                         + rm.sp_val.size * 12)  # spill tail
        return total

    @torch.no_grad()
    def apply(self, x_dev: torch.Tensor) -> torch.Tensor:
        """One SpMV in the permuted input space; column blocks each read
        their own slice of x and their outputs sum."""
        y = None
        for ap, lo in zip(self.applies, self._lo):
            xs = (x_dev if len(self.applies) == 1
                  else x_dev[lo:lo + ap.d.padded_x_rows])
            yb = ap(xs)
            y = yb if y is None else y + yb
        return y
