"""Disk cache for converted EHYB artifacts.

The reference rebuilds partition+reorder+convert from the ``.mtx`` on every run
(``spmv.cu:73``; SURVEY.md §5 flags this as a gap).  Here the expensive host
preprocessing is cached: keyed by a hash of the matrix structure + the planner
configuration, stored as ``.npz`` next to a small metadata file.

Port copy of ``ehyb_spmv_gpu_tpu/core/cache.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..config import EhybConfig
from ..core.coo import MatrixCOO
from ..core.ehyb import EhybMatrix
from ..core.reorder import Reordering
from ..utils.log import get_logger

log = get_logger(__name__)

#: The port's own namespace: artifacts are shareable in principle, but gate
#: verdicts are hardware measurements and must never cross backends.
DEFAULT_CACHE_DIR = os.environ.get(
    "EHYB_TORCH_CACHE_DIR",
    os.path.join(os.path.expanduser("~"), ".cache", "ehyb_torch"))


#: Entries sampled per array by the fingerprint.  Full-array SHA-256 pushed
#: ~1.8 GB through the hash on audikw-class matrices (~10 s of every cached
#: setup); a strided sample plus head/tail blocks catches any
#: realistic edit to the matrix (changed dims/nnz, permuted or re-valued
#: entries at sampled positions) at microsecond cost.  The cache is advisory:
#: a missed difference yields a wrong artifact only if two *different*
#: matrices agree on dims, nnz, and every sampled coordinate and value.
_FP_SAMPLE = 65536


def matrix_fingerprint(m: MatrixCOO) -> str:
    """Structural+numeric hash of a COO matrix (order-sensitive by design: the
    pipeline consumes the matrix as given).  Sampled: dims + nnz + a strided
    sample of (row, col, val) + head/tail blocks."""
    h = hashlib.sha256()
    h.update(np.int64([m.n_rows, m.n_cols, m.nnz]).tobytes())
    stride = max(1, m.nnz // _FP_SAMPLE)
    for a, dt in ((m.row, np.int64), (m.col, np.int64), (m.val, np.float64)):
        a = np.asarray(a)
        h.update(np.ascontiguousarray(a[::stride][:_FP_SAMPLE],
                                      dtype=dt).tobytes())
        h.update(np.ascontiguousarray(a[-256:], dtype=dt).tobytes())
    return h.hexdigest()[:24]


#: Bump on ANY converter/reorderer semantic change — cached artifacts encode
#: the conversion algorithm, not just its inputs.
FORMAT_VERSION = 8  # 8: native greedy relaxed packer (step assignments and
# so the packed rx body differ from the round election's);
# 7: partition-futility gate gained the rcm-vs-natural
# discriminator (large scrambled stencils pick partition orderings again);
# 6: big streamed variants lift the SMEM gate (the
# relax/quad auto decisions baked into cached artifacts changed)


def config_fingerprint(cfg: EhybConfig) -> str:
    payload = json.dumps({
        "format_version": FORMAT_VERSION,
        "dtype": cfg.dtype, "index_dtype": cfg.index_dtype,
        "window_budget": cfg.window_budget_bytes, "window_rows": cfg.window_rows,
        "min_parts": cfg.min_parts, "slice_rows": cfg.slice_rows,
        "width_align": cfg.width_align, "long_row": cfg.long_row_threshold,
        "er_slice_rows": cfg.er_slice_rows,
        "features": (cfg.features.reorder, cfg.features.cache,
                     cfg.features.block, cfg.features.sort_rows,
                     cfg.features.sort_mode, cfg.features.dia),
        "partitioner": cfg.partitioner, "imbalance": cfg.partition_imbalance,
        "body_layout": cfg.body_layout, "ordering": cfg.ordering,
        "min_window_group_nnz": cfg.min_window_group_nnz,
        "windows_per_subtile": getattr(cfg, "windows_per_subtile", 2),
        "sliding_windows": bool(cfg.sliding_windows),
        "dia": (cfg.dia_threshold, cfg.max_diagonals),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def cache_paths(m: MatrixCOO, cfg: EhybConfig,
                cache_dir: Optional[str] = None) -> Tuple[str, str]:
    d = cache_dir or DEFAULT_CACHE_DIR
    key = f"{matrix_fingerprint(m)}-{config_fingerprint(cfg)}"
    return (os.path.join(d, f"{key}.ehyb.npz"),
            os.path.join(d, f"{key}.reorder.npz"))


def save_artifacts(m: MatrixCOO, cfg: EhybConfig, e: EhybMatrix,
                   r: Reordering, cache_dir: Optional[str] = None) -> None:
    ehyb_path, reorder_path = cache_paths(m, cfg, cache_dir)
    os.makedirs(os.path.dirname(ehyb_path), exist_ok=True)
    e.save_npz(ehyb_path)
    np.savez_compressed(reorder_path, new_to_old=r.new_to_old,
                        old_to_new=r.old_to_new, boundaries=r.boundaries)
    log.info("cached EHYB artifacts → %s", ehyb_path)


def load_artifacts(m: MatrixCOO, cfg: EhybConfig,
                   cache_dir: Optional[str] = None
                   ) -> Optional[Tuple[EhybMatrix, Reordering]]:
    ehyb_path, reorder_path = cache_paths(m, cfg, cache_dir)
    if not (os.path.exists(ehyb_path) and os.path.exists(reorder_path)):
        return None
    try:
        e = EhybMatrix.load_npz(ehyb_path)
        z = np.load(reorder_path)
        r = Reordering(new_to_old=z["new_to_old"], old_to_new=z["old_to_new"],
                       boundaries=z["boundaries"])
        log.info("loaded cached EHYB artifacts ← %s", ehyb_path)
        return e, r
    except Exception as exc:  # corrupted cache: rebuild
        log.warning("cache load failed (%s); rebuilding", exc)
        return None
