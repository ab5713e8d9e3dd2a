"""Graph partitioning front-end.

Role of the reference's mt-metis invocation (``MTMETIS_PartGraphKway`` called at
``reordering.c:126-139`` and ``reordering.c:280-293``): given the symmetrized
adjacency structure of the matrix, produce a per-row partition label such that
each partition's rows are tightly coupled (minimizing out-of-window entries, the
TPU analog of the edge cut minimizing ER size).

Backends:
  * ``native``  — the framework's own C++ multilevel k-way partitioner
    (``native/partition.cpp``, loaded via ctypes) — the mt-metis replacement.
  * ``blocks``  — contiguous equal chunks in the current ordering (correct for
    already-banded matrices; the always-available fallback).
  * ``auto``    — native if the shared library is available, else blocks.

Correctness never depends on partition quality — only the ELL/ER split (and thus
performance) does, exactly as in the reference.

Port copy of ``ehyb_spmv_gpu_tpu/partition.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from .core.coo import MatrixCOO
from .utils.log import get_logger

log = get_logger(__name__)


def adjacency_csr(m: MatrixCOO):
    """Symmetrized CSR adjacency (A ∪ Aᵀ pattern, self-loops removed) — what the
    reference feeds METIS (built inline for the unsym path at
    ``reordering.c:50-89``; the sym path passes the matrix pattern directly).

    Runs native by default (``native/rcm.cpp::ehyb_adjacency``, bit-identical
    output): the fused-key NumPy sort below costs ~70 s at 84M nnz where the
    counting-sort C++ pass is ~5 s.  ``EHYB_NATIVE_ADJ=0`` or a missing
    toolchain falls back."""
    dim = m.dimension
    if os.environ.get("EHYB_NATIVE_ADJ", "1") != "0":
        try:
            from .native import adjacency_native

            return adjacency_native(m.row, m.col, dim)
        except Exception as exc:              # pragma: no cover - no g++
            log.warning("native adjacency unavailable (%s); NumPy fallback",
                        exc)
    row = np.concatenate([m.row, m.col]).astype(np.int64)
    col = np.concatenate([m.col, m.row]).astype(np.int64)
    off = row != col
    row, col = row[off], col[off]
    # Single fused-key sort + dedupe: a two-key lexsort costs ~70 s on an
    # audikw-scale edge list; one int64 radix-ish sort is ~4x cheaper.
    key = row * dim + col
    key = np.sort(key, kind="stable")
    if key.size:
        keep = np.empty(key.size, dtype=bool)
        keep[0] = True
        np.not_equal(key[1:], key[:-1], out=keep[1:])
        key = key[keep]
    row, col = key // dim, key % dim
    xadj = np.zeros(dim + 1, dtype=np.int32)
    np.cumsum(np.bincount(row, minlength=dim), out=xadj[1:])
    return xadj, col.astype(np.int32)


def partition_blocks(dim: int, n_parts: int) -> np.ndarray:
    """Contiguous-chunk fallback: label = row * n_parts // dim."""
    return (np.arange(dim, dtype=np.int64) * n_parts // max(dim, 1)).astype(np.int32)


def partition_rows(m: MatrixCOO, n_parts: int, method: str = "auto",
                   imbalance: float = 1.03, seed: int = 0,
                   adj=None) -> np.ndarray:
    """Return per-row partition labels in [0, n_parts).

    ``adj``: optional precomputed ``adjacency_csr(m)`` pair — the ordering
    auto-selector builds it once and shares it across RCM + the partitioner
    (it is an O(nnz log nnz) sort, the order phase's largest single cost).
    """
    dim = m.dimension
    if n_parts <= 1:
        return np.zeros(dim, dtype=np.int32)
    if method == "blocks":
        return partition_blocks(dim, n_parts)
    if method in ("auto", "native"):
        try:
            from .native import kway_partition_native
            xadj, adjncy = adj if adj is not None else adjacency_csr(m)
            t0 = time.perf_counter()
            labels = kway_partition_native(xadj, adjncy, n_parts,
                                           imbalance=imbalance, seed=seed)
            log.info("native k-way partition: %d parts in %.1f ms (edgecut path)",
                     n_parts, 1e3 * (time.perf_counter() - t0))
            return labels
        except Exception as e:  # pragma: no cover - env dependent
            if method == "native":
                raise
            log.warning("native partitioner unavailable (%s); "
                        "falling back to contiguous blocks", e)
            return partition_blocks(dim, n_parts)
    raise ValueError(f"unknown partition method {method!r}")


def edge_cut(m: MatrixCOO, labels: np.ndarray) -> int:
    """Number of (undirected) pattern edges crossing partitions — the quality
    metric mt-metis reports (``r_edgecut``, ``reordering.c:136``)."""
    xadj, adjncy = adjacency_csr(m)
    dim = m.dimension
    row = np.repeat(np.arange(dim), np.diff(xadj))
    cross = labels[row] != labels[adjncy]
    return int(cross.sum()) // 2
