"""Native (C++) host components, loaded via ctypes.

Port counterpart of ``ehyb_spmv_gpu_tpu/native/__init__.py``.  The C++
sources are the port's own copies of the JAX package's (``partition.cpp``,
``rcm.cpp``, ``diaextract.cpp``, ``mtxparse.cpp``, ``routecolor.cpp``, in
this directory), so both packages pack byte-identical artifacts while the
port compiles nothing of the JAX package; a tier-1 test holds the copies'
code equal to the originals.  Libraries are built with ``g++`` on first use
into ``ehyb_spmv_torch/build/`` under names of their own.  Each build writes
a temporary file and renames it into place, so concurrent processes (test
workers) never load a half-written library.

Bound entry points: the k-way partitioner, RCM + adjacency, the DIA
extractor, the ``.mtx`` entry parser, the relaxed body packer and the
routing engine's three edge colorers.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The port's own C++ sources (copies of the JAX package's).
SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "build")
_lock = threading.Lock()
_libs = {}


class NativeCompileError(RuntimeError):
    pass


def _compile(stem: str, force: bool = False) -> str:
    """Compile ``SRC_DIR/<stem>.cpp`` → ``BUILD_DIR/libehybtorch_<stem>.so``
    (cached by mtime)."""
    src = os.path.join(SRC_DIR, f"{stem}.cpp")
    lib = os.path.join(BUILD_DIR, f"libehybtorch_{stem}.so")
    if not os.path.exists(src):
        raise NativeCompileError(f"C++ source not found: {src}")
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
               "-fPIC", "-std=c++17", "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeCompileError(
                f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load(stem: str, bind) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(_compile(stem))
            bind(lib)
            _libs[stem] = lib
        return lib


def _i32():
    return np.ctypeslib.ndpointer(np.int32, flags="C")


def _i64():
    return np.ctypeslib.ndpointer(np.int64, flags="C")


def _i16():
    return np.ctypeslib.ndpointer(np.int16, flags="C")


def _f64():
    return np.ctypeslib.ndpointer(np.float64, flags="C")


# ---------------------------------------------------------------------------
# k-way partitioner (partition.cpp).
# ---------------------------------------------------------------------------

def _bind_partition(lib):
    lib.ehyb_partition_kway.restype = ctypes.c_longlong
    lib.ehyb_partition_kway.argtypes = [
        ctypes.c_int, _i32(), _i32(), ctypes.c_int, ctypes.c_double,
        ctypes.c_int, _i32()]


def kway_partition_native(xadj: np.ndarray, adjncy: np.ndarray, n_parts: int,
                          imbalance: float = 1.03, seed: int = 0) -> np.ndarray:
    """k-way partition labels via the C++ partitioner.  Returns int32 [n]."""
    lib = _load("partition", _bind_partition)
    xadj = np.ascontiguousarray(xadj, dtype=np.int32)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int32)
    n = xadj.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    cut = lib.ehyb_partition_kway(n, xadj, adjncy, int(n_parts),
                                  float(imbalance), int(seed), out)
    if cut < 0:
        raise RuntimeError(f"native partitioner failed (code {cut})")
    return out


# ---------------------------------------------------------------------------
# Relaxed SELL-body packer and the routing colorers (routecolor.cpp).
# ---------------------------------------------------------------------------

def _bind_color(lib):
    lib.ehyb_pack_relaxed.restype = ctypes.c_longlong
    lib.ehyb_pack_relaxed.argtypes = [
        ctypes.c_longlong, _i64(), _i16(), _i16(), _i16(), _i64(), _i32()]
    lib.ehyb_color_edges.restype = ctypes.c_longlong
    lib.ehyb_color_edges.argtypes = [
        ctypes.c_longlong, _i32(), _i16(), _i16(), _i64(), ctypes.c_int,
        ctypes.c_int, _i32()]
    lib.ehyb_color_edges_cls.restype = ctypes.c_longlong
    lib.ehyb_color_edges_cls.argtypes = [
        ctypes.c_longlong, _i32(), _i16(), _i16(), _i16(), _i64(),
        ctypes.c_int, ctypes.c_int, _i32()]
    lib.ehyb_color_edges_cls_bal.restype = ctypes.c_longlong
    lib.ehyb_color_edges_cls_bal.argtypes = [
        ctypes.c_longlong, _i32(), _i16(), _i16(), _i16(), _i32(), _i32(),
        _i16(), _i64(), ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32()]


def pack_relaxed_native(pair: np.ndarray, lane: np.ndarray, slot: np.ndarray,
                        cls: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Relaxed SELL-body step assignment (class-aware greedy).  ``order``
    must be grouped by pair.  Returns int64 per-entry step within its pair."""
    lib = _load("routecolor", _bind_color)
    n = pair.shape[0]
    pair = np.ascontiguousarray(pair, dtype=np.int64)
    lane = np.ascontiguousarray(lane, dtype=np.int16)
    slot = np.ascontiguousarray(slot, dtype=np.int16)
    cls = np.ascontiguousarray(cls, dtype=np.int16)
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    rc = lib.ehyb_pack_relaxed(n, pair, lane, slot, cls, order, out)
    if rc < 0:
        raise RuntimeError(f"native relaxed packer failed (code {rc})")
    return out.astype(np.int64)


def color_edges_cls_bal_native(pair: np.ndarray, lane: np.ndarray,
                               slot: np.ndarray, cls: np.ndarray,
                               win: np.ndarray, dslice: np.ndarray,
                               perm: np.ndarray, order: np.ndarray,
                               n_pairs: int, n_dslices: int,
                               P: int) -> np.ndarray:
    """Stage-A class-aware coloring with B-side slot balancing.  Returns
    int32 stripe (pre-scramble) per edge; -1 = spill."""
    lib = _load("routecolor", _bind_color)
    n = pair.shape[0]
    out = np.empty(n, dtype=np.int32)
    spilled = lib.ehyb_color_edges_cls_bal(
        n, np.ascontiguousarray(pair, dtype=np.int32),
        np.ascontiguousarray(lane, dtype=np.int16),
        np.ascontiguousarray(slot, dtype=np.int16),
        np.ascontiguousarray(cls, dtype=np.int16),
        np.ascontiguousarray(win, dtype=np.int32),
        np.ascontiguousarray(dslice, dtype=np.int32),
        np.ascontiguousarray(perm, dtype=np.int16),
        np.ascontiguousarray(order, dtype=np.int64),
        int(n_pairs), int(n_dslices), int(P), out)
    if spilled < 0:
        raise RuntimeError(f"native bal colorer failed (code {spilled})")
    return out


def color_edges_cls_native(pair: np.ndarray, lane: np.ndarray,
                           slot: np.ndarray, cls: np.ndarray,
                           order: np.ndarray, n_pairs: int,
                           max_colors: int) -> np.ndarray:
    """Class-aware greedy edge coloring (routing stage A): slot conflicts
    count only when the class differs.  Returns int32 colors per edge; -1 =
    spill."""
    lib = _load("routecolor", _bind_color)
    n = pair.shape[0]
    out = np.empty(n, dtype=np.int32)
    spilled = lib.ehyb_color_edges_cls(
        n, np.ascontiguousarray(pair, dtype=np.int32),
        np.ascontiguousarray(lane, dtype=np.int16),
        np.ascontiguousarray(slot, dtype=np.int16),
        np.ascontiguousarray(cls, dtype=np.int16),
        np.ascontiguousarray(order, dtype=np.int64),
        int(n_pairs), int(max_colors), out)
    if spilled < 0:
        raise RuntimeError(f"native class colorer failed (code {spilled})")
    return out


def color_edges_native(pair: np.ndarray, lane: np.ndarray, slot: np.ndarray,
                       order: np.ndarray, n_pairs: int,
                       max_colors: int = 64) -> np.ndarray:
    """Greedy lowest-free-color bipartite edge coloring (routing stage B).
    Returns int32 colors per edge; -1 marks spilled edges (no free color
    under ``max_colors`` at both endpoints)."""
    lib = _load("routecolor", _bind_color)
    n = pair.shape[0]
    out = np.empty(n, dtype=np.int32)
    spilled = lib.ehyb_color_edges(
        n, np.ascontiguousarray(pair, dtype=np.int32),
        np.ascontiguousarray(lane, dtype=np.int16),
        np.ascontiguousarray(slot, dtype=np.int16),
        np.ascontiguousarray(order, dtype=np.int64),
        int(n_pairs), int(max_colors), out)
    if spilled < 0:
        raise RuntimeError(f"native edge colorer failed (code {spilled})")
    return out


# ---------------------------------------------------------------------------
# DIA extractor (diaextract.cpp).
# ---------------------------------------------------------------------------

def _bind_dia(lib):
    lib.ehyb_dia_count.restype = ctypes.c_longlong
    lib.ehyb_dia_count.argtypes = [
        ctypes.c_longlong, _i64(), _i64(), ctypes.c_longlong,
        ctypes.c_longlong, _i64()]
    lib.ehyb_dia_fill.restype = ctypes.c_longlong
    lib.ehyb_dia_fill.argtypes = [
        ctypes.c_longlong, _i64(), _i64(), _f64(), ctypes.c_longlong,
        ctypes.c_longlong, _i32(), ctypes.c_longlong, _f64(),
        np.ctypeslib.ndpointer(np.uint8, flags="C")]


def dia_count_native(row: np.ndarray, col: np.ndarray, lo: int,
                     hi: int) -> np.ndarray:
    """Per-offset entry counts over the band [lo, hi]; counts[d - lo] is the
    number of entries with col - row == d."""
    lib = _load("diaextract", _bind_dia)
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    counts = np.zeros(hi - lo + 1, dtype=np.int64)
    rc = lib.ehyb_dia_count(row.shape[0], row, col, int(lo), int(hi), counts)
    if rc < 0:
        raise RuntimeError(f"native dia count failed (code {rc})")
    return counts


def dia_fill_native(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                    lo: int, hi: int, off_rank: np.ndarray, dim_r: int,
                    k: int):
    """Scatter-add in-band entries into the (k, dim_r) dense diagonal block.
    Accumulates f64; returns (dia, keep_mask)."""
    lib = _load("diaextract", _bind_dia)
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float64)
    off_rank = np.ascontiguousarray(off_rank, dtype=np.int32)
    dia = np.zeros(max(k, 1) * dim_r, dtype=np.float64)
    keep = np.empty(row.shape[0], dtype=np.uint8)
    kept = lib.ehyb_dia_fill(row.shape[0], row, col, val, int(lo), int(hi),
                             off_rank, int(dim_r), dia, keep)
    if kept < 0:
        raise RuntimeError(f"native dia fill failed (code {kept})")
    return dia[:k * dim_r].reshape(k, dim_r), keep.view(bool)


# ---------------------------------------------------------------------------
# RCM ordering and symmetrized adjacency (rcm.cpp).
# ---------------------------------------------------------------------------

def _bind_rcm(lib):
    lib.ehyb_rcm.restype = ctypes.c_longlong
    lib.ehyb_rcm.argtypes = [ctypes.c_longlong, _i32(), _i32(), _i64()]
    lib.ehyb_adjacency.restype = ctypes.c_longlong
    lib.ehyb_adjacency.argtypes = [
        ctypes.c_longlong, _i64(), _i64(), ctypes.c_longlong, _i32(), _i32()]


def adjacency_native(row: np.ndarray, col: np.ndarray, n: int):
    """Symmetrized dedup'd CSR adjacency.  Returns (xadj int32 [n+1],
    adjncy)."""
    lib = _load("rcm", _bind_rcm)
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    xadj = np.empty(n + 1, dtype=np.int32)
    adjncy = np.empty(max(2 * row.shape[0], 1), dtype=np.int32)
    sz = lib.ehyb_adjacency(row.shape[0], row, col, int(n), xadj, adjncy)
    if sz < 0:
        raise RuntimeError(f"native adjacency failed (code {sz})")
    return xadj, adjncy[:sz].copy()


def rcm_native(xadj: np.ndarray, adjncy: np.ndarray) -> np.ndarray:
    """Level-set pseudo-RCM over a CSR adjacency.  Returns int64
    ``new_to_old``."""
    lib = _load("rcm", _bind_rcm)
    xadj = np.ascontiguousarray(xadj, dtype=np.int32)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int32)
    n = xadj.shape[0] - 1
    out = np.empty(n, dtype=np.int64)
    rc = lib.ehyb_rcm(n, xadj, adjncy, out)
    if rc < 0:
        raise RuntimeError(f"native rcm failed (code {rc})")
    return out


# ---------------------------------------------------------------------------
# .mtx entry parser (mtxparse.cpp).
# ---------------------------------------------------------------------------

def _bind_io(lib):
    lib.ehyb_parse_entries.restype = ctypes.c_longlong
    lib.ehyb_parse_entries.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        _i64(), _i64(), _f64()]


def parse_entries_native(body: bytes, n_entries: int, has_value: bool):
    """Parse ``.mtx`` coordinate entries with the C++ scanner.  Returns
    (row, col, val) 1-based int64/int64/float64 arrays of length exactly
    ``n_entries``.  Raises ValueError on malformed/miscounted input."""
    lib = _load("mtxparse", _bind_io)
    row = np.empty(n_entries, dtype=np.int64)
    col = np.empty(n_entries, dtype=np.int64)
    val = np.empty(n_entries if has_value else 1, dtype=np.float64)
    n = lib.ehyb_parse_entries(body, len(body), 3 if has_value else 2,
                               n_entries, row, col, val)
    if n < 0:
        raise ValueError(f"native mtx parse failed (code {n})")
    if n != n_entries:
        raise ValueError(f"expected {n_entries} entries, parsed {n}")
    if not has_value:
        val = np.ones(n_entries, dtype=np.float64)
    return row, col, val
