"""Synthetic sparse-matrix generators.

The reference benchmarks on SuiteSparse matrices fetched from disk
(``./read/<name>.mtx``, ``solver_test.c:284``).  This environment has no network
access, so the framework ships generators that reproduce the *structural classes*
of the paper's corpus: banded FEM-like matrices (audikw_1-class: 3D mesh, 3
dofs/node, ~80 nnz/row), stencil Laplacians, power-law/irregular matrices (to
stress the ER tail and long-row paths), and randomly permuted variants (to make
the METIS-style partitioner actually matter, since freshly generated meshes are
already band-ordered).

All generators are deterministic given their arguments.

Port copy of ``ehyb_spmv_gpu_tpu/io/generate.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import numpy as np

from ..core.coo import MatrixCOO, coalesce


def diag_matrix(dim: int, value: float = 2.0) -> MatrixCOO:
    i = np.arange(dim, dtype=np.int64)
    return MatrixCOO(dim, dim, i, i, np.full(dim, value))


def poisson2d(n: int) -> MatrixCOO:
    """5-point Laplacian on an n×n grid (dim = n², ~5 nnz/row, SPD)."""
    idx = np.arange(n * n, dtype=np.int64).reshape(n, n)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v))

    add(idx, idx, 4.0)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -1.0)
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return MatrixCOO(n * n, n * n, np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals))


def stencil3d(n: int, points: int = 7) -> MatrixCOO:
    """7- or 27-point Laplacian-like stencil on an n³ grid."""
    if points not in (7, 27):
        raise ValueError("points must be 7 or 27")
    dim = n ** 3
    idx = np.arange(dim, dtype=np.int64).reshape(n, n, n)
    rows, cols, vals = [], [], []
    if points == 7:
        offsets = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                   (0, 0, 1), (0, 0, -1)]
    else:
        offsets = [(dx, dy, dz)
                   for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                   if (dx, dy, dz) != (0, 0, 0)]
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(np.full(dim, float(len(offsets))))
    for dx, dy, dz in offsets:
        sl_r = (slice(max(0, -dx), n - max(0, dx)),
                slice(max(0, -dy), n - max(0, dy)),
                slice(max(0, -dz), n - max(0, dz)))
        sl_c = (slice(max(0, dx), n - max(0, -dx)),
                slice(max(0, dy), n - max(0, -dy)),
                slice(max(0, dz), n - max(0, -dz)))
        r = idx[sl_r].ravel()
        c = idx[sl_c].ravel()
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.size, -1.0 / len(offsets)))
    return MatrixCOO(dim, dim, np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals))


def fem3d(n: int, dofs: int = 3, points: int = 27, seed: int = 0) -> MatrixCOO:
    """audikw_1-class structural FEM analog: n³-node 3D mesh, ``points``-point
    node stencil, ``dofs`` degrees of freedom per node (dense dofs×dofs coupling
    blocks) — dim = dofs·n³, ~points·dofs nnz/row.  ``fem3d(68)`` ≈ audikw_1's
    scale (dim ≈ 943k, nnz ≈ 76M)."""
    base = stencil3d(n, points)
    rng = np.random.default_rng(seed)
    # Expand each node entry to a dofs×dofs dense block.
    di = np.arange(dofs, dtype=np.int64)
    bi = np.repeat(di, dofs)   # block-row offsets
    bj = np.tile(di, dofs)     # block-col offsets
    row = (base.row[:, None] * dofs + bi[None, :]).ravel()
    col = (base.col[:, None] * dofs + bj[None, :]).ravel()
    block_vals = rng.standard_normal((base.nnz, dofs * dofs)) * 0.1
    # Keep diagonal dominance for stable power iterations.
    diag_mask = (row == col)
    val = block_vals.ravel()
    val[diag_mask] += float(points)
    dim = base.n_rows * dofs
    return MatrixCOO(dim, dim, row, col, val)


def random_general(dim: int, avg_nnz_per_row: int, seed: int = 0,
                   power_law: float = 0.0, symmetric: bool = False) -> MatrixCOO:
    """Random matrix with ~``avg_nnz_per_row`` nnz/row.  ``power_law`` > 0 skews
    the per-row counts toward a heavy tail (stress for the density sort, ER tail,
    and long-row path — cf. the reference's long-vector extraction at
    ``convert.c:92-101``)."""
    rng = np.random.default_rng(seed)
    if power_law > 0:
        w = (1.0 + np.arange(dim)) ** (-power_law)
        rng.shuffle(w)
        counts = rng.poisson(avg_nnz_per_row * dim * w / w.sum())
    else:
        counts = rng.poisson(avg_nnz_per_row, size=dim)
    counts = np.clip(counts, 1, dim).astype(np.int64)
    row = np.repeat(np.arange(dim, dtype=np.int64), counts)
    col = rng.integers(0, dim, size=row.shape[0], dtype=np.int64)
    val = rng.standard_normal(row.shape[0]) * 0.5
    m = coalesce(MatrixCOO(dim, dim, row, col, val))
    if symmetric:
        m = coalesce(MatrixCOO(dim, dim,
                               np.concatenate([m.row, m.col]),
                               np.concatenate([m.col, m.row]),
                               np.concatenate([m.val, m.val]) * 0.5))
    return m


def with_dense_rows(m: MatrixCOO, n_dense: int, density: float = 0.5,
                    seed: int = 1) -> MatrixCOO:
    """Inject ``n_dense`` pathological dense rows (the long-row stress case the
    reference handles with ``longRowKernel``, ``kernel.cu:43-67``)."""
    rng = np.random.default_rng(seed)
    dim = m.dimension
    rows_sel = rng.choice(dim, size=n_dense, replace=False)
    per = max(1, int(density * dim))
    new_row = np.repeat(rows_sel.astype(np.int64), per)
    new_col = np.concatenate([
        rng.choice(dim, size=per, replace=False).astype(np.int64)
        for _ in range(n_dense)])
    new_val = rng.standard_normal(new_row.shape[0]) * 0.01
    return coalesce(MatrixCOO(dim, dim,
                              np.concatenate([m.row, new_row]),
                              np.concatenate([m.col, new_col]),
                              np.concatenate([m.val, new_val])))


def permuted(m: MatrixCOO, seed: int = 0) -> MatrixCOO:
    """Apply a random symmetric permutation P·A·Pᵀ — destroys the generator's
    natural band ordering so partitioning/reordering has real work to do."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m.dimension).astype(np.int64)
    return MatrixCOO(m.n_rows, m.n_cols, perm[m.row], perm[m.col], m.val.copy())


def load_corpus(name: str, cache_dir: str = None) -> MatrixCOO:
    """``CORPUS[name]()`` with a disk cache.

    The reference reads its corpus from ``./read/<name>.mtx``
    (``solver_test.c:284``) — the matrix is ON DISK and parsing it is the only
    per-run cost.  Our generators are the corpus stand-in, but regenerating an
    audikw-class FEM matrix costs ~30 s per run (a large slice of the measured
    setup time): cache the generated COO as an ``.npz`` keyed
    by the corpus name, so repeat runs pay one array load instead.
    """
    import os

    d = cache_dir or os.environ.get(
        "EHYB_CORPUS_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "ehyb", "corpus"))
    base = os.path.join(d, name)
    # Raw .npy per array (direct fread) — np.load on an .npz goes through
    # zipfile (crc32 + small-chunk reads) and measured 71 s on a 1.2 GB
    # audikw-class cache entry vs ~2 s for the same bytes as plain .npy.
    # The .ok marker (written last) is the commit point for concurrent
    # bench subprocesses; per-file write-then-rename avoids torn arrays.
    ok = base + ".ok"
    if os.path.exists(ok):
        with open(ok) as f:
            n_rows, n_cols = (int(t) for t in f.read().split())
        return MatrixCOO(n_rows, n_cols,
                         np.load(base + ".row.npy").astype(np.int64),
                         np.load(base + ".col.npy").astype(np.int64),
                         np.load(base + ".val.npy"))
    legacy = base + ".npz"
    if os.path.exists(legacy):
        z = np.load(legacy)
        m = MatrixCOO(int(z["n_rows"]), int(z["n_cols"]),
                      z["row"].astype(np.int64), z["col"].astype(np.int64),
                      z["val"])
        _write_corpus_cache(base, m)          # upgrade in place
        os.remove(legacy)
        return m
    m = CORPUS[name]()
    os.makedirs(d, exist_ok=True)
    _write_corpus_cache(base, m)
    return m


def _write_corpus_cache(base: str, m: MatrixCOO) -> None:
    import os

    # int32 indices (every corpus dim < 2^31) halve the file.
    for stem, arr in (("row", m.row.astype(np.int32)),
                      ("col", m.col.astype(np.int32)), ("val", m.val)):
        tmp = f"{base}.{stem}.tmp{os.getpid()}.npy"
        np.save(tmp, arr)
        os.replace(tmp, f"{base}.{stem}.npy")
    tmp = f"{base}.ok.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{m.n_rows} {m.n_cols}")
    os.replace(tmp, base + ".ok")


#: Named corpus used by tests and the benchmark sweep (the stand-in for the
#: paper's SuiteSparse appendix list, ``README.md:3``).
CORPUS = {
    # name: zero-arg constructor
    "diag4k": lambda: diag_matrix(4096),
    "poisson2d_64": lambda: poisson2d(64),
    "poisson2d_512": lambda: poisson2d(512),
    "stencil3d_32": lambda: stencil3d(32, 7),
    "stencil27_24": lambda: stencil3d(24, 27),
    "fem3d_16": lambda: fem3d(16),
    "fem3d_32": lambda: fem3d(32),
    "fem3d_68_audikw_class": lambda: fem3d(68),
    "random_16k": lambda: random_general(16384, 24, seed=3),
    "powerlaw_16k": lambda: random_general(16384, 24, seed=4, power_law=0.7),
    "permuted_poisson_512": lambda: permuted(poisson2d(512), seed=7),
    # 1M-row scrambled stencil: the relaxed body in the HBM-streaming
    # regime (the ell stream exceeds the VMEM prestage limit)
    "permuted_poisson_1024": lambda: permuted(poisson2d(1024), seed=9),
    # 16.7M-row scrambled stencil (x = 64 MB > the VMEM residency budget):
    # the HBM window-cache body is the only fast path — the regime where the
    # reference kernel streams from global memory at any size
    # (kernel.cu:110-195)
    "permuted_poisson_4096": lambda: permuted(poisson2d(4096), seed=13),
    # 1M rows x ~16 random nnz/row, no recoverable structure: the
    # ER-exposure stress — how much does the relaxed
    # body absorb when there is nothing for the reorderer to find?
    "random_1m": lambda: random_general(1 << 20, 16, seed=17),
    # 4M rows x ~8 random nnz/row: past the single-level router's
    # select-chain bound — exercises the COLUMN-BLOCK routed mode (4
    # vertical blocks), proving the gather-wall answer has no size cliff
    "random_4m": lambda: random_general(1 << 22, 8, seed=23),
    # 1M rows, heavy-tailed (~24 nnz/row mean, power-law 0.7): scale AND
    # skew together — hub rows at a dimension where nothing is
    # VMEM-resident.  Stresses the long-row extraction, the density sort,
    # and (when the gate delegates) the router's hot-window cells, none of
    # which random_1m's uniform columns exercise.
    "powerlaw_1m": lambda: random_general(1 << 20, 24, seed=29,
                                          power_law=0.7),
}
