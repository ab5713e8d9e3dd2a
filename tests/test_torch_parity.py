"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (the same inputs go through both host layers and both applies),
and the tests of the hand-over itself: ``ehyb_from_arrays`` and the torch
device mirror."""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

REF = "ehyb_spmv_gpu_tpu"
PORT = "ehyb_spmv_torch"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def coo_for(pkg: str, m):
    """The same matrix as ``pkg``'s own MatrixCOO."""
    return _mod(pkg, "core.coo").MatrixCOO(m.n_rows, m.n_cols, m.row, m.col,
                                           m.val)


def config_for(pkg: str, flagship: bool, layout: str = "sell_mw",
               wps: int = 2, **kw):
    """The plain config, or the layout the flagship pins for its kernel
    (1024-row windows, int16 columns, sliding windows, 32-step widths)."""
    cfg_mod = _mod(pkg, "config")
    if not flagship:
        return cfg_mod.EhybConfig(**kw)
    feats = cfg_mod.Features(
        sort_mode="pattern" if layout == "sell_mw" else "density")
    return cfg_mod.EhybConfig(
        window_rows=1024, body_layout=layout, width_align=32,
        index_dtype="int16", sliding_windows=True, features=feats,
        relax_body="never", windows_per_subtile=wps, **kw)


def host_pipeline(pkg: str, m, cfg):
    """make_plan → ordering → coo_to_ehyb through ``pkg``'s host layer.
    Returns (plan, reordering, EhybMatrix)."""
    m = coo_for(pkg, m)
    plan = _mod(pkg, "core.planner").make_plan(m.dimension, cfg)
    if cfg.body_layout in ("sell_mw", "sell_rx"):
        r = _mod(pkg, "core.ordering").pick_ordering(m, plan, cfg,
                                                     cfg.ordering)
    else:
        labels = _mod(pkg, "partition").partition_rows(
            m, plan.n_parts, cfg.partitioner, cfg.partition_imbalance)
        r = _mod(pkg, "core.reorder").two_level_reorder(
            m, labels, plan, sort_rows=cfg.features.sort_rows,
            sort_mode=cfg.features.sort_mode)
    e = _mod(pkg, "core.convert").coo_to_ehyb(r.apply_to_matrix(m), r, plan,
                                              cfg)
    return plan, r, e


def ehyb_fields(e) -> dict:
    return {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}


def assert_same_ehyb(a, b) -> None:
    """Byte-identical EhybMatrix arrays (dtype and shape included) and
    equal scalars and stats."""
    fa, fb = ehyb_fields(a), ehyb_fields(b)
    assert fa.keys() == fb.keys()
    for k, va in fa.items():
        vb = fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert va.tobytes() == vb.tobytes(), k
        else:
            assert va == vb, k


def port_from_ref(e_ref):
    """The reference EhybMatrix rebuilt in the port via ehyb_from_arrays."""
    from ehyb_spmv_torch.core.ehyb import ehyb_from_arrays

    meta = dict(dim=e_ref.dim, nnz_total=e_ref.nnz_total,
                window_rows=e_ref.window_rows, n_parts=e_ref.n_parts,
                stats=e_ref.stats)
    return ehyb_from_arrays(ehyb_fields(e_ref), meta)


def body_rows(got, want):
    """``want`` (a combine's padded y: the body's rows and one slice of
    slack for the ER dump row) cut to the rows of ``got`` (the flagship's
    y: the body's rows), after checking that the slack holds zeros."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape[0] <= want.shape[0] <= got.shape[0] + 128
    assert not np.any(want[got.shape[0]:])
    return want[:got.shape[0]]


def rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def cancellation_matrix(pkg: str):
    """Row 0 sums 100 ones among ±1e8 blocks: exact in f64, lossy in naive
    f32 summation (the stress of the JAX suite's compensated test, smaller).
    Built as ``pkg``'s MatrixCOO."""
    dim, n = 1024, 612
    vals = np.concatenate([np.ones(100), np.full(256, 1e8),
                           np.full(256, -1e8)])
    return _mod(pkg, "core.coo").MatrixCOO(
        dim, dim, np.concatenate([np.zeros(n, np.int64), np.arange(1, dim)]),
        np.concatenate([np.arange(n), np.arange(1, dim)]),
        np.concatenate([vals, np.ones(dim - 1)]))


def test_ehyb_from_arrays_round_trip(scrambled):
    """A reference artifact rebuilt in the port keeps every field."""
    e_ref = host_pipeline(REF, scrambled,
                          config_for(REF, True, "sell_rx", 4))[2]
    assert_same_ehyb(e_ref, port_from_ref(e_ref))


def test_device_mirror_uploads_every_array(scrambled):
    """EhybDevice holds every array field as a buffer (so ``to(device)``
    moves them all), casts only the value arrays, and keeps the static
    metadata as plain Python."""
    import torch

    e = port_from_ref(host_pipeline(REF, scrambled,
                                    config_for(REF, True, "sell_rx", 2))[2])
    d = e.to_torch(dtype="float64")
    names = {n for n, _ in d.named_buffers()}
    assert names == set(d.ARRAY_FIELDS)
    for f in d.ARRAY_FIELDS:
        want = getattr(e, f)
        got = getattr(d, f)
        if f in d.VALUE_FIELDS:
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))
        else:
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
    assert d.dia_offsets == tuple(int(o) for o in e.dia_offsets)
    assert d.body_nnz == e.stats["nnz_ell"] and d.rx_body and d.nwin == 2
    assert d.padded_x_rows == e.padded_x_rows
