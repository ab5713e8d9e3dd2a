"""The port's DIA body on the CPU: its plain version (the one the DIA
kernel's wrapper takes for CPU tensors) against the JAX Pallas DIA kernel K9
in interpret mode, in both of K9's variants, and the flagship on an all-DIA
FEM matrix against the JAX flagship with K9 forced.

Bounds: f32 rel <= 2e-6 in norm against the JAX kernel (the same products,
summed in another order); rel <= 5e-6 against the exact-f64 oracle (the
suite's bound)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ehyb_spmv_gpu_tpu as ref
import ehyb_spmv_gpu_tpu.models.ehyb as ref_ehyb
import ehyb_spmv_gpu_tpu.ops.dia_pallas as dp
from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from ehyb_spmv_torch.ops import dia, ehyb_stream, ehyb_wincache
from test_torch_parity import PORT, assert_same_ehyb, coo_for, rel

PARITY_TOL = 2e-6
ORACLE_TOL = 5e-6
OFFSETS = (-1024, -128, -1, 0, 1, 128, 1024)
DIM = 8192


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    val = rng.standard_normal((len(OFFSETS), DIM)).astype(np.float32)
    x = rng.standard_normal(DIM).astype(np.float32)
    return val, x


def _exact(val, x, offsets):
    want = np.zeros(val.shape[1])
    i = np.arange(val.shape[1])
    for k, d in enumerate(offsets):
        j = i + d
        ok = (j >= 0) & (j < x.shape[0])
        want[i[ok]] += val[k, i[ok]].astype(np.float64) * x[j[ok]]
    return want


@pytest.mark.parametrize("variant,block_rows", [
    ("resident", 8192), ("resident", 4096), ("streamed", 4096)])
def test_dia_plain_matches_pallas_interpret(variant, block_rows,
                                            monkeypatch):
    """K9 in interpret mode on pack_dia'd values, x resident or streamed as
    block pairs, against the port's DIA body on the (K, dim) values."""
    val, x = _inputs()
    if variant == "streamed":
        monkeypatch.setattr(dp, "X_RESIDENT_DIA_BYTES", 1024)
    packed, _ = dp.pack_dia(val, block_rows=block_rows)
    apply = dp.make_dia_pallas_apply(OFFSETS, DIM, "float32",
                                     block_rows=block_rows, interpret=True)
    want = np.asarray(apply(jnp.asarray(packed), jnp.asarray(x)))[:DIM]

    e = types.SimpleNamespace(dia_offsets=OFFSETS,
                              dia_val=torch.from_numpy(val))
    xt = torch.from_numpy(x)
    got = dia.dia_body(e, xt).numpy()
    assert got.shape == (DIM,) and got.dtype == np.float32
    assert rel(got, want) <= PARITY_TOL, rel(got, want)
    assert rel(got, _exact(val, x, OFFSETS)) <= PARITY_TOL
    # on a CPU tensor the wrapper IS the plain version
    assert torch.equal(dia.dia_body(e, xt), dia.dia_body_plain(e, xt))


def test_dia_reads_zero_outside_x():
    """An x index outside [0, len(x)) reads as zero, at both ends, with
    offsets past the edges and an x shorter than the rows."""
    rng = np.random.default_rng(3)
    offsets = (-3000, -5, 0, 7, 2999)
    val = rng.standard_normal((len(offsets), 2500)).astype(np.float32)
    x = rng.standard_normal(2300).astype(np.float32)
    e = types.SimpleNamespace(dia_offsets=offsets,
                              dia_val=torch.from_numpy(val))
    got = dia.dia_body(e, torch.from_numpy(x)).numpy()
    assert rel(got, _exact(val, x, offsets)) <= PARITY_TOL
    empty = types.SimpleNamespace(dia_offsets=(),
                                  dia_val=torch.zeros(0, 2500))
    assert dia.dia_body(empty, torch.from_numpy(x)).shape == (0,)


def test_flagship_all_dia_fem_matches_jax_with_k9(monkeypatch):
    """fem3d_16 goes all to DIA (99 diagonals): the port's flagship against
    the JAX flagship with K9 forced (a lowered VMEM_PRESTAGE_LIMIT puts it
    in args mode), each against the oracle; the same artifact, no body."""
    m = generate.fem3d(16)
    monkeypatch.setenv("EHYB_FORCE_PALLAS", "interpret")
    monkeypatch.setattr(ref_ehyb, "VMEM_PRESTAGE_LIMIT", 1024)
    kw = dict(artifact_cache=False, routed_delegate="never")
    jmodel = ref.EhybSpmv(ref.EhybConfig(**kw)).setup(m)
    assert jmodel._args_mode and getattr(jmodel, "_dia_apply", None)
    assert jmodel._pallas_apply.__name__ == "apply_nobody"
    before = (dia.dia_body.launches, ehyb_stream.stream_body.launches,
              ehyb_wincache.wincache_body.launches)
    model = port.EhybSpmv(port.EhybConfig(**kw), device="cpu").setup(
        coo_for(PORT, m))
    assert_same_ehyb(model.ehyb, jmodel.ehyb)
    st = model.ehyb.stats
    assert st["nnz_dia"] == m.nnz and st["nnz_ell"] == 0
    assert len(model.dev.dia_offsets) == 99
    assert model.module.branch == "skipped"
    x = deterministic_x(m.dimension)
    want = oracle_spmv(m, x)
    got = model.matvec(x)
    jgot = jmodel.matvec(x)
    assert rel(got, want) <= ORACLE_TOL
    assert rel(jgot, want) <= ORACLE_TOL
    assert rel(got, jgot) <= PARITY_TOL
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (dia.dia_body.launches, ehyb_stream.stream_body.launches,
            ehyb_wincache.wincache_body.launches) == before
