"""Each plain-torch op of the port against its XLA counterpart on one shared
artifact (built by the JAX host layer, carried over with ehyb_from_arrays),
and the streamed body's plain version against the JAX Pallas kernel run in
interpret mode, as the JAX suite runs it.

Bound: f32 rel <= 2e-6 — both sides round each product the same way but sum
in another order (index_add_ vs segment_sum or the kernel's running sum)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ehyb_spmv_gpu_tpu.io import generate
from ehyb_spmv_gpu_tpu.ops import xla_ops

from ehyb_spmv_torch.ops import ehyb_stream, torch_ops
from test_torch_parity import (REF, body_rows, cancellation_matrix,
                              config_for, host_pipeline, port_from_ref,
                              rel)

TOL = 2e-6

# (case id, fixture, flagship layout or None for the plain config, windows
#  per sub-tile, extra config, phase the artifact must exercise)
CASES = [
    ("er_dia", "scrambled", None, 2, {"window_rows": 1024}, "er"),
    ("long", "dense_rows", None, 2,
     {"window_rows": 1024, "long_row_threshold": 128}, "long"),
    ("er_powerlaw", "powerlaw_small", None, 2, {"window_rows": 1024}, "er"),
    ("dia", "poisson_mid", None, 2, {}, "dia"),
    ("mw", "scrambled", "sell_mw", 2, {}, "body"),
    ("quad", "powerlaw_small", "sell_rx", 4, {}, "body"),
    ("hub_split", "powerlaw_small", "sell_rx", 2,
     {"row_split_threshold": 4}, "split"),
]


@pytest.fixture(scope="module")
def dense_rows(scrambled):
    return generate.with_dense_rows(scrambled, 2, density=0.8, seed=3)


def _artifact(request, fixture, layout, wps, extra):
    m = request.getfixturevalue(fixture)
    cfg = config_for(REF, layout is not None, layout or "sell", wps, **extra)
    return host_pipeline(REF, m, cfg)[2], cfg


def _x_pad(e, seed=0):
    return np.random.default_rng(seed).standard_normal(
        e.padded_x_rows).astype(np.float32)


def _has(e, phase):
    st = e.stats
    return {"er": st["nnz_er"], "long": st["nnz_long"], "dia": st["nnz_dia"],
            "body": st["nnz_ell"], "split": e.split_src.size}[phase] > 0


@pytest.mark.parametrize("case,fixture,layout,wps,extra,phase", CASES,
                         ids=[c[0] for c in CASES])
def test_ops_match_xla(case, fixture, layout, wps, extra, phase, request):
    e_ref, _ = _artifact(request, fixture, layout, wps, extra)
    assert _has(e_ref, phase), f"{case}: artifact lacks its {phase} phase"
    d_ref = e_ref.to_jax()
    d_pt = port_from_ref(e_ref).to_torch()
    x = _x_pad(e_ref)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)

    if e_ref.stats["nnz_ell"]:
        np.testing.assert_array_equal(
            np.asarray(xla_ops.body_gather_index(d_ref)),
            torch_ops.body_gather_index(d_pt).numpy())
    pairs = {
        "body": (xla_ops.ehyb_body_xla, torch_ops.ehyb_body),
        "er": (xla_ops.ehyb_er_xla, torch_ops.ehyb_er),
        "long": (xla_ops.ehyb_long_xla, torch_ops.ehyb_long),
        "dia": (xla_ops.ehyb_dia_xla, torch_ops.ehyb_dia),
        "apply": (xla_ops.ehyb_apply_xla, torch_ops.ehyb_apply),
    }
    outs = {}
    for name, (f_ref, f_pt) in pairs.items():
        want = np.asarray(f_ref(d_ref, xj))
        got = f_pt(d_pt, xt).numpy()
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, name
        assert rel(got, want) <= TOL, (name, rel(got, want))
        outs[name] = want

    # combine alone, on identical phase inputs
    parts = [outs["body"], outs["er"], outs["long"], outs["dia"]]
    want = np.asarray(xla_ops.combine_ehyb(
        d_ref, *(jnp.asarray(p) for p in parts)))
    got = torch_ops.combine_ehyb(
        d_pt, *(torch.from_numpy(np.array(p)) for p in parts)).numpy()
    assert rel(got, want) <= TOL


STREAM_CASES = [
    ("nwin1", "sell_mw", 1, False),
    ("nwin2", "sell_rx", 2, False),
    ("nwin4", "sell_rx", 4, False),
    ("nwin2_kahan", "sell_rx", 2, True),
]


@pytest.mark.parametrize("case,layout,nwin,kahan", STREAM_CASES,
                         ids=[c[0] for c in STREAM_CASES])
def test_stream_plain_matches_pallas_interpret(case, layout, nwin, kahan,
                                               scrambled):
    from ehyb_spmv_gpu_tpu.ops.ehyb_pallas import (make_ehyb_pallas_apply,
                                                   pad_stream_arrays)

    m = cancellation_matrix(REF) if kahan else scrambled
    cfg = config_for(REF, True, layout, max(nwin, 2), compensated_sum=kahan)
    _, r_ref, e_ref = host_pipeline(REF, m, cfg)
    e_pt = port_from_ref(e_ref)
    d_pt = e_pt.to_torch()
    assert d_pt.nwin == nwin and e_ref.stats["nnz_ell"] > 0

    apply = make_ehyb_pallas_apply(e_ref, cfg, interpret=True, streaming=True)
    col_p, val_p = pad_stream_arrays(e_ref)
    d_ref = dataclasses.replace(e_ref.to_jax(), ell_col=jnp.asarray(col_p),
                                ell_val=jnp.asarray(val_p))
    x = np.ones(e_ref.padded_x_rows, np.float32) if kahan else _x_pad(e_ref)
    want = np.asarray(jax.jit(apply)(d_ref, jnp.asarray(x)))

    xt = torch.from_numpy(x)
    # the flagship's apply: K1 over its compact plan of this artifact
    flagship = ehyb_stream.make_stream_apply(e_pt, d_pt, kahan=kahan)
    assert flagship.cells is not None and d_pt.ell_val is None
    got = flagship(xt).numpy()
    # y has the body's rows: the combine's slack for the ER dump row goes
    want = body_rows(got, want)
    assert rel(got, want) <= TOL, rel(got, want)
    # on a CPU tensor the wrapper IS the plain version
    body = ehyb_stream.stream_body(flagship.cells, xt, kahan)
    assert torch.equal(body, ehyb_stream.stream_body_plain(flagship.cells,
                                                           xt, kahan))
    if kahan:
        # row 0 of the cancellation matrix sums to 100 exactly
        r0 = int(r_ref.old_to_new[0])
        assert got[r0] == want[r0] == 100.0
        naive = ehyb_stream.make_stream_apply(e_pt, e_pt.to_torch())(
            xt).numpy()
        assert abs(naive[r0] - 100.0) > 1e-4   # the stress has teeth
