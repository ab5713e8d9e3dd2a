"""The port's profiling on the CPU: the roofline audit counts what the
card moves (its total is ``bytes_model()``), ``phase_breakdown`` names the
apply's phases, and ``trace`` writes a Chrome trace."""
import json
import math
import os

import pytest

from ehyb_spmv_gpu_tpu.core.coo import deterministic_x
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from ehyb_spmv_torch.utils.profiling import (phase_breakdown,
                                             roofline_report, trace)
from test_torch_parity import coo_for

EHYB_PHASES = {"dia", "body", "er", "long", "full_apply"}
#: The flagship's phases where K1 runs: K1 (the body with the tail folded
#: in) and K9.
FLAGSHIP_PHASES = {"body", "dia", "full_apply"}


@pytest.fixture(scope="module")
def models(scrambled):
    m = coo_for("ehyb_spmv_torch", scrambled)
    heavy = coo_for("ehyb_spmv_torch",
                    generate.random_general(2000, 8, seed=1, power_law=0.8))
    out = {name: port.MODELS[name](port.EhybConfig(), device="cpu").setup(m)
           for name in ("ehyb", "ehyb_xla", "hyb", "csr", "bcoo")}
    out["ehyb_split"] = port.DegreeSplitSpmv(port.EhybConfig(),
                                             device="cpu").setup(heavy)
    return out


@pytest.mark.parametrize("name", ["ehyb", "ehyb_xla", "hyb", "csr", "bcoo",
                                  "ehyb_split"])
def test_roofline_report_totals_bytes_model(models, name):
    model = models[name]
    phases = model.roofline_phases()
    assert sum(b for _, b in phases.values()) == model.bytes_model()
    rep = roofline_report(model)
    assert rep.startswith("roofline audit") and "VMEM" not in rep
    assert f"total bytes/iter: {model.bytes_model() / 1e6:.1f} MB" in rep
    for k, (flops, n_bytes) in phases.items():
        assert (f"\n  {k:16s} " in rep) == bool(flops or n_bytes), k


def test_roofline_counts_the_k1_plan_not_the_padded_body(models):
    """K1's plan holds the body and the tail: the body's phase counts the
    plan's bytes and every body, ER and long-row entry's flops, and the ER
    and long rows have no phase of their own."""
    model = models["ehyb"]
    phases = model.roofline_phases()
    st = model.ehyb.stats
    assert model.module.cells.stats["folded"]
    assert phases["body"] == (2 * (st["nnz_ell"] + st["nnz_er"]
                                   + st["nnz_long"]),
                              model.module.cells.stats["stream_bytes"])
    assert "er" not in phases and "long" not in phases


@pytest.mark.parametrize("name", ["ehyb", "ehyb_xla", "csr", "ehyb_split"])
def test_phase_breakdown_keys(models, name):
    model = models[name]
    x_dev = model.prepare_x(deterministic_x(model.m.dimension))
    t = phase_breakdown(model, x_dev, iters=3)
    want = {"ehyb": FLAGSHIP_PHASES, "ehyb_xla": EHYB_PHASES}.get(
        name, {"full_apply"})
    assert set(t) == want
    assert all(v >= 0.0 and not math.isnan(v) for v in t.values())


def test_phases_sum_to_the_apply(models):
    """The phases the breakdown times are the apply's own parts: combined,
    they give the apply's y (the flagship's: K9's sums added into K1's y,
    the plain model's: the combine of its four)."""
    from ehyb_spmv_torch.ops.torch_ops import combine_ehyb

    for name in ("ehyb", "ehyb_xla"):
        model = models[name]
        x_dev = model.prepare_x(deterministic_x(model.m.dimension))
        p = model.module.phases()
        if name == "ehyb":
            y = p["body"](x_dev)
            y_dia = p["dia"](x_dev)
            y[:y_dia.shape[0]] += y_dia
        else:
            y = combine_ehyb(model.dev, p["body"](x_dev), p["er"](x_dev),
                             p["long"](x_dev), p["dia"](x_dev))
        assert bool((y == model.apply(x_dev)).all()), name


def test_trace_writes_a_chrome_trace(models, tmp_path):
    model = models["ehyb"]
    x_dev = model.prepare_x(deterministic_x(model.m.dimension))
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        model.iterate(x_dev, 3)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        assert json.load(f)["traceEvents"]
