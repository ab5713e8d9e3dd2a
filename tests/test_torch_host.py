"""The port's host layer reproduces the JAX package's artifacts byte for byte:
plans, orderings and EhybMatrix arrays, on the plain config and on the
layouts the flagship pins (mw, rx, quad), plus the .mtx round trip."""
import numpy as np
import pytest

from ehyb_spmv_gpu_tpu.io import generate, read_mtx, write_mtx

import ehyb_spmv_torch.io as port_io
from test_torch_parity import (PORT, REF, assert_same_ehyb, config_for,
                              coo_for, host_pipeline)

FIXTURES = ["poisson_mid", "fem_small", "scrambled", "powerlaw_small",
            "dense_rows"]
LAYOUTS = [("plain", None, 2), ("mw", "sell_mw", 2), ("rx", "sell_rx", 2),
           ("quad", "sell_rx", 4)]


@pytest.fixture(scope="module")
def dense_rows(scrambled):
    return generate.with_dense_rows(scrambled, 3, density=0.4, seed=2)


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("name,layout,wps", LAYOUTS,
                         ids=[lay[0] for lay in LAYOUTS])
def test_host_pipeline_byte_identical(fixture, name, layout, wps, request):
    m = request.getfixturevalue(fixture)
    flagship = layout is not None
    out = {}
    for pkg in (REF, PORT):
        cfg = config_for(pkg, flagship, layout or "sell", wps)
        out[pkg] = host_pipeline(pkg, m, cfg)
    (plan_r, r_r, e_r), (plan_p, r_p, e_p) = out[REF], out[PORT]
    assert plan_r.describe() == plan_p.describe()
    assert plan_r.n_parts == plan_p.n_parts
    assert plan_r.window_rows == plan_p.window_rows
    for k in ("new_to_old", "old_to_new", "boundaries"):
        a, b = getattr(r_r, k), getattr(r_p, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert_same_ehyb(e_r, e_p)
    if name == "quad" and e_p.stats["nnz_ell"]:
        assert e_p.step_win_d.size == e_p.step_win.size
    if name == "rx" and e_p.stats["nnz_ell"]:
        assert e_p.step_win_b.size and not e_p.step_win_c.size


def test_hub_split_byte_identical(powerlaw_small):
    out = [host_pipeline(pkg, powerlaw_small,
                         config_for(pkg, True, "sell_rx", 2,
                                    row_split_threshold=16))[2]
           for pkg in (REF, PORT)]
    assert out[0].split_src.size > 0
    assert_same_ehyb(*out)


def test_mtx_round_trip(scrambled, tmp_path):
    """Reference writes, port reads (text and gzip), and the reverse."""
    import gzip
    import shutil

    path = str(tmp_path / "m.mtx")
    write_mtx(path, scrambled)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    a = port_io.read_mtx(path)
    a_gz = port_io.read_mtx(path + ".gz")
    port_io.write_mtx(str(tmp_path / "p.mtx"), a)
    b = read_mtx(str(tmp_path / "p.mtx"))
    ref = coo_for(REF, scrambled)
    for got in (a, a_gz, b):
        assert (got.n_rows, got.n_cols) == (ref.n_rows, ref.n_cols)
        order_g = np.lexsort((got.col, got.row))
        order_r = np.lexsort((ref.col, ref.row))
        assert np.array_equal(got.row[order_g], ref.row[order_r])
        assert np.array_equal(got.col[order_g], ref.col[order_r])
        np.testing.assert_array_equal(got.val[order_g], ref.val[order_r])
