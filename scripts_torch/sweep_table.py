#!/usr/bin/env python3
"""The port's corpus table (``BENCH_SWEEP_H100.md``), rebuilt from a sweep
log's ``BENCH_RESULT`` lines.

    python3 scripts_torch/sweep_table.py sweep.log [out.md]

``scripts_torch/sweep.py`` prints one ``BENCH_RESULT {json}`` line per
(model, matrix) and writes the table through :func:`render` after each row;
this script renders the same rows from such a log (``tee`` the sweep's
standard output into one).  The port's counterpart of
``scripts/sweep_table.py``, with the card's regimes in place of the TPU's:
``L2`` where the row's modeled bytes per product (``bytes_model``) fit the
H100's 50 MB L2, so that its data can stay on chip between products and
the HBM roofline does not bound it; ``HBM`` otherwise.
"""
from __future__ import annotations

import json
import sys
import time

TAG = "BENCH_RESULT "
#: The H100's L2 cache (50 MiB).
L2_BYTES = 50 * 1024 * 1024


def parse(path: str):
    """[(matrix, {model: result})] in the order the log first names each
    matrix; a later line for the same (matrix, model) replaces an earlier
    one."""
    rows = {}
    with open(path) as f:
        for ln in f:
            i = ln.find(TAG)
            if i >= 0:
                d = json.loads(ln[i + len(TAG):])
                rows.setdefault(d["matrix"], {})[d["model"]] = d
    return list(rows.items())


def _ok(r) -> bool:
    return r is not None and "error" not in r


def _gflops(r) -> str:
    if r is None:
        return "-"
    return f"{r['gflops']:.2f}" if _ok(r) else "FAIL"


def render(rows, source: str) -> str:
    """The table of ``rows`` ([(matrix, {model: result})]) as markdown;
    ``source`` says what generated it."""
    cards = sorted({r["card"] or r["backend"] for _, rs in rows
                    for r in rs.values() if _ok(r)})
    lines = [
        f"# Benchmark sweep of the PyTorch port ({'; '.join(cards) or '-'})",
        "",
        f"Generated by {source} on {time.strftime('%Y-%m-%d %H:%M')}: each "
        "(model, matrix) in its own process through `bench_torch.py --run`, "
        "10 warm-up iterations, then one timed region of chained products "
        "(CUDA-graph replays, CUDA events); GFLOP/s = 2·nnz·iters/s "
        "(`spmv.cu:121`). Each row's answer is held to the exact-f64 oracle "
        "at rel 5e-6.",
        "",
        "| matrix | nnz | engine | EHYB GFLOP/s | % HBM roofline | regime | "
        "launches K1/K9/RX/WC | rel error | routed | split | CSR (torch) | "
        "BCOO (cuSPARSE) | EHYB vs BCOO | setup s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fails = []
    for name, rs in rows:
        fails += [(name, r) for r in rs.values() if not _ok(r)]
        e, b = rs.get("ehyb"), rs.get("bcoo")
        cells = [_gflops(rs.get(c)) for c in ("ehyb_routed", "ehyb_split",
                                              "csr", "bcoo")]
        if not _ok(e):
            lines.append(f"| {name} | - | - | {_gflops(e)} | | | | | "
                         + " | ".join(cells) + " | | |")
            continue
        frac = e["roofline_frac"]
        regime = ("-" if e["backend"] != "cuda" else
                  "L2" if e["bytes_model"] < L2_BYTES else "HBM")
        la = e["launches"]
        vs = f"{e['gflops'] / b['gflops']:.2f}x" if _ok(b) else "-"
        setup = e["setup_seconds"]
        lines.append(
            f"| {name} | {e['nnz']:,} | {e['engine']} | {e['gflops']:.2f} | "
            f"{'-' if frac is None else f'{100 * frac:.0f}%'} | {regime} | "
            f"{la['K1']}/{la['K9']}/{la['RX']}/{la['WC']} | "
            f"{e['rel_error']:.2e} | " + " | ".join(cells)
            + f" | {vs} | {setup.get('total', sum(setup.values())):.1f} |")
    lines += [
        "",
        "`routed`, `split`: the routed engine (`ehyb_routed`) and the "
        "degree-split hybrid (`ehyb_split`) run alone, on the rows with no "
        "recoverable structure and on the heavy-tailed rows. `launches`: "
        "each kernel's launches over the EHYB child (K1 the SELL body, K9 "
        "DIA, RX the routed kernel, WC the window cache; 0 on the CPU). "
        "`regime`: L2 where the modeled bytes per product fit the 50 MB L2 "
        "(the data can stay on chip between products, so the HBM roofline "
        "does not bound the row), HBM otherwise. `setup s`: the EHYB "
        "child's host setup (artifacts cached by matrix fingerprint when "
        "the cache holds them)."]
    if fails:
        lines += ["", "Failed:"]
        lines += [f"- {name} `{r['model']}`: {r['error']}"
                  for name, r in fails]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    out = argv[1] if len(argv) > 1 else "BENCH_SWEEP_H100.md"
    rows = parse(argv[0])
    with open(out, "w") as f:
        f.write(render(rows, f"scripts_torch/sweep_table.py from {argv[0]}"))
    print(f"wrote {out} ({len(rows)} matrices)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
