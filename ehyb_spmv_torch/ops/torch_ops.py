"""Plain-torch EHYB ops: the SELL body, ER tail, long rows, DIA and combine.

Port counterpart of ``ehyb_spmv_gpu_tpu/ops/xla_ops.py``: the COO product of
the ``csr`` baseline and the EHYB phases.
These are the port's always-available formulations: they run on the CPU
(tests, oracle cross-checks) and on the GPU, where the flagship model keeps
the ER tail, long rows, DIA and combine as torch ops (the JAX package leaves
the same phases to XLA) and runs the SELL body through the hand-written
kernel in ``ops/ehyb_stream.py``.

``segment_sum`` and ``.at[].add`` become ``index_add_``.  Every function
takes the :class:`~..core.ehyb.EhybDevice` mirror and a padded x.
"""
from __future__ import annotations

import torch

from ..config import LANES
from ..core.ehyb import EhybDevice


def coo_spmv(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y = A·x from COO triples: gather x by column, scatter-add the
    products by row (the JAX package's ``segment_sum``; rows need not be
    sorted)."""
    return x.new_zeros(n_rows).index_add_(0, row, val * x.index_select(0, col))


def _segment_rows(offset: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Map each width-step k to its slice id via the offset prefix sums.
    Steps past the last offset map to ``n_slices`` (a dropped dump row, as
    ``segment_sum`` drops out-of-range ids)."""
    steps = torch.arange(n_steps, dtype=offset.dtype, device=offset.device)
    return torch.searchsorted(offset[1:], steps, right=True)


def _sum_slices(contrib: torch.Tensor, offset: torch.Tensor, n_slices: int,
                acc_dtype: torch.dtype) -> torch.Tensor:
    """Per-slice lane sums of a (steps, 128) contribution array, flattened to
    (n_slices * 128,)."""
    step_slice = _segment_rows(offset, contrib.shape[0])
    y2 = torch.zeros(n_slices + 1, contrib.shape[1], dtype=acc_dtype,
                     device=contrib.device)
    y2.index_add_(0, step_slice, contrib.to(acc_dtype))
    return y2[:n_slices].reshape(-1)


def neumaier_rows(term: torch.Tensor, row: torch.Tensor,
                  place: torch.Tensor, n_rows: int,
                  n_places: int) -> torch.Tensor:
    """Per-row sums of the terms with Neumaier compensation, each row's
    terms added in ``place`` order (0, 1, ...), as the compensated kernels
    add them: the float64 plain version of their Kahan variants.  A
    (row, place) holds at most one term; a missing one adds 0.
    ``n_places``, a host int above every place, sets the passes, so the
    sum reads no device scalar (a CUDA graph can capture it)."""
    n, dev = term.shape[0], term.device
    at = torch.full((n_places * n_rows,), n, dtype=torch.long, device=dev)
    at.index_copy_(0, place.long() * n_rows + row.long(),
                   torch.arange(n, device=dev))
    vals = torch.cat([term, term.new_zeros(1)])
    s = term.new_zeros(n_rows)
    c = term.new_zeros(n_rows)
    for k in range(n_places):
        v = vals[at[k * n_rows:(k + 1) * n_rows]]
        t = s + v
        c += torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
        s = t
    return s + c


def chain_offsets(group: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """For units in walk order (a row block's pieces, or its stages), each
    unit's first place in its group's row: the widths of the same group's
    earlier units, summed."""
    order = torch.argsort(group, stable=True)
    w = width[order]
    before = torch.cumsum(w, 0) - w
    g = group[order]
    start = torch.ones_like(g, dtype=torch.bool)
    start[1:] = g[1:] != g[:-1]
    # ``before`` never decreases, so its running max over the group starts
    # is the current group's first value
    base = torch.cummax(torch.where(start, before, 0), 0).values
    out = torch.empty_like(before)
    out[order] = before - base
    return out


def ehyb_dia(e: EhybDevice, x_pad: torch.Tensor,
             x_base: int = 0) -> torch.Tensor:
    """DIA body: y[i] = Σ_k dia_val[k, i] · x[i + d_k], one shifted slice of
    x per static offset.  Returns y of length ``dia_val.shape[1]``, or length
    0 when no diagonals were extracted."""
    offs = e.dia_offsets
    if not offs:
        return x_pad.new_zeros(0)
    dim_r = e.dia_val.shape[1]
    lo = min(min(offs) + x_base, 0)          # most negative slice start
    hi = max(max(offs) + x_base + dim_r, x_pad.shape[0])
    x_ext = x_pad
    if lo < 0 or hi > x_pad.shape[0]:
        x_ext = torch.nn.functional.pad(x_pad, (-lo, hi - x_pad.shape[0]))
    dia_val = e.dia_val.to(x_pad.dtype)
    y = x_pad.new_zeros(dim_r)
    for k, d in enumerate(offs):
        start = x_base + d - lo
        # in place on the fresh accumulator: one fused multiply-add a term
        y.addcmul_(dia_val[k], x_ext[start:start + dim_r])
    return y


def body_gather_index(e: EhybDevice) -> torch.Tensor:
    """Global x index per SELL-body cell (decodes the plain window-local and
    the relaxed lo-slot layouts).

    Relaxed layout: ``ell_col`` packs ``(sel << 10) | (hi << 7) | lo``, and
    ``(sel, hi)`` at lane j describe LO-SLOT j — the slot attributes are read
    at lane ``lo`` of the same step row, not from the entry's own bits."""
    idx = e.ell_col.to(torch.int32)
    if not e.rx_body:
        return e.step_win[:, None] + idx
    lo = idx & 127
    slot_attr = torch.gather(idx, 1, lo.long())
    sel = slot_attr >> 10            # 1 bit (dual) or 2 bits (quad)
    hi = (slot_attr >> 7) & 7
    base = torch.where(sel == 1, e.step_win_b[:, None], e.step_win[:, None])
    if e.step_win_c.shape[0]:        # windows_per_subtile = 4
        base = torch.where(sel == 2, e.step_win_c[:, None], base)
        base = torch.where(sel == 3, e.step_win_d[:, None], base)
    return base + (hi << 7) + lo


def ehyb_body(e: EhybDevice, x_pad: torch.Tensor,
              compensated: bool = False) -> torch.Tensor:
    """SELL body: y[s*128+lane] = Σ_k ell_val[k,lane]·x[decoded col].

    ``compensated`` on a float32 x sums in float64 and rounds once: the
    exact-sum answer that the compensated kernel approximates to about one
    ulp.  On a float64 x it adds each row's products in step order with
    Neumaier compensation (:func:`neumaier_rows`), as the float64 Kahan
    kernels do; it reads the widest slice's width on the host."""
    n_steps, c = e.ell_val.shape
    n_slices = e.slice_win_start.shape[0]
    if n_steps == 0 or e.body_nnz == 0:
        return x_pad.new_zeros(n_slices * c)
    gidx = body_gather_index(e)
    contrib = e.ell_val.to(x_pad.dtype) \
        * x_pad.index_select(0, gidx.reshape(-1)).reshape(gidx.shape)
    if compensated and x_pad.dtype == torch.float64:
        step_slice = _segment_rows(e.slice_offset, n_steps)
        bounds = torch.cat([e.slice_offset.long(), step_slice.new_tensor(
            [n_steps])])
        place = torch.arange(n_steps, device=x_pad.device) \
            - bounds[step_slice]
        row = step_slice[:, None] * c + torch.arange(c, device=x_pad.device)
        y = neumaier_rows(contrib.reshape(-1), row.reshape(-1),
                          place[:, None].expand(-1, c).reshape(-1),
                          (n_slices + 1) * c, int(torch.diff(bounds).max()))
        return y[:n_slices * c]
    acc = torch.float64 if compensated else x_pad.dtype
    return _sum_slices(contrib, e.slice_offset, n_slices, acc).to(x_pad.dtype)


def ehyb_er(e: EhybDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """ER tail: packed yER (density-sorted row order, global columns)."""
    n_steps = e.er_val.shape[0]
    n_slices = max(e.er_slice_offset.shape[0] - 1, 0)
    if n_steps == 0 or n_slices == 0:
        return x_pad.new_zeros(0)
    contrib = e.er_val.to(x_pad.dtype) * x_pad.index_select(
        0, e.er_col.reshape(-1)).reshape(e.er_col.shape)
    return _sum_slices(contrib, e.er_slice_offset, n_slices, x_pad.dtype)


def ehyb_long(e: EhybDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """Long-row partial sums (one scalar per long row), a segment reduction
    over the (col, val) stream."""
    n_long = e.long_rows.shape[0]
    if n_long == 0 or e.long_col.shape[0] == 0:
        return x_pad.new_zeros(0)
    contrib = e.long_val.to(x_pad.dtype) * x_pad.index_select(0, e.long_col)
    return x_pad.new_zeros(n_long).index_add_(0, e.long_seg, contrib)


def combine_ehyb(e: EhybDevice, y_body: torch.Tensor, y_er: torch.Tensor,
                 y_long: torch.Tensor, y_dia: torch.Tensor = None
                 ) -> torch.Tensor:
    """Assemble the final (reordered, padded) y from the phases.

    ER padding lanes point at the dump row ``dim``, so ``er_rows`` holds
    duplicates; ``index_add_`` accumulates them."""
    ny = y_body.shape[0] + LANES  # slack so the dump row `dim` is in range
    y = y_body.new_zeros(ny)
    y[: y_body.shape[0]] = y_body
    if e.split_src.shape[0]:
        # hub-row splitting: overflow rows fold into their true rows, then
        # are zeroed so the padded tail stays clean
        y.index_add_(0, e.split_dst, y_body.index_select(0, e.split_src))
        y[e.split_src.long()] = 0.0
    if y_dia is not None and y_dia.shape[0]:
        n = min(y_dia.shape[0], ny)
        y[:n] += y_dia[:n]
    if y_er.shape[0]:
        y.index_add_(0, e.er_rows, y_er)
    if y_long.shape[0]:
        y.index_add_(0, e.long_rows, y_long)
    return y


def ehyb_apply(e: EhybDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """Full EHYB SpMV (plain torch): returns the padded reordered y."""
    return combine_ehyb(e, ehyb_body(e, x_pad), ehyb_er(e, x_pad),
                        ehyb_long(e, x_pad), ehyb_dia(e, x_pad))


class EhybApply(torch.nn.Module):
    """Device apply of the plain model: ``forward(x_pad)`` → padded y."""

    def __init__(self, e: EhybDevice):
        super().__init__()
        self.e = e

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        return ehyb_apply(self.e, x_pad)

    def phases(self) -> dict:
        """Each phase of the apply as a function of x_pad, by name."""
        e = self.e
        return {"dia": lambda x: ehyb_dia(e, x),
                "body": lambda x: ehyb_body(e, x),
                "er": lambda x: ehyb_er(e, x),
                "long": lambda x: ehyb_long(e, x)}
