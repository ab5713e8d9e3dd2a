"""The precision mode (``EhybConfig(dword_values=True)``) on the card: f64
values, x, y and sums.

Port counterpart of ``ehyb_spmv_gpu_tpu/ops/dword.py``.  The reference's
contract is f64 values (``spmv.h:46``).  The TPU's vector unit has no f64,
so the JAX package carries every value and x as a (hi, lo) pair of f32,
multiplies with Dekker's two-product and reduces in ordered Neumaier
chains, long rows in a lane-chain layout of their own (``pack_long_dword``,
``_lane_tree_sum``).  The H100 computes in f64 natively, and an f64 value
takes the 8 bytes a pair takes, so the port needs none of that arithmetic:
the mode is the plain EHYB apply in f64.

* The host side is the JAX mode's (:func:`dword_config`): f64 host values,
  no hub-row splitting, no relaxed-layout switch.  The flagship pins no
  layout in this mode, as the JAX flagship runs no Pallas kernel in it, so
  ``ehyb``, ``ehyb_xla`` and ``hyb`` build the JAX package's ``EhybMatrix``.
* The apply (:func:`make_dword_apply`) runs the SELL body, the ER tail and
  the long rows (where the TPU packs lane chains) through K1 over one
  compact plan in f64 (``csrc/ehyb_stream.cu``; the unordered body is
  scattered, so the plan takes direct columns and groups its rows where
  that pays, and a row block a hub row or its tail makes long goes in
  chunks, :func:`~.stream_cells.k1_folded_plan`), then the DIA part
  through K9 in f64 (``csrc/dia.cu``), added into K1's y.  The TPU branch
  is the XLA one (``module.branch == "dword xla"``): the window cache
  never runs here.
* On the CPU the same module takes the kernels' plain versions, which are
  dtype-generic: the plain torch formulation in f64.

Held to the JAX mode's bound: rel <= 1e-12 against the exact-f64 oracle
(``tests/test_dword.py``).
"""
from __future__ import annotations

import dataclasses
import time

from ..config import EhybConfig
from ..core.ehyb import EhybDevice, EhybMatrix
from ..utils.log import get_logger
from .ehyb_stream import EhybStreamApply
from .stream_cells import has_tail, k1_folded_plan

log = get_logger(__name__)

#: The models whose JAX counterparts honour the mode (``EhybXlaSpmv`` and
#: its subclasses); every other model refuses it.
DWORD_MODELS = ("ehyb_xla", "ehyb", "hyb")


def dword_config(cfg: EhybConfig) -> EhybConfig:
    """The config the mode plans with (``models/ehyb.py:156-163`` of the JAX
    package): f64 host values, hub-row splitting off (its combine would
    re-sum pieces), no relaxed-layout switch."""
    return dataclasses.replace(cfg, dtype="float64", row_split_threshold=0,
                               relax_body="never")


def make_dword_apply(e: EhybMatrix, dev: EhybDevice, cache: str = None):
    """The mode's apply for artifact ``e`` (f64 host values) and its device
    mirror ``dev``: K1 over the compact plan of the body and the tail (ER
    and long-row entries as cells of their true rows), then K9 adding the
    diagonals into K1's y, both in f64.  As in the flagship, ``dev`` gives
    up its padded body once the plan is on the device; the plan's build
    seconds (its load's, where ``cache``, the artifact's cache path, holds
    it: ``stream_cells.k1_folded_plan``) are ``apply.plan_seconds``."""
    t0 = time.perf_counter()
    cells = None
    if dev.body_nnz or has_tail(e):
        plan = k1_folded_plan(e, cache=cache)
        cells = plan.to_torch(dev.slice_offset.device)
        dev.ell_col = dev.ell_val = None
        st = plan.stats
        log.info("precision mode: K1 in f64 with the tail folded in (%d "
                 "cells of ER and long-row entries) over %d row blocks (%d "
                 "cut for the 16-bit range, %d of %d pieces direct, rows "
                 "%s, %d in %d chunks), %.1f MB of cells", st["tail_cells"],
                 st["n_rb"], st["split_rbs"], st["direct_pieces"],
                 st["n_pieces"], "grouped" if st["grouped"] else
                 "in body order", st["chunked_rbs"], st["n_chunks"],
                 st["cell_bytes"] / 1e6)
    # the TPU's branch here: the JAX package's XLA dword formulation
    apply = EhybStreamApply(dev, cells=cells, branch="dword xla")
    apply.plan_seconds = time.perf_counter() - t0
    return apply
