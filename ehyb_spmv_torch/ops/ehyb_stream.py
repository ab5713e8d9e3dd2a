"""The streamed SELL body on the GPU (K1): wrapper, plain version, and the
flagship's apply.

Port counterpart of the resident streamed body in
``ehyb_spmv_gpu_tpu/ops/ehyb_pallas.py`` (``_make_stream_resident_kernel``
and the branch of ``make_ehyb_pallas_apply`` that runs it).  The kernel is
``csrc/ehyb_stream.cu``; see its header for what it computes, what bounds
it on the H100 and how its design answers that.  It reads the compact plan
of ``ops/stream_cells.py``, built once per artifact at upload, so it also
computes the bodies the TPU gives to K2, K5 and K6 and to its XLA
fallbacks.  :func:`make_stream_apply` picks K1 or the window-cache kernel
(``ops/ehyb_wincache.py``) by the TPU's branch.

:func:`stream_body` launches the kernel for tensors on a CUDA device and
takes the plain version :func:`stream_body_plain` only for tensors on the
CPU.  A CUDA call launches the kernel or raises; nothing falls back.  The
flagship's plan holds the EHYB tail too (:func:`~.stream_cells.k1_folded_plan`:
ER, long-row and hub-split entries as cells of their true rows), so its
apply is K1 into a fresh y, then K9 adding the diagonals into it.  The
plan's values and x are float32, or float64 (the precision mode,
``ops/dword.py``, and a ``dtype="float64"`` config), whose kernels are
built at one row a thread with x through L1/L2, plain or Kahan, with or
without a row-block list: a plan in the table form and the body's row
order takes the float kernel's code in float64, and a plan with direct
pieces or a row map (:func:`~.stream_cells.k1_options`: a scattered body's)
a float64 kernel of its own.  A plan in the split form (a heavy-tailed
body's: row blocks cut into chunks, ``stream_cells.split``) takes a split
variant, built at one row a thread with x through L1/L2, in float32 and
float64, plain or Kahan, over every piece form; a list over it is a list
of its work items (:func:`~.stream_cells.list_items`), which the split
variants walk in place of the plan's, so the sharded apply
(``parallel/spmv.py``) runs a heavy-tailed shard in two such calls.  A
split plan too small to fill the card takes the split form's small form
(``stream_cells.small``: hub rows apart, short items, a fixed fold), whose
kernel is built in float32 and float64, plain or Kahan, at one row a
thread with x through L1/L2, and takes no list; its hubs' plain version is
:func:`hub_sums_plain`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import time

import torch

from ..config import LANES
from ..core.ehyb import EhybDevice, EhybMatrix
from ..utils.log import get_logger
from . import stream_plan
from .build import BuiltLibrary, build_cuda_library
from .dia import SMEM_LIMIT_BYTES, dia_body
from .ehyb_wincache import WinCacheDevice, build_wincache_plan, wincache_body
from .stream_cells import (BLOCK_ROWS, HUB_CELL, HUB_ID, HUB_SLOT,
                           HUB_STEPS_COL, ITEM_PIECE, PIECE_CELL, PIECE_RB,
                           PIECE_ROW, StreamCellsDevice, has_tail,
                           k1_folded_plan, small, split)
from .torch_ops import (add_tail_, chain_offsets, ehyb_er, ehyb_long,
                        fold_split_, neumaier_add, neumaier_pairs)

log = get_logger(__name__)

X_MODES = ("ldg", "staged")
#: The rows per thread (row blocks a warp takes at once) K1 is built for.
BUILT_ROWS = (1, 2, 4)
#: Value types K1 is built for.
DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    """How K1 walks the plan: ``threads`` per block; ``rows`` row blocks a
    warp takes at once (each thread owns ``rows`` neighbouring rows of one
    and reads their cells with one load); ``blocks_per_sm`` the persistent
    grid's blocks on each SM (fewer where they do not fit); ``x_mode``
    ``"ldg"`` (x through L1/L2) or ``"staged"`` (each piece's table rows
    copied to shared memory first)."""
    threads: int = 512
    rows: int = 1
    blocks_per_sm: int = 4
    x_mode: str = "ldg"

    def check(self) -> None:
        if self.rows not in BUILT_ROWS:
            raise ValueError(f"no kernel built for {self.rows} rows per "
                             f"thread (built: {BUILT_ROWS})")
        if self.x_mode not in X_MODES:
            raise ValueError(f"x_mode {self.x_mode!r} not in {X_MODES}")
        if not (32 <= self.threads <= 512 and self.threads % 32 == 0):
            raise ValueError(f"threads {self.threads}: a multiple of 32 up "
                             "to 512")
        if self.blocks_per_sm < 1:
            raise ValueError("blocks_per_sm must be at least 1")


#: The geometry every call takes.  ``chip_k1_sweep.py`` chose it: the
#: fastest at permuted_poisson_1024 within 3% of the fastest at
#: permuted_poisson_512 (four blocks of 512 threads fill an SM; one row a
#: thread gives pp512's 8,192 row blocks the most warps).
GEOMETRY = StreamGeometry()
#: The geometry a plan in the split form takes (its variants are built at
#: one row a thread, x through L1/L2).  ``chip_k1_sweep.py --long`` chose
#: it with ``SPLIT_STEPS``: the least sum of the times over the fastest at
#: powerlaw_1m's dense body and powerlaw_16k's body (185.4 and 12.8 us,
#: against the fastest 155.7 and 12.7, on an H100 at 700 W);
#: ``--long --f64`` chose it again with ``SPLIT_STEPS_F64`` for the float64
#: variants, where the resident blocks, not the geometry asked for, cap
#: the grid (eight blocks of 128 threads at 64 registers a thread).
SPLIT_GEOMETRY = StreamGeometry(threads=128, blocks_per_sm=16)
#: The geometry a plan in the small form takes (its kernel is built at one
#: row a thread, x through L1/L2).  ``chip_k1_sweep.py --small`` chose it
#: at powerlaw_16k in five configs with ``stream_cells.SMALL_STEPS`` and
#: ``HUB_STEPS``: the least sum of the times over the fastest (PERF.md).
SMALL_GEOMETRY = StreamGeometry(threads=128, blocks_per_sm=16)

_lock = threading.Lock()
_built = None
_lib = None
#: (geometry, kahan, f64, list, scattered, split, device) → blocks of it
#: resident on one SM.
_resident: dict = {}


def build_kernel() -> BuiltLibrary:
    """Compile ``csrc/ehyb_stream.cu`` (once per process) and return the
    library's path, build time and ptxas report."""
    global _built, _lib
    with _lock:
        if _built is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the streamed SELL-body kernel needs a "
                                   "CUDA device; none is available")
            built = build_cuda_library("ehyb_stream", ["ehyb_stream.cu"])
            lib = ctypes.CDLL(built.path)
            lib.ehyb_stream_body.restype = ctypes.c_int
            lib.ehyb_stream_body.argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            lib.ehyb_stream_body_split.restype = ctypes.c_int
            lib.ehyb_stream_body_split.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
            lib.ehyb_stream_resident_blocks.restype = ctypes.c_int
            lib.ehyb_stream_resident_blocks.argtypes = [ctypes.c_int] * 8
            lib.ehyb_stream_registers.restype = ctypes.c_int
            lib.ehyb_stream_registers.argtypes = [ctypes.c_int] * 6
            lib.ehyb_stream_smem_bytes.restype = ctypes.c_longlong
            lib.ehyb_stream_smem_bytes.argtypes = [ctypes.c_int] * 4
            lib.ehyb_stream_body_small.restype = ctypes.c_int
            lib.ehyb_stream_body_small.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int]
                + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
            lib.ehyb_stream_small_resident_blocks.restype = ctypes.c_int
            lib.ehyb_stream_small_resident_blocks.argtypes = \
                [ctypes.c_int] * 3
            lib.ehyb_stream_small_registers.restype = ctypes.c_int
            lib.ehyb_stream_small_registers.argtypes = [ctypes.c_int] * 2
            _built, _lib = built, lib
        return _built


def resident_blocks(geometry: StreamGeometry, kahan: bool, device,
                    f64: bool = False, lst: bool = False,
                    scattered: bool = False, split: bool = False) -> int:
    """Blocks of this geometry (in float64 where ``f64``, its row-block list
    variant where ``lst``, the scattered body's float64 kernel where
    ``scattered``, the split variant where ``split``) that stay resident on
    one SM of ``device`` (made once and kept); raises where not one does,
    as the launch would be refused."""
    key = (geometry, bool(kahan), bool(f64), bool(lst), bool(scattered),
           bool(split), torch.device(device))
    n = _resident.get(key)
    if n is None:
        smem = smem_bytes(geometry, f64)
        if smem > SMEM_LIMIT_BYTES:
            raise RuntimeError(f"K1 {geometry} needs {smem} B of shared "
                               f"memory a block, above {SMEM_LIMIT_BYTES}")
        with torch.cuda.device(key[-1]):
            n = _lib.ehyb_stream_resident_blocks(
                geometry.rows, int(geometry.x_mode == "staged"), int(kahan),
                int(f64), geometry.threads, int(lst), int(scattered),
                int(split))
        if n <= 0:
            raise RuntimeError(f"K1 {geometry} cannot run (occupancy {n})")
        _resident[key] = n
    return n


def small_resident_blocks(geometry: StreamGeometry, kahan: bool, device,
                          f64: bool = False) -> int:
    """Blocks of the small form's kernel at ``geometry`` that stay resident
    on one SM of ``device`` (made once and kept); raises where not one
    does, as the launch would be refused."""
    key = ("small", geometry, bool(kahan), bool(f64), torch.device(device))
    n = _resident.get(key)
    if n is None:
        with torch.cuda.device(key[-1]):
            n = _lib.ehyb_stream_small_resident_blocks(
                int(kahan), int(f64), geometry.threads)
        if n <= 0:
            raise RuntimeError(f"K1's small form at {geometry} cannot run "
                               f"(occupancy {n})")
        _resident[key] = n
    return n


def small_registers(kahan: bool = False, f64: bool = False) -> int:
    """Registers a thread of the small form's kernel variant takes."""
    build_kernel()
    return _lib.ehyb_stream_small_registers(int(kahan), int(f64))


def registers(geometry: StreamGeometry, kahan: bool = False,
              f64: bool = False, scattered: bool = False,
              split: bool = False) -> int:
    """Registers a thread of the geometry's kernel variant takes."""
    build_kernel()
    return _lib.ehyb_stream_registers(
        geometry.rows, int(geometry.x_mode == "staged"), int(kahan),
        int(f64), int(scattered), int(split))


def smem_bytes(geometry: StreamGeometry, f64: bool = False) -> int:
    """Dynamic shared memory a block of the geometry takes."""
    build_kernel()
    return _lib.ehyb_stream_smem_bytes(
        geometry.rows, int(geometry.x_mode == "staged"), geometry.threads,
        int(f64))


def grid_of(p: StreamCellsDevice, geometry: StreamGeometry, kahan: bool,
            device, n_rb: int = None, lst: bool = False) -> int:
    """The persistent grid: the resident blocks of the card (of the list
    variant where ``lst``), or fewer where the row-block groups (of the
    plan, or of ``n_rb`` listed row blocks; a split plan's work items) do
    not give every warp one."""
    f64 = p.cell_val.dtype == torch.float64
    if small(p):
        per_sm = min(geometry.blocks_per_sm,
                     small_resident_blocks(geometry, kahan, device, f64))
        n_rb = p.n_items + p.n_hub_items
    else:
        per_sm = min(geometry.blocks_per_sm,
                     resident_blocks(geometry, kahan, device, f64, lst,
                                     scattered(p), split(p)))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_rb = (p.n_items if split(p) else p.n_rb) if n_rb is None else n_rb
    groups = -(-n_rb // geometry.rows)
    return max(1, min(per_sm * n_sm, -(-groups // (geometry.threads // 32))))


def scattered(p: StreamCellsDevice) -> bool:
    """Whether plan ``p`` has direct pieces or a row map: the forms of a
    scattered body, which the float64 kernel of their own reads."""
    return bool(p.cell_col.numel() or p.row_map.numel())


def _check(p: StreamCellsDevice, x_pad: torch.Tensor) -> None:
    """Refuse anything the kernel does not take."""
    dev = x_pad.device
    if x_pad.dtype not in DTYPES or x_pad.dim() != 1 \
            or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous 1-D float32 or float64 "
                         "tensor")
    n_x = p.stats["x_rows"]
    if x_pad.shape[0] < n_x:
        raise ValueError(f"x_pad has {x_pad.shape[0]} rows; the plan reads "
                         f"{n_x}")
    if p.cell_val.dtype != x_pad.dtype or p.cell_idx.dtype != torch.int16 \
            or p.cell_col.dtype != torch.int32 \
            or p.row_map.dtype != torch.int32:
        raise ValueError(f"the plan's cells must be {x_pad.dtype} values "
                         f"(x_pad's type), 16-bit indices and int32 columns "
                         f"and row map")
    if x_pad.dtype == torch.float32 and scattered(p):
        raise ValueError("the float32 K1 reads the table form only: no "
                         "direct pieces, no row map")
    if small(p) and (p.hub_val.dtype != x_pad.dtype
                     or p.hub_col.dtype != torch.int32):
        raise ValueError(f"the plan's hub cells must be {x_pad.dtype} "
                         "values and int32 columns")
    for t in (x_pad, p.piece, p.rows, p.cell_val, p.cell_idx, p.cell_col,
              p.row_map, p.item, p.chunk_first, p.partial, p.counter,
              p.hub_val, p.hub_col, p.hub_cell, p.hub_first, p.hub_row,
              p.hub_item):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, x_pad on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned (16-B "
                             "cell loads, cp.async)")


def _check_split(p: StreamCellsDevice, rb_list) -> None:
    """Refuse a list the plan's form is not read with: a plan in the split
    form takes a (k, 4) list of its work items
    (:func:`~.stream_cells.list_items`), the table form a 1-D list of row
    blocks."""
    if rb_list is None:
        return
    if small(p):
        raise ValueError("a plan in the small form takes no list (its "
                         "kernel walks the whole plan): build a listed "
                         "plan with stream_cells.k1_options(e, lists=True)")
    if split(p) and (rb_list.dim() != 2 or rb_list.shape[1] != 4):
        raise ValueError("a plan in the split form takes a (k, 4) list of "
                         "its work items (stream_cells.list_items), not a "
                         "row-block list")
    if not split(p) and rb_list.dim() != 1:
        raise ValueError("a plan in the table form takes a 1-D row-block "
                         "list, not a list of work items")


def _output(p: StreamCellsDevice, x_pad: torch.Tensor, rb_list, out):
    """The y a call writes: ``out`` (checked), or a new one, zeros where a
    list leaves rows unwritten."""
    n = p.n_rb * BLOCK_ROWS
    if rb_list is not None:
        if rb_list.dtype != torch.int32 or not rb_list.is_contiguous():
            raise ValueError("rb_list must be a contiguous int32 tensor")
        if rb_list.device != x_pad.device:
            raise ValueError(f"rb_list on {rb_list.device}, x_pad on "
                             f"{x_pad.device}")
    if out is None:
        return (torch.empty if rb_list is None else torch.zeros)(
            n, dtype=x_pad.dtype, device=x_pad.device)
    if out.dtype != x_pad.dtype or out.shape != (n,) \
            or not out.is_contiguous() or out.device != x_pad.device:
        raise ValueError(f"out must be a contiguous ({n},) {x_pad.dtype} "
                         f"tensor on {x_pad.device}")
    return out


def geometry_of(p: StreamCellsDevice) -> StreamGeometry:
    """The geometry a call over plan ``p`` takes: the small form's, the
    split form's or the table form's.  Which plans take the small form is
    ``stream_cells.small_form_wanted``'s rule: a split plan whose chunks
    are longer than ``SMALL_STEPS`` and whose work items fill at most
    ``SMALL_WAVE_SHARE`` of a wave."""
    if small(p):
        return SMALL_GEOMETRY
    return SPLIT_GEOMETRY if split(p) else GEOMETRY


def check_built(g: StreamGeometry, dtype: torch.dtype,
                split_form: bool = False, small_form: bool = False) -> None:
    """Refuse a geometry K1 is not built for in ``dtype``: float32 at every
    checked geometry; float64 at one row a thread with x through L1/L2
    (plain or Kahan, with or without a row-block list); the split variant
    (``split_form``) at one row a thread with x through L1/L2; the small
    form (``small_form``) at one row a thread with x through L1/L2."""
    g.check()
    if small_form:
        if g.rows != 1 or g.x_mode != "ldg":
            raise ValueError(f"no small-form K1 built for {g}: it is built "
                             "at one row a thread, x through L1/L2")
        return
    if split_form and (g.rows != 1 or g.x_mode != "ldg"):
        what = [f"rows={g.rows}"] if g.rows != 1 else []
        what += [f"x_mode={g.x_mode!r}"] if g.x_mode != "ldg" else []
        raise ValueError(f"no split K1 built for {g} ({', '.join(what)}): "
                         "it is built at one row a thread, x through L1/L2")
    if dtype == torch.float64 and (g.rows != 1 or g.x_mode != "ldg"):
        what = [f"rows={g.rows}"] if g.rows != 1 else []
        what += [f"x_mode={g.x_mode!r}"] if g.x_mode != "ldg" else []
        raise ValueError(f"no float64 K1 built for {g} ({', '.join(what)}):"
                         " float64 is built at one row a thread, x ldg")


def _launch(p: StreamCellsDevice, x_pad: torch.Tensor, kahan: bool = False,
            geometry: StreamGeometry = None, rb_list: torch.Tensor = None,
            out: torch.Tensor = None) -> torch.Tensor:
    """One launch at ``geometry`` (the default for the plan's form where
    None), counted."""
    chunked = split(p)
    g = geometry_of(p) if geometry is None else geometry
    _check(p, x_pad)
    _check_split(p, rb_list)
    check_built(g, x_pad.dtype, chunked, small(p))
    f64 = x_pad.dtype == torch.float64
    y = _output(p, x_pad, rb_list, out)
    build_kernel()
    if small(p):
        return _launch_small(p, x_pad, kahan, g, y)
    if rb_list is not None:
        n = rb_list.shape[0]
    else:
        n = p.n_items if chunked else p.n_rb
    if not n:
        return y
    ptr = lambda t: t.data_ptr() if t.numel() else None  # noqa: E731
    if chunked:
        # a list of work items is walked in place of the plan's
        items = p.item if rb_list is None else rb_list
        if items.data_ptr() % 16:
            raise ValueError("a list of work items must be 16-byte aligned "
                             "(the kernel reads an item with one 16-B load)")
        rc = _lib.ehyb_stream_body_split(
            p.piece.data_ptr(), p.rows.data_ptr(), p.cell_val.data_ptr(),
            ptr(p.cell_idx), ptr(p.cell_col), ptr(p.row_map),
            items.data_ptr(), p.chunk_first.data_ptr(),
            p.partial.data_ptr(), p.counter.data_ptr(), x_pad.data_ptr(),
            y.data_ptr(), n, int(bool(kahan)), int(f64), g.threads,
            grid_of(p, g, kahan, x_pad.device, n),
            torch.cuda.current_stream(x_pad.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ehyb_stream_body_split launch failed: CUDA "
                               f"error {rc}")
        stream_body.launches += 1
        return y
    rc = _lib.ehyb_stream_body(
        p.piece.data_ptr(), p.rows.data_ptr(), p.cell_val.data_ptr(),
        ptr(p.cell_idx), ptr(p.cell_col), ptr(p.row_map), x_pad.data_ptr(),
        y.data_ptr(), p.n_rb,
        None if rb_list is None else rb_list.data_ptr(), n,
        g.rows, int(g.x_mode == "staged"), int(bool(kahan)), int(f64),
        g.threads, grid_of(p, g, kahan, x_pad.device, n,
                           rb_list is not None),
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_stream_body launch failed: CUDA error {rc}")
    stream_body.launches += 1
    return y


def _launch_small(p: StreamCellsDevice, x_pad: torch.Tensor, kahan: bool,
                  g: StreamGeometry, y: torch.Tensor) -> torch.Tensor:
    """One launch of the small form's kernel over plan ``p``, counted."""
    if p.item.shape[1] != 8 or p.hub_item.shape[1] != 8:
        raise ValueError("a plan in the small form holds (n, 8) items")
    ptr = lambda t: t.data_ptr() if t.numel() else None  # noqa: E731
    rc = _lib.ehyb_stream_body_small(
        p.piece.data_ptr(), ptr(p.rows), ptr(p.cell_val), ptr(p.cell_idx),
        ptr(p.cell_col), ptr(p.row_map), p.item.data_ptr(), p.n_items,
        p.hub_item.data_ptr(), p.n_hub_items, p.hub_val.data_ptr(),
        p.hub_col.data_ptr(), p.partial.data_ptr(), p.counter.data_ptr(),
        x_pad.data_ptr(), y.data_ptr(), int(bool(kahan)),
        int(x_pad.dtype == torch.float64), g.threads,
        grid_of(p, g, kahan, x_pad.device),
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_stream_body_small launch failed: CUDA "
                           f"error {rc}")
    stream_body.launches += 1
    return y


def stream_body(p: StreamCellsDevice, x_pad: torch.Tensor,
                kahan: bool = False, rb_list: torch.Tensor = None,
                out: torch.Tensor = None) -> torch.Tensor:
    """SELL-body sums per row, flattened to (n_slices * 128,), over K1's
    compact plan ``p``.

    With ``rb_list`` (int32 row-block ids, each at most once; over a plan
    in the split form, the (k, 4) work items of the listed row blocks,
    :func:`~.stream_cells.list_items`) only those row blocks are computed
    and only their rows of the output are written (through the row map
    where the plan has one): into ``out`` where it is given (the sharded
    path fills one y with two calls over disjoint lists), else into a new
    y of zeros.

    CPU tensors take :func:`stream_body_plain`; CUDA tensors launch the
    kernel (``kahan`` selects the compensated variant; float64 x takes the
    float64 kernel; a plan in the split form the split variant) or
    raise."""
    if x_pad.device.type == "cpu":
        return stream_body_plain(p, x_pad, kahan, rb_list, out)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    return _launch(p, x_pad, kahan, rb_list=rb_list, out=out)


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
stream_body.launches = 0


def stream_body_plain(p: StreamCellsDevice, x_pad: torch.Tensor,
                      kahan: bool = False, rb_list: torch.Tensor = None,
                      out: torch.Tensor = None) -> torch.Tensor:
    """Plain-torch version of the kernel: read each cell's x through its
    piece's table (or at its column, in a piece with no table) and add the
    products per row in cell order (a row's step order; a row block's
    later pieces follow the main ones), into the row the row map names.  With
    ``kahan`` a float32 x sums in float64 and rounds once, the answer the
    compensated kernel reaches to about one ulp; a float64 x adds each
    row's products in the kernel's order with Neumaier compensation.  With
    ``rb_list`` (row blocks, or a split plan's work items) it writes the
    listed row blocks' rows of the full sums into ``out`` (or into zeros),
    as the kernel does.  A plan in the split form
    adds a chunk's products into its partial (a float64 x with ``kahan``:
    its (sum, compensation) pair), then a chunked row block's partials
    into y in chunk order (:func:`fold_pairs`), as the kernel does."""
    dev = x_pad.device
    _check_split(p, rb_list)
    if x_pad.shape[0] < p.stats["x_rows"]:
        raise ValueError(f"x_pad has {x_pad.shape[0]} rows; the plan reads "
                         f"{p.stats['x_rows']}")
    neumaier = kahan and x_pad.dtype == torch.float64
    acc = torch.float64 if kahan else x_pad.dtype
    n = p.n_rb * BLOCK_ROWS
    y = torch.zeros(n, dtype=acc, device=dev)
    # a float32 x with kahan sums whole rows in float64, chunked or not
    chunked = p.n_chunked > 0 and (neumaier or not kahan)
    if p.n_cells:
        piece = p.piece.long()
        cell_piece = torch.repeat_interleave(
            torch.arange(p.n_pieces, device=dev),
            torch.diff(piece[:, PIECE_CELL]), output_size=p.n_cells)
        first = piece[cell_piece]
        col = None
        if p.cell_idx.numel():
            idx = p.cell_idx.long() & 0xFFFF
            at = first[:, PIECE_ROW] + (idx >> 7)
            if p.cell_col.numel():
                # a direct piece's cells point at no table row
                at = at.clamp_max(max(p.rows.numel() - 1, 0))
            col = p.rows.long()[at] * LANES + (idx & (LANES - 1))
        if p.cell_col.numel():
            direct = p.cell_col.long()
            col = direct if col is None else torch.where(
                (torch.diff(piece[:, PIECE_ROW]) == 0)[cell_piece], direct,
                col)
        off = torch.arange(p.n_cells, device=dev) - first[:, PIECE_CELL]
        # the plan's row of each cell, or a chunk's row in its slot of 32
        # partials past y's rows
        row = first[:, PIECE_RB] * BLOCK_ROWS + off % BLOCK_ROWS
        n_ext = n
        if chunked:
            slot = p.piece_slot.long()[cell_piece]
            row = torch.where(slot >= 0, n + slot * BLOCK_ROWS
                              + off % BLOCK_ROWS, row)
            n_ext += p.n_chunks * BLOCK_ROWS
        contrib = p.cell_val.to(x_pad.dtype) * x_pad[col]
        if neumaier:
            # places counted from a chunk's first piece, or a whole row
            # block's
            width = torch.diff(piece[:, PIECE_CELL]) // BLOCK_ROWS
            group = piece[:-1, PIECE_RB]
            if chunked:
                ps = p.piece_slot.long()
                group = torch.where(ps >= 0, p.n_rb + ps, group)
            place = chain_offsets(group, width)[cell_piece] \
                + off // BLOCK_ROWS
            s, c = neumaier_pairs(
                contrib, row, place, n_ext, p.stats["max_item_steps"]
                if chunked else p.stats["max_row_cells"])
            y = s[:n] + c[:n]
            if chunked:
                fold_pairs(p, y, s[n:], c[n:])
        else:
            ext = torch.zeros(n_ext, dtype=acc, device=dev)
            ext.index_add_(0, row, contrib.to(acc))
            y = ext[:n]
            if chunked:
                # each chunked row block's partials into y, in chunk order
                slot_rb = p.chunk_rb.long()[torch.repeat_interleave(
                    torch.arange(p.n_chunked, device=dev),
                    torch.diff(p.chunk_first.long()),
                    output_size=p.n_chunks)]
                y.index_add_(0, (slot_rb[:, None] * BLOCK_ROWS + torch.arange(
                    BLOCK_ROWS, device=dev)).reshape(-1), ext[n:])
    if small(p):
        y = y.index_copy(0, p.hub_row.long(), hub_sums_plain(p, x_pad,
                                                               kahan))
    y = y.to(x_pad.dtype)
    if p.row_map.numel():
        y = torch.empty_like(y).index_copy_(0, p.row_map.long(), y)
    if rb_list is None:
        return y if out is None else out.copy_(y)
    out = _output(p, x_pad, rb_list, out)
    rb = rb_list.long() if rb_list.dim() == 1 else \
        p.piece[rb_list[:, ITEM_PIECE].long(), PIECE_RB].long()
    rows = (rb[:, None] * BLOCK_ROWS
            + torch.arange(BLOCK_ROWS, device=dev)).reshape(-1)
    if p.row_map.numel():
        rows = p.row_map.long()[rows]
    # a chunked row block's items name it once each: the same rows, the
    # same values
    return out.index_copy_(0, rows, y.index_select(0, rows))


def _combine(s, c, os, oc, neumaier: bool):
    """The small form's pair combine (``csrc/ehyb_stream.cu``): with
    ``neumaier`` (S, C) takes ``os`` by one Neumaier step, then C += oc;
    else S + os."""
    if not neumaier:
        return s + os, c
    t, cn = neumaier_add(s, c, os)
    return t, cn + oc


def _tree(s: torch.Tensor, c: torch.Tensor, neumaier: bool):
    """The warp's fixed shuffle tree over the last dimension's 32 lanes:
    at k = 16, 8, 4, 2, 1 lane l < k combines its pair with lane l + k's;
    lane 0's pair."""
    for k in (16, 8, 4, 2, 1):
        s_hi, c_hi = s[:, k:2 * k], c[:, k:2 * k]
        s, c = _combine(s[:, :k], c[:, :k], s_hi, c_hi, neumaier)
    return s[:, 0], c[:, 0]


def hub_sums_plain(p: StreamCellsDevice, x_pad: torch.Tensor,
                   kahan: bool = False) -> torch.Tensor:
    """The small form's hub rows, in its kernel's order step for step:
    lane l of a hub chunk adds its entries l, l + 32, ... in order; the
    32 lane sums meet in :func:`_tree`; a hub of one chunk takes its tree's
    sum, a longer one folds its chunks' partials (lane l adds slots l,
    l + 32, ... in order, then the tree).  A float64 x with ``kahan`` adds
    by Neumaier steps and combines pairs (:func:`_combine`), and a row is
    S + C; a float32 x with ``kahan`` sums each hub in float64 (the
    compensated kernel's answer to about one ulp).  Returns one sum a hub
    (float64 where ``kahan``)."""
    dev = x_pad.device
    prod = p.hub_val.to(x_pad.dtype) * x_pad[p.hub_col.long()]
    if kahan and x_pad.dtype == torch.float32:
        hub = torch.repeat_interleave(
            torch.arange(p.n_hubs, device=dev), torch.diff(p.hub_cell.long()),
            output_size=p.n_hub_cells)
        return torch.zeros(p.n_hubs, dtype=torch.float64,
                           device=dev).index_add_(0, hub, prod.double())
    neumaier = kahan
    it = p.hub_item.long()
    lane = torch.arange(BLOCK_ROWS, device=dev)
    s = prod.new_zeros(p.n_hub_items, BLOCK_ROWS)
    c = torch.zeros_like(s)
    for q in range(p.hub_steps):
        on = (q < it[:, HUB_STEPS_COL])[:, None]
        at = (it[:, HUB_CELL, None] + q * BLOCK_ROWS + lane).clamp_max(
            p.n_hub_cells - 1)
        t, cn = neumaier_add(s, c, prod[at]) if neumaier else (
            s + prod[at], c)
        s, c = torch.where(on, t, s), torch.where(on, cn, c)
    s, c = _tree(s, c, neumaier)
    # a hub of one chunk: its item's pair; a longer one's chunks: slots
    one = it[:, HUB_SLOT] < 0
    n_slots = p.n_hub_slots
    slot = torch.where(one, n_slots, it[:, HUB_SLOT])
    part_s = s.new_zeros(n_slots + 1).index_copy_(0, slot, s)
    part_c = s.new_zeros(n_slots + 1).index_copy_(0, slot, c)
    hub = torch.where(one, it[:, HUB_ID], p.n_hubs)
    out_s = s.new_zeros(p.n_hubs + 1).index_copy_(0, hub, s)[:-1]
    out_c = s.new_zeros(p.n_hubs + 1).index_copy_(0, hub, c)[:-1]
    first = p.hub_first.long()
    count = torch.diff(first)
    fs = s.new_zeros(p.n_hubs, BLOCK_ROWS)
    fc = torch.zeros_like(fs)
    for r in range(-(-p.max_fold // BLOCK_ROWS)):
        q = r * BLOCK_ROWS + lane
        on = q[None, :] < count[:, None]
        at = torch.where(on, first[:-1, None] + q, n_slots)
        t, cn = _combine(fs, fc, part_s[at], part_c[at], neumaier)
        fs, fc = torch.where(on, t, fs), torch.where(on, cn, fc)
    if p.n_hubs:
        fs, fc = _tree(fs, fc, neumaier)
        folded = count > 0
        out_s = torch.where(folded, fs, out_s)
        out_c = torch.where(folded, fc, out_c)
    return out_s + out_c if neumaier else out_s


def fold_pairs(p: StreamCellsDevice, y: torch.Tensor, s: torch.Tensor,
               c: torch.Tensor) -> None:
    """The compensated split variant's fold: each chunked row block's
    chunk pairs (``s``, ``c``: a sum and a compensation a partial) in
    chunk order, from (S, C) = (0, 0), S and C took ``v = s_i`` by one
    Neumaier step (t = S + v; C += (S - t) + v where |S| >= |v|, else
    (v - t) + S; S = t), then C += c_i; the row's y is S + C.  Writes
    the chunked row blocks' rows of ``y`` (plan rows)."""
    dev = y.device
    first = p.chunk_first.long()
    s, c = s.view(-1, BLOCK_ROWS), c.view(-1, BLOCK_ROWS)
    big_s = s.new_zeros(p.n_chunked, BLOCK_ROWS)
    big_c = s.new_zeros(p.n_chunked, BLOCK_ROWS)
    for i in range(p.max_chunks):
        at = first[:-1] + i
        has = (at < first[1:])[:, None]
        at = at.clamp_max(p.n_chunks - 1)
        t, cn = neumaier_add(big_s, big_c, s[at])
        big_s = torch.where(has, t, big_s)
        big_c = torch.where(has, cn + c[at], big_c)
    rows = (p.chunk_rb.long()[:, None] * BLOCK_ROWS
            + torch.arange(BLOCK_ROWS, device=dev)).reshape(-1)
    y[rows] = (big_s + big_c).reshape(-1)


class EhybStreamApply(torch.nn.Module):
    """Device apply of the flagship.  ``forward(x_pad)`` → padded y, of the
    body's length (``n_slices * 128`` rows; ``models/base.py``'s
    ``_resize_like`` fits it to x).

    Where K1 runs (``cells``, its plan on the device, which must hold the
    EHYB tail: :func:`~.stream_cells.k1_folded_plan`), a call is two
    launches: K1 writes y (body, ER, long and hub-split rows), then K9 adds
    the diagonals into it in place.  Where the window cache runs the body
    (``wincache``, its plan on the device), K9 adds into the window cache's
    y in place and the tail stays torch ops added into it
    (:func:`~.torch_ops.fold_split_`, :func:`~.torch_ops.add_tail_`).  An
    artifact with neither a body nor a tail is K9's alone."""

    def __init__(self, e: EhybDevice, kahan: bool = False,
                 cells: StreamCellsDevice = None,
                 wincache: WinCacheDevice = None, branch: str = ""):
        super().__init__()
        if cells is not None and wincache is not None or \
                e.body_nnz and cells is None and wincache is None:
            raise ValueError("a body needs exactly one plan: K1's cells or "
                             "the window cache's")
        if wincache is None and has_tail(e) and (
                cells is None or not cells.stats.get("folded")):
            raise ValueError("the artifact has ER, long-row or hub-split "
                             "entries, and K1's plan does not hold them: "
                             "build it with stream_cells.k1_folded_plan")
        self.e = e
        self.kahan = kahan
        self.cells = cells
        self.wincache = wincache
        #: The TPU branch the JAX flagship takes for this artifact.
        self.branch = branch
        #: y's rows: the body's.
        self.n_rows = e.slice_win_start.shape[0] * LANES
        #: The ER lanes before the padding (the window-cache path's tail).
        self.n_er_rows = int((e.er_rows < e.dim).sum()) \
            if wincache is not None else 0

    def body(self, x_pad: torch.Tensor) -> torch.Tensor:
        """The body's sums: K1's with the tail folded in, or the window
        cache's (the body alone)."""
        if self.wincache is not None:
            return wincache_body(self.e, self.wincache, x_pad, self.kahan)
        if self.cells is None:
            # everything went to DIA: nothing for the body to do
            return x_pad.new_zeros(self.n_rows)
        return stream_body(self.cells, x_pad, self.kahan)

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        e = self.e
        if self.wincache is not None:
            y = fold_split_(e, self.body(x_pad))
            dia_body(e, x_pad, out=y)
            return add_tail_(e, y, ehyb_er(e, x_pad), ehyb_long(e, x_pad),
                             self.n_er_rows)
        if self.cells is None and e.dia_offsets:
            return dia_body(e, x_pad)
        return dia_body(e, x_pad, out=self.body(x_pad))

    def phases(self) -> dict:
        """Each phase of the apply as a function of x_pad, by name: K1's
        (the body with the tail) and K9's; the window-cache path's body
        (the window cache), K9's and its torch ER and long rows."""
        e = self.e
        out = {"body": self.body, "dia": lambda x: dia_body(e, x)}
        if self.wincache is not None:
            out.update(er=lambda x: ehyb_er(e, x),
                       long=lambda x: ehyb_long(e, x))
        return out


def make_stream_apply(e: EhybMatrix, dev: EhybDevice, kahan: bool = False,
                      value_bytes: int = 4,
                      cache: str = None) -> EhybStreamApply:
    """The flagship's apply for this artifact: the TPU branch decides the
    body kernel.  Where the JAX package runs K3 or K4 (x past
    ``X_RESIDENT_BYTES`` and the window-cache plan schedules) the body goes
    through the window-cache kernel; everywhere else through K1, which
    computes the bodies of K2, K5 and K6 and the XLA fallbacks too, and
    the EHYB tail with them (its plan is ``k1_folded_plan``'s; an empty
    body with a tail gets a plan of the tail alone).

    Both kernels read a plan of the body's real cells, built here from
    ``e`` and uploaded beside ``dev``, so ``dev`` then gives up its padded
    cells (``ell_col`` and ``ell_val`` become None); ``e`` keeps them on
    the host.  The plan's build seconds are ``apply.plan_seconds``; with
    ``cache`` (the artifact's cache path) K1's plan is cached beside the
    artifact, and a cached one loaded (``stream_cells.k1_folded_plan``)."""
    branch = stream_plan.tpu_body_branch(e, value_bytes)
    device = dev.slice_offset.device
    cells = wincache = None
    t0 = time.perf_counter()
    if stream_plan.BRANCH_KERNEL[branch] in ("K3", "K4"):
        plan = build_wincache_plan(e)
        wincache = plan.to_torch(device)
        st = plan.stats
        log.info("body [%s on the TPU]: window-cache kernel, %d "
                 "blocks, %d stages (%d chunked slices), %.1f MB of cells "
                 "in place of %.1f MB padded, staged %.1f MB of %.1f MB "
                 "of x", branch, st["n_blocks"], st["n_stages"],
                 st["chunked_slices"], st["cell_bytes"] / 1e6,
                 st["body_bytes"] / 1e6, st["staged_bytes"] / 1e6,
                 st["x_bytes"] / 1e6)
    elif branch != "skipped" or has_tail(e):
        plan = k1_folded_plan(e, cache=cache)
        cells = plan.to_torch(device)
        st = plan.stats
        log.info("body [%s on the TPU]: K1 with the tail folded in (%d "
                 "cells of ER, long-row and hub-split entries), then K9 "
                 "into its y; %d row blocks (%d cut into pieces, %d in %d "
                 "chunks of at most %d steps), %.1f MB of cells in place "
                 "of %.1f MB padded", branch, st["tail_cells"], st["n_rb"],
                 st["split_rbs"], st["chunked_rbs"], st["n_chunks"],
                 st["split_steps"], st["cell_bytes"] / 1e6,
                 st["body_bytes"] / 1e6)
    else:
        log.info("body [%s on the TPU]: none (all DIA): K9 alone", branch)
    if cells is not None or wincache is not None:
        dev.ell_col = dev.ell_val = None
    apply = EhybStreamApply(dev, kahan=kahan, cells=cells,
                            wincache=wincache, branch=branch)
    apply.plan_seconds = time.perf_counter() - t0
    return apply
