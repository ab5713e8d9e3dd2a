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
plan's values and x are float32, or float64 (the precision mode,
``ops/dword.py``, and a ``dtype="float64"`` config), whose kernel is built
at one row a thread with x through L1/L2, plain or Kahan, with or without
a row-block list.
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
from .stream_cells import (BLOCK_ROWS, PIECE_CELL, PIECE_RB, PIECE_ROW,
                           StreamCellsDevice, build_stream_cells)
from .torch_ops import (chain_offsets, combine_ehyb, ehyb_er, ehyb_long,
                        neumaier_rows)

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

_lock = threading.Lock()
_built = None
_lib = None
#: (geometry, kahan, f64, list, device) → blocks of it resident on one SM.
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
                [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            lib.ehyb_stream_resident_blocks.restype = ctypes.c_int
            lib.ehyb_stream_resident_blocks.argtypes = [ctypes.c_int] * 6
            lib.ehyb_stream_registers.restype = ctypes.c_int
            lib.ehyb_stream_registers.argtypes = [ctypes.c_int] * 4
            lib.ehyb_stream_smem_bytes.restype = ctypes.c_longlong
            lib.ehyb_stream_smem_bytes.argtypes = [ctypes.c_int] * 4
            _built, _lib = built, lib
        return _built


def resident_blocks(geometry: StreamGeometry, kahan: bool, device,
                    f64: bool = False, lst: bool = False) -> int:
    """Blocks of this geometry (in float64 where ``f64``, its row-block list
    variant where ``lst``) that stay resident on one SM of ``device`` (made
    once and kept); raises where not one does, as the launch would be
    refused."""
    key = (geometry, bool(kahan), bool(f64), bool(lst), torch.device(device))
    n = _resident.get(key)
    if n is None:
        smem = smem_bytes(geometry, f64)
        if smem > SMEM_LIMIT_BYTES:
            raise RuntimeError(f"K1 {geometry} needs {smem} B of shared "
                               f"memory a block, above {SMEM_LIMIT_BYTES}")
        with torch.cuda.device(key[4]):
            n = _lib.ehyb_stream_resident_blocks(
                geometry.rows, int(geometry.x_mode == "staged"), int(kahan),
                int(f64), geometry.threads, int(lst))
        if n <= 0:
            raise RuntimeError(f"K1 {geometry} cannot run (occupancy {n})")
        _resident[key] = n
    return n


def registers(geometry: StreamGeometry, kahan: bool = False,
              f64: bool = False) -> int:
    """Registers a thread of the geometry's kernel variant takes."""
    build_kernel()
    return _lib.ehyb_stream_registers(
        geometry.rows, int(geometry.x_mode == "staged"), int(kahan),
        int(f64))


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
    plan, or of ``n_rb`` listed row blocks) do not give every warp one."""
    f64 = p.cell_val.dtype == torch.float64
    per_sm = min(geometry.blocks_per_sm,
                 resident_blocks(geometry, kahan, device, f64, lst))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_rb = p.n_rb if n_rb is None else n_rb
    groups = -(-n_rb // geometry.rows)
    return max(1, min(per_sm * n_sm, -(-groups // (geometry.threads // 32))))


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
    if p.cell_val.dtype != x_pad.dtype or p.cell_idx.dtype != torch.int16:
        raise ValueError(f"the plan's cells must be {x_pad.dtype} values "
                         f"(x_pad's type) and 16-bit indices")
    for t in (x_pad, p.piece, p.rows, p.cell_val, p.cell_idx):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, x_pad on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned (16-B "
                             "cell loads, cp.async)")


def _output(p: StreamCellsDevice, x_pad: torch.Tensor, rb_list, out):
    """The y a call writes: ``out`` (checked), or a new one, zeros where a
    list leaves rows unwritten."""
    n = p.n_rb * BLOCK_ROWS
    if rb_list is not None:
        if rb_list.dtype != torch.int32 or rb_list.dim() != 1 \
                or not rb_list.is_contiguous():
            raise ValueError("rb_list must be a contiguous 1-D int32 tensor")
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


def check_built(g: StreamGeometry, dtype: torch.dtype) -> None:
    """Refuse a geometry K1 is not built for in ``dtype``: float32 at every
    checked geometry; float64 at one row a thread with x through L1/L2
    (plain or Kahan, with or without a row-block list)."""
    g.check()
    if dtype == torch.float64 and (g.rows != 1 or g.x_mode != "ldg"):
        what = [f"rows={g.rows}"] if g.rows != 1 else []
        what += [f"x_mode={g.x_mode!r}"] if g.x_mode != "ldg" else []
        raise ValueError(f"no float64 K1 built for {g} ({', '.join(what)}):"
                         " float64 is built at one row a thread, x ldg")


def _launch(p: StreamCellsDevice, x_pad: torch.Tensor, kahan: bool = False,
            geometry: StreamGeometry = None, rb_list: torch.Tensor = None,
            out: torch.Tensor = None) -> torch.Tensor:
    """One launch at ``geometry`` (the default where None), counted."""
    g = GEOMETRY if geometry is None else geometry
    _check(p, x_pad)
    check_built(g, x_pad.dtype)
    f64 = x_pad.dtype == torch.float64
    y = _output(p, x_pad, rb_list, out)
    build_kernel()
    n = p.n_rb if rb_list is None else rb_list.shape[0]
    if not n:
        return y
    rc = _lib.ehyb_stream_body(
        p.piece.data_ptr(), p.rows.data_ptr(), p.cell_val.data_ptr(),
        p.cell_idx.data_ptr(), x_pad.data_ptr(), y.data_ptr(), p.n_rb,
        None if rb_list is None else rb_list.data_ptr(), n,
        g.rows, int(g.x_mode == "staged"), int(bool(kahan)), int(f64),
        g.threads, grid_of(p, g, kahan, x_pad.device, n,
                           rb_list is not None),
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_stream_body launch failed: CUDA error {rc}")
    stream_body.launches += 1
    return y


def stream_body(p: StreamCellsDevice, x_pad: torch.Tensor,
                kahan: bool = False, rb_list: torch.Tensor = None,
                out: torch.Tensor = None) -> torch.Tensor:
    """SELL-body sums per row, flattened to (n_slices * 128,), over K1's
    compact plan ``p``.

    With ``rb_list`` (int32 row-block ids, each at most once) only those
    row blocks are computed and only their rows of the output are written:
    into ``out`` where it is given (the sharded path fills one y with two
    calls over disjoint lists), else into a new y of zeros.

    CPU tensors take :func:`stream_body_plain`; CUDA tensors launch the
    kernel (``kahan`` selects the compensated variant; float64 x takes the
    float64 kernel) or raise."""
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
    piece's table and add the products per row in cell order (a row's step
    order; a row block's later pieces follow the main ones).  With
    ``kahan`` a float32 x sums in float64 and rounds once, the answer the
    compensated kernel reaches to about one ulp; a float64 x adds each
    row's products in the kernel's order with Neumaier compensation.  With
    ``rb_list`` it writes the listed row blocks' rows of the full sums into
    ``out`` (or into zeros), as the kernel does."""
    dev = x_pad.device
    neumaier = kahan and x_pad.dtype == torch.float64
    acc = torch.float64 if kahan else x_pad.dtype
    y = torch.zeros(p.n_rb * BLOCK_ROWS, dtype=acc, device=dev)
    if p.n_cells:
        piece = p.piece.long()
        cell_piece = torch.repeat_interleave(
            torch.arange(p.n_pieces, device=dev),
            torch.diff(piece[:, PIECE_CELL]), output_size=p.n_cells)
        first = piece[cell_piece]
        idx = p.cell_idx.long() & 0xFFFF
        col = p.rows.long()[first[:, PIECE_ROW] + (idx >> 7)] * LANES \
            + (idx & (LANES - 1))
        off = torch.arange(p.n_cells, device=dev) - first[:, PIECE_CELL]
        row = first[:, PIECE_RB] * BLOCK_ROWS + off % BLOCK_ROWS
        contrib = p.cell_val.to(x_pad.dtype) * x_pad[col]
        if neumaier:
            width = torch.diff(piece[:, PIECE_CELL]) // BLOCK_ROWS
            place = chain_offsets(piece[:-1, PIECE_RB], width)[cell_piece] \
                + off // BLOCK_ROWS
            y = neumaier_rows(contrib, row, place, y.shape[0],
                              p.stats["max_row_cells"])
        else:
            y.index_add_(0, row, contrib.to(acc))
    y = y.to(x_pad.dtype)
    if rb_list is None:
        return y if out is None else out.copy_(y)
    out = _output(p, x_pad, rb_list, out)
    rb = rb_list.long()
    out.view(-1, BLOCK_ROWS).index_copy_(
        0, rb, y.view(-1, BLOCK_ROWS).index_select(0, rb))
    return out


class EhybStreamApply(torch.nn.Module):
    """Device apply of the flagship: the body kernel, the DIA kernel and the
    torch ER, long-row and combine phases.  ``forward(x_pad)`` → padded y.

    The body runs through the window-cache kernel when ``wincache`` (its
    plan on the device) is given, else through K1 over ``cells`` (its
    plan on the device)."""

    def __init__(self, e: EhybDevice, kahan: bool = False,
                 cells: StreamCellsDevice = None,
                 wincache: WinCacheDevice = None, branch: str = ""):
        super().__init__()
        if e.body_nnz and (cells is None) == (wincache is None):
            raise ValueError("a body needs exactly one plan: K1's cells or "
                             "the window cache's")
        self.e = e
        self.kahan = kahan
        self.cells = cells
        self.wincache = wincache
        #: The TPU branch the JAX flagship takes for this artifact.
        self.branch = branch

    def body(self, x_pad: torch.Tensor) -> torch.Tensor:
        e = self.e
        if e.body_nnz == 0:
            # everything went to DIA/ER/long: nothing for the body to do
            return x_pad.new_zeros(e.slice_win_start.shape[0] * LANES)
        if self.wincache is not None:
            return wincache_body(e, self.wincache, x_pad, self.kahan)
        return stream_body(self.cells, x_pad, self.kahan)

    def forward(self, x_pad: torch.Tensor) -> torch.Tensor:
        e = self.e
        return combine_ehyb(e, self.body(x_pad), ehyb_er(e, x_pad),
                            ehyb_long(e, x_pad), dia_body(e, x_pad))

    def phases(self) -> dict:
        """Each phase of the apply as a function of x_pad, by name."""
        e = self.e
        return {"dia": lambda x: dia_body(e, x), "body": self.body,
                "er": lambda x: ehyb_er(e, x),
                "long": lambda x: ehyb_long(e, x)}


def make_stream_apply(e: EhybMatrix, dev: EhybDevice, kahan: bool = False,
                      value_bytes: int = 4) -> EhybStreamApply:
    """The flagship's apply for this artifact: the TPU branch decides the
    body kernel.  Where the JAX package runs K3 or K4 (x past
    ``X_RESIDENT_BYTES`` and the window-cache plan schedules) the body goes
    through the window-cache kernel; everywhere else through K1, which
    computes the bodies of K2, K5 and K6 and the XLA fallbacks too.

    Both kernels read a plan of the body's real cells, built here from
    ``e`` and uploaded beside ``dev``, so ``dev`` then gives up its padded
    cells (``ell_col`` and ``ell_val`` become None); ``e`` keeps them on
    the host.  The plan's build seconds are ``apply.plan_seconds``."""
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
    elif branch != "skipped":
        plan = build_stream_cells(e)
        cells = plan.to_torch(device)
        st = plan.stats
        log.info("body [%s on the TPU]: K1, %d row blocks (%d cut for the "
                 "16-bit range), %.1f MB of cells in place of %.1f MB "
                 "padded", branch, st["n_rb"], st["split_rbs"],
                 st["cell_bytes"] / 1e6, st["body_bytes"] / 1e6)
    else:
        log.info("body [%s on the TPU]: none (all DIA/ER/long)", branch)
    if cells is not None or wincache is not None:
        dev.ell_col = dev.ell_val = None
    apply = EhybStreamApply(dev, kahan=kahan, cells=cells,
                            wincache=wincache, branch=branch)
    apply.plan_seconds = time.perf_counter() - t0
    return apply
