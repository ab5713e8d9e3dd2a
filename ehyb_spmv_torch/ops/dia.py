"""The DIA body on the GPU: host plan, wrapper and plain version.

Port counterpart of ``ehyb_spmv_gpu_tpu/ops/dia_pallas.py``
(``make_dia_pallas_apply``, the Pallas kernel K9, in both its x-resident and
x-streamed variants).  The kernel is ``csrc/dia.cu``; its header says what
it computes, what bounds it on the H100 and how its design answers that.

The kernel's geometry is a host plan (:func:`make_plan`): the offset runs,
the tile rows, the persistent grid, the staged x windows and the table the
kernel reads.  :func:`device_plan` makes it once per (offsets, rows, layout,
device) and keeps its table on the card, so a call copies nothing to the
card and can be captured in a CUDA graph.

:func:`dia_body` launches the kernel for tensors on a CUDA device and takes
the plain version :func:`dia_body_plain` (the shifted-slice torch op) only
for tensors on the CPU.  A CUDA call launches the kernel or raises.  Values
and x are float32, or float64 for the precision mode (``ops/dword.py``),
whose kernel is built for the default (STEP, QUADS) in both x modes; its
plan counts what 16 B hold in doubles (:func:`make_plan`'s
``value_bytes``).  With ``out`` the kernel runs in its accumulate mode
(built at the default (STEP, QUADS)): each row's diagonal sum is added once
into ``out`` in place, which is how the flagship's apply finishes the y K1
wrote (``ops/ehyb_stream.py``).  With ``x_base`` row i reads
``x[x_base + i + d_k]``: the sharded apply's diagonals read a shard's
``x_ext`` past its left halo (``parallel/spmv.py``).  The plan holds the
base as shifted offsets (:func:`make_plan`), so the kernel reads x at row
plus offset as it always did, and a plan at base 0 is the plan it was.

A DIA part too small to fill the card takes the kernel's spread form
(:class:`SpreadGeometry`: a tile of rows and all its diagonals a block, the
products over the block's threads, each row summed in order of k by one
thread).  :func:`choose_geometry` picks it where the default grid fills
at most a quarter of one wave and the diagonals are six or more, where
the card measured it faster; both forms give the plain version's values
bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Iterator, Tuple

import torch

from ..core.ehyb import EhybDevice
from .build import BuiltLibrary, build_cuda_library
from .torch_ops import dia_terms

#: Shared memory one block may hold on the H100 (232,448 bytes).
SMEM_LIMIT_BYTES = 227 * 1024
#: Two neighbouring offsets at most this far apart fall in one run (one
#: staged window); fem3d's 27-point stencil gives 9 runs of 11.
RUN_GAP = 16
#: The (STEP, QUADS) pairs ``csrc/dia.cu`` is built for: the default
#: geometry's and its neighbours along each axis, for the sweep.
BUILT_STEPS = ((2, 1), (4, 1), (8, 1), (4, 2))
#: The (STEP, QUADS) pairs built in float64: the default geometry's.
BUILT_STEPS_F64 = ((4, 1),)
#: The (STEP, QUADS) pairs the accumulate mode is built for, in float32 and
#: float64: the default geometry's.
BUILT_STEPS_ACC = ((4, 1),)
X_MODES = ("ldg", "staged")
#: The spread form's tile rows (powers of two up to its 256 threads); the
#: form is built in float32 and float64, in the write and the accumulate
#: mode.
SPREAD_ROWS = (32, 64, 128, 256)
#: Value types the kernel is built for, by their size in bytes.
DTYPES = {4: torch.float32, 8: torch.float64}


@dataclasses.dataclass(frozen=True)
class DiaGeometry:
    """How the kernel walks the rows.

    ``threads`` per block; ``quads`` groups of 4 rows per thread per tile
    (a tile is ``4 * threads * quads`` rows); ``step`` diagonals whose
    values each thread requests together; ``blocks_per_sm`` the persistent
    grid's blocks on each SM (fewer where they do not fit); ``x_mode``
    ``"ldg"`` (x through L1/L2) or ``"staged"`` (x per offset run in shared
    memory, filled a tile ahead).  The blocks take the tiles round-robin
    (:meth:`DiaPlan.tiles`)."""
    threads: int = 128
    quads: int = 1
    step: int = 4
    blocks_per_sm: int = 8
    x_mode: str = "ldg"

    @property
    def tile_rows(self) -> int:
        return 4 * self.threads * self.quads

    @property
    def variant(self) -> Tuple[int, int, int, int]:
        """The kernel variant's (step, quads, staged, spread rows) as
        ``csrc/dia.cu::pick`` takes them."""
        return self.step, self.quads, int(self.x_mode == "staged"), 0

    def check(self, value_bytes: int = 4, acc: bool = False) -> None:
        if value_bytes not in DTYPES:
            raise ValueError(f"no kernel built for {value_bytes}-byte values")
        built = BUILT_STEPS if value_bytes == 4 else BUILT_STEPS_F64
        if acc:
            built = BUILT_STEPS_ACC
        if (self.step, self.quads) not in built:
            raise ValueError(f"no kernel built for step {self.step}, quads "
                             f"{self.quads} in {value_bytes}-byte values"
                             f"{' (accumulate mode)' if acc else ''} "
                             f"(built: {built})")
        if self.x_mode not in X_MODES:
            raise ValueError(f"x_mode {self.x_mode!r} not in {X_MODES}")
        if not (32 <= self.threads <= 512 and self.threads % 32 == 0):
            raise ValueError(f"threads {self.threads}: a multiple of 32 up "
                             "to 512")
        if self.blocks_per_sm < 1:
            raise ValueError("blocks_per_sm must be at least 1")


#: The geometry every call takes where the card is full
#: (``chip_dia_sweep.py`` chose it).
GEOMETRY = DiaGeometry()


@dataclasses.dataclass(frozen=True)
class SpreadGeometry:
    """The kernel's spread form (``csrc/dia.cu``, ``dia_kernel_spread``).

    A block takes a tile of ``rows`` consecutive rows (one of
    :data:`SPREAD_ROWS`) and all its diagonals, ``chunk`` at a time; its
    ``threads`` split the tile's products, and thread r sums row r's in
    order of k.  The tiles are dealt round-robin to at most
    ``blocks_per_sm`` blocks on each SM.  x is read through L1/L2."""
    rows: int = 64
    chunk: int = 64

    threads = 256
    blocks_per_sm = 8

    @property
    def tile_rows(self) -> int:
        return self.rows

    @property
    def variant(self) -> Tuple[int, int, int, int]:
        """The kernel variant's (step, quads, staged, spread rows) as
        ``csrc/dia.cu::pick`` takes them."""
        return 0, 0, 0, self.rows

    def check(self, value_bytes: int = 4, acc: bool = False) -> None:
        if value_bytes not in DTYPES:
            raise ValueError(f"no kernel built for {value_bytes}-byte values")
        if self.rows not in SPREAD_ROWS:
            raise ValueError(f"rows {self.rows}: one of {SPREAD_ROWS}")
        if self.chunk < 1:
            raise ValueError("chunk must be at least 1")


#: :func:`choose_geometry` takes the spread form only where the default
#: geometry's tiles fill at most 1 / SPREAD_WAVE_SHARE of the wave and the
#: diagonals are at least SPREAD_MIN_DIAGONALS.  Set on an H100
#: (``chip_dia_sweep.py --small``; spread / default time): 0.33 at
#: stencil27_24 (27 diagonals, the default's tiles 0.03 of the wave), 0.42
#: at fem3d_32 (99, 0.18), 0.87 at stencil3d(32, 7) (7, 0.06); 1.04 at
#: poisson2d(256) (5, 0.12); 1.02-1.07 at 5, 9 and 13 diagonals of 262,144
#: rows (0.48), 1.24 at one.
SPREAD_WAVE_SHARE = 4
SPREAD_MIN_DIAGONALS = 6


def spread_geometry(dim_r: int, n_sm: int, resident: int) -> SpreadGeometry:
    """The spread form for ``dim_r`` rows on a card of ``n_sm`` SMs where
    ``resident`` blocks of the default geometry stay on each: tiles of the
    fewest rows of :data:`SPREAD_ROWS` (up to its threads) whose tiles fit
    in that one wave of blocks, each block a tile."""
    wave = n_sm * min(GEOMETRY.blocks_per_sm, resident)
    rows = next((r for r in SPREAD_ROWS if -(-dim_r // r) <= wave),
                SPREAD_ROWS[-1])
    return SpreadGeometry(rows=rows)


def choose_geometry(dim_r: int, n_diag: int, n_sm: int, resident: int):
    """The geometry a call of ``n_diag`` diagonals of ``dim_r`` rows takes
    on a card of ``n_sm`` SMs where ``resident`` blocks of the default
    geometry stay on each (one wave): :func:`spread_geometry`'s where the
    default's tiles fill at most ``1 / SPREAD_WAVE_SHARE`` of the wave and
    the diagonals are at least ``SPREAD_MIN_DIAGONALS``, else
    :data:`GEOMETRY`.  A pure function of its arguments."""
    g = GEOMETRY
    tiles = -(-((dim_r + 3) // 4) // (g.threads * g.quads))
    wave = n_sm * min(g.blocks_per_sm, resident)
    if SPREAD_WAVE_SHARE * tiles > wave or n_diag < SPREAD_MIN_DIAGONALS:
        return g
    return spread_geometry(dim_r, n_sm, resident)


def offset_runs(offsets) -> Tuple[Tuple[int, int, int, int], ...]:
    """Maximal runs of the sorted offsets whose neighbours are at most
    ``RUN_GAP`` apart, as (first offset, last offset, first k, end k)."""
    runs, k0 = [], 0
    for k in range(1, len(offsets) + 1):
        if k == len(offsets) or offsets[k] - offsets[k - 1] > RUN_GAP:
            runs.append((offsets[k0], offsets[k - 1], k0, k))
            k0 = k
    return tuple(runs)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """The kernel's geometry for one DIA part (see ``csrc/dia.cu``).

    The rows are ``nq = ceil(dim_r / 4)`` quads of 4, cut into tiles of at
    most ``tile_quads`` quads (:meth:`tiles`).  In the staged mode run r's
    window for the tile that starts at row t0 holds x[t0 + wlo_r + j],
    j < width_r, at ``base_r + j`` of a buffer of ``stage_floats`` values;
    diagonal k reads its 16-B loads from ``xo_k + (row - t0)``.  Windows,
    bases and reads are aligned to what one 16-B load holds
    (:attr:`per_load`: 4 floats, or 2 doubles).  In the spread form
    (:attr:`spread`) the tiles are ``geometry.rows`` rows and nothing is
    staged."""
    geometry: "DiaGeometry | SpreadGeometry"
    offsets: Tuple[int, ...]
    dim_r: int
    grid: int
    runs: Tuple[Tuple[int, int, int, int], ...]
    #: Per run: (base, wlo, width) in values (multiples of ``per_load``).
    windows: Tuple[Tuple[int, int, int], ...]
    #: Per diagonal: where its reads start in the staged buffer.
    xo: Tuple[int, ...]
    stage_floats: int
    smem_bytes: int
    #: Bytes of a value: 4 (float32) or 8 (float64).
    value_bytes: int = 4
    #: Where row 0's diagonal 0 reads x: ``offsets`` are the diagonals'
    #: offsets plus this base.
    x_base: int = 0

    @property
    def per_load(self) -> int:
        """Values one 16-B load holds."""
        return 16 // self.value_bytes

    @property
    def staged(self) -> bool:
        return bool(self.geometry.variant[2])

    @property
    def spread(self) -> bool:
        """The spread form (tiles of ``geometry.rows`` rows, the products
        spread over a block)."""
        return isinstance(self.geometry, SpreadGeometry)

    @property
    def chunk(self) -> int:
        """The spread form's diagonals a chunk (0 in the quad form)."""
        return min(self.geometry.chunk, len(self.offsets)) \
            if self.spread else 0

    @property
    def tile_quads(self) -> int:
        """The quad form's quads a tile (0 in the spread form)."""
        return 0 if self.spread else \
            self.geometry.threads * self.geometry.quads

    def table(self) -> list:
        """The int32 table the kernel copies to shared memory: the offsets,
        then (staged) each diagonal's window start and each run's (base,
        wlo, width, 0)."""
        out = list(self.offsets)
        if self.staged:
            out += list(self.xo)
            for w in self.windows:
                out += [*w, 0]
        return out

    def tiles(self, b: int) -> Iterator[Tuple[int, int]]:
        """Block b's tiles as row ranges [t0, t1), in the kernel's order
        (``csrc/dia.cu::block_walk``): tiles b, b + grid, ... of one size,
        as many for every block give or take one; in the spread form
        tiles b, b + grid, ... of ``geometry.rows`` rows
        (``dia_kernel_spread``)."""
        if self.spread:
            r = self.geometry.rows
            for t0 in range(b * r, self.dim_r, self.grid * r):
                yield t0, min(t0 + r, self.dim_r)
            return
        nq, g = (self.dim_r + 3) // 4, self.grid
        rounds = -(-nq // (g * self.tile_quads))
        tq = -(-nq // (g * rounds))
        for qa in range(b * tq, nq, g * tq):
            yield 4 * qa, min(4 * (qa + tq), self.dim_r)

    def window(self, r: int, t0: int) -> Tuple[int, int]:
        """The x indices [start, stop) run r's window stages for the tile
        that starts at row t0."""
        _, wlo, width = self.windows[r]
        return t0 + wlo, t0 + wlo + width

    @property
    def stats(self) -> dict:
        k, n, vb = len(self.offsets), self.dim_r, self.value_bytes
        n_tiles = sum(1 for b in range(self.grid) for _ in self.tiles(b))
        return dict(
            grid=self.grid, runs=len(self.runs),
            tile_rows=self.geometry.tile_rows, smem_bytes=self.smem_bytes,
            # x the staged windows read from L2, all tiles together
            staged_bytes=vb * n_tiles * self.stage_floats,
            # what the function needs: each value once, x and y once
            layout_bytes=vb * (k * n + 2 * n))


def make_plan(offsets, dim_r: int, geometry: DiaGeometry = GEOMETRY,
              blocks: int = 8 * 132, value_bytes: int = 4,
              acc: bool = False, x_base: int = 0) -> DiaPlan:
    """The kernel's geometry for ``len(offsets)`` diagonals of ``dim_r``
    rows of ``value_bytes``-byte values, on a grid of at most ``blocks``
    blocks (the resident blocks of the card; fewer where the rows are fewer
    than a tile per block); ``acc``: for the accumulate mode; ``x_base``:
    where row 0 reads x, held as every offset shifted by it (row i's
    diagonal k reads ``x[i + d_k + x_base]``, the kernel's ``x[i + d]``)."""
    geometry.check(value_bytes, acc)
    offsets = tuple(int(d) + int(x_base) for d in offsets)
    if not offsets or list(offsets) != sorted(set(offsets)):
        raise ValueError("offsets must be distinct, sorted and not empty")
    if max(abs(offsets[0]), abs(offsets[-1])) >= 2 ** 30:
        raise ValueError("diagonal offsets out of int32 range")
    runs = offset_runs(offsets)
    if isinstance(geometry, SpreadGeometry):
        return _spread_plan(geometry, offsets, int(dim_r), runs, blocks,
                            value_bytes, int(x_base))
    t = geometry.tile_rows
    # the values a 16-B load holds, and the mask that aligns an index to it
    a = 16 // value_bytes
    align = ~(a - 1)
    windows, xo, base = [], [0] * len(offsets), 0
    for lo, hi, k0, k1 in runs:
        wlo = lo & align
        # the last quad of a tile reads 4 + a values from
        # (t - 4) + (hi & align)
        width = t + a + (hi & align) - wlo
        windows.append((base, wlo, width))
        for k in range(k0, k1):
            xo[k] = base + (offsets[k] & align) - wlo
        base += width
    staged = geometry.x_mode == "staged"
    stage_floats = base if staged else 0
    n_table = len(offsets) + (len(offsets) + 4 * len(runs) if staged else 0)
    smem = value_bytes * 2 * stage_floats + 4 * n_table
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"DIA plan needs {smem} B of shared memory per "
                         f"block ({len(runs)} runs of tiles of {t} rows), "
                         f"above {SMEM_LIMIT_BYTES}")
    nq = (dim_r + 3) // 4
    grid = max(1, min(blocks, -(-nq // (geometry.threads * geometry.quads))))
    return DiaPlan(geometry=geometry, offsets=offsets, dim_r=int(dim_r),
                   grid=grid, runs=runs, windows=tuple(windows),
                   xo=tuple(xo), stage_floats=stage_floats, smem_bytes=smem,
                   value_bytes=value_bytes, x_base=int(x_base))


def _spread_plan(geometry: SpreadGeometry, offsets: tuple, dim_r: int,
                 runs: tuple, blocks: int, value_bytes: int,
                 x_base: int) -> DiaPlan:
    """:func:`make_plan` for the spread form: a buffer of a chunk's
    products (``chunk x rows`` values) and the offsets in shared memory,
    a grid of a block a tile up to ``blocks``."""
    chunk = min(geometry.chunk, len(offsets))
    smem = value_bytes * chunk * geometry.rows + 4 * len(offsets)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"DIA plan needs {smem} B of shared memory per "
                         f"block ({chunk} diagonals of {geometry.rows} "
                         f"rows), above {SMEM_LIMIT_BYTES}")
    grid = max(1, min(blocks, -(-dim_r // geometry.rows)))
    return DiaPlan(geometry=geometry, offsets=offsets, dim_r=dim_r,
                   grid=grid, runs=runs, windows=(),
                   xo=(0,) * len(offsets), stage_floats=0, smem_bytes=smem,
                   value_bytes=value_bytes, x_base=x_base)


_lock = threading.Lock()
_built = None
_lib = None
#: (offsets, dim_r, vec, geometry, value bytes, accumulate mode, x base,
#: device) → (plan, its table on the card),
#: made once so that a call (and a CUDA graph capture of it) copies nothing
#: to the card.
_plans: dict = {}


def build_kernel() -> BuiltLibrary:
    """Compile ``csrc/dia.cu`` (once per process) and return the library's
    path, build time and ptxas report."""
    global _built, _lib
    with _lock:
        if _built is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the DIA kernel needs a CUDA device; "
                                   "none is available")
            built = build_cuda_library("ehyb_dia", ["dia.cu"])
            lib = ctypes.CDLL(built.path)
            lib.ehyb_dia.restype = ctypes.c_int
            lib.ehyb_dia.argtypes = ([
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                + [ctypes.c_int] * 12 + [ctypes.c_longlong, ctypes.c_void_p])
            lib.ehyb_dia_registers.restype = ctypes.c_int
            lib.ehyb_dia_registers.argtypes = [ctypes.c_int] * 7
            lib.ehyb_dia_resident_blocks.restype = ctypes.c_int
            lib.ehyb_dia_resident_blocks.argtypes = [ctypes.c_int] * 8 + [
                ctypes.c_longlong]
            _built, _lib = built, lib
        return _built


def resident_blocks(geometry, smem_bytes: int, vec: bool,
                    device, value_bytes: int = 4, acc: bool = False) -> int:
    """Blocks of this geometry (in the accumulate mode where ``acc``) that
    stay resident on one SM of ``device`` (the kernel's occupancy at its
    registers and shared memory); raises where not one does, as the launch
    would be refused."""
    build_kernel()
    with torch.cuda.device(device):
        step, quads, staged, rows = geometry.variant
        n = _lib.ehyb_dia_resident_blocks(
            step, quads, staged, int(vec), int(value_bytes == 8), int(acc),
            rows, geometry.threads, smem_bytes)
    if n <= 0:
        raise RuntimeError(f"DIA kernel {geometry} with {smem_bytes} B of "
                           f"shared memory cannot run (occupancy {n})")
    return n


def registers(geometry, vec: bool, value_bytes: int = 4,
              acc: bool = False) -> int:
    """Registers a thread of the geometry's kernel variant takes."""
    build_kernel()
    step, quads, staged, rows = geometry.variant
    return _lib.ehyb_dia_registers(step, quads, staged, int(vec),
                                   int(value_bytes == 8), int(acc), rows)


def _per_sm(geometry, offsets: tuple, dim_r: int, vec: bool, device,
            value_bytes: int, acc: bool, x_base: int) -> int:
    """The geometry's blocks on one SM: its ``blocks_per_sm``, or fewer
    where fewer stay resident."""
    probe = make_plan(offsets, dim_r, geometry, 1, value_bytes, acc, x_base)
    return min(geometry.blocks_per_sm,
               resident_blocks(geometry, probe.smem_bytes, vec, device,
                               value_bytes, acc))


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_plan(offsets: tuple, dim_r: int, vec: bool, device,
                geometry=None, value_bytes: int = 4,
                acc: bool = False, x_base: int = 0):
    """The plan for these diagonals on ``device`` (in the accumulate mode
    where ``acc``, reading x from ``x_base``) at ``geometry``, or where
    None at :func:`choose_geometry`'s, and its table on the card (made once
    and kept)."""
    device = torch.device(device)
    key = (offsets, dim_r, vec, geometry, value_bytes, acc, x_base, device)
    hit = _plans.get(key)
    if hit is None:
        args = (offsets, dim_r, vec, device, value_bytes, acc, x_base)
        if geometry is None:
            per_sm = _per_sm(GEOMETRY, *args)
            geometry = choose_geometry(dim_r, len(offsets), _n_sm(device),
                                       per_sm)
        per_sm = _per_sm(geometry, *args)
        plan = make_plan(offsets, dim_r, geometry, per_sm * _n_sm(device),
                         value_bytes, acc, x_base)
        hit = (plan, torch.tensor(plan.table(), dtype=torch.int32,
                                  device=device))
        _plans[key] = hit
    return hit


def _check(e: EhybDevice, x_pad: torch.Tensor) -> None:
    """Refuse anything the kernel does not take."""
    if x_pad.dtype not in DTYPES.values() or x_pad.dim() != 1 \
            or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous 1-D float32 or float64 "
                         "tensor")
    if x_pad.data_ptr() % 16:
        raise ValueError("x_pad must start on a 16-byte boundary (the "
                         "kernel reads x with 16-byte loads)")
    v = e.dia_val
    if v.dtype != x_pad.dtype or v.dim() != 2 or not v.is_contiguous():
        raise ValueError(f"dia_val must be a contiguous (K, dim_r) "
                         f"{x_pad.dtype} tensor (x_pad's type)")
    if v.shape[0] != len(e.dia_offsets):
        raise ValueError(f"dia_val has {v.shape[0]} rows for "
                         f"{len(e.dia_offsets)} offsets")
    if v.device != x_pad.device:
        raise ValueError(f"dia_val on {v.device}, x_pad on {x_pad.device}")


def _check_out(e: EhybDevice, x_pad: torch.Tensor, out) -> None:
    """Refuse an ``out`` the accumulate mode cannot add into."""
    if out is None:
        return
    dim_r = e.dia_val.shape[1] if e.dia_offsets else 0
    if out.dtype != x_pad.dtype or out.dim() != 1 \
            or not out.is_contiguous() or out.device != x_pad.device \
            or out.shape[0] < dim_r:
        raise ValueError(f"out must be a contiguous 1-D {x_pad.dtype} "
                         f"tensor on {x_pad.device} of at least {dim_r} "
                         f"rows")


def _launch(e: EhybDevice, x_pad: torch.Tensor,
            geometry=None, out: torch.Tensor = None,
            x_base: int = 0) -> torch.Tensor:
    """One launch at ``geometry`` (:func:`choose_geometry`'s where None),
    counted: into a new y, or added into ``out`` (the accumulate mode), row
    i reading x from ``x_base + i``."""
    _check(e, x_pad)
    _check_out(e, x_pad, out)
    v = e.dia_val
    dim_r = v.shape[1]
    acc = out is not None
    vec = dim_r % 4 == 0 and v.data_ptr() % 16 == 0 \
        and (not acc or out.data_ptr() % 16 == 0)
    vb = v.element_size()
    plan, table = device_plan(e.dia_offsets, dim_r, vec, x_pad.device,
                              geometry, vb, acc, int(x_base))
    step, quads, staged, rows = plan.geometry.variant
    y = out if acc else torch.empty(dim_r, dtype=v.dtype,
                                    device=x_pad.device)
    if not dim_r:
        return y
    rc = _lib.ehyb_dia(
        v.data_ptr(), table.data_ptr(), len(plan.offsets), len(plan.runs),
        plan.offsets[0], plan.offsets[-1], dim_r, x_pad.data_ptr(),
        x_pad.shape[0], y.data_ptr(), step, quads, staged, int(vec),
        int(vb == 8), int(acc), rows, plan.chunk, plan.geometry.threads,
        plan.grid, plan.tile_quads, plan.stage_floats, plan.smem_bytes,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_dia launch failed: CUDA error {rc}")
    dia_body.launches += 1
    return y


def dia_body(e: EhybDevice, x_pad: torch.Tensor, out: torch.Tensor = None,
             x_base: int = 0) -> torch.Tensor:
    """y[i] = Σ_k dia_val[k, i] · x[x_base + i + d_k] for i <
    dia_val.shape[1], an x index outside x_pad reading as zero; length 0
    without diagonals.  With ``out`` (at least that many rows) each row's
    sum is added into ``out[i]`` in place (``out[i] + y[i]``), and ``out``
    is returned.

    CPU tensors take :func:`dia_body_plain`; CUDA tensors launch the kernel
    (float64 values and x take the float64 kernel; ``out`` its accumulate
    mode) or raise."""
    if x_pad.device.type == "cpu":
        return dia_body_plain(e, x_pad, out, x_base)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    if not e.dia_offsets:
        _check_out(e, x_pad, out)
        return x_pad.new_zeros(0) if out is None else out
    return _launch(e, x_pad, out=out, x_base=x_base)


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
dia_body.launches = 0


def dia_body_plain(e: EhybDevice, x_pad: torch.Tensor,
                   out: torch.Tensor = None,
                   x_base: int = 0) -> torch.Tensor:
    """Plain-torch version of the kernel: the shifted-slice op with a
    product and an add per diagonal, in the kernel's order and rounding
    (same inputs, same output, bit for bit on the CPU; the plain models'
    ``torch_ops.ehyb_dia`` fuses them), row i reading x from ``x_base +
    i``; with ``out`` the rows' sums are then added into it in one add, as
    the kernel's accumulate mode adds them."""
    _check_out(e, x_pad, out)
    if not e.dia_offsets:
        y = x_pad.new_zeros(0)
    else:
        y = x_pad.new_zeros(e.dia_val.shape[1])
        for v, xs in dia_terms(e, x_pad, x_base):
            # a product, then an add: a fused multiply-add would round once
            y.add_(v * xs)
    if out is None:
        return y
    out[:y.shape[0]].add_(y)
    return out
