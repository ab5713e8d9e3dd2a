"""The routed apply in one pass over x chunks staged in shared memory: plan,
wrapper and plain version.

Port counterpart of both routed stages of
``ehyb_spmv_gpu_tpu/ops/route_pallas.py`` (``_route_at_kernel``, K7: stages
A+T, and ``_make_route_b_kernel``, K8: stage B) and of the spill tail that
``make_routed_apply`` adds after them.  The kernel is
``csrc/route_xcache.cu``; its header says what it computes, what bounds it
and why the H100 needs neither the TPU's two stages nor their product array.

:func:`build_route_plan` decodes a routed schedule once on the host (stage
B names each routed entry's dst row and the place of its product, stage A
that product's column and value), adds the spilled entries, and tiles them
by (group of dst rows, part of the x chunks), in segments of one chunk each,
whose entries run in passes that hold a row at most once (so the kernel
needs no atomics and sums in a fixed order).  :func:`build_blocks_plan`
does the same for the column blocks of one matrix: their entries, moved to
the blocks' columns of the shared x, go into one plan and one launch.  A
direct plan stages nothing: the kernel reads x[col] through
L2, in chunks as wide as the entry's bits allow.  :func:`choose_geometry`
picks the geometry from the entries a staged chunk carries: a staged plan
where a chunk carries enough of them (random_1m), a direct one where it
carries few (random_4m).
:func:`route_xcache` launches the kernel for CUDA tensors and takes
:func:`route_xcache_plain` only for CPU tensors.  The plain version applies
the same plan on tensors, so the CPU tests hold the plan itself;
:func:`route_xcache_replay` repeats the kernel's own order of sums on the
host, bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import threading

import numpy as np
import torch

from ..config import LANES, cdiv, round_up
from ..core.route import TS, WIN, RoutedMatrix, segment_bounds
from .build import BuiltLibrary, build_cuda_library
from .stream_cells import _stable_order
from ..utils.log import get_logger

log = get_logger(__name__)

#: A staged plan's geometry: dst rows per group (their f32 sums live in
#: shared memory), parts the x chunks are cut into, 1024-column windows per
#: staged chunk; and the launch's threads per block.  Chosen by
#: chip_routed_sweep.py on random_1m (the fastest of its 57 readings).
GROUP_ROWS = 32768
PARTS = 4
CHUNK_WINDOWS = 8
THREADS = 1024
#: A direct plan's geometry: 4,096 rows a group (16 KB of sums, so eight
#: blocks share an SM), one part, chunks of 128 windows (2^17 columns), 256
#: threads.  Chosen by chip_routed_sweep.py on random_4m.
DIRECT_GROUP_ROWS = 4096
DIRECT_CHUNK_WINDOWS = 128
DIRECT_THREADS = 256
#: L2 bytes a staged plan would spend an entry (``4 * chunk_cols`` over the
#: entries a chunk carries to one row group) past which the rule reads x
#: through L2 instead: random_1m spends 8 and stays staged, random_4m would
#: spend 64 (chip_routed_sweep.py: 0.1073 ms staged against 0.1533 direct
#: at random_1m; 0.2981 ms direct against 0.9288 staged at random_4m).
DIRECT_PAST_BYTES = 16
#: An entry's fields: ``pass << 29 | row_in_group << 13 | col_in_chunk`` in
#: a staged plan; a direct plan's chunks may be wider, ``col_bits`` =
#: log2(chunk_cols) bits, leaving ``29 - col_bits`` to the row.  A segment
#: holds at most MAX_PASSES passes; a staged plan's group at most
#: MAX_GROUP_ROWS rows, its chunk at most MAX_CHUNK_COLS columns (8
#: windows).
PASS_SHIFT, ROW_SHIFT = 29, 13
MAX_PASSES = 1 << (32 - PASS_SHIFT)
MAX_GROUP_ROWS = 1 << (PASS_SHIFT - ROW_SHIFT)
MAX_CHUNK_COLS = 1 << ROW_SHIFT
#: Dynamic shared memory a block may ask for on the H100 (227 KB), less 1 KB
#: for the kernel's static shared memory.
MAX_SMEM_BYTES = 232448 - 1024
#: Bump on any change to the plan's arrays or to the geometry rule: the
#: cached plans' file names carry it.
PLAN_VERSION = 1
#: Stage-B steps the plan decodes at once (bounds its numpy temporaries).
_CHUNK_STEPS = 1 << 15

_lock = threading.Lock()
_built = None
_lib = None


def decode_routed(rm: RoutedMatrix):
    """Every entry the schedule holds as (dst row, column, value) arrays
    (int64, int64, float32): the routed entries in stage-B order, then the
    spilled ones.

    Stage B is the authority: an unmasked B slot names one dst row and the
    place of one product in the band-major product array T (row ``base +
    sel * 8 + srow``, lane ``src``).  Inverting K7's A→T map (step t of grid
    step (b, q) and lane l go to ``T[b, l, q * 8 + t // 128, t % 128]``)
    gives the A slot behind it, whose column and value are the entry's.  So
    padding is never recognised by value, and an explicit zero is kept."""
    seg_first, seg_last = segment_bounds(rm)
    n_sub = rm.b_idx.shape[0] // TS
    n = seg_last - seg_first + 1
    sub_seg = np.full(n_sub, -1, dtype=np.int64)
    sub_seg[np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
            + np.repeat(seg_first, n)] = np.repeat(np.arange(n.size), n)
    gr = rm.group_rows
    block_rows = rm.bands_per_block * gr
    a_col = rm.a_col.reshape(-1)
    a_val = rm.a_val.reshape(-1)
    rows, cols, vals = [], [], []
    for a in range(0, rm.b_idx.shape[0], _CHUNK_STEPS):
        iv = rm.b_idx[a:a + _CHUNK_STEPS].astype(np.int32)
        st, ln = np.nonzero((iv >> 14) == 0)
        src = iv[st, ln] & (LANES - 1)
        attr = iv[st, src]                     # slot attribute at lane src
        sel = (attr >> 10) & 15
        sel = np.where(sel < rm.chain, sel, 0)
        srow = (attr >> 7) & 7
        step = st.astype(np.int64) + a
        k = step // TS
        seg = sub_seg[k]
        if np.any(seg < 0):
            raise ValueError("an unmasked stage-B slot lies in no segment")
        if rm.octet:
            rows.append((seg * TS + step % TS) * LANES + ln)
        else:
            rows.append(seg * LANES + ln)
        t_row = rm.b_gmap[k // rm.s_b].astype(np.int64) * block_rows \
            + rm.b_boff[k] + sel * TS + srow
        band = t_row // gr
        flat = ((band // LANES) * (gr * LANES) + (t_row % gr) * LANES
                + src) * LANES + band % LANES
        c = a_col[flat].astype(np.int64)
        lo = c & (LANES - 1)
        hi = a_col[flat - flat % LANES + lo].astype(np.int64) >> 7
        win = rm.a_win[flat // (LANES * TS)].astype(np.int64)
        cols.append((win + hi) * LANES + lo)
        vals.append(a_val[flat])
    rows.append(rm.sp_dst.astype(np.int64))
    cols.append(rm.sp_col.astype(np.int64))
    vals.append(rm.sp_val.astype(np.float32))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32))


@dataclasses.dataclass
class RoutePlan:
    """Host plan of the one-pass routed kernel.

    The dst rows are cut into groups of ``group_rows``; the x columns into
    chunks of ``chunk_cols`` (whole 1024-column windows), and the chunks into
    ``parts`` runs of whole chunks.  Tile ``t = group * parts + part`` holds
    the entries of its group's rows and its part's columns, in segments
    that read one chunk each: tile t owns segments ``[tile_seg[t],
    tile_seg[t+1])``, segment s reads chunk ``seg_chunk[s]`` and holds
    entries ``[seg_ent[s], seg_ent[s+1])`` in ``seg_npass[s]`` passes.  A
    pass holds each row at most once: the k-th entry
    of a row in a (tile, chunk) goes to pass k % MAX_PASSES of that chunk's
    segment number k // MAX_PASSES, and a segment's entries run pass by
    pass, each pass in the schedule's order.  An entry is ``ent_idx = pass
    << 29 | (row - group * group_rows) << col_bits | (col - chunk *
    chunk_cols)`` (a uint32 kept in int32 bits; ``col_bits`` is 13 in a
    staged plan, log2(chunk_cols) in a ``direct`` one) and ``ent_val``.  The
    launch runs ``threads`` threads a block."""

    n_rows: int
    n_x: int
    group_rows: int
    parts: int
    chunk_cols: int
    threads: int
    direct: bool
    col_bits: int
    tile_seg: np.ndarray
    seg_chunk: np.ndarray
    seg_ent: np.ndarray
    seg_npass: np.ndarray
    ent_idx: np.ndarray
    ent_val: np.ndarray
    stats: dict

    @property
    def n_groups(self) -> int:
        return cdiv(self.n_rows, self.group_rows)

    def to_torch(self, device=None) -> "RoutePlanDevice":
        return RoutePlanDevice(self).to(device)

    def save(self, path: str) -> None:
        """Write the plan to ``path`` (an uncompressed ``.npz``), through a
        temporary file, so that a reader sees the whole plan or none."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self) if f.name != "stats"}
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, stats_json=json.dumps(
            self.stats, default=lambda v: v.item()), **fields)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "RoutePlan":
        """The plan :meth:`save` wrote to ``path``."""
        with np.load(path) as z:
            kw = {f.name: z[f.name] for f in dataclasses.fields(cls)
                  if f.name != "stats"}
            stats = json.loads(str(z["stats_json"]))
        for f in dataclasses.fields(cls):
            if f.type in ("int", "bool"):
                kw[f.name] = {"int": int, "bool": bool}[f.type](kw[f.name])
        return cls(stats=stats, **kw)


class RoutePlanDevice(torch.nn.Module):
    """Device mirror of :class:`RoutePlan`: its arrays as buffers, and one
    arrival counter per row group for the kernel's last-block reduction
    (zero between launches: the last block of a group resets its own)."""

    MAP_FIELDS = ("tile_seg", "seg_chunk", "seg_ent", "seg_npass")

    def __init__(self, p: RoutePlan):
        super().__init__()
        for f in ("n_rows", "n_x", "group_rows", "parts", "chunk_cols",
                  "threads", "direct", "col_bits",
                  "n_groups"):
            setattr(self, f, getattr(p, f))
        # sizes as host ints: the plain version reads no device scalar, so
        # it can be captured in a CUDA graph
        self.n_tiles = len(p.tile_seg) - 1
        self.n_segs = len(p.seg_chunk)
        self.n_ent = int(p.seg_ent[-1])
        self.stats = dict(p.stats)
        for f in self.MAP_FIELDS:
            self.register_buffer(f, torch.from_numpy(
                np.ascontiguousarray(getattr(p, f), dtype=np.int32)))
        self.register_buffer("ent_idx", torch.from_numpy(p.ent_idx))
        self.register_buffer("ent_val", torch.from_numpy(p.ent_val))
        self.register_buffer("arrivals",
                             torch.zeros(self.n_groups, dtype=torch.int32))


def smem_bytes(group_rows: int, chunk_cols: int) -> int:
    """Dynamic shared memory of one block: the group's sums and two chunk
    buffers (none in a direct plan: ``chunk_cols`` 0)."""
    return 4 * (group_rows + 2 * chunk_cols)


def choose_geometry(nnz: int, n_rows: int, n_x: int) -> dict:
    """The plan's geometry from its density: the entries one staged chunk
    would carry to one row group at the staged plan's group and chunk
    sizes.

    A staged tile copies every chunk of its part from L2, so it pays ``4 *
    chunk_cols / entries`` bytes of L2 an entry: 8 at random_1m (16 entries
    a row over 2^20 columns: 4,096 entries a chunk), 64 at random_4m (8 over
    2^22: 512).  Past DIRECT_PAST_BYTES the plan is direct: x[col] through
    L2, one 32-byte sector an entry, in wide chunks."""
    group_rows = min(GROUP_ROWS, round_up(max(n_rows, 1), 32))
    chunk_cols = min(CHUNK_WINDOWS, max(cdiv(n_x, WIN), 1)) * WIN
    per_chunk = nnz * (group_rows / max(n_rows, 1)) * (chunk_cols
                                                        / max(n_x, 1))
    if 4 * chunk_cols > DIRECT_PAST_BYTES * per_chunk:
        return dict(group_rows=DIRECT_GROUP_ROWS, parts=1,
                    chunk_windows=DIRECT_CHUNK_WINDOWS,
                    threads=DIRECT_THREADS, direct=True)
    return dict(group_rows=GROUP_ROWS, parts=PARTS,
                chunk_windows=CHUNK_WINDOWS, threads=THREADS, direct=False)


def build_route_plan(rm: RoutedMatrix, **geometry) -> RoutePlan:
    """Decode the schedule (:func:`decode_routed`) and tile its entries
    (:func:`tile_entries`)."""
    return build_blocks_plan([rm], [0], rm.padded_x_rows, **geometry)


def build_blocks_plan(blocks, los, n_x: int, **geometry) -> RoutePlan:
    """One plan over the column blocks ``blocks`` of one matrix (their
    schedules, block ``i`` reading columns ``los[i]`` on): their entries
    (:func:`decode_blocks`) over the shared x of ``n_x`` rows, tiled at
    once."""
    plan = tile_entries(decode_blocks(blocks, los), blocks[0].n_dst_rows,
                        n_x, **geometry)
    plan.stats["spilled"] = int(sum(rm.sp_val.shape[0] for rm in blocks))
    plan.stats["blocks"] = len(blocks)
    return plan


def cached_blocks_plan(blocks, los, n_x: int, cache: str = None):
    """:func:`build_blocks_plan` at the rule's geometry, read from a file
    beside the schedules' cache where one is there, else built and written
    there (``cache``: the schedules' cache path without its suffix; None:
    no cache).  The file's name carries PLAN_VERSION."""
    if cache is None:
        return build_blocks_plan(blocks, los, n_x)
    path = f"{cache}.plan{PLAN_VERSION}.npz"
    if os.path.exists(path):
        try:
            plan = RoutePlan.load(path)
            log.info("loaded cached routed plan <- %s", path)
            return plan
        except Exception as exc:  # a corrupted cache: build again
            log.warning("routed plan cache load failed (%s); rebuilding",
                        exc)
    plan = build_blocks_plan(blocks, los, n_x)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plan.save(path)
    log.info("cached routed plan -> %s", path)
    return plan


def decode_blocks(blocks, los):
    """Every entry of the column blocks ``blocks`` (block ``i`` reading
    columns ``los[i]`` on) as (dst row, column, value) arrays in the shared
    x's columns: :func:`decode_routed` of each, concatenated.  The blocks
    share one dst space (identity dst, the same rows)."""
    if any(rm.n_dst_rows != blocks[0].n_dst_rows for rm in blocks):
        raise ValueError("column blocks of one plan must share their dst "
                         "rows")
    if len(blocks) == 1:
        r, c, v = decode_routed(blocks[0])
        return r, c + los[0], v
    rows, cols, vals = [], [], []
    for rm, lo in zip(blocks, los):
        r, c, v = decode_routed(rm)
        rows.append(r)
        cols.append(c + lo)
        vals.append(v)
    return tuple(np.concatenate(a) for a in (rows, cols, vals))


def tile_entries(entries, n_rows: int, n_x: int, **geometry) -> RoutePlan:
    """Tile ``entries`` (dst row, column, value arrays) of an ``n_rows``-row
    y over an ``n_x``-row x (a whole number of 1024-row windows).

    ``geometry`` may name ``group_rows``, ``parts``, ``chunk_windows``,
    ``threads`` and ``direct``; :func:`choose_geometry` gives the others.
    A group never holds more rows than y has (rounded up to
    32), a chunk never more windows than x has (nor, staged, than
    MAX_CHUNK_COLS columns; direct, a power of two of windows), and the
    parts never outnumber the chunks, so one group and one part may cover a
    small matrix.  A staged plan's chunks halve until a block's sums and
    two chunk buffers fit shared memory."""
    row, col, val = entries
    n_ent = row.shape[0]
    geo = choose_geometry(n_ent, n_rows, n_x)
    unknown = set(geometry) - set(geo)
    if unknown:
        raise ValueError(f"unknown geometry {sorted(unknown)}")
    geo.update(geometry)
    group_rows, parts, chunk_windows = (geo["group_rows"], geo["parts"],
                                        geo["chunk_windows"])
    threads, direct = geo["threads"], geo["direct"]
    if parts < 1 or chunk_windows < 1:
        raise ValueError("parts and chunk_windows must be positive")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError("threads must be a multiple of 32 in [32, 1024]")
    group_rows = min(group_rows, round_up(n_rows, 32))
    if direct:
        # a direct plan stages nothing: its chunks are whole powers of two
        # of windows, as wide as the rows leave bits for
        chunk_windows = min(1 << (chunk_windows.bit_length() - 1),
                            1 << (cdiv(n_x, WIN) - 1).bit_length())
        col_bits = (chunk_windows * WIN).bit_length() - 1
    else:
        chunk_windows = min(chunk_windows, cdiv(n_x, WIN),
                            MAX_CHUNK_COLS // WIN)
        col_bits = ROW_SHIFT
    max_rows = 1 << (PASS_SHIFT - col_bits)
    if group_rows % 32 or not 32 <= group_rows <= max_rows:
        raise ValueError(f"group_rows must be a multiple of 32 in [32, "
                         f"{max_rows}]")
    while not direct and chunk_windows > 1 and smem_bytes(
            group_rows, chunk_windows * WIN) > MAX_SMEM_BYTES:
        chunk_windows //= 2
    chunk_cols = chunk_windows * WIN
    if smem_bytes(group_rows, 0 if direct else chunk_cols) > MAX_SMEM_BYTES:
        raise ValueError(f"{group_rows} rows of sums leave no room for two "
                         f"windows in shared memory")
    n_chunks = cdiv(n_x, chunk_cols)
    per_part = cdiv(n_chunks, min(parts, n_chunks))
    parts = cdiv(n_chunks, per_part)
    n_groups = cdiv(n_rows, group_rows)
    n_tiles = n_groups * parts
    if n_ent >= 2 ** 30 or n_tiles >= 2 ** 31:
        raise ValueError("routed plan too large for int32 offsets")
    if n_ent and (row.max() >= n_rows or col.max() >= n_x
                  or min(row.min(), col.min()) < 0):
        raise ValueError("an entry lies outside the dst rows or x")

    group, chunk = row // group_rows, col // chunk_cols
    local_row = row - group * group_rows
    # the rank of each entry among its row's entries in its (tile, chunk)
    rk = (group * n_chunks + chunk) * group_rows + local_row
    o = _stable_order(rk)
    rk = rk[o]
    first = np.r_[True, rk[1:] != rk[:-1]] if n_ent else np.zeros(0, bool)
    starts = np.flatnonzero(first)
    rank = np.empty(n_ent, np.int64)
    rank[o] = np.arange(n_ent) - starts[np.cumsum(first) - 1]
    del rk, o, first, starts
    sub, pss = rank // MAX_PASSES, rank % MAX_PASSES
    del rank
    n_sub = int(sub.max()) + 1 if n_ent else 1
    # segments: (tile, chunk, sub) in order, each pass by pass, each pass in
    # the schedule's order
    seg_key = (group * n_chunks + chunk) * n_sub + sub
    del sub
    order = _stable_order(seg_key * MAX_PASSES + pss)
    seg_key = seg_key[order]
    starts = np.flatnonzero(np.r_[True, seg_key[1:] != seg_key[:-1]]) \
        if n_ent else np.zeros(0, np.int64)
    seg_ent = np.append(starts, n_ent).astype(np.int64)
    seg_npass = pss[order][seg_ent[1:] - 1] + 1
    seg_chunk = seg_key[starts] // n_sub % n_chunks
    seg_tile = seg_key[starts] // n_sub // n_chunks * parts \
        + seg_chunk // per_part
    del seg_key
    tile_seg = np.searchsorted(seg_tile, np.arange(n_tiles + 1))
    ent_idx = ((pss << PASS_SHIFT) | (local_row << col_bits)
               | (col - chunk * chunk_cols))[order].astype(np.uint32)
    ent_val = val[order]

    per_tile = np.diff(seg_ent[tile_seg])
    # a staged segment copies its chunk from L2
    staged = 0 if direct else 4 * int(np.minimum(
        chunk_cols, n_x - seg_chunk * chunk_cols).sum())
    y_bytes = 4 * n_rows
    stats = dict(
        n_tiles=n_tiles, n_groups=n_groups, parts=parts,
        group_rows=group_rows, chunk_windows=chunk_windows, threads=threads,
        direct=direct, n_segs=len(starts),
        smem_bytes=smem_bytes(group_rows, 0 if direct else chunk_cols),
        passes=int(seg_npass.sum()), entries=n_ent,
        max_tile_entries=int(per_tile.max(initial=0)),
        mean_tile_entries=float(n_ent / max(n_tiles, 1)),
        mean_segment_entries=float(n_ent / max(len(starts), 1)),
        ent_bytes=8 * n_ent, staged_bytes=staged,
        x_bytes=4 * n_x, y_bytes=y_bytes,
        partial_bytes=2 * parts * y_bytes if parts > 1 else 0,
        map_bytes=4 * (tile_seg.size + seg_chunk.size + seg_ent.size
                       + seg_npass.size))
    # what the kernel moves through device memory: its entries, x once (a
    # chunk is staged from L2, once per row group), the partials written
    # and read back, y once, and its maps
    stats["layout_bytes"] = stats["ent_bytes"] + stats["x_bytes"] \
        + y_bytes + stats["partial_bytes"] + stats["map_bytes"]
    return RoutePlan(
        n_rows=n_rows, n_x=n_x, group_rows=group_rows, parts=parts,
        chunk_cols=chunk_cols, threads=threads, direct=direct,
        col_bits=col_bits,
        tile_seg=tile_seg.astype(np.int32),
        seg_chunk=seg_chunk.astype(np.int32), seg_ent=seg_ent.astype(np.int32),
        seg_npass=seg_npass.astype(np.int32),
        ent_idx=ent_idx.view(np.int32), ent_val=ent_val, stats=stats)


def build_kernel() -> BuiltLibrary:
    """Compile ``csrc/route_xcache.cu`` (once per process) and return the
    library's path, build time and ptxas report."""
    global _built, _lib
    with _lock:
        if _built is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the routed kernel needs a CUDA device; "
                                   "none is available")
            built = build_cuda_library("route_xcache", ["route_xcache.cu"])
            lib = ctypes.CDLL(built.path)
            lib.ehyb_route_xcache.restype = ctypes.c_int
            lib.ehyb_route_xcache.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            _built, _lib = built, lib
        return _built


def _check(p: RoutePlanDevice, x_pad: torch.Tensor) -> None:
    """Refuse anything the kernel does not take."""
    dev = x_pad.device
    if x_pad.dtype != torch.float32 or x_pad.dim() != 1 \
            or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous 1-D float32 tensor")
    if x_pad.shape[0] < p.n_x:
        raise ValueError(f"x_pad has {x_pad.shape[0]} rows; the plan reads "
                         f"{p.n_x}")
    if x_pad.data_ptr() % 16:
        raise ValueError("x_pad must be 16-byte aligned (cp.async)")
    if p.ent_idx.dtype != torch.int32 or p.ent_val.dtype != torch.float32:
        raise ValueError("the plan's entries must be int32 indices and "
                         "float32 values")
    for t in (*(getattr(p, f) for f in p.MAP_FIELDS), p.ent_idx, p.ent_val,
              p.arrivals):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, x_pad on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def route_xcache(p: RoutePlanDevice, x_pad: torch.Tensor) -> torch.Tensor:
    """The routed apply's dst-space y, (n_rows,): every entry of the plan,
    routed and spilled, summed into its row.

    CPU tensors take :func:`route_xcache_plain`; CUDA tensors launch the
    kernel or raise."""
    if x_pad.device.type == "cpu":
        return route_xcache_plain(p, x_pad)
    if x_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pad.device}")
    return _launch(p, x_pad)


def _launch(p: RoutePlanDevice, x_pad: torch.Tensor,
            threads: int = None) -> torch.Tensor:
    """One launch of the kernel at the plan's threads, or ``threads`` (the
    wrapper passes the plan's; chip_routed_sweep.py times others)."""
    threads = threads or p.threads
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError("threads must be a multiple of 32 in [32, 1024]")
    _check(p, x_pad)
    build_kernel()
    y = torch.empty(p.n_rows, dtype=torch.float32, device=x_pad.device)
    partial = (torch.empty(p.parts * p.n_rows, dtype=torch.float32,
                           device=x_pad.device) if p.parts > 1 else y)
    rc = _lib.ehyb_route_xcache(
        p.ent_idx.data_ptr(), p.ent_val.data_ptr(), p.tile_seg.data_ptr(),
        p.seg_chunk.data_ptr(), p.seg_ent.data_ptr(), p.seg_npass.data_ptr(),
        x_pad.data_ptr(),
        p.n_x, p.chunk_cols, p.group_rows, p.n_rows, p.parts,
        partial.data_ptr(), p.arrivals.data_ptr(), y.data_ptr(), p.n_tiles,
        threads, int(p.direct), p.col_bits,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ehyb_route_xcache launch failed: CUDA error "
                           f"{rc}")
    if p.n_tiles:
        route_xcache.launches += 1
    return y


#: Kernel launches since the count was last reset (a run sets it to 0 to
#: show that its main path went through the kernel).
route_xcache.launches = 0


def plan_rows_cols(p: RoutePlanDevice):
    """Each entry's dst row and column (int64 tensors on the plan's device),
    decoded from its segment and tile without a device sync."""
    dev = p.ent_idx.device
    seg_tile = torch.repeat_interleave(
        torch.arange(p.n_tiles, device=dev), torch.diff(p.tile_seg.long()),
        output_size=p.n_segs)
    ent_seg = torch.repeat_interleave(
        torch.arange(p.n_segs, device=dev), torch.diff(p.seg_ent.long()),
        output_size=p.n_ent)
    idx = p.ent_idx.long()
    row = (seg_tile // p.parts)[ent_seg] * p.group_rows \
        + ((idx >> p.col_bits) & ((1 << (PASS_SHIFT - p.col_bits)) - 1))
    col = p.seg_chunk.long()[ent_seg] * p.chunk_cols \
        + (idx & ((1 << p.col_bits) - 1))
    return row, col


def route_xcache_plain(p: RoutePlanDevice,
                       x_pad: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the kernel: ``index_add_`` val * x[col] of
    every entry into its row (the sums run in entry order, the kernel's in
    its own fixed order)."""
    y = torch.zeros(p.n_rows, dtype=x_pad.dtype, device=x_pad.device)
    if p.n_ent == 0:
        return y
    row, col = plan_rows_cols(p)
    return y.index_add_(0, row, p.ent_val.to(x_pad.dtype) * x_pad[col])


def route_xcache_replay(p: RoutePlanDevice, x_pad) -> np.ndarray:
    """The kernel's own order of sums, on the host in numpy (float32): each
    row's products (``__fmul_rn``) added (``__fadd_rn``) in plan order into
    one sum per part, then the parts' sums added in part order from 0.  The
    kernel's y equals it bit for bit."""
    row, col = (t.cpu().numpy() for t in plan_rows_cols(p))
    x = torch.as_tensor(x_pad).cpu().numpy().astype(np.float32)
    seg_tile = np.repeat(np.arange(p.n_tiles),
                         np.diff(p.tile_seg.cpu().numpy()))
    ent_seg = np.repeat(np.arange(p.n_segs), np.diff(p.seg_ent.cpu().numpy()))
    part = seg_tile[ent_seg] % p.parts
    prod = p.ent_val.cpu().numpy() * x[col]
    # each entry's rank among the entries of its (part, row), in plan order
    key = part * p.n_rows + row
    o = np.argsort(key, kind="stable")
    ks = key[o]
    first = np.r_[True, ks[1:] != ks[:-1]] if ks.size else ks.astype(bool)
    rank = np.empty(ks.size, np.int64)
    rank[o] = np.arange(ks.size) - np.flatnonzero(first)[np.cumsum(first)
                                                         - 1]
    sums = np.zeros((p.parts, p.n_rows), np.float32)
    for r in range(int(rank.max()) + 1 if rank.size else 0):
        s = rank == r
        sums[part[s], row[s]] += prod[s]
    if p.parts == 1:
        return sums[0]
    y = np.zeros(p.n_rows, np.float32)
    for q in range(p.parts):
        y += sums[q]
    return y
