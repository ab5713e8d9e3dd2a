"""Matrix Market (``.mtx``) reader/writer.

Re-implements the slice of the NIST mmio library the reference actually uses —
banner parsing (``mm_read_banner`` ``mmio.c:96``), size line
(``mm_read_mtx_crd_size`` ``mmio.c:189``), typecode checks (``mmio.h:31-47``) —
plus the caller-side entry parsing and symmetric expansion
(``solver_test.c:127-265``).  Goes beyond the reference (which only supports
``real coordinate``): ``integer`` and ``pattern`` fields and ``skew-symmetric``
symmetry are handled; ``complex`` and ``array`` formats raise a clear error.

The symmetric reader mirrors the reference's lower-triangle expansion
(``solver_test.c:235-260``): every off-diagonal (i, j) produces the mirrored
(j, i) with the same value (negated for skew).

Port copy of ``ehyb_spmv_gpu_tpu/io/mtx.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import gzip
import io as _io
from typing import IO, Union

import numpy as np

from ..core.coo import MatrixCOO

BANNER = "%%MatrixMarket"

_VALID_OBJECTS = {"matrix"}
_VALID_FORMATS = {"coordinate", "array"}
_VALID_FIELDS = {"real", "integer", "pattern", "complex"}
_VALID_SYMMETRIES = {"general", "symmetric", "skew-symmetric", "hermitian"}


@dataclasses.dataclass(frozen=True)
class MtxHeader:
    """Parsed banner + size line (role of the mmio typecode, ``mmio.h:10-47``)."""

    object: str
    format: str
    field: str
    symmetry: str
    n_rows: int
    n_cols: int
    n_entries: int  # stored entries (lower triangle only if symmetric)

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry in ("symmetric", "hermitian")

    @property
    def is_skew(self) -> bool:
        return self.symmetry == "skew-symmetric"


class MtxError(ValueError):
    pass


def _open(path_or_file: Union[str, IO]) -> IO:
    if hasattr(path_or_file, "read"):
        return path_or_file
    path = str(path_or_file)
    # Binary streams: the body goes to the native scanner as raw bytes.  The
    # text-mode formulation cost two full-size passes on a 1.3 GB audikw-
    # class file (UTF-8 decode on read + ASCII re-encode for the scanner)
    # before a single token was parsed.
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _as_text(line) -> str:
    """Lines from a binary stream → str (header lines are tiny ASCII)."""
    return line.decode("ascii", errors="replace") if isinstance(line, bytes) \
        else line


def read_header(f: IO) -> MtxHeader:
    """Parse the ``%%MatrixMarket`` banner and the size line, skipping ``%``
    comment lines (``mm_read_banner`` ``mmio.c:96-179`` +
    ``mm_read_mtx_crd_size`` ``mmio.c:189-233``).  Accepts text or binary
    streams."""
    line = _as_text(f.readline())
    if not line or not line.startswith(BANNER):
        raise MtxError(f"missing {BANNER} banner")
    parts = line.strip().split()
    if len(parts) != 5:
        raise MtxError(f"malformed banner: {line.strip()!r}")
    _, obj, fmt, field, sym = (p.lower() for p in parts)
    if obj not in _VALID_OBJECTS:
        raise MtxError(f"unsupported object {obj!r}")
    if fmt not in _VALID_FORMATS:
        raise MtxError(f"unsupported format {fmt!r}")
    if field not in _VALID_FIELDS:
        raise MtxError(f"unsupported field {field!r}")
    if sym not in _VALID_SYMMETRIES:
        raise MtxError(f"unsupported symmetry {sym!r}")
    if fmt == "array":
        raise MtxError("dense 'array' format not supported (sparse framework)")
    if field == "complex":
        raise MtxError("'complex' field not supported")

    # Size line: first non-comment, non-blank line.
    while True:
        line = _as_text(f.readline())
        if not line:
            raise MtxError("EOF before size line")
        s = line.strip()
        if s and not s.startswith("%"):
            break
    dims = s.split()
    if len(dims) != 3:
        raise MtxError(f"malformed size line: {s!r}")
    try:
        n_rows, n_cols, n_entries = (int(d) for d in dims)
    except ValueError as exc:
        raise MtxError(f"malformed size line: {s!r}") from exc
    return MtxHeader(obj, fmt, field, sym, n_rows, n_cols, n_entries)


def read_mtx(path_or_file: Union[str, IO], expand_symmetry: bool = True) -> MatrixCOO:
    """Read a coordinate ``.mtx`` file into :class:`MatrixCOO` (0-based indices).

    With ``expand_symmetry`` (default), symmetric/hermitian/skew files are
    expanded to the full pattern exactly as the reference's symmetric reader does
    (``solver_test.c:235-260``).
    """
    f = _open(path_or_file)
    close = f is not path_or_file
    try:
        header = read_header(f)
        body = f.read()
    finally:
        if close:
            f.close()

    row, col, val = _parse_entries(body, header)

    if expand_symmetry and (header.is_symmetric or header.is_skew):
        off = row != col
        sign = -1.0 if header.is_skew else 1.0
        row, col, val = (np.concatenate([row, col[off]]),
                         np.concatenate([col, row[off]]),
                         np.concatenate([val, sign * val[off]]))

    return MatrixCOO(header.n_rows, header.n_cols, row, col, val)


def _parse_entries(body: str, header: MtxHeader):
    """Parse the entry lines → 0-based (row, col, val).

    Fast path: the native C++ scanner (``native/mtxparse.cpp``) — the
    reference parses entries with fscanf at C speed (``solver_test.c:196-206``)
    and so do we (231M tokens for audikw_1-class files).  Fallback: NumPy
    token parse (e.g. if g++ is unavailable).
    """
    has_value = header.field != "pattern"
    try:
        from ..native import parse_entries_native

        raw = (body if isinstance(body, bytes)
               else body.encode("ascii", errors="replace"))
        row1, col1, val = parse_entries_native(raw, header.n_entries,
                                               has_value)
        return row1 - 1, col1 - 1, val
    except Exception:
        # Native unavailable OR it rejected the file (e.g. float-formatted
        # indices the strict integer scanner refuses): the NumPy fallback
        # below is the arbiter — it raises MtxError on genuinely bad input.
        pass

    if isinstance(body, bytes):
        body = body.decode("ascii", errors="replace")
    # Strip any trailing comment lines (rare but legal).
    if "%" in body:
        body = "\n".join(ln for ln in body.splitlines()
                         if ln.strip() and not ln.lstrip().startswith("%"))
    width = 3 if has_value else 2
    try:
        data = np.fromiter((float(t) for t in body.split()), dtype=np.float64)
    except ValueError as exc:
        raise MtxError(f"malformed entry token: {exc}") from exc
    if data.size != header.n_entries * width:
        raise MtxError(f"expected {header.n_entries} entries of {width} "
                       f"fields, got {data.size} tokens")
    data = data.reshape(-1, width)
    row = data[:, 0].astype(np.int64) - 1
    col = data[:, 1].astype(np.int64) - 1
    val = (data[:, 2].copy() if has_value
           else np.ones(row.shape[0], dtype=np.float64))
    return row, col, val


def write_mtx(path: str, m: MatrixCOO, symmetry: str = "general",
              field: str = "real") -> None:
    """Write a COO matrix as a coordinate ``.mtx`` file (1-based indices).

    For ``symmetry='symmetric'`` only the lower triangle is stored (the caller
    must pass a structurally symmetric matrix).
    """
    if symmetry not in _VALID_SYMMETRIES:
        raise MtxError(f"unsupported symmetry {symmetry!r}")
    row, col, val = m.row, m.col, m.val
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        keep = row >= col
        row, col, val = row[keep], col[keep], val[keep]
    with open(path, "w") as f:
        f.write(f"{BANNER} matrix coordinate {field} {symmetry}\n")
        f.write(f"{m.n_rows} {m.n_cols} {row.shape[0]}\n")
        if field == "pattern":
            np.savetxt(f, np.column_stack([row + 1, col + 1]), fmt="%d %d")
        else:
            np.savetxt(f, np.column_stack([row + 1, col + 1, val]),
                       fmt="%d %d %.17g")
