"""Compare the SASS of the CUDA kernels of two checkouts.

    python3 chip_sass_check.py OTHER_ROOT [SOURCE ...]

Builds each source (file names under ``ehyb_spmv_torch/csrc/``; default:
every ``.cu`` there that OTHER_ROOT has too) from this checkout and from
OTHER_ROOT with the package's nvcc flags into a temporary directory, dumps
both libraries' SASS with ``cuobjdump -sass`` and looks for each kernel of
OTHER_ROOT's build among this build's kernels, instruction for instruction
(names aside: a kernel templated since on its value type or block size
has another name for the same float code).  Prints, per source, the
kernels found unchanged, those with no identical kernel here, and the new
ones; exits 1 where one of OTHER_ROOT's kernels has no identical kernel
here.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``, ``cu++filt``).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from ehyb_spmv_torch.ops.build import CSRC_DIR, NVCC_FLAGS, find_nvcc

_FUNC = re.compile(r"^\s*Function : (\S+)")


def build(src: str, out: str) -> None:
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)


def demangle(names: list) -> list:
    tool = os.path.join(os.path.dirname(find_nvcc()), "cu++filt")
    proc = subprocess.run([tool], input="\n".join(names), check=True,
                          capture_output=True, text=True)
    return proc.stdout.splitlines()


def sass(lib: str) -> dict:
    """Kernel name (demangled) → its SASS lines."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    bodies, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = bodies.setdefault(m.group(1), [])
            continue
        # instructions and their encodings (the control bits included),
        # spaces aside: the dump pads its columns to the longest name
        if cur is not None and line.strip().startswith("/*"):
            cur.append(" ".join(line.split()))
    names = list(bodies)
    return dict(zip(demangle(names), (bodies[n] for n in names)))


def compare(source: str, other_root: str, tmp: str) -> bool:
    here, there = os.path.join(tmp, "here.so"), os.path.join(tmp, "there.so")
    build(os.path.join(CSRC_DIR, source), here)
    build(os.path.join(other_root, "ehyb_spmv_torch", "csrc", source), there)
    mine, theirs = sass(here), sass(there)
    by_body = {tuple(b): k for k, b in mine.items()}
    found = {k: by_body.get(tuple(b)) for k, b in theirs.items()}
    lost = [k for k, v in found.items() if v is None]
    new = [k for k in mine if k not in set(found.values())]
    print(f"{source}: {len(theirs) - len(lost)} of {len(theirs)} kernels of "
          f"{other_root} unchanged here, {len(lost)} changed, {len(new)} "
          "new")
    for k, v in found.items():
        if v is not None:
            print(f"  unchanged: {k}" + (f" (here {v})" if v != k else ""))
    for k in lost:
        print(f"  changed: {k} ({len(theirs[k])} instructions; here "
              f"{len(mine.get(k, []))} under that name)")
    for k in new:
        print(f"  new: {k}")
    return not lost


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = sys.argv[1]
    sources = sys.argv[2:] or sorted(
        f for f in os.listdir(CSRC_DIR) if f.endswith(".cu") and
        os.path.exists(os.path.join(other, "ehyb_spmv_torch", "csrc", f)))
    with tempfile.TemporaryDirectory() as tmp:
        ok = [compare(s, other, tmp) for s in sources]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
