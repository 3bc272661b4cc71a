#!/usr/bin/env python3
"""Compare the chunk kernel's SASS with another checkout's, instruction
for instruction, on a machine with the CUDA toolkit.

    python3 scripts/torch_chunk_sass_diff.py --other DIR [--define ...]
        [--both ...] [--source ctmc_chunk|mj_chunk]

Compiles ``src/repro_torch/csrc/ctmc_chunk.cu`` of this checkout and of
the checkout at ``DIR`` to cubins with the flags of
``kernels/ctmc_chunk.py``'s float32 library (``-fmad=false``, sm_90a),
disassembles both with ``cuobjdump -sass``, and compares each instance's
instructions (addresses and encodings dropped) by its failure-family code
``kKind``, whatever its other template arguments.  ``--define`` adds a
``-D`` to this checkout's build only (``CTMC_AGE_T=double`` builds the
float64 twins, to count how far they are from the float32 instances);
``--both`` adds a ``-D`` to both builds (``CTMC_AGE_T=double`` compares
the float64 twins with the other checkout's).  ``--source mj_chunk``
compares the multi-job kernel's template instances by their job count J
instead.
Prints a line an instance and exits 1 if an instance differs or is
missing on either side.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src") / "repro_torch" / "csrc"
FLAGS = ["-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-fmad=false"]
#: kKind's flag bits (csrc/ctmc_chunk.cu's kSlotBit and kScenBit)
FAMILIES = ("exponential", "weibull", "bathtub", "lognormal", "empirical")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise SystemExit("nvcc not found")


def label(kind: int, source: str = "ctmc_chunk") -> str:
    if source == "mj_chunk":
        return f"J = {kind}"
    fam = FAMILIES[kind & 7]
    return fam + (" + slots" if kind & 8 else "") \
        + (" + scenario" if kind & 16 else "")


def sass(root: Path, defines, out: Path, source: str = "ctmc_chunk") -> dict:
    """kKind (or J) -> the instance's instructions, from ``root``'s
    source."""
    cubin = out.with_suffix(".cubin")
    subprocess.run([nvcc(), *FLAGS, *(f"-D{d}" for d in defines), "-o",
                    str(cubin), str(root / CSRC / f"{source}.cu")],
                   check=True)
    dump = subprocess.run([Path(nvcc()).with_name("cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    kernels, cur = {}, None
    for line in dump.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            m = re.search(source + r"_kernelILi(\d+)E", head.group(1))
            cur = int(m.group(1)) if m else None
            if cur is not None:
                kernels[cur] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur is not None and ins:
            kernels[cur].append(ins.group(1))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other checkout's root")
    ap.add_argument("--define", action="append", default=[],
                    help="a -D for this checkout's build only")
    ap.add_argument("--both", action="append", default=[],
                    help="a -D for both builds")
    ap.add_argument("--source", default="ctmc_chunk",
                    choices=("ctmc_chunk", "mj_chunk"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        mine = sass(ROOT, args.define + args.both, Path(tmp) / "mine",
                    args.source)
        theirs = sass(args.other.resolve(), args.both, Path(tmp) / "theirs",
                      args.source)
    bad = 0
    for kind in sorted(set(mine) | set(theirs)):
        a, b = mine.get(kind), theirs.get(kind)
        if a is None or b is None:
            print(f"{label(kind, args.source):28s}: only in "
                  f"{'the other checkout' if a is None else 'this one'}")
            bad += 1
            continue
        differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(f"{label(kind, args.source):28s}: {len(a)} instructions here, "
              f"{len(b)} "
              f"there, {differ} differing")
        bad += differ > 0
    print(f"{len(mine)} instances here, {len(theirs)} there; "
          f"{'identical' if not bad else f'{bad} differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
