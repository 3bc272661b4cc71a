#!/usr/bin/env python3
"""Where the CTMC chunk kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_chunk_variants.py

Builds two timing-only copies of ``src/repro_torch/csrc/ctmc_chunk.cu``
next to the real kernel, under ``build/repro_torch/variants/``, and times
all three at the Table-I sweep's shape (4 points x 1,024 replicas, one
chunk of 64 steps) with torch.profiler:

* ``kernel``: the kernel as built for the engine;
* ``approx-div``: every correctly rounded division of the step
  (:data:`DIVISIONS`) swapped for ``__fdividef`` (its results are wrong;
  the gap to ``kernel`` is what exact division costs);
* ``profile``: the kernel with ``clock64()`` read at section boundaries of
  the step, summed over the first thread of each warp, printed as cycles a
  warp-step for the first two states.

Each is timed on the sweep's initial state ("first": every row computing),
after 20 chunks ("mid"), and after 20 chunks with the histogram left out
("mid, no histogram").  Prints the card's name and power limit first.
Not part of the engine: the copies are never used for results.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "repro_torch" / "variants"

#: section boundaries of the step, in source order, for the profile copy
MARKS = ("    const bool computing = phase == kCompute;",
         "    float dt;\n    int32_t ev;",
         "    int32_t cls = ev % 4;",
         "    // ---- failure handling",
         "    int p_run = 0, p_take = 0;",
         "    // ---- repair completions",
         "    // ---- streaming histograms",
         "    // ---- commit")
SECTIONS = ("loop top", "rates, residuals", "race", "progress..diagnosis",
            "waterfall choice", "picks, compartments", "repairs",
            "histograms", "commit, quotients")

PROFILE_PRELUDE = """__device__ unsigned long long g_prof[16];
extern "C" int prof_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof,
                                               sizeof(g_prof)));
}
extern "C" int prof_reset() {
  unsigned long long z[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
}
#define PROF(i) { const long long c_ = clock64(); acc[i] += c_ - last; \\
                  last = c_; }
namespace {

__device__ __forceinline__ float f(bool b)"""


#: every correctly rounded division of the step, by file
DIVISIONS = {"src": ("aut[j] / auto_div", "man[j] / man_div",
                     "lane_of(aut, ja) / auto_div",
                     "lane_of(man, cls) / man_div",
                     "m[kUsefulWork] / fmaxf(t_new, kMinDiv)"),
             "hdr": ("-logf(u_time) / safe", "c / s")}


def _approx_div(src: str, hdr: str):
    texts = {"src": src, "hdr": hdr}
    for key, divisions in DIVISIONS.items():
        for division in divisions:
            if division not in texts[key]:
                raise SystemExit(f"division {division!r} not in the kernel")
            num, den = division.split(" / ", 1)
            texts[key] = texts[key].replace(
                division, f"__fdividef({num}, {den})")
    return texts["src"], texts["hdr"]


def _profile(src: str, hdr: str):
    src = src.replace("namespace {\n\n__device__ __forceinline__ float "
                      "f(bool b)", PROFILE_PRELUDE, 1)
    for i, mark in enumerate(MARKS):
        if mark not in src:
            raise SystemExit(f"section mark {mark!r} not in the kernel")
        src = src.replace(mark, f"    PROF({i});\n" + mark, 1)
    src = src.replace(
        "  for (int k = 0; k < a.n_steps; ++k) {",
        "  long long acc[16] = {0};\n  long long last = clock64();\n"
        "  for (int k = 0; k < a.n_steps; ++k) {\n    acc[15] += 1;", 1)
    src = src.replace(
        "    if (phase == kDone) break;\n  }",
        f"    PROF({len(MARKS)});\n    if (phase == kDone) break;\n  }}\n"
        "  if ((threadIdx.x & 31) == 0) {\n#pragma unroll\n"
        "    for (int i = 0; i < 16; ++i) {\n"
        "      atomicAdd(&g_prof[i], (unsigned long long)acc[i]);\n    }\n"
        "  }", 1)
    return src, hdr


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_chunk_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import vectorized as tv
    from repro_torch.core.params import MINUTES_PER_DAY, Params
    from repro_torch.kernels import _build, ctmc_chunk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = (CSRC / "ctmc_chunk.cu").read_text()
    hdr = (CSRC / "event_race.cuh").read_text()
    libs = {"kernel": ctmc_chunk.LIBRARY}
    for tag, make in (("approx-div", _approx_div), ("profile", _profile)):
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        s, h = make(src, hdr)
        for header in CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "ctmc_chunk.cu").write_text(s)
        (d / "event_race.cuh").write_text(h)
        lib = _build.CudaLibrary("ctmc_chunk", ctmc_chunk._bind,
                                 extra_flags=ctmc_chunk.LIBRARY.flags[
                                     len(_build.NVCC_FLAGS):])
        lib.source, lib.name = d / "ctmc_chunk.cu", f"ctmc_chunk_{tag}"
        libs[tag] = lib
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for tag, lib in libs.items():
        report = [line.strip() for line in lib.build_log.splitlines()
                  if "registers" in line or "stack frame" in line]
        print(f"{tag}: {'; '.join(report) or 'built earlier'}")

    pts = [Params(job_length=16 * MINUTES_PER_DAY, warm_standbys=w)
           for w in (4, 8, 16, 32)]
    R, P = 1024, len(pts)
    pv = torch.as_tensor(np.repeat(np.stack(
        [tv._params_vector(p) for p in pts]), R, 0), device="cuda")
    channels = tv._hist_channels(pts)

    def draw(i):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(tv._chunk_seed(0, i))
        return torch.rand((64, R, 8), generator=gen,
                          device="cuda").clamp_min_(1e-12)

    first = tv._initial_state_batch(pts, R, pts[0].max_run_records, "cuda")
    mid = first
    for i in range(20):
        mid = ctmc_chunk.ctmc_chunk_cuda(mid, draw(i), pv, R, P, channels)
    no_hist = {k: v for k, v in mid.items()
               if k not in ("hist", "hist_edges")}
    states = (("first", first, channels), ("mid", mid, channels),
              ("mid, no histogram", no_hist, ()))
    us = draw(20)
    for tag, lib in libs.items():
        ctmc_chunk.LIBRARY = lib
        for label, state, ch in states:
            split = chip_smoke.device_kernels_ms(
                lambda: ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, ch),
                20)
            ms = sum(t for name, t in split if "ctmc_chunk_kernel" in name)
            print(f"{tag}, {label}: {ms * 1e3:.3f} us a launch, "
                  f"{ms * 1e3 / 64:.4f} us a step")
    lib = libs["profile"].load()
    buf = (ctypes.c_ulonglong * 16)()
    ctmc_chunk.LIBRARY = libs["profile"]
    for label, state, ch in states[:2]:
        lib.prof_reset()
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, ch)
        torch.cuda.synchronize()
        lib.prof_read(buf)
        n = max(buf[15], 1)
        parts = ", ".join(f"{name} {buf[i] / n:.0f}"
                          for i, name in enumerate(SECTIONS))
        total = sum(buf[i] for i in range(len(SECTIONS))) / n
        print(f"profile, {label}: cycles a warp-step: {parts}; "
              f"total {total:.0f}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONWARNINGS", "ignore")
    sys.exit(main())
