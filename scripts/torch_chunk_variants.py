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
("mid, no histogram").  Then the exponential scenario instance at the
shape of ``chip_smoke.py`` phase 18 (the rack-outage sweep: 4 points of
``rack_shock_rate`` x 1,024 replicas, 45 fault domains), first and after
20 chunks, through the kernel and through a fourth copy:

* ``no-shock-lanes``: the scenario instance racing the 16 lanes alone
  (the 45 shock lanes neither summed nor picked; no shock fires, so its
  rows run as the rate-0 point's do); the gap to ``kernel`` is what the
  shock lanes cost a step.

Last, both at that shape with every point at the top rate, then at rate
0, the parameter row shared by the batch against a copy a row (the
sweep's layout): the same results, so the gap is what each thread's own
copy of the shock rates costs.  At rate 0 no shock fires and the race
still sums the 45 lanes, so there the gap between the kernel and the
no-shock-lanes copy is the lanes' own loop, without the struck steps.

Prints the card's name and power limit first.  Not part of the engine:
the copies are never used for results.
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


def _no_shock_lanes(src: str, hdr: str):
    for old, new in (("  const int kx = kExp + n_dom;",
                      "  const int kx = kExp;"),
                     ("event_race_row(rates, kExp, shock_rate, n_dom,",
                      "event_race_row(rates, kExp, shock_rate, 0,")):
        if old not in src:
            raise SystemExit(f"{old!r} not in the kernel")
        src = src.replace(old, new)
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
    for tag, make in (("approx-div", _approx_div), ("profile", _profile),
                      ("no-shock-lanes", _no_shock_lanes)):
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
        if tag == "no-shock-lanes":
            continue
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
    _time_scenario(chip_smoke, tv, ctmc_chunk, libs)
    return 0


def _time_scenario(chip_smoke, tv, ctmc_chunk, libs):
    """The exponential scenario instance at phase 18's shape, through the
    kernel and the no-shock-lanes copy."""
    import numpy as np
    import torch
    from repro_torch.core import faultdomains
    from repro_torch.core.params import MINUTES_PER_DAY, Params
    pts = [Params(job_length=chip_smoke.SHOCK_DAYS * MINUTES_PER_DAY,
                  fault_domains=faultdomains.FaultTopology(
                      n_racks=chip_smoke.SHOCK_RACKS,
                      racks_per_pod=chip_smoke.SHOCK_RACKS_PER_POD,
                      rack_shock_rate=r))
           for r in chip_smoke.SHOCK_RATES]
    scen = faultdomains.scenario_key(pts[0])
    R, P = 1024, len(pts)
    pv = torch.as_tensor(np.repeat(np.stack(
        [tv._params_vector(p) for p in pts]), R, 0), device="cuda")
    channels = tv._hist_channels(pts)

    def draw(i):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(tv._chunk_seed(0, i))
        return torch.rand((64, R, 8), generator=gen,
                          device="cuda").clamp_min_(1e-12)

    ctmc_chunk.LIBRARY = libs["kernel"]
    first = tv._initial_state_batch(pts, R, pts[0].max_run_records, "cuda",
                                    scen=scen)
    mid = first
    for i in range(20):
        mid = ctmc_chunk.ctmc_chunk_cuda(mid, draw(i), pv, R, P, channels,
                                         scen=scen)
    us = draw(20)
    print(f"scenario instance, {scen[0]} domains, rates "
          f"{chip_smoke.SHOCK_RATES}: shocks so far "
          f"{float(mid['n_domain_shocks'].sum()):.0f}")
    for tag in ("kernel", "no-shock-lanes"):
        ctmc_chunk.LIBRARY = libs[tag]
        for label, state in (("first", first), ("mid", mid)):
            split = chip_smoke.device_kernels_ms(
                lambda: ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P,
                                                   channels, scen=scen), 20)
            ms = sum(t for name, t in split if "ctmc_chunk_kernel" in name)
            print(f"scenario {tag}, {label}: {ms * 1e3:.3f} us a launch, "
                  f"{ms * 1e3 / 64:.4f} us a step")
    for p in (pts[-1], pts[0]):
        _time_layouts(chip_smoke, tv, ctmc_chunk, libs, p, scen, R, P, draw)
    ctmc_chunk.LIBRARY = libs["kernel"]


def _time_layouts(chip_smoke, tv, ctmc_chunk, libs, p, scen, R, P, draw):
    """Phase 18's shape with every point at ``p``, through the kernel and
    the no-shock-lanes copy, the parameter row passed two ways: one row
    shared by the batch (stride 0: a warp's load of a shock rate touches
    one cache line) and a copy a row (each of a warp's loads touches 32).
    The results are the same; the gap between the layouts is what the
    copies' cache lines cost."""
    import torch
    pts = [p] * P
    row = torch.as_tensor(tv._params_vector(p), device="cuda")
    layouts = (("shared row", row),
               ("row a replica", row.repeat(P * R, 1).contiguous()))
    channels = tv._hist_channels(pts)
    ctmc_chunk.LIBRARY = libs["kernel"]
    first = tv._initial_state_batch(pts, R, p.max_run_records, "cuda",
                                    scen=scen)
    mid = first
    for i in range(20):
        mid = ctmc_chunk.ctmc_chunk_cuda(mid, draw(i), row, R, P, channels,
                                         scen=scen)
    us = draw(20)
    outs = [ctmc_chunk.ctmc_chunk_cuda(mid, us, pv, R, P, channels,
                                       scen=scen) for _, pv in layouts]
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    rate = p.fault_domains.rack_shock_rate
    print(f"layouts, every point at rack_shock_rate {rate}: lanes "
          f"differing between them {differ}")
    if differ:
        raise SystemExit("the two parameter layouts give different results")
    for tag in ("kernel", "no-shock-lanes"):
        ctmc_chunk.LIBRARY = libs[tag]
        for layout, pv in layouts:
            for label, state in (("first", first), ("mid", mid)):
                split = chip_smoke.device_kernels_ms(
                    lambda: ctmc_chunk.ctmc_chunk_cuda(
                        state, us, pv, R, P, channels, scen=scen), 20)
                ms = sum(t for name, t in split
                         if "ctmc_chunk_kernel" in name)
                print(f"layout {layout}, rate {rate}, {tag}, {label}: "
                      f"{ms * 1e3:.3f} us a launch, {ms * 1e3 / 64:.4f} us "
                      "a step")


if __name__ == "__main__":
    os.environ.setdefault("PYTHONWARNINGS", "ignore")
    sys.exit(main())
