#!/usr/bin/env python3
"""Where the multi-job chunk kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_mj_chunk_variants.py

Builds three timing-only copies of ``src/repro_torch/csrc/mj_chunk.cu``
next to the real kernel, under ``build/repro_torch/variants/``, and times
all four at the shape of ``chip_smoke.py`` phase 20 (3 jobs of 64/32/16
servers on a 200-server pool, 8 points x 256 replicas = 2,048 rows, one
chunk of 64 steps) with torch.profiler:

* ``kernel``: the kernel as built for the engine (J a template
  parameter, an instance a job count);
* ``runtime-J``: one instance for every J, the job count read from the
  launch's arguments, so the per-job loops are bounded loops that do not
  unroll and the race's 16J rates sit in local memory;
* ``cp-async``: the next step's 40-byte uniform row copied into shared
  memory with ``cp.async`` (two buffers a thread) instead of loaded into
  registers;
* ``profile``: the kernel with ``clock64()`` read at section boundaries of
  the step, summed over the first thread of each warp, printed as cycles a
  warp-step.

Each copy must give the kernel's result bit for bit (the script exits 1
otherwise).  Each is timed on the grid's initial state ("first": every
row live) and after 10 chunks ("mid").  Then the kernel at 32, 64 and 128
rows a block (``kernels/mj_chunk.py::rows_per_block``'s ``widest``; the
engine launches 128), each width twice in the order 32, 64, 128, 128, 64,
32 so that a drift of the card's clock cannot order them, each held bit
for bit to the engine's launch.  Then every instance of the kernel, J = 1
to 8 (the first J of eight jobs on the same pool), first and mid, with
its registers and spills from nvcc's report.

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

#: eight jobs (size, length in minutes, warm standbys) on phase 20's pool;
#: a J-job grid takes the first J
JOBS = ((64, 720.0, 2), (32, 1000.0, 1), (16, 860.0, 1), (16, 900.0, 1),
        (8, 700.0, 0), (8, 800.0, 0), (8, 900.0, 0), (8, 1000.0, 0))
SPARES, SHOPS, R = (8, 10, 12, 14), (3, 4), 256

#: section boundaries of the step, in source order, for the profile copy
MARKS = ("    // ---- rates (16J) and residuals (2J); the stalled jobs",
         "    float dt;\n    int32_t ev;",
         "    // the race's event: class, owning / failing job",
         "    // ---- progress / completion / timers / run durations",
         "    // ---- a failure",
         "    // ---- a repair completion",
         "    // ---- a job completion: release",
         "    // ---- conservation invariant")
SECTIONS = ("uniforms", "rates, residuals", "race", "decode",
            "progress loop", "failure", "repair", "completion",
            "conservation, loop end")

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

CP_ASYNC_HELPERS = """namespace {

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\\n" ::);
}

__device__ __forceinline__ float f(bool b)"""

CP_ASYNC_LOAD = """  // the uniform rows through shared memory: two 10-float buffers a thread
  // after its words, the next step's copied with cp.async
  float* ubuf = smem + n_pad + (L::kFloats + L::kInts) * nt + 20 * tid;
  const float* ug = a.us + 10 * (b % a.R);
  const int64_t u_step = 10 * a.R_draw;             // floats a step
#pragma unroll
  for (int i = 0; i < 5; ++i) cp_async8(ubuf + 2 * i, ug + 2 * i);
  cp_async_commit();

  for (int k = 0; k < a.n_steps; ++k) {
    float u[kNU];
    cp_async_wait_all();
    const float* cur = ubuf + 10 * (k & 1);
#pragma unroll
    for (int i = 0; i < kNU; ++i) u[i] = cur[i];
    if (k + 1 < a.n_steps) {
      float* nxt = ubuf + 10 * ((k + 1) & 1);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        cp_async8(nxt + 2 * i, ug + (k + 1) * u_step + 2 * i);
      }
      cp_async_commit();
    }
"""


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"{old[:60]!r} is in the kernel "
                         f"{src.count(old)} times, not {count}")
    return src.replace(old, new)


def _runtime_j(src: str) -> str:
    src = _replace(src, "template <int J>\n__global__ void "
                   "__launch_bounds__(kMaxThreads)\n    mj_chunk_kernel("
                   "const MjChunkArgs a) {\n  using L = Layout<J>;",
                   "template <int JT>\n__global__ void "
                   "__launch_bounds__(kMaxThreads)\n    mj_chunk_kernel("
                   "const MjChunkArgs a) {\n  const int J = a.n_jobs;\n"
                   "  using L = Layout<JT>;")
    src = _replace(src, "float rates[16 * J];", "float rates[16 * JT];")
    src = _replace(src, "float resid[2 * J];", "float resid[2 * JT];")
    # a loop over the blocks' words covers the J jobs of the launch
    src = _replace(src, "i < L::kBlock;", "i < 4 * J;", 4)
    src = _replace(src, "pk = min(pk, L::kBlock - 1);",
                   "pk = min(pk, 4 * J - 1);")
    src = _replace(src, "    for (int i = 0; i < kNBlock * L::kBlock; ++i) "
                   "tot += s[i];",
                   "    for (int kb = 0; kb < kNBlock; ++kb) {\n"
                   "      for (int i = 0; i < 4 * J; ++i) "
                   "tot += s[kb * L::kBlock + i];\n    }")
    for j in range(1, 9):
        src = _replace(src, f"case {j}: return launch<{j}>(args, s);",
                       f"case {j}: return launch<8>(args, s);")
    return src


def _cp_async(src: str) -> str:
    src = _replace(src, "namespace {\n\n__device__ __forceinline__ float "
                   "f(bool b)", CP_ASYNC_HELPERS)
    a = src.index("  // the next step's uniforms, loaded before this step's")
    b = src.index("    const float u_time = u[0]")
    src = src[:a] + CP_ASYNC_LOAD + src[b:]
    return _replace(src, "smem_bytes(args, L::kFloats, L::kInts)",
                    "smem_bytes(args, L::kFloats + 20, L::kInts)")


def _profile(src: str) -> str:
    src = _replace(src, "namespace {\n\n__device__ __forceinline__ float "
                   "f(bool b)", PROFILE_PRELUDE)
    for i, mark in enumerate(MARKS):
        src = _replace(src, mark, f"    PROF({i + 1});\n" + mark)
    src = _replace(src, "  for (int k = 0; k < a.n_steps; ++k) {\n"
                   "    float u[kNU];",
                   "  long long acc[16] = {0};\n  long long last = clock64();\n"
                   "  for (int k = 0; k < a.n_steps; ++k) {\n"
                   "    acc[15] += 1;\n    PROF(0);\n    float u[kNU];")
    src = _replace(src, "    if (!any_live) break;\n  }",
                   f"    PROF({len(MARKS) + 1});\n"
                   "    if (!any_live) break;\n  }\n"
                   "  if ((threadIdx.x & 31) == 0) {\n#pragma unroll\n"
                   "    for (int i = 0; i < 16; ++i) {\n"
                   "      atomicAdd(&g_prof[i], (unsigned long long)acc[i]);\n"
                   "    }\n  }")
    return src


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_mj_chunk_variants: needs a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import vectorized as tv
    from repro_torch.core import vectorized_multijob as tm
    from repro_torch.core.multijob import JobSpec
    from repro_torch.core.params import Params
    from repro_torch.kernels import _build, mj_chunk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = (CSRC / "mj_chunk.cu").read_text()
    libs = {"kernel": mj_chunk.LIBRARY}
    for tag, make in (("runtime-J", _runtime_j), ("cp-async", _cp_async),
                      ("profile", _profile)):
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "mj_chunk.cu").write_text(make(src))
        lib = _build.CudaLibrary("mj_chunk", mj_chunk._bind,
                                 extra_flags=mj_chunk.LIBRARY.flags[
                                     len(_build.NVCC_FLAGS):])
        lib.source, lib.name = d / "mj_chunk.cu", f"mj_chunk_{tag}"
        libs[tag] = lib
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for tag, lib in libs.items():
        entry, report = None, {}
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("ILi")[1].split("EE")[0] \
                    if "ILi" in line else "?"
            elif entry and ("registers" in line or "stack frame" in line):
                report.setdefault(entry, []).append(line.strip())
        print(f"{tag}: " + ("; ".join(
            f"J={j}: {' '.join(v)}" for j, v in sorted(report.items()))
            or "built earlier"))

    def grid(J):
        cluster = Params(**chip_smoke.MJ_CLUSTER)
        jobs = tuple(JobSpec(*j) for j in JOBS[:J])
        pts = [(cluster.replace(spare_pool_size=s, repair_servers=r), jobs)
               for s in SPARES for r in SHOPS]
        pv = torch.as_tensor(np.repeat(np.stack(
            [tm._mj_params_vector(c, js) for c, js in pts]), R, 0),
            device="cuda")
        return pts, pv

    def draw(i):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(tv._chunk_seed(0, i))
        return torch.rand((64, R, tm._N_UNIFORMS), generator=gen,
                          device="cuda").clamp_min_(1e-12)

    def states(J):
        pts, pv = grid(J)
        mj_chunk.LIBRARY = libs["kernel"]
        first = tm._mj_initial_state_batch(pts, R, 77, "cuda")
        mid = first
        for i in range(10):
            mid = mj_chunk.mj_chunk_cuda(mid, draw(i), pv, R, len(pts), J,
                                         ())
        return pts, pv, (("first", first), ("mid", mid))

    def time_launch(state, us, pv, P, J):
        split = chip_smoke.device_kernels_ms(
            lambda: mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J, ()), 20)
        return sum(t for name, t in split if "mj_chunk_kernel" in name)

    def launch_at(rows, state, us, pv, P, J):
        """The kernel's launch with ``rows`` rows a block at most."""
        new = {k: v.clone() if k in mj_chunk.WRITTEN else v
               for k, v in state.items()}
        layout = mj_chunk.mj_chunk_layout(new, us, pv, R, P, J, ())
        layout["rows"] = mj_chunk.rows_per_block(J, layout["n_edges"],
                                                 widest=rows)
        args = mj_chunk._args(layout)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check_launch(mj_chunk.LIBRARY.load().mj_chunk_launch(
            ctypes.byref(args), stream), f"mj_chunk at {rows} rows a block")
        return new

    J = 3
    pts, pv, named = states(J)
    P = len(pts)
    us = draw(10)
    live = {label: int((st["phase"] != tm.DONE).any(-1).sum())
            for label, st in named}
    print(f"phase 20's pool, J = {J}, {P} x {R} rows: live rows {live}")
    bad = 0
    for tag, lib in libs.items():
        mj_chunk.LIBRARY = lib
        for label, state in named:
            if tag != "kernel":
                mj_chunk.LIBRARY = libs["kernel"]
                want = mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J, ())
                mj_chunk.LIBRARY = lib
                got = mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J, ())
                torch.cuda.synchronize()
                diff = sum(int((got[k].view(torch.int32)
                                != want[k].view(torch.int32)).sum())
                           if want[k].dtype.is_floating_point
                           else int((got[k] != want[k]).sum())
                           for k in want)
                bad += diff
                print(f"{tag}, {label}: bit-different elements against the "
                      f"kernel {diff}")
            ms = time_launch(state, us, pv, P, J)
            print(f"{tag}, {label}: {ms * 1e3:.3f} us a launch, "
                  f"{ms * 1e3 / 64:.4f} us a step")
    mj_chunk.LIBRARY = libs["kernel"]
    for label, state in named:
        want = mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J, ())
        passes = {32: [], 64: [], 128: []}
        for rows in (32, 64, 128, 128, 64, 32):
            got = launch_at(rows, state, us, pv, P, J)
            torch.cuda.synchronize()
            diff = sum(int((got[k].view(torch.int32)
                            != want[k].view(torch.int32)).sum())
                       if want[k].dtype.is_floating_point
                       else int((got[k] != want[k]).sum()) for k in want)
            bad += diff
            split = chip_smoke.device_kernels_ms(
                lambda: launch_at(rows, state, us, pv, P, J), 20)
            passes[rows].append(sum(t for name, t in split
                                    if "mj_chunk_kernel" in name))
            if diff:
                print(f"{rows} rows a block, {label}: bit-different "
                      f"elements against the engine's launch {diff}")
        print(f"rows a block, {label}: " + "; ".join(
            f"{rows}: {sum(v) / len(v) * 1e3:.3f} us a launch (passes "
            + ", ".join(f"{t * 1e3:.3f}" for t in v) + ")"
            for rows, v in passes.items()))
    lib = libs["profile"].load()
    buf = (ctypes.c_ulonglong * 16)()
    mj_chunk.LIBRARY = libs["profile"]
    for label, state in named:
        lib.prof_reset()
        mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J, ())
        torch.cuda.synchronize()
        lib.prof_read(buf)
        n = max(buf[15], 1)
        parts = ", ".join(f"{name} {buf[i + 1] / n:.0f}"
                          for i, name in enumerate(SECTIONS))
        total = sum(buf[i + 1] for i in range(len(SECTIONS))) / n
        print(f"profile, {label}: cycles a warp-step: {parts}; "
              f"total {total:.0f}")
    mj_chunk.LIBRARY = libs["kernel"]
    for J in range(1, 9):
        pts, pv, named = states(J)
        for label, state in named:
            ms = time_launch(state, draw(10), pv, len(pts), J)
            print(f"instance J={J}, {label}: {ms * 1e3:.3f} us a launch, "
                  f"{ms * 1e3 / 64:.4f} us a step")
    return 1 if bad else 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONWARNINGS", "ignore")
    sys.exit(main())
