#!/usr/bin/env python3
"""Where the selective-scan kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_scan_variants.py

Builds timing-only copies of ``src/repro_torch/csrc/mamba_scan.cu`` next
to the real kernel, under ``build/repro_torch/variants/``, and times each
with torch.profiler at falcon-mamba-7b's prefill shape (4 x 512 tokens,
d_inner 8192, N 16, bf16, B and C column slices of the x_proj output),
beside the kernel's bound:

* ``kernel``: the kernel as built for the model (N 16 over 2 lanes);
* ``lanes-4``: N 16 over 4 lanes (4 states a lane, twice the threads);
* ``unroll-1``, ``unroll-4``: the step loop unrolled once or four times
  (the kernel unrolls it twice);
* ``no-ex2``: ``dt * A2`` in place of its ``ex2.approx`` (wrong results;
  the time without the special-function units);
* ``bf16-bc``: in bf16 the consumers read B and C from the ring as they
  came (one 16-byte bf16x8 vector each a step) and widen them in
  registers, in place of the fp32 copies the producer makes (half the
  shared-memory reads, 16 more integer instructions a lane-step);
* ``y-split``: y summed as two interleaved partial sums (a shorter
  dependent chain; another summation order);
* ``expf``: full-precision ``expf(dt * A)`` in place of ``ex2.approx``
  on the pre-scaled A (the gap is what the special-function shortcut
  saves);
* ``consumers-only``: the producer stages span 0 and nothing after it
  (the consumers rerun span 0's data; wrong results, the consumers' own
  time);
* ``producer-only``: the consumers skip the steps (wrong results, the
  producer's own time);
* ``trace``: each block records its SM and its first and last global
  timer reading, from which the blocks resident at once on an SM follow.

While the kernel runs back to back for three seconds, ``nvidia-smi``
samples the SM clock and the power draw every 100 ms.  Each copy's max
abs error against ``selective_scan_ref`` is printed beside its time, so
that a copy meant to be right is never timed broken.  Prints the card's
name and power limit first.  Not part of the model: the copies are never
used for its results.
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

LANES_LINE = "constexpr int kLanes = 2;"
PRESCALE = "for (int j = 0; j < K; ++j) A2[j] *= kLog2e;"
EX2 = "fast_exp2(d * A2[j])"
NAMESPACE = "namespace {\n"
BEGIN = "const int len_ok = a.di - c0;       // the block's channels in d_inner"
END = "  if (live) store_vec<K>(a.hf + state, h);"

TRACE_PRELUDE = """__device__ unsigned long long g_trace[3 * 8192];
extern "C" int trace_read(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_trace, sizeof(unsigned long long) * 3 * n));
}
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long smid() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}
"""
TRACE_END = """  if (tid == 0 && blockIdx.y * gridDim.x + blockIdx.x < 8192) {
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    g_trace[3 * blk] = smid();
    g_trace[3 * blk + 1] = t_begin_;
    g_trace[3 * blk + 2] = gtimer();
  }
"""

PRODUCER_LOOP = """      if (s + 1 < spans) issue(s + 1);
      if (s > 0) drain(s - 1);
      if (s + 1 < spans) land(s + 1);
      __syncthreads();                // span s + 1 in; span s's y written
    }
"""
LOAD_ROW = """// K bf16 of a B or C row, widened exactly (a bf16 is the high half of
// its fp32)
template <int K>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[K]) {
  uint32_t w[K / 2];
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int i = 0; i < K / 8; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = q.x; w[4 * i + 1] = q.y; w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x; w[1] = q.y;
  }
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
  load_vec<K>(p, v);
}

"""
BF16_BC_SUBS = (
    ("template <int W> struct Word;", LOAD_ROW + "template <int W> struct Word;"),
    ("""    const float* bs;                  // B_t at bs + t * pitch, C_t at + N
    int pitch;
    if constexpr (kConvert) {
      bs = &sm.bc[s & 1][0][g * K];
      pitch = 2 * N;
    } else {
      bs = &st.b[0][g * K];
      pitch = N;
    }
    const int cs = kConvert ? N : kSpan * N;   // C_t - B_t
""", """    const T* bs = &st.b[0][g * K];
    const int pitch = N;
    const int cs = kSpan * N;
"""),
    ("    load_vec<K>(bs, b_n);\n    load_vec<K>(bs + cs, c_n);",
     "    load_row<K>(bs, b_n);\n    load_row<K>(bs + cs, c_n);"),
    ("      load_vec<K>(bs + tn * pitch, b_n);\n"
     "      load_vec<K>(bs + tn * pitch + cs, c_n);",
     "      load_row<K>(bs + tn * pitch, b_n);\n"
     "      load_row<K>(bs + tn * pitch + cs, c_n);"),
)
Y_CHAIN = """      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float decay = fast_exp2(d * A2[j]);
        h[j] = fmaf(decay, h[j], dx * bv[j]);
        y = fmaf(h[j], cv[j], y);
      }
"""
Y_SPLIT = """      float y = 0.0f, y1 = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float decay = fast_exp2(d * A2[j]);
        h[j] = fmaf(decay, h[j], dx * bv[j]);
        if (j & 1) {
          y1 = fmaf(h[j], cv[j], y1);
        } else {
          y = fmaf(h[j], cv[j], y);
        }
      }
      y += y1;
"""

#: tag -> (substitutions into the source, lanes a channel)
VARIANTS = {
    "lanes-4": (((LANES_LINE, LANES_LINE.replace("2", "4")),), 4),
    "unroll-1": ((("#pragma unroll 2\n    for (int t = 0; t < span; ++t)",
                   "#pragma unroll 1\n    for (int t = 0; t < span; ++t)"),), 2),
    "unroll-4": ((("#pragma unroll 2\n    for (int t = 0; t < span; ++t)",
                   "#pragma unroll 4\n    for (int t = 0; t < span; ++t)"),), 2),
    "no-ex2": (((EX2, "(d * A2[j])"),), 2),
    "bf16-bc": (BF16_BC_SUBS, 2),
    "y-split": (((Y_CHAIN, Y_SPLIT),), 2),
    "expf": (((PRESCALE, PRESCALE.replace("kLog2e", "1.0f")),
              (EX2, "expf(d * A2[j])")), 2),
    "consumers-only": (((PRODUCER_LOOP, "      __syncthreads();\n    }\n"),),
                       2),
    "producer-only": ((("#pragma unroll 2\n    for (int t = 0; t < span; ++t)",
                        "#pragma unroll 2\n    for (int t = 0; t < 0; ++t)"),),
                      2),
    "trace": (((NAMESPACE, TRACE_PRELUDE + NAMESPACE),
               (BEGIN, BEGIN + "\n  const unsigned long long t_begin_ = "
                "gtimer();"),
               (END, TRACE_END + END)), 2),
}


def _variant(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{old!r} not in the kernel's source")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build, mamba_scan, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = (CSRC / "mamba_scan.cu").read_text()
    if src.count(NAMESPACE) != 1:
        raise SystemExit("the kernel's source has more than one namespace")
    libs = {"kernel": (mamba_scan.LIBRARY, mamba_scan.LANES)}
    for tag, (subs, lanes) in VARIANTS.items():
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        (d / "mamba_scan.cu").write_text(_variant(src, subs))
        lib = _build.CudaLibrary("mamba_scan", mamba_scan._bind)
        lib.source, lib.name = d / "mamba_scan.cu", f"mamba_scan_{tag}"
        libs[tag] = (lib, lanes)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda item: item[0].build(), libs.values()))
    for tag, (lib, _) in libs.items():
        report = chip_smoke.ptxas_report(lib.build_log,
                                         "selective_scan_kernel")
        print(f"{tag}: " + ("; ".join(
            f"{name} {regs} registers, {spill} B spilled, {smem} B shared"
            for name, regs, spill, smem in report) or "built earlier"))

    main_args = chip_smoke.scan_inputs(4, 512, 8192, 16, torch.bfloat16,
                                       seed=3, dt_rank=256)
    bound_ms, bound_by = chip_smoke.scan_bound_ms(main_args[0],
                                                  main_args[3], 16)
    y_r, h_r = ref.selective_scan_ref(*main_args)
    kernel_lib, kernel_lanes = mamba_scan.LIBRARY, mamba_scan.LANES
    try:
        for tag, (lib, lanes) in libs.items():
            mamba_scan.LIBRARY, mamba_scan.LANES = lib, lanes
            y, h = mamba_scan.selective_scan_cuda(*main_args)
            err = max(float((y.float() - y_r.float()).abs().max()),
                      float((h - h_r).abs().max()))
            split = chip_smoke.device_kernels_ms(
                lambda: mamba_scan.selective_scan_cuda(*main_args), 20)
            ms = sum(t for name, t in split if "selective_scan" in name)
            print(f"{tag}: {ms * 1e3:.3f} us a call, "
                  f"{bound_ms / ms * 100:.1f}% of the {bound_ms * 1e3:.3f} "
                  f"us bound ({bound_by}); max abs err {err:.3e}")
        mamba_scan.LIBRARY, mamba_scan.LANES = kernel_lib, kernel_lanes
        _sample_clocks(lambda: mamba_scan.selective_scan_cuda(*main_args))
        _read_trace(libs["trace"][0], mamba_scan, main_args)
    finally:
        mamba_scan.LIBRARY, mamba_scan.LANES = kernel_lib, kernel_lanes
    return 0


def _sample_clocks(fn, seconds: float = 3.0) -> None:
    """SM clock and power draw while ``fn`` runs back to back."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            calls += 100
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    rows = [line.split(",") for line in out.strip().splitlines()]
    clocks = sorted(float(r[0]) for r in rows[1:-1] if len(r) == 2)
    power = sorted(float(r[1]) for r in rows[1:-1] if len(r) == 2)
    if clocks:
        print(f"clocks while the kernel runs back to back ({calls} calls, "
              f"{len(clocks)} samples): SM {clocks[0]:.0f} / "
              f"{clocks[len(clocks) // 2]:.0f} / {clocks[-1]:.0f} MHz, "
              f"power {power[0]:.1f} / {power[len(power) // 2]:.1f} / "
              f"{power[-1]:.1f} W (min / median / max)")


def _read_trace(lib, mamba_scan, args) -> None:
    """Blocks resident at once on an SM, from the trace copy's records."""
    import torch
    mamba_scan.LIBRARY, mamba_scan.LANES = lib, 2
    plan = mamba_scan.launch_plan(*args[:2], *args[3:5])
    n = plan.grid[0] * plan.grid[1]
    mamba_scan.selective_scan_cuda(*args)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * n))()
    if lib.load().trace_read(buf, n):
        raise SystemExit("trace_read failed")
    rec = [(buf[3 * i], buf[3 * i + 1], buf[3 * i + 2]) for i in range(n)]
    t0 = min(r[1] for r in rec)
    span_ns = max(r[2] for r in rec) - t0
    most = {}
    for sm in {r[0] for r in rec}:
        events = sorted([(r[1], 1) for r in rec if r[0] == sm]
                        + [(r[2], -1) for r in rec if r[0] == sm])
        live = peak = 0
        for _, step in events:
            live += step
            peak = max(peak, live)
        most[sm] = peak
    durs = sorted(r[2] - r[1] for r in rec)
    counts = sorted(most.values())
    print(f"trace: {n} blocks on {len(most)} SMs in {span_ns / 1e3:.3f} us; "
          f"blocks resident at once on an SM: min {counts[0]}, median "
          f"{counts[len(counts) // 2]}, max {counts[-1]}; a block's time: "
          f"min {durs[0] / 1e3:.3f} us, median {durs[n // 2] / 1e3:.3f} us, "
          f"max {durs[-1] / 1e3:.3f} us")


if __name__ == "__main__":
    os.environ.setdefault("PYTHONWARNINGS", "ignore")
    sys.exit(main())
