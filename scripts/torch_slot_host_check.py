#!/usr/bin/env python3
"""Check the chunk kernel's repair-slot instances on the host, without a card.

    PYTHONPATH=src python scripts/torch_slot_host_check.py [--cases ...]
        [--age64] [--wide]

Compiles ``src/repro_torch/csrc/ctmc_chunk.cu`` as host C++ (``g++
-ffp-contract=off``, as ``scripts/torch_chunk_host_check.py`` does) against
a header that runs each block's threads as coroutines on one host thread:
the lanes of a warp take turns, each running to its next warp collective,
so a shuffle, a ballot or a ``__syncwarp`` sees every lane's value, as on
the card.  Its launch goes through the same ``ChunkArgs`` as the card's,
and every lane is compared with the plain chunk (``vectorized._steps_ref``)
on CPU tensors, for each repair family and a slot instance of every
failure family: alone, as a sweep with one parameter row a replica and
checkpoints, with rows finishing, with the lane overflowing and at a
width that is not a power of two.  ``--age64`` checks the float64 twins
(``-DCTMC_AGE_T=double``, ``Params.age_dtype="float64"``: the remaining
times a double a slot).  ``--wide`` checks the wide twins (``-DCTMC_WIDE``:
the slot lane worked in place in the state tensors, any segment count) on
the same cases and on an empirical repair of 70 segments a stage.

The plain chunk runs with ``torch.log``, ``exp``, ``pow``, ``log1p``,
``torch.special.log_ndtr`` and ``ndtri`` swapped for the C library's
``logf``, ``expf``, ``powf``, ``log1pf`` and the kernel's own ``log_ndtr``
and ``ndtri``, so a difference here is one of operations or their order.
Whether the card rounds as PyTorch's CUDA kernels do is what
``chip_smoke.py`` phase 16 measures.  Prints the bit-different elements a
case and exits 1 if any.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from torch_chunk_host_check import _elementwise, _libm_patches  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "repro_torch" / "slot_host_check"

#: the CUDA names the kernel uses, with a block's threads as coroutines
STUB = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(n)
#define CTMC_HOST_WARP 1
struct dim3h { unsigned x, y, z; };
inline dim3h threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
inline std::vector<float> host_smem;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __log2f(float x) { return std::log2(x); }
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v;
                                             return o; }
using std::isfinite;
using std::isinf;
using std::max;
using std::min;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> inline cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// A block's threads are coroutines taking turns in a fixed round: each
// runs to its next collective and yields.  Every lane of a warp meets the
// same collectives in the same order, so when a lane resumes from one,
// every lane of its warp has written its value for it; the values
// alternate between two buffers, as a lane runs at most one collective
// ahead of the lanes after it.
namespace host_sim {
struct Coro { ucontext_t ctx; bool done = false; std::vector<char> stack; };
struct WarpBuf {
  float f[2][32];
  double d[2][32];
  int i[2][32];
  unsigned u[2][32];
  int gen[32];
};
inline std::function<void()> body;
inline ucontext_t main_ctx;
inline std::vector<Coro> coros;
inline std::vector<WarpBuf> warps;
inline int cur = 0;

inline int next_live(int from) {
  const int n = static_cast<int>(coros.size());
  for (int k = 1; k <= n; ++k) {
    const int j = (from + k) % n;
    if (!coros[j].done) return j;
  }
  return -1;
}
inline void yield() {
  const int me = cur;
  const int nx = next_live(me);
  if (nx < 0 || nx == me) return;
  cur = nx;
  swapcontext(&coros[me].ctx, &coros[nx].ctx);
  cur = me;
  threadIdx.x = static_cast<unsigned>(me);
}
inline void entry(int idx) {
  threadIdx.x = static_cast<unsigned>(idx);
  body();
  coros[idx].done = true;
  const int nx = next_live(idx);
  if (nx < 0) setcontext(&main_ctx);
  cur = nx;
  setcontext(&coros[nx].ctx);
}
inline WarpBuf& warp(int* lane, int* g) {
  const int t = static_cast<int>(threadIdx.x);
  WarpBuf& w = warps[t / 32];
  *lane = t & 31;
  *g = w.gen[*lane]++ & 1;
  return w;
}
}  // namespace host_sim

inline void __syncthreads() { host_sim::yield(); }
inline void __syncwarp() { host_sim::yield(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  int l, g;
  host_sim::WarpBuf& w = host_sim::warp(&l, &g);
  w.f[g][l] = v;
  host_sim::yield();
  return w.f[g][l ^ off];
}
inline double __shfl_xor_sync(unsigned, double v, int off) {
  int l, g;
  host_sim::WarpBuf& w = host_sim::warp(&l, &g);
  w.d[g][l] = v;
  host_sim::yield();
  return w.d[g][l ^ off];
}
inline int __shfl_xor_sync(unsigned, int v, int off) {
  int l, g;
  host_sim::WarpBuf& w = host_sim::warp(&l, &g);
  w.i[g][l] = v;
  host_sim::yield();
  return w.i[g][l ^ off];
}
inline unsigned __ballot_sync(unsigned, int p) {
  int l, g;
  host_sim::WarpBuf& w = host_sim::warp(&l, &g);
  w.u[g][l] = p != 0 ? 1u : 0u;
  host_sim::yield();
  unsigned m = 0;
  for (int k = 0; k < 32; ++k) m |= w.u[g][k] << k;
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

// blocks in order, each block's threads as coroutines
template <class K, class A>
inline void host_launch(K kernel, long long blocks, int threads, size_t smem,
                        const A& a) {
  using namespace host_sim;
  for (long long blk = 0; blk < blocks; ++blk) {
    host_smem.assign(smem / sizeof(float) + 1, 0.0f);
    blockIdx = {static_cast<unsigned>(blk), 0, 0};
    blockDim = {static_cast<unsigned>(threads), 1, 1};
    body = [&] { kernel(a); };
    coros.clear();
    coros.resize(threads);
    warps.assign((threads + 31) / 32, WarpBuf{});
    for (int t = 0; t < threads; ++t) {
      Coro& c = coros[t];
      c.stack.resize(1 << 18);
      getcontext(&c.ctx);
      c.ctx.uc_stack.ss_sp = c.stack.data();
      c.ctx.uc_stack.ss_size = c.stack.size();
      c.ctx.uc_link = nullptr;
      makecontext(&c.ctx, reinterpret_cast<void (*)()>(&entry), 1, t);
    }
    cur = 0;
    swapcontext(&main_ctx, &coros[0].ctx);
  }
}
"""

EXTRA = r"""
extern "C" float host_log_ndtr(float x) { return log_ndtr(x); }
extern "C" float host_ndtri(float x) { return ndtri(x); }
"""


def build(age64: bool = False, wide: bool = False) -> Path:
    """The host library of the current kernel source (its float64 twins
    for ``age64``, its wide twins for ``wide``)."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cuda_runtime.h").write_text(STUB)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    src = (CSRC / "ctmc_chunk.cu").read_text()
    src, n = re.subn(
        r"ctmc_chunk_kernel<kKind, AgeT>\s*<<<.*?>>>\(\*args\);",
        "host_launch(ctmc_chunk_kernel<kKind, AgeT>, blocks, kThreads, "
        "smem, *args);", src)
    if n != 1:
        raise SystemExit("the kernel launch was not found in ctmc_chunk.cu")
    src = src.replace("extern __shared__ float s_edges[];",
                      "float* s_edges = host_smem.data();")
    (OUT / "ctmc_chunk_host.cpp").write_text(src + EXTRA)
    lib = OUT / (f"ctmc_chunk_host{'64' if age64 else ''}"
                 f"{'_wide' if wide else ''}.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(OUT)]
                   + (["-DCTMC_AGE_T=double"] if age64 else [])
                   + (["-DCTMC_WIDE"] if wide else [])
                   + ["-o", str(lib), str(OUT / "ctmc_chunk_host.cpp")],
                   check=True)
    return lib


def _patches(lib):
    import torch
    libm = ctypes.CDLL("libm.so.6")
    libm.log1pf.argtypes = [ctypes.c_float]
    libm.log1pf.restype = ctypes.c_float
    lib.host_ndtri.argtypes = [ctypes.c_float]
    lib.host_ndtri.restype = ctypes.c_float
    return _libm_patches(lib) + (
        mock.patch.object(torch, "log1p",
                          lambda x: _elementwise(libm.log1pf, x)),
        mock.patch.object(torch.special, "ndtri",
                          lambda x: _elementwise(lib.host_ndtri, x)))


def cases():
    """name -> (Params grid, replicas a point, slot width or None for the
    engine's): tests/test_repair_dist.py's cluster under each repair
    family, and a slot instance of each failure family."""
    from repro_torch.core.params import MINUTES_PER_DAY as DAY
    from repro_torch.core.params import Params
    base = Params(job_size=24, working_pool_size=32, spare_pool_size=4,
                  warm_standbys=2, job_length=2 * DAY,
                  random_failure_rate=2.0 / DAY,
                  systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
                  auto_repair_time=30.0, manual_repair_time=120.0)
    rep = {
        "weibull": dict(repair_distribution="weibull",
                        distribution_kwargs={"k": 0.7}),
        "lognormal": dict(repair_distribution="lognormal",
                          distribution_kwargs={"sigma": 1.2}),
        "deterministic": dict(repair_distribution="deterministic"),
        "empirical": dict(repair_distribution="empirical",
                          distribution_kwargs={"edges": [0.5],
                                               "rates": [0.1, 2.0]}),
    }
    out = {}
    for rkind, kw in rep.items():
        p = base.replace(**kw)
        out[f"{rkind}_alone"] = ([p], 24, None)
        out[f"{rkind}_sweep"] = ([p, p.replace(checkpoint_interval=60.0,
                                               checkpoint_cost=2.0),
                                  p.replace(warm_standbys=0,
                                            auto_repair_time=90.0)], 10,
                                 None)
        out[f"{rkind}_short"] = ([p.replace(job_length=0.1 * DAY)], 16, None)
    wb = base.replace(**rep["weibull"])
    # a lane of one slot (it overflows), and a width of 44 (the physical
    # cap, every server) that long manual repairs fill past its first 32
    # slots: a small job on a large pool keeps failing while they pile up
    out["weibull_overflow"] = ([wb.replace(auto_repair_time=2 * DAY)], 16, 1)
    out["weibull_width_44"] = ([wb.replace(
        job_size=4, working_pool_size=44, spare_pool_size=0,
        warm_standbys=0, random_failure_rate=8.0 / DAY,
        auto_repair_time=0.5 * DAY, manual_repair_time=30 * DAY,
        automated_repair_probability=0.3, repair_slots=44)], 16, None)
    # a slot instance of each failure family
    fam = {
        "weibull": dict(failure_distribution="weibull",
                        distribution_kwargs={"k": 1.5}),
        "bathtub": dict(failure_distribution="bathtub",
                        distribution_kwargs={"infant_factor": 8.0,
                                             "infant_tau": 0.25 * DAY}),
        "lognormal": dict(failure_distribution="lognormal",
                          distribution_kwargs={"sigma": 1.0}),
        "empirical": dict(failure_distribution="empirical",
                          distribution_kwargs={"edges": [0.4, 2.0],
                                               "rates": [0.3, 1.5, 0.7]}),
    }
    for kind, kw in fam.items():
        args = {**kw, "repair_distribution": "weibull"}
        args["distribution_kwargs"] = {**kw["distribution_kwargs"],
                                       "k": kw["distribution_kwargs"].get(
                                           "k", 0.7)}
        if kind == "empirical":
            args["repair_distribution"] = "empirical"
        out[f"{kind}_failures"] = ([base.replace(**args)], 16, None)
    # an empirical repair of 70 segments a stage (the wide instances only)
    out["empirical_70_segments"] = ([base.replace(
        repair_distribution="empirical", distribution_kwargs={
            "edges": [0.02 * (i + 1) for i in range(69)],
            "rates": [0.1 + 0.3 * ((5 * i) % 13) for i in range(70)]})],
        16, None)
    return out


def run(names, n_chunks: int, age64: bool = False,
        wide: bool = False) -> int:
    import numpy as np
    import torch
    from repro_torch.core import hazards
    from repro_torch.core import vectorized as tv
    from repro_torch.kernels import ctmc_chunk
    torch.set_num_threads(1)
    lib = ctypes.CDLL(str(build(age64, wide)))
    ctmc_chunk._bind(lib)
    table = cases()
    bad = 0
    for name in names:
        pts, R, width = table[name]
        if age64:
            pts = [p.replace(age_dtype="float64") for p in pts]
        P = len(pts)
        fam = {(hazards.hazard_kind(p), hazards.hazard_segment_count(p),
                hazards.repair_kind(p), hazards.repair_segment_count(p))
               for p in pts}
        assert len(fam) == 1, fam
        kind, n_seg, rkind, n_rseg = fam.pop()
        assert rkind != "exponential"
        n_slots = width or tv._repair_slots_for(pts, rkind)
        rows = np.stack([tv._params_vector(p) for p in pts])
        pv = (torch.as_tensor(rows[0]) if P == 1 else
              torch.as_tensor(np.repeat(rows, R, axis=0)))
        channels = tv._hist_channels(pts)
        want = tv._initial_state_batch(pts, R, 4, "cpu", rkind, n_slots)
        got = {k: v.clone() for k, v in want.items()}
        diff = 0
        for i in range(n_chunks):
            gen = torch.Generator().manual_seed(tv._chunk_seed(3, i))
            us = torch.rand((64, tv._next_pow2(R),
                             tv._n_uniforms(kind, rkind)),
                            generator=gen).clamp_min_(1e-12)
            layout = ctmc_chunk.chunk_layout(got, us, pv, R, P, channels,
                                             kind=kind, n_seg=n_seg,
                                             rkind=rkind, n_rseg=n_rseg,
                                             wide=wide)
            err = lib.ctmc_chunk_launch(ctypes.byref(
                ctmc_chunk._args(layout)), None)
            if err:
                raise SystemExit(f"{name}: host launch returned {err}")
            with ExitStack() as stack:
                for patch in _patches(lib):
                    stack.enter_context(patch)
                want = tv._steps_ref(want, us, pv, R, P, "ref", channels,
                                     kind, n_seg, rkind, n_rseg)
            for k, w in want.items():
                g = got[k]
                assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
                if w.dtype.is_floating_point:
                    diff += int((g.view(torch.int32)
                                 != w.view(torch.int32)).sum())
                else:
                    diff += int((g != w).sum())
        reps = float((want["n_auto_repairs"] + want["n_manual_repairs"])
                     .sum())
        busy = int(torch.isfinite(want["repair_rem"]).sum(-1).max())
        over = float(want["n_repair_overflow"].sum())
        done = float((want["phase"] == tv.DONE).float().mean())
        print(f"{name:22s}: {kind}/{rkind}, {P} x {R} rows, {n_slots} slots, "
              f"{n_chunks} x 64 steps, {reps:.0f} repairs, most slots busy "
              f"{busy}, overflows {over:.0f}, {done:.2f} done; "
              f"bit-different elements {diff}", flush=True)
        bad += diff
    return 1 if bad else 0


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=None,
                    help="case names (default: all)")
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--age64", action="store_true",
                    help="the float64 age instances")
    ap.add_argument("--wide", action="store_true",
                    help="the wide instances (-DCTMC_WIDE)")
    args = ap.parse_args()
    names = args.cases or [n for n in cases()
                           if args.wide or n != "empirical_70_segments"]
    return run(names, args.chunks, args.age64, args.wide)


if __name__ == "__main__":
    sys.exit(main())
