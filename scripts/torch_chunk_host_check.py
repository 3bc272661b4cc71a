#!/usr/bin/env python3
"""Check the CTMC chunk kernel's arithmetic on the host, without a card.

    PYTHONPATH=src python scripts/torch_chunk_host_check.py [--kinds ...]
        [--age64] [--wide]

Compiles ``src/repro_torch/csrc/ctmc_chunk.cu`` as host C++ (``g++
-ffp-contract=off``, so no multiply-add is contracted, as ``nvcc
-fmad=false`` builds it for the card) against a small header that stubs
the CUDA keywords, runs its launch as a loop over rows through the same
``ChunkArgs`` as the card, and compares every lane with the plain chunk
(``vectorized._steps_ref``) on CPU tensors, for each failure family, alone
and through its scenario instance (fault domains, a campaign kill and a
maintenance window).  ``--age64`` builds the float64 twins instead
(``-DCTMC_AGE_T=double``, ``Params.age_dtype="float64"``); ``--wide``
the wide twins (``-DCTMC_WIDE``: the edges read where they lie, any
segment count), on the same cases and on an empirical fit of 70 segments a
clock.

The plain chunk runs with ``torch.log``, ``torch.exp``, ``torch.pow`` and
``torch.special.log_ndtr`` swapped for the C library's ``logf``, ``expf``
and ``powf`` (``pow`` on the float64 age lane) and the kernel's own
``log_ndtr`` (the CPU's torch functions
differ from those by an ulp on some inputs; on the card PyTorch calls
``logf``, ``expf`` and ``powf``).  So a difference here is a difference of
operations or their order, not of a library's rounding.  Whether PyTorch's
CUDA functions and the card's libdevice round as the kernel does is what
``chip_smoke.py`` phase 14 measures.  Prints the bit-different elements
a family and exits 1 if any.
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
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "repro_torch" / "host_check"

#: the CUDA names the kernel uses, for a host compiler
STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>
#define __global__
#define __device__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(n)
struct dim3h { unsigned x, y, z; };
inline thread_local dim3h threadIdx{0, 0, 0}, blockIdx{0, 0, 0},
    blockDim{1, 1, 1};
inline std::vector<float> host_smem;
inline void __syncthreads() {}
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __log2f(float x) { return std::log2(x); }
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v;
                                             return o; }
using std::isfinite;
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
// one thread a block, blocks in order: each row's thread stages the
// histogram edges itself before it reads them
template <class K, class A>
inline void host_launch(K kernel, long long blocks, size_t smem, const A& a) {
  host_smem.assign(smem / sizeof(float) + 1, 0.0f);
  for (long long r = 0; r < a.n_rows; ++r) {
    blockIdx = {static_cast<unsigned>(r), 0, 0};
    kernel(a);
  }
}
"""

EXTRA = r"""
extern "C" float host_log_ndtr(float x) { return log_ndtr(x); }
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
        "host_launch(ctmc_chunk_kernel<kKind, AgeT>, blocks, smem, *args);",
        src)
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


def _elementwise(fn, *args, dtype="float32"):
    import numpy as np
    import torch
    arrays = torch.broadcast_tensors(*[torch.as_tensor(a) for a in args])
    flat = [a.detach().numpy().astype(dtype).ravel() for a in arrays]
    out = np.array([fn(*vals) for vals in zip(*flat)], dtype)
    return torch.from_numpy(out.reshape(arrays[0].shape))


def _libm_patches(lib):
    import torch
    from repro_torch.core import hazards
    libm = ctypes.CDLL("libm.so.6")
    for name, n in (("logf", 1), ("expf", 1), ("powf", 2)):
        getattr(libm, name).argtypes = [ctypes.c_float] * n
        getattr(libm, name).restype = ctypes.c_float
    libm.pow.argtypes = [ctypes.c_double] * 2
    libm.pow.restype = ctypes.c_double
    lib.host_log_ndtr.argtypes = [ctypes.c_float]
    lib.host_log_ndtr.restype = ctypes.c_float

    def pow_(x, y):
        # the hazards' pow in the age lane's dtype: powf, or pow on the
        # float64 lane
        if x.dtype == torch.float64:
            return _elementwise(libm.pow, x, y, dtype="float64")
        return _elementwise(libm.powf, x, y)
    return (
        mock.patch.object(hazards, "_pow", pow_),
        mock.patch.object(torch, "log", lambda x: _elementwise(libm.logf, x)),
        mock.patch.object(torch, "exp", lambda x: _elementwise(libm.expf, x)),
        mock.patch.object(torch, "pow",
                          lambda x, y: _elementwise(libm.powf, x, y)),
        mock.patch.object(torch.special, "log_ndtr",
                          lambda x: _elementwise(lib.host_log_ndtr, x)))


def _wide_edges(n_seg: int):
    """An empirical fit's (edges, rates) of ``n_seg`` segments a clock."""
    edges = [0.05 * (i + 1) for i in range(n_seg - 1)]
    rates = [0.3 + 1.2 * ((7 * i) % 11) / 10.0 for i in range(n_seg)]
    return {"edges": edges, "rates": rates}


def cases(wide: bool = False):
    """family -> case -> (Params grid, replicas a point): each family at
    the sizes of tests/test_nonexp.py, alone, as a sweep with one
    parameter row a replica, and with a job short enough to finish; then
    under a fault-domain scenario (rack and pod shocks, a kill and a
    maintenance window, checkpoints, thin pools, so bulk kills stall with a
    deficit over 1 and land in checkpoint writes), alone, as a shock-rate
    sweep, and with the pod level only and no campaign."""
    from repro_torch.core.faultdomains import (Campaign, CampaignEvent,
                                               FaultTopology)
    from repro_torch.core.params import MINUTES_PER_DAY as DAY
    from repro_torch.core.params import Params
    base = Params(job_size=24, working_pool_size=32, spare_pool_size=4,
                  warm_standbys=2, job_length=2 * DAY,
                  random_failure_rate=2.0 / DAY,
                  systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
                  auto_repair_time=30.0, manual_repair_time=120.0)
    fam = {
        "exponential": {},
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
    out = {}
    for kind, kw in fam.items():
        p = base.replace(**kw)
        out[kind] = {
            "alone": ([p], 48),
            "sweep": ([p, p.replace(checkpoint_interval=60.0,
                                    checkpoint_cost=2.0),
                       p.replace(warm_standbys=0,
                                 random_failure_rate=4.0 / DAY)], 20),
            # rows that finish mid-chunk
            "short": ([p.replace(job_length=0.1 * DAY)], 32),
        }
        topo = FaultTopology(n_racks=4, racks_per_pod=2,
                             rack_shock_rate=1e-3, pod_shock_rate=3e-4)
        camp = Campaign(events=(
            CampaignEvent(time=200.0, kind="kill", domain=3),
            CampaignEvent(time=300.0, kind="maintenance", duration=150.0)))
        sc = p.replace(fault_domains=topo, campaign=camp, warm_standbys=1,
                       checkpoint_interval=40.0, checkpoint_cost=3.0)
        out[kind].update({
            "scen": ([sc], 48),
            "scen_sweep": ([sc.replace(fault_domains=FaultTopology(
                n_racks=4, racks_per_pod=2, rack_shock_rate=r,
                pod_shock_rate=3e-4)) for r in (0.0, 1e-3, 3e-3)], 20),
            "scen_pods": ([p.replace(fault_domains=FaultTopology(
                n_racks=3, racks_per_pod=3, pod_shock_rate=2e-3),
                job_length=0.1 * DAY)], 32),
        })
    if wide:
        p = base.replace(failure_distribution="empirical",
                         distribution_kwargs=_wide_edges(70))
        out["empirical"]["wide_seg"] = ([p, p.replace(
            checkpoint_interval=60.0, checkpoint_cost=2.0)], 20)
    return out


def run(kinds, n_chunks: int, age64: bool = False,
        wide: bool = False) -> int:
    import numpy as np
    import torch
    from repro_torch.core import faultdomains, hazards
    from repro_torch.core import vectorized as tv
    from repro_torch.kernels import ctmc_chunk
    torch.set_num_threads(1)
    lib = ctypes.CDLL(str(build(age64, wide)))
    ctmc_chunk._bind(lib)
    bad = 0
    for kind in kinds:
        for label, (pts, R) in cases(wide)[kind].items():
            if age64:
                pts = [p.replace(age_dtype="float64") for p in pts]
            assert {hazards.hazard_kind(p) for p in pts} == {kind}
            P = len(pts)
            n_seg = hazards.hazard_segment_count(pts[0])
            scen = faultdomains.scenario_key(pts[0])
            codes = (torch.tensor(scen[1], dtype=torch.int32)
                     if scen and scen[1] else None)
            rows = np.stack([tv._params_vector(p) for p in pts])
            pv = (torch.as_tensor(rows[0]) if P == 1 else
                  torch.as_tensor(np.repeat(rows, R, axis=0)))
            channels = tv._hist_channels(pts)
            want = tv._initial_state_batch(pts, R, 4, "cpu", scen=scen)
            got = {k: v.clone() for k, v in want.items()}
            diff = 0
            stalls = [0, 0]
            for i in range(n_chunks):
                gen = torch.Generator().manual_seed(tv._chunk_seed(3, i))
                us = torch.rand((64, tv._next_pow2(R), tv._n_uniforms(kind)),
                                generator=gen).clamp_min_(1e-12)
                layout = ctmc_chunk.chunk_layout(got, us, pv, R, P, channels,
                                                 kind=kind, n_seg=n_seg,
                                                 scen=scen, wide=wide)
                err = lib.ctmc_chunk_launch(ctypes.byref(
                    ctmc_chunk._args(layout, codes)), None)
                if err:
                    raise SystemExit(f"{kind}: host launch returned {err}")
                with ExitStack() as stack:
                    for patch in _libm_patches(lib):
                        stack.enter_context(patch)
                    # a scenario's plain chunk runs a step at a time (the
                    # same steps) to count what its steps reached
                    for k in (range(us.shape[0]) if scen is not None
                              else [None]):
                        before = want
                        want = tv._steps_ref(
                            want, us if k is None else us[k:k + 1], pv, R, P,
                            "ref", channels, kind, n_seg, scen=scen)
                        if k is not None:
                            stalls[0] += int(((want["phase"] == tv.STALL)
                                              & (want["deficit"] > 1.0)
                                              & (before["phase"] != tv.STALL)
                                              ).sum())
                            stalls[1] += int(((before["in_ckpt"] > 0)
                                              & (want["n_shock_killed"]
                                                 > before["n_shock_killed"])
                                              ).sum())
                for k, w in want.items():
                    g = got[k]
                    assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
                    if w.dtype.is_floating_point:
                        diff += int((g.view(torch.int32)
                                     != w.view(torch.int32)).sum())
                    else:
                        diff += int((g != w).sum())
            fails = float(want["n_failures"].sum())
            done = float((want["phase"] == tv.DONE).float().mean())
            extra = ""
            if scen is not None:
                shocks = float(want["n_domain_shocks"].sum())
                entries = float(want["n_campaign_events"].sum())
                extra = (f", {shocks:.0f} shocks, {entries:.0f} campaign "
                         f"entries, {stalls[0]} stalls owing over 1, "
                         f"{stalls[1]} kills in a write")
            print(f"{kind:12s} {label:10s}: {P} x {R} rows, {n_chunks} x 64 "
                  f"steps, {fails:.0f} failures, {done:.2f} done{extra}; "
                  f"bit-different elements {diff}")
            bad += diff
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kinds", nargs="+",
                    default=["exponential", "weibull", "bathtub", "lognormal",
                             "empirical"])
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--age64", action="store_true",
                    help="the float64 age instances")
    ap.add_argument("--wide", action="store_true",
                    help="the wide instances (-DCTMC_WIDE)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    return run(args.kinds, args.chunks, args.age64, args.wide)


if __name__ == "__main__":
    sys.exit(main())
