#!/usr/bin/env python3
"""Check the multi-job chunk kernel's arithmetic on the host, without a card.

    PYTHONPATH=src python scripts/torch_mj_chunk_host_check.py [--chunks 3]
        [--runtime]

Compiles ``src/repro_torch/csrc/mj_chunk.cu`` as host C++ (``g++
-ffp-contract=off``, so no multiply-add is contracted, as ``nvcc
-fmad=false`` builds it for the card) against the stub header of
``scripts/torch_chunk_host_check.py`` (the CUDA keywords, a block of one
thread a row), runs its launch as a loop over rows through the same
``MjChunkArgs`` as the card, and compares every lane with the plain chunk
(``vectorized_multijob._mj_steps`` with ``impl="ref"``) on CPU tensors: at
one, two, three, four and eight jobs, finite and unbounded repair shops,
histograms on and off, a run-duration ring that wraps, one parameter row
shared by the batch and a grid of rows, and two jobs stalled at the same
instant.  ``--runtime`` checks the runtime-J instance instead
(``-DMJ_RUNTIME_J``) on the same cases and at nine and sixteen jobs, each
case twice: a row's words in shared memory, then in global memory.

The plain chunk runs with ``torch.log`` swapped for the C library's
``logf`` (the CPU's torch function differs from it by an ulp on some
inputs; on the card PyTorch calls ``logf``).  So a difference here is a
difference of operations or their order, not of a library's rounding.
Whether PyTorch's CUDA kernels round as the card's kernel does is what the
``gpu`` cases and ``chip_smoke.py`` phase 20 measure.  Prints the
bit-different elements a case and exits 1 if any.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch_chunk_host_check as base

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "repro_torch" / "host_check"

#: what the multi-job kernel needs beyond the single-job kernel's stubs
STUB = base.STUB + r"""
struct alignas(8) float2 { float x, y; };
"""


def build(runtime: bool = False) -> Path:
    """The host library of the current kernel source (its runtime-J
    instance for ``runtime``)."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cuda_runtime.h").write_text(STUB)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    src = (CSRC / "mj_chunk.cu").read_text()
    src, n = re.subn(r"mj_chunk_kernel<J>\s*<<<.*?>>>\(\*args\);",
                     "host_launch(mj_chunk_kernel<J>, blocks, smem, *args);",
                     src, flags=re.S)
    src, n_rt = re.subn(
        r"mj_chunk_kernel_rt<<<.*?>>>\(\s*\*args, rates, words\);",
        "host_launch([&](const MjChunkArgs& x) { mj_chunk_kernel_rt(x, "
        "rates, words); }, blocks, smem, *args);", src, flags=re.S)
    if n != 1 or n_rt != 1:
        raise SystemExit("the kernel launch was not found in mj_chunk.cu")
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = host_smem.data();")
    (OUT / "mj_chunk_host.cpp").write_text(src)
    lib = OUT / f"mj_chunk_host{'_rt' if runtime else ''}.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(OUT)]
                   + (["-DMJ_RUNTIME_J"] if runtime else [])
                   + ["-o", str(lib), str(OUT / "mj_chunk_host.cpp")],
                   check=True)
    return lib


def cases(runtime: bool = False):
    """case -> (points, replicas a point, ring records): the stall-tie
    states of tests/test_torch_multijob.py (a repaired server, then a
    completing job's release, goes to the lower of two jobs stalled at
    the same instant; :func:`tie_state`), the lockstep
    clusters of tests/test_torch_multijob.py (short jobs on tight pools
    and a busy, error-prone shop, so a few chunks hold stalls, hand-offs,
    queue admissions and completion releases) at two and four jobs, finite
    and unbounded shops; a three-job grid with histograms off; one job
    with a finite shop; eight jobs (the kernel's cap)."""
    from repro_torch.core.multijob import JobSpec
    from repro_torch.core.params import Params
    lock = Params(working_pool_size=60, spare_pool_size=4, job_size=16,
                  job_length=400.0, random_failure_rate=0.004,
                  systematic_failure_rate=0.01, auto_repair_time=150.0,
                  manual_repair_time=400.0, repair_servers=3,
                  diagnosis_uncertainty=0.2)
    two = (JobSpec(32, 300.0, 2), JobSpec(16, 500.0, 1))
    three = (JobSpec(20, 300.0, 2), JobSpec(12, 450.0, 1),
             JobSpec(8, 350.0, 1))
    four = (JobSpec(24, 300.0, 2), JobSpec(16, 400.0, 1),
            JobSpec(12, 350.0, 1), JobSpec(8, 500.0, 1))
    eight = tuple(JobSpec(6, 200.0 + 40.0 * j, j % 2) for j in range(8))
    four_c = lock.replace(working_pool_size=66)
    # tests/test_torch_multijob.py's tie states: three jobs on 8 servers,
    # jobs 1 and 2 stalled at the same instant
    tie = Params(working_pool_size=8, spare_pool_size=0, job_size=1,
                 job_length=10.0, random_failure_rate=0.0,
                 systematic_failure_rate=0.0,
                 systematic_failure_fraction=0.0,
                 automated_repair_probability=1.0,
                 auto_repair_failure_probability=0.0, auto_repair_time=5.0,
                 histogram=None)
    tie_jobs = (JobSpec(1, 10.0, 0), JobSpec(2, 100.0, 0),
                JobSpec(2, 100.0, 0))
    out = {
        "ties_handoff": ([(tie, tie_jobs)], 8, 4),
        "ties_release": ([(tie, tie_jobs)], 8, 4),
        "J2_shop3": ([(lock, two)], 48, 4),
        "J2_unbounded": ([(lock.replace(repair_servers=0), two)], 48, 4),
        "J3_grid_nohist": ([(lock.replace(spare_pool_size=s,
                                          repair_servers=r, histogram=None),
                             three) for s in (2, 6) for r in (0, 2)], 16, 4),
        "J4_shop3": ([(four_c, four)], 40, 77),
        "J4_unbounded": ([(four_c.replace(repair_servers=0), four)], 40, 3),
        "J1_shop2": ([(lock.replace(repair_servers=2),
                       (JobSpec(40, 600.0, 3),))], 48, 4),
        "J8_shop4": ([(lock.replace(working_pool_size=70, repair_servers=4),
                       eight)], 24, 4),
    }
    if runtime:
        nine = tuple(JobSpec(4, 100.0 + 30.0 * j, j % 2) for j in range(9))
        sixteen = tuple(JobSpec(3, 150.0 + 20.0 * j, j % 3)
                        for j in range(16))
        out["J9_shop3"] = ([(lock.replace(working_pool_size=60), nine)], 24,
                           4)
        out["J16_unbounded"] = ([(lock.replace(working_pool_size=60,
                                               repair_servers=0), sixteen)],
                                16, 3)
    return out


def tie_state(state, handoff: bool):
    """The tie states: job 0 computes and one of its servers finishes an
    automated repair that heals (``handoff``), or job 0 completes at once
    and releases its server; jobs 1 and 2 stalled since t = 5."""
    import torch
    from repro_torch.core import vectorized as tv
    state["phase"][:] = torch.tensor([tv.COMPUTE, tv.STALL, tv.STALL],
                                     dtype=torch.int32)
    state["stall_start"][:] = torch.tensor([0.0, 5.0, 5.0])
    if handoff:
        state["work_left"][:, 0] = 1e6
        state["auto"][:, 0, 0] = 1.0
        state["fw"][:, 0] -= 1.0
    else:
        state["work_left"][:, 0] = 1.0
    return state


def run(n_chunks: int, runtime: bool = False) -> int:
    import numpy as np
    import torch
    from repro_torch.core import vectorized as tv
    from repro_torch.core import vectorized_multijob as tm
    from repro_torch.kernels import mj_chunk
    torch.set_num_threads(1)
    lib = ctypes.CDLL(str(build(runtime)))
    (mj_chunk._bind_rt if runtime else mj_chunk._bind)(lib)
    libm = ctypes.CDLL("libm.so.6")
    libm.logf.argtypes = [ctypes.c_float]
    libm.logf.restype = ctypes.c_float
    log_patch = mock.patch.object(
        torch, "log", lambda x: base._elementwise(libm.logf, x))
    bad = 0
    todo = [(label, case, global_words)
            for label, case in cases(runtime).items()
            for global_words in ((False, True) if runtime else (False,))]
    for label, (pts, R, max_runs), global_words in todo:
        P, J = len(pts), len(pts[0][1])
        rows = np.stack([tm._mj_params_vector(c, js) for c, js in pts])
        pv = (torch.as_tensor(rows[0]) if P == 1 else
              torch.as_tensor(np.repeat(rows, R, axis=0)))
        channels = tv._selected_channels(pts[0][0].histogram)
        want = tm._mj_initial_state_batch(pts, R, max_runs, "cpu")
        if label.startswith("ties_"):
            want = tie_state(want, label == "ties_handoff")
        got = {k: v.clone() for k, v in want.items()}
        diff = 0
        for i in range(n_chunks):
            gen = torch.Generator().manual_seed(tv._chunk_seed(3, i))
            us = torch.rand((64, tv._next_pow2(R), tm._N_UNIFORMS),
                            generator=gen).clamp_min_(1e-12)
            layout = mj_chunk.mj_chunk_layout(got, us, pv, R, P, J,
                                              channels, runtime=runtime)
            args = ctypes.byref(mj_chunk._args(layout))
            if runtime:
                B = layout["n_rows"]
                rates = torch.empty(B * mj_chunk.RT_RATE_WORDS * J)
                words = (torch.empty(B * mj_chunk._WORDS_A_JOB * J)
                         if global_words else None)
                err = lib.mj_chunk_rt_launch(
                    args, rates.data_ptr(),
                    None if words is None else words.data_ptr(), None)
            else:
                err = lib.mj_chunk_launch(args, None)
            if err:
                raise SystemExit(f"{label}: host launch returned {err}")
            with log_patch:
                want = tm._mj_steps(want, us, pv, R, P, J, "ref", channels)
            for k, w in want.items():
                g = got[k]
                if w.dtype.is_floating_point:
                    diff += int((g.view(torch.int32)
                                 != w.view(torch.int32)).sum())
                else:
                    diff += int((g != w).sum())
        done = float((want["phase"] == tv.DONE).all(-1).float().mean())
        where = " (words global)" if global_words else ""
        print(f"{label + where:29s}: {P} x {R} rows, J={J}, {n_chunks} x 64 "
              "steps, "
              f"{float(want['n_failures'].sum()):.0f} failures, "
              f"{float(want['stall_handoffs'].sum()):.0f} hand-offs, "
              f"{float(want['n_shop_queued'].sum()):.0f} queued, "
              f"{int(want['n_runs'].max())} runs at most (ring "
              f"{max_runs}), {done:.2f} done, conservation "
              f"{float(want['conservation_err'].max())}; bit-different "
              f"elements {diff}")
        bad += diff
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--runtime", action="store_true",
                    help="the runtime-J instance (-DMJ_RUNTIME_J)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    return run(args.chunks, args.runtime)


if __name__ == "__main__":
    sys.exit(main())
