#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- a Table-I capacity-planning sweep through
``repro_torch.core.OneWaySweep`` -- on the card, and holds the
hand-written event-race kernel against its plain PyTorch version.
Phases, each of which fails the run loudly:

1. the card's name and power limit; build the kernel from
   ``src/repro_torch/csrc/event_race.cu`` with nvcc;
2. the kernel against ``event_race_ref`` on the card, at the main path's
   shape (4,096 x 16 x 3) and at odd shapes, with all-zero-rate rows and
   exact residual ties: events exact, dt within rtol 1e-6; then the
   kernel's and the plain version's times beside the kernel's bound;
3. the main path: ``OneWaySweep`` over ``warm_standbys`` in {4, 8, 16,
   32} at the paper's full width (job_size 4096, working pool 4160,
   spare pool 200), 1,024 replicas a point, ``job_length`` cut from 64 to
   16 days; then two more points at the same width through
   ``run_replications`` with closed-form answers (no failures; repairs
   that never heal);
4. the same sweep with the plain event race (``event_race_impl="ref"``)
   on the same uniform stream: per-replica integer metrics and means
   must agree;
5. a traced window of the main path (two chunks, torch.profiler): the
   device's busy share and the ops that take the host's time.

Prints a ``{"kernels": [...]}`` line and, as its last line,
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no CUDA device or the repository's sources are missing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

TPU_KERNEL = "src/repro/kernels/des_step.py:46"
KERNEL_SOURCE = "src/repro_torch/csrc/event_race.cu"

SWEEP_VALUES = [4, 8, 16, 32]          # Table I's warm_standbys range
N_REPLICAS = 1024
JOB_DAYS = 16                          # cut from the default 64 days


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def device_seconds(prof) -> float:
    """Kernel time on the card in a profile: the device-side events only
    (a host op's row also carries its kernels' time, so summing every row
    would count it twice)."""
    total_us = 0.0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / 1e6


def device_ms(fn, iters: int):
    """Device time per call from torch.profiler, or None if it shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_s = device_seconds(prof)
    return total_s / iters * 1e3 if total_s > 0 else None


def event_ms(fn, iters: int) -> float:
    """Milliseconds per call between CUDA events over back-to-back calls
    (host dispatch included, as the step loop pays it)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def race_inputs(R: int, k_exp: int, k_det: int, seed: int):
    """Race inputs on the card with the edge cases the kernel must keep:
    zero-rate rows, switched-off lanes and timers, exact residual ties,
    and uniforms as strided columns of an (R, 8) draw, as in the step."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rates = torch.rand((R, k_exp), generator=gen, device="cuda") * 2.0
    rates[:, k_exp // 2] = 0.0
    resid = torch.rand((R, k_det), generator=gen, device="cuda") * 5.0
    resid[: R // 4, 0] = math.inf
    if k_det > 1:
        resid[1::3, 1] = resid[1::3, 0]                  # exact ties
    rates[::5] = 0.0                                     # all-zero rows
    resid[::7] = math.inf                                # no timer at all
    u = torch.rand((R, 8), generator=gen, device="cuda").clamp_min(1e-12)
    return rates, resid, u[:, 0], u[:, 1]


def compare_race(R: int, k_exp: int, k_det: int):
    """Kernel against plain version: (event mismatches, dt max rel err,
    dt max abs err); raises if the infinities disagree."""
    import torch
    from repro_torch.kernels import des_step, ref
    args = race_inputs(R, k_exp, k_det, seed=R * 131 + k_exp)
    dt_k, ev_k = des_step.event_race_cuda(*args)
    dt_r, ev_r = ref.event_race_ref(*args)
    torch.cuda.synchronize()
    if ev_k.dtype != torch.int32 or dt_k.dtype != torch.float32:
        fail(f"kernel output dtypes {dt_k.dtype}, {ev_k.dtype}")
    mism = int((ev_k != ev_r).sum())
    fin = torch.isfinite(dt_r)
    if not torch.equal(fin, torch.isfinite(dt_k)):
        fail(f"kernel and plain version disagree on +inf dt at {R}x"
             f"{k_exp}x{k_det}")
    diff = (dt_k[fin] - dt_r[fin]).abs()
    rel = float((diff / dt_r[fin].abs().clamp_min(1e-30)).max()) \
        if bool(fin.any()) else 0.0
    return mism, rel, float(diff.max()) if bool(fin.any()) else 0.0


def capture_final_states(vectorized):
    """Wrap the engine's chunk loop to keep each batch's final state (for
    conservation and per-replica A/B checks).  Returns (list, restore)."""
    states = []
    orig = vectorized._chunk_loop

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        states.append(out)
        return out

    vectorized._chunk_loop = wrapped

    def restore():
        vectorized._chunk_loop = orig
    return states, restore


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import (MINUTES_PER_DAY, OneWaySweep, Params,
                                  analytical, run_replications,
                                  run_replications_batch, vectorized)
    from repro_torch.kernels import des_step, ref

    # ---- phase 1: card and build ------------------------------------------
    phase("phase 1: card and kernel build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    lib = des_step.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {des_step.BUILD_SECONDS:.2f} s) -> "
          f"{os.path.relpath(lib, ROOT)}")
    if des_step.BUILD_LOG.strip():
        print(des_step.BUILD_LOG.strip())

    # ---- phase 2: kernel against plain version ----------------------------
    phase("phase 2: event_race kernel vs plain PyTorch version")
    B_main = len(SWEEP_VALUES) * N_REPLICAS
    shapes = [(B_main, 16, 3), (130, 9, 5), (96, 23, 7), (8, 1, 1)]
    main_err = None
    for R, ke, kd in shapes:
        mism, rel, abs_err = compare_race(R, ke, kd)
        print(f"  {R}x{ke}x{kd}: event mismatches {mism}, dt max rel err "
              f"{rel:.3e}, max abs err {abs_err:.3e}")
        if mism or rel > 1e-6:
            fail(f"kernel disagrees with event_race_ref at {R}x{ke}x{kd} "
                 f"(mismatches {mism}, dt rel err {rel:.3e} > 1e-6)")
        if main_err is None:
            main_err = (mism, rel, abs_err)
    args = race_inputs(B_main, 16, 3, seed=7)
    launches_before = des_step.LAUNCHES
    k_ms = event_ms(lambda: des_step.event_race_cuda(*args), 2000)
    r_ms = event_ms(lambda: ref.event_race_ref(*args), 500)
    k_dev = device_ms(lambda: des_step.event_race_cuda(*args), 200)
    r_dev = device_ms(lambda: ref.event_race_ref(*args), 100)
    des_step.LAUNCHES = launches_before
    row_bytes = (16 + 3 + 2) * 4 + 4 + 4      # inputs read once + outputs
    row_ops = 4 * 16 + 3 + 4                  # sum, cumsum, divide, compare
    bytes_ms = B_main * row_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = B_main * row_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  {B_main}x16x3 per call, CUDA events over back-to-back calls "
          f"(host dispatch included): kernel {k_ms:.6f} ms, plain "
          f"{r_ms:.6f} ms")
    print(f"  device time per call (torch.profiler): kernel {k_dev} ms, "
          f"plain {r_dev} ms; bound {bound_ms:.6f} ms ({bound_by})")

    # ---- phase 3: the main path -------------------------------------------
    phase(f"phase 3: OneWaySweep warm_standbys={SWEEP_VALUES}, "
          f"{N_REPLICAS} replicas, Table-I width, job_length cut from 64 "
          f"to {JOB_DAYS} days")
    base = Params(job_length=JOB_DAYS * MINUTES_PER_DAY)
    sweep = OneWaySweep("warm standbys", "warm_standbys", SWEEP_VALUES,
                        n_replications=N_REPLICAS, base_params=base,
                        device="cuda")
    states, restore = capture_final_states(vectorized)
    try:
        des_step.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = des_step.LAUNCHES
    finally:
        restore()
    if launches <= 0:
        fail("the main path launched the event-race kernel no time")
    if len(states) != 1:
        fail(f"expected one batch for the sweep, got {len(states)}")
    final = states[0]
    n_events = 0.0
    for j, (v, pt) in enumerate(zip(SWEEP_VALUES, res.points)):
        st = pt.stats
        if st["completed"].mean != 1.0:
            fail(f"warm_standbys={v}: only {st['completed'].mean:.4f} of "
                 "replicas completed")
        for name, stat in st.items():
            if not math.isfinite(stat.mean):
                fail(f"warm_standbys={v}: metric {name} is not finite")
        rows = slice(j * N_REPLICAS, (j + 1) * N_REPLICAS)
        total = sum(final[k][rows].sum(-1) for k in
                    ("run", "sb", "fw", "fs", "auto", "man"))
        want = base.working_pool_size + base.spare_pool_size
        if not bool((total == want).all()):
            fail(f"warm_standbys={v}: servers not conserved "
                 f"({float(total.min())}..{float(total.max())} != {want})")
        # per replica: a failure and its timer expiry, each repair
        # completion, and the job's completion
        n_events += float((2 * final["n_failures"][rows]
                           + final["n_auto_repairs"][rows]
                           + final["n_manual_repairs"][rows] + 1).sum())
        print(f"  warm_standbys={v}: total_time {st['total_time'].mean:.1f} "
              f"min, n_failures {st['n_failures'].mean:.2f}, stall_time "
              f"{st['stall_time'].mean:.2f}, goodput "
              f"{st['goodput'].mean:.5f}, recovery_p99 "
              f"{st['recovery_dist'].percentiles[99]:.2f}")
    print(f"  wall {wall:.3f} s, {launches} scan steps ({launches / wall:.1f} "
          f"steps/s), {n_events:.0f} replica-events "
          f"({n_events / wall:.1f} replica-events/s), event_race launches "
          f"{launches}")

    # ---- phase 3b: closed-form points at the same width --------------------
    calm = base.replace(random_failure_rate=0.0, systematic_failure_rate=0.0)
    rep = run_replications(calm, N_REPLICAS, device="cuda")
    want = calm.host_selection_time + calm.job_length
    tt = rep.arrays["total_time"]
    if not (abs(tt - want) <= 1e-5 * want).all() \
            or rep.arrays["n_failures"].sum() != 0:
        fail(f"failure-free point: total_time {tt.min()}..{tt.max()} != "
             f"{want}")
    print(f"  failure-free: total_time == host_selection + job_length = "
          f"{want} for all {N_REPLICAS} replicas")
    no_heal = base.replace(auto_repair_failure_probability=1.0,
                           manual_repair_failure_probability=1.0)
    rep = run_replications(no_heal, N_REPLICAS, device="cuda")
    got = rep.stats["n_failures"].mean
    exp = analytical.expected_failures(no_heal)
    print(f"  repairs never heal: mean n_failures {got:.2f}, closed form "
          f"{exp:.2f} ({(got / exp - 1) * 100:+.2f}%)")
    if abs(got / exp - 1.0) > 0.15 or rep.stats["completed"].mean != 1.0:
        fail("never-healing point is outside 15% of the closed form")

    # ---- phase 4: A/B against the plain event race --------------------------
    phase("phase 4: the same sweep with event_race_impl='ref'")
    sweep_ref = OneWaySweep("warm standbys", "warm_standbys", SWEEP_VALUES,
                            n_replications=N_REPLICAS,
                            base_params=base.replace(event_race_impl="ref"),
                            device="cuda")
    states_ref, restore = capture_final_states(vectorized)
    try:
        launches_before = des_step.LAUNCHES
        t0 = time.perf_counter()
        res_ref = sweep_ref.run()
        torch.cuda.synchronize()
        wall_ref = time.perf_counter() - t0
    finally:
        restore()
    if des_step.LAUNCHES != launches_before:
        fail("impl='ref' launched the CUDA kernel")
    final_ref = states_ref[0]
    int_metrics = ("n_failures", "n_random_failures",
                   "n_systematic_failures", "n_preemptions",
                   "n_auto_repairs", "n_manual_repairs", "n_failed_repairs",
                   "n_host_selections", "n_standby_swaps", "n_undiagnosed",
                   "n_misdiagnosed")
    same = torch.ones_like(final["n_failures"], dtype=torch.bool)
    for m in int_metrics:
        same &= final[m] == final_ref[m]
    frac = float(same.float().mean())
    print(f"  wall {wall_ref:.3f} s; replicas with identical integer "
          f"metrics: {frac * 100:.3f}%")
    if frac < 0.99:
        fail(f"only {frac:.4f} of replicas agree with the plain race")
    worst = 0.0
    for pt, pt_ref in zip(res.points, res_ref.points):
        for m in ("total_time", "n_failures", "stall_time", "goodput",
                  "n_preemptions", "recovery_overhead"):
            a, b = pt.stats[m], pt_ref.stats[m]
            se = math.sqrt((a.std ** 2 + b.std ** 2) / N_REPLICAS)
            z = abs(a.mean - b.mean) / max(se, 1e-12)
            worst = max(worst, z)
    print(f"  largest |z| of the means against the plain race: {worst:.3f}")
    if worst >= 3.5:
        fail(f"means disagree with the plain race (|z| = {worst:.3f})")

    # ---- phase 5: traced window ------------------------------------------
    phase("phase 5: traced window of the main path (two chunks)")
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # cut on purpose
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_replications_batch(
                [base.replace(warm_standbys=v) for v in SWEEP_VALUES],
                N_REPLICAS, max_steps=2 * vectorized.DEFAULT_CHUNK_STEPS,
                device="cuda")
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_s = device_seconds(prof)
    n_kernels = sum(e.count for e in events
                    if str(e.device_type).endswith("CUDA"))
    steps = 2 * vectorized.DEFAULT_CHUNK_STEPS
    print(f"  traced wall {traced_wall:.3f} s for {steps} steps "
          f"({traced_wall / steps * 1e3:.3f} ms/step traced, "
          f"{wall / launches * 1e3:.3f} ms/step untraced in phase 3); "
          f"device busy {dev_s:.4f} s = "
          f"{dev_s / traced_wall * 100:.2f}% of the traced wall; "
          f"{n_kernels / steps:.1f} device kernels a step")
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in top:
        print(f"    host {e.key}: {e.count} calls, self "
              f"{e.self_cpu_time_total / 1e3:.1f} ms")

    mism, rel, abs_err = main_err
    record = {"name": "event_race", "route": "cuda", "source": KERNEL_SOURCE,
              "replaces": TPU_KERNEL,
              "replaces_function": "src/repro/kernels/des_step.py:"
                                   "_event_race_kernel",
              "launches": launches, "max_abs_err": abs_err,
              "event_mismatches": mism, "dt_max_rel_err": rel,
              "ms": k_ms if k_dev is None else k_dev,
              "plain_ms": r_ms if r_dev is None else r_dev,
              "call_ms": k_ms, "plain_call_ms": r_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
