#!/usr/bin/env python3
"""Where the time of a replica-sharded CTMC sweep goes: one card against
two shards on ``cuda:0`` and ``cuda:1``.

    python3 scripts/torch_shard_trace.py [--replicas 1024 8192 65536]
        [--trace 1024 65536] [--out DIR] [--device cpu]

Runs ``chip_smoke.py`` phase 5's batch (the Table-I ``warm_standbys``
sweep: warm standbys 4, 8, 16 and 32, the job cut to 16 days) through
``simulate_ctmc_sweep`` unsharded and with ``shards=2``, for each
``--replicas`` count (replicas a point):

* the wall of each, warm, in the order one card, two shards, two shards,
  one card (the faster of the two runs each);
* at each ``--trace`` count (default the first), each once more under
  ``torch.profiler`` (CPU and CUDA activities), with spans around a
  shard's chunk (the draw and the launch), the kernel's wrapper, the
  early-exit read (which syncs the host with that shard's card), the
  scatter and gather of the shards' lanes, the initial state and the
  copy of the outputs to the host.  From the trace: each card's
  chunk-kernel launches, their device time and busy share of the wall;
  the time during which chunk kernels of ``cuda:0`` and ``cuda:1`` run at
  once; the host's time in each span, a shard's chunk for the first
  three and a run for the others.  The traces are written to
  ``DIR/shard_trace_{R}_{1,2}.json`` (default ``build/shard_trace``).

``--device cpu`` runs the same on the host (the shards in turn), as a dry
run of the script; it then needs no card and reports no device time.
Prints the card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_VALUES = (4, 8, 16, 32)
JOB_DAYS = 16
#: spans timed a shard's chunk, then spans timed a run
CHUNK_SPANS = ("shard_chunk", "chunk_wrapper", "early_exit_read")
RUN_SPANS = ("initial_state", "shard_scatter", "shard_gather",
             "host_outputs")


def instrument(tv, cc, record_function):
    """Wrap the sharded scan's steps in named profiler spans; returns the
    function that puts them back."""
    saved = {}

    def wrap(owner, attr, span):
        fn = getattr(owner, attr)
        saved[(owner, attr)] = fn

        def spanned(*args, **kwargs):
            with record_function(span):
                return fn(*args, **kwargs)
        setattr(owner, attr, spanned)

    chunk_fn = tv._chunk_fn

    def spanned_chunk_fn(*args, **kwargs):
        run = chunk_fn(*args, **kwargs)

        def run_chunk(state, i, n_steps):
            with record_function("shard_chunk"):
                return run(state, i, n_steps)
        return run_chunk

    saved[(tv, "_chunk_fn")] = chunk_fn
    tv._chunk_fn = spanned_chunk_fn
    wrap(cc, "ctmc_chunk_cuda", "chunk_wrapper")
    wrap(tv, "_any_active", "early_exit_read")
    wrap(tv, "_shard_state", "shard_scatter")
    wrap(tv, "_gather_shards", "shard_gather")
    wrap(tv, "_initial_state_batch", "initial_state")
    wrap(tv, "_host_outputs", "host_outputs")

    def restore():
        for (owner, attr), fn in saved.items():
            setattr(owner, attr, fn)
    return restore


def overlap_us(a, b):
    """Time during which an interval of ``a`` and one of ``b`` both run
    (each list one stream's intervals, which do not overlap each other)."""
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read_trace(path, wall_s):
    """Kernel and span times from a chrome trace of one sweep."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = {}
    spans = {s: [0, 0.0] for s in CHUNK_SPANS + RUN_SPANS}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel" and "ctmc_chunk_kernel" in e["name"]:
            dev = int(e.get("args", {}).get("device", -1))
            kernels.setdefault(dev, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif e.get("cat") == "user_annotation" and e["name"] in spans:
            spans[e["name"]][0] += 1
            spans[e["name"]][1] += float(e["dur"])
    out = {"cards": {}}
    for dev, iv in sorted(kernels.items()):
        busy = sum(hi - lo for lo, hi in iv)
        out["cards"][str(dev)] = {
            "launches": len(iv), "kernel_ms": busy / 1e3,
            "busy_share": busy / 1e6 / wall_s if wall_s else None}
    devs = sorted(kernels)
    out["overlap_ms"] = (overlap_us(kernels[devs[0]], kernels[devs[1]]) / 1e3
                         if len(devs) >= 2 else None)
    n_chunks = spans["shard_chunk"][0]
    out["host_us_a_chunk"] = {
        s: (spans[s][1] / n_chunks if n_chunks else None)
        for s in CHUNK_SPANS}
    out["host_ms_a_run"] = {s: spans[s][1] / 1e3 for s in RUN_SPANS}
    out["span_counts"] = {s: n for s, (n, _) in spans.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, nargs="+", default=[1024])
    ap.add_argument("--trace", type=int, nargs="+", default=None,
                    help="replica counts to trace (default the first)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "shard_trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = args.device != "cpu"
    if on_card and torch.cuda.device_count() < 2:
        print("torch_shard_trace: needs two CUDA devices (or --device cpu)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import vectorized as tv
    from repro_torch.core.params import MINUTES_PER_DAY, Params
    from repro_torch.kernels import ctmc_chunk as cc

    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    pts = [Params(job_length=JOB_DAYS * MINUTES_PER_DAY, warm_standbys=w)
           for w in SWEEP_VALUES]

    def sync():
        if on_card:
            for d in range(2):
                torch.cuda.synchronize(d)

    def sweep(R, n):
        sync()
        t0 = time.perf_counter()
        tv.simulate_ctmc_sweep(pts, R, seed=pts[0].seed, shards=n or None,
                               device=args.device)
        sync()
        return time.perf_counter() - t0

    result = {"replicas": {}, "trace": {}}
    for R in args.replicas:
        sweep(R, 2)                  # warms both cards at this shape
        launches = cc.LAUNCHES
        sweep(R, 0)
        chunks = cc.LAUNCHES - launches if on_card else None
        walls = {0: [], 2: []}
        for n in (0, 2, 2, 0):
            walls[n].append(sweep(R, n))
        row = {"one_card_s": min(walls[0]), "two_shards_s": min(walls[2]),
               "chunks_a_run": chunks}
        row["two_over_one"] = row["two_shards_s"] / row["one_card_s"]
        result["replicas"][R] = row
        print(f"  {R} replicas a point ({len(pts) * R} rows): one card "
              f"{row['one_card_s']:.6f} s, two shards "
              f"{row['two_shards_s']:.6f} s ({row['two_over_one']:.3f}x), "
              f"{chunks} chunk launches a one-card run")

    args.out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    restore = instrument(tv, cc, record_function)
    try:
        for R in args.trace or args.replicas[:1]:
            for n in (0, 2):
                with profile(activities=activities) as prof:
                    wall = sweep(R, n)
                path = args.out / f"shard_trace_{R}_{n or 1}.json"
                prof.export_chrome_trace(str(path))
                rec = dict(read_trace(path, wall), wall_s=wall)
                result["trace"][f"{R}_{n or 1}"] = rec
                label = "two shards" if n else "one card"
                print(f"  traced {label}, {R} replicas a point: wall "
                      f"{wall:.6f} s; " + "; ".join(
                          f"cuda:{d} {c['launches']} launches, "
                          f"{c['kernel_ms']:.6f} ms kernel time, busy "
                          f"{c['busy_share']:.4f}"
                          for d, c in rec["cards"].items())
                      + f"; both cards' kernels at once {rec['overlap_ms']}"
                      " ms")
                print("    host a shard's chunk (us): " + ", ".join(
                    f"{s} {v:.1f}" if v is not None else f"{s} -"
                    for s, v in rec["host_us_a_chunk"].items())
                    + "; host a run (ms): " + ", ".join(
                        f"{s} {v:.3f}"
                        for s, v in rec["host_ms_a_run"].items())
                    + f"; spans {rec['span_counts']}")
    finally:
        restore()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
