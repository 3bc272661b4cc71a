#!/usr/bin/env python3
"""Time the chunk kernel of this checkout against another checkout's, in
turns, on the card.

    python3 scripts/torch_chunk_ab.py --other DIR [--rounds 5]

Builds ``src/repro_torch/csrc/ctmc_chunk.cu`` of both checkouts with the
flags of ``kernels/ctmc_chunk.py``'s float32 library, then times one
launch of each on ``chip_smoke.py`` phase 5's first chunk (the Table-I
``warm_standbys`` sweep: 4 points x 1,024 replicas, 64 steps, the
exponential instance) and on the chunk after 20 chunks: the kernel's
device time a launch from ``torch.profiler`` over 20 launches (the
wrapper's clones and the host excluded), in the order other, this, this,
other, ``--rounds`` times.  Both launches must give the same state bit
for bit.  Prints each turn's time in microseconds a launch and the
medians.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_chunk_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import vectorized as tv
    from repro_torch.core.params import MINUTES_PER_DAY, Params
    from repro_torch.kernels import _build, ctmc_chunk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    other = _build.CudaLibrary(
        "ctmc_chunk", ctmc_chunk._bind,
        extra_flags=ctmc_chunk.LIBRARY.flags[len(_build.NVCC_FLAGS):])
    other.source = (args.other.resolve() / "src" / "repro_torch" / "csrc"
                    / "ctmc_chunk.cu")
    other.name = "ctmc_chunk_other"
    libs = {"other": other, "this": ctmc_chunk.LIBRARY}
    for lib in libs.values():
        lib.build()

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
    cases = {"first": (first, draw(0)), "after 20 chunks": (mid, draw(20))}

    def launch(tag, state, us):
        ctmc_chunk.LIBRARY = libs[tag]
        return ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels)

    def time_us(tag, state, us, iters=20):
        from torch.profiler import ProfilerActivity, profile
        for _ in range(3):
            launch(tag, state, us)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                launch(tag, state, us)
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()
                   if "ctmc_chunk_kernel" in e.key) / iters

    try:
        for label, (state, us) in cases.items():
            a, b = launch("other", state, us), launch("this", state, us)
            torch.cuda.synchronize()
            same = all(torch.equal(a[k], b[k]) for k in a)
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for tag in ("other", "this", "this", "other"):
                    times[tag].append(time_us(tag, state, us))
            print(f"{label}: same state {same}; kernel us a launch, other "
                  + " ".join(f"{t:.3f}" for t in times["other"]) + "; this "
                  + " ".join(f"{t:.3f}" for t in times["this"]))
            print(f"{label}: medians other "
                  f"{statistics.median(times['other']):.3f}, this "
                  f"{statistics.median(times['this']):.3f}")
            if not same:
                return 1
    finally:
        ctmc_chunk.LIBRARY = libs["this"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
