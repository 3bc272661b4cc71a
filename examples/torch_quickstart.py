"""Quickstart on the PyTorch/CUDA port: simulate a cluster, read the
outputs, run a sweep.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The same study as ``examples/quickstart.py``, through ``repro_torch``.
The event engine runs on the host; the sweep runs on the CTMC engine on
``--device`` (default: the card).
"""

import argparse

from repro_torch.core import (MINUTES_PER_DAY, OneWaySweep, Params, aggregate,
                              simulate)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default=None,
                    help="device of the CTMC engine (default: the card)")
args = parser.parse_args()

# ---------------------------------------------------------------------------
# 1. one configuration, a few replications
# ---------------------------------------------------------------------------
params = Params(
    job_size=1024,                    # servers the job needs
    working_pool_size=1060,           # powered-on pool (36 spare-ish)
    spare_pool_size=64,               # preemptible pool
    warm_standbys=8,
    job_length=8 * MINUTES_PER_DAY,   # useful compute
    random_failure_rate=0.01 / MINUTES_PER_DAY,
    systematic_failure_rate=0.05 / MINUTES_PER_DAY,
    systematic_failure_fraction=0.15,
    recovery_time=20.0,               # minutes per restart
)

results = simulate(params, n_replications=5)
stats = aggregate(results)
print("=== single configuration (5 replications) ===")
print(f"total time      : {stats['total_time'].mean / 60:8.1f} h "
      f"(median {stats['total_time'].median / 60:.1f}, "
      f"p99 {stats['total_time'].percentiles[99] / 60:.1f})")
print(f"failures        : {stats['n_failures'].mean:8.1f} "
      f"(random {stats['n_random_failures'].mean:.1f} / "
      f"systematic {stats['n_systematic_failures'].mean:.1f})")
print(f"repairs         : auto {stats['n_auto_repairs'].mean:.1f}, "
      f"manual {stats['n_manual_repairs'].mean:.1f}")
print(f"preemptions     : {stats['n_preemptions'].mean:8.1f}")
print(f"overhead        : {stats['overhead_fraction'].mean * 100:8.2f} %")

# ---------------------------------------------------------------------------
# 2. a one-way sweep (the paper's §III-D API) under a bathtub hazard
# ---------------------------------------------------------------------------
# age-dependent failures (infant mortality + wear-out) are one Params
# switch, and engine="auto" still takes the CTMC engine: the whole sweep
# is one batch through the bathtub instance of the chunk kernel
bathtub = params.replace(
    failure_distribution="bathtub",
    distribution_kwargs={"infant_factor": 5.0,
                         "infant_tau": 7 * MINUTES_PER_DAY})
sweep = OneWaySweep("Systematic Failure Fraction (bathtub hazard)",
                    "systematic_failure_fraction", [0.1, 0.15, 0.2, 0.3],
                    n_replications=3, base_params=bathtub, engine="auto",
                    device=args.device)
result = sweep.run()
print("\n=== one-way sweep: systematic failure fraction, bathtub hazard ===")
for point, row in zip(result.points, result.to_rows()):
    print(f"  fraction={row['systematic_failure_fraction']:<5} "
          f"total={row['total_time'] / 60:7.1f} h  "
          f"failures={row['n_failures']:6.1f}  "
          f"(ci95 +-{row['total_time_ci95'] / 60:.1f} h)  "
          f"[{point.engine}]")
result.write_csv("results/torch_quickstart_sweep.csv")
print("wrote results/torch_quickstart_sweep.csv")
