"""What-if scenario analysis (paper §II-C / §III) on the PyTorch/CUDA port.

The questions the paper poses verbatim:
  * "how much does availability improve if we reduce the recovery time
    after a failure by 50%?"
  * "when the same server fails repeatedly, after how many failures
    should we remove it from the cluster for ever?"
  * "what if failure rates increase and whether current policies will
    still be effective?"

    PYTHONPATH=src python examples/torch_whatif_scenarios.py [--fast] \
        [--device cpu]

The same tour as ``examples/whatif_scenarios.py``, through ``repro_torch``:
CTMC studies run on ``--device`` (default: the card), retirement studies
on the event engine on the host.
"""

import argparse

from repro_torch.core import (MINUTES_PER_DAY, Params, resolve_engine,
                              run_replications)
from repro_torch.core.vectorized import supports

parser = argparse.ArgumentParser()
parser.add_argument("--fast", action="store_true")
parser.add_argument("--engine", choices=("auto", "event", "ctmc"),
                    default="auto")
parser.add_argument("--device", default=None,
                    help="device of the CTMC engine (default: the card)")
args = parser.parse_args()
N = 96 if args.fast else 384

BASE = Params(job_size=1024, working_pool_size=1056, spare_pool_size=128,
              warm_standbys=16, job_length=16 * MINUTES_PER_DAY,
              random_failure_rate=0.02 / MINUTES_PER_DAY,
              systematic_failure_rate=0.10 / MINUTES_PER_DAY)


def run(p: Params, label: str) -> float:
    # a forced --engine ctmc would raise on retirement scenarios; let
    # those degrade to auto (-> event) instead of crashing the tour
    eng = "auto" if (args.engine == "ctmc" and not supports(p)) \
        else args.engine
    # replica budget follows the engine that will actually run: the
    # vectorized path gets the full count, the sequential one a slice
    n = N if resolve_engine(p, eng) == "ctmc" else max(N // 24, 8)
    rep = run_replications(p, n, engine=eng, device=args.device)
    hours = rep.stats["total_time"].mean / 60
    util = 1.0 - rep.stats["overhead_fraction"].mean
    print(f"  {label:44s} {hours:9.1f} h   utilization {util * 100:6.2f}%"
          f"   [{rep.engine}]")
    return hours


print("=== baseline ===")
base_h = run(BASE, "as configured")

print("\n=== what if recovery got 50% faster? (paper's example) ===")
fast_h = run(BASE.replace(recovery_time=BASE.recovery_time / 2),
             "recovery 20 -> 10 min")
print(f"  -> saves {base_h - fast_h:.1f} h "
      f"({(base_h - fast_h) / base_h * 100:.1f}%)")

print("\n=== what if failure rates double / quadruple? ===")
for mult in (2, 4):
    run(BASE.replace(
        random_failure_rate=BASE.random_failure_rate * mult,
        systematic_failure_rate=BASE.systematic_failure_rate * mult),
        f"{mult}x failure rates")

print("\n=== retirement policy: remove after K failures in 7 days ===")
for k in (0, 2, 3, 5):
    label = "no retirement" if k == 0 else f"retire after {k} failures"
    run(BASE.replace(retirement_threshold=k,
                     auto_repair_failure_probability=0.9,
                     manual_repair_failure_probability=0.6), label)
print("  (with poor repair efficacy, early retirement removes chronic "
      "offenders\n   before they burn more recovery cycles)")

print("\n=== distribution sensitivity (age-dependent hazards) ===")
# every family here rides the CTMC engine under engine="auto", each
# through its own instance of the chunk kernel
for dist, kwargs in (("exponential", {}),
                     ("weibull", {"k": 1.5}),
                     ("bathtub", {"infant_factor": 5.0}),
                     ("lognormal", {"sigma": 1.0})):
    p = BASE.replace(failure_distribution=dist, distribution_kwargs=kwargs,
                     job_length=4 * MINUTES_PER_DAY)
    chosen = resolve_engine(p, "auto")
    rep = run_replications(p, N if chosen == "ctmc" else 12, engine="auto",
                           device=args.device)
    st = rep.stats["total_time"]
    print(f"  {dist:14s} mean total {st.mean / 60:8.1f} h   "
          f"p99 {st.percentiles[99] / 60:8.1f} h   [{rep.engine}]")
