#!/usr/bin/env python
"""Write the JAX package's paper tables as the yardstick of the port's.

Runs the reference's Fig. 2a, Fig. 2b and Table-I sensitivity grids
(``benchmarks/paper_tables.py``: 4096 servers, 32 days, seed 0; 256
replicas a point for the figures, 128 for the sensitivity grid) through
``repro.core.vectorized.simulate_ctmc_sweep`` on the CPU, one call a
sweep, and writes one JSON row a point: the grid's defining fields
(table, param, value, pool, replicas, days, seed) and the mean, std
(numpy's default ddof 0) and count of total time (minutes), failures and
preemptions.  ``chip_smoke.py`` phase 24 holds the port's tables on the
card to these rows (the card's machine has no JAX), and
``tests/test_torch_paper_tables.py`` checks that the file's grid is the
one the port builds.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_paper_reference.py \\
        [-o tests/data/torch_paper_reference.json]

Takes a few minutes on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.core import MINUTES_PER_DAY, Params  # noqa: E402
from repro.core.params import PAPER_TABLE1_RANGES  # noqa: E402
from repro.core.vectorized import simulate_ctmc_sweep  # noqa: E402

DEFAULT_OUT = Path(__file__).resolve().parent.parent / "tests" / "data" / \
    "torch_paper_reference.json"
#: benchmarks/paper_tables.py:34-36, 135-141, 144-145
POOL_SIZES = [4112, 4128, 4160, 4192]
JOB_DAYS = 32
N_REPLICAS = 256
SENSITIVITY_REPLICAS = 128
SENSITIVITY_POOLS = (4112, 4160)
SENSITIVITY_PARAMS = [
    "random_failure_rate", "systematic_failure_rate_multiplier",
    "systematic_failure_fraction", "warm_standbys", "host_selection_time",
    "automated_repair_probability", "auto_repair_failure_probability",
    "manual_repair_failure_probability", "auto_repair_time",
    "manual_repair_time", "spare_pool_size", "diagnosis_probability",
]
SEED = 0
METRICS = ("total_time", "n_failures", "n_preemptions")


def paper_params(**kw) -> Params:
    """benchmarks/paper_tables.py:39-42."""
    base = dict(job_length=JOB_DAYS * MINUTES_PER_DAY)
    base.update(kw)
    return Params(**base)


def grid(param, values, pools):
    """benchmarks/paper_tables.py:58-70: (value, pool, Params), values
    outermost."""
    out = []
    for v in values:
        for pool in pools:
            if param == "systematic_failure_rate_multiplier":
                p = paper_params(working_pool_size=pool)
                p = p.replace(systematic_failure_rate=v * p.random_failure_rate)
            else:
                p = paper_params(working_pool_size=pool, **{param: v})
            out.append((v, pool, p))
    return out


def tables():
    """(table, param, values, pools, replicas) of every sweep that fig2a,
    fig2b and sensitivity run, in their order."""
    yield ("fig2a", "recovery_time", PAPER_TABLE1_RANGES["recovery_time"],
           POOL_SIZES, N_REPLICAS)
    yield ("fig2b", "waiting_time", PAPER_TABLE1_RANGES["waiting_time"],
           POOL_SIZES, N_REPLICAS)
    for param in SENSITIVITY_PARAMS:
        yield ("sensitivity", param, PAPER_TABLE1_RANGES[param],
               SENSITIVITY_POOLS, SENSITIVITY_REPLICAS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    rows = []
    t_all = time.perf_counter()
    for table, param, values, pools, n in tables():
        t0 = time.perf_counter()
        pts = grid(param, values, pools)
        outs = simulate_ctmc_sweep([p for _, _, p in pts], n_replicas=n,
                                   seed=SEED)
        for (v, pool, _), out in zip(pts, outs):
            row = {"table": table, "param": param, "value": v, "pool": pool,
                   "replicas": n, "days": JOB_DAYS, "seed": SEED}
            for m in METRICS:
                a = out[m].astype("float64")
                row[m] = {"mean": float(a.mean()), "std": float(a.std()),
                          "n": int(a.size)}
            rows.append(row)
        print(f"{table} {param}: {len(pts)} points, "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    blob = {"source": "repro.core.vectorized.simulate_ctmc_sweep (JAX, CPU)",
            "script": "scripts/torch_paper_reference.py",
            "rows": rows}
    Path(args.out).write_text(json.dumps(blob, indent=1) + "\n")
    print(f"wrote {args.out}: {len(rows)} rows in "
          f"{time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
