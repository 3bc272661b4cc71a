"""Reproductions of the paper's evaluation (§IV, Table I, Fig. 2a/2b).

Counterpart of ``benchmarks/paper_tables.py``, with its names, grids,
sizes, seed and statistics.  The paper's design: two-way sweeps of each
Table-I knob against the working-pool size {4112, 4128, 4160, 4192} for a
4096-server job with 16 warm standbys, measuring total training time
(lower = better).  Each sweep is one
:func:`repro_torch.core.vectorized.simulate_ctmc_sweep` call over the
whole values x pools grid at seed 0, on ``device=`` (default the card;
``device="cpu"`` must be asked for, and runs the plain step loop).  Job
length is 32 days, as in the reference.

Tables are written under ``results_dir`` (default ``results/torch``), so
a run of the port never overwrites the reference's ``results/*.csv``.

    python -m repro_torch.studies.paper_tables [--device cpu] [--fast]

prints one ``name,us_per_call,derived`` row a table, as the reference's
``benchmarks/run.py`` does for its paper rows.

Expected qualitative results (asserted on the card by
tests/test_torch_paper_claims.py and chip_smoke.py):
  * training time increases with recovery time (Fig 2a);
  * training time increases with spare-pool waiting time, most at the
    smallest working pool (Fig 2b);
  * +32 servers over minimum suffice — larger pools give ~no further gain;
  * the other knobs are ~flat in this over-provisioned regime.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import Dict, List, Sequence

import numpy as np

from ..core.params import MINUTES_PER_DAY, PAPER_TABLE1_RANGES, Params
from ..core.vectorized import simulate_ctmc_sweep

#: the port's own results folder, beside the reference's ``results/``
RESULTS_DIR = os.path.join("results", "torch")
POOL_SIZES = list(PAPER_TABLE1_RANGES["working_pool_size"])
JOB_DAYS = 32
N_REPLICAS = 256


def paper_params(**kw) -> Params:
    base = dict(job_length=JOB_DAYS * MINUTES_PER_DAY)
    base.update(kw)
    return Params(**base)


def _cell_stats(out: Dict[str, np.ndarray], n_replicas: int) -> Dict[str, float]:
    return {
        "total_time_hours": float(out["total_time"].mean()) / 60.0,
        "total_time_ci95_hours": float(
            1.96 * out["total_time"].std() / np.sqrt(n_replicas)) / 60.0,
        "n_failures": float(out["n_failures"].mean()),
        "n_preemptions": float(out["n_preemptions"].mean()),
        "stall_hours": float(out["stall_time"].mean()) / 60.0,
        "overhead_fraction": float(
            1.0 - out["useful_work"].mean() / out["total_time"].mean()),
    }


def two_way_grid(param: str, values: Sequence[float],
                 pools: Sequence[int] = POOL_SIZES) -> List[tuple]:
    """The sweep's (value, pool, Params) points, values outermost."""
    grid = []
    for v in values:
        for pool in pools:
            if param == "systematic_failure_rate_multiplier":
                p = paper_params(working_pool_size=pool)
                p = p.replace(systematic_failure_rate=v * p.random_failure_rate)
            else:
                p = paper_params(working_pool_size=pool, **{param: v})
            grid.append((v, pool, p))
    return grid


def two_way_sweep(param: str, values: Sequence[float],
                  pools: Sequence[int] = POOL_SIZES,
                  n_replicas: int = N_REPLICAS, device=None) -> List[Dict]:
    grid = two_way_grid(param, values, pools)
    # one batched call: with structure padding the whole values x pools
    # cross grid -- pool size is a structural knob -- runs as one batch
    outs = simulate_ctmc_sweep([p for _, _, p in grid], n_replicas=n_replicas,
                               seed=0, device=device)
    return [{param: v, "working_pool_size": pool, **_cell_stats(out, n_replicas)}
            for (v, pool, _), out in zip(grid, outs)]


def _write_csv(rows: List[Dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def _plot(rows: List[Dict], param: str, path: str, title: str) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig, ax = plt.subplots(figsize=(7, 4))
    pools = sorted({r["working_pool_size"] for r in rows})
    for pool in pools:
        sub = [r for r in rows if r["working_pool_size"] == pool]
        xs = [r[param] for r in sub]
        ys = [r["total_time_hours"] for r in sub]
        es = [r["total_time_ci95_hours"] for r in sub]
        ax.errorbar(xs, ys, yerr=es, marker="o", label=f"pool={pool}")
    ax.set_xlabel(param)
    ax.set_ylabel("total training time (hours)")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def fig2a(n_replicas: int = N_REPLICAS, device=None,
          results_dir: str = RESULTS_DIR) -> List[Dict]:
    """Training time vs recovery time x pool size (paper Fig 2a)."""
    rows = two_way_sweep("recovery_time",
                         PAPER_TABLE1_RANGES["recovery_time"],
                         n_replicas=n_replicas, device=device)
    _write_csv(rows, f"{results_dir}/fig2a_recovery_time.csv")
    _plot(rows, "recovery_time", f"{results_dir}/fig2a_recovery_time.png",
          "Fig 2a: total training time vs recovery time")
    return rows


def fig2b(n_replicas: int = N_REPLICAS, device=None,
          results_dir: str = RESULTS_DIR) -> List[Dict]:
    """Training time vs spare-pool waiting time x pool size (Fig 2b)."""
    rows = two_way_sweep("waiting_time",
                         PAPER_TABLE1_RANGES["waiting_time"],
                         n_replicas=n_replicas, device=device)
    _write_csv(rows, f"{results_dir}/fig2b_waiting_time.csv")
    _plot(rows, "waiting_time", f"{results_dir}/fig2b_waiting_time.png",
          "Fig 2b: total training time vs spare-pool waiting time")
    return rows


#: the "all other knobs" of Table I (the paper's flat-sensitivity finding)
SENSITIVITY_PARAMS = [
    "random_failure_rate", "systematic_failure_rate_multiplier",
    "systematic_failure_fraction", "warm_standbys", "host_selection_time",
    "automated_repair_probability", "auto_repair_failure_probability",
    "manual_repair_failure_probability", "auto_repair_time",
    "manual_repair_time", "spare_pool_size", "diagnosis_probability",
]


def sensitivity(n_replicas: int = 128,
                pools: Sequence[int] = (4112, 4160), device=None,
                results_dir: str = RESULTS_DIR) -> List[Dict]:
    """Table-I grid: every remaining knob x pool size; effect sizes."""
    all_rows: List[Dict] = []
    for param in SENSITIVITY_PARAMS:
        rows = two_way_sweep(param, PAPER_TABLE1_RANGES[param], pools,
                             n_replicas, device=device)
        for r in rows:
            r["parameter"] = param
            r["value"] = r.pop(param)
        all_rows.extend(rows)
    _write_csv(all_rows, f"{results_dir}/table1_sensitivity.csv")
    return all_rows


def effect_sizes(rows: List[Dict]) -> Dict[str, float]:
    """Relative spread of training time per parameter (max-min)/min."""
    out: Dict[str, float] = {}
    for param in {r["parameter"] for r in rows}:
        ts = [r["total_time_hours"] for r in rows if r["parameter"] == param]
        out[param] = (max(ts) - min(ts)) / min(ts)
    return out


def _row(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="run device (default the card; 'cpu' runs the "
                         "plain step loop)")
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help=f"where the tables go (default {RESULTS_DIR})")
    ap.add_argument("--fast", action="store_true",
                    help="fewer replicas (64 a point, 32 in the "
                         "sensitivity grid), as REPRO_BENCH_FAST=1")
    args = ap.parse_args(argv)
    n_rep = 64 if args.fast else N_REPLICAS
    kw = dict(device=args.device, results_dir=args.results_dir)

    t0 = time.perf_counter()
    rows = fig2a(n_replicas=n_rep, **kw)
    base = min(r["total_time_hours"] for r in rows)
    worst = max(r["total_time_hours"] for r in rows)
    _row("fig2a_recovery_time", (time.perf_counter() - t0) * 1e6,
         f"train_hours {base:.1f}..{worst:.1f} over recovery 10..30min")

    t0 = time.perf_counter()
    rows = fig2b(n_replicas=n_rep, **kw)
    base = min(r["total_time_hours"] for r in rows)
    worst = max(r["total_time_hours"] for r in rows)
    _row("fig2b_waiting_time", (time.perf_counter() - t0) * 1e6,
         f"train_hours {base:.1f}..{worst:.1f} over waiting 10..30min")

    t0 = time.perf_counter()
    rows = sensitivity(n_replicas=32 if args.fast else 128, **kw)
    effects = effect_sizes(rows)
    flat = sum(1 for v in effects.values() if v < 0.05)
    _row("table1_sensitivity", (time.perf_counter() - t0) * 1e6,
         f"{flat}/{len(effects)} knobs flat (<5% effect); "
         f"max effect {max(effects.values()):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
