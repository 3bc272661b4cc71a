"""Experiment harness: one-way and two-way parameter sweeps (paper §III-D).

Counterpart of ``src/repro/core/sweeps.py``.  The paper's user-facing
API:

    OneWaySweep("Systematic Failure Fraction",
                "systematic_failure_fraction", [0.1, 0.2, 0.3])

Each sweep point runs ``n_replications`` replications and aggregates the
paper's output metrics; TwoWaySweep crosses two parameter ranges, and
MultiJobSweep crosses cluster parameters under a fixed mix of jobs that
share one fleet.  Sweeps
route through :mod:`repro_torch.core.backend` (``engine=``, default
``"auto"``): every point inside the port's CTMC engine runs in one batch
on ``device=`` (default the card; ``device="cpu"`` must be asked for),
and the rest on the event engine.  Results can be dumped as CSV or JSON
with the reference's columns; a yaml or json experiment file is read by
:func:`load_experiment`.

Special virtual parameter ``systematic_failure_rate_multiplier`` sets the
systematic rate as a multiple of the (possibly swept) random rate, the way
Table I expresses it.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .backend import (MultiJobReplications, Replications,
                      run_multijob_batch, run_replications_batch)
from .metrics import RunResult, Stat
from .multijob import JobSpec
from .params import Params

#: sweep-table columns (means over replications)
DEFAULT_STATS = ("total_time", "n_failures", "n_random_failures",
                 "n_systematic_failures", "n_preemptions", "n_auto_repairs",
                 "n_manual_repairs", "n_host_selections", "stall_time",
                 "overhead_fraction", "goodput", "lost_work",
                 "checkpoint_overhead", "mean_run_duration",
                 "n_domain_shocks", "n_incomplete")


def _apply_param(params: Params, name: str, value: Any) -> Params:
    """Set a (possibly virtual) parameter on a Params copy."""
    if name == "systematic_failure_rate_multiplier":
        return params.replace(
            systematic_failure_rate=value * params.random_failure_rate)
    if name in ("rack_shock_rate", "pod_shock_rate"):
        if params.fault_domains is None:
            raise ValueError(
                f"sweeping {name!r} requires Params.fault_domains")
        return params.replace(fault_domains=dataclasses.replace(
            params.fault_domains, **{name: value}))
    if not hasattr(params, name):
        raise ValueError(f"unknown parameter {name!r}")
    # preserve int-ness of count-typed fields
    current = getattr(params, name)
    if isinstance(current, int) and not isinstance(current, bool):
        value = int(value)
    return params.replace(**{name: value})


#: percentiles written per distribution channel to sweep tables
DIST_PERCENTILES = (50, 90, 99)


@dataclass
class SweepPoint:
    values: Dict[str, Any]
    results: List[RunResult]        # per-replication results (event engine)
    stats: Dict[str, Stat]
    #: replication count (== len(results) on the event engine; the batched
    #: CTMC path aggregates arrays directly and leaves ``results`` empty)
    n: Optional[int] = None
    engine: str = "event"
    #: pooled streaming histograms per channel (when Params.histogram set)
    histograms: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_replications(self) -> int:
        return self.n if self.n is not None else len(self.results)

    def row(self, columns: Sequence[str] = DEFAULT_STATS) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.values)
        for c in columns:
            out[c] = self.stats[c].mean
        out["total_time_ci95"] = self.stats["total_time"].ci95_halfwidth(
            self.n_replications)
        # distribution percentiles from the streaming histograms, e.g.
        # run_duration_p50 / recovery_p99 — exact to one bin width of the
        # Params.histogram spec (a resolution caveat, not sampling error)
        for name, stat in self.stats.items():
            if name.endswith("_dist"):
                for q in DIST_PERCENTILES:
                    out[f"{name[:-5]}_p{q}"] = stat.percentiles.get(
                        q, float("nan"))
        return out

    @classmethod
    def of(cls, values: Dict[str, Any], rep: Replications) -> "SweepPoint":
        return cls(values, rep.results, rep.stats, n=rep.n,
                   engine=rep.engine, histograms=rep.histograms)


@dataclass
class SweepResult:
    name: str
    parameter_names: List[str]
    points: List[SweepPoint]

    def to_rows(self, columns: Sequence[str] = DEFAULT_STATS) -> List[Dict[str, Any]]:
        return [p.row(columns) for p in self.points]

    def write_csv(self, path: str, columns: Sequence[str] = DEFAULT_STATS) -> None:
        rows = self.to_rows(columns)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if rows:
            fieldnames = list(rows[0].keys())
        else:  # empty sweep: still emit a well-formed header-only file
            fieldnames = (list(self.parameter_names) + list(columns)
                          + ["total_time_ci95"])
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            writer.writerows(rows)

    def write_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({
                "name": self.name,
                "parameters": self.parameter_names,
                "rows": self.to_rows(),
            }, f, indent=2)

    def column(self, metric: str) -> List[float]:
        return [p.stats[metric].mean for p in self.points]



class OneWaySweep:
    """Vary one parameter over a list of values (paper's OneWaySweep).

    Every grid point runs ``n_replications`` replications; the points
    inside the port's CTMC engine run as one batch, with common random
    numbers across points, and the rest on the event engine.  Results come back as a :class:`SweepResult`
    whose points carry full :class:`repro_torch.core.metrics.Stat` dicts,
    pooled histograms, and CSV writers.

    >>> calm = Params(job_size=2, working_pool_size=3, spare_pool_size=1,
    ...               warm_standbys=0, job_length=10.0,
    ...               random_failure_rate=0.0, systematic_failure_rate=0.0,
    ...               histogram=None)
    >>> res = OneWaySweep("demo", "job_length", [10.0, 20.0],
    ...                   n_replications=2, base_params=calm,
    ...                   device="cpu").run()
    >>> [round(p.stats["total_time"].mean, 1) for p in res.points]
    [13.0, 23.0]
    >>> res.to_rows()[0]["job_length"]
    10.0
    """

    def __init__(self, title: str, parameter: str, values: Sequence[Any],
                 n_replications: int = 5, base_params: Optional[Params] = None,
                 base_seed: int = 0, engine: str = "auto",
                 padded: bool = True, bucketed: bool = True, device=None):
        self.title = title
        self.parameter = parameter
        self.values = list(values)
        self.n_replications = n_replications
        self.base_params = base_params or Params()
        self.base_seed = base_seed
        self.engine = engine
        self.padded = padded
        self.bucketed = bucketed
        self.device = device

    def run(self, progress: Optional[Callable[[str], None]] = None) -> SweepResult:
        grid = [_apply_param(self.base_params, self.parameter, v)
                for v in self.values]
        cb = (lambda i: progress(
            f"{self.title}: {self.parameter}={self.values[i]}")) \
            if progress else None
        reps = run_replications_batch(grid, self.n_replications,
                                      engine=self.engine,
                                      base_seed=self.base_seed, progress=cb,
                                      padded=self.padded,
                                      bucketed=self.bucketed,
                                      device=self.device)
        points = [SweepPoint.of({self.parameter: v}, rep)
                  for v, rep in zip(self.values, reps)]
        return SweepResult(self.title, [self.parameter], points)


class TwoWaySweep:
    """Cross two parameter ranges (the paper's evaluation design).

    The grid is the full cross product, points ordered with
    ``parameter_b`` varying fastest; everything else matches
    :class:`OneWaySweep`.

    >>> calm = Params(job_size=2, working_pool_size=3, spare_pool_size=1,
    ...               warm_standbys=0, job_length=10.0,
    ...               random_failure_rate=0.0, systematic_failure_rate=0.0,
    ...               histogram=None)
    >>> res = TwoWaySweep("demo", "job_length", [10.0, 20.0],
    ...                   "host_selection_time", [0.0, 5.0],
    ...                   n_replications=2, base_params=calm,
    ...                   device="cpu").run()
    >>> [(p.values["job_length"], p.values["host_selection_time"],
    ...   round(p.stats["total_time"].mean, 1)) for p in res.points]
    [(10.0, 0.0, 10.0), (10.0, 5.0, 15.0), (20.0, 0.0, 20.0), (20.0, 5.0, 25.0)]
    """

    def __init__(self, title: str, parameter_a: str, values_a: Sequence[Any],
                 parameter_b: str, values_b: Sequence[Any],
                 n_replications: int = 5, base_params: Optional[Params] = None,
                 base_seed: int = 0, engine: str = "auto",
                 padded: bool = True, bucketed: bool = True, device=None):
        self.title = title
        self.parameter_a, self.values_a = parameter_a, list(values_a)
        self.parameter_b, self.values_b = parameter_b, list(values_b)
        self.n_replications = n_replications
        self.base_params = base_params or Params()
        self.base_seed = base_seed
        self.engine = engine
        self.padded = padded
        self.bucketed = bucketed
        self.device = device

    def run(self, progress: Optional[Callable[[str], None]] = None) -> SweepResult:
        combos = [(va, vb) for va in self.values_a for vb in self.values_b]
        grid = [_apply_param(_apply_param(self.base_params,
                                          self.parameter_a, va),
                             self.parameter_b, vb)
                for va, vb in combos]
        cb = (lambda i: progress(
            f"{self.title}: {self.parameter_a}={combos[i][0]}, "
            f"{self.parameter_b}={combos[i][1]}")) if progress else None
        reps = run_replications_batch(grid, self.n_replications,
                                      engine=self.engine,
                                      base_seed=self.base_seed, progress=cb,
                                      padded=self.padded,
                                      bucketed=self.bucketed,
                                      device=self.device)
        points = [SweepPoint.of({self.parameter_a: va, self.parameter_b: vb},
                                rep)
                  for (va, vb), rep in zip(combos, reps)]
        return SweepResult(self.title,
                           [self.parameter_a, self.parameter_b], points)


#: fleet-level sweep-table columns for multi-job capacity grids
MULTIJOB_FLEET_STATS = ("makespan", "fleet_n_failures", "fleet_stall_time",
                        "n_auto_repairs", "n_manual_repairs",
                        "n_failed_repairs", "stall_handoffs",
                        "n_shop_queued", "completed")

#: per-job columns expanded to ``job{i}_{name}`` in multi-job tables
MULTIJOB_JOB_STATS = ("total_time", "n_failures", "stall_time",
                      "n_preemptions", "overhead_fraction")


def _multijob_point_stats(rep: MultiJobReplications) -> Dict[str, Stat]:
    """Flatten a MultiJobReplications into one SweepPoint stats dict.

    Fleet stats keep their names (plus a ``total_time`` alias for the
    makespan, which the generic CSV writer's ci95 column reads); per-job
    stats are prefixed ``job{i}_``.
    """
    stats: Dict[str, Stat] = dict(rep.fleet)
    stats["total_time"] = rep.fleet["makespan"]
    for i, job_rep in enumerate(rep.per_job):
        for name in MULTIJOB_JOB_STATS:
            stats[f"job{i}_{name}"] = job_rep.stats[name]
    return stats


class MultiJobSweep:
    """Capacity-planning grid over a fixed multi-job cluster.

    Crosses one or two *cluster-level* parameters (spare_pool_size,
    repair_servers, failure rates, ...) while the job mix -- sizes,
    lengths, warm-standby targets -- stays fixed.  On ``engine="auto"``
    every point inside the multi-job CTMC envelope runs in one
    ``simulate_multijob_ctmc_sweep`` call on ``device`` (default the
    card): the job count is the only structure key, so the whole grid
    (mixed job sizes included) is ONE batch.  CSV rows carry the fleet
    columns (:data:`MULTIJOB_FLEET_STATS`) plus per-job
    ``job{i}_{metric}`` columns (:data:`MULTIJOB_JOB_STATS`).

    >>> from repro_torch.core import JobSpec, MultiJobSweep, Params
    >>> calm = Params(job_size=2, working_pool_size=8, spare_pool_size=2,
    ...               warm_standbys=0, job_length=10.0,
    ...               random_failure_rate=0.0, systematic_failure_rate=0.0,
    ...               histogram=None)
    >>> jobs = [JobSpec(2, 10.0, warm_standbys=0),
    ...         JobSpec(3, 20.0, warm_standbys=0)]
    >>> sweep = MultiJobSweep("demo", jobs, "spare_pool_size", [2, 4],
    ...                       n_replications=2, base_params=calm,
    ...                       engine="event")
    >>> res = sweep.run()
    >>> [round(p.stats["makespan"].mean, 1) for p in res.points]  # +3 select
    [23.0, 23.0]
    >>> sorted(res.to_rows(sweep.columns())[0])[:3]
    ['completed', 'fleet_n_failures', 'fleet_stall_time']
    """

    def __init__(self, title: str, jobs: Sequence[JobSpec],
                 parameter: str, values: Sequence[Any],
                 parameter_b: Optional[str] = None,
                 values_b: Optional[Sequence[Any]] = None,
                 n_replications: int = 5,
                 base_params: Optional[Params] = None,
                 base_seed: int = 0, engine: str = "auto", device=None):
        self.title = title
        self.jobs = [JobSpec(j.job_size, j.job_length, j.warm_standbys,
                             j.start_time) if not isinstance(j, JobSpec)
                     else j for j in jobs]
        self.parameter, self.values = parameter, list(values)
        self.parameter_b = parameter_b
        self.values_b = list(values_b) if values_b is not None else None
        self.n_replications = n_replications
        self.base_params = base_params or Params()
        self.base_seed = base_seed
        self.engine = engine
        self.device = device

    def columns(self) -> List[str]:
        """Default CSV column list for this grid's job count."""
        return list(MULTIJOB_FLEET_STATS) + [
            f"job{i}_{name}" for i in range(len(self.jobs))
            for name in MULTIJOB_JOB_STATS]

    def _combos(self) -> List[Dict[str, Any]]:
        if self.parameter_b is None:
            return [{self.parameter: v} for v in self.values]
        return [{self.parameter: va, self.parameter_b: vb}
                for va in self.values for vb in self.values_b]

    def run(self, progress: Optional[Callable[[str], None]] = None,
            ) -> SweepResult:
        combos = self._combos()
        grid = []
        for values in combos:
            p = self.base_params
            for name, v in values.items():
                p = _apply_param(p, name, v)
            grid.append((p, tuple(self.jobs)))
        if progress:
            progress(f"{self.title}: {len(grid)} points x "
                     f"{len(self.jobs)} jobs")
        reps = run_multijob_batch(grid, self.n_replications,
                                  engine=self.engine,
                                  base_seed=self.base_seed,
                                  device=self.device)
        points = [SweepPoint(values, [], _multijob_point_stats(rep),
                             n=rep.n, engine=rep.engine,
                             histograms=rep.histograms)
                  for values, rep in zip(combos, reps)]
        names = [self.parameter] + ([self.parameter_b]
                                    if self.parameter_b else [])
        return SweepResult(self.title, names, points)


def load_experiment(path: str, engine: Optional[str] = None,
                    device=None) -> List[Any]:
    """Build sweeps from a yaml/json experiment file.

    Schema::

        base_params: {recovery_time: 20, ...}
        n_replications: 5
        engine: auto          # optional: auto | event | ctmc
        sweeps:
          - {title: ..., parameter: ..., values: [...]}                    # one-way
          - {title: ..., parameter_a: ..., values_a: [...],
             parameter_b: ..., values_b: [...]}                            # two-way

    ``engine`` (argument or file key; the argument wins) selects the
    execution engine for every sweep, routed as
    :func:`repro_torch.core.backend.resolve_engine` routes it.  CTMC
    points run on ``device`` (default the card).  A ``.yaml`` / ``.yml``
    file needs PyYAML, imported only for such a file; any other file is
    read as json.
    """
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml
            spec = yaml.safe_load(f)
        else:
            spec = json.load(f)
    base = Params.from_dict(spec.get("base_params", {})) \
        if spec.get("base_params") else Params()
    n_rep = int(spec.get("n_replications", 5))
    eng = engine or spec.get("engine", "auto")
    sweeps: List[Any] = []
    for s in spec.get("sweeps", []):
        if "parameter" in s:
            sweeps.append(OneWaySweep(s.get("title", s["parameter"]),
                                      s["parameter"], s["values"],
                                      n_replications=n_rep, base_params=base,
                                      engine=eng, device=device))
        else:
            sweeps.append(TwoWaySweep(s.get("title", "two-way"),
                                      s["parameter_a"], s["values_a"],
                                      s["parameter_b"], s["values_b"],
                                      n_replications=n_rep, base_params=base,
                                      engine=eng, device=device))
    return sweeps
