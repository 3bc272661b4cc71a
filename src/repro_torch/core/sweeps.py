"""Experiment harness: one-way and two-way parameter sweeps (paper §III-D).

Counterpart of ``src/repro/core/sweeps.py`` (its single-job sweeps).  The
paper's user-facing API:

    OneWaySweep("Systematic Failure Fraction",
                "systematic_failure_fraction", [0.1, 0.2, 0.3])

Each sweep point runs ``n_replications`` replications and aggregates the
paper's output metrics; TwoWaySweep crosses two parameter ranges.  Sweeps
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

from .backend import Replications, run_replications_batch
from .metrics import RunResult, Stat
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
