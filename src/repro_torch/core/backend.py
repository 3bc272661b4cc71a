"""Engine dispatch: route replication studies to the right simulator.

Counterpart of ``src/repro/core/backend.py``.  The port has the
reference's two engines, each for one job and for several jobs sharing a
fleet:

  * ``event`` — the generator-coroutine DES
    (:mod:`repro_torch.core.simulation`, :mod:`repro_torch.core.multijob`),
    host code in pure Python and numpy, bit-identical to the reference's
    for the same Params and seed.
  * ``ctmc``  — the vectorized PyTorch engines
    (:mod:`repro_torch.core.vectorized`, where a chunk of 64 steps is one
    launch of the chunk kernel on the card, and
    :mod:`repro_torch.core.vectorized_multijob`, one launch of the race
    kernel a step), on ``device=`` (default the card).

``engine="auto"`` routes as the reference does wherever the port can: it
picks ``ctmc`` when the port's CTMC engine runs the params, and ``event``
when the *reference's* CTMC engine would refuse them (retirement,
bad-set regeneration, failing warm standbys, ``repair_servers > 0``,
distributions without a fast-path family).  Where only the port's CTMC
engine is short (a family or feature the reference runs on its CTMC
engine and the port has not ported yet), ``auto`` raises with the ROADMAP
item instead of moving a study the reference runs on its device onto the
host.  ``engine="ctmc"`` refuses with every reason; ``engine="event"``
always runs the event engine.  The event engine takes no device.
:func:`resolve_engine_multijob` routes multi-job clusters the same way.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import vectorized, vectorized_multijob
from .histograms import Histogram
from .metrics import (RunResult, Stat, aggregate, aggregate_arrays,
                      aggregate_multijob_arrays, histograms_from_arrays,
                      histograms_from_results, pool_histograms)
from .multijob import JobSpec, MultiJobResult, simulate_multijob
from .params import Params
from .simulation import simulate

ENGINES = ("auto", "event", "ctmc")


def resolve_engine(params: Params, engine: str = "auto") -> str:
    """Map an engine request to the concrete engine that will run.

    >>> resolve_engine(Params(retirement_threshold=3))
    'event'
    >>> resolve_engine(Params())
    'ctmc'
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if engine == "event":
        return engine
    if vectorized.supports(params):
        return "ctmc"
    if engine == "auto":
        if vectorized.reference_reasons(params):
            return "event"
        raise ValueError(
            "engine='auto' cannot run these Params on the port: the "
            "reference runs them on its CTMC engine, but "
            + "; ".join(vectorized.port_reasons(params))
            + "; pass engine='event' to run them on the event engine")
    raise ValueError(
        "engine='ctmc' requested but these Params are outside the port's "
        "CTMC engine: " + "; ".join(vectorized.unsupported_reasons(params))
        + "; use engine='event' to run them on the event engine")


@dataclass
class Replications:
    """Aggregated outcome of one replication study (one sweep point)."""

    engine: str                     # concrete engine that ran: event | ctmc
    n: int                          # number of replications
    stats: Dict[str, Stat]
    #: per-replication RunResults (event engine only; empty for ctmc)
    results: List[RunResult] = field(default_factory=list)
    #: raw {metric: (n,) ndarray} (ctmc engine only)
    arrays: Optional[Dict[str, np.ndarray]] = None
    #: pooled streaming histograms per channel (whenever
    #: ``Params.histogram`` is set)
    histograms: Dict[str, Histogram] = field(default_factory=dict)


def _from_arrays(arrays: Dict[str, np.ndarray], n: int) -> Replications:
    incomplete = int(n - arrays["completed"].sum())
    if incomplete:
        warnings.warn(
            f"{incomplete}/{n} CTMC replicas hit the step budget before "
            "finishing the job; means are biased low — raise max_steps "
            "(truncation is surfaced as the 'n_incomplete' metric and the "
            "'completed' fraction in stats and sweep CSVs)",
            RuntimeWarning, stacklevel=3)
    overflows = int(arrays.get("n_repair_overflow", np.zeros(1)).sum())
    if overflows:
        warnings.warn(
            f"{overflows} diagnosed failure(s) found the repair-slot lane "
            "full (the server never leaves the shop; results are biased) "
            "— raise Params.repair_slots",
            RuntimeWarning, stacklevel=3)
    hists = histograms_from_arrays(arrays)
    return Replications(engine="ctmc", n=n,
                        stats=aggregate_arrays(arrays, histograms=hists),
                        arrays=arrays, histograms=hists)


def _from_results(results: List[RunResult], n: int,
                  params: Params) -> Replications:
    hists = histograms_from_results(results, params.histogram)
    return Replications(engine="event", n=n,
                        stats=aggregate(results, histograms=hists),
                        results=results, histograms=hists)


def run_replications(params: Params, n: int, engine: str = "auto",
                     base_seed: Optional[int] = None,
                     impl: Optional[str] = None,
                     max_steps: Optional[int] = None,
                     device=None) -> Replications:
    """Run ``n`` independent replications on the selected engine.

    The CTMC engine runs on ``device`` (default the card); the event
    engine is host code and takes no device.
    """
    chosen = resolve_engine(params, engine)
    if chosen == "ctmc":
        seed = params.seed if base_seed is None else base_seed
        arrays = vectorized.simulate_ctmc(params, n_replicas=n, seed=seed,
                                          impl=impl, max_steps=max_steps,
                                          device=device)
        return _from_arrays(arrays, n)
    results = simulate(params, n, base_seed=base_seed)
    return _from_results(results, n, params)


def run_replications_batch(params_list: Sequence[Params], n: int,
                           engine: str = "auto",
                           base_seed: Optional[int] = None,
                           impl: Optional[str] = None,
                           max_steps: Optional[int] = None,
                           progress: Optional[Callable[[int], None]] = None,
                           padded: bool = True,
                           bucketed: bool = True,
                           device=None) -> List[Replications]:
    """Replication studies for a whole sweep grid, batched where possible.

    Every point that resolves to the CTMC engine runs in a single
    :func:`vectorized.simulate_ctmc_sweep` call on ``device`` (``padded``
    / ``bucketed`` as there); the rest run through the event engine one
    by one.  ``progress(i)`` is called for every CTMC point up front
    (they start together), then for each event point as it starts.
    Results come back in input order regardless of routing.

    >>> calm = Params(job_size=2, working_pool_size=3, spare_pool_size=1,
    ...               warm_standbys=0, job_length=10.0,
    ...               random_failure_rate=0.0, systematic_failure_rate=0.0,
    ...               histogram=None)
    >>> reps = run_replications_batch(
    ...     [calm, calm.replace(job_length=20.0)], n=2, engine="event")
    >>> [round(r.stats["total_time"].mean, 1) for r in reps]  # +3.0 select
    [13.0, 23.0]
    >>> [r.engine for r in reps]
    ['event', 'event']
    """
    params_list = list(params_list)
    chosen = [resolve_engine(p, engine) for p in params_list]
    out: List[Optional[Replications]] = [None] * len(params_list)

    ctmc_idx = [i for i, c in enumerate(chosen) if c == "ctmc"]
    if ctmc_idx:
        if progress:
            for i in ctmc_idx:
                progress(i)
        seed = (params_list[ctmc_idx[0]].seed if base_seed is None
                else base_seed)
        arrays_list = vectorized.simulate_ctmc_sweep(
            [params_list[i] for i in ctmc_idx], n_replicas=n, seed=seed,
            impl=impl, max_steps=max_steps, padded=padded,
            bucketed=bucketed, device=device)
        for i, arrays in zip(ctmc_idx, arrays_list):
            out[i] = _from_arrays(arrays, n)

    for i, c in enumerate(chosen):
        if c == "event":
            if progress:
                progress(i)
            results = simulate(params_list[i], n, base_seed=base_seed)
            out[i] = _from_results(results, n, params_list[i])
    return out


# ---------------------------------------------------------------------------
# multi-job dispatch
# ---------------------------------------------------------------------------

def resolve_engine_multijob(cluster: Params, jobs: Sequence[JobSpec],
                            engine: str = "auto") -> str:
    """Multi-job twin of :func:`resolve_engine`.

    ``auto`` picks the multi-job CTMC engine
    (:mod:`repro_torch.core.vectorized_multijob`) whenever the cluster is
    inside its envelope -- exponential failures and repairs, all jobs
    starting at t=0, none of the event-only extensions -- and falls back
    to the event engine's :class:`~repro_torch.core.multijob.MultiJobSimulation`
    where the reference's CTMC engine refuses too.  Where only the port is
    short, ``auto`` raises with the ROADMAP item, as :func:`resolve_engine`
    does.

    >>> jobs = [JobSpec(8, 100.0), JobSpec(4, 50.0)]
    >>> resolve_engine_multijob(Params(repair_servers=2), jobs)
    'ctmc'
    >>> resolve_engine_multijob(Params(checkpoint_interval=60.0), jobs)
    'event'
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if engine == "auto":
        if vectorized_multijob.supports_multijob(cluster, jobs):
            return "ctmc"
        if vectorized_multijob.reference_reasons_multijob(cluster, jobs):
            return "event"
        raise ValueError(
            "engine='auto' cannot run this multi-job cluster on the port: "
            "the reference runs it on its CTMC engine, but "
            + "; ".join(vectorized_multijob.port_reasons_multijob(
                cluster, jobs))
            + "; pass engine='event' to run it on the event engine")
    if engine == "ctmc":
        reasons = vectorized_multijob.unsupported_reasons_multijob(
            cluster, jobs)
        if reasons:
            raise ValueError(
                "engine='ctmc' requested but this multi-job cluster is "
                "outside the CTMC envelope: " + "; ".join(reasons)
                + "; use engine='auto' to fall back")
    return engine


@dataclass
class MultiJobReplications:
    """Aggregated outcome of one multi-job replication study."""

    engine: str                     # concrete engine that ran
    n: int                          # number of replications
    #: one full Replications per job (same Stat keys as single-job runs)
    per_job: List[Replications]
    #: fleet-level Stats: makespan, shared-shop counters, stall_handoffs,
    #: n_shop_queued, conservation_err, completed, fleet_* sums, and
    #: fleet-pooled {channel}_dist
    fleet: Dict[str, Stat]
    #: fleet-pooled streaming histograms (all jobs' channels merged)
    histograms: Dict[str, Histogram] = field(default_factory=dict)


def _multijob_from_arrays(point: Dict[str, object],
                          n: int) -> MultiJobReplications:
    agg = aggregate_multijob_arrays(point)
    per_job = []
    for arrays, stats, hists in zip(point["per_job"], agg["per_job"],
                                    agg["per_job_histograms"]):
        per_job.append(Replications(engine="ctmc", n=n, stats=stats,
                                    arrays=arrays, histograms=hists))
    incomplete = int(n - point["completed"].sum())
    if incomplete:
        warnings.warn(
            f"{incomplete}/{n} multi-job CTMC replicas hit the step budget "
            "before every job finished; means are biased low — raise "
            "max_steps", RuntimeWarning, stacklevel=3)
    return MultiJobReplications(engine="ctmc", n=n, per_job=per_job,
                                fleet=agg["fleet"],
                                histograms=agg["histograms"])


def _multijob_from_results(results: List[MultiJobResult], n: int,
                           cluster: Params) -> MultiJobReplications:
    n_jobs = len(results[0].per_job)
    per_job = [
        _from_results([r.per_job[j] for r in results], n, cluster)
        for j in range(n_jobs)]
    fleet: Dict[str, Stat] = {}
    lanes = {
        "makespan": [r.makespan for r in results],
        "stall_handoffs": [float(r.stall_events) for r in results],
        "n_auto_repairs": [float(r.cluster.n_auto_repairs)
                           for r in results],
        "n_manual_repairs": [float(r.cluster.n_manual_repairs)
                             for r in results],
        "n_failed_repairs": [float(r.cluster.n_failed_repairs)
                             for r in results],
        "n_shop_queued": [float(r.queue_events) for r in results],
        # the event loop conserves servers by construction; reported for
        # key parity
        "conservation_err": [0.0] * n,
        "completed": [0.0 if any(p.timed_out for p in r.per_job) else 1.0
                      for r in results],
        "fleet_n_failures": [float(r.total_failures) for r in results],
        "fleet_stall_time": [sum(p.stall_time for p in r.per_job)
                             for r in results],
        "fleet_useful_work": [sum(p.useful_work for p in r.per_job)
                              for r in results],
    }
    for name, xs in lanes.items():
        fleet[name] = Stat.of(xs)
    pooled = pool_histograms([rep.histograms for rep in per_job])
    for ch, h in pooled.items():
        fleet[f"{ch}_dist"] = Stat.from_histogram(h)
    return MultiJobReplications(engine="event", n=n, per_job=per_job,
                                fleet=fleet, histograms=pooled)


def run_replications_multijob(cluster: Params, jobs: Sequence[JobSpec],
                              n: int, engine: str = "auto",
                              base_seed: Optional[int] = None,
                              impl: Optional[str] = None,
                              max_steps: Optional[int] = None,
                              device=None) -> MultiJobReplications:
    """``n`` independent multi-job replications on the selected engine
    (the CTMC engine on ``device``, default the card)."""
    return run_multijob_batch([(cluster, tuple(jobs))], n, engine=engine,
                              base_seed=base_seed, impl=impl,
                              max_steps=max_steps, device=device)[0]


def run_multijob_batch(points: Sequence, n: int, engine: str = "auto",
                       base_seed: Optional[int] = None,
                       impl: Optional[str] = None,
                       max_steps: Optional[int] = None,
                       device=None) -> List[MultiJobReplications]:
    """Multi-job replication studies for a whole capacity grid.

    ``points`` is a sequence of ``(cluster Params, [JobSpec, ...])``
    pairs.  Every point inside the multi-job CTMC envelope runs in a
    single :func:`~repro_torch.core.vectorized_multijob.simulate_multijob_ctmc_sweep`
    call on ``device`` -- points sharing a job count run as ONE batch no
    matter how sizes, rates, or pool/shop capacities vary -- and the rest
    run on the event engine one by one.  Results come back in input order.
    """
    points = [(c, tuple(js)) for c, js in points]
    chosen = [resolve_engine_multijob(c, js, engine) for c, js in points]
    out: List[Optional[MultiJobReplications]] = [None] * len(points)

    ctmc_idx = [i for i, c in enumerate(chosen) if c == "ctmc"]
    if ctmc_idx:
        seed = (points[ctmc_idx[0]][0].seed if base_seed is None
                else base_seed)
        point_outs = vectorized_multijob.simulate_multijob_ctmc_sweep(
            [points[i] for i in ctmc_idx], n_replicas=n, seed=seed,
            impl=impl, max_steps=max_steps, device=device)
        for i, po in zip(ctmc_idx, point_outs):
            out[i] = _multijob_from_arrays(po, n)

    for i, c in enumerate(chosen):
        if c == "event":
            cluster, js = points[i]
            results = simulate_multijob(
                cluster, list(js), n_replications=n,
                base_seed=cluster.seed if base_seed is None else base_seed)
            out[i] = _multijob_from_results(results, n, cluster)
    return out
