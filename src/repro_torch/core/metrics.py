"""Output metrics of a simulation run (paper §III-B Outputs).

Counterpart of ``src/repro/core/metrics.py`` for the port's engines:
:class:`RunResult` and :class:`Stat`; the event engine's
:func:`histograms_from_results`, :func:`aggregate` and :func:`summarize`
over per-replication results; the CTMC engine's
:func:`histograms_from_arrays` and :func:`aggregate_arrays` over the
per-replica arrays it returns; and the multi-job engines'
:func:`pool_histograms` and :func:`aggregate_multijob_arrays`, all
computed on the host in numpy.

AIReSim reports: (1) total time to train the job, (2) failure counts split
random/systematic, (3) preemptions, (4) repair counts (auto/manual), and
(5) run durations between restarts — with mean/median/std/percentiles over
replications.  We add stall time, host selections, retirements, and wasted
(recovery/lost) time, which the capacity-planning case study needs.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .histograms import (HIST_CHANNELS, Histogram, HistogramSpec,
                         percentiles_per_row)


@dataclass
class RunResult:
    """Raw outputs of a single simulation replication."""

    total_time: float = 0.0            # minutes from t=0 to job completion
    useful_work: float = 0.0           # == params.job_length on success
    n_failures: int = 0
    n_random_failures: int = 0
    n_systematic_failures: int = 0
    n_undiagnosed: int = 0
    n_misdiagnosed: int = 0
    n_preemptions: int = 0             # spare-pool draws
    n_auto_repairs: int = 0
    n_manual_repairs: int = 0
    n_failed_repairs: int = 0          # silent repair failures
    n_host_selections: int = 0         # full host-selection rounds (excl. t=0)
    n_standby_swaps: int = 0
    n_retired: int = 0
    #: CTMC engine only: diagnosed failures that found the repair-slot
    #: lane full (see ``Params.repair_slots``).  The event engine has no
    #: slot bound, so this is exactly zero on the event path.
    n_repair_overflow: int = 0
    #: correlated-failure counters (see repro_torch.core.faultdomains): shock
    #: events, servers killed by shocks/campaign kills (all compartments,
    #: in-shop re-breaks included), and campaign schedule entries fired
    n_domain_shocks: int = 0
    n_shock_killed: int = 0
    n_campaign_events: int = 0
    #: per-domain shock counts ([] unless Params.fault_domains is set)
    domain_shocks: List[int] = field(default_factory=list)
    stall_time: float = 0.0            # job waiting with zero capacity
    recovery_overhead: float = 0.0     # sum of recovery_time charges
    lost_work: float = 0.0             # checkpoint-rollback loss (extension)
    #: wall-clock minutes spent writing periodic checkpoints
    #: (``Params.checkpoint_cost`` per completed write; partial for a
    #: write a shock interrupted)
    checkpoint_overhead: float = 0.0
    run_durations: List[float] = field(default_factory=list)
    #: per-failure downtime (failure -> compute restart; ETTR) and the
    #: replacement-acquisition part of it alone — the event-engine
    #: sources of the "recovery" / "waiting" histogram channels
    recovery_durations: List[float] = field(default_factory=list)
    waiting_durations: List[float] = field(default_factory=list)
    timed_out: bool = False            # hit max_sim_time before completing

    @property
    def overhead_fraction(self) -> float:
        """Fraction of wall time not spent on useful work."""
        if self.total_time <= 0:
            return 0.0
        return 1.0 - self.useful_work / self.total_time

    @property
    def effective_utilization(self) -> float:
        return 1.0 - self.overhead_fraction

    @property
    def goodput(self) -> float:
        """Useful work per wall-clock minute — the operator-facing
        objective (Meta's "Revisiting Reliability" framing): 1.0 means
        every minute trained; rollback (``lost_work``), checkpoint
        writes, recovery, and stalls all pull it down."""
        if self.total_time <= 0:
            return 0.0
        return self.useful_work / self.total_time

    @property
    def goodput_samples(self) -> List[float]:
        """The ``goodput`` histogram channel's source: one realized
        goodput sample per *finished* job (timed-out runs record
        nothing, matching the CTMC engine's record-at-completion)."""
        if self.timed_out or self.total_time <= 0:
            return []
        return [self.useful_work / self.total_time]

    @property
    def mean_run_duration(self) -> float:
        return float(np.mean(self.run_durations)) if self.run_durations else 0.0

    @property
    def n_incomplete(self) -> int:
        """1 if this replication hit max_sim_time (or, on the CTMC
        engine, the step budget) before finishing the job — the scalar
        twin of ``timed_out`` so truncation shows up in aggregate stats
        and sweep CSV columns, not just a RuntimeWarning."""
        return int(self.timed_out)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["mean_run_duration"] = self.mean_run_duration
        d["overhead_fraction"] = self.overhead_fraction
        d["goodput"] = self.goodput
        d["n_incomplete"] = self.n_incomplete
        for k in ("run_durations", "recovery_durations", "waiting_durations",
                  "domain_shocks"):
            del d[k]
        return d


#: histogram channel -> RunResult list holding its raw values
_CHANNEL_SOURCES = {"run_duration": "run_durations",
                    "recovery": "recovery_durations",
                    "waiting": "waiting_durations",
                    "goodput": "goodput_samples"}


#: metric -> extractor used for aggregate statistics
_SCALAR_METRICS = (
    "total_time", "n_failures", "n_random_failures", "n_systematic_failures",
    "n_preemptions", "n_auto_repairs", "n_manual_repairs", "n_failed_repairs",
    "n_host_selections", "n_standby_swaps", "n_retired", "n_undiagnosed",
    "n_misdiagnosed", "n_repair_overflow", "n_domain_shocks",
    "n_shock_killed", "n_campaign_events", "n_incomplete", "stall_time",
    "recovery_overhead", "lost_work", "checkpoint_overhead",
    "mean_run_duration", "overhead_fraction", "goodput",
)

_PERCENTILES = (25, 50, 75, 90, 99)
#: histogram-backed stats add the deep tail (unbounded run counts make
#: p99.9 meaningful); keys stay numeric for CSV column naming
_HIST_PERCENTILES = (25, 50, 75, 90, 99, 99.9)
#: the per-replica tail percentile whose cross-replica spread is
#: surfaced as the ``{channel}_p99_replica`` dispersion Stat
REPLICA_TAIL_PERCENTILE = 99


@dataclass(frozen=True)
class Stat:
    mean: float
    median: float
    std: float
    minimum: float
    maximum: float
    percentiles: Dict[int, float]

    @classmethod
    def of(cls, xs: Sequence[float]) -> "Stat":
        a = np.asarray(list(xs), dtype=np.float64)
        if a.size == 0:
            # empty inputs (empty sweeps, zero recorded runs) must yield
            # a well-formed NaN Stat, never raise from np.percentile
            nan = float("nan")
            return cls(nan, nan, nan, nan, nan, {p: nan for p in _PERCENTILES})
        return cls(
            mean=float(a.mean()),
            median=float(np.median(a)),
            std=float(a.std(ddof=1)) if a.size > 1 else 0.0,
            minimum=float(a.min()),
            maximum=float(a.max()),
            percentiles={p: float(np.percentile(a, p)) for p in _PERCENTILES},
        )

    @classmethod
    def from_histogram(cls, h: Histogram) -> "Stat":
        """Distribution statistics from accumulated bin counts.

        Percentiles (incl. p99.9) are exact to one bin width; mean/std
        use geometric bin midpoints.  An empty histogram yields the same
        NaN-filled Stat as an empty sequence.
        """
        if h.total == 0:
            nan = float("nan")
            return cls(nan, nan, nan, nan, nan,
                       {p: nan for p in _HIST_PERCENTILES})
        return cls(
            mean=h.mean(),
            median=h.percentile(50),
            std=h.std(),
            minimum=h.minimum(),
            maximum=h.maximum(),
            percentiles={p: h.percentile(p) for p in _HIST_PERCENTILES},
        )

    @property
    def iqr(self) -> float:
        """Interquartile range (p75 - p25) — the robust spread measure
        the dispersion stats (``{channel}_p99_replica``) are read with:
        e.g. ``stats["recovery_p99_replica"].iqr`` is the IQR of
        per-replica p99 ETTR across replicas."""
        nan = float("nan")
        return (self.percentiles.get(75, nan)
                - self.percentiles.get(25, nan))

    def ci95_halfwidth(self, n: int) -> float:
        if n <= 1 or math.isnan(self.std):
            return 0.0
        return 1.96 * self.std / math.sqrt(n)


def histograms_from_results(results: Sequence[RunResult],
                            spec: Optional[HistogramSpec],
                            ) -> Dict[str, Histogram]:
    """Pooled per-channel histograms from event-engine per-run lists.

    This is the pure-numpy reference accumulator: the CTMC scan fills
    the identical bin layout in compiled code, so the two engines'
    distributions are directly comparable bin by bin.
    """
    if spec is None:
        return {}
    out: Dict[str, Histogram] = {}
    for ch in spec.channels:
        h = Histogram(spec)
        for r in results:
            h.add(getattr(r, _CHANNEL_SOURCES[ch]))
        out[ch] = h
    return out


def histograms_from_arrays(arrays: Dict[str, np.ndarray],
                           ) -> Dict[str, Histogram]:
    """Pooled per-channel histograms from CTMC per-replica bin counts."""
    if "hist_edges" not in arrays:
        return {}
    edges = np.asarray(arrays["hist_edges"], np.float64)
    out: Dict[str, Histogram] = {}
    for ch in HIST_CHANNELS:
        key = f"hist_{ch}"
        if key in arrays:
            counts = np.asarray(arrays[key], np.float64).sum(axis=0)
            out[ch] = Histogram(edges, counts)
    return out


def aggregate(results: Sequence[RunResult],
              histogram: Optional[HistogramSpec] = None,
              histograms: Optional[Dict[str, Histogram]] = None,
              ) -> Dict[str, Stat]:
    """Cross-replication statistics for every scalar output metric.

    With a :class:`HistogramSpec`, also reports ``{channel}_dist`` Stats
    (percentiles incl. p99.9, exact to one bin width) from the pooled
    per-run lists — the event-engine counterpart of the CTMC engine's
    streaming histograms — plus ``{channel}_p99_replica`` dispersion
    Stats: each replication's own p99 (binned through the same layout
    the CTMC engine uses, so the stat is engine-comparable), aggregated
    across replications; read the cross-replica IQR off ``.iqr``.
    Callers that already pooled (the backend) pass the prebuilt
    ``histograms`` dict to skip re-binning.
    """
    out: Dict[str, Stat] = {}
    for name in _SCALAR_METRICS:
        out[name] = Stat.of([float(getattr(r, name)) for r in results])
    out["completed"] = Stat.of([0.0 if r.timed_out else 1.0
                                for r in results])
    # run durations pooled across replications; the event engine keeps
    # full per-run lists, so nothing is ever truncated on this path
    pooled: List[float] = []
    for r in results:
        pooled.extend(r.run_durations)
    out["run_duration_pooled"] = Stat.of(pooled)
    out["run_duration_truncated"] = Stat.of([0.0] * len(results))
    if histograms is None:
        histograms = histograms_from_results(results, histogram)
    for ch, h in histograms.items():
        out[f"{ch}_dist"] = Stat.from_histogram(h)
        # cross-replica dispersion: each replication's own p99,
        # estimated through the same bin layout the CTMC engine uses so
        # the stat means the same thing on both engines
        per = []
        for r in results:
            vals = getattr(r, _CHANNEL_SOURCES[ch])
            if vals:
                per.append(Histogram.from_values(h.edges, vals)
                           .percentile(REPLICA_TAIL_PERCENTILE))
        out[f"{ch}_p{REPLICA_TAIL_PERCENTILE}_replica"] = Stat.of(per)
    return out


def aggregate_arrays(arrays: Dict[str, np.ndarray],
                     histograms: Optional[Dict[str, Histogram]] = None,
                     ) -> Dict[str, Stat]:
    """Cross-replication statistics from per-replica arrays.

    The keys are those of the reference's ``metrics.aggregate`` and
    ``metrics.aggregate_arrays``, so sweep tables read alike.

    Input is the ``{metric: (R,) ndarray}`` dict produced by the
    vectorized CTMC engine (:mod:`repro_torch.core.vectorized`).  Metrics
    absent from the arrays are filled with zeros — currently only
    ``n_retired``, which is exactly zero inside the CTMC envelope
    (``supports`` requires ``retirement_threshold == 0``).  Derived
    metrics are computed from the raw arrays:

      * ``overhead_fraction``  = 1 - useful_work / total_time
      * ``mean_run_duration``  — exact: the engine's per-run records
        satisfy sum(records) = useful_work + lost_work - cur_run, so the
        per-replica mean interval is that sum over ``n_runs`` even when
        the ring buffer overwrote old records.

    ``run_duration_pooled`` pools every surviving recorded interval from
    the ``run_durations`` (R, max_runs) ring buffers — the same pooling
    the event engine applies to its per-run lists — and
    ``run_duration_truncated`` counts the records the cap overwrote
    (raise ``Params.max_run_records`` to keep them).

    Streaming-histogram channels (``hist_{channel}`` (R, n_bins+2)
    per-replica counts + shared ``hist_edges``) pool across replicas into
    ``{channel}_dist`` Stats whose percentiles are exact to one bin width
    with **no** run-count bound — the trustworthy distribution source
    whenever ``run_duration_truncated`` is nonzero.  A prebuilt
    ``histograms`` dict (the backend's) skips re-pooling.  The raw
    per-replica counts additionally yield ``{channel}_p99_replica``
    dispersion Stats (each replica's own p99 via the vectorized
    :func:`repro_torch.core.histograms.percentiles_per_row`; ``.iqr`` is the
    cross-replica IQR) — pooling first would erase that spread.

    Legacy fallback: arrays lacking the run-duration records (foreign
    producers) degrade to the old total_time/(n_failures+1)
    approximation for both run-duration statistics.
    """
    some = next(iter(arrays.values()))
    R = len(some)
    zeros = np.zeros(R, dtype=np.float64)
    total_time = np.asarray(arrays["total_time"], np.float64)
    safe_total = np.maximum(total_time, 1e-12)
    derived = {
        "overhead_fraction": np.where(
            total_time > 0,
            1.0 - np.asarray(arrays["useful_work"], np.float64) / safe_total,
            0.0),
        "goodput": np.where(
            total_time > 0,
            np.asarray(arrays["useful_work"], np.float64) / safe_total,
            0.0),
    }
    if "completed" in arrays:
        # per-replica truncation indicator: the scalar twin of the
        # backend's step-budget RuntimeWarning
        derived["n_incomplete"] = 1.0 - np.asarray(arrays["completed"],
                                                   np.float64)
    exact = "run_durations" in arrays and "n_runs" in arrays
    if exact:
        buf = np.asarray(arrays["run_durations"], np.float64)
        n_runs = np.asarray(arrays["n_runs"], np.int64)
        max_runs = buf.shape[1]
        n_valid = np.minimum(n_runs, max_runs)
        valid = np.arange(max_runs)[None, :] < n_valid[:, None]
        recorded_total = (
            np.asarray(arrays["useful_work"], np.float64)
            + np.asarray(arrays.get("lost_work", zeros), np.float64)
            - np.asarray(arrays.get("cur_run", zeros), np.float64))
        derived["mean_run_duration"] = np.where(
            n_runs > 0, recorded_total / np.maximum(n_runs, 1), 0.0)
        # max_runs=0 means recording was compiled out: pool the (still
        # exact) per-replica means instead of individual intervals
        pooled = buf[valid] if max_runs else derived["mean_run_duration"]
        truncated = (n_runs - n_valid).astype(np.float64)
    else:
        derived["mean_run_duration"] = total_time / (
            np.asarray(arrays["n_failures"], np.float64) + 1.0)
        pooled = derived["mean_run_duration"]
        truncated = zeros
    out: Dict[str, Stat] = {}
    for name in _SCALAR_METRICS:
        if name in arrays:
            xs = np.asarray(arrays[name], np.float64)
        elif name in derived:
            xs = derived[name]
        else:
            xs = zeros
        out[name] = Stat.of(xs)
    if "completed" in arrays:   # fraction of replicas that finished the
        # job inside the step budget (CTMC) — parity with timed_out
        out["completed"] = Stat.of(np.asarray(arrays["completed"],
                                              np.float64))
    out["run_duration_pooled"] = Stat.of(pooled)
    out["run_duration_truncated"] = Stat.of(truncated)
    if histograms is None:
        histograms = histograms_from_arrays(arrays)
    for ch, h in histograms.items():
        out[f"{ch}_dist"] = Stat.from_histogram(h)
    if "hist_edges" in arrays:
        # cross-replica dispersion of distribution tails: vectorized
        # per-replica percentiles straight from the raw (R, n_bins + 2)
        # counts (pooling first would erase run-to-run spread)
        edges = np.asarray(arrays["hist_edges"], np.float64)
        for ch in HIST_CHANNELS:
            key = f"hist_{ch}"
            if key in arrays:
                per = percentiles_per_row(edges, arrays[key],
                                          REPLICA_TAIL_PERCENTILE)
                out[f"{ch}_p{REPLICA_TAIL_PERCENTILE}_replica"] = Stat.of(
                    per[np.isfinite(per)])
    return out


def pool_histograms(hist_dicts: Sequence[Dict[str, Histogram]],
                    ) -> Dict[str, Histogram]:
    """Merge per-channel histogram dicts by summing bin counts.

    The multi-job engines report one histogram dict per job; pooling
    them gives the fleet-level ETTF/recovery/waiting distributions (all
    dicts share the cluster's single ``Params.histogram`` layout)."""
    out: Dict[str, Histogram] = {}
    for d in hist_dicts:
        for ch, h in d.items():
            out[ch] = out[ch].merge(h) if ch in out else Histogram(
                h.edges, h.counts)
    return out


#: fleet-level (R,) lanes of a multi-job CTMC point dict
_MJ_FLEET_METRICS = ("makespan", "stall_handoffs", "n_auto_repairs",
                     "n_manual_repairs", "n_failed_repairs",
                     "n_shop_queued", "conservation_err", "completed")


def aggregate_multijob_arrays(point: Dict[str, Any],
                              ) -> Dict[str, Any]:
    """Per-job + fleet-pooled statistics for one multi-job CTMC point.

    ``point`` is one element of
    :func:`repro_torch.core.vectorized_multijob.simulate_multijob_ctmc_sweep`'s
    return: per-job array dicts (each :func:`aggregate_arrays`-shaped)
    plus cluster-level (R,) lanes.  Returns::

        {"per_job": [Stat dict per job],
         "fleet":   {makespan, shop counters, stall_handoffs,
                     n_shop_queued, conservation_err, completed,
                     fleet_n_failures, fleet_stall_time,
                     fleet_useful_work, {channel}_dist, ...},
         "histograms": fleet-pooled {channel: Histogram},
         "per_job_histograms": [{channel: Histogram} per job]}

    Fleet sums are per-replication (summed across jobs, then aggregated
    across replicas), so their Stats carry real cross-replica spread.
    """
    per_job_hists = [histograms_from_arrays(d) for d in point["per_job"]]
    per_job = [aggregate_arrays(d, histograms=h)
               for d, h in zip(point["per_job"], per_job_hists)]
    fleet: Dict[str, Stat] = {}
    for name in _MJ_FLEET_METRICS:
        fleet[name] = Stat.of(np.asarray(point[name], np.float64))
    for pooled_name, src in (("fleet_n_failures", "n_failures"),
                             ("fleet_stall_time", "stall_time"),
                             ("fleet_useful_work", "useful_work")):
        tot = np.sum([np.asarray(d[src], np.float64)
                      for d in point["per_job"]], axis=0)
        fleet[pooled_name] = Stat.of(tot)
    pooled = pool_histograms(per_job_hists)
    for ch, h in pooled.items():
        fleet[f"{ch}_dist"] = Stat.from_histogram(h)
    return {"per_job": per_job, "fleet": fleet, "histograms": pooled,
            "per_job_histograms": per_job_hists}


def summarize(results: Sequence[RunResult]) -> Dict[str, float]:
    """Flat {metric: mean} view — convenient for sweep tables."""
    agg = aggregate(results)
    return {name: stat.mean for name, stat in agg.items()}
