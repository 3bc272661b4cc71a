"""Simulation parameters (the paper's `Params` data class).

Counterpart of ``src/repro/core/params.py``: the same fields, defaults
and dict round trip, so ``Params.from_dict(reference.to_dict())`` rebuilds
a reference configuration field for field.  Only ``event_race_impl``
takes the port's own values (``None`` / ``"ref"`` / ``"cuda"``).

All thirteen §III-B input parameters are present under the paper's own
names, with Table-I defaults. Time unit is MINUTES throughout (the paper's
rates are written per-minute, e.g. ``0.01/(24*60)``).

Extensions beyond the paper are grouped at the bottom and default to the
paper-faithful behavior (off / equivalent).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .faultdomains import Campaign, FaultTopology
from .histograms import HistogramSpec

MINUTES_PER_DAY = 24 * 60


@dataclass
class Params:
    """Input parameters for one cluster-reliability simulation.

    All of the paper's §III-B inputs under their own names, with Table-I
    defaults; every time is in **minutes**.  Instances are plain
    dataclasses: build one, tweak copies with :meth:`replace`, and hand
    it to ``run_replications`` / the sweep classes.

    >>> p = Params(recovery_time=30.0, warm_standbys=32)
    >>> p.validate()                       # raises ValueError on bad input
    >>> p.replace(warm_standbys=8).warm_standbys   # copies, never mutates
    8
    >>> p.warm_standbys
    32
    >>> round(p.bad_failure_rate / p.random_failure_rate, 1)  # random + sys
    6.0

    The non-exponential failure families (Weibull, bathtub, lognormal,
    empirical) and repair families (Weibull, lognormal, deterministic,
    empirical) keep their fields here, and the port's CTMC and event
    engines run them as the reference's do.

    Round trips for experiment files:

    >>> Params.from_dict(p.to_dict()) == p
    True
    """

    # ---- failure model (paper inputs 1-2) --------------------------------
    random_failure_rate: float = 0.01 / MINUTES_PER_DAY
    #: systematic rate is *additional* on top of random for bad servers
    systematic_failure_rate: float = 5 * 0.01 / MINUTES_PER_DAY
    systematic_failure_fraction: float = 0.15

    # ---- recovery / job (paper inputs 3-6) --------------------------------
    recovery_time: float = 20.0                 # minutes; checkpoint reload + restart
    job_size: int = 4096                        # servers needed to execute
    job_length: float = 64 * MINUTES_PER_DAY    # useful compute minutes (paper e.g. 256 days)
    warm_standbys: int = 16                     # allocated beyond job_size

    # ---- pools (paper inputs 7-8) ------------------------------------------
    working_pool_size: int = 4160
    spare_pool_size: int = 200

    # ---- host selection / preemption (Table I) -----------------------------
    host_selection_time: float = 3.0            # minutes
    waiting_time: float = 20.0                  # minutes to preempt a spare-pool job

    # ---- repair model (paper inputs 9-11) -----------------------------------
    auto_repair_time: float = 120.0             # minutes (mean)
    manual_repair_time: float = 2 * 1440.0      # minutes (mean)
    auto_repair_failure_probability: float = 0.4
    manual_repair_failure_probability: float = 0.2
    #: probability a failure is handled by automated repair (Table I
    #: "Automated repair probability"); 1-p escalates straight to manual.
    automated_repair_probability: float = 0.8

    # ---- diagnosis (paper inputs 12-13) -------------------------------------
    diagnosis_probability: float = 0.8          # failure diagnosed at all
    diagnosis_uncertainty: float = 0.0          # wrong server identified

    # ---- distributions (assumption 2) ---------------------------------------
    failure_distribution: str = "exponential"
    repair_distribution: str = "exponential"
    distribution_kwargs: Dict[str, Any] = field(default_factory=dict)

    # ---- extensions (default = paper-faithful) ------------------------------
    #: regenerate the bad-server set every N minutes (assumption 1 case 2);
    #: 0 disables (fixed bad set).
    bad_set_regeneration_period: float = 0.0
    #: retire a server after >= this many failures within retirement_window
    #: minutes; 0 disables retirement (paper §IV runs without it).
    retirement_threshold: int = 0
    retirement_window: float = 7 * MINUTES_PER_DAY
    #: if True, warm standbys also run failure processes while allocated
    #: (paper assumption 7 models failures only on executing servers).
    standbys_can_fail: bool = False
    #: explicit checkpoint model: if > 0, a failure additionally loses the
    #: work since the last checkpoint (interval in minutes). 0 = paper model
    #: (all failure cost folded into recovery_time).
    checkpoint_interval: float = 0.0
    #: wall-clock minutes each periodic checkpoint *write* costs (charged
    #: every ``checkpoint_interval`` minutes of useful compute; the
    #: failure clock is frozen while the write runs).  0 = free writes —
    #: the historical model, where only rollback is priced.  Both knobs
    #: are traced sweep axes on the CTMC fast path.
    checkpoint_cost: float = 0.0
    #: fixed preemption cost charged per spare-pool server drawn
    #: (assumption 7: "fixed cost per server ... that was preempted").
    preemption_cost: float = 0.0

    # ---- experiment control ---------------------------------------------------
    seed: int = 0
    max_sim_time: float = 10_000 * MINUTES_PER_DAY  # hard stop (deadlock guard)
    #: ring-buffer slots for exact per-run duration records in the
    #: vectorized CTMC engine (per replica).  Runs beyond the cap
    #: overwrite the oldest slot and surface as the
    #: ``run_duration_truncated`` statistic; per-replica means stay exact
    #: regardless.  The event engine keeps full Python lists and ignores
    #: this.
    max_run_records: int = 128
    #: streaming distribution outputs: log-spaced histograms of run
    #: durations (ETTF), recovery downtime (ETTR), and replacement
    #: waiting, accumulated with no run-count bound on both engines.
    #: Percentiles are exact to one bin width (see
    #: :class:`repro_torch.core.histograms.HistogramSpec`); ``None``
    #: leaves the accumulator out of the CTMC scan entirely.
    histogram: Optional[HistogramSpec] = field(default_factory=HistogramSpec)
    #: dtype of the CTMC engine's hazard-age arithmetic ("float32" |
    #: "float64").  "float64" keeps the failure-age and repair-slot lanes
    #: in float64, as the reference does (its carve-out for the
    #: cancellation of the Weibull inversion at large ages); on the card
    #: it runs the float64 instances of the chunk kernel.
    age_dtype: str = "float32"
    #: repair-slot lane width of the CTMC engine under *non-exponential*
    #: repair distributions (each in-repair server occupies one slot
    #: carrying its class, stage, and remaining duration).  0 (default)
    #: auto-sizes from the expected shop occupancy (Little's law) with
    #: generous head-room, rounded to a power of two for program
    #: sharing.  A full lane surfaces as the ``n_repair_overflow``
    #: metric (the overflowing server stays in the shop forever) — raise
    #: this if that ever fires.  Exponential repairs ignore it.
    repair_slots: int = 0
    #: finite repair-shop capacity: at most this many servers are *in
    #: service* (automated or manual stage) at once; further failed
    #: servers queue inside the shop until a service slot frees up.  A
    #: freed slot admits a queued server chosen uniformly at random —
    #: which makes admission class- and owner-proportional over the
    #: queued counts, the property the CTMC engine's compartment model
    #: reproduces exactly in law.  0 (default) = unlimited servers (the
    #: paper's model: every repair starts immediately).
    repair_servers: int = 0
    #: correlated failure domains: a rack → pod topology with per-level
    #: exponential shock rates.  A shock atomically fails every server
    #: in the struck domain (running, spare, and in-repair alike).
    #: ``None`` (default) disables correlated failures entirely.  See
    #: :mod:`repro_torch.core.faultdomains`.
    fault_domains: Optional[FaultTopology] = None
    #: scripted fault-injection campaign: a validated schedule of timed
    #: ``kill domain d at t`` and repair-shop maintenance windows,
    #: honored exactly by both engines.  ``None`` disables.
    campaign: Optional[Campaign] = None
    #: shard the CTMC engine's replica axis over this many local devices
    #: (cuda:0 .. cuda:n-1 on the card; in turn on the CPU).  0 (default)
    #: = unsharded single-device dispatch; 1 is bit for bit the same run.
    engine_shards: int = 0
    #: kernel dispatch of the CTMC engine: ``None`` (default) chooses by
    #: device — the CUDA chunk kernel (steps and event race fused) for
    #: tensors on the card, the plain PyTorch step loop on the CPU.
    #: ``"ref"`` forces the plain loop, ``"cuda"`` the kernel (raises for
    #: CPU tensors).
    event_race_impl: Optional[str] = None

    # -------------------------------------------------------------------------
    def validate(self) -> None:
        if self.job_size <= 0:
            raise ValueError("job_size must be positive")
        if self.working_pool_size < self.job_size:
            raise ValueError(
                f"working pool ({self.working_pool_size}) smaller than job "
                f"({self.job_size}); the job can never be scheduled")
        if self.warm_standbys < 0 or self.spare_pool_size < 0:
            raise ValueError("pool sizes must be non-negative")
        if not 0.0 <= self.systematic_failure_fraction <= 1.0:
            raise ValueError("systematic_failure_fraction must be in [0,1]")
        for name in ("auto_repair_failure_probability",
                     "manual_repair_failure_probability",
                     "automated_repair_probability",
                     "diagnosis_probability", "diagnosis_uncertainty"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must be a probability")
        for name in ("random_failure_rate", "systematic_failure_rate",
                     "recovery_time", "job_length", "host_selection_time",
                     "waiting_time", "auto_repair_time", "manual_repair_time",
                     "checkpoint_interval", "checkpoint_cost"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be non-negative")
        if self.max_run_records < 1:
            raise ValueError("max_run_records must be >= 1")
        if self.age_dtype not in ("float32", "float64"):
            raise ValueError(
                f"age_dtype={self.age_dtype!r} must be 'float32' or "
                "'float64'")
        if self.repair_slots < 0:
            raise ValueError("repair_slots must be non-negative")
        if self.repair_servers < 0:
            raise ValueError("repair_servers must be non-negative "
                             "(0 = unlimited)")
        if self.engine_shards < 0:
            raise ValueError("engine_shards must be non-negative "
                             "(0 = unsharded)")
        if self.event_race_impl not in (None, "ref", "cuda"):
            raise ValueError(
                f"event_race_impl={self.event_race_impl!r} must be None, "
                "'ref' or 'cuda'")
        if self.histogram is not None:
            self.histogram.validate()
        if self.fault_domains is not None:
            self.fault_domains.validate(
                self.working_pool_size + self.spare_pool_size)
        if self.campaign is not None:
            self.campaign.validate(self.fault_domains)

    def replace(self, **kwargs) -> "Params":
        return dataclasses.replace(self, **kwargs)

    @property
    def bad_failure_rate(self) -> float:
        """Total failure rate of a bad server (random + systematic)."""
        return self.random_failure_rate + self.systematic_failure_rate

    @property
    def initial_standby_headroom(self) -> int:
        """Free working-pool servers beyond the job's allocation."""
        return self.working_pool_size - self.job_size - self.warm_standbys

    def expected_failures_per_minute(self) -> float:
        """Mean cluster-wide failure rate of the executing servers at t=0."""
        n_bad = self.systematic_failure_fraction * self.job_size
        n_good = self.job_size - n_bad
        return (n_good * self.random_failure_rate
                + n_bad * self.bad_failure_rate)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Params":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Params fields: {sorted(unknown)}")
        if isinstance(d.get("histogram"), dict):   # to_dict/yaml round trip
            d = dict(d, histogram=HistogramSpec.from_dict(d["histogram"]))
        if isinstance(d.get("fault_domains"), dict):
            d = dict(d, fault_domains=FaultTopology(**d["fault_domains"]))
        if isinstance(d.get("campaign"), dict):
            d = dict(d, campaign=Campaign(**d["campaign"]))
        return cls(**d)


def paper_table1_defaults() -> Params:
    """The exact Table-I default column (job_length set to 64 days; the
    paper's job length is illustrative — '(e.g., 256 days)' — and Table I
    does not pin it)."""
    return Params()


#: Table I "Value Range Considered" — used by the paper-reproduction sweeps.
PAPER_TABLE1_RANGES: Dict[str, list] = {
    "random_failure_rate": [0.005 / MINUTES_PER_DAY, 0.01 / MINUTES_PER_DAY,
                            0.025 / MINUTES_PER_DAY, 0.05 / MINUTES_PER_DAY],
    "systematic_failure_rate_multiplier": [3, 5, 10],   # x random rate
    "systematic_failure_fraction": [0.1, 0.15, 0.2],
    "recovery_time": [10.0, 20.0, 30.0],
    "warm_standbys": [4, 8, 16, 32],
    "host_selection_time": [1.0, 3.0, 5.0, 10.0],
    "waiting_time": [10.0, 20.0, 30.0],
    "automated_repair_probability": [0.70, 0.80, 0.90],
    "auto_repair_failure_probability": [0.2, 0.4, 0.6],
    "manual_repair_failure_probability": [0.1, 0.2, 0.3],
    "auto_repair_time": [60.0, 120.0, 180.0],
    "manual_repair_time": [1440.0, 2 * 1440.0, 3 * 1440.0],
    "working_pool_size": [4112, 4128, 4160, 4192],
    "spare_pool_size": [200, 300, 400],
    "diagnosis_probability": [0.6, 0.8, 1.0],
}
