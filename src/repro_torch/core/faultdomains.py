"""Correlated failure domains and scripted fault-injection campaigns.

Counterpart of ``src/repro/core/faultdomains.py``.  It carries the
parameter types :class:`FaultTopology`, :class:`CampaignEvent` and
:class:`Campaign`; the CTMC engine's helpers :func:`scenario_key` (the
scenario's structure, which groups a sweep and sizes the step's race),
:func:`scenario_columns` (its trailing float64 parameter columns) and
:func:`scenario_budget` (its step-budget term), each equal to the
reference's; and the event engine's :class:`ShockInjector`, copied draw
for draw, so shocks and campaigns run on the port's event engine exactly
as on the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FaultTopology", "CampaignEvent", "Campaign", "ShockInjector",
           "Injection", "scenario_key", "scenario_columns", "scenario_budget",
           "KILL", "MAINT_START", "MAINT_END"]

#: campaign schedule entry codes
KILL, MAINT_START, MAINT_END = 0, 1, 2


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultTopology:
    """Rack → pod fault-domain hierarchy with per-level shock rates.

    Domains are indexed ``0..n_racks-1`` (racks) followed by
    ``n_racks..n_racks+n_pods-1`` (pods).  ``racks_per_pod == 0``
    disables the pod level entirely.

    >>> t = FaultTopology(n_racks=4, racks_per_pod=2,
    ...                   rack_shock_rate=1e-4)
    >>> t.n_pods, t.n_domains
    (2, 6)
    >>> [t.rack_of(s) for s in range(6)]
    [0, 1, 2, 3, 0, 1]
    >>> t.domain_members(4, total=8)     # pod 0 = racks {0, 1}
    [0, 1, 4, 5]
    """

    n_racks: int
    racks_per_pod: int = 0
    rack_shock_rate: float = 0.0
    pod_shock_rate: float = 0.0

    def validate(self, total_servers: int) -> None:
        if self.n_racks < 1:
            raise ValueError(f"n_racks must be >= 1, got {self.n_racks}")
        if self.racks_per_pod < 0:
            raise ValueError("racks_per_pod must be >= 0")
        if self.rack_shock_rate < 0 or self.pod_shock_rate < 0:
            raise ValueError("shock rates must be >= 0")
        if self.pod_shock_rate > 0 and self.racks_per_pod == 0:
            raise ValueError(
                "pod_shock_rate > 0 requires racks_per_pod >= 1")
        if self.n_racks > total_servers:
            raise ValueError(
                f"n_racks={self.n_racks} exceeds the fleet size "
                f"{total_servers}: every rack must hold a server")

    @property
    def n_pods(self) -> int:
        if not self.racks_per_pod:
            return 0
        return math.ceil(self.n_racks / self.racks_per_pod)

    @property
    def n_domains(self) -> int:
        return self.n_racks + self.n_pods

    def rack_of(self, sid: int) -> int:
        return sid % self.n_racks

    def pod_of_rack(self, rack: int) -> int:
        return rack // self.racks_per_pod

    def domain_members(self, domain: int, total: int) -> List[int]:
        """Server ids (workers + spares) belonging to ``domain``."""
        if domain < self.n_racks:
            return [s for s in range(total) if s % self.n_racks == domain]
        pod = domain - self.n_racks
        return [s for s in range(total)
                if (s % self.n_racks) // self.racks_per_pod == pod]

    def domain_rates(self) -> np.ndarray:
        """Per-domain shock rates, racks first then pods — shape (D,)."""
        return np.concatenate([
            np.full(self.n_racks, self.rack_shock_rate, np.float64),
            np.full(self.n_pods, self.pod_shock_rate, np.float64)])

    def domain_fractions(self, total: int) -> np.ndarray:
        """Fraction of the fleet in each domain — shape (D,).

        The CTMC engine carries compartment *counts*, not identities, so
        a shock removes ``fraction * count`` servers from every pool
        (stochastically rounded).  With round-robin assignment the
        striping is uniform, so the per-domain fraction is the exact
        expectation of the event engine's member count in every pool.
        """
        sizes = np.array([len(self.domain_members(d, total))
                          for d in range(self.n_domains)], np.float64)
        return sizes / max(total, 1)


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CampaignEvent:
    """One scripted injection.

    ``kind="kill"``: fail every server in ``domain`` at ``time``.
    ``kind="maintenance"``: disable the repair shop over
    ``[time, time + duration]`` — in-flight repairs pause and resume
    with their remaining stage time.
    """

    time: float
    kind: str = "kill"
    domain: int = 0
    duration: float = 0.0

    def validate(self, topology: Optional[FaultTopology]) -> None:
        if self.kind not in ("kill", "maintenance"):
            raise ValueError(f"unknown campaign event kind {self.kind!r}")
        if self.time < 0:
            raise ValueError("campaign event time must be >= 0")
        if self.kind == "maintenance" and self.duration <= 0:
            raise ValueError("maintenance windows need duration > 0")
        if self.kind == "kill":
            if topology is None:
                raise ValueError(
                    "campaign kills require Params.fault_domains")
            if not 0 <= self.domain < topology.n_domains:
                raise ValueError(
                    f"kill domain {self.domain} out of range "
                    f"[0, {topology.n_domains})")


@dataclass(frozen=True)
class Campaign:
    """An ordered, validated schedule of :class:`CampaignEvent`.

    >>> c = Campaign(events=({"time": 10.0, "kind": "maintenance",
    ...                       "duration": 5.0},
    ...              CampaignEvent(time=2.0, kind="kill", domain=1)))
    >>> c.schedule()
    [(2.0, 0, 1), (10.0, 1, 0), (15.0, 2, 0)]
    """

    events: Tuple[CampaignEvent, ...] = field(default_factory=tuple)

    def __post_init__(self):
        norm = tuple(CampaignEvent(**e) if isinstance(e, dict) else e
                     for e in self.events)
        object.__setattr__(self, "events", norm)

    def validate(self, topology: Optional[FaultTopology]) -> None:
        for e in self.events:
            e.validate(topology)

    def schedule(self) -> List[Tuple[float, int, int]]:
        """Flatten to a time-sorted list of ``(time, code, domain)``.

        Maintenance windows become two entries (start/end).  The sort is
        stable, so simultaneous entries fire in declaration order on
        both engines.
        """
        flat: List[Tuple[float, int, int]] = []
        for e in self.events:
            if e.kind == "kill":
                flat.append((float(e.time), KILL, e.domain))
            else:
                flat.append((float(e.time), MAINT_START, 0))
                flat.append((float(e.time + e.duration), MAINT_END, 0))
        flat.sort(key=lambda x: x[0])
        return flat


# ---------------------------------------------------------------------------
# CTMC helpers
# ---------------------------------------------------------------------------
# The CTMC step treats the scenario as (structure, numbers): the domain
# count D and the tuple of schedule codes size the race and the state, so
# they split a sweep into batches; every rate, fraction, time and target
# domain rides in trailing parameter columns, so a shock-rate grid over
# one topology is one batch.

def scenario_key(p) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """Scenario structure ``(D, codes)`` -- or None when no scenario."""
    if p.fault_domains is None and p.campaign is None:
        return None
    d = p.fault_domains.n_domains if p.fault_domains is not None else 0
    codes = tuple(code for _, code, _ in p.campaign.schedule()) \
        if p.campaign is not None else ()
    return (d, codes)


def scenario_columns(p) -> np.ndarray:
    """Trailing parameter columns of the scenario, float64.

    Layout: ``[rates (D), fractions (D), times (L), fracs (L),
    domains (L)]`` where L is the flattened schedule length.  Kill
    entries carry the struck domain's fleet fraction; maintenance
    entries carry zeros.

    >>> t = FaultTopology(n_racks=2, rack_shock_rate=1e-4)
    >>> c = Campaign(events=(CampaignEvent(time=5.0, domain=1),))
    >>> class P: fault_domains, campaign = t, c
    >>> P.working_pool_size, P.spare_pool_size = 3, 1
    >>> scenario_columns(P).tolist()
    [0.0001, 0.0001, 0.5, 0.5, 5.0, 0.5, 1.0]
    """
    topo, camp = p.fault_domains, p.campaign
    total = p.working_pool_size + p.spare_pool_size
    if topo is not None:
        rates = topo.domain_rates()
        fracs = topo.domain_fractions(total)
    else:
        rates = fracs = np.zeros(0, np.float64)
    times: List[float] = []
    efracs: List[float] = []
    edoms: List[float] = []
    if camp is not None:
        for t, code, dom in camp.schedule():
            times.append(t)
            efracs.append(float(fracs[dom]) if code == KILL else 0.0)
            edoms.append(float(dom))
    return np.concatenate([rates, fracs,
                           np.asarray(times, np.float64),
                           np.asarray(efracs, np.float64),
                           np.asarray(edoms, np.float64)])


def scenario_budget(p, horizon: float) -> Tuple[float, float]:
    """``(extra_steps, extra_horizon)`` for the CTMC step budget.

    Each shock takes one step plus the repair traffic of the block it
    kills (about 4 steps a killed server: automated completion,
    escalation, manual completion, return or unstall).  Maintenance
    windows stretch the horizon by their duration (repairs pause) and
    each campaign entry takes a step of its own.
    """
    topo, camp = p.fault_domains, p.campaign
    total = p.working_pool_size + p.spare_pool_size
    extra_steps = 0.0
    extra_horizon = 0.0
    if topo is not None:
        rates = topo.domain_rates()
        sizes = topo.domain_fractions(total) * total
        lam = float(rates.sum())
        if lam > 0:
            n_shocks = lam * horizon
            mean_kill = float((rates * sizes).sum()) / lam
            extra_steps += n_shocks * (2.0 + 4.0 * mean_kill)
            extra_horizon += n_shocks * (
                p.recovery_time + p.host_selection_time + p.waiting_time)
    if camp is not None:
        for _, code, dom in camp.schedule():
            extra_steps += 2.0
            if code == KILL and topo is not None:
                extra_steps += 4.0 * len(topo.domain_members(dom, total))
        extra_horizon += sum(e.duration for e in camp.events
                             if e.kind == "maintenance")
    return extra_steps, extra_horizon


# ---------------------------------------------------------------------------
# event-engine injector
# ---------------------------------------------------------------------------

@dataclass
class Injection:
    """One injection popped from the merged stream."""

    time: float
    kind: str                      # "shock" | "kill" | "maint_start" | "maint_end"
    domain: int
    members: Sequence[int]         # struck server ids ([] for maintenance)


class ShockInjector:
    """Merged random-shock + campaign stream for the event engine.

    Per-domain shock arrivals are drawn lazily (one exponential gap per
    pop) from the simulation RNG; the campaign schedule is a pointer
    walk.  ``peek()`` returns the next injection time (inf when
    exhausted), ``pop()`` consumes it.  Ties between a shock and a
    campaign entry resolve campaign-first, matching the CTMC race where
    deterministic residual ties break on the first (campaign) column.
    """

    def __init__(self, topology: Optional[FaultTopology],
                 campaign: Optional[Campaign], total: int, rng) -> None:
        self.topology = topology
        self._rng = rng
        if topology is not None:
            self._rates = topology.domain_rates()
            self._members = [topology.domain_members(d, total)
                             for d in range(topology.n_domains)]
            self._next = np.array(
                [rng.exponential(1.0 / r) if r > 0 else math.inf
                 for r in self._rates])
        else:
            self._rates = np.zeros(0)
            self._members = []
            self._next = np.zeros(0)
        self._schedule = campaign.schedule() if campaign is not None else []
        self._ptr = 0

    def _next_campaign_time(self) -> float:
        if self._ptr >= len(self._schedule):
            return math.inf
        return self._schedule[self._ptr][0]

    def peek(self) -> float:
        t = self._next_campaign_time()
        if len(self._next):
            t = min(t, float(self._next.min()))
        return t

    def pop(self) -> Injection:
        t_camp = self._next_campaign_time()
        t_shock = float(self._next.min()) if len(self._next) else math.inf
        if t_camp <= t_shock:            # campaign wins ties (see class doc)
            t, code, dom = self._schedule[self._ptr]
            self._ptr += 1
            if code == KILL:
                return Injection(t, "kill", dom, self._members[dom])
            kind = "maint_start" if code == MAINT_START else "maint_end"
            return Injection(t, kind, 0, [])
        d = int(self._next.argmin())
        t = self._next[d]
        self._next[d] = t + self._rng.exponential(1.0 / self._rates[d])
        return Injection(float(t), "shock", d, self._members[d])
