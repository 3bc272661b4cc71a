"""Fault tolerance: failure injection, checkpoint restart, elastic re-mesh,
straggler policy.

Counterpart of ``src/repro/train/fault_tolerance.py``, on the port's
``core.params`` and ``core.analytical``: the same numpy draws, so a seed
and a cluster give the reference's failure steps.

This closes the loop with the paper: the *same* failure model AIReSim
sweeps (exponential per-server random + systematic rates) drives the
injector here, and the recovery path the trainer executes (restore +
seek + re-lower) is the recovery_time AIReSim charges.  Running the
trainer under injection produces an empirical overhead fraction that can
be validated against the simulator's prediction
(tests/test_torch_train_loop.py holds the port's to the reference's).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.params import Params as ClusterParams


@dataclass
class FailureEvent:
    step: int
    kind: str          # "random" | "systematic" | "injected"
    wall_time: float


class FailureInjector:
    """Samples job-level failures from the cluster failure model.

    P(failure during a step) = 1 - exp(-lambda * step_minutes) with
    lambda = cluster-wide failure rate of the executing servers — the
    identical quantity core.analytical.cluster_failure_rate computes for
    the simulator.
    """

    def __init__(self, cluster: ClusterParams, step_minutes: float,
                 seed: int = 0, deterministic_steps: Optional[List[int]] = None):
        from ..core.analytical import cluster_failure_rate
        self.rate_per_step = cluster_failure_rate(cluster) * step_minutes
        self.p_systematic = (
            cluster.systematic_failure_fraction * cluster.systematic_failure_rate
            / max(cluster.expected_failures_per_minute()
                  / max(cluster.job_size, 1), 1e-30)) if cluster.job_size else 0.0
        self.rng = np.random.default_rng(seed)
        self.deterministic_steps = set(deterministic_steps or [])
        self.events: List[FailureEvent] = []

    def check(self, step: int) -> Optional[FailureEvent]:
        if step in self.deterministic_steps:
            # one-shot: after the restart replays this step, don't re-fail
            self.deterministic_steps.discard(step)
            ev = FailureEvent(step, "injected", time.time())
            self.events.append(ev)
            return ev
        if self.rate_per_step > 0 and \
                self.rng.random() < 1.0 - math.exp(-self.rate_per_step):
            kind = "systematic" if self.rng.random() < 0.5 else "random"
            ev = FailureEvent(step, kind, time.time())
            self.events.append(ev)
            return ev
        return None


@dataclass
class StragglerPolicy:
    """Detect slow steps; the mitigation mirrors the DES scheduler's
    standby swap (evict slow host, swap warm standby, no host selection).

    threshold: step slower than ``threshold`` x running median counts as a
    straggler; ``patience`` consecutive stragglers trigger mitigation.
    """
    threshold: float = 2.0
    patience: int = 3
    window: int = 32
    _times: List[float] = field(default_factory=list)
    _strikes: int = 0
    n_stragglers: int = 0
    n_mitigations: int = 0

    def observe(self, step_time: float) -> bool:
        """Returns True when mitigation (host swap) should fire."""
        self._times.append(step_time)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 8:
            return False
        median = float(np.median(self._times[:-1]))
        if step_time > self.threshold * median:
            self.n_stragglers += 1
            self._strikes += 1
            if self._strikes >= self.patience:
                self._strikes = 0
                self.n_mitigations += 1
                return True
        else:
            self._strikes = 0
        return False


@dataclass
class ElasticState:
    """Tracks data-parallel capacity for elastic re-meshing."""
    n_replicas: int
    n_failed: int = 0
    relowered: int = 0

    def shrink(self) -> int:
        """Lose one data replica (node group); returns the new count."""
        if self.n_replicas <= 1:
            raise RuntimeError("cannot shrink below one replica")
        self.n_failed += 1
        self.n_replicas -= 1
        return self.n_replicas


class RecoveryStats:
    """Accounting mirroring RunResult for the live trainer."""

    def __init__(self):
        self.n_failures = 0
        self.n_restores = 0
        self.lost_steps = 0
        self.recovery_wall_s = 0.0
        self.straggler_mitigations = 0

    def overhead_fraction(self, useful_steps: int, step_time_s: float) -> float:
        total = useful_steps * step_time_s + self.recovery_wall_s \
            + self.lost_steps * step_time_s
        if total <= 0:
            return 0.0
        return 1.0 - useful_steps * step_time_s / total

    def to_dict(self) -> Dict[str, float]:
        return {"n_failures": self.n_failures, "n_restores": self.n_restores,
                "lost_steps": self.lost_steps,
                "recovery_wall_s": self.recovery_wall_s,
                "straggler_mitigations": self.straggler_mitigations}
