"""Bathtub-curve failure model (paper §II-A).

Counterpart of ``src/repro/core/bathtub.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

"Typically, hardware failures follow a classic 'bath-tub' curve, with
most of the systematic issues manifesting at both ends of the curve,
while the flat portion of the curve (operational phase) consists mostly
of random failures.  However, modern hardware is becoming increasingly
difficult to test thoroughly ... systematic failures are becoming more
common even during the operational phase."

This module provides an age-dependent hazard:

    h(t) = h_infant * exp(-t / tau_infant)        (decreasing, early)
         + h_flat                                  (operational)
         + h_wear * max(0, (t - t_wear) / tau_wear)  (increasing, late)

sampled exactly by inversion of the cumulative hazard (closed-form
pieces + numerically inverted total).  Registered as the "bathtub"
failure distribution so a single Params switch turns it on:

    Params(failure_distribution="bathtub",
           distribution_kwargs={"infant_factor": 20, ...})

The mean-preserving parameterization keeps the long-run average rate
equal to the configured failure rate, so bathtub-vs-exponential sweeps
isolate the *shape* effect.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .distributions import Distribution, register_distribution

MINUTES_PER_DAY = 24 * 60


@dataclass(frozen=True)
class Bathtub(Distribution):
    """Age-dependent hazard with infant-mortality and wear-out phases.

    mean_value:    target mean time-to-failure of the *flat* phase
    infant_factor: hazard multiple at t=0 (relative to flat)
    infant_tau:    decay time of the infant phase (minutes)
    wear_start:    onset of wear-out (minutes)
    wear_tau:      time for the wear hazard to reach the flat hazard
    """

    mean_value: float
    infant_factor: float = 10.0
    infant_tau: float = 7.0 * MINUTES_PER_DAY
    wear_start: float = 365.0 * MINUTES_PER_DAY
    wear_tau: float = 90.0 * MINUTES_PER_DAY

    @property
    def _h_flat(self) -> float:
        return 1.0 / self.mean_value

    def hazard(self, t: float) -> float:
        h = self._h_flat
        out = h + (self.infant_factor - 1.0) * h * math.exp(-t / self.infant_tau)
        if t > self.wear_start:
            out += h * (t - self.wear_start) / self.wear_tau
        return out

    def cumulative_hazard(self, t: float) -> float:
        h = self._h_flat
        H = h * t
        H += (self.infant_factor - 1.0) * h * self.infant_tau \
            * (1.0 - math.exp(-t / self.infant_tau))
        if t > self.wear_start:
            dt = t - self.wear_start
            H += h * dt * dt / (2.0 * self.wear_tau)
        return H

    def sample(self, rng: np.random.Generator) -> float:
        """Inverse-CDF via bisection on H(t) = -ln(U) (H is increasing)."""
        if self.mean_value <= 0 or math.isinf(self.mean_value):
            return math.inf
        target = -math.log(max(rng.random(), 1e-300))
        lo, hi = 0.0, self.mean_value
        while self.cumulative_hazard(hi) < target:
            hi *= 2.0
            if hi > 1e12:
                return hi
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if self.cumulative_hazard(mid) < target:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    @property
    def mean(self) -> float:
        return float(self.mean_value)

    def phase_at(self, t: float) -> str:
        if t < 3.0 * self.infant_tau:
            return "infant"
        if t > self.wear_start:
            return "wear-out"
        return "operational"


def _make_bathtub(mean, infant_factor=10.0, infant_tau=7.0 * MINUTES_PER_DAY,
                  wear_start=365.0 * MINUTES_PER_DAY,
                  wear_tau=90.0 * MINUTES_PER_DAY, **_):
    return Bathtub(mean_value=mean, infant_factor=infant_factor,
                   infant_tau=infant_tau, wear_start=wear_start,
                   wear_tau=wear_tau)


register_distribution("bathtub", _make_bathtub)
