"""Sampling distributions for failure inter-arrival and repair durations.

Counterpart of ``src/repro/core/distributions.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

The paper assumes exponential distributions by default (assumption 2) but
states AIReSim "also supports the Lognormal and Weibull distributions" and
"can be extended with user-specified distributions".  Every distribution here
is parameterized by its *mean* so that swapping distributions holds the mean
occurrence rate fixed — the natural A/B comparison for reliability sweeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np


class Distribution:
    """Base: a sampler of non-negative durations with a defined mean."""

    def sample(self, rng: np.random.Generator) -> float:
        raise NotImplementedError

    @property
    def mean(self) -> float:
        raise NotImplementedError

    def is_memoryless(self) -> bool:
        return False


@dataclass(frozen=True)
class Exponential(Distribution):
    """Exponential with the given *rate* (events per unit time)."""

    rate: float

    def sample(self, rng: np.random.Generator) -> float:
        if self.rate <= 0.0:
            return math.inf
        return float(rng.exponential(1.0 / self.rate))

    @property
    def mean(self) -> float:
        return math.inf if self.rate <= 0 else 1.0 / self.rate

    def is_memoryless(self) -> bool:
        return True


@dataclass(frozen=True)
class Deterministic(Distribution):
    """Fixed duration — used by unit tests for exact-time assertions."""

    value: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(self.value)

    @property
    def mean(self) -> float:
        return float(self.value)


@dataclass(frozen=True)
class LogNormal(Distribution):
    """LogNormal parameterized by its mean and the log-space sigma."""

    mean_value: float
    sigma: float = 1.0

    @property
    def mu(self) -> float:
        """Log-space location for the configured mean (-inf if disabled)."""
        if self.mean_value <= 0 or math.isinf(self.mean_value):
            return -math.inf
        return math.log(self.mean_value) - 0.5 * self.sigma ** 2

    @property
    def scale(self) -> float:
        """``exp(mu)`` — the median; 0 for a disabled (infinite-mean) clock.

        This is the scale-family parameter the vectorized engine traces:
        the hazard satisfies ``h_scale(t) = h_1(t / scale) / scale``.
        """
        mu = self.mu
        return 0.0 if math.isinf(mu) else math.exp(mu)

    def sample(self, rng: np.random.Generator) -> float:
        if self.mean_value <= 0 or math.isinf(self.mean_value):
            return math.inf
        return float(rng.lognormal(self.mu, self.sigma))

    @property
    def mean(self) -> float:
        return float(self.mean_value)


@dataclass(frozen=True)
class Weibull(Distribution):
    """Weibull parameterized by its mean and shape k.

    k < 1 models infant mortality (decreasing hazard), k > 1 wear-out
    (increasing hazard) — the two ends of the paper's bathtub curve.
    """

    mean_value: float
    k: float = 1.5

    @property
    def lam(self) -> float:
        """Weibull scale for the configured mean; 0 for a disabled clock.

        Single source of the mean -> scale conversion for both engines:
        the event sampler below and the vectorized engine's traced
        parameter columns read the same value.
        """
        if self.mean_value <= 0 or math.isinf(self.mean_value):
            return 0.0
        return self.mean_value / math.gamma(1.0 + 1.0 / self.k)

    def sample(self, rng: np.random.Generator) -> float:
        if self.mean_value <= 0 or math.isinf(self.mean_value):
            return math.inf
        return float(self.lam * rng.weibull(self.k))

    @property
    def mean(self) -> float:
        return float(self.mean_value)


# Registry so configs can name distributions by string (yaml-friendly) and
# users can register their own (paper: "extended with user-specified
# distributions").
#: factories accept (and ignore) unrelated kwargs so that one
#: Params.distribution_kwargs dict can serve failure AND repair
#: distributions of different families.
_REGISTRY: Dict[str, Callable[..., Distribution]] = {
    "exponential": lambda mean, **_: Exponential(
        rate=(0.0 if math.isinf(mean) else 1.0 / mean)),
    "deterministic": lambda mean, **_: Deterministic(value=mean),
    "lognormal": lambda mean, sigma=1.0, **_: LogNormal(
        mean_value=mean, sigma=sigma),
    "weibull": lambda mean, k=1.5, **_: Weibull(mean_value=mean, k=k),
}


def register_distribution(name: str, factory: Callable[..., Distribution]) -> None:
    _REGISTRY[name.lower()] = factory


def make_distribution(name: str, mean: float, **kwargs) -> Distribution:
    """Build a duration distribution with the given mean by registry name."""
    try:
        factory = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown distribution {name!r}; known: {sorted(_REGISTRY)}") from None
    return factory(mean, **kwargs)


def failure_distribution(name: str, rate: float, **kwargs) -> Distribution:
    """Build a failure inter-arrival distribution from a *rate* (1/mean)."""
    mean = math.inf if rate <= 0 else 1.0 / rate
    return make_distribution(name, mean, **kwargs)
