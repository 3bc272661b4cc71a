"""Host-side hazard helpers of the CTMC engine.

Counterpart of the host half of ``src/repro/core/hazards.py``.  The
classifier -- :func:`hazard_kind` and :func:`repair_kind`, with the
distribution builders and the ``hazard_segments()`` protocol probe they
use -- is the reference's, so the port knows exactly which Params the
reference's CTMC engine runs and which it sends to the event engine.
The port's CTMC engine runs only the plain exponential families so far:
the samplers and parameter columns of the Weibull, bathtub, lognormal,
empirical and deterministic families are ROADMAP queue 1 items 7-8, and
:func:`repro_torch.core.vectorized.unsupported_reasons` refuses them with
the item.  The column layout keeps the reference's widths, so the
parameter vectors line up column for column.
"""

from __future__ import annotations

import warnings
from functools import lru_cache
from typing import Optional

import numpy as np

from .bathtub import Bathtub
from .distributions import (Deterministic, LogNormal, Weibull,
                            failure_distribution)
from .empirical import Empirical, validate_segments
from .params import Params

#: hazard parameter columns after the 16 base columns (all zero and
#: unused for the exponential family)
N_HAZARD_COLS = 5

#: repair parameter columns after the hazard columns (all zero and
#: unused for exponential repairs)
N_REPAIR_COLS = 3


def hazard_col_count(kind: Optional[str], n_segments: int = 0) -> int:
    """Width of the hazard-column block for this family.

    >>> hazard_col_count("exponential")
    5
    >>> hazard_col_count("empirical", 4)
    14
    """
    return 4 * n_segments - 2 if kind == "empirical" else N_HAZARD_COLS


def repair_col_count(kind: Optional[str], n_segments: int = 0) -> int:
    """Width of the repair-column block for this family."""
    return 4 * n_segments - 2 if kind == "empirical" else N_REPAIR_COLS


def _build_distribution(params: Params, rate: float):
    """The event engine's own distribution object for this failure clock.

    Going through the registry factory keeps every kwarg default in ONE
    place (the :class:`Weibull` / :class:`Bathtub` / :class:`LogNormal`
    dataclasses): if a default is ever retuned there, both engines move
    together instead of the fast path keeping a stale copy.  Returns
    None when construction fails — dispatch treats that as unsupported.
    """
    try:
        return failure_distribution(params.failure_distribution, rate,
                                    **params.distribution_kwargs)
    except (ValueError, TypeError):
        return None


def _build_repair_distributions(params: Params):
    """(auto, manual) repair distributions, or (None, None) on failure."""
    from .repair import repair_distributions
    try:
        return repair_distributions(params)
    except (ValueError, TypeError):
        return None, None


@lru_cache(maxsize=1)
def _scipy_available() -> bool:
    """The lognormal fast path needs scipy host-side (mode location /
    peak hazard via ``scipy.special.log_ndtr``).  If scipy is ever
    absent, the graceful-degrade convention applies: dispatch falls back
    to the event engine instead of committing to the fast path and
    crashing mid-run.  The fallback
    is loud — a one-time RuntimeWarning (the lru_cache makes it fire
    once) — because a mis-provisioned environment silently running the
    O(cluster)-per-restart event engine looks like a perf regression,
    not a packaging problem."""
    try:
        import scipy.special  # noqa: F401
        return True
    except ImportError:
        warnings.warn(
            "scipy is unavailable: lognormal failure hazards cannot run "
            "on the vectorized fast path, so engine='auto' will fall "
            "back to the much slower O(cluster)-per-restart event "
            "engine for them (install scipy to restore the CTMC path)",
            RuntimeWarning, stacklevel=2)
        return False


def _clock_segments(dist):
    """Classify one clock's distribution for the piecewise-constant path.

    Returns ``(edges, rates)`` float arrays for a fast-path-eligible
    clock, the string ``"off"`` for a clock that never fires (disabled
    — ``hazard_segments()`` returned None), or None when the
    distribution is ineligible (no ``hazard_segments()`` protocol, or
    segments that fail :func:`repro_torch.core.empirical.validate_segments`).
    """
    probe = getattr(dist, "hazard_segments", None)
    if probe is None or not callable(probe):
        return None
    try:
        seg = probe()
    except Exception:  # graceful-degrade: user protocol code may raise
        return None
    if seg is None:
        return "off"
    try:
        edges, rates = seg
    except (TypeError, ValueError):
        return None
    if not validate_segments(edges, rates):
        return None
    return (np.asarray(edges, dtype=float), np.asarray(rates, dtype=float))


def _piecewise_pair_kind(d_rand, d_sys) -> Optional[str]:
    """Dispatch for the piecewise-constant path (a pair of clocks).

    Any registered distribution exposing the ``hazard_segments()``
    protocol qualifies — this absorbs the old "user-registered
    distributions are event-engine-only" carve-out.  A single-segment
    builtin :class:`Empirical` is memoryless with rate exactly
    ``1 / mean``, so it collapses to the exponential program
    (bit-identical reduction).
    """
    if d_rand is None or d_sys is None:
        return None
    s_rand = _clock_segments(d_rand)
    s_sys = _clock_segments(d_sys)
    if s_rand is None or s_sys is None:
        return None
    if (isinstance(d_rand, Empirical) and d_rand.n_segments == 1
            and isinstance(d_sys, Empirical) and d_sys.n_segments == 1):
        return "exponential"
    return "empirical"


def hazard_kind(params: Params) -> Optional[str]:
    """The vectorized engine's failure-hazard family, or None.

    None means the failure distribution is outside the fast path and
    the event engine must run it: deterministic failures, and
    registered distributions — including a re-registered builtin name
    that no longer builds the expected class — that do not opt in via
    the ``hazard_segments()`` piecewise-constant protocol.  Degenerate
    parameters (``k <= 0``, non-positive taus, ``infant_factor < 1``
    which would break the ``g >= 1`` acceptance-probability bound,
    ``sigma <= 0``, empty / duplicate / non-monotone empirical segment
    edges, defective zero-rate tails) also return None rather than
    raising.  A single-segment builtin empirical hazard is memoryless
    and returns "exponential" (bit-identical program reduction).
    """
    name = params.failure_distribution.lower()
    if name == "exponential":
        return "exponential"
    dist = _build_distribution(params, params.random_failure_rate)
    if name == "weibull" and isinstance(dist, Weibull):
        return "weibull" if dist.k > 0 else None
    if name == "bathtub" and isinstance(dist, Bathtub):
        ok = (dist.infant_factor >= 1.0 and dist.infant_tau > 0
              and dist.wear_tau > 0)
        return "bathtub" if ok else None
    if name == "lognormal" and isinstance(dist, LogNormal):
        return "lognormal" if dist.sigma > 0 and _scipy_available() else None
    # everything else — the builtin "empirical" family and any registered
    # distribution opting in via the hazard_segments() protocol — runs
    # the piecewise-constant program (None keeps it on the event engine)
    return _piecewise_pair_kind(
        dist, _build_distribution(params, params.systematic_failure_rate))


def repair_kind(params: Params) -> Optional[str]:
    """The vectorized engine's repair family for these Params, or None.

    Mirrors :func:`hazard_kind` for the repair side: None routes the
    point to the event engine (registered families without the
    ``hazard_segments()`` protocol, or degenerate parameters —
    ``k <= 0``, ``sigma <= 0``, invalid empirical segments).  The
    empirical pair here is (auto, manual) rather than (random,
    systematic); a single-segment builtin empirical repair collapses to
    the exponential repair program the same way.
    """
    name = params.repair_distribution.lower()
    if name == "exponential":
        return "exponential"
    auto, man = _build_repair_distributions(params)
    if name == "weibull" and isinstance(auto, Weibull):
        return "weibull" if auto.k > 0 else None
    if name == "lognormal" and isinstance(auto, LogNormal):
        return "lognormal" if auto.sigma > 0 else None
    if name == "deterministic" and isinstance(auto, Deterministic):
        return "deterministic"
    return _piecewise_pair_kind(auto, man)


def hazard_segment_count(params: Params) -> int:
    """Segment count of an empirical failure hazard: 0 on this path."""
    return 0


def repair_segment_count(params: Params) -> int:
    """Segment count of an empirical repair family: 0 on this path."""
    return 0


def hazard_columns(params: Params) -> np.ndarray:
    """Failure-hazard parameter columns: ``N_HAZARD_COLS`` zeros."""
    return np.zeros(N_HAZARD_COLS, np.float32)


def repair_columns(params: Params) -> np.ndarray:
    """Repair parameter columns: ``N_REPAIR_COLS`` zeros."""
    return np.zeros(N_REPAIR_COLS, np.float32)


def effective_event_rate(params: Params) -> float:
    """Cluster failure-event rate for step budgeting: the paper's
    ``expected_failures_per_minute`` under exponential failures."""
    return params.expected_failures_per_minute()


def phantom_steps(params: Params) -> int:
    """Thinning phantom steps to budget: none for exponential hazards."""
    return 0
