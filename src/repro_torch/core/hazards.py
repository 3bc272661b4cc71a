"""Hazard helpers of the port's CTMC engine: host columns and torch math.

Counterpart of ``src/repro/core/hazards.py`` for the failure side.  The
event engine samples a non-exponential failure by drawing one fresh
time-to-failure per running server at every compute-phase start; the
minimum of ``n`` iid draws with per-server hazard ``h(t)`` is one
first-passage time with hazard ``n * h(t)``, where ``t`` is the *phase
age* (compute minutes since the job last restarted).  So the CTMC state
carries one ``age`` per replica, and each family races its failures as
the reference does:

* **Weibull** -- exact conditional inversion.  Every clock shares the
  shape ``k``, so the fleet's cumulative hazard is ``C * t**k`` with
  ``C = sum_i lam_i**-k``, and the time to the next failure from age
  ``a`` is ``(a**k + E / C)**(1/k) - a`` with ``E ~ Exp(1)``.  It enters
  the race as a fourth residual; the failing class is picked from the
  age-invariant hazard shares with the race's unused ``u_pick``.
* **Bathtub** -- Ogata thinning against the endpoint majorant
  ``g_bar = max(g(a), g(a + W))`` of the convex shape ``g``, a window
  expiry ``W`` raced as a phantom residual, and acceptance with
  probability ``g(a + dt) / g_bar``.
* **Lognormal** -- thinning against the hazard at the mode clipped into
  the window (the hazard is unimodal); the mode of a unit-scale clock is
  located host-side once per sigma.  The random and systematic clocks
  thin separately.
* **Empirical** -- piecewise-constant hazards thinned with the exact
  majorant (the current segment rate) over a window that runs to the
  next segment edge of either clock.

Non-exponential repairs (Weibull, lognormal, deterministic, empirical)
run on a per-replica repair-slot lane: a diagnosed failure's server takes
a free slot with its automated-stage duration, drawn by exact inverse CDF
(the samplers' ``quantile``) at shop entry, when the event engine's
``RepairShop`` draws it; an escalation re-arms the slot with a manual-stage
draw.  The slot lane is auto-sized from :func:`expected_repair_occupancy`.

The classifier (:func:`hazard_kind`, :func:`repair_kind`) is the
reference's, so the port knows exactly which Params the reference's CTMC
engine runs.  Host helpers build the per-point parameter columns, equal
to the reference's float32 for float32; the torch helpers evaluate the
hazards and quantiles inside the plain step
(:func:`repro_torch.core.vectorized._step_u`), whose chunk kernel
``csrc/ctmc_chunk.cu`` repeats the same operations.
"""

from __future__ import annotations

import math
import warnings
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .bathtub import Bathtub
from .distributions import (Deterministic, LogNormal, Weibull,
                            failure_distribution)
from .empirical import Empirical, pad_segments, validate_segments
from .params import Params

#: failure-hazard families the CTMC engine runs, in the chunk kernel's
#: code order (``csrc/ctmc_chunk.cu``'s ``Kind``)
HAZARD_KINDS = ("exponential", "weibull", "bathtub", "lognormal",
                "empirical")

#: repair families the CTMC engine runs, in the chunk kernel's code order
#: (``csrc/ctmc_chunk.cu``'s ``RepairKind``).  Exponential keeps the
#: count-based repair compartments (memoryless, no per-server state); the
#: others run the repair-slot lane with durations drawn at entry.
REPAIR_KINDS = ("exponential", "weibull", "lognormal", "deterministic",
                "empirical")

#: hazard parameter columns after the 16 base columns.  By family:
#:   weibull   : [C_rand, C_sys, k, 0, 0]        C = lam**-k per clock
#:   bathtub   : [infant_factor, infant_tau, wear_start, wear_tau, window]
#:   lognormal : [scale_rand, scale_sys, sigma, mode_rel, window]
#:   exponential : all zeros (unused)
#: The empirical block depends on the segment count m instead:
#:   empirical : [rand_edges (m-1), rand_rates (m),
#:                sys_edges (m-1), sys_rates (m)]      (4m - 2 columns)
N_HAZARD_COLS = 5

#: repair parameter columns after the hazard columns.  By family:
#:   weibull       : [lam_auto, lam_manual, k]     (the stage scales)
#:   lognormal     : [scale_auto, scale_manual, sigma]
#:   deterministic : [value_auto, value_manual, 0]
#:   exponential   : all zeros (unused)
#: The empirical block is [auto_edges (m-1), auto_rates (m), manual_edges
#: (m-1), manual_rates (m)] instead.  A zero scale marks a disabled stage.
N_REPAIR_COLS = 3


def hazard_col_count(kind: Optional[str], n_segments: int = 0) -> int:
    """Width of the hazard-column block for this family.

    >>> hazard_col_count("weibull")
    5
    >>> hazard_col_count("empirical", 4)
    14
    """
    return 4 * n_segments - 2 if kind == "empirical" else N_HAZARD_COLS


def repair_col_count(kind: Optional[str], n_segments: int = 0) -> int:
    """Width of the repair-column block for this family."""
    return 4 * n_segments - 2 if kind == "empirical" else N_REPAIR_COLS


#: fraction of the fastest bathtub time constant used as the thinning
#: window W: small enough that the endpoint majorant stays tight
#: (rejection fraction ~W/tau), large enough that window-expiry phantom
#: events are rare next to real cluster events.
BATHTUB_WINDOW_FRACTION = 0.25

#: lognormal thinning window, as a fraction of the earliest enabled
#: clock's hazard-mode time -- the scale on which the hazard varies.
LOGNORMAL_WINDOW_FRACTION = 0.25

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


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


def _padded_pair_count(d_a, d_b) -> int:
    """Shared segment count for a pair of piecewise-constant clocks.

    The max over both clocks' fitted counts, floored at 2 so the edge
    blocks are never zero-width (a genuinely single-segment builtin
    hazard never reaches here -- it collapses to the exponential
    program in dispatch).
    """
    n = 1
    for d in (d_a, d_b):
        seg = _clock_segments(d)
        if isinstance(seg, tuple):
            n = max(n, len(seg[1]))
    return max(n, 2)


def hazard_segment_count(params: Params) -> int:
    """The empirical failure program's segment count (else 0).

    It sizes the column block and groups a sweep; the edges and rates
    themselves are columns, so fits from different log slices share a
    batch as long as their (padded) segment counts agree.
    """
    if hazard_kind(params) != "empirical":
        return 0
    return _padded_pair_count(
        _build_distribution(params, params.random_failure_rate),
        _build_distribution(params, params.systematic_failure_rate))


def repair_segment_count(params: Params) -> int:
    """The empirical repair program's segment count (else 0)."""
    if repair_kind(params) != "empirical":
        return 0
    auto, man = _build_repair_distributions(params)
    return _padded_pair_count(auto, man)


def _pair_segment_columns(d_a, d_b, m: int) -> np.ndarray:
    """``[a_edges (m-1), a_rates (m), b_edges (m-1), b_rates (m)]``.

    Disabled clocks become all-zero rates over synthetic edges (zero
    hazard never fires); shorter fits pad by repeating the terminal
    rate, which leaves the hazard function unchanged.
    """
    blocks = []
    for d in (d_a, d_b):
        seg = _clock_segments(d)
        if isinstance(seg, tuple):
            e, r = pad_segments(seg[0], seg[1], m)
        else:
            e, r = np.arange(1.0, m), np.zeros(m)
        blocks.extend([e, r])
    return np.concatenate(blocks).astype(np.float32)


def _weibull_clock_coeff(w: Weibull) -> float:
    """``lam**-k`` for a mean-parameterized Weibull clock; 0 for a
    disabled clock (infinite mean, i.e. zero rate)."""
    lam = w.lam
    return 0.0 if lam <= 0.0 else lam ** -w.k


def _lognormal_log_hazard_host(logt: float, sigma: float) -> float:
    """Host-side unit-scale log hazard ``log h(e^logt)`` (scipy).

    Must mirror :func:`lognormal_hazard` (the torch twin evaluated in the
    step) term for term: mode location and step budgeting read this
    one, the thinning acceptance reads the torch one.
    """
    from scipy.special import log_ndtr as np_log_ndtr

    z = logt / sigma
    return -0.5 * z * z - _LOG_SQRT_2PI - np_log_ndtr(-z) \
        - math.log(sigma) - logt


@lru_cache(maxsize=64)
def _lognormal_mode_rel(sigma: float) -> float:
    """Hazard-mode time of a unit-scale lognormal, located numerically.

    The lognormal hazard ``h(t) = phi(z) / (sigma * t * Phi(-z))`` with
    ``z = ln(t) / sigma`` is unimodal (Sweet 1990), so a ternary search
    on ``log t`` finds its argmax.  The result scales to any clock as
    ``t_mode = scale * mode_rel(sigma)``; cached per sigma.
    """
    lo, hi = -40.0 * sigma - 5.0, 40.0 * sigma + 5.0
    for _ in range(200):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        if _lognormal_log_hazard_host(m1, sigma) \
                < _lognormal_log_hazard_host(m2, sigma):
            lo = m1
        else:
            hi = m2
    return math.exp(0.5 * (lo + hi))


def _lognormal_peak_hazard(scale: float, sigma: float) -> float:
    """``max_t h(t)`` for a lognormal clock, host-side (scale family:
    ``h_scale(t) = h_1(t / scale) / scale``)."""
    if scale <= 0.0:
        return 0.0
    logt_mode = math.log(_lognormal_mode_rel(sigma))
    return math.exp(_lognormal_log_hazard_host(logt_mode, sigma)) / scale


def hazard_columns(params: Params) -> np.ndarray:
    """Per-point failure-hazard parameter columns.

    Shape ``(hazard_col_count(kind, n_segments),)`` float32, read off the
    same distribution objects the event engine samples from.
    """
    kind = hazard_kind(params)
    if kind == "empirical":
        return _pair_segment_columns(
            _build_distribution(params, params.random_failure_rate),
            _build_distribution(params, params.systematic_failure_rate),
            hazard_segment_count(params))
    cols = np.zeros(N_HAZARD_COLS, np.float32)
    if kind == "weibull":
        w_rand = _build_distribution(params, params.random_failure_rate)
        w_sys = _build_distribution(params, params.systematic_failure_rate)
        cols[0] = _weibull_clock_coeff(w_rand)
        cols[1] = _weibull_clock_coeff(w_sys)
        cols[2] = w_rand.k
    elif kind == "bathtub":
        bt = _build_distribution(params, params.random_failure_rate)
        cols[0] = bt.infant_factor
        cols[1] = bt.infant_tau
        cols[2] = bt.wear_start
        cols[3] = bt.wear_tau
        cols[4] = BATHTUB_WINDOW_FRACTION * min(bt.infant_tau, bt.wear_tau)
    elif kind == "lognormal":
        ln_rand = _build_distribution(params, params.random_failure_rate)
        ln_sys = _build_distribution(params, params.systematic_failure_rate)
        cols[0] = ln_rand.scale
        cols[1] = ln_sys.scale
        cols[2] = ln_rand.sigma
        cols[3] = _lognormal_mode_rel(ln_rand.sigma)
        scales = [s for s in (ln_rand.scale, ln_sys.scale) if s > 0.0]
        if scales:
            cols[4] = LOGNORMAL_WINDOW_FRACTION * cols[3] * min(scales)
    return cols


def repair_columns(params: Params) -> np.ndarray:
    """Per-point repair parameter columns, float32 (see
    :data:`N_REPAIR_COLS`), read off the distributions the event engine's
    ``RepairShop`` samples from
    (:func:`repro_torch.core.repair.repair_distributions`)."""
    kind = repair_kind(params)
    cols = np.zeros(N_REPAIR_COLS, np.float32)
    if kind in (None, "exponential"):
        return cols
    auto, man = _build_repair_distributions(params)
    if kind == "empirical":
        return _pair_segment_columns(auto, man, repair_segment_count(params))
    if kind == "weibull":
        cols[0], cols[1], cols[2] = auto.lam, man.lam, auto.k
    elif kind == "lognormal":
        cols[0], cols[1], cols[2] = auto.scale, man.scale, auto.sigma
    elif kind == "deterministic":
        cols[0], cols[1] = auto.value, man.value
    return cols


def effective_event_rate(params: Params) -> float:
    """Cluster failure-event rate estimate for step budgeting.

    Failure clocks restart at each compute-phase start, so the age-zero
    hazard, not the long-run mean, governs short phases:

    * weibull -- the exact mean phase length ``Gamma(1 + 1/k) *
      C**(-1/k)``; the budget uses its reciprocal.
    * bathtub -- ``infant_factor`` times the flat rate (an upper bound).
    * lognormal -- thinning *candidates* consume steps and arrive at up
      to the majorant rate, so the fleet-summed peak hazard.
    * empirical -- the fleet-summed peak segment rate per clock.
    * exponential -- the paper's ``expected_failures_per_minute``.
    """
    kind = hazard_kind(params)
    lam = params.expected_failures_per_minute()
    n_bad = params.systematic_failure_fraction * params.job_size
    if kind == "weibull":
        cols = hazard_columns(params)
        c_rand, c_sys, k = float(cols[0]), float(cols[1]), float(cols[2])
        C = params.job_size * c_rand + n_bad * c_sys
        if C <= 0.0:
            return 0.0
        mean_phase = math.gamma(1.0 + 1.0 / k) * C ** (-1.0 / k)
        return 1.0 / max(mean_phase, 1e-12)
    if kind == "bathtub":
        return lam * float(hazard_columns(params)[0])   # g(0) ~ infant_factor
    if kind == "lognormal":
        cols = hazard_columns(params)
        sigma = float(cols[2])
        h_rand = _lognormal_peak_hazard(float(cols[0]), sigma)
        h_sys = _lognormal_peak_hazard(float(cols[1]), sigma)
        return params.job_size * h_rand + n_bad * h_sys
    if kind == "empirical":
        cols = hazard_columns(params)
        m = hazard_segment_count(params)
        peak_rand = float(cols[m - 1:2 * m - 1].max())
        peak_sys = float(cols[3 * m - 2:].max())
        return params.job_size * peak_rand + n_bad * peak_sys
    return lam


def phantom_steps(params: Params) -> int:
    """Extra steps budgeted for thinning phantoms.

    Bathtub and lognormal fire a window-expiry phantom at most every
    ``W`` compute minutes (rejected candidates are in
    :func:`effective_event_rate` already).  The empirical family's
    phantoms are segment-edge re-anchors: (edges below the horizon) x
    (nominal phase count), an over-count.  Weibull inversion has none.
    """
    kind = hazard_kind(params)
    if kind == "empirical":
        cols = hazard_columns(params)
        m = hazard_segment_count(params)
        edges = np.concatenate([cols[:m - 1], cols[2 * m - 1:3 * m - 3]])
        n_edges = int((edges < params.job_length).sum())
        phases = 1 + int(params.expected_failures_per_minute()
                         * params.job_length)
        return n_edges * phases
    if kind not in ("bathtub", "lognormal"):
        return 0
    cols = hazard_columns(params)
    window = float(cols[4])
    if window <= 0.0:
        return 0
    return int(params.job_length / window) + 1


def expected_repair_occupancy(params: Params) -> float:
    """Mean number of servers in the repair shop (Little's law), which
    sizes the repair-slot lane (``vectorized._repair_slots_for``).

    Entry rate = diagnosed failures; time in shop = the automated stage
    plus the escalated manual stage.  The entry rate is an accepted-failure
    estimate: lognormal and empirical failures take the nominal mean rate
    (their :func:`effective_event_rate` is a thinning-candidate bound),
    the other families their :func:`effective_event_rate`.  An estimate,
    not a bound: the caller's margin absorbs the gap, and a full lane is
    counted in ``n_repair_overflow``.
    """
    if hazard_kind(params) in ("lognormal", "empirical"):
        rate = params.expected_failures_per_minute()
    else:
        rate = effective_event_rate(params)
    mean_shop = (params.auto_repair_time
                 + (1.0 - params.automated_repair_probability)
                 * params.manual_repair_time)
    return rate * params.diagnosis_probability * mean_shop


# ---------------------------------------------------------------------------
# torch hazard math (evaluated inside the plain step)
# ---------------------------------------------------------------------------
#
# Each function is the reference's JAX twin, operation for operation, in
# float32.  On a CUDA tensor every operation is one of PyTorch's
# elementwise kernels, which the chunk kernel repeats in the same order
# (see csrc/ctmc_chunk.cu).  Divisors are tensors, never Python floats:
# PyTorch's CUDA division by a host scalar multiplies by its reciprocal.

def bathtub_shape(t, infant_factor, infant_tau, wear_start, wear_tau):
    """Dimensionless bathtub hazard shape ``g(t) = h(t) / h_flat``:
    ``1 + (IF - 1) * exp(-t / tau_i) + relu(t - t_w) / tau_w``.  Convex,
    and ``g >= 1`` (``IF >= 1`` is enforced by :func:`hazard_kind`)."""
    g = 1.0 + (infant_factor - 1.0) * torch.exp(-t / infant_tau)
    return g + (t - wear_start).clamp_min(0.0) / wear_tau


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis, left to right (the chunk
    kernel's order; ``torch.cumsum`` and ``sum`` fix none)."""
    parts = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        parts.append(parts[-1] + x[..., j])
    return torch.stack(parts, dim=-1)


def _pow(x, y):
    """``x ** y`` elementwise in ``x``'s dtype (float32, or float64 for
    the age lane's carve-out).  On CUDA PyTorch calls ``powf`` / ``pow``
    for each element, as the chunk kernel does.  PyTorch's CPU ``pow``
    rounds an element differently by where it falls in the tensor (a
    vectorized body and a scalar tail), so on the CPU float32 runs in
    float64 and float64 in the C library's long double, each rounded
    once, which keeps a point's results the same alone and in a bucketed
    batch."""
    if x.device.type == "cuda":
        return torch.pow(x, y)
    if x.dtype == torch.float64:
        xb, yb = torch.broadcast_tensors(x, torch.as_tensor(y, dtype=x.dtype))
        out = np.power(xb.numpy().astype(np.longdouble),
                       yb.numpy().astype(np.longdouble))
        return torch.from_numpy(np.asarray(out, np.float64))
    return torch.pow(x.double(), y.double()).float()


def weibull_conditional_ttf(age, C, k, exp_draw):
    """Exact time-to-first-failure from phase age ``age``.

    ``C`` is the summed ``lam**-k`` over the active clocks, ``k`` the
    shared shape, ``exp_draw`` an Exp(1) variate; +inf where ``C <= 0``.
    Solves ``C * ((age + s)**k - age**k) = E`` for ``s`` in the age
    lane's dtype (``C`` and ``E`` cast to it, as the reference's
    ``jnp.asarray(C, age.dtype)``; float64 under ``Params.age_dtype``
    closes the large-age cancellation of ``(a**k + E/C)**(1/k) - a``) and
    returns float32 for the race.
    """
    C = C.to(age.dtype)
    exp_draw = exp_draw.to(age.dtype)
    safe_c = C.clamp_min(1e-30)
    target = _pow(age, k) + exp_draw / safe_c
    s = _pow(target, 1.0 / k) - age
    return torch.where(C > 0.0, s.clamp_min(0.0),
                       torch.inf).to(torch.float32)


def lognormal_hazard(t, scale, sigma):
    """Lognormal hazard ``h(t) = f(t) / S(t)``, with ``log_ndtr`` for the
    survival term so the deep right tail stays finite.  ``scale =
    exp(mu)``; a non-positive scale marks a disabled clock (hazard 0)."""
    safe_scale = scale.clamp_min(1e-30)
    safe_t = t.clamp_min(1e-30)
    z = (torch.log(safe_t) - torch.log(safe_scale)) / sigma
    log_h = -0.5 * z * z - _LOG_SQRT_2PI - torch.special.log_ndtr(-z) \
        - torch.log(sigma) - torch.log(safe_t)
    return torch.where(scale > 0.0, torch.exp(log_h), 0.0)


def lognormal_window_majorant(age, window, scale, sigma, mode_rel):
    """``sup h`` over ``[age, age + window]``: the hazard at the mode
    ``scale * mode_rel`` clipped into the window (unimodality)."""
    t_star = torch.minimum(torch.maximum(scale * mode_rel, age),
                           age + window)
    return lognormal_hazard(t_star, scale, sigma)


def _segment_take(values, idx):
    """``values[..., idx]`` at per-replica segment index ``idx``: a shared
    1-D row or one row per replica."""
    if values.ndim == idx.ndim + 1:
        return torch.gather(values, -1, idx[..., None])[..., 0]
    return values[idx]


def piecewise_hazard(t, edges, rates):
    """``h(t)`` of a piecewise-constant hazard: ``edges`` the ``m - 1``
    interior breakpoints, ``rates`` the ``m`` segment rates, either a
    shared row or one row per replica."""
    idx = (t[..., None] >= edges).sum(-1)
    return _segment_take(rates, idx)


def piecewise_next_edge(t, edges):
    """Distance from ``t`` to the nearest edge strictly above it (+inf
    past the last edge): the window over which the current segment rate
    is the exact supremum."""
    gap = torch.where(edges > t[..., None], edges - t[..., None], torch.inf)
    return gap.amin(-1)


def piecewise_window_majorant(age, window, edges, rates):
    """``sup h`` over ``[age, age + window)``: the largest rate of a
    segment the window meets (its end exclusive)."""
    b = age + window
    lo = torch.cat([torch.zeros_like(edges[..., :1]), edges], dim=-1)
    hi = torch.cat([edges, torch.full_like(edges[..., :1], torch.inf)],
                   dim=-1)
    mask = (lo < b[..., None]) & (hi > age[..., None])
    return torch.where(mask, rates, 0.0).amax(-1)


def piecewise_conditional_residual(age, edges, rates, exp_draw):
    """Exact time-to-event from ``age`` given survival: locate the segment
    where the cumulative hazard crosses ``H(age) + E`` and invert
    linearly inside it; +inf when a zero-rate tail exhausts the hazard."""
    e, r = edges, rates
    lo = torch.cat([torch.zeros_like(e[..., :1]), e], dim=-1)
    hi = torch.cat([e, torch.full_like(e[..., :1], torch.inf)], dim=-1)
    width = hi - lo
    seg_h = torch.where(r > 0.0, r * width, 0.0)     # keeps 0 * inf at 0
    # the sums run left to right, as the chunk kernel's do
    cs = _seq_cumsum(seg_h)
    c_prev = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]],
                       dim=-1)
    rb = r.expand(c_prev.shape)
    h_age = _seq_cumsum(rb * torch.minimum(
        (age[..., None] - lo).clamp_min(0.0), width))[..., -1]
    target = h_age + exp_draw
    idx = (cs <= target[..., None]).sum(-1)
    m = r.shape[-1]
    idx_c = idx.clamp(0, m - 1)
    r_j = _segment_take(rb, idx_c)
    lo_j = _segment_take(lo.expand(c_prev.shape), idx_c)
    cp_j = _segment_take(c_prev, idx_c)
    t_star = lo_j + (target - cp_j) / r_j.clamp_min(1e-30)
    s = (t_star - age).clamp_min(0.0)
    return torch.where(idx >= m, torch.inf, s)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

class HazardSampler:
    """Family-specific sampling primitives for the failure and repair races.

    One stateless instance per family.  The failure race consumes
    ``conditional_residual`` (inversion families) or ``majorant`` +
    ``hazard`` (thinning families); ``cols`` is a family-specific tuple
    of parameter columns, documented on each sampler.  The repair-slot
    lane consumes ``quantile``.
    """

    kind: str = "base"

    def conditional_residual(self, age, coeff, shape, exp_draw):
        """Exact time-to-event from ``age`` given survival (Exp(1) draw)."""
        raise NotImplementedError(self.kind)

    def hazard(self, t, cols):
        """Exact hazard at ``t`` (the Ogata acceptance numerator)."""
        raise NotImplementedError(self.kind)

    def majorant(self, age, window, cols):
        """Valid upper bound of the hazard over ``[age, age + window]``."""
        raise NotImplementedError(self.kind)

    def quantile(self, u, scale, shape):
        """Exact inverse CDF: a repair duration drawn at slot entry.

        ``scale`` is the stage's scale column (0 marks a disabled stage:
        +inf, the event engine's infinite-mean convention), ``shape`` the
        family's shape column.
        """
        raise NotImplementedError(self.kind)


class WeibullSampler(HazardSampler):
    kind = "weibull"

    def conditional_residual(self, age, coeff, shape, exp_draw):
        return weibull_conditional_ttf(age, coeff, shape, exp_draw)

    def quantile(self, u, scale, shape):
        q = scale * _pow(-torch.log1p(-u), 1.0 / shape)
        return torch.where(scale > 0.0, q, torch.inf)


class BathtubSampler(HazardSampler):
    kind = "bathtub"
    #: hazard/majorant return the dimensionless g, which scales the
    #: exponential propensities; cols = (infant_factor, infant_tau,
    #: wear_start, wear_tau)

    def hazard(self, t, cols):
        infant_factor, infant_tau, wear_start, wear_tau = cols
        return bathtub_shape(t, infant_factor, infant_tau, wear_start,
                             wear_tau)

    def majorant(self, age, window, cols):
        # convex g => endpoint bound
        return torch.maximum(self.hazard(age, cols),
                             self.hazard(age + window, cols))


class LognormalSampler(HazardSampler):
    kind = "lognormal"
    #: hazard cols = (scale, sigma); majorant cols = (scale, sigma,
    #: mode_rel), the pre-located unit-scale hazard mode

    def hazard(self, t, cols):
        scale, sigma = cols
        return lognormal_hazard(t, scale, sigma)

    def majorant(self, age, window, cols):
        scale, sigma, mode_rel = cols
        return lognormal_window_majorant(age, window, scale, sigma,
                                         mode_rel)

    def quantile(self, u, scale, shape):
        q = scale * torch.exp(shape * torch.special.ndtri(u))
        return torch.where(scale > 0.0, q, torch.inf)


class DeterministicSampler(HazardSampler):
    kind = "deterministic"

    def quantile(self, u, scale, shape):
        # a fixed duration; 0 is a valid instant repair, as the event
        # engine's Deterministic(0) is
        return scale * torch.ones_like(u)


class PiecewiseConstantSampler(HazardSampler):
    kind = "empirical"
    #: cols = (edges, rates) of ONE clock; the race thins the random and
    #: systematic clocks separately (exact for independent NHPPs)

    def hazard(self, t, cols):
        edges, rates = cols
        return piecewise_hazard(t, edges, rates)

    def majorant(self, age, window, cols):
        edges, rates = cols
        return piecewise_window_majorant(age, window, edges, rates)

    def conditional_residual(self, age, edges, rates, exp_draw):
        return piecewise_conditional_residual(age, edges, rates, exp_draw)

    def quantile(self, u, edges, rates):
        # the repair race passes the stage's (edges, rates) through the
        # (scale, shape) slots; invert H(t) = -log1p(-u) from age 0
        return piecewise_conditional_residual(
            torch.zeros_like(u), edges, rates, -torch.log1p(-u))


#: failure families with sampling machinery (exponential is the plain
#: rate race and needs none)
FAILURE_SAMPLERS = {
    "weibull": WeibullSampler(),
    "bathtub": BathtubSampler(),
    "lognormal": LognormalSampler(),
    "empirical": PiecewiseConstantSampler(),
}

#: repair families the slot lane samples at entry
REPAIR_SAMPLERS = {
    "weibull": WeibullSampler(),
    "lognormal": LognormalSampler(),
    "deterministic": DeterministicSampler(),
    "empirical": PiecewiseConstantSampler(),
}
