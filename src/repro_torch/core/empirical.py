"""Trace-driven empirical hazards: piecewise-constant fitting + ingestion.

Counterpart of ``src/repro/core/empirical.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

The paper's premise is tuning mitigation knobs against a cluster's
*measured* failure behavior, but measured MTTF / failure-category data
(Meta's "Revisiting Reliability", the Lablup 504-GPU report) matches no
closed-form family.  This module closes that gap with a generic
piecewise-constant hazard:

    h(t) = rates[i]   for  edges[i-1] <= t < edges[i]

with ``edges`` the interior breakpoints (length ``len(rates) - 1``; the
first segment starts at 0, the last extends to infinity).  Every
segment has a trivial *exact* majorant (its own rate), so the
vectorized engine's Ogata thinning needs no per-family math (the
reference's ``PiecewiseConstantSampler``; on the port, ROADMAP queue 1
item 7).

Three layers live here:

* :class:`Empirical` — a mean-parameterized :class:`Distribution`
  (registered as ``"empirical"``) whose shape is the fitted segment
  profile and whose time axis is rescaled so the realized mean equals
  the configured one (``random_failure_rate`` / ``auto_repair_time``
  keep their usual meaning).  Pass the fitted profile verbatim by
  setting the rate to ``1 / fit.mean``.
* :func:`fit_piecewise_hazard` — Nelson–Aalen or binned-exposure rate
  estimation from raw duration samples, with quantile bin edges by
  default (equal event counts per segment).
* :func:`from_log` / :func:`from_mttf_table` — ingestion of simple
  timestamped CSV/JSONL event logs and published MTTF tables.

Example: fit an exponential-ish log and recover a flat hazard::

    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> fit = fit_piecewise_hazard(rng.exponential(100.0, 4000), n_bins=4)
    >>> bool(np.all(np.abs(np.array(fit.rates) * 100.0 - 1.0) < 0.2))
    True
    >>> abs(fit.mean / 100.0 - 1.0) < 0.1
    True
"""

from __future__ import annotations

import csv
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .distributions import Distribution, register_distribution

__all__ = [
    "Empirical", "PiecewiseFit", "fit_piecewise_hazard", "from_log",
    "from_mttf_table", "segments_mean", "validate_segments",
    "pad_segments",
]


# ---------------------------------------------------------------------------
# segment math (numpy, host-side)
# ---------------------------------------------------------------------------

def _sanitize(edges: Sequence[float], rates: Sequence[float]):
    """Clamp a (possibly degenerate) segment spec into non-crashing form.

    Negative / non-finite rates clamp to 0 and out-of-order edges become
    zero-width segments — sampling from a degenerate spec must complete
    (the event engine runs it after ``hazard_kind`` refuses the fast
    path), it just is not fast-path eligible.
    """
    e = np.asarray(edges, dtype=float).ravel()
    r = np.asarray(rates, dtype=float).ravel()
    r = np.where(np.isfinite(r), r, 0.0)
    r = np.maximum(r, 0.0)
    lo = np.concatenate([[0.0], e])
    hi = np.concatenate([e, [np.inf]])
    w = np.maximum(hi - lo, 0.0)
    return lo, w, r


def segments_mean(edges: Sequence[float], rates: Sequence[float]) -> float:
    """Mean of the piecewise-constant-hazard distribution (∫ S(t) dt).

    Returns ``inf`` for defective specs (zero hazard on an infinite
    tail with survival mass left) and ``nan``-free output always.

    >>> segments_mean([], [0.01])            # one segment == exponential
    100.0
    >>> segments_mean([10.0], [0.0, 0.5])    # failure-free warmup
    12.0
    """
    lo, w, r = _sanitize(edges, rates)
    if r.size == 0:
        return math.inf
    mean, surv = 0.0, 1.0
    for w_i, r_i in zip(w, r):
        if surv <= 0.0:
            break
        if r_i > 0.0:
            if math.isinf(w_i):
                mean += surv / r_i
                surv = 0.0
            else:
                decay = math.exp(-r_i * w_i)
                mean += surv * (1.0 - decay) / r_i
                surv *= decay
        else:
            if math.isinf(w_i):
                return math.inf
            mean += surv * w_i
    return float(mean)


def validate_segments(edges: Sequence[float], rates: Sequence[float]) -> bool:
    """True iff (edges, rates) define a fast-path-eligible hazard.

    Requirements: at least one segment, ``len(edges) == len(rates) - 1``,
    strictly increasing positive finite edges, finite non-negative
    rates, and a *positive terminal rate* (defective hazards — survival
    plateaus — stay on the event engine so repair slots cannot wedge on
    an infinite quantile).

    >>> validate_segments([10.0, 20.0], [0.5, 0.1, 0.2])
    True
    >>> validate_segments([10.0, 10.0], [0.5, 0.1, 0.2])  # duplicate edge
    False
    >>> validate_segments([], [])                          # empty
    False
    """
    e = np.asarray(edges, dtype=float).ravel()
    r = np.asarray(rates, dtype=float).ravel()
    if r.size < 1 or e.size != r.size - 1:
        return False
    if not (np.all(np.isfinite(r)) and np.all(r >= 0.0)):
        return False
    if r[-1] <= 0.0:
        return False
    if e.size:
        if not np.all(np.isfinite(e)) or e[0] <= 0.0:
            return False
        if np.any(np.diff(e) <= 0.0):
            return False
    return True


def pad_segments(edges: np.ndarray, rates: np.ndarray, n_segments: int,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a valid segment spec to exactly ``n_segments`` segments.

    Padding repeats the terminal rate over synthetic trailing edges, so
    the hazard function is unchanged — this is how clocks with fewer
    fitted segments join one batch keyed on the maximum segment count.

    >>> e, r = pad_segments(np.array([5.0]), np.array([2.0, 1.0]), 4)
    >>> e.tolist(), r.tolist()
    ([5.0, 6.0, 7.0], [2.0, 1.0, 1.0, 1.0])
    """
    e = np.asarray(edges, dtype=float).ravel()
    r = np.asarray(rates, dtype=float).ravel()
    if r.size >= n_segments:
        return e, r
    extra = n_segments - r.size
    last = e[-1] if e.size else 1.0
    new_edges = last + np.arange(1, extra + 1, dtype=float)
    tail = r[-1] if r.size else 0.0
    return (np.concatenate([e, new_edges]),
            np.concatenate([r, np.full(extra, tail)]))


def sample_piecewise(exp_draw: float, edges: Sequence[float],
                     rates: Sequence[float]) -> float:
    """Invert the cumulative hazard: smallest t with H(t) >= exp_draw.

    Exact (closed form per segment); tolerates degenerate specs by
    sanitizing first.  Returns ``inf`` when the total hazard is
    exhausted before the target (defective tail).

    >>> sample_piecewise(0.5, [], [0.01])    # exponential reduction
    50.0
    """
    lo, w, r = _sanitize(edges, rates)
    if r.size == 0:
        return math.inf
    seg_h = np.where(r > 0.0, r * w, 0.0)          # 0 * inf stays 0
    cs = np.cumsum(seg_h)
    c_prev = np.concatenate([[0.0], cs[:-1]])
    j = int(np.searchsorted(cs, exp_draw, side="right"))
    if j >= r.size:
        return math.inf
    return float(lo[j] + (exp_draw - c_prev[j]) / r[j])


# ---------------------------------------------------------------------------
# the registered distribution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Empirical(Distribution):
    """Piecewise-constant-hazard distribution fit from measured data.

    ``edges`` / ``rates`` describe the fitted *shape*; like every other
    registered family the instance is parameterized by its mean, so the
    time axis is rescaled by ``mean_value / shape_mean`` (a pure scale
    family: edges stretch, rates shrink).  Feeding the fit back
    verbatim therefore means setting the configured rate to
    ``1 / fit.mean``.

    Implements the ``hazard_segments()`` fast-path protocol: any
    registered distribution exposing it (returning absolute
    ``(edges, rates)`` arrays, or None for a never-firing clock) runs on
    the vectorized CTMC engine — this absorbs the old "user-registered
    distributions are event-engine-only" carve-out.

    >>> d = Empirical(mean_value=50.0, edges=(), rates=(0.02,))
    >>> d.mean, d.n_segments, d.shape_ok
    (50.0, 1, True)
    >>> e, r = d.hazard_segments()
    >>> r.tolist()                 # rescaled so the mean is 50, not 1/0.02
    [0.02]
    """

    mean_value: float
    edges: Tuple[float, ...] = ()
    rates: Tuple[float, ...] = ()

    @property
    def n_segments(self) -> int:
        return len(self.rates)

    @property
    def shape_mean(self) -> float:
        return segments_mean(self.edges, self.rates)

    @property
    def shape_ok(self) -> bool:
        """Structurally valid shape with a finite, positive mean."""
        if not validate_segments(self.edges, self.rates):
            return False
        m0 = self.shape_mean
        return math.isfinite(m0) and m0 > 0.0

    @property
    def _disabled(self) -> bool:
        return self.mean_value <= 0.0 or math.isinf(self.mean_value) \
            or math.isnan(self.mean_value)

    @property
    def time_scale(self) -> float:
        """Stretch factor mapping the fitted shape onto ``mean_value``."""
        if self._disabled:
            return 0.0
        m0 = self.shape_mean
        if not (math.isfinite(m0) and m0 > 0.0):
            return 1.0      # degenerate shape: use verbatim (event engine)
        return self.mean_value / m0

    def hazard_segments(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Absolute (edges, rates) after mean rescaling; None = disabled."""
        if self._disabled:
            return None
        s = self.time_scale
        return (np.asarray(self.edges, dtype=float) * s,
                np.asarray(self.rates, dtype=float) / s)

    def sample(self, rng: np.random.Generator) -> float:
        if self._disabled:
            return math.inf
        s = self.time_scale
        draw = rng.exponential()
        return s * sample_piecewise(draw, self.edges, self.rates)

    @property
    def mean(self) -> float:
        return float(self.mean_value)


def _make_empirical(mean, edges=(), rates=(), **_):
    return Empirical(
        mean_value=mean,
        edges=tuple(float(x) for x in np.asarray(edges, dtype=float).ravel()),
        rates=tuple(float(x) for x in np.asarray(rates, dtype=float).ravel()))


register_distribution("empirical", _make_empirical)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PiecewiseFit:
    """A fitted piecewise-constant hazard, ready to drop into Params.

    ``Params(failure_distribution="empirical",
             random_failure_rate=fit.rate,
             distribution_kwargs=fit.distribution_kwargs)``
    reproduces the fitted hazard verbatim on either engine.
    """

    edges: Tuple[float, ...]
    rates: Tuple[float, ...]
    mean: float
    n_events: int
    method: str = "nelson-aalen"

    @property
    def rate(self) -> float:
        """Rate whose mean matches the fit (``1 / mean``)."""
        return 1.0 / self.mean if math.isfinite(self.mean) and self.mean > 0 \
            else 0.0

    @property
    def distribution_kwargs(self) -> Dict[str, List[float]]:
        return {"edges": list(self.edges), "rates": list(self.rates)}

    def to_json(self) -> Dict[str, object]:
        return {"edges": list(self.edges), "rates": list(self.rates),
                "mean": self.mean, "rate": self.rate,
                "n_events": self.n_events, "method": self.method}

    @classmethod
    def from_json(cls, blob: Dict[str, object]) -> "PiecewiseFit":
        return cls(edges=tuple(float(x) for x in blob["edges"]),
                   rates=tuple(float(x) for x in blob["rates"]),
                   mean=float(blob["mean"]),
                   n_events=int(blob.get("n_events", 0)),
                   method=str(blob.get("method", "nelson-aalen")))


def _auto_edges(durations: np.ndarray, n_bins: int) -> np.ndarray:
    """Quantile (equal-event-count) interior edges over the data range."""
    if n_bins < 2:
        return np.empty(0)
    qs = np.quantile(durations, np.linspace(0.0, 1.0, n_bins + 1)[1:-1])
    qs = qs[(qs > 0.0) & (qs < durations.max())]
    return np.unique(qs)


def fit_piecewise_hazard(durations: Sequence[float], n_bins: int = 8,
                         method: str = "nelson-aalen",
                         edges: Optional[Sequence[float]] = None,
                         censored: Sequence[float] = (),
                         ) -> PiecewiseFit:
    """Fit a piecewise-constant hazard to observed durations.

    ``method="nelson-aalen"``: the Nelson–Aalen cumulative-hazard
    estimator (jumps of 1/R(t) at each event, R the at-risk count,
    right-censored observations contributing risk only), binned into a
    rate per segment.  ``method="binned"``: events / total exposure per
    bin — the piecewise-exponential MLE.  Both agree on large samples.

    The terminal segment extends the last observed positive rate to
    infinity (standard practice; it also keeps the fitted mean finite,
    which the mean-parameterized :class:`Empirical` family requires).

    >>> fit = fit_piecewise_hazard([5.0, 7.0, 11.0, 23.0], n_bins=1)
    >>> len(fit.rates), len(fit.edges)
    (1, 0)
    """
    d = np.asarray(durations, dtype=float).ravel()
    d = d[np.isfinite(d) & (d > 0.0)]
    if d.size == 0:
        raise ValueError("fit_piecewise_hazard: no positive finite durations")
    c = np.asarray(censored, dtype=float).ravel()
    c = c[np.isfinite(c) & (c > 0.0)]
    if edges is None:
        e = _auto_edges(d, n_bins)
    else:
        e = np.unique(np.asarray(edges, dtype=float).ravel())
        e = e[(e > 0.0) & np.isfinite(e)]
    lo = np.concatenate([[0.0], e])
    hi = np.concatenate([e, [np.inf]])
    horizon = max(float(d.max()), float(c.max()) if c.size else 0.0)
    # effective width of the (half-open) terminal bin: up to the last
    # observation — beyond it there is no information, the terminal
    # rate is simply held constant
    width = np.minimum(hi, horizon) - lo
    width = np.maximum(width, 0.0)

    if method == "nelson-aalen":
        allobs = np.concatenate([d, c])
        # risk set at each event time (ties share the pre-tie risk set)
        risk = np.array([(allobs >= t).sum() for t in d], dtype=float)
        jumps = 1.0 / np.maximum(risk, 1.0)
        which = np.searchsorted(e, d, side="right")
        d_h = np.bincount(which, weights=jumps, minlength=lo.size)
        rates = np.divide(d_h, width, out=np.zeros_like(d_h),
                          where=width > 0.0)
    elif method == "binned":
        which = np.searchsorted(e, d, side="right")
        events = np.bincount(which, minlength=lo.size).astype(float)
        allobs = np.concatenate([d, c])
        exposure = np.maximum(
            np.minimum(allobs[:, None], hi[None, :]) - lo[None, :],
            0.0).sum(axis=0)
        rates = np.divide(events, exposure, out=np.zeros_like(events),
                          where=exposure > 0.0)
    else:
        raise ValueError(f"unknown fit method {method!r} "
                         "(known: nelson-aalen, binned)")

    # hold the last *positive* rate on the infinite tail so the fit is
    # non-defective (validate_segments requires a positive terminal rate)
    pos = np.nonzero(rates > 0.0)[0]
    tail = rates[pos[-1]] if pos.size else 1.0 / float(d.mean())
    if rates[-1] <= 0.0:
        rates[-1] = tail
    mean = segments_mean(e, rates)
    return PiecewiseFit(edges=tuple(float(x) for x in e),
                        rates=tuple(float(x) for x in rates),
                        mean=float(mean), n_events=int(d.size),
                        method=method)


# ---------------------------------------------------------------------------
# ingestion: timestamped event logs + published MTTF tables
# ---------------------------------------------------------------------------

_ENTITY_FIELDS = ("server", "host", "node", "entity", "id")


def _read_rows(path: str) -> List[Dict[str, object]]:
    ext = os.path.splitext(path)[1].lower()
    rows: List[Dict[str, object]] = []
    with open(path, "r", encoding="utf-8") as fh:
        if ext in (".jsonl", ".ndjson", ".json"):
            for line in fh:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        else:
            rows.extend(dict(r) for r in csv.DictReader(fh))
    return rows


def from_log(path: str, event: Optional[str] = None,
             time_field: str = "time", duration_field: str = "duration",
             entity_field: Optional[str] = None) -> np.ndarray:
    """Read durations from a simple timestamped CSV or JSONL event log.

    Format: one record per event — a CSV with a header row, or one JSON
    object per line (``.jsonl`` / ``.ndjson``).  Recognized fields:

    * ``duration`` — used directly when present (e.g. repair times);
    * ``time`` — event timestamp in minutes; durations are the gaps
      between consecutive events, per entity when a ``server`` / ``host``
      / ``node`` / ``entity`` / ``id`` column exists (or pass
      ``entity_field``), otherwise over the merged stream;
    * ``event`` / ``kind`` — record type; pass ``event="failure"`` to
      keep only matching records before computing gaps.
    """
    rows = _read_rows(path)
    if event is not None:
        rows = [r for r in rows
                if str(r.get("event", r.get("kind", ""))) == event]
    if not rows:
        raise ValueError(f"from_log: no usable records in {path!r}"
                         + (f" for event={event!r}" if event else ""))

    def _num(value) -> Optional[float]:
        try:
            out = float(value)
        except (TypeError, ValueError):
            return None
        return out if math.isfinite(out) else None

    durs = [_num(r.get(duration_field)) for r in rows]
    durs = [x for x in durs if x is not None and x > 0.0]
    if durs:
        return np.asarray(durs, dtype=float)

    if entity_field is None:
        for cand in _ENTITY_FIELDS:
            if any(cand in r for r in rows):
                entity_field = cand
                break
    groups: Dict[object, List[float]] = {}
    for r in rows:
        t = _num(r.get(time_field))
        if t is None:
            continue
        key = r.get(entity_field) if entity_field else None
        groups.setdefault(key, []).append(t)
    gaps: List[float] = []
    for times in groups.values():
        times.sort()
        gaps.extend(b - a for a, b in zip(times, times[1:]) if b > a)
    if not gaps:
        raise ValueError(f"from_log: {path!r} yields no positive durations "
                         f"(need a {duration_field!r} column or >= 2 "
                         f"timestamps per entity)")
    return np.asarray(gaps, dtype=float)


def from_mttf_table(ages: Sequence[float], mttfs: Sequence[float],
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Convert a published age-bucketed MTTF table to (edges, rates).

    ``ages`` are bucket start times (first must be 0, strictly
    increasing); ``mttfs`` the per-bucket mean time to failure.  The
    hazard in each bucket is ``1 / mttf``.

    >>> e, r = from_mttf_table([0.0, 100.0], [50.0, 200.0])
    >>> e.tolist(), r.tolist()
    ([100.0], [0.02, 0.005])
    """
    a = np.asarray(ages, dtype=float).ravel()
    m = np.asarray(mttfs, dtype=float).ravel()
    if a.size != m.size or a.size == 0:
        raise ValueError("from_mttf_table: ages and mttfs must be equal, "
                         "non-empty lengths")
    if a[0] != 0.0 or (a.size > 1 and np.any(np.diff(a) <= 0.0)):
        raise ValueError("from_mttf_table: ages must start at 0 and be "
                         "strictly increasing")
    if np.any(~np.isfinite(m)) or np.any(m <= 0.0):
        raise ValueError("from_mttf_table: mttfs must be positive and finite")
    return a[1:], 1.0 / m
