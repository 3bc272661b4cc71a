"""Streaming fixed-bin histograms for distribution-level outputs.

The paper's Fig. 2 tunes on recovery/waiting *distributions*, and the
operational studies it cites make checkpoint and spare-capacity decisions
from tail percentiles (p99 ETTF/ETTR), not means.  The event engine keeps
full per-run Python lists, but the vectorized CTMC scan cannot: its exact
per-run ring buffer (``Params.max_run_records``) truncates at multi-year
horizons.  A fixed-bin log-spaced histogram closes that gap — O(bins)
memory per replica, no run-count bound, percentiles exact to one bin
width at any horizon.

Layout (shared by the numpy accumulator here and the in-scan PyTorch
accumulator in :mod:`repro_torch.core.vectorized`):

  * ``edges`` — ``n_bins + 1`` log-spaced boundaries over [low, high);
  * ``counts`` — ``n_bins + 2`` slots: ``counts[0]`` is the underflow bin
    [0, edges[0]), ``counts[i]`` covers [edges[i-1], edges[i]) for
    1 <= i <= n_bins (left-closed / right-open, so a value exactly on an
    edge lands deterministically in the bin it opens), and
    ``counts[n_bins + 1]`` is the overflow bin [edges[-1], inf).

``np.searchsorted(edges, values, side="right")`` maps values to exactly
this indexing, which is why both accumulators agree bit-for-bit on bin
assignment (up to the float32 edge representation the scan carries).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

#: channel order is part of the scan's state layout — the CTMC
#: engine accumulates the subset a :class:`HistogramSpec` selects, in
#: this order.  ``goodput`` (one per-replica fraction per completed job)
#: is opt-in: the default spec tracks the original three duration
#: channels so the default state layout stays as it was.
HIST_CHANNELS: Tuple[str, ...] = ("run_duration", "recovery", "waiting",
                                  "goodput")

#: the default tracked subset (every duration channel; goodput opt-in)
DEFAULT_CHANNELS: Tuple[str, ...] = ("run_duration", "recovery", "waiting")


@dataclass(frozen=True)
class HistogramSpec:
    """Bin layout + tracked channels for streaming distribution outputs.

    Defaults span 10^-2 .. 10^7 minutes (sub-second to ~19 years) in 128
    log-spaced bins: ~17.6% relative bin width, the resolution floor of
    every reported histogram percentile.  Channels:

      * ``run_duration`` — failure-to-failure useful-compute intervals
        (the ETTF-style metric); one record per completed run.
      * ``recovery``     — failure-to-compute-restart downtime (ETTR):
        recovery + host selection + preemption wait + stall, as incurred.
      * ``waiting``      — replacement-acquisition delay alone (the ETTR
        minus the fixed recovery reload); 0 for standby swaps and
        undiagnosed failures, so mass in the underflow bin is expected.
      * ``goodput``      — opt-in (not in the default subset): each
        completed replica's useful-work / wall-time fraction, one record
        per finished job.  Fractions live in (0, 1], far below the
        default ``low`` edge — pair it with a linear-friendly range such
        as ``HistogramSpec(low=0.01, high=1.0)``.

    Selecting a channel subset leaves the others *out* of the CTMC
    scan state (smaller carry, fewer scatter lanes), not just out of the
    reports; an empty tuple disables the accumulator like
    ``Params(histogram=None)``.

    >>> spec = HistogramSpec(low=1.0, high=100.0, n_bins=2,
    ...                      channels=("run_duration",))
    >>> spec.n_counts            # n_bins + underflow + overflow slots
    4
    >>> [round(float(e), 1) for e in spec.edges()]
    [1.0, 10.0, 100.0]
    >>> h = Histogram.from_values(spec, [0.5, 2.0, 3.0, 42.0, 1e6])
    >>> [int(c) for c in h.counts]          # under, [1,10), [10,100), over
    [1, 2, 1, 1]
    >>> round(h.percentile(50), 2)          # exact to one bin width
    7.75
    """

    low: float = 1e-2
    high: float = 1e7
    n_bins: int = 128
    channels: Tuple[str, ...] = DEFAULT_CHANNELS

    def __post_init__(self):
        # tolerate list input (yaml/json round trips); keep hashable
        object.__setattr__(self, "channels", tuple(self.channels))

    def validate(self) -> None:
        if not 0 < self.low < self.high:
            raise ValueError(
                f"histogram range must satisfy 0 < low < high, got "
                f"[{self.low}, {self.high})")
        if self.n_bins < 1:
            raise ValueError("histogram n_bins must be >= 1")
        unknown = set(self.channels) - set(HIST_CHANNELS)
        if unknown:
            raise ValueError(f"unknown histogram channels {sorted(unknown)}; "
                             f"available: {HIST_CHANNELS}")

    @property
    def n_counts(self) -> int:
        """Count slots including the underflow and overflow bins."""
        return self.n_bins + 2

    def edges(self) -> np.ndarray:
        """Log-spaced bin boundaries, shape (n_bins + 1,)."""
        return np.geomspace(self.low, self.high, self.n_bins + 1)

    @classmethod
    def from_dict(cls, d: Dict) -> "HistogramSpec":
        return cls(**d)


SpecOrEdges = Union[HistogramSpec, np.ndarray, Sequence[float]]


def _as_edges(spec_or_edges: SpecOrEdges) -> np.ndarray:
    if isinstance(spec_or_edges, HistogramSpec):
        return spec_or_edges.edges()
    return np.asarray(spec_or_edges, np.float64)


class Histogram:
    """One channel's accumulated counts — the pure-numpy reference.

    The event engine builds these from its per-run Python lists
    (:func:`Histogram.from_values`); the CTMC engine produces the
    identical ``counts`` layout inside the scan.  ``merge`` is
    associative and commutative (it is plain count addition), so
    replica-chunked accumulation order never matters.
    """

    __slots__ = ("edges", "counts")

    def __init__(self, edges: SpecOrEdges,
                 counts: Optional[np.ndarray] = None):
        self.edges = _as_edges(edges)
        if counts is None:
            counts = np.zeros(len(self.edges) + 1, np.float64)
        self.counts = np.asarray(counts, np.float64).copy()
        if self.counts.shape != (len(self.edges) + 1,):
            raise ValueError(
                f"counts shape {self.counts.shape} does not match "
                f"{len(self.edges) + 1} bins (n_bins + under/overflow)")

    @classmethod
    def from_values(cls, spec_or_edges: SpecOrEdges,
                    values: Sequence[float]) -> "Histogram":
        return cls(spec_or_edges).add(values)

    # -- accumulation -----------------------------------------------------
    def add(self, values: Sequence[float]) -> "Histogram":
        """Accumulate values in place; returns self for chaining."""
        vals = np.asarray(list(values) if not isinstance(values, np.ndarray)
                          else values, np.float64)
        if vals.size:
            idx = np.searchsorted(self.edges, vals, side="right")
            np.add.at(self.counts, idx, 1.0)
        return self

    def merge(self, other: "Histogram") -> "Histogram":
        """New histogram with summed counts (associative + commutative)."""
        if not np.array_equal(self.edges, other.edges):
            raise ValueError("cannot merge histograms with different edges")
        return Histogram(self.edges, self.counts + other.counts)

    # -- queries ----------------------------------------------------------
    @property
    def total(self) -> float:
        return float(self.counts.sum())

    def cdf(self) -> np.ndarray:
        """Cumulative fraction at each bin's *upper* edge (monotone)."""
        total = max(self.total, 1.0)
        return np.cumsum(self.counts) / total

    def _bin_bounds(self, i: int) -> Tuple[float, float]:
        """[lower, upper) of count slot i; underflow starts at 0 (all
        tracked channels are non-negative durations)."""
        lo = 0.0 if i == 0 else float(self.edges[i - 1])
        hi = float(self.edges[-1]) if i >= len(self.edges) \
            else float(self.edges[i])
        return lo, hi

    def bin_width_at(self, x: float) -> float:
        """Width of the bin containing x — the resolution of any
        percentile that lands there."""
        i = int(np.searchsorted(self.edges, x, side="right"))
        lo, hi = self._bin_bounds(i)
        return hi - lo

    def percentile(self, q: float) -> float:
        """Percentile estimate, linear interpolation inside the bin.

        Exact to one bin width by construction; the overflow bin reports
        its lower edge (the histogram cannot see beyond ``high``).
        """
        total = self.total
        if total == 0:
            return float("nan")
        target = q / 100.0 * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, len(self.counts) - 1)
        if i == len(self.counts) - 1:        # overflow bin: no upper bound
            return float(self.edges[-1])
        lo, hi = self._bin_bounds(i)
        below = cum[i - 1] if i > 0 else 0.0
        frac = (target - below) / max(self.counts[i], 1e-30)
        return float(lo + min(max(frac, 0.0), 1.0) * (hi - lo))

    def _representatives(self) -> np.ndarray:
        """Per-bin representative values for moment estimates: geometric
        midpoints; half the low edge for underflow, the top edge for
        overflow."""
        e = self.edges
        reps = np.empty(len(self.counts))
        reps[0] = e[0] / 2.0
        reps[1:-1] = np.sqrt(e[:-1] * e[1:])
        reps[-1] = e[-1]
        return reps

    def mean(self) -> float:
        total = self.total
        if total == 0:
            return float("nan")
        return float((self.counts * self._representatives()).sum() / total)

    def std(self) -> float:
        total = self.total
        if total <= 1:
            return 0.0 if total == 1 else float("nan")
        reps = self._representatives()
        m = (self.counts * reps).sum() / total
        var = (self.counts * (reps - m) ** 2).sum() / (total - 1)
        return float(np.sqrt(max(var, 0.0)))

    def minimum(self) -> float:
        nz = np.nonzero(self.counts)[0]
        if nz.size == 0:
            return float("nan")
        return self._bin_bounds(int(nz[0]))[0]

    def maximum(self) -> float:
        nz = np.nonzero(self.counts)[0]
        if nz.size == 0:
            return float("nan")
        return self._bin_bounds(int(nz[-1]))[1]

    def __repr__(self) -> str:
        return (f"Histogram(n_bins={len(self.edges) - 1}, "
                f"total={self.total:.0f}, "
                f"range=[{self.edges[0]:g}, {self.edges[-1]:g}))")


def percentiles_per_row(edges: SpecOrEdges, counts_2d: np.ndarray,
                        q: float) -> np.ndarray:
    """Vectorized :meth:`Histogram.percentile` over a stack of histograms.

    ``counts_2d`` is an ``(R, n_bins + 2)`` matrix of per-replica bin
    counts (the CTMC engine's raw ``hist_{channel}`` output).  Returns
    ``(R,)`` percentile estimates — bit-compatible with building one
    :class:`Histogram` per row and calling ``percentile(q)``, which is
    what the event-engine path does — with NaN for empty rows.  This is
    the workhorse of the cross-replica dispersion statistics
    (``{channel}_p99_replica``): per-replica tail percentiles whose
    spread across replicas measures run-to-run variability, which the
    pooled histogram (one merged distribution) cannot see.
    """
    edges = _as_edges(edges)
    counts = np.asarray(counts_2d, np.float64)
    if counts.ndim != 2 or counts.shape[1] != len(edges) + 1:
        raise ValueError(
            f"counts shape {counts.shape} does not match "
            f"(R, {len(edges) + 1}) for {len(edges)} edges")
    total = counts.sum(axis=1)
    cum = np.cumsum(counts, axis=1)
    target = q / 100.0 * total
    i = np.sum(cum < target[:, None], axis=1)          # searchsorted left
    i = np.minimum(i, counts.shape[1] - 1)
    lo_edges = np.concatenate([[0.0], edges])          # slot lower bounds
    hi_edges = np.concatenate([edges, [edges[-1]]])    # slot upper bounds
    below = np.where(i > 0,
                     np.take_along_axis(cum, np.maximum(i - 1, 0)[:, None],
                                        axis=1)[:, 0], 0.0)
    in_bin = np.take_along_axis(counts, i[:, None], axis=1)[:, 0]
    frac = np.clip((target - below) / np.maximum(in_bin, 1e-30), 0.0, 1.0)
    val = lo_edges[i] + frac * (hi_edges[i] - lo_edges[i])
    # the overflow slot has no upper bound: report its lower edge, the
    # same convention as Histogram.percentile
    val = np.where(i == counts.shape[1] - 1, edges[-1], val)
    return np.where(total > 0, val, np.nan)
