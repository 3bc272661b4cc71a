"""Knob optimization on the batched CTMC engine (close-the-loop layer).

Counterpart of ``src/repro/core/optimize.py``.  The paper's stated
purpose is *tuning* the failure/recovery knobs, not just sweeping them.
This module turns batched replication studies into derivative-free
optimizers:

  * :func:`optimize_checkpoint_interval` — coarse grid + golden-section
    refinement over ``Params.checkpoint_interval``, maximizing simulated
    goodput.  Every iteration evaluates its whole candidate set in ONE
    :func:`repro_torch.core.backend.run_replications_batch` call on
    ``device=`` (default the card, where a chunk of 64 steps of the whole
    batch is one chunk-kernel launch), and all candidates share common
    random numbers: the chunk draws are seeded from ``(seed, chunk
    index)`` alone, whatever the number of points, so the sampled
    objective is a deterministic function of the interval and the
    golden-section search converges as on a noiseless function.
  * :func:`optimize_knobs` — cyclic coordinate descent over any set of
    ``Params`` fields (e.g. warm_standbys x spare_pool_size x
    checkpoint_interval); each coordinate pass is again one batched
    call.  Structural fields ride the padded sweep path, so mixed
    pool-size candidate rows share one batch.

Cross-check: in the low-overhead exponential regime the goodput-optimal
interval lands within one grid notch of
:func:`repro_torch.core.analytical.young_daly_interval`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .analytical import cluster_failure_rate, young_daly_interval
from .backend import run_replications_batch
from .params import Params

#: golden ratio conjugate: interior points of a golden-section bracket
_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0


@dataclass(frozen=True)
class CheckpointOptResult:
    """Outcome of :func:`optimize_checkpoint_interval`."""

    interval: float                 #: argmax checkpoint interval (minutes)
    objective: float                #: its simulated objective value
    young_daly: float               #: sqrt(2*C*MTBF) reference interval
    grid: Tuple[float, ...]         #: coarse-stage candidate intervals
    grid_objective: Tuple[float, ...]  #: their simulated objectives
    #: (bracket_low, bracket_high) after each golden-section iteration —
    #: convergence is observable: widths shrink by invphi per iteration
    history: Tuple[Tuple[float, float], ...] = ()
    n_evals: int = 0                #: total simulated candidates


@dataclass(frozen=True)
class KnobOptResult:
    """Outcome of :func:`optimize_knobs`."""

    values: Dict[str, float]        #: best knob assignment
    objective: float                #: its simulated objective value
    #: one (knob, values-tried, objectives) triple per coordinate visit
    history: Tuple[Tuple[str, Tuple[float, ...], Tuple[float, ...]], ...] = ()
    n_evals: int = 0
    converged: bool = True          #: False = hit max_sweeps still moving


def _evaluate(grid: Sequence[Params], n_replicas: int, stat: str,
              engine: str, max_steps: Optional[int],
              device) -> List[float]:
    """Mean ``stat`` per grid point — ONE batched call, CRN across points."""
    reps = run_replications_batch(list(grid), n_replicas, engine=engine,
                                  max_steps=max_steps, device=device)
    return [float(r.stats[stat].mean) for r in reps]


def default_interval_bounds(params: Params) -> Tuple[float, float]:
    """Bracket for the interval search: the Young/Daly point +- 8x, kept
    inside (0, job_length].  With a free write or a failure-free fleet
    there is no interior optimum; fall back to a job-length-scaled span.
    """
    lam = cluster_failure_rate(params)
    tau = young_daly_interval(max(params.checkpoint_cost, 0.0),
                              math.inf if lam <= 0 else 1.0 / lam)
    if not math.isfinite(tau) or tau <= 0:
        return params.job_length / 64.0, params.job_length
    lo = max(tau / 8.0, params.checkpoint_cost, 1e-3)
    hi = min(tau * 8.0, params.job_length)
    if lo >= hi:   # degenerate (huge cost or tiny job): widen downward
        lo = hi / 64.0
    return lo, hi


def optimize_checkpoint_interval(
        params: Params,
        n_replicas: int = 256,
        bounds: Optional[Tuple[float, float]] = None,
        n_grid: int = 12,
        refine_iters: int = 10,
        objective: str = "goodput",
        maximize: bool = True,
        engine: str = "ctmc",
        max_steps: Optional[int] = None,
        device=None) -> CheckpointOptResult:
    """Goodput-optimal ``checkpoint_interval`` for ``params``.

    Two stages, each candidate set one batched call on ``device``
    (default the card; ``device="cpu"`` must be asked for):

    1. a geometric ``n_grid``-point sweep over ``bounds`` (default:
       :func:`default_interval_bounds`, the Young/Daly point +- 8x);
    2. golden-section refinement of the bracket around the grid argmax —
       both interior probes of every iteration are evaluated together
       in one batched call.

    Common random numbers (``params.seed`` shared by every candidate,
    the same draw for every point of a batch) make the simulated
    objective a deterministic function of the interval, so the refinement is a real optimization, not a noisy
    race.  Returns a :class:`CheckpointOptResult`; ``history`` records
    the shrinking bracket for convergence tests.
    """
    if n_grid < 3:
        raise ValueError("n_grid must be >= 3 to bracket an optimum")
    lo, hi = bounds if bounds is not None else default_interval_bounds(params)
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    sign = 1.0 if maximize else -1.0
    lam = cluster_failure_rate(params)
    yd = young_daly_interval(max(params.checkpoint_cost, 0.0),
                             math.inf if lam <= 0 else 1.0 / lam)

    # stage 1: geometric coarse grid, one batched call
    ratio = (hi / lo) ** (1.0 / (n_grid - 1))
    grid = [lo * ratio ** i for i in range(n_grid)]
    vals = _evaluate([params.replace(checkpoint_interval=iv) for iv in grid],
                     n_replicas, objective, engine, max_steps, device)
    n_evals = len(grid)
    best = max(range(n_grid), key=lambda i: sign * vals[i])
    best_iv, best_val = grid[best], vals[best]

    # stage 2: golden-section inside the one-notch bracket around the
    # argmax (the cross-check contract: the true optimum of a unimodal
    # response through the argmax of its own grid lies in this bracket)
    a = grid[max(best - 1, 0)]
    b = grid[min(best + 1, n_grid - 1)]
    history: List[Tuple[float, float]] = []
    for _ in range(max(refine_iters, 0)):
        span = b - a
        if span <= max(1e-6, 1e-4 * best_iv):
            break
        x1 = b - _INVPHI * span
        x2 = a + _INVPHI * span
        v1, v2 = _evaluate(
            [params.replace(checkpoint_interval=x1),
             params.replace(checkpoint_interval=x2)],
            n_replicas, objective, engine, max_steps, device)
        n_evals += 2
        for x, v in ((x1, v1), (x2, v2)):
            if sign * v > sign * best_val:
                best_iv, best_val = x, v
        if sign * v1 < sign * v2:
            a = x1
        else:
            b = x2
        history.append((a, b))

    return CheckpointOptResult(
        interval=best_iv, objective=best_val, young_daly=yd,
        grid=tuple(grid), grid_objective=tuple(vals),
        history=tuple(history), n_evals=n_evals)


def optimize_knobs(params: Params,
                   axes: Dict[str, Sequence],
                   n_replicas: int = 256,
                   objective: str = "goodput",
                   maximize: bool = True,
                   engine: str = "auto",
                   max_sweeps: int = 4,
                   max_steps: Optional[int] = None,
                   device=None) -> KnobOptResult:
    """Cyclic coordinate descent over discrete knob candidate sets.

    ``axes`` maps ``Params`` field names to their candidate values, e.g.
    ``{"warm_standbys": (0, 2, 4, 8), "spare_pool_size": (4, 8, 16),
    "checkpoint_interval": (60, 120, 240, 480)}``.  Each coordinate
    visit simulates every candidate row (with the other knobs held at
    their incumbents) in ONE batched call — structural knobs included,
    thanks to structure padding — on ``device`` (default the card), and
    moves to the row argmax.  Sweeps
    repeat until a full cycle leaves every knob unchanged or
    ``max_sweeps`` is hit.

    Coordinate descent on a discrete grid converges to a point that is
    optimal along every axis (a Nash point of the grid); with common
    random numbers the trajectory is deterministic in ``params.seed``.
    """
    if not axes:
        raise ValueError("axes must name at least one Params field")
    for name, vals in axes.items():
        if not hasattr(params, name):
            raise ValueError(f"unknown Params field {name!r}")
        if len(list(vals)) == 0:
            raise ValueError(f"axis {name!r} has no candidate values")
    sign = 1.0 if maximize else -1.0
    current: Dict[str, float] = {n: getattr(params, n) for n in axes}
    best_val = -math.inf
    history: List[Tuple[str, Tuple[float, ...], Tuple[float, ...]]] = []
    n_evals = 0
    converged = False
    for _ in range(max(max_sweeps, 1)):
        moved = False
        for name, cand in axes.items():
            cand = list(cand)
            if current[name] not in cand:
                cand = [current[name]] + cand
            grid = [params.replace(**{**current, name: v}) for v in cand]
            vals = _evaluate(grid, n_replicas, objective, engine, max_steps,
                             device)
            n_evals += len(grid)
            best = max(range(len(cand)), key=lambda i: sign * vals[i])
            history.append((name, tuple(float(c) for c in cand),
                            tuple(vals)))
            if cand[best] != current[name]:
                current[name] = cand[best]
                moved = True
            best_val = vals[best]
        if not moved:
            converged = True
            break
    return KnobOptResult(values=dict(current), objective=best_val,
                         history=tuple(history), n_evals=n_evals,
                         converged=converged)
