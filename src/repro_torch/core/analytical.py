"""Closed-form reliability cross-checks (the paper's §I 'analytical methods').

The paper positions DES against Markov/analytical models; we keep a small
analytical layer for three purposes:

1. *Validation*: under simplifying assumptions (no pool exhaustion, no
   stalls) the expected training time has a renewal-reward closed form the
   simulator must approach — used by tests.
2. *Checkpoint cadence* (Young/Daly): the training substrate picks its
   checkpoint interval from the same failure rates the DES sweeps, closing
   the sim-to-system loop.
3. *Napkin math for sweeps*: expected failures, repair-shop occupancy
   (M/G/infinity), and spare-capacity sizing bounds used to sanity-check
   sweep outputs before trusting them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .params import Params


def cluster_failure_rate(params: Params) -> float:
    """Mean failure rate (per minute) of the executing fleet at t=0."""
    return params.expected_failures_per_minute()


def expected_total_time(params: Params) -> float:
    """Renewal-reward estimate of E[total training time].

    Model: failures arrive at rate L while computing; each failure costs
    ``recovery_time`` (ignores host-selection, preemption, stalls, and the
    depletion of bad servers via repair — an *optimistic lower bound* that
    tightens as pools stay unexhausted; tests assert the simulator is
    slower than this bound minus CI but in its vicinity for the default
    over-provisioned configuration).

        E[T] ~= job_length * (1 + L * recovery_overhead_per_failure)

    With checkpoint rollback (``checkpoint_interval`` = tau > 0) each
    failure additionally re-computes the work lost since the last
    durable checkpoint, and every tau of banked compute pays one
    ``checkpoint_cost`` write.  For exponential inter-failure times with
    the failure clock restarting at every restart, banking one tau
    segment is a geometric renewal: an attempt succeeds with
    p = e^(-L*tau) and costs E[min(X, tau)] = (1 - e^(-L*tau))/L of
    compute, so

        E[compute] = job_length * (e^(L*tau) - 1) / (L * tau)

    exactly (equivalently job_length + n_fail * E[loss] with the
    truncated-exponential mean E[loss] = 1/L - tau/(e^(L*tau) - 1) ->
    tau/2 as L*tau -> 0, the Young/Daly regime).  Writes number
    ~job_length/tau.  The bound stays optimistic (no stalls, pools,
    host-selection) exactly as in the rollback-free case.
    """
    lam = cluster_failure_rate(params)
    per_failure = params.recovery_time
    tau = params.checkpoint_interval
    if lam <= 0 or tau <= 0:
        return params.job_length * (1.0 + lam * per_failure)
    x = lam * tau
    # truncated-exponential mean, numerically stable for small x via
    # expm1 (naive 1 - e^-x cancels below x ~ 1e-8)
    e_loss = 1.0 / lam - tau * math.exp(-x) / (-math.expm1(-x))
    # mean compute minutes per banked minute: a segment reaches the next
    # write with prob e^-x, and every attempt costs an expected
    # min(X, tau) = (1 - e^-x)/L minutes of compute
    compute = params.job_length * (-math.expm1(-x) / lam) / (
        tau * math.exp(-x))
    n_fail = lam * compute
    writes = params.job_length / tau
    return (compute + writes * params.checkpoint_cost
            + n_fail * per_failure)


def expected_failures(params: Params) -> float:
    """E[#failures] over the job under the optimistic model above."""
    return cluster_failure_rate(params) * params.job_length


def repair_shop_occupancy(params: Params) -> float:
    """M/G/infinity steady-state mean servers simultaneously in repair.

    Little's law: N = lambda * E[repair duration], with the repair duration
    mixing automated and escalated-manual paths.
    """
    lam = cluster_failure_rate(params) * params.diagnosis_probability
    p_auto = params.automated_repair_probability
    mean_repair = (params.auto_repair_time
                   + (1.0 - p_auto) * params.manual_repair_time)
    return lam * mean_repair


def spare_capacity_bound(params: Params, quantile_z: float = 2.33) -> float:
    """Poisson upper bound (z~2.33 -> ~99%) on servers out for repair.

    A working-pool headroom above this bound makes stalls rare — the
    analytical counterpart of the paper's capacity-planning case study.
    """
    occ = repair_shop_occupancy(params)
    return occ + quantile_z * math.sqrt(max(occ, 1e-12))


# ---------------------------------------------------------------------------
# Young/Daly checkpoint cadence — used by train/loop.py
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CheckpointPlan:
    interval_minutes: float       # optimal checkpoint interval
    mtbf_minutes: float           # cluster-level MTBF feeding the formula
    checkpoint_cost_minutes: float
    expected_overhead_fraction: float


def young_daly_interval(checkpoint_cost_minutes: float,
                        mtbf_minutes: float) -> float:
    """First-order optimum tau = sqrt(2 * C * MTBF) (Young 1974 / Daly 2006)."""
    if mtbf_minutes <= 0 or math.isinf(mtbf_minutes):
        return math.inf
    return math.sqrt(2.0 * checkpoint_cost_minutes * mtbf_minutes)


def plan_checkpoints(params: Params,
                     checkpoint_cost_minutes: float) -> CheckpointPlan:
    lam = cluster_failure_rate(params)
    mtbf = math.inf if lam <= 0 else 1.0 / lam
    tau = young_daly_interval(checkpoint_cost_minutes, mtbf)
    if math.isinf(tau):
        overhead = 0.0
    else:
        # overhead ~ C/tau (write cost) + tau/(2*MTBF) (expected rollback)
        overhead = checkpoint_cost_minutes / tau + tau / (2.0 * mtbf)
    return CheckpointPlan(interval_minutes=tau, mtbf_minutes=mtbf,
                          checkpoint_cost_minutes=checkpoint_cost_minutes,
                          expected_overhead_fraction=overhead)
