"""Vectorized multi-job CTMC engine on PyTorch: whole-cluster sweeps as one
batch.

Counterpart of ``src/repro/core/vectorized_multijob.py``.  The paper's
headline case study is *capacity planning*: many concurrent jobs of mixed
sizes contending for one spare pool and one repair shop.  The single-job
engine (:mod:`.vectorized`) models exactly one job; this module runs the
event engine's multi-job semantics (:mod:`.multijob` / ``scheduler`` /
``coordinator``) as a batched CTMC.

State layout (batch axis B = points x replicas, J jobs fixed per batch):

  * per-job compartment blocks ``run`` / ``sb`` -- each job carries its
    own running set and warm-standby complement over the 4 (origin x
    health) classes, its own phase/timer/work_left lanes, and its own
    run/recovery/waiting histogram channels;
  * shared pool lanes ``fw`` / ``fs`` -- ONE working pool and ONE spare
    pool all jobs draw from (the contention the paper predicts at
    replacement acquisition);
  * a shared finite-server repair shop, partitioned **by owning job**:
    ``auto`` / ``man`` are the in-service stages (``Params.repair_servers``
    service slots) and ``q`` is the waiting line behind them.  A departure
    admits one queued server proportionally over the queued (job, class)
    counts -- the uniform-random admission the event engine's
    :class:`~repro_torch.core.repair.RepairShop` draws, so admission is
    exact in law.  ``repair_servers=0`` keeps the shop unbounded and the
    queue lane permanently empty.

The job count is the only structure key: job sizes, lengths, rates,
warm-standby targets and pool/shop capacities are per-row values, so a
mixed-size capacity grid (spare-pool size x repair servers) runs as ONE
batch through :func:`simulate_multijob_ctmc_sweep`.

Dispatch semantics of the event engine's ``Dispatcher``:

  * a repaired server goes to the **longest-stalled** job first (FIFO
    over stall-start times; ties resolve to the lowest job index, as
    ``torch.argmin`` returns the first minimum), paying the
    host-selection surcharge iff the receiver is not the owner that
    submitted it;
  * otherwise the owning job refills its standby complement (if still
    active and below its warm target);
  * otherwise the server returns to its origin pool.

A completing job releases its running + standby servers to the pools;
stalled jobs grab one each (earliest stall first -- the release-watcher
order of the event engine) with the host-selection surcharge always
charged (released servers are never members of the starved job).

Each step races 16J exponential lanes against 2J deterministic residuals.
On the card a chunk of steps is one launch of the multi-job chunk kernel
(``csrc/mj_chunk.cu`` through :mod:`repro_torch.kernels.mj_chunk`), which
runs :func:`_mj_step_u` with the race fused in, for J up to
``mj_chunk.MAX_JOBS``; on the CPU and for ``impl="ref"`` each step is
:func:`_mj_step_u` in PyTorch ops with the plain race (:func:`_mj_steps`,
the kernel's plain version), and ``_mj_steps(..., impl="cuda")`` still
races through the standalone race kernel (``csrc/event_race.cu``).
Random numbers copy the *shape* of the reference's draws, not its bits:
each chunk makes one ``(chunk, next_pow2(R), 10)`` draw in ``[1e-12, 1)``
from a ``torch.Generator`` seeded from ``(seed, chunk index)``, sliced to
R and tiled across the P points, as the single-job engine does.  That
gives common random numbers across points and keeps pow2 bucketing
value-identical on real rows.

Reduction: a 1-job cluster with an unbounded shop **routes to the
single-job engine** (:func:`.vectorized.simulate_ctmc_sweep`): the same
results as a direct call, through the chunk kernel on the card.

Carve-outs (the event engine :mod:`.multijob` remains the oracle):
exponential failures AND repairs only, no fault domains / campaigns /
checkpoint rollback / retirement / regeneration / failing standbys, and
all jobs start at t=0 (:func:`reference_reasons_multijob`, the reference's
reasons word for word).  ``shards`` splits the replica axis over
devices as the single-job engine does (:func:`_mj_chunk_loop`).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import mj_chunk, ops
from . import hazards
from . import vectorized as vz
from .histograms import HIST_CHANNELS
from .multijob import JobSpec
from .params import Params
from .vectorized import (COMPUTE, DONE, OVERHEAD, STALL, _next_pow2,
                         _selected_channels, default_max_steps)

#: per-job scalar metrics carried as (B, J) lanes -- the per-job
#: RunResult fields the event oracle reports
_MJ_JOB_METRICS = (
    "total_time", "useful_work", "n_failures", "n_random_failures",
    "n_systematic_failures", "n_undiagnosed", "n_misdiagnosed",
    "n_preemptions", "n_host_selections", "n_standby_swaps",
    "stall_time", "recovery_overhead",
)

#: cluster-level (B,) metrics: the shared repair shop's counters (the
#: event engine's ``MultiJobResult.cluster``), the dispatcher's stall
#: hand-off count, shop-queue pressure, and the conservation check
_MJ_CLUSTER_METRICS = ("n_auto_repairs", "n_manual_repairs",
                       "n_failed_repairs", "stall_handoffs",
                       "n_shop_queued", "conservation_err")

#: uniform lanes per step: u_time, u_pick (event race), u_diag, u_wrong,
#: u_cls, u_esc, u_succ, u_pool (failure/repair path -- same roles as the
#: single-job engine), u_adm (queue admission pick), u_rel
#: (completion-release class picks, golden-ratio shifted per hand-off)
_N_UNIFORMS = 10

_PHI = 0.6180339887498949


def reference_reasons_multijob(cluster: Params,
                               jobs: Sequence[JobSpec]) -> list:
    """Why the reference's multi-job CTMC engine refuses this cluster.

    The reference's ``unsupported_reasons_multijob``, word for word and
    branch for branch.  A cluster with a reason here runs on the event
    engine under ``engine="auto"`` in both packages.

    >>> reference_reasons_multijob(Params(checkpoint_interval=60.0),
    ...                            [JobSpec(8, 100.0)])
    ['checkpoint rollback is event-engine-only']
    """
    reasons = []
    if len(jobs) < 1:
        reasons.append("no jobs given")
    if hazards.hazard_kind(cluster) != "exponential":
        reasons.append(
            "non-exponential failure distribution (the multi-job "
            "program has no per-job hazard lanes yet; the single-job "
            "CTMC engine covers weibull/bathtub/lognormal/empirical)")
    if hazards.repair_kind(cluster) != "exponential":
        reasons.append(
            "non-exponential repair distribution (the shared "
            "repair-shop lane is exponential-stage only)")
    if cluster.fault_domains is not None or cluster.campaign is not None:
        reasons.append(
            "fault domains / campaigns are single-job-fast-path or "
            "event-engine territory here")
    if cluster.retirement_threshold != 0:
        reasons.append("retirement policies are event-engine-only")
    if cluster.bad_set_regeneration_period != 0:
        reasons.append("bad-set regeneration is event-engine-only")
    if cluster.checkpoint_interval != 0:
        reasons.append("checkpoint rollback is event-engine-only")
    if cluster.standbys_can_fail:
        reasons.append("failing warm standbys are event-engine-only")
    if any(j.start_time != 0.0 for j in jobs):
        reasons.append(
            "staggered job start times (all jobs must start at t=0)")
    return reasons


def port_reasons_multijob(cluster: Params,
                          jobs: Sequence[JobSpec]) -> list:
    """What of the reference's multi-job CTMC envelope the port does not
    run yet, with its ROADMAP item: nothing (replica sharding runs here
    too).  Kept so that :func:`unsupported_reasons_multijob` and
    ``backend.resolve_engine_multijob`` can name a part that a later
    reference adds before the port has it.

    >>> port_reasons_multijob(Params(engine_shards=2), [JobSpec(8, 100.0)])
    []
    """
    return []


def unsupported_reasons_multijob(cluster: Params,
                                 jobs: Sequence[JobSpec]) -> list:
    """Why this cluster is outside the port's multi-job CTMC engine
    (empty = inside): the reference's reasons, then the port's own.

    >>> unsupported_reasons_multijob(Params(), [JobSpec(8, 100.0)])
    []
    """
    return (reference_reasons_multijob(cluster, jobs)
            + port_reasons_multijob(cluster, jobs))


def supports_multijob(cluster: Params, jobs: Sequence[JobSpec]) -> bool:
    """Can the port's multi-job CTMC engine run this cluster?

    It covers the paper's exponential baseline -- exponential failures
    and repairs -- with any number of mixed-size jobs sharing one spare
    pool and one (optionally finite) repair shop.

    >>> supports_multijob(Params(repair_servers=4),
    ...                   [JobSpec(8, 100.0), JobSpec(4, 50.0)])
    True
    >>> supports_multijob(Params(failure_distribution="weibull"),
    ...                   [JobSpec(8, 100.0)])
    False
    """
    return not unsupported_reasons_multijob(cluster, jobs)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def _mj_initial_counts(cluster: Params, jobs: Sequence[JobSpec]) -> dict:
    """Sequential expectation-split allocation, mirroring the event
    engine's job-order pops from one shared working pool at t=hs."""
    wp, sp = cluster.working_pool_size, cluster.spare_pool_size
    total = wp + sp
    n_bad = int(round(cluster.systematic_failure_fraction * total))
    bad_w = round(n_bad * wp / total)
    bad_s = n_bad - bad_w

    def split(n_take, pool_good, pool_bad):
        frac_bad = pool_bad / max(pool_good + pool_bad, 1)
        take_bad = int(round(n_take * frac_bad))
        return n_take - take_bad, take_bad

    w_good, w_bad = wp - bad_w, bad_w
    run, sb = [], []
    for spec in jobs:
        rg, rb = split(spec.job_size, w_good, w_bad)
        w_good -= rg
        w_bad -= rb
        n_sb = min(spec.warm_standbys, w_good + w_bad)
        sg, s_b = split(n_sb, w_good, w_bad)
        w_good -= sg
        w_bad -= s_b
        run.append([rg, rb, 0, 0])
        sb.append([sg, s_b, 0, 0])
    return {"run": run, "sb": sb,
            "fw": [w_good, w_bad, 0, 0],
            "fs": [0, 0, sp - bad_s, bad_s],
            "fleet_total": float(total)}


def _mj_initial_state_batch(points: Sequence[Tuple[Params, tuple]],
                            R: int, max_runs: int, device="cpu",
                            ) -> Dict[str, torch.Tensor]:
    """Padded initial state for a structural grid, point-major (P*R, ...).

    As in the single-job engine, structure (job sizes, pool sizes, job
    lengths) enters purely as per-point initial *values*: every point of
    a group shares the compartment layout of its job count.  The keys,
    shapes and dtypes are the reference's.
    """
    P = len(points)
    B = P * R
    J = len(points[0][1])
    counts = [_mj_initial_counts(c, js) for c, js in points]
    f32 = dict(dtype=torch.float32, device=device)

    def rep(arr):
        return torch.as_tensor(np.repeat(np.asarray(arr, np.float32), R,
                                         axis=0), **f32)

    state: Dict[str, torch.Tensor] = {}
    state["run"] = rep([c["run"] for c in counts])          # (B, J, 4)
    state["sb"] = rep([c["sb"] for c in counts])
    state["fw"] = rep([c["fw"] for c in counts])            # (B, 4)
    state["fs"] = rep([c["fs"] for c in counts])
    state["auto"] = torch.zeros((B, J, 4), **f32)
    state["man"] = torch.zeros((B, J, 4), **f32)
    state["q"] = torch.zeros((B, J, 4), **f32)
    state["fleet_total"] = rep([c["fleet_total"] for c in counts])  # (B,)
    state["t"] = rep([c.host_selection_time for c, _ in points])
    state["work_left"] = rep([[j.job_length for j in js]
                              for _, js in points])         # (B, J)
    state["timer"] = torch.full((B, J), torch.inf, **f32)
    state["stall_start"] = torch.zeros((B, J), **f32)
    state["phase"] = torch.full((B, J), COMPUTE, dtype=torch.int32,
                                device=device)
    state["cur_run"] = torch.zeros((B, J), **f32)
    state["n_runs"] = torch.zeros((B, J), dtype=torch.int32, device=device)
    state["run_durations"] = torch.zeros((B, J, max_runs), **f32)
    spec = points[0][0].histogram
    sel = _selected_channels(spec)
    if sel:
        state["hist"] = torch.zeros((B, J, len(sel), spec.n_counts), **f32)
        state["hist_edges"] = torch.as_tensor(spec.edges(), **f32)
    for m in _MJ_JOB_METRICS:
        state.setdefault(m, torch.zeros((B, J), **f32))
    for m in _MJ_CLUSTER_METRICS:
        state[m] = torch.zeros((B,), **f32)
    return state


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """``torch.arange(n)`` (int64) on ``device``, made once: a step would
    otherwise build each index vector anew, one device launch apiece."""
    return torch.arange(n, device=device)


def _onehot_jobs(j: torch.Tensor, J: int) -> torch.Tensor:
    """Boolean one-hot of a (B,) job index over J jobs: (B, J)."""
    return j[:, None] == _arange(J, j.device)


def _at(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[b, j[b]]`` of a (B, J, ...) block."""
    return x[_arange(x.shape[0], x.device), j.long()]


def _add_at(x: torch.Tensor, j1b: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """``x.at[rows, j].add(v)`` of a (B, J, 4) block: v (B, 4) lands on
    job j of each row, the others are left as they were."""
    return torch.where(j1b[..., None], x + v[:, None, :], x)


# ---------------------------------------------------------------------------
# one transition
# ---------------------------------------------------------------------------

def _mj_step_u(s: Dict[str, torch.Tensor], u: torch.Tensor, pv: torch.Tensor,
               J: int, impl: Optional[str] = None,
               hist_channels: tuple = HIST_CHANNELS,
               ) -> Dict[str, torch.Tensor]:
    """One multi-job CTMC transition for a batch of replicas.

    ``u`` is the step's ``(B, 10)`` uniforms.  ``pv`` columns: 14 shared
    model parameters [r_rand, r_sys, recovery, host_sel, waiting, auto_t,
    man_t, auto_fail, man_fail, p_auto, dp, du, preempt_cost,
    repair_servers] followed by J per-job warm-standby targets -- a single
    vector or one row per replica (the batched sweep layout).  Race
    layout: 16J exponential lanes ([random-failure x4, systematic x4,
    auto-completion x4, manual x4] per job, job-major within each family
    block) + 2J deterministic residuals (per-job completion, then per-job
    overhead timer); exact ties go to the lower column.  Returns a new
    state dict; ``s`` is left as it was.
    """
    B = s["t"].shape[0]
    device = s["t"].device
    if pv.ndim == 1:
        col = [pv[i] for i in range(14)]
        warm = pv[14:14 + J]                                   # (J,)

        def warm_of(j):
            return warm[j.long()]

        def _e(x):          # parameter -> broadcast over (B, J, 4)
            return x

        _j = _e             # parameter -> broadcast over (B, J)
    else:
        col = [pv[:, i] for i in range(14)]
        warm = pv[:, 14:14 + J]                                # (B, J)

        def warm_of(j):
            return _at(warm, j)

        def _e(x):
            return x[:, None, None]

        def _j(x):
            return x[:, None]
    (r_rand, r_sys, recovery, host_sel, waiting, auto_t, man_t,
     auto_fail, man_fail, p_auto, dp, du, preempt_cost, cap) = col

    (u_time, u_pick, u_diag, u_wrong, u_cls, u_esc, u_succ, u_pool,
     u_adm, u_rel) = u.unbind(1)

    phase = s["phase"]
    computing = phase == COMPUTE                               # (B, J)
    in_overhead = phase == OVERHEAD
    stalled_pre = phase == STALL
    active_any = (phase != DONE).any(-1)                       # (B,)

    # ---- rates (B, 16J) -------------------------------------------------
    run = s["run"]
    bad_mask, _ = vz._lane_consts(device)
    comp3 = computing[..., None]
    fail_rand = run * _e(r_rand) * comp3
    fail_sys = run * bad_mask * _e(r_sys) * comp3
    auto_rate = s["auto"] / _e(auto_t).clamp_min(1e-9)
    man_rate = s["man"] / _e(man_t).clamp_min(1e-9)
    rates = torch.cat(
        [fail_rand.reshape(B, 4 * J), fail_sys.reshape(B, 4 * J),
         auto_rate.reshape(B, 4 * J), man_rate.reshape(B, 4 * J)],
        dim=-1) * active_any[:, None]

    residuals = torch.cat(
        [torch.where(computing, s["work_left"], torch.inf),
         torch.where(in_overhead, s["timer"], torch.inf)], dim=-1)  # (B, 2J)

    dt, ev = ops.event_race(rates, residuals, u_time, u_pick, impl=impl)
    dt = torch.where(active_any & torch.isfinite(dt), dt, 0.0)
    kx = 16 * J

    # the race's int32 event decodes in int32: class, owning/failing job
    cls = ev % 4
    ej = (ev % (4 * J)) // 4
    ej1b = _onehot_jobs(ej, J)                                 # (B, J)
    is_fail = active_any & (ev < 8 * J)
    is_sys = active_any & (ev >= 4 * J) & (ev < 8 * J)
    is_auto = active_any & (ev >= 8 * J) & (ev < 12 * J)
    is_man = active_any & (ev >= 12 * J) & (ev < 16 * J)
    jobs_ax = _arange(J, device)
    is_complete = active_any[:, None] \
        & (ev[:, None] == kx + jobs_ax[None, :])               # (B, J)
    is_timer = active_any[:, None] \
        & (ev[:, None] == kx + J + jobs_ax[None, :])

    ns = dict(s)
    t_new = s["t"] + dt
    ns["t"] = t_new

    # ---- progress / completion / timers --------------------------------
    progress = torch.where(computing, dt[:, None], 0.0)        # (B, J)
    ns["work_left"] = s["work_left"] - progress
    ns["useful_work"] = s["useful_work"] + progress
    timer_dec = torch.where(in_overhead, s["timer"] - dt[:, None],
                            s["timer"])
    phase_n = torch.where(is_complete, DONE, phase)
    phase_n = torch.where(is_timer, COMPUTE, phase_n)
    timer_n = torch.where(is_timer, torch.inf, timer_dec)
    ns["total_time"] = torch.where(is_complete, t_new[:, None],
                                   s["total_time"])

    # ---- exact per-job run durations ------------------------------------
    fail_j = is_fail[:, None] & ej1b                           # (B, J)
    record = fail_j | is_complete
    run_val = s["cur_run"] + progress
    max_runs = s["run_durations"].shape[2]
    if max_runs:
        slot = (s["n_runs"] % max_runs).long()[..., None]      # (B, J, 1)
        kept = s["run_durations"].gather(2, slot)[..., 0]
        new = torch.where(record, run_val, kept)
        ns["run_durations"] = s["run_durations"].scatter(2, slot,
                                                         new[..., None])
    ns["n_runs"] = s["n_runs"] + record.to(torch.int32)
    ns["cur_run"] = torch.where(record, 0.0, run_val)

    # ---- failure handling ----------------------------------------------
    # a float32 count plus a boolean mask adds 1.0 where the mask holds
    ns["n_failures"] = s["n_failures"] + fail_j
    ns["n_systematic_failures"] = s["n_systematic_failures"] \
        + (is_sys[:, None] & ej1b)
    ns["n_random_failures"] = s["n_random_failures"] \
        + ((is_fail & ~is_sys)[:, None] & ej1b)

    diagnosed = is_fail & (u_diag < dp)
    wrong = diagnosed & (u_wrong < du)
    ns["n_undiagnosed"] = s["n_undiagnosed"] \
        + ((is_fail & ~diagnosed)[:, None] & ej1b)
    ns["n_misdiagnosed"] = s["n_misdiagnosed"] + (wrong[:, None] & ej1b)

    run_f = _at(run, ej)                                       # (B, 4)
    sb_f = _at(s["sb"], ej)
    # stacked proportional picks: misdiagnosis target within the failing
    # job's own running set, standby take, working take, spare take
    picks = vz._pick_classes(
        torch.stack([run_f, sb_f, s["fw"], s["fs"]], dim=1),
        torch.stack([u_cls, u_cls, u_pool, u_pool], dim=1))    # (B, 4)
    pick1h = vz._onehot(picks)                                 # (B, 4, 4)

    rm1h = torch.where(wrong[:, None], pick1h[:, 0], vz._onehot(cls)) \
        * diagnosed[:, None]                                   # (B, 4)
    run_n = _add_at(run, ej1b, -rm1h)

    # shop entry: a free service slot starts the automated stage at
    # once; a full shop parks the server in the queue lane (by owner)
    cap_eff = torch.where(cap > 0, cap, torch.inf)
    shop_active = s["auto"].sum((-2, -1)) + s["man"].sum((-2, -1))  # (B,)
    has_slot = shop_active < cap_eff
    enters = diagnosed & has_slot
    queues = diagnosed & ~has_slot
    auto_n = _add_at(s["auto"], ej1b, rm1h * enters[:, None])
    q_n = _add_at(s["q"], ej1b, rm1h * queues[:, None])
    ns["n_shop_queued"] = s["n_shop_queued"] + queues

    # replacement waterfall: own standbys -> shared working -> shared
    # spare -> stall (the paper's priority order, per job)
    sb_tot = sb_f.sum(-1)
    fw_tot = s["fw"].sum(-1)
    fs_tot = s["fs"].sum(-1)
    use_sb = diagnosed & (sb_tot > 0)
    use_fw = diagnosed & ~use_sb & (fw_tot > 0)
    use_fs = diagnosed & ~use_sb & ~use_fw & (fs_tot > 0)
    goes_stall = diagnosed & ~use_sb & ~use_fw & ~use_fs

    take = (pick1h[:, 1] * use_sb[:, None]
            + pick1h[:, 2] * use_fw[:, None]
            + pick1h[:, 3] * use_fs[:, None])
    sb_n = _add_at(s["sb"], ej1b, -pick1h[:, 1] * use_sb[:, None])
    fw_n = s["fw"] - pick1h[:, 2] * use_fw[:, None]
    fs_n = s["fs"] - pick1h[:, 3] * use_fs[:, None]
    run_n = _add_at(run_n, ej1b, take)
    ns["n_standby_swaps"] = s["n_standby_swaps"] \
        + (use_sb[:, None] & ej1b)
    ns["n_host_selections"] = s["n_host_selections"] \
        + ((use_fw | use_fs)[:, None] & ej1b)
    ns["n_preemptions"] = s["n_preemptions"] + (use_fs[:, None] & ej1b)

    fail_timer = (recovery
                  + torch.where(use_fw | use_fs, host_sel, 0.0)
                  + torch.where(use_fs, waiting + preempt_cost, 0.0))
    resolves = is_fail & ~goes_stall
    resolves_j = resolves[:, None] & ej1b
    stall_j = goes_stall[:, None] & ej1b
    timer_n = torch.where(resolves_j, fail_timer[:, None], timer_n)
    phase_n = torch.where(resolves_j, OVERHEAD, phase_n)
    phase_n = torch.where(stall_j, STALL, phase_n)
    stall_start_n = torch.where(stall_j, t_new[:, None], s["stall_start"])
    recovery_overhead = s["recovery_overhead"] \
        + torch.where(resolves_j, _j(recovery), 0.0)

    # ---- repair completions ---------------------------------------------
    rep1h = vz._onehot(cls)
    auto_n = _add_at(auto_n, ej1b, -rep1h * is_auto[:, None])
    ns["n_auto_repairs"] = s["n_auto_repairs"] + is_auto
    escalate = is_auto & (u_esc >= p_auto)
    man_n = _add_at(s["man"], ej1b, rep1h * escalate[:, None]
                    - rep1h * is_man[:, None])
    ns["n_manual_repairs"] = s["n_manual_repairs"] + is_man

    finishes = (is_auto & ~escalate) | is_man
    fail_prob = torch.where(is_man, man_fail, auto_fail)
    healed = finishes & (u_succ >= fail_prob)
    ns["n_failed_repairs"] = s["n_failed_repairs"] + (finishes & ~healed)
    out_cls = torch.where(healed, cls - (cls % 2), cls)        # bad -> good
    out1h = vz._onehot(out_cls)
    spare_origin = out_cls >= 2

    # dispatcher: longest-stalled job anywhere > owner standby refill >
    # origin pool.  The host-selection surcharge applies iff the
    # receiver is NOT the owner that submitted the server (the event
    # engine's membership rule -- only original members rejoin free).
    # argmin takes the first minimum: ties go to the lowest job index.
    any_stalled = stalled_pre.any(-1)
    k_star = torch.argmin(torch.where(stalled_pre, s["stall_start"],
                                      torch.inf), dim=-1)      # (B,)
    to_stalled = finishes & any_stalled
    k1b = _onehot_jobs(k_star, J)
    to_stalled_j = to_stalled[:, None] & k1b
    surcharge = to_stalled & (k_star != ej)
    run_n = _add_at(run_n, k1b, out1h * to_stalled[:, None])
    unstall_timer = recovery + torch.where(surcharge, host_sel, 0.0)
    phase_n = torch.where(to_stalled_j, OVERHEAD, phase_n)
    timer_n = torch.where(to_stalled_j, unstall_timer[:, None], timer_n)
    stall_wait = t_new - _at(s["stall_start"], k_star)
    stall_time = s["stall_time"] \
        + torch.where(to_stalled_j, stall_wait[:, None], 0.0)
    n_host_sel = ns["n_host_selections"] + (surcharge[:, None] & k1b)
    recovery_overhead = recovery_overhead \
        + torch.where(to_stalled_j, _j(recovery), 0.0)
    ns["stall_handoffs"] = s["stall_handoffs"] + to_stalled

    owner_active = _at(phase, ej) != DONE
    sb_owner_tot = _at(sb_n, ej).sum(-1)
    to_sb = finishes & ~to_stalled & owner_active \
        & (sb_owner_tot < warm_of(ej))
    to_pool = finishes & ~to_stalled & ~to_sb
    sb_n = _add_at(sb_n, ej1b, out1h * to_sb[:, None])
    fw_n = fw_n + out1h * (to_pool & ~spare_origin)[:, None]
    fs_n = fs_n + out1h * (to_pool & spare_origin)[:, None]

    # a departure frees a service slot: admit one queued server,
    # proportionally over the queued (job, class) counts -- exact in law
    # vs the event shop's uniform-random admission
    q_flat = q_n.reshape(B, 4 * J)
    admit = finishes & (q_flat.sum(-1) > 0)
    pick_q = vz._pick_classes(q_flat, u_adm)
    qj1b = _onehot_jobs(pick_q // 4, J)
    qc1h = vz._onehot(pick_q % 4) * admit[:, None]
    q_n = _add_at(q_n, qj1b, -qc1h)
    auto_n = _add_at(auto_n, qj1b, qc1h)

    # ---- histogram bookkeeping for failure/unstall paths ---------------
    # per step each job records at most one recovery/waiting event:
    # a resolved failure (its own), a repair-return unstall, or (below)
    # a completion-release unstall
    ended = resolves_j | to_stalled_j                          # (B, J)
    rec_fail = fail_timer[:, None]
    rec_unst = (stall_wait + unstall_timer)[:, None]
    downtime = torch.where(resolves_j, rec_fail,
                           torch.where(to_stalled_j, rec_unst, 0.0))
    acq_fail = (fail_timer - recovery)[:, None]
    acq_unst = (stall_wait + unstall_timer - recovery)[:, None]
    acquire_wait = torch.where(resolves_j, acq_fail,
                               torch.where(to_stalled_j, acq_unst, 0.0))

    # ---- job completion: release running + standbys ---------------------
    # argmax takes the first maximum: one completing job a step, the
    # lowest index on a tie
    any_complete = is_complete.any(-1)
    ci = torch.argmax(is_complete.to(torch.int32), dim=-1)     # (B,)
    released = _onehot_jobs(ci, J) & any_complete[:, None]     # (B, J)
    rel = (_at(run_n, ci) + _at(sb_n, ci)) * any_complete[:, None]
    run_n = torch.where(released[..., None], 0.0, run_n)
    sb_n = torch.where(released[..., None], 0.0, sb_n)

    # released servers go to starving jobs first (earliest stall first,
    # one each -- the release-watcher semantics), always paying the
    # host-selection surcharge; class picks are proportional over the
    # released batch (the reference's documented approximation: the event
    # engine hands the literal pushed server, an exchangeable draw from
    # the same batch).  The remainder lands in the origin pools.
    stalled_now = (phase_n == STALL) & ~is_complete
    rel_rem = rel
    rel_timer = (recovery + host_sel).expand(B)
    for r in range(max(J - 1, 0)):
        can = any_complete & stalled_now.any(-1) & (rel_rem.sum(-1) > 0)
        k_r = torch.argmin(torch.where(stalled_now, stall_start_n,
                                       torch.inf), dim=-1)
        kr1b = _onehot_jobs(k_r, J)
        can_j = can[:, None] & kr1b
        # the shift rounds to float32 before the add, as the reference's
        # weakly typed Python float does
        u_r = torch.remainder(u_rel + r * _PHI, 1.0)
        p1h = vz._onehot(vz._pick_classes(rel_rem, u_r)) * can[:, None]
        rel_rem = rel_rem - p1h
        run_n = _add_at(run_n, kr1b, p1h)
        rel_wait = t_new - _at(stall_start_n, k_r)
        phase_n = torch.where(can_j, OVERHEAD, phase_n)
        timer_n = torch.where(can_j, rel_timer[:, None], timer_n)
        stall_time = stall_time \
            + torch.where(can_j, rel_wait[:, None], 0.0)
        n_host_sel = n_host_sel + can_j
        recovery_overhead = recovery_overhead \
            + torch.where(can_j, _j(recovery), 0.0)
        ended = ended | can_j
        downtime = torch.where(can_j, (rel_wait + rel_timer)[:, None],
                               downtime)
        acquire_wait = torch.where(
            can_j, (rel_wait + rel_timer - recovery)[:, None], acquire_wait)
        stalled_now = stalled_now & ~can_j
    from_spare = vz._lane_consts(device)[1] >= 2          # origin classes
    fw_n = fw_n + torch.where(from_spare, 0.0, rel_rem)
    fs_n = fs_n + torch.where(from_spare, rel_rem, 0.0)
    ns.update(run=run_n, sb=sb_n, fw=fw_n, fs=fs_n, auto=auto_n, man=man_n,
              q=q_n, phase=phase_n, timer=timer_n, stall_start=stall_start_n,
              stall_time=stall_time, n_host_selections=n_host_sel,
              recovery_overhead=recovery_overhead)

    # ---- streaming per-job histograms -----------------------------------
    # (row, job, channel) triples are unique, so the scatter's order
    # cannot change the result
    if "hist" in s:
        channel_vals = {"run_duration": (run_val, record),
                        "recovery": (downtime, ended),
                        "waiting": (acquire_wait, ended)}
        vals = torch.stack([channel_vals[ch][0] for ch in hist_channels],
                           dim=2)                              # (B, J, S)
        masks = torch.stack([channel_vals[ch][1] for ch in hist_channels],
                            dim=2)
        idx = torch.searchsorted(s["hist_edges"], vals, right=True)
        ns["hist"] = s["hist"].scatter_add(3, idx[..., None],
                                           masks.to(torch.float32)[..., None])

    # ---- conservation invariant ----------------------------------------
    tot = (run_n.sum((-2, -1)) + sb_n.sum((-2, -1))
           + auto_n.sum((-2, -1)) + man_n.sum((-2, -1))
           + q_n.sum((-2, -1)) + fw_n.sum(-1) + fs_n.sum(-1))
    ns["conservation_err"] = torch.maximum(
        s["conservation_err"], (tot - s["fleet_total"]).abs())
    return ns


# ---------------------------------------------------------------------------
# run loop
# ---------------------------------------------------------------------------

def _mj_params_vector(cluster: Params, jobs: Sequence[JobSpec],
                      ) -> np.ndarray:
    """float32 parameter row: the 14 shared columns, then the J per-job
    warm-standby targets."""
    base = np.asarray([
        cluster.random_failure_rate, cluster.systematic_failure_rate,
        cluster.recovery_time, cluster.host_selection_time,
        cluster.waiting_time, cluster.auto_repair_time,
        cluster.manual_repair_time, cluster.auto_repair_failure_probability,
        cluster.manual_repair_failure_probability,
        cluster.automated_repair_probability,
        cluster.diagnosis_probability, cluster.diagnosis_uncertainty,
        cluster.preemption_cost, float(cluster.repair_servers),
    ], np.float32)
    warm = np.asarray([float(j.warm_standbys) for j in jobs], np.float32)
    return np.concatenate([base, warm])


def default_max_steps_multijob(cluster: Params,
                               jobs: Sequence[JobSpec],
                               safety: float = 2.0) -> int:
    """Per-job single-job budgets summed (each race event is one step),
    plus head-room for shop-queue churn under a tight capacity."""
    steps = 0
    for spec in jobs:
        p = cluster.replace(job_size=spec.job_size,
                            job_length=spec.job_length,
                            warm_standbys=spec.warm_standbys,
                            repair_servers=0)
        steps += default_max_steps(p, safety)
    return steps


def _mj_steps(state: Dict[str, torch.Tensor], us: torch.Tensor,
              pv: torch.Tensor, R: int, P: int, J: int,
              impl: Optional[str], hist_channels: tuple,
              ) -> Dict[str, torch.Tensor]:
    """``us.shape[0]`` steps of :func:`_mj_step_u` on one chunk's draw.

    ``us`` is the chunk's ``(n_steps, R_draw, 10)`` draw; it is sliced to
    R replicas and tiled across the P points of a ``(P * R,)`` batch, so
    row b reads replica ``b % R``'s uniforms.  ``impl`` goes to the event
    race of each step.  The plain version of the multi-job chunk kernel
    (``impl="ref"``); ``impl="cuda"`` races through the standalone race
    kernel, for tests and timing.
    """
    if us.shape[1] != R:
        us = us[:, :R]
    if P > 1:
        us = us.repeat(1, P, 1)
    for k in range(us.shape[0]):
        state = _mj_step_u(state, us[k], pv, J, impl, hist_channels)
    return state


def _mj_chunk_fn(pv: torch.Tensor, seed: int, P: int, R: int, J: int,
                 impl: Optional[str], hist_channels: tuple,
                 init_state: Dict[str, torch.Tensor]):
    """``run_chunk(state, i, n_steps)`` of one batch -- the multi-job twin
    of the single-job ``vectorized._chunk_fn``: chunk ``i`` draws
    ``(n_steps, next_pow2(R), 10)`` uniforms seeded ``_chunk_seed(seed,
    i)``, then runs one launch of the multi-job chunk kernel for
    ``impl=None`` or ``"cuda"`` on the card -- the template instance of
    its J, or above ``mj_chunk.MAX_JOBS`` the runtime-J instance, chosen
    before the first launch (``mj_chunk.runtime_for``) -- and
    :func:`_mj_steps` with the plain race for ``impl="ref"`` and on the
    CPU (where ``impl="cuda"`` raises)."""
    device = init_state["phase"].device
    R_draw = _next_pow2(R)
    fused = ops._use_kernel("mj_chunk", impl, init_state["phase"])
    runtime = fused and mj_chunk.runtime_for(J)
    owned = False

    def run_chunk(state, i, n_steps):
        nonlocal owned
        gen = torch.Generator(device=device)
        gen.manual_seed(vz._chunk_seed(seed, i))
        us = torch.rand((n_steps, R_draw, _N_UNIFORMS), generator=gen,
                        dtype=torch.float32, device=device)
        us = us.clamp_min_(1e-12)
        if not fused:
            return _mj_steps(state, us, pv, R, P, J, impl, hist_channels)
        # the first launch clones the lanes it writes; later ones update
        # those clones in place
        state = mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J,
                                       hist_channels, runtime=runtime,
                                       inplace=owned)
        owned = True
        return state

    return run_chunk


def _mj_finish(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The completion flags, and the clock as the total time of a job the
    budget cut."""
    state = dict(state)
    done = state["phase"] == DONE
    state["completed"] = done.to(torch.float32)
    state["total_time"] = torch.where(done, state["total_time"],
                                      state["t"][:, None])
    return state


def _mj_chunk_loop(pv: torch.Tensor, seed: int, P: int, R: int, chunk: int,
                   n_chunks: int, rem: int, J: int, impl: Optional[str],
                   early_exit: bool, hist_channels: tuple,
                   init_state: Dict[str, torch.Tensor], *, mesh=None,
                   ) -> Dict[str, torch.Tensor]:
    """Chunked scan with early exit -- the multi-job twin of the
    single-job ``_chunk_loop`` (same chunking, bucketing, sharding over
    ``mesh`` and common-random-number conventions; see that docstring)
    over :func:`_mj_chunk_fn`'s chunks, and so the ``mj_chunk.cu``
    instance of its J.  ``init_state`` is left as it was."""
    def make_run(pv_s, seed_s, R_loc, state_s):
        return _mj_chunk_fn(pv_s, seed_s, P, R_loc, J, impl, hist_channels,
                            state_s)

    return vz._run_sharded(pv, seed, P, R, init_state,
                           mesh or [init_state["phase"].device], make_run,
                           _mj_finish, n_chunks, chunk, rem, early_exit)


def _unsupported_error(cluster: Params, jobs) -> ValueError:
    reasons = unsupported_reasons_multijob(cluster, jobs) \
        or ["unknown reason — please report"]
    return ValueError(
        "this multi-job cluster is outside the CTMC envelope: "
        + "; ".join(reasons)
        + "; use core.multijob.simulate_multijob (or engine='auto') "
        "instead")


#: state entries extraction reads
_HOST_KEYS = (_MJ_JOB_METRICS + _MJ_CLUSTER_METRICS
              + ("phase", "run_durations", "n_runs", "cur_run", "hist",
                 "hist_edges"))


def _extract_point(host: Dict[str, np.ndarray], rows, J: int,
                   channels: tuple) -> Dict[str, object]:
    """Per-point result: a list of single-job-compatible array dicts
    (one per job -- ``metrics.aggregate_arrays`` consumes them directly)
    plus the cluster-level lanes.  ``host`` is the final state on the
    host (numpy)."""
    per_job: List[Dict[str, np.ndarray]] = []
    edges = (np.asarray(host["hist_edges"], np.float64)
             if "hist" in host and channels else None)
    for j in range(J):
        d: Dict[str, np.ndarray] = {}
        for m in _MJ_JOB_METRICS:
            d[m] = host[m][rows, j]
        d["lost_work"] = np.zeros_like(d["useful_work"])
        d["completed"] = np.asarray(host["phase"][rows, j] == DONE,
                                    np.float32)
        d["run_durations"] = host["run_durations"][rows, j]
        d["n_runs"] = host["n_runs"][rows, j]
        d["cur_run"] = host["cur_run"][rows, j]
        if edges is not None:
            hist = np.asarray(host["hist"][rows, j], np.float64)
            for ch_i, ch in enumerate(channels):
                d[f"hist_{ch}"] = hist[:, ch_i]
            d["hist_edges"] = edges
        per_job.append(d)
    out: Dict[str, object] = {"per_job": per_job}
    for m in _MJ_CLUSTER_METRICS:
        out[m] = host[m][rows]
    tt = np.stack([d["total_time"] for d in per_job], axis=-1)
    out["makespan"] = tt.max(-1)
    out["completed"] = np.asarray(
        np.prod([d["completed"] for d in per_job], axis=0), np.float32)
    return out


def _wrap_single_job(arrays: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Adapt a single-job CTMC result dict to the multi-job shape (the
    J=1, unbounded-shop reduction path)."""
    R = len(arrays["total_time"])
    zeros = np.zeros(R, np.float32)
    out: Dict[str, object] = {"per_job": [arrays]}
    out["makespan"] = np.asarray(arrays["total_time"])
    out["completed"] = np.asarray(arrays.get("completed", zeros + 1.0))
    for m in ("n_auto_repairs", "n_manual_repairs", "n_failed_repairs"):
        out[m] = np.asarray(arrays.get(m, zeros))
    for m in ("stall_handoffs", "n_shop_queued", "conservation_err"):
        out[m] = zeros
    return out


def simulate_multijob_ctmc_sweep(
        points: Sequence[Tuple[Params, Sequence[JobSpec]]],
        n_replicas: int = 1024, seed: int = 0,
        max_steps: Optional[int] = None,
        impl: Optional[str] = None,
        chunk_steps: Optional[int] = None,
        early_exit: bool = True,
        bucketed: bool = True,
        max_runs: Optional[int] = None,
        device=None,
        shards: Optional[int] = None) -> List[Dict[str, object]]:
    """Batched multi-job sweep: one batch per job-count group.

    ``points`` is a sequence of ``(cluster Params, [JobSpec, ...])``
    pairs.  Points sharing a job count J -- whatever their job sizes,
    lengths, rates, pool sizes or shop capacity, all of which are per-row
    values -- run as ONE flat (P*R,) batch on ``device`` (default the
    card; ``device="cpu"`` must be asked for), with pow2 shape bucketing
    and common random numbers exactly like the single-job sweep.
    ``impl`` overrides every point's ``event_race_impl`` (``None`` /
    ``"cuda"``: the multi-job chunk kernel on the card; ``"ref"``: the
    plain step loop); otherwise points split by it.  ``shards`` (default
    the grid's one ``Params.engine_shards``; a mixed grid raises) splits
    every batch's replica axis over that many devices, as the single-job
    sweep does (:func:`_mj_chunk_loop`).

    Returns one dict per point: ``per_job`` is a list of
    single-job-compatible array dicts (feed each to
    ``metrics.aggregate_arrays``), plus cluster lanes ``makespan``,
    ``stall_handoffs``, the shared-shop counters, ``n_shop_queued``,
    ``conservation_err`` (max per-step deviation of the server-count
    invariant -- exactly 0.0 in a correct run), and the all-jobs
    ``completed`` flag.

    Reduction: 1-job points with ``repair_servers == 0`` route through
    the single-job engine (the same results as a direct
    :func:`.vectorized.simulate_ctmc_sweep` call) -- the multi-job batch
    is only built when the multi-job machinery is actually needed.
    """
    dev = resolve_device(device)
    points = [(c, tuple(js)) for c, js in points]
    for c, js in points:
        if not supports_multijob(c, js):
            raise _unsupported_error(c, js)
        # the cluster-level job fields are unused in multi-job mode;
        # validate through a per-job surrogate (the event engine's
        # Coordinator params are built the same way)
        c.replace(job_size=js[0].job_size, job_length=js[0].job_length,
                  warm_standbys=js[0].warm_standbys).validate()
        total_needed = sum(j.job_size + j.warm_standbys for j in js)
        if c.working_pool_size < total_needed:
            raise ValueError(
                f"working pool {c.working_pool_size} cannot host "
                f"{len(js)} jobs needing {total_needed}")
    if not points:
        return []
    if len({c.histogram for c, _ in points}) > 1:
        raise ValueError(
            "all points of a batched multi-job sweep must share the same "
            "Params.histogram spec (the in-scan accumulator layout is "
            "per-batch); split the grid or unify the spec")

    results: List[Optional[Dict[str, object]]] = [None] * len(points)
    channels = _selected_channels(points[0][0].histogram)
    # replica sharding resolves as in the single-job sweep: the explicit
    # argument, else the grid's one Params value
    shards = vz._resolve_shards(shards, [c for c, _ in points])

    # group: the single-job reduction, then one group per job count
    single_idx = [i for i, (c, js) in enumerate(points)
                  if len(js) == 1 and c.repair_servers == 0]
    if single_idx:
        sp = [points[i][0].replace(job_size=points[i][1][0].job_size,
                                   job_length=points[i][1][0].job_length,
                                   warm_standbys=points[i][1][0]
                                   .warm_standbys)
              for i in single_idx]
        outs = vz.simulate_ctmc_sweep(
            sp, n_replicas=n_replicas, seed=seed, max_steps=max_steps,
            impl=impl, chunk_steps=chunk_steps, early_exit=early_exit,
            bucketed=bucketed, max_runs=max_runs, device=dev, shards=shards)
        for i, arr in zip(single_idx, outs):
            results[i] = _wrap_single_job(arr)

    groups: Dict[tuple, list] = {}
    for i, (c, js) in enumerate(points):
        if results[i] is None:
            impl_eff = impl if impl is not None else c.event_race_impl
            groups.setdefault((len(js), impl_eff), []).append(i)
    for (J, impl_eff), idxs in groups.items():
        pts = [points[i] for i in idxs]
        P, R = len(pts), n_replicas
        steps = max_steps or max(default_max_steps_multijob(c, js)
                                 for c, js in pts)
        chunk = min(chunk_steps or vz.DEFAULT_CHUNK_STEPS, steps)
        P_run, R_run = ((_next_pow2(P), _next_pow2(R)) if bucketed
                        else (P, R))
        if bucketed and max_steps is None:
            steps = -(-steps // chunk) * chunk
        mr = (max(c.max_run_records for c, _ in pts) if max_runs is None
              else max_runs)
        pv = np.stack([_mj_params_vector(c, js) for c, js in pts])
        if P_run != P:
            # padding rows are inert (every job DONE); repeating the last
            # real row keeps every column benign
            pv = np.concatenate([pv, np.repeat(pv[-1:], P_run - P, 0)])
        pv_flat = torch.as_tensor(np.repeat(pv, R_run, axis=0), device=dev)
        init_state = _mj_initial_state_batch(pts, R, mr, dev)
        if (P_run, R_run) != (P, R):
            init_state = vz._bucket_pad_state(init_state, P, R, P_run,
                                                R_run)
        args = (pv_flat, seed, P_run, R_run, chunk, steps // chunk,
                steps % chunk, J, impl_eff, early_exit, channels, init_state)
        out = _mj_chunk_loop(*args,
                             mesh=vz._shard_mesh(shards or 1, R_run, dev))
        host = vz.state_to_numpy({k: v for k, v in out.items()
                                  if k in _HOST_KEYS})
        for jg, i in enumerate(idxs):
            rows = slice(jg * R_run, jg * R_run + R)
            results[i] = _extract_point(host, rows, J, channels)
    return results


def simulate_multijob_ctmc(cluster: Params, jobs: Sequence[JobSpec],
                           n_replicas: int = 1024, seed: int = 0,
                           **kw) -> Dict[str, object]:
    """Single-point convenience wrapper over the batched sweep."""
    return simulate_multijob_ctmc_sweep([(cluster, tuple(jobs))],
                                        n_replicas=n_replicas, seed=seed,
                                        **kw)[0]
