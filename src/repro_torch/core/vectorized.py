"""Vectorized PyTorch CTMC engine: thousands of AIReSim replicas per device.

Counterpart of ``src/repro/core/vectorized.py`` for one job, under every
failure family of the reference's CTMC engine (exponential, Weibull,
bathtub, lognormal and empirical: piecewise-constant, builtin or a
registered distribution with ``hazard_segments()``), every repair family
(exponential, Weibull, lognormal, deterministic and empirical), and
correlated fault domains and campaigns with exponential repairs.  The
cluster is a continuous-time Markov chain over server *compartments* --
servers are exchangeable within (origin x health) classes, so counts are
sufficient state. Each step races the 16 exponential clock families
against the deterministic timers (job completion, recovery/host-selection
timer, the failure family's hazard residual where it has one, checkpoint
write) and then applies the winning transition with masked updates; a
non-exponential family's failures come from :mod:`.hazards` (Weibull by
exact inversion, the others by Ogata thinning on a ninth uniform). A
non-exponential repair family completes its repairs through the
repair-slot lane instead of the exponential repair clocks: each server in
the shop holds a slot with its remaining repair time, counted down in
wall-clock time, whose minimum is raced first among the residuals; a
duration is drawn by inverse CDF on one more uniform when a server enters
the shop or escalates. A fault-domain scenario (:mod:`.faultdomains`) adds
one exponential shock lane a domain to the race and races the campaign
schedule first among the residuals; a shock or scripted kill removes a
rounded fraction of every pool at once, refills the running block through
the standby -> working -> spare waterfall and carries any shortfall in a
``deficit`` lane, and a maintenance window gates the exponential repair
rates to zero. It draws no uniform of its own: the failure path's idle
lanes round the counts. The step carries checkpoint rollback, goodput, the
per-replica run-duration ring buffer and the streaming histograms exactly
as the reference does.

State is a dict of tensors with the reference's keys
(``_initial_state_batch``), on an explicit device.  The scan runs in
chunks of :data:`DEFAULT_CHUNK_STEPS` steps; the early-exit test (every
replica DONE) reads the device once per chunk.  On the card a chunk is one
launch of the hand-written CUDA kernel of
:mod:`repro_torch.kernels.ctmc_chunk`, which runs every step of the chunk
for every replica with the state in registers.  :func:`_steps_ref` is its
plain version, a Python loop of :func:`_step_u` with the plain event race,
taken on the CPU and for ``impl="ref"``; on the same state and draw the
two agree bit for bit.

Random numbers copy the *shape* of the reference's draws, not its bits
(torch's Philox cannot reproduce JAX's threefry): each chunk makes one
``(chunk, next_pow2(R), _n_uniforms(kind, rkind))`` draw from a
``torch.Generator`` on the run device seeded from ``(seed, chunk
index)``, clamped into ``[1e-12, 1)``, sliced to R and tiled across the
P points of a sweep.  That shape gives
common random numbers across sweep points and keeps pow2-bucketed sweeps
bit-identical to unbucketed ones on their real rows.

Sweeps flatten a (points x replicas) grid into one batch axis per
failure and repair family: every point shares one compartment layout, so
structural parameters enter as initial occupancies, and the point and
replica counts round up to powers of two with inert rows (phase DONE from
step 0) that extraction drops.

``Params.age_dtype="float64"`` keeps the failure-age lane ``age`` and the
repair-slot lane ``repair_rem`` in float64, the reference's carve-out for
the cancellation of the Weibull inversion at large ages; every other lane
stays float32, and the hazards of the thinning families and the race read
the float32 view, as in the reference.  Torch needs no flag for it.  Such
a batch runs the float64 instance of the chunk kernel.

``shards`` (default ``Params.engine_shards``; 0 unsharded) splits the
replica axis of every batch over that many devices
(:mod:`repro_torch.parallel.sharding`): each shard runs its own chunked
scan on its ``(P, R / n)`` replicas with its own seed, the shards' chunks
interleaved so that several cards overlap, and the replica axes are
concatenated back.  One shard is the unsharded run bit for bit.
What the reference's CTMC engine refuses (:func:`reference_reasons`)
runs on the port's event engine (:mod:`repro_torch.core.simulation`)
under ``engine="auto"``, as in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ctmc_chunk, ops
from ..parallel import sharding as rsharding
from . import faultdomains, hazards
from .histograms import HIST_CHANNELS
from .params import Params

COMPUTE, OVERHEAD, STALL, DONE = 0, 1, 2, 3
K_EXP = 16

_METRICS = ("total_time", "n_failures", "n_random_failures",
            "n_systematic_failures", "n_preemptions", "n_auto_repairs",
            "n_manual_repairs", "n_failed_repairs", "n_host_selections",
            "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed",
            "stall_time", "recovery_overhead", "lost_work", "useful_work",
            "checkpoint_overhead", "n_repair_overflow", "n_domain_shocks",
            "n_shock_killed", "n_campaign_events")

#: uniform draws per step on the exponential path
N_UNIFORMS = 8


def _n_uniforms(kind: str, rkind: str = "exponential") -> int:
    """Uniform draws per step: the exponential program keeps its 8-wide
    stream bit for bit; a non-exponential failure family adds one lane
    (the Exp(1) inversion draw for Weibull, the accept/reject draw of
    the thinning families) and a non-exponential repair family one more
    (u_dur, the entry or escalation duration draw).

    >>> _n_uniforms("exponential"), _n_uniforms("weibull")
    (8, 9)
    >>> _n_uniforms("exponential", "weibull"), _n_uniforms("lognormal",
    ...                                                     "weibull")
    (9, 10)
    """
    return N_UNIFORMS + (kind != "exponential") + (rkind != "exponential")


def reference_reasons(params: Params) -> list:
    """Why the reference's CTMC engine refuses these params (empty = runs).

    The reference's own reasons, word for word, decided as the reference
    decides them: by the built distribution (:func:`hazards.hazard_kind`
    / :func:`hazards.repair_kind`), not by its name.  Params with a reason
    here run on the event engine under ``engine="auto"`` in both packages.

    >>> reference_reasons(Params(failure_distribution="weibull"))
    []
    >>> reference_reasons(Params(standbys_can_fail=True))
    ['failing warm standbys are event-engine-only']
    """
    reasons = []
    if hazards.hazard_kind(params) is None:
        reasons.append(
            "failure distribution has no fast-path hazard family "
            "(closed-form exponential/weibull/bathtub/lognormal, an "
            "empirical fit, or a registered distribution with valid "
            "hazard_segments())")
    if hazards.repair_kind(params) is None:
        reasons.append(
            "repair distribution has no fast-path repair family "
            "(exponential/weibull/lognormal/deterministic, an empirical "
            "fit, or a registered distribution with valid "
            "hazard_segments())")
    if ((params.fault_domains is not None or params.campaign is not None)
            and hazards.repair_kind(params) != "exponential"):
        reasons.append(
            "fault domains / campaigns require exponential repairs on "
            "the fast path (a struck in-shop server would need a "
            "per-slot redraw)")
    if params.repair_servers != 0:
        reasons.append(
            "finite repair-shop capacity (repair_servers > 0) — the "
            "multi-job CTMC engine models it; the single-job program "
            "has no queue compartment")
    if params.retirement_threshold != 0:
        reasons.append("retirement policies are event-engine-only")
    if params.bad_set_regeneration_period != 0:
        reasons.append("bad-set regeneration is event-engine-only")
    if params.standbys_can_fail:
        reasons.append("failing warm standbys are event-engine-only")
    return reasons


def port_reasons(params: Params) -> list:
    """What of the reference's CTMC envelope these params need and the
    port's CTMC engine does not run yet, each with its ROADMAP item.

    Nothing: every failure and repair family of the reference's CTMC
    engine runs here (a one-segment ``Empirical`` collapses to the
    exponential program, as in the reference), and so do fault domains
    and campaigns, float64 age and replica sharding.  Kept so that
    :func:`unsupported_reasons` and ``backend.resolve_engine`` can name a
    part that a later reference adds before the port has it.

    >>> from .faultdomains import FaultTopology
    >>> port_reasons(Params())
    []
    >>> port_reasons(Params(fault_domains=FaultTopology(n_racks=8)))
    []
    >>> port_reasons(Params(engine_shards=2, age_dtype="float64"))
    []
    """
    return []


def unsupported_reasons(params: Params) -> list:
    """Why these params are outside the port's CTMC path (empty = inside).

    The reference's reasons (:func:`reference_reasons`) followed by the
    port's own (:func:`port_reasons`).

    >>> unsupported_reasons(Params())
    []
    >>> unsupported_reasons(Params(retirement_threshold=3))
    ['retirement policies are event-engine-only']
    """
    return reference_reasons(params) + port_reasons(params)


def supports(params: Params) -> bool:
    """Can the port's CTMC engine simulate these params?

    >>> supports(Params())                                    # Table-I default
    True
    >>> supports(Params(failure_distribution="weibull"))
    True
    >>> supports(Params(repair_distribution="weibull"))
    True
    >>> supports(Params(engine_shards=2, age_dtype="float64"))
    True
    """
    return not unsupported_reasons(params)


def _unsupported_error(params: Params) -> ValueError:
    reasons = unsupported_reasons(params) \
        or ["unknown reason — please report"]
    return ValueError(
        "these Params are outside the port's CTMC engine: "
        + "; ".join(reasons))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def _initial_counts(p: Params):
    total = p.working_pool_size + p.spare_pool_size
    n_bad = int(round(p.systematic_failure_fraction * total))
    bad_w = round(n_bad * p.working_pool_size / total)
    bad_s = n_bad - bad_w

    def split(n_take, pool_good, pool_bad):
        frac_bad = pool_bad / max(pool_good + pool_bad, 1)
        take_bad = int(round(n_take * frac_bad))
        return n_take - take_bad, take_bad

    w_good, w_bad = p.working_pool_size - bad_w, bad_w
    run_g, run_b = split(p.job_size, w_good, w_bad)
    w_good -= run_g
    w_bad -= run_b
    n_sb = min(p.warm_standbys, w_good + w_bad)
    sb_g, sb_b = split(n_sb, w_good, w_bad)
    w_good -= sb_g
    w_bad -= sb_b
    return {
        "run": [run_g, run_b, 0, 0],
        "sb": [sb_g, sb_b, 0, 0],
        "fw": [w_good, w_bad, 0, 0],
        "fs": [0, 0, p.spare_pool_size - bad_s, bad_s],
    }


def _age_dtype(p: Params) -> torch.dtype:
    """Dtype of the failure-age and repair-slot lanes
    (``Params.age_dtype``).  The reference needs JAX's x64 flag for
    float64; torch needs none.

    >>> _age_dtype(Params()), _age_dtype(Params(age_dtype="float64"))
    (torch.float32, torch.float64)
    """
    return torch.float64 if p.age_dtype == "float64" else torch.float32


def _initial_state_batch(pts: Sequence[Params], R: int, max_runs: int,
                         device, rkind: str = "exponential",
                         n_slots: int = 0,
                         scen=None) -> Dict[str, torch.Tensor]:
    """Padded initial state for a structural grid, point-major (P*R, ...).

    All points share one compartment layout, so structural parameters
    (job_size, pool sizes, warm_standbys, systematic fraction, job_length,
    host-selection offset) enter purely as per-point initial values:
    compartments a small point does not populate sit at zero occupancy and
    carry zero rates.  ``rkind`` / ``n_slots`` size the repair-slot lane
    of a non-exponential repair family.  ``scen`` is the scenario key
    ``(D, codes)`` of :func:`faultdomains.scenario_key`: it adds the
    replacement-deficit lane, the per-domain shock counts (D > 0), the
    schedule pointer (a non-empty schedule) and the maintenance flag (a
    schedule with a window).  The keys are the reference's, and so are
    the dtypes: ``age`` and ``repair_rem`` take the first point's
    :func:`_age_dtype`.
    """
    P = len(pts)
    B = P * R
    counts = [_initial_counts(p) for p in pts]
    f32 = dict(dtype=torch.float32, device=device)
    adt = dict(dtype=_age_dtype(pts[0]), device=device)

    def tile(key):
        arr = np.asarray([c[key] for c in counts], np.float32)   # (P, 4)
        return torch.as_tensor(np.repeat(arr, R, axis=0), **f32)

    def per_point(vals):
        return torch.as_tensor(np.repeat(np.asarray(vals, np.float32), R),
                               **f32)

    state = {k: tile(k) for k in ("run", "sb", "fw", "fs")}
    state["auto"] = torch.zeros((B, 4), **f32)
    state["man"] = torch.zeros((B, 4), **f32)
    state["t"] = per_point([p.host_selection_time for p in pts])
    state["work_left"] = per_point([p.job_length for p in pts])
    state["timer"] = torch.full((B,), torch.inf, **f32)
    state["stall_start"] = torch.zeros((B,), **f32)
    state["phase"] = torch.full((B,), COMPUTE, dtype=torch.int32,
                                device=device)
    #: phase age: compute minutes since the job last (re)started (the
    #: hazard clock of the non-exponential families; inert here)
    state["age"] = torch.zeros((B,), **adt)
    if rkind != "exponential":
        # repair-slot lane: one (remaining, class, stage) triple per
        # server in the shop; remaining counts down in wall-clock time
        # and never resets with the job.  +inf marks a free slot.
        i32 = dict(dtype=torch.int32, device=device)
        state["repair_rem"] = torch.full((B, n_slots), torch.inf, **adt)
        state["repair_cls"] = torch.zeros((B, n_slots), **i32)
        state["repair_stage"] = torch.zeros((B, n_slots), **i32)
    state["cur_run"] = torch.zeros((B,), **f32)
    #: compute minutes since the last durable checkpoint
    state["ckpt_work"] = torch.zeros((B,), **f32)
    #: 1.0 while the OVERHEAD phase is a checkpoint *write*
    state["in_ckpt"] = torch.zeros((B,), **f32)
    state["n_runs"] = torch.zeros((B,), dtype=torch.int32, device=device)
    state["run_durations"] = torch.zeros((B, max_runs), **f32)
    spec = pts[0].histogram
    sel = _selected_channels(spec)
    if sel:
        # only the selected channels are carried; the grid shares the
        # first point's bin layout, with edges in float32 as in the
        # reference's scan
        state["hist"] = torch.zeros((B, len(sel), spec.n_counts), **f32)
        state["hist_edges"] = torch.as_tensor(spec.edges(), **f32)
    if scen is not None:
        n_dom, codes = scen
        # replacements still owed after bulk kills: the job unstalls only
        # once the whole struck block is restored
        state["deficit"] = torch.zeros((B,), **f32)
        if n_dom:
            state["domain_shocks"] = torch.zeros((B, n_dom), **f32)
        if codes:
            state["camp_idx"] = torch.zeros((B,), dtype=torch.int32,
                                            device=device)
        if faultdomains.MAINT_START in codes:
            state["maint"] = torch.zeros((B,), **f32)
    for m in _METRICS:
        state[m] = torch.zeros((B,), **f32)
    return state


#: state entries with no leading replica axis
_UNBATCHED_STATE = ("hist_edges",)


def _selected_channels(spec) -> tuple:
    """Channels carried through the scan, in fixed HIST_CHANNELS order."""
    if spec is None:
        return ()
    return tuple(ch for ch in HIST_CHANNELS if ch in spec.channels)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _bucket_pad_state(state: Dict[str, torch.Tensor], P: int, R: int,
                      P_pad: int, R_pad: int) -> Dict[str, torch.Tensor]:
    """Pad a (P*R, ...) point-major state to (P_pad*R_pad, ...).

    Padding rows start in phase DONE with zero occupancies, so they carry
    zero rates and are inert for the whole scan, early-exit test
    included.  Extraction drops them.
    """
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if k in _UNBATCHED_STATE:
            out[k] = v
            continue
        v = v.reshape((P, R) + v.shape[1:])
        padded = v.new_zeros((P_pad, R_pad) + v.shape[2:])
        padded[:P, :R] = v
        out[k] = padded.reshape((P_pad * R_pad,) + v.shape[2:])
    phase = out["phase"].reshape(P_pad, R_pad, -1)     # (B,) or (B, J)
    phase[P:] = DONE
    phase[:, R:] = DONE
    return out


def _initial_state(p: Params, R: int, max_runs: Optional[int] = None,
                   device="cpu") -> Dict[str, torch.Tensor]:
    rkind = hazards.repair_kind(p) or "exponential"
    return _initial_state_batch(
        [p], R, p.max_run_records if max_runs is None else max_runs, device,
        rkind, _repair_slots_for([p], rkind), faultdomains.scenario_key(p))


def _repair_slots_for(pts, rkind: str) -> int:
    """Repair-slot lane width for a batch of points (host-side).

    Twice the expected shop occupancy (Little's law,
    :func:`hazards.expected_repair_occupancy`) plus eight standard
    deviations of the Poisson in-shop count, rounded up to a power of two
    but never past the physical bound (every server in the shop at once),
    where overflow is impossible.  An infinite-mean stage takes that
    bound.  ``Params.repair_slots > 0`` overrides a point's estimate.

    >>> _repair_slots_for([Params()], "exponential")
    0
    >>> _repair_slots_for([Params(repair_distribution="weibull")], "weibull")
    128
    """
    if rkind == "exponential":
        return 0
    n = 1
    for p in pts:
        total = p.working_pool_size + p.spare_pool_size
        if p.repair_slots > 0:
            want = min(p.repair_slots, total)
        else:
            occ = hazards.expected_repair_occupancy(p)
            if not math.isfinite(occ):
                occ = float(total)
            want = min(int(2.0 * occ + 8.0 * math.sqrt(max(occ, 1.0)) + 8.0),
                       total)
        n = max(n, min(_next_pow2(want), total))
    return n


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """The port's state from a dict of numpy arrays (dtypes kept).

    ``{k: np.asarray(v) for k, v in reference_state.items()}`` goes in
    unchanged, which is how the step-parity tests hand one state to both
    engines.
    """
    return {k: torch.as_tensor(np.array(v, copy=True), device=device)
            for k, v in arrays.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A dict of numpy arrays from the port's state (dtypes kept)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def _lane_consts(device: torch.device):
    """``(bad_mask (4,) f32, lanes (4,) i32)`` on ``device``, made once.

    Building them per step from Python lists would copy host to device
    on every step.  ``bad_mask`` is pinned to float32.
    """
    lanes = torch.arange(4, dtype=torch.int32, device=device)
    return (lanes % 2).to(torch.float32), lanes


def _pick_classes(counts: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draws proportional to counts over the last axis: (..., K)
    x (...) -> (...) int32.  Counts are whole numbers, so the sum and the
    cumulative sum are exact in any order."""
    total = counts.sum(-1).clamp_min(1e-30)
    cdf = counts.cumsum(-1) / total[..., None]
    return (u[..., None] >= cdf).sum(-1).clamp_max(counts.shape[-1] - 1) \
        .to(torch.int32)


def _onehot(c: torch.Tensor) -> torch.Tensor:
    """float32 one-hot over the 4 classes (an out-of-range index gives a
    zero row, as ``jax.nn.one_hot`` does; no host sync)."""
    _, lanes = _lane_consts(c.device)
    return (c[..., None] == lanes).to(torch.float32)


def _at(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``block[b, idx[b]]`` of a (B, n) column block, or ``block[idx]`` of
    a shared row's (n,) block."""
    idx = idx.long()
    if block.ndim == 1:
        return block[idx]
    return block[torch.arange(idx.shape[0], device=idx.device), idx]


def _pos(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with a +0 for every zero (a -0 from ``ceil(-u)`` included),
    so the result has one bit pattern on every device."""
    return torch.where(x > 0, x, 0.0)


def _syscomp(tgt: torch.Tensor, uu: torch.Tensor) -> torch.Tensor:
    """Systematic rounding of fractional per-class targets ``tgt`` (...,
    4): per-class counts n_c in {floor(tgt_c), ceil(tgt_c)} that sum to the
    stochastic rounding of ``tgt.sum(-1)``, one uniform of ``uu`` (...)
    driving both.  With integer occupancies and tgt_c <= count_c, n_c <=
    count_c.  The cumsum runs left to right, the chunk kernel's order;
    every operation is elementwise, so several pools' targets stacked in
    one call round as they would one by one."""
    c = hazards._seq_cumsum(tgt)
    c_prev = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)
    return _pos(torch.ceil(c - uu[..., None])) \
        - _pos(torch.ceil(c_prev - uu[..., None]))


#: golden-ratio shifts that decorrelate the three waterfall takes of a
#: bulk kill, which share u_pool
_PHI = 0.6180339887498949


# ---------------------------------------------------------------------------
# one transition
# ---------------------------------------------------------------------------

def _step_u(s: Dict[str, torch.Tensor], u: torch.Tensor, pv: torch.Tensor,
            impl: Optional[str] = None,
            hist_channels: tuple = HIST_CHANNELS,
            kind: str = "exponential",
            n_seg: int = 0, rkind: str = "exponential",
            n_rseg: int = 0, scen=None) -> Dict[str, torch.Tensor]:
    """One CTMC transition for a batch of replicas, with given uniforms.

    ``u`` is ``(B, _n_uniforms(kind, rkind))``.  ``pv`` is either one
    parameter vector shared by the batch or a ``(B, n_cols)`` matrix with
    one row per replica (the sweep layout); columns 0..15 are the base
    model parameters, the next ``hazards.hazard_col_count(kind, n_seg)``
    the failure family's and the ``hazards.repair_col_count(rkind,
    n_rseg)`` after those the repair family's (``n_seg`` / ``n_rseg`` are
    the empirical segment counts).  ``hist_channels`` is the tuple of
    channels ``s["hist"]`` carries.  ``scen`` is the scenario key ``(D,
    codes)``: the ``2D + 3L`` scenario columns of
    :func:`faultdomains.scenario_columns` follow the repair block, the
    race gains D shock lanes after the 16 and, for a schedule of L > 0
    entries, a campaign residual before every other.  Scenarios run with
    exponential repairs only.  Returns a new state dict; ``s`` is left as
    it was.
    """
    n_hc = hazards.hazard_col_count(kind, n_seg)
    n_rc = hazards.repair_col_count(rkind, n_rseg)
    if pv.ndim == 1:
        cols = [pv[i] for i in range(16)]
        _c = lambda x: x            # noqa: E731  param vs (B, 4) arrays
    else:
        cols = [pv[:, i] for i in range(16)]
        _c = lambda x: x[:, None]   # noqa: E731
    (r_rand, r_sys, recovery, host_sel, waiting, auto_t, man_t,
     auto_fail, man_fail, p_auto, dp, du, ckpt, preempt_cost,
     warm_standbys, ckpt_cost) = cols

    def _vcol(lo, n):
        # a contiguous column block (shared row or per-replica matrix)
        return pv[lo:lo + n] if pv.ndim == 1 else pv[:, lo:lo + n]

    if kind == "empirical":
        # [rand edges (m-1), rand rates (m), sys edges (m-1), sys rates
        # (m)] -- per-clock piecewise-constant hazards (hazard_columns)
        e_re = _vcol(16, n_seg - 1)
        e_rr = _vcol(16 + n_seg - 1, n_seg)
        e_se = _vcol(16 + 2 * n_seg - 1, n_seg - 1)
        e_sr = _vcol(16 + 3 * n_seg - 2, n_seg)
    hz = [pv[i] if pv.ndim == 1 else pv[:, i]
          for i in range(16, 16 + n_hc)]
    if rkind == "empirical":
        # [auto edges, auto rates, manual edges, manual rates]; the stage
        # is selected at slot entry below
        r0 = 16 + n_hc
        r_ae = _vcol(r0, n_rseg - 1)
        r_ar = _vcol(r0 + n_rseg - 1, n_rseg)
        r_me = _vcol(r0 + 2 * n_rseg - 1, n_rseg - 1)
        r_mr = _vcol(r0 + 3 * n_rseg - 2, n_rseg)
    elif rkind != "exponential":
        # [auto scale, manual scale, shape]
        rz = [pv[i] if pv.ndim == 1 else pv[:, i]
              for i in range(16 + n_hc, 16 + n_hc + n_rc)]
    if scen is not None:
        # [shock rates (D), fleet fractions (D), entry times (L), kill
        # fractions (L), target domains (L)]; D, L and the codes are the
        # key's.  A kill needs only its fraction, so the target domains
        # are not read.
        n_dom, codes = scen
        n_camp = len(codes)
        has_maint = faultdomains.MAINT_START in codes
        c0 = 16 + n_hc + n_rc
        shock_rate = _vcol(c0, n_dom)
        dom_frac = _vcol(c0 + n_dom, n_dom)
        camp_t = _vcol(c0 + 2 * n_dom, n_camp)
        camp_frac = _vcol(c0 + 2 * n_dom + n_camp, n_camp)
    lanes = u.unbind(1)
    u_time, u_pick, u_diag, u_wrong, u_cls, u_esc, u_succ, u_pool = \
        lanes[:N_UNIFORMS]
    u_haz = lanes[N_UNIFORMS] if kind != "exponential" else None
    u_dur = lanes[-1] if rkind != "exponential" else None

    phase = s["phase"]
    computing = phase == COMPUTE
    in_overhead = phase == OVERHEAD
    stalled = phase == STALL
    active = phase != DONE
    # OVERHEAD flavor: a checkpoint *write* (timer expiry resumes compute
    # without resetting the hazard age) vs a recovery/restart (which does)
    in_ckpt_flag = s["in_ckpt"] > 0
    B = phase.shape[0]
    device = phase.device

    # ---- rates (B, 16) ------------------------------------------------
    run = s["run"]
    age = s["age"]
    # the thinning families' hazards read the float32 view: the float64
    # carve-out is for the Weibull inversion and the repair countdown, not
    # for the well-conditioned hazard ratios (the reference's age32)
    age32 = age.to(torch.float32)
    bad_mask, _ = _lane_consts(device)
    haz_resid = None
    if kind == "weibull":
        # exact conditional inversion: the fleet's cumulative hazard is
        # C * age**k, so the time to the next failure enters the race as
        # a residual and the failure channels carry no rate; haz_cum
        # accumulates the per-channel hazard shares for the failing-class
        # pick
        c_rand, c_sys, w_k = hz[0], hz[1], hz[2]
        w_rand = run * _c(c_rand) * computing[:, None]
        w_sys = run * bad_mask[None, :] * _c(c_sys) * computing[:, None]
        haz_cum = hazards._seq_cumsum(torch.cat([w_rand, w_sys], -1))
        haz_total = haz_cum[:, -1]
        haz_resid = hazards.FAILURE_SAMPLERS["weibull"].conditional_residual(
            age, haz_total, w_k, -torch.log(u_haz))
        fail_rand = torch.zeros_like(run)
        fail_sys = torch.zeros_like(run)
    elif kind == "bathtub":
        # Ogata thinning: scale the propensities by the window majorant
        # g_bar = max(g(age), g(age + W)) and race a window-expiry
        # phantom W; a winning candidate is accepted below with
        # probability g(age + dt) / g_bar
        b_win = hz[4]
        g_bar = hazards.FAILURE_SAMPLERS["bathtub"].majorant(
            age32, b_win, tuple(hz[:4]))
        fail_rand = run * _c(r_rand) * g_bar[:, None] * computing[:, None]
        fail_sys = run * bad_mask[None, :] * _c(r_sys) * g_bar[:, None] \
            * computing[:, None]
        haz_resid = torch.where(computing, b_win * torch.ones_like(age32),
                                torch.inf)
    elif kind == "lognormal":
        # thinning against the hazard at the mode clipped into the
        # window, one majorant and accept ratio per clock
        ln = hazards.FAILURE_SAMPLERS["lognormal"]
        l_sr, l_ss, l_sig, l_mode, l_win = hz
        hbar_r = ln.majorant(age32, l_win, (l_sr, l_sig, l_mode))
        hbar_s = ln.majorant(age32, l_win, (l_ss, l_sig, l_mode))
        fail_rand = run * hbar_r[:, None] * computing[:, None]
        fail_sys = run * bad_mask[None, :] * hbar_s[:, None] \
            * computing[:, None]
        # both clocks disabled => zero window; disarm the expiry timer
        win_eff = torch.where(l_win > 0, l_win, torch.inf)
        haz_resid = torch.where(computing, win_eff * torch.ones_like(age32),
                                torch.inf)
    elif kind == "empirical":
        # thinning with the exact majorant (the current segment rate)
        # over a window that runs to the next edge of either clock
        pe = hazards.FAILURE_SAMPLERS["empirical"]
        hbar_r = pe.hazard(age32, (e_re, e_rr))
        hbar_s = pe.hazard(age32, (e_se, e_sr))
        fail_rand = run * hbar_r[:, None] * computing[:, None]
        fail_sys = run * bad_mask[None, :] * hbar_s[:, None] \
            * computing[:, None]
        win = torch.minimum(hazards.piecewise_next_edge(age32, e_re),
                            hazards.piecewise_next_edge(age32, e_se))
        haz_resid = torch.where(computing, win, torch.inf)
    else:
        fail_rand = run * _c(r_rand) * computing[:, None]
        fail_sys = run * bad_mask[None, :] * _c(r_sys) * computing[:, None]
    if rkind == "exponential":
        auto_rate = s["auto"] / _c(auto_t).clamp_min(1e-9)
        man_rate = s["man"] / _c(man_t).clamp_min(1e-9)
    else:
        # repairs complete through the slot lane's residual; the auto /
        # man compartments stay as bookkeeping and carry no rate
        auto_rate = torch.zeros_like(run)
        man_rate = torch.zeros_like(run)
    rate_parts = [fail_rand, fail_sys, auto_rate, man_rate]
    kx = K_EXP
    if scen is not None:
        if has_maint:
            # a maintenance window darkens the shop: gating the exponential
            # repair rates to zero pauses and resumes it exactly
            # (memorylessness)
            repair_on = (s["maint"] == 0.0)[:, None]
            rate_parts[2] = torch.where(repair_on, auto_rate, 0.0)
            rate_parts[3] = torch.where(repair_on, man_rate, 0.0)
        if n_dom:
            # one shock clock a fault domain, live in every phase but DONE
            rate_parts.append(shock_rate.expand(B, n_dom))
            kx = K_EXP + n_dom
    rates = torch.cat(rate_parts, -1) * active[:, None]

    # residual column order decides exact ties (the race takes the first
    # minimum): a scenario's campaign entry, then the repair-slot residual
    # (a repair completing at
    # the instant the job completes resolves first, as the event engine's
    # heap does; the job completes on the next step at dt = 0), job
    # completion, the recovery timer, the failure family's hazard
    # residual, then the checkpoint write, appended last so a completion
    # beats a same-instant write.  At checkpoint_interval == 0 that
    # column is +inf throughout.
    resid_cols = []
    coff = 0
    if scen is not None and n_camp:
        # the schedule's next entry, raced before every other residual: an
        # entry at the instant of a timer or completion fires first, the
        # tie the event engine's injector breaks the same way; same-time
        # entries take successive dt = 0 steps in schedule order
        ci = s["camp_idx"].clamp(0, n_camp - 1)
        camp_pending = active & (s["camp_idx"] < n_camp)
        resid_cols.append(torch.where(
            camp_pending, (_at(camp_t, ci) - s["t"]).clamp_min(0.0),
            torch.inf))
        coff = 1
    roff = 0
    if rkind != "exponential":
        rep_rem = s["repair_rem"]
        # the minimum in the lane's dtype, raced in float32
        resid_cols.append(torch.where(
            active, rep_rem.amin(-1).to(torch.float32), torch.inf))
        roff = 1
    resid_cols += [torch.where(computing, s["work_left"], torch.inf),
                   torch.where(in_overhead, s["timer"], torch.inf)]
    if haz_resid is not None:
        resid_cols.append(haz_resid)
    resid_cols.append(torch.where(computing & (ckpt > 0),
                                  (ckpt - s["ckpt_work"]).clamp_min(0.0),
                                  torch.inf))
    residuals = torch.stack(resid_cols, dim=-1)

    dt, ev = ops.event_race(rates, residuals, u_time, u_pick, impl=impl)
    dt = torch.where(active & torch.isfinite(dt), dt, 0.0)

    cls = ev % 4
    is_fail = active & (ev < 8)
    is_sys = active & (ev >= 4) & (ev < 8)
    if kind == "weibull":
        # the failure arrives on the hazard residual; pick the failing
        # channel from the hazard shares.  u_pick is consumed by the race
        # only when an exponential channel wins, so it is fresh here.
        total_w = haz_total.clamp_min(1e-30)
        cdf8 = haz_cum / total_w[:, None]
        pick8 = (u_pick[:, None] >= cdf8).sum(-1).clamp_max(7) \
            .to(torch.int32)
        haz_fail = active & (ev == kx + coff + roff + 2)
        is_fail = haz_fail
        is_sys = haz_fail & (pick8 >= 4)
        cls = torch.where(haz_fail, pick8 % 4, cls)
    elif kind == "bathtub":
        # accept/reject: a rejected candidate (and the window expiry) is
        # a phantom -- time and work advance, no transition fires
        g_at = hazards.FAILURE_SAMPLERS["bathtub"].hazard(age32 + dt,
                                                         tuple(hz[:4]))
        accept = u_haz * g_bar < g_at
        is_fail = is_fail & accept
        is_sys = is_sys & accept
    elif kind == "lognormal":
        h_r = ln.hazard(age32 + dt, (l_sr, l_sig))
        h_s = ln.hazard(age32 + dt, (l_ss, l_sig))
        cand_sys = (ev >= 4) & (ev < 8)
        accept = u_haz * torch.where(cand_sys, hbar_s, hbar_r) \
            < torch.where(cand_sys, h_s, h_r)
        is_fail = is_fail & accept
        is_sys = is_sys & accept
    elif kind == "empirical":
        # inside the window the hazard equals the majorant, so this
        # accepts; it bites only where rounding lands age + dt across an
        # edge, where the new segment's rate keeps the process exact
        h_r = pe.hazard(age32 + dt, (e_re, e_rr))
        h_s = pe.hazard(age32 + dt, (e_se, e_sr))
        cand_sys = (ev >= 4) & (ev < 8)
        accept = u_haz * torch.where(cand_sys, hbar_s, hbar_r) \
            <= torch.where(cand_sys, h_s, h_r)
        is_fail = is_fail & accept
        is_sys = is_sys & accept
    if rkind == "exponential":
        is_auto = active & (ev >= 8) & (ev < 12)
        is_man = active & (ev >= 12) & (ev < 16)
    else:
        # a slot's repair completed: the winning slot's class and stage
        # drive the completion logic the exponential channels feed
        srows = torch.arange(B, device=device)
        won_slot = torch.argmin(rep_rem, dim=-1)
        is_rep = active & (ev == kx + coff)
        done_stage = s["repair_stage"][srows, won_slot]
        cls = torch.where(is_rep, s["repair_cls"][srows, won_slot], cls)
        is_auto = is_rep & (done_stage == 0)
        is_man = is_rep & (done_stage == 1)
    is_complete = active & (ev == kx + coff + roff)
    is_timer = active & (ev == kx + coff + roff + 1)
    # the checkpoint write is the last residual column
    is_ckpt = active & (ev == kx + len(resid_cols) - 1)

    if scen is not None:
        # ---- shock and campaign sizing ----------------------------------
        # a shock arrives on lanes [K_EXP, kx), a campaign entry on the
        # first residual.  Either excludes every other event of its step,
        # so the failure path's idle uniforms (u_diag .. u_succ, u_pool)
        # round the per-pool kill counts and no lane is drawn for them: a
        # zero-rate, empty scenario keeps the scenario-free stream
        no = torch.zeros_like(active)
        if n_dom:
            is_shock = active & (ev >= K_EXP) & (ev < kx)
            shock_dom = (ev - K_EXP).clamp(0, n_dom - 1)
        else:
            is_shock, shock_dom = no, torch.zeros_like(ev)
        if n_camp:
            is_camp = camp_pending & (ev == kx)
            code = ctmc_chunk.schedule_codes(codes, device)[ci.long()]
            is_kill = is_camp & (code == faultdomains.KILL)
            is_m_on = is_camp & (code == faultdomains.MAINT_START)
            is_m_off = is_camp & (code == faultdomains.MAINT_END)
            kfrac = _at(camp_frac, ci)
        else:
            is_camp = is_kill = is_m_on = is_m_off = no
            kfrac = torch.zeros_like(u_time)
        struck = is_shock | is_kill
        frac = torch.where(is_kill, kfrac, _at(dom_frac, shock_dom) if n_dom
                           else torch.zeros_like(u_time))
        # the four pools' kills in one stacked rounding (B, 4 pools, 4
        # classes): run on u_diag, standby on u_wrong, free working on
        # u_cls, free spare on u_esc
        pools = torch.stack([run, s["sb"], s["fw"], s["fs"]], 1)
        rm = _syscomp(pools * frac[:, None, None],
                      torch.stack([u_diag, u_wrong, u_cls, u_esc], 1)) \
            * struck.to(torch.float32)[:, None, None]
        rm_run, rm_sb, rm_fw, rm_fs = rm.unbind(1)
        k_run, k_sb, k_fw, k_fs = rm.sum(-1).unbind(1)
        # struck servers already in the shop re-break: under exponential
        # stages that is a no-op in law, so they are counted, not moved
        shop = (s["auto"].sum(-1) + s["man"].sum(-1)).clamp_min(0.0)
        x = shop * frac
        x_fl = torch.floor(x)
        k_shop = torch.where(
            struck, x_fl + (u_succ < x - x_fl).to(torch.float32), 0.0)
        # bulk replacement through the single failure's waterfall, sized
        # on the pools left after the kill (integers: the min-chain is
        # exact)
        left = pools[:, 1:] - rm[:, 1:]                     # (B, 3, 4)
        rem = (pools[:, 1:].sum(-1) - rm[:, 1:].sum(-1)).clamp_min(0.0)
        sb_rem, fw_rem, fs_rem = rem.unbind(1)
        t_sb = torch.minimum(k_run, sb_rem)
        t_fw = torch.minimum(k_run - t_sb, fw_rem)
        t_fs = torch.minimum(k_run - t_sb - t_fw, fs_rem)
        shortfall = (k_run - t_sb - t_fw - t_fs).clamp_min(0.0)
        # the three takes in one stacked rounding, t of a pool's rem
        # servers each; they share u_pool (idle on a struck step), shifted
        # by the golden ratio: totals stay exact, only a bulk event's
        # class split is approximated
        take = torch.stack([t_sb, t_fw, t_fs], 1)
        mv_sb, mv_fw, mv_fs = _syscomp(
            left * (take / rem.clamp_min(1.0))[..., None],
            torch.stack([u_pool, torch.remainder(u_pool + _PHI, 1.0),
                         torch.remainder(u_pool + 2.0 * _PHI, 1.0)], 1)
        ).unbind(1)
        sh_affects = struck & (k_run > 0)
        # a full refill while already stalled leaves the STALL: the first
        # deficit is still owed
        sh_resolves = sh_affects & (shortfall <= 1e-6) & ~stalled
        sh_stalls = sh_affects & ~sh_resolves
        # one group restart: host selection and preemption waits overlap
        # across the block, so they are charged once an event
        shock_timer = (recovery
                       + torch.where(t_fw + t_fs > 1e-6, host_sel, 0.0)) \
            + torch.where(t_fs > 1e-6, waiting + preempt_cost, 0.0)

    ns = dict(s)
    ns["t"] = s["t"] + dt

    # ---- progress accounting -------------------------------------------
    # work accrues during every COMPUTE interval whichever event ends it;
    # a failure (or a shock that guts the running block, a checkpoint
    # write included) rolls back to the last durable checkpoint
    # (``ckpt_work`` is the work since the last write), so ``banked`` goes
    # negative on a failing step.  checkpoint_interval == 0 never loses
    # work.
    progress = torch.where(computing, dt, 0.0)
    rollback = is_fail
    if scen is not None:
        rollback = rollback | (sh_affects & (computing | in_ckpt_flag))
    new_ckpt_work = s["ckpt_work"] + progress
    lost = torch.where(rollback & (ckpt > 0), new_ckpt_work, 0.0)
    banked = progress - lost
    ns["work_left"] = s["work_left"] - banked
    ns["useful_work"] = s["useful_work"] + banked
    ns["lost_work"] = s["lost_work"] + lost
    ns["ckpt_work"] = torch.where(rollback | is_ckpt | is_complete,
                                  0.0, new_ckpt_work)

    # ---- completion / timer ----------------------------------------------
    timer_dec = torch.where(in_overhead, s["timer"] - dt, s["timer"])
    phase_n = torch.where(is_complete, DONE, phase)
    phase_n = torch.where(is_timer, COMPUTE, phase_n)
    timer_n = torch.where(is_timer, torch.inf, timer_dec)
    ns["total_time"] = torch.where(is_complete, ns["t"], s["total_time"])

    # ---- checkpoint writes ----------------------------------------------
    # a paid write runs as an OVERHEAD interval flagged in_ckpt; a free
    # write (checkpoint_cost == 0) banks the checkpoint without leaving
    # COMPUTE
    paid_ckpt = is_ckpt & (ckpt_cost > 0)
    phase_n = torch.where(paid_ckpt, OVERHEAD, phase_n)
    timer_n = torch.where(paid_ckpt, ckpt_cost, timer_n)
    ns["in_ckpt"] = torch.where(is_timer, 0.0,
                                torch.where(paid_ckpt, 1.0, s["in_ckpt"]))
    ns["checkpoint_overhead"] = s["checkpoint_overhead"] \
        + torch.where(in_ckpt_flag, dt, 0.0)

    # ---- exact run durations -------------------------------------------
    # a run is one useful-compute interval between restarts; records land
    # in a ring buffer at slot n_runs % max_runs (max_runs == 0 leaves
    # the buffer out)
    record = rollback | is_complete
    run_val = s["cur_run"] + progress
    max_runs = s["run_durations"].shape[1]
    if max_runs:
        rows = torch.arange(B, device=device)
        slot = (s["n_runs"] % max_runs).long()
        kept = s["run_durations"][rows, slot]
        buf = s["run_durations"].clone()
        buf.index_put_((rows, slot), torch.where(record, run_val, kept))
        ns["run_durations"] = buf
    ns["n_runs"] = s["n_runs"] + record.to(torch.int32)
    ns["cur_run"] = torch.where(record, 0.0, run_val)

    # ---- phase age --------------------------------------------------------
    # a recovery/restart timer resets the failure clocks; a checkpoint
    # write's does not (float64 under the carve-out: age + progress
    # promotes)
    ns["age"] = torch.where(is_timer & ~in_ckpt_flag, 0.0, age + progress)

    # ---- failure handling ---------------------------------------------------
    ns["n_failures"] = s["n_failures"] + is_fail.to(torch.float32)
    ns["n_systematic_failures"] = s["n_systematic_failures"] \
        + is_sys.to(torch.float32)
    ns["n_random_failures"] = s["n_random_failures"] \
        + (is_fail & ~is_sys).to(torch.float32)

    diagnosed = is_fail & (u_diag < dp)
    wrong = diagnosed & (u_wrong < du)
    ns["n_undiagnosed"] = s["n_undiagnosed"] \
        + (is_fail & ~diagnosed).to(torch.float32)
    ns["n_misdiagnosed"] = s["n_misdiagnosed"] + wrong.to(torch.float32)

    # one stacked categorical draw for all four pools; rep1h (the one-hot
    # of the raced class) doubles as the right-diagnosis removal mask
    picks = _pick_classes(
        torch.stack([run, s["sb"], s["fw"], s["fs"]], dim=1),
        torch.stack([u_cls, u_cls, u_pool, u_pool], dim=1))    # (B, 4)
    pick1h = _onehot(picks)                                    # (B, 4, 4)
    rep1h = _onehot(cls)
    rm1h = torch.where(wrong[:, None], pick1h[:, 0], rep1h) \
        * diagnosed[:, None]
    run_n = run - rm1h
    auto_n = s["auto"] + rm1h

    # replacement waterfall (only when a server was removed)
    use_sb = diagnosed & (s["sb"].sum(-1) > 0)
    use_fw = diagnosed & ~use_sb & (s["fw"].sum(-1) > 0)
    use_fs = diagnosed & ~use_sb & ~use_fw & (s["fs"].sum(-1) > 0)
    goes_stall = diagnosed & ~use_sb & ~use_fw & ~use_fs

    take = (pick1h[:, 1] * use_sb[:, None]
            + pick1h[:, 2] * use_fw[:, None]
            + pick1h[:, 3] * use_fs[:, None])
    sb_n = s["sb"] - pick1h[:, 1] * use_sb[:, None]
    fw_n = s["fw"] - pick1h[:, 2] * use_fw[:, None]
    fs_n = s["fs"] - pick1h[:, 3] * use_fs[:, None]
    run_n = run_n + take
    ns["n_standby_swaps"] = s["n_standby_swaps"] + use_sb.to(torch.float32)
    ns["n_host_selections"] = s["n_host_selections"] \
        + (use_fw | use_fs).to(torch.float32)
    ns["n_preemptions"] = s["n_preemptions"] + use_fs.to(torch.float32)

    fail_timer = (recovery
                  + torch.where(use_fw | use_fs, host_sel, 0.0)
                  + torch.where(use_fs, waiting + preempt_cost, 0.0))
    resolves = is_fail & ~goes_stall
    timer_n = torch.where(resolves, fail_timer, timer_n)
    phase_n = torch.where(resolves, OVERHEAD, phase_n)
    phase_n = torch.where(goes_stall, STALL, phase_n)
    ns["stall_start"] = torch.where(goes_stall, ns["t"], s["stall_start"])
    recovery_oh = s["recovery_overhead"] + torch.where(resolves, recovery,
                                                       0.0)

    # ---- repair completions ----------------------------------------------
    auto_n = auto_n - rep1h * is_auto[:, None]
    ns["n_auto_repairs"] = s["n_auto_repairs"] + is_auto.to(torch.float32)
    escalate = is_auto & (u_esc >= p_auto)
    man_n = s["man"] + rep1h * escalate[:, None]
    man_n = man_n - rep1h * is_man[:, None]
    ns["n_manual_repairs"] = s["n_manual_repairs"] \
        + is_man.to(torch.float32)

    finishes = (is_auto & ~escalate) | is_man
    fail_prob = torch.where(is_man, man_fail, auto_fail)
    healed = finishes & (u_succ >= fail_prob)
    ns["n_failed_repairs"] = s["n_failed_repairs"] \
        + (finishes & ~healed).to(torch.float32)
    out_cls = torch.where(healed, cls - (cls % 2), cls)  # bad -> good
    out1h = _onehot(out_cls)

    # returning server: stalled job > standby refill > origin pool
    to_stalled = finishes & stalled
    to_sb = finishes & ~to_stalled & (sb_n.sum(-1) < warm_standbys)
    to_pool = finishes & ~to_stalled & ~to_sb
    spare_origin = out_cls >= 2
    run_n = run_n + out1h * to_stalled[:, None]
    sb_n = sb_n + out1h * to_sb[:, None]
    fw_n = fw_n + out1h * (to_pool & ~spare_origin)[:, None]
    fs_n = fs_n + out1h * (to_pool & spare_origin)[:, None]
    unstall = to_stalled
    if scen is not None:
        # the deficit: a bulk kill can leave the stalled job several
        # servers short; each returning server pays one off and the job
        # restarts once the whole block is back (a struck step, a stall
        # and a return never share a step)
        deficit = (s["deficit"] + torch.where(goes_stall, 1.0, 0.0)) \
            + torch.where(struck, shortfall, 0.0)
        deficit = torch.where(to_stalled, (deficit - 1.0).clamp_min(0.0),
                              deficit)
        unstall = to_stalled & (deficit <= 1e-6)
        ns["deficit"] = deficit
    phase_n = torch.where(unstall, OVERHEAD, phase_n)
    timer_n = torch.where(unstall, recovery, timer_n)
    ns["stall_time"] = s["stall_time"] \
        + torch.where(unstall, ns["t"] - s["stall_start"], 0.0)
    ns["recovery_overhead"] = recovery_oh + torch.where(unstall, recovery,
                                                        0.0)

    if scen is not None:
        # ---- shock and campaign execution --------------------------------
        # the struck block leaves every pool at once for the automated
        # stage, and its replacements join the running block in the step
        hit = struck[:, None]
        run_n = torch.where(hit, run_n - rm_run + mv_sb + mv_fw + mv_fs,
                            run_n)
        sb_n = torch.where(hit, sb_n - rm_sb - mv_sb, sb_n)
        fw_n = torch.where(hit, fw_n - rm_fw - mv_fw, fw_n)
        fs_n = torch.where(hit, fs_n - rm_fs - mv_fs, fs_n)
        auto_n = torch.where(hit, auto_n + rm_run + rm_sb + rm_fw + rm_fs,
                             auto_n)
        ns["n_domain_shocks"] = s["n_domain_shocks"] \
            + is_shock.to(torch.float32)
        ns["n_campaign_events"] = s["n_campaign_events"] \
            + is_camp.to(torch.float32)
        ns["n_shock_killed"] = s["n_shock_killed"] + torch.where(
            struck, k_run + k_sb + k_fw + k_fs + k_shop, 0.0)
        ns["n_standby_swaps"] = ns["n_standby_swaps"] \
            + torch.where(struck, t_sb, 0.0)
        ns["n_host_selections"] = ns["n_host_selections"] \
            + torch.where(struck, t_fw + t_fs, 0.0)
        ns["n_preemptions"] = ns["n_preemptions"] \
            + torch.where(struck, t_fs, 0.0)
        if n_dom:
            shocks = s["domain_shocks"].clone()
            rows = torch.arange(B, device=device)
            shocks[rows, shock_dom.long()] += is_shock.to(torch.float32)
            ns["domain_shocks"] = shocks
        if n_camp:
            ns["camp_idx"] = s["camp_idx"] + is_camp.to(torch.int32)
        if has_maint:
            ns["maint"] = torch.where(
                is_m_on, 1.0, torch.where(is_m_off, 0.0, s["maint"]))
        timer_n = torch.where(sh_resolves, shock_timer, timer_n)
        phase_n = torch.where(sh_resolves, OVERHEAD, phase_n)
        phase_n = torch.where(sh_stalls, STALL, phase_n)
        # a shock aborts a checkpoint write in flight: the OVERHEAD that
        # follows is a recovery (the age resets when it ends)
        ns["in_ckpt"] = torch.where(sh_affects, 0.0, ns["in_ckpt"])
        ns["stall_start"] = torch.where(sh_stalls & ~stalled, ns["t"],
                                        ns["stall_start"])
        ns["recovery_overhead"] = ns["recovery_overhead"] \
            + torch.where(sh_resolves, recovery, 0.0)
    ns.update(run=run_n, sb=sb_n, fw=fw_n, fs=fs_n, auto=auto_n, man=man_n,
              phase=phase_n, timer=timer_n)

    # ---- repair-slot lane ------------------------------------------------
    # every occupied slot counts down by dt in every phase; a completion
    # frees the winning slot (an escalation re-arms it with a manual-stage
    # draw) and a diagnosed failure claims the first free slot with an
    # automated-stage draw.  Completion and entry never share a step, so
    # one duration draw and one write per slot array cover both.
    if rkind != "exponential":
        adt = rep_rem.dtype
        rem = torch.where(active[:, None],
                          rep_rem - dt.to(adt)[:, None], rep_rem)
        free = torch.isinf(rem)
        any_free = free.any(-1)
        fslot = free.to(torch.int32).argmax(-1)      # first free slot
        entered = diagnosed & any_free
        rm_cls = torch.where(wrong, picks[:, 0], cls)
        rsampler = hazards.REPAIR_SAMPLERS[rkind]
        if rkind == "empirical":
            esc2 = escalate[:, None]
            q_dur = rsampler.quantile(u_dur, torch.where(esc2, r_me, r_ae),
                                      torch.where(esc2, r_mr, r_ar))
        else:
            q_dur = rsampler.quantile(
                u_dur, torch.where(escalate, rz[1], rz[0]), rz[2])
        # drawn in float32, kept in the lane's dtype
        q_dur = q_dur.to(adt)
        idx = torch.where(is_rep, won_slot, fslot)
        cur_rem = rem[srows, idx]
        rem[srows, idx] = torch.where(
            finishes, torch.inf,
            torch.where(escalate | entered, q_dur, cur_rem))
        stage = s["repair_stage"].clone()
        stage[srows, idx] = torch.where(
            escalate, 1, torch.where(entered, 0, stage[srows, idx]))
        rcls = s["repair_cls"].clone()
        rcls[srows, idx] = torch.where(entered, rm_cls, rcls[srows, idx])
        ns.update(repair_rem=rem, repair_stage=stage, repair_cls=rcls)
        # a full lane: the server stays in the shop for good; counted and
        # warned about downstream (raise Params.repair_slots)
        ns["n_repair_overflow"] = s["n_repair_overflow"] \
            + (diagnosed & ~any_free).to(torch.float32)

    # ---- streaming histograms -------------------------------------------
    # bin layout mirrors histograms.Histogram: searchsorted(right=True)
    # over the float32 edges with under/overflow slots.  A failure
    # resolved through the waterfall records its downtime at once; a
    # stalled one when the repaired server restarts the job.
    if "hist" in s:
        stall_wait = ns["t"] - s["stall_start"]
        ended = resolves | unstall
        downtime = torch.where(resolves, fail_timer, stall_wait + recovery)
        acquire_wait = torch.where(resolves, fail_timer - recovery,
                                   stall_wait)
        if scen is not None:
            # a shock resolved through the waterfall records its planned
            # downtime at once, as a failure does
            ended = ended | sh_resolves
            downtime = torch.where(sh_resolves, shock_timer, downtime)
            acquire_wait = torch.where(sh_resolves, shock_timer - recovery,
                                       acquire_wait)
        channel_vals = {"run_duration": (run_val, record),
                        "recovery": (downtime, ended),
                        "waiting": (acquire_wait, ended),
                        "goodput": (ns["useful_work"]
                                    / ns["t"].clamp_min(1e-9),
                                    is_complete)}
        vals = torch.stack([channel_vals[ch][0] for ch in hist_channels],
                           dim=1)
        masks = torch.stack([channel_vals[ch][1] for ch in hist_channels],
                            dim=1)                      # (B, n_sel)
        idx = torch.searchsorted(s["hist_edges"], vals, right=True)
        rows = torch.arange(B, device=device)[:, None].expand_as(idx)
        chan = torch.arange(vals.shape[1], device=device)[None, :] \
            .expand_as(idx)
        # (row, channel) pairs are unique, so the accumulation order
        # cannot change the result
        hist = s["hist"].clone()
        hist.index_put_((rows, chan, idx), masks.to(torch.float32),
                        accumulate=True)
        ns["hist"] = hist
    return ns


# ---------------------------------------------------------------------------
# run loop
# ---------------------------------------------------------------------------

def _params_vector(p: Params) -> np.ndarray:
    """float32 parameter row: the 16 base columns, the failure family's
    hazard block, the repair family's block and, for a fault-domain
    scenario, its ``2D + 3L`` trailing columns."""
    base = np.asarray([
        p.random_failure_rate, p.systematic_failure_rate, p.recovery_time,
        p.host_selection_time, p.waiting_time, p.auto_repair_time,
        p.manual_repair_time, p.auto_repair_failure_probability,
        p.manual_repair_failure_probability, p.automated_repair_probability,
        p.diagnosis_probability, p.diagnosis_uncertainty,
        p.checkpoint_interval, p.preemption_cost, float(p.warm_standbys),
        p.checkpoint_cost,
    ], np.float32)
    parts = [base, hazards.hazard_columns(p), hazards.repair_columns(p)]
    if faultdomains.scenario_key(p) is not None:
        parts.append(faultdomains.scenario_columns(p).astype(np.float32))
    return np.concatenate(parts)


def default_max_steps(p: Params, safety: float = 2.0) -> int:
    """Expected events (failures x ~3 repair/replace hops) + head-room."""
    lam = hazards.effective_event_rate(p)
    horizon = p.job_length * (1.0 + lam * (p.recovery_time + 2.0))
    extra = 0.0
    if p.fault_domains is not None or p.campaign is not None:
        # shocks, campaign entries and their bulk repair traffic, and the
        # horizon stretch of maintenance windows and shock recoveries
        extra, extra_h = faultdomains.scenario_budget(p, horizon)
        horizon += extra_h
    steps = max(128, int((lam * horizon + extra) * 3.2 * safety))
    if p.checkpoint_interval > 0:
        # every checkpoint_interval minutes of compute burns one
        # write-event step (plus its expiry step when the write is paid)
        writes = p.job_length / max(p.checkpoint_interval, 1e-9)
        steps += int(writes * (2.0 if p.checkpoint_cost > 0 else 1.0)
                     * safety)
    return steps + int(hazards.phantom_steps(p) * safety)


#: steps simulated per early-exit check
DEFAULT_CHUNK_STEPS = 64


def _struct_key(p: Params):
    """Hashable identity of a point's pool *structure* (the grouping key
    of the ``padded=False`` sweep path)."""
    return (p.job_size, p.working_pool_size, p.spare_pool_size,
            p.warm_standbys, round(p.systematic_failure_fraction, 6),
            round(p.job_length, 3), round(p.host_selection_time, 3))


def _chunk_seed(seed: int, i: int) -> int:
    """64-bit generator seed for chunk ``i`` of a run seeded ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64), i])
    return int(ss.generate_state(1, np.uint64)[0])


def _any_active(state: Dict[str, torch.Tensor]) -> bool:
    """One device-to-host read: is any replica still running?"""
    return bool((state["phase"] != DONE).any())


def _steps_ref(state: Dict[str, torch.Tensor], us: torch.Tensor,
               pv: torch.Tensor, R: int, P: int, impl: Optional[str],
               hist_channels: tuple, kind: str = "exponential",
               n_seg: int = 0, rkind: str = "exponential",
               n_rseg: int = 0, scen=None) -> Dict[str, torch.Tensor]:
    """``us.shape[0]`` steps of the plain step loop on one chunk's draw.

    The plain version of the chunk kernel.  ``us`` is the chunk's
    ``(n_steps, R_draw, _n_uniforms(kind, rkind))`` draw; it is sliced to
    R replicas and tiled across the P points of a ``(P * R,)`` batch, so
    row b reads replica ``b % R``'s uniforms.  ``impl`` goes to the event
    race of each step; ``kind`` / ``n_seg`` name the failure family,
    ``rkind`` / ``n_rseg`` the repair family and ``scen`` the fault-domain
    scenario's key (None for none).
    """
    if us.shape[1] != R:
        us = us[:, :R]
    if P > 1:
        us = us.repeat(1, P, 1)
    for k in range(us.shape[0]):
        state = _step_u(state, us[k], pv, impl, hist_channels, kind, n_seg,
                        rkind, n_rseg, scen)
    return state


def _chunk_fn(pv: torch.Tensor, seed: int, P: int, R: int,
              impl: Optional[str], hist_channels: tuple,
              init_state: Dict[str, torch.Tensor],
              kind: str = "exponential", n_seg: int = 0,
              rkind: str = "exponential", n_rseg: int = 0, scen=None):
    """``run_chunk(state, i, n_steps)`` of one batch: chunk ``i``'s draw of
    ``_n_uniforms(kind, rkind)`` uniforms a step at the power-of-two width
    ``next_pow2(R)`` from a generator seeded ``_chunk_seed(seed, i)`` on
    the batch's device (row b reads replica ``b % R``'s), then one launch
    of the chunk kernel for ``impl=None`` or ``"cuda"`` on the card, or
    :func:`_steps_ref` with the plain race for ``impl="ref"`` and on the
    CPU (where ``impl="cuda"`` raises).  The instance is chosen from the
    batch's shape before the first launch: the standard one, or its wide
    twin where the standard ones' caps refuse the shape
    (``ctmc_chunk.wide_for``: over 64 empirical segments, or histogram
    edges or a slot lane past one block's shared memory).  The first
    launch clones the lanes it writes and later ones update those clones
    in place, so ``init_state`` is left as it was."""
    device = init_state["phase"].device
    R_draw = _next_pow2(R)
    fused = ops._use_kernel("ctmc_chunk", impl, init_state["phase"])
    wide = fused and ctmc_chunk.wide_for(init_state, n_seg, n_rseg)
    owned = False

    def run_chunk(state, i, n_steps):
        nonlocal owned
        gen = torch.Generator(device=device)
        gen.manual_seed(_chunk_seed(seed, i))
        us = torch.rand((n_steps, R_draw, _n_uniforms(kind, rkind)),
                        generator=gen, dtype=torch.float32, device=device)
        us = us.clamp_min_(1e-12)
        if not fused:
            return _steps_ref(state, us, pv, R, P, impl, hist_channels,
                              kind, n_seg, rkind, n_rseg, scen)
        state = ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P,
                                           hist_channels, kind=kind,
                                           n_seg=n_seg, rkind=rkind,
                                           n_rseg=n_rseg, scen=scen,
                                           wide=wide, inplace=owned)
        owned = True
        return state

    return run_chunk


def _drive(runs, n_chunks: int, chunk: int, rem: int,
           early_exit: bool) -> list:
    """Run ``n_chunks * chunk + rem`` steps of each ``(run_chunk, state)``
    of ``runs`` (one a shard) and return the final states.

    Chunk ``i`` is launched on every scan still running before any early-
    exit read (a read syncs the host with that scan's device), so scans on
    several cards overlap; each stops at the first chunk boundary where
    all its replicas are DONE (finished replicas are inert, so skipping
    them changes nothing).  A scan's steps depend only on its own state,
    seed and chunk index, so the interleaving cannot change its bits.
    The partial final chunk honours an explicit ``max_steps`` exactly.
    """
    states = [state for _, state in runs]
    live = list(range(len(runs)))
    for i, n_steps in enumerate([chunk] * n_chunks + ([rem] if rem else [])):
        if early_exit:
            live = [j for j in live if _any_active(states[j])]
        if not live:
            break
        for j in live:
            states[j] = runs[j][0](states[j], i, n_steps)
    return states


def _finish(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The completion flag, and the clock as the total time of a replica
    the budget cut."""
    state = dict(state)
    done = state["phase"] == DONE
    state["completed"] = done.to(torch.float32)
    state["total_time"] = torch.where(done, state["total_time"], state["t"])
    return state


def _chunk_loop(pv: torch.Tensor, seed: int, P: int, R: int, chunk: int,
                n_chunks: int, rem: int, impl: Optional[str],
                early_exit: bool, hist_channels: tuple,
                init_state: Dict[str, torch.Tensor],
                kind: str = "exponential", n_seg: int = 0,
                rkind: str = "exponential", n_rseg: int = 0, scen=None,
                *, mesh=None) -> Dict[str, torch.Tensor]:
    """Chunked scan with early exit; batch axis is B = P * R (point-major).

    Runs ``n_chunks * chunk + rem`` steps (:func:`_drive`) of
    :func:`_chunk_fn`'s chunks, less the chunks early exit skips once
    every replica is DONE, split over the devices of ``mesh``
    (:func:`_shard_mesh`; default the batch's own device, one shard) as
    :func:`_run_sharded` sets out.  ``init_state`` is left as it was.
    """
    def make_run(pv_s, seed_s, R_loc, state_s):
        return _chunk_fn(pv_s, seed_s, P, R_loc, impl, hist_channels,
                         state_s, kind, n_seg, rkind, n_rseg, scen)

    return _run_sharded(pv, seed, P, R, init_state,
                        mesh or [init_state["phase"].device], make_run,
                        _finish, n_chunks, chunk, rem, early_exit)


# ---------------------------------------------------------------------------
# replica sharding
# ---------------------------------------------------------------------------

def _shard_rows(x: torch.Tensor, P: int, R: int, s: int, n: int,
                device) -> torch.Tensor:
    """Shard ``s`` of ``n``'s ``(P * R / n, ...)`` rows of a point-major
    ``(P * R, ...)`` lane: replicas ``[s R / n, (s + 1) R / n)`` of every
    point, on ``device``."""
    R_loc = R // n
    v = x.reshape((P, R) + x.shape[1:])[:, s * R_loc:(s + 1) * R_loc]
    return v.reshape((P * R_loc,) + x.shape[1:]).to(device).contiguous()


def _shard_state(state: Dict[str, torch.Tensor], P: int, R: int, s: int,
                 mesh) -> Dict[str, torch.Tensor]:
    """Shard ``s``'s state on ``mesh[s]``: its slice of every batched lane
    (:func:`repro_torch.parallel.sharding.replica_state_specs`), the
    shared lanes (the bin edges) whole."""
    specs = rsharding.replica_state_specs(state, _UNBATCHED_STATE)
    dev = mesh[s]
    return {k: (_shard_rows(v, P, R, s, len(mesh), dev) if specs[k]
                else v.to(dev)) for k, v in state.items()}


def _gather_shards(parts, P: int, R_loc: int,
                   device) -> Dict[str, torch.Tensor]:
    """The shards' final states concatenated back along the replica axis
    into the flat ``(P * R, ...)`` layout on ``device``; the merge is
    exact, since every lane is a replica's own."""
    if len(parts) == 1:
        return {k: v.to(device) for k, v in parts[0].items()}
    specs = rsharding.replica_state_specs(parts[0], _UNBATCHED_STATE)
    out = {}
    for k, v0 in parts[0].items():
        if not specs[k]:
            out[k] = v0.to(device)
            continue
        tail = v0.shape[1:]
        out[k] = torch.cat([p[k].reshape((P, R_loc) + tail).to(device)
                            for p in parts], dim=1) \
            .reshape((P * R_loc * len(parts),) + tail)
    return out


def _run_sharded(pv: torch.Tensor, seed: int, P: int, R: int,
                 init_state: Dict[str, torch.Tensor], mesh, make_run,
                 finish, n_chunks: int, chunk: int, rem: int,
                 early_exit: bool) -> Dict[str, torch.Tensor]:
    """A chunked scan over the devices of ``mesh``, for the single-job and
    the multi-job engines (:func:`_chunk_loop`, ``_mj_chunk_loop``).

    Shard ``s`` takes the ``(P, R / n)`` slice of every batched lane, its
    slice of a per-row parameter block (or the shared row), the seed
    ``shard_seeds(seed, n)[s]`` and the device ``mesh[s]``, and runs
    ``make_run(pv_s, seed_s, R / n, state_s)``'s chunks; the shards are
    driven side by side (:func:`_drive`), each ``finish``-ed and then
    concatenated back (:func:`_gather_shards`) on the batch's device.  So
    shard ``s`` is bit for bit an unsharded run over its replicas seeded
    ``seed_s``, and one shard the unsharded run.
    """
    n = len(mesh)
    R_loc = R // n
    seeds = rsharding.shard_seeds(seed, n)
    runs = []
    for s in range(n):
        state_s = _shard_state(init_state, P, R, s, mesh)
        pv_s = (_shard_rows(pv, P, R, s, n, mesh[s]) if pv.ndim == 2
                else pv.to(mesh[s]))
        runs.append((make_run(pv_s, seeds[s], R_loc, state_s), state_s))
    finals = [finish(st) for st in _drive(runs, n_chunks, chunk, rem,
                                          early_exit)]
    return _gather_shards(finals, P, R_loc, init_state["phase"].device)


def _resolve_shards(shards: Optional[int], pts) -> int:
    """Effective shard count: the explicit argument, else the (single)
    ``Params.engine_shards`` value of the batch; a mixed grid raises (the
    batch axis shards as one unit, and de-sharding part of a grid is what
    a sharded run never does)."""
    if shards is not None:
        return shards
    vals = {p.engine_shards for p in pts}
    if len(vals) > 1:
        raise ValueError(
            f"all points of a batched CTMC sweep must agree on "
            f"Params.engine_shards (got {sorted(vals)}); the batch axis "
            f"shards as one unit — split the grid or pass shards= "
            f"explicitly")
    return vals.pop()


def _shard_mesh(n_shards: int, R: int, device) -> list:
    """The devices of ``n_shards`` shards over R replicas on ``device``'s
    kind; raises -- never de-shards -- when the shard count does not
    divide the replica count or exceeds the visible cards."""
    if R % n_shards:
        raise ValueError(
            f"engine_shards={n_shards} does not divide the replica "
            f"count {R}: the batch axis shards by whole replica "
            f"columns.  Choose a divisor; bucketed sweeps round R up to "
            f"a power of two, so any power-of-two shard count <= R "
            f"divides it (docs/scaling.md)")
    return rsharding.replica_mesh(n_shards, device)


#: non-_METRICS outputs worth returning: completion flag + the exact
#: run-duration records (ring buffer, attempt count, in-flight interval)
#: + the per-domain shock counts of scenario runs (absent otherwise)
_EXTRA_OUTPUTS = ("completed", "run_durations", "n_runs", "cur_run",
                  "domain_shocks")


def _host_outputs(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state entries extraction reads, copied to the host once."""
    keep = set(_METRICS + _EXTRA_OUTPUTS + ("hist", "hist_edges"))
    return state_to_numpy({k: v for k, v in state.items() if k in keep})


def _extract(host: Dict[str, np.ndarray], sl=slice(None),
             channels=()) -> Dict[str, np.ndarray]:
    out = {k: v[sl] for k, v in host.items()
           if k in _METRICS + _EXTRA_OUTPUTS}
    if "hist" in host and channels:
        # the in-scan accumulator carries exactly the selected channels,
        # in HIST_CHANNELS order
        hist = np.asarray(host["hist"][sl], np.float64)
        for ci, ch in enumerate(channels):
            out[f"hist_{ch}"] = hist[:, ci]
        out["hist_edges"] = np.asarray(host["hist_edges"], np.float64)
    return out


def _hist_channels(pts) -> tuple:
    return _selected_channels(pts[0].histogram)


def simulate_ctmc(params: Params, n_replicas: int = 1024, seed: int = 0,
                  max_steps: Optional[int] = None,
                  impl: Optional[str] = None,
                  chunk_steps: Optional[int] = None,
                  early_exit: bool = True,
                  max_runs: Optional[int] = None,
                  device=None,
                  shards: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Vectorized replication study. Returns {metric: np.ndarray (R,)}.

    Runs on ``device`` (default the card; ``device="cpu"`` must be asked
    for).  The scan runs in ``chunk_steps``-sized pieces and stops at the
    first chunk boundary where every replica is DONE; ``early_exit=False``
    runs the whole ``max_steps`` budget with bit-identical results.
    ``max_runs`` (default ``params.max_run_records``) sizes the per-run
    duration ring buffer; 0 leaves it out.  ``impl`` (default
    ``params.event_race_impl``) selects the chunk kernel (``None`` or
    ``"cuda"``) or the plain step loop (``"ref"``).  ``shards`` (default
    ``params.engine_shards``; 0 unsharded) splits the replicas over that
    many devices (:func:`_run_sharded`): bit for bit the
    unsharded run at one shard, and shard ``s`` the unsharded run over
    its replicas seeded ``shard_seeds(seed, shards)[s]``; a shard count
    that does not divide ``n_replicas`` or exceeds the visible cards
    raises.
    """
    dev = resolve_device(device)
    if not supports(params):
        raise _unsupported_error(params)
    params.validate()
    impl = params.event_race_impl if impl is None else impl
    shards = _resolve_shards(shards, [params])
    max_steps = max_steps or default_max_steps(params)
    chunk = min(chunk_steps or DEFAULT_CHUNK_STEPS, max_steps)
    channels = _hist_channels([params])
    init_state = _initial_state(params, n_replicas, max_runs, dev)
    pv = torch.as_tensor(_params_vector(params), device=dev)
    args = (pv, seed, 1, n_replicas, chunk, max_steps // chunk,
            max_steps % chunk, impl, early_exit, channels, init_state,
            hazards.hazard_kind(params),
            hazards.hazard_segment_count(params),
            hazards.repair_kind(params),
            hazards.repair_segment_count(params),
            faultdomains.scenario_key(params))
    out = _chunk_loop(*args, mesh=_shard_mesh(shards or 1, n_replicas, dev))
    return _extract(_host_outputs(out), channels=channels)


def simulate_ctmc_sweep(params_list, n_replicas: int = 1024, seed: int = 0,
                        max_steps: Optional[int] = None,
                        impl: Optional[str] = None,
                        chunk_steps: Optional[int] = None,
                        early_exit: bool = True,
                        padded: bool = True,
                        bucketed: bool = True,
                        max_runs: Optional[int] = None,
                        device=None,
                        shards: Optional[int] = None):
    """Batched sweep: the whole grid as one flat batch on one device.

    ``params_list`` is a sequence of :class:`Params`.  With ``padded=True``
    (default) every point, structural ones included, goes into one
    ``(P * R,)`` batch with one parameter row per replica; ``padded=False``
    runs one batch per pool structure (:func:`_struct_key`), with the same
    per-point results.  ``bucketed=True`` (default, padded path only)
    rounds P and R up to powers of two with inert rows, and rounds a
    derived step budget up to whole chunks; an explicit ``max_steps`` is
    honored exactly, and real rows are then bit-identical to
    ``bucketed=False``.  Uniforms are shared across points (common random
    numbers).  The failure and repair families and their empirical segment
    counts change the step and the draw's width, a scenario's key (domain
    count and schedule codes) its race and lanes, and ``age_dtype`` the
    age lanes' dtype (and the kernel's instance), so a grid mixing them
    runs one batch per ``(failure family, repair family, age dtype,
    scenario key, segment counts)``; their parameters (shock rates,
    campaign times included) are columns and never split a batch.
    ``impl`` overrides every point's ``event_race_impl``; otherwise
    points split by it.  ``shards`` (default the grid's one
    ``Params.engine_shards``; a mixed grid raises) splits every batch's
    replica axis over that many devices, as :func:`simulate_ctmc` does;
    the count must divide the *run* replica count (after pow2 bucketing).

    Returns a list of ``{metric: np.ndarray (R,)}`` dicts in input order.
    """
    dev = resolve_device(device)
    params_list = list(params_list)
    for p in params_list:
        if not supports(p):
            raise _unsupported_error(p)
        p.validate()
    if not params_list:
        return []
    shards = _resolve_shards(shards, params_list)
    if len({p.histogram for p in params_list}) > 1:
        raise ValueError(
            "all points of a batched CTMC sweep must share the same "
            "Params.histogram spec (the in-scan accumulator layout is "
            "per-batch); split the grid or unify the spec")

    groups: Dict[tuple, list] = {}
    for i, p in enumerate(params_list):
        gkey = (hazards.hazard_kind(p), hazards.repair_kind(p), p.age_dtype,
                faultdomains.scenario_key(p),
                hazards.hazard_segment_count(p),
                hazards.repair_segment_count(p),
                None if padded else _struct_key(p),
                impl if impl is not None else p.event_race_impl)
        groups.setdefault(gkey, []).append(i)
    mr = (max(p.max_run_records for p in params_list) if max_runs is None
          else max_runs)

    bucket = padded and bucketed
    channels = _hist_channels(params_list)
    results: list = [None] * len(params_list)
    for (kind, rkind, _adt, scen, n_seg, n_rseg, _skey, impl_eff), idxs in \
            groups.items():
        pts = [params_list[i] for i in idxs]
        P, R = len(pts), n_replicas
        steps = max_steps or max(default_max_steps(p) for p in pts)
        chunk = min(chunk_steps or DEFAULT_CHUNK_STEPS, steps)
        P_run, R_run = (_next_pow2(P), _next_pow2(R)) if bucket else (P, R)
        if bucket and max_steps is None:
            steps = -(-steps // chunk) * chunk
        pv = np.stack([_params_vector(p) for p in pts])         # (P, n_cols)
        if P_run != P:
            # padding rows are inert (phase DONE); repeating the last real
            # row keeps every column benign
            pv = np.concatenate([pv, np.repeat(pv[-1:], P_run - P, 0)])
        pv_flat = torch.as_tensor(np.repeat(pv, R_run, axis=0), device=dev)
        init_state = _initial_state_batch(pts, R, mr, dev, rkind,
                                          _repair_slots_for(pts, rkind),
                                          scen)
        if (P_run, R_run) != (P, R):
            init_state = _bucket_pad_state(init_state, P, R, P_run, R_run)
        args = (pv_flat, seed, P_run, R_run, chunk, steps // chunk,
                steps % chunk, impl_eff, early_exit, channels, init_state,
                kind, n_seg, rkind, n_rseg, scen)
        out = _chunk_loop(*args, mesh=_shard_mesh(shards or 1, R_run, dev))
        host = _host_outputs(out)
        for j, i in enumerate(idxs):
            results[i] = _extract(host, slice(j * R_run, j * R_run + R),
                                  channels)
    return results
