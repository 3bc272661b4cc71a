"""The CTMC chunk kernel of the port and its plain version.

On the CPU: the kernel's layout and refusals (``kernels/ctmc_chunk.py``),
the plain chunk (``vectorized._steps_ref``) against the loop it was
factored out of (bit for bit) and against the JAX reference's ``_step_u``
over 64 steps on the same numpy uniforms (integer lanes under the
pick-flip budget of ``test_torch_step.py``).  On the card (marked
``gpu``): the kernel against ``_steps_ref`` on the same state and draw,
every lane, over configurations that reach each branch of the step, for
each failure family and, through the slot instances, each repair family,
and through the scenario instances each failure family under fault
domains and a campaign.
Integer lanes and histogram counts must match exactly and float lanes
within 1e-6 relative; both run the same float32 operations in the same
order, so they are expected to agree bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import faultdomains, hazards
from repro_torch.core import vectorized as tv
from repro_torch.core.faultdomains import (Campaign, CampaignEvent,
                                           FaultTopology)
from repro_torch.core.histograms import HIST_CHANNELS, HistogramSpec
from repro_torch.core.params import MINUTES_PER_DAY as DAY
from repro_torch.core.params import Params
from repro_torch.kernels import _build, ctmc_chunk, des_step

torch.set_num_threads(1)

BASE = Params(job_size=64, working_pool_size=72, spare_pool_size=16,
              warm_standbys=4, job_length=0.5 * DAY,
              random_failure_rate=2.0 / DAY)
SMALL = Params(job_size=16, working_pool_size=20, spare_pool_size=4,
               warm_standbys=2, job_length=0.5 * DAY,
               random_failure_rate=2.0 / DAY)
#: tests/test_nonexp.py's base: systematic failures frequent enough to
#: reach the systematic clock of every family
NONEXP = Params(job_size=24, working_pool_size=32, spare_pool_size=4,
                warm_standbys=2, job_length=2 * DAY,
                random_failure_rate=2.0 / DAY,
                systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
                auto_repair_time=30.0, manual_repair_time=120.0)
#: the non-exponential failure families, as tests/test_nonexp.py,
#: tests/test_empirical.py and tests/test_repair_dist.py configure them
FAMILIES = {
    "weibull": NONEXP.replace(failure_distribution="weibull",
                              distribution_kwargs={"k": 1.5}),
    "weibull_infant": NONEXP.replace(failure_distribution="weibull",
                                     distribution_kwargs={"k": 0.8}),
    "bathtub": NONEXP.replace(failure_distribution="bathtub",
                              distribution_kwargs={"infant_factor": 8.0,
                                                   "infant_tau": 0.25 * DAY}),
    "lognormal": NONEXP.replace(failure_distribution="lognormal",
                                distribution_kwargs={"sigma": 1.0}),
    "empirical": NONEXP.replace(failure_distribution="empirical",
                                distribution_kwargs={
                                    "edges": [0.4, 2.0],
                                    "rates": [0.3, 1.5, 0.7]}),
}
#: the non-exponential repair families, as tests/test_repair_dist.py and
#: tests/test_empirical.py configure them
REPAIRS = {
    "weibull": NONEXP.replace(repair_distribution="weibull",
                              distribution_kwargs={"k": 0.7}),
    "lognormal": NONEXP.replace(repair_distribution="lognormal",
                                distribution_kwargs={"sigma": 1.2}),
    "deterministic": NONEXP.replace(repair_distribution="deterministic"),
    "empirical": NONEXP.replace(repair_distribution="empirical",
                                distribution_kwargs={"edges": [0.5],
                                                     "rates": [0.1, 2.0]}),
    "combined": NONEXP.replace(failure_distribution="lognormal",
                               repair_distribution="weibull",
                               distribution_kwargs={"k": 0.7,
                                                    "sigma": 1.0}),
    "weibull_failures": NONEXP.replace(failure_distribution="weibull",
                                       repair_distribution="weibull",
                                       distribution_kwargs={"k": 1.5}),
    "bathtub_failures": NONEXP.replace(
        failure_distribution="bathtub", repair_distribution="deterministic",
        distribution_kwargs={"infant_factor": 8.0, "infant_tau": 0.25 * DAY}),
    "empirical_failures": NONEXP.replace(
        failure_distribution="empirical", repair_distribution="empirical",
        distribution_kwargs={"edges": [0.4, 2.0], "rates": [0.3, 1.5, 0.7]}),
    # a one-slot lane that overflows
    "overflow": NONEXP.replace(repair_distribution="weibull",
                               distribution_kwargs={"k": 0.7},
                               auto_repair_time=2 * DAY, repair_slots=1),
    # 44 slots (not a power of two) that long manual repairs fill past 32
    "width_44": NONEXP.replace(
        repair_distribution="weibull", distribution_kwargs={"k": 0.7},
        job_size=4, working_pool_size=44, spare_pool_size=0,
        warm_standbys=0, random_failure_rate=8.0 / DAY,
        auto_repair_time=0.5 * DAY, manual_repair_time=30 * DAY,
        automated_repair_probability=0.3, repair_slots=44),
}
#: each failure family under a fault-domain scenario, for the scenario
#: instances: rack and pod shocks, a kill of pod 1 and a maintenance
#: window inside the first 64 steps, one warm standby and frequent paid
#: checkpoint writes, so that the first chunk holds shock steps, the kill,
#: the window's start and end, stalls owing more than one server and kills
#: during a checkpoint write (test_scenario_chunk_reaches_every_branch)
SCEN_TOPO = FaultTopology(n_racks=4, racks_per_pod=2, rack_shock_rate=2e-3,
                          pod_shock_rate=6e-4)
SCEN_CAMPAIGN = Campaign(events=(
    CampaignEvent(time=60.0, kind="kill", domain=5),
    CampaignEvent(time=100.0, kind="maintenance", duration=60.0)))
SCENARIOS = {
    name: p.replace(fault_domains=SCEN_TOPO, campaign=SCEN_CAMPAIGN,
                    warm_standbys=1, checkpoint_interval=10.0,
                    checkpoint_cost=4.0)
    for name, p in (("exponential", NONEXP),
                    *((k, FAMILIES[k]) for k in ("weibull", "bathtub",
                                                 "lognormal", "empirical")))}
#: name -> (points, replicas a point, ring size or None for the default,
#: per-row pv, pow2-bucketed, chunks of 64 steps)
CASES = {
    # the configurations of test_torch_ctmc.py
    "default": ([BASE], 64, None, False, False, 3),
    "starved": ([Params(job_size=32, working_pool_size=33, spare_pool_size=2,
                        warm_standbys=1, job_length=0.5 * DAY,
                        random_failure_rate=4.0 / DAY,
                        auto_repair_time=240.0, manual_repair_time=2880.0,
                        diagnosis_probability=1.0)], 64, None, False, False,
                3),
    "diagnosis": ([BASE.replace(diagnosis_probability=0.6,
                                diagnosis_uncertainty=0.3)], 48, None, True,
                  False, 3),
    "small": ([SMALL], 32, None, False, False, 4),
    # checkpoint interval 0 and > 0, cost 0 and > 0
    "ckpt_paid": ([BASE.replace(checkpoint_interval=60.0,
                                checkpoint_cost=2.0)], 64, None, False, False,
                  3),
    "ckpt_free": ([BASE.replace(checkpoint_interval=45.0,
                                checkpoint_cost=0.0)], 64, None, True, False,
                  3),
    "ckpt_off_cost": ([BASE.replace(checkpoint_interval=0.0,
                                    checkpoint_cost=3.0)], 64, None, False,
                      False, 3),
    # no ring buffer, and a ring that wraps many times
    "ring_none": ([BASE], 64, 0, False, False, 3),
    "ring_wraps": ([BASE], 64, 2, True, False, 3),
    # histograms off and each channel subset
    "hist_none": ([BASE.replace(histogram=None)], 64, None, False, False, 3),
    **{f"hist_{ch}": ([BASE.replace(histogram=HistogramSpec(channels=(ch,)))],
                      64, None, False, False, 3) for ch in HIST_CHANNELS},
    "hist_all": ([BASE.replace(histogram=HistogramSpec(
        channels=HIST_CHANNELS, n_bins=40))], 64, None, False, False, 3),
    # P > 1 with R not a power of two, unbucketed and bucketed
    "sweep_p3_r20": ([BASE.replace(warm_standbys=w) for w in (0, 2, 4)], 20,
                     None, True, False, 3),
    "sweep_p3_r20_bucketed": ([BASE.replace(warm_standbys=w)
                               for w in (0, 2, 4)], 20, None, True, True, 3),
    "sweep_structural": ([SMALL, SMALL.replace(job_size=12),
                          BASE.replace(checkpoint_interval=30.0,
                                       checkpoint_cost=1.0)], 24, 4, True,
                         True, 4),
    # rows that finish mid-chunk and chunks that start with finished rows
    "finish_mid_chunk": ([SMALL.replace(job_length=0.1 * DAY)], 96, None,
                         False, False, 3),
    # each non-exponential failure family, alone (one shared parameter
    # row) and with checkpoints (the hazard residual before the write's)
    **{f"family_{name}": ([p], 64, None, False, False, 3)
       for name, p in FAMILIES.items()},
    **{f"family_{name}_ckpt": ([p.replace(checkpoint_interval=60.0,
                                          checkpoint_cost=2.0)], 48, None,
                               True, False, 3)
       for name, p in FAMILIES.items()},
    # a Weibull k grid as one bucketed sweep, k = 1 included
    "weibull_k_grid": ([FAMILIES["weibull"].replace(
        distribution_kwargs={"k": k}) for k in (0.6, 1.0, 1.5, 3.0, 5.0)],
        20, None, True, True, 3),
    # an empirical grid of two fits with one segment count
    "empirical_grid": ([FAMILIES["empirical"], FAMILIES["empirical"].replace(
        distribution_kwargs={"edges": [1.0, 3.0], "rates": [2.0, 0.5, 1.0]})],
        24, 4, True, True, 3),
    # each non-exponential repair family through a slot instance, alone
    # and as a bucketed repair-parameter sweep with checkpoints
    **{f"repair_{name}": ([p], 48, None, False, False, 3)
       for name, p in REPAIRS.items()},
    "repair_weibull_grid": ([REPAIRS["weibull"].replace(
        auto_repair_time=v, checkpoint_interval=60.0, checkpoint_cost=2.0)
        for v in (20.0, 45.0, 90.0)], 20, None, True, True, 3),
    "repair_short": ([REPAIRS["lognormal"].replace(job_length=0.1 * DAY)],
                     40, None, False, False, 3),
    # each failure family through its scenario instance, one chunk
    **{f"scen_{name}": ([p], 48, None, False, False, 1)
       for name, p in SCENARIOS.items()},
    # a bucketed shock-rate sweep (rate 0 included) over three chunks, and
    # shocks alone with rows that finish
    "scen_rate_grid": ([SCENARIOS["exponential"].replace(
        fault_domains=FaultTopology(n_racks=4, racks_per_pod=2,
                                    rack_shock_rate=r, pod_shock_rate=6e-4))
        for r in (0.0, 1e-3, 3e-3)], 20, None, True, True, 3),
    "scen_shocks_only": ([SMALL.replace(
        fault_domains=FaultTopology(n_racks=5, rack_shock_rate=5e-3),
        job_length=0.1 * DAY)], 40, None, False, False, 3),
}


def _family(pts):
    """(kind, n_seg) of a case's points, which share one failure family."""
    return _families(pts)[:2]


def _families(pts):
    """(kind, n_seg, rkind, n_rseg) of a case's points, which share one
    failure and one repair family."""
    keys = {(hazards.hazard_kind(p), hazards.hazard_segment_count(p),
             hazards.repair_kind(p), hazards.repair_segment_count(p))
            for p in pts}
    assert len(keys) == 1, keys
    return keys.pop()


def _scen(pts):
    """The scenario key the case's points share (None for none)."""
    keys = {faultdomains.scenario_key(p) for p in pts}
    assert len(keys) == 1, keys
    return keys.pop()


def _fam_kw(pts):
    """The launch's family keywords for a case's points."""
    kind, n_seg, rkind, n_rseg = _families(pts)
    return dict(kind=kind, n_seg=n_seg, rkind=rkind, n_rseg=n_rseg,
                scen=_scen(pts))


def _setup(name, device):
    """(state, pv, R, P, channels) of a case, on ``device``; its families
    from :func:`_families`."""
    pts, R, mr, per_row, bucket, _ = CASES[name]
    P = len(pts)
    mr = max(p.max_run_records for p in pts) if mr is None else mr
    rkind = _families(pts)[2]
    state = tv._initial_state_batch(pts, R, mr, device, rkind,
                                    tv._repair_slots_for(pts, rkind),
                                    _scen(pts))
    rows = np.stack([tv._params_vector(p) for p in pts])
    if bucket:
        P_run, R_run = tv._next_pow2(P), tv._next_pow2(R)
        state = tv._bucket_pad_state(state, P, R, P_run, R_run)
        rows = np.concatenate([rows, np.repeat(rows[-1:], P_run - P, 0)])
        P, R = P_run, R_run
    if per_row:
        pv = torch.as_tensor(np.repeat(rows, R, axis=0), device=device)
    else:
        assert len(pts) == 1
        pv = torch.as_tensor(rows[0], device=device)
    return state, pv, R, P, tv._hist_channels(pts)


def _draw(R, i, n_steps=64, device="cpu", seed=17, kind="exponential",
          rkind="exponential"):
    """Chunk i's uniforms as ``_chunk_loop`` draws them for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(tv._chunk_seed(seed, i))
    return torch.rand((n_steps, tv._next_pow2(R),
                       tv._n_uniforms(kind, rkind)),
                      generator=gen, device=device).clamp_min_(1e-12)


# ---------------------------------------------------------------------------
# layout and refusals (CPU)
# ---------------------------------------------------------------------------

def test_kernel_lanes_are_the_exponential_state():
    state = tv._initial_state_batch([BASE], 4, 3, "cpu")
    known = set(ctmc_chunk.WRITTEN + ctmc_chunk.CARRIED + ("hist_edges",))
    assert set(state) == known
    assert set(tv._METRICS) == set(ctmc_chunk.METRICS + ctmc_chunk.CARRIED)
    assert ctmc_chunk.CHANNELS == HIST_CHANNELS


@pytest.mark.parametrize("name", ["default", "hist_none", "ring_none",
                                  "hist_goodput", "hist_all", "sweep_p3_r20",
                                  "sweep_p3_r20_bucketed",
                                  "sweep_structural", "family_weibull",
                                  "family_bathtub_ckpt", "family_lognormal",
                                  "family_empirical", "weibull_k_grid",
                                  "empirical_grid"])
def test_layout(name):
    state, pv, R, P, channels = _setup(name, "cpu")
    kind, n_seg = _family(CASES[name][0])
    us = _draw(R, 0, n_steps=5, kind=kind)
    lay = ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, kind=kind,
                                  n_seg=n_seg)
    assert (lay["kind"], lay["n_seg"]) == (ctmc_chunk.KINDS.index(kind),
                                           n_seg)
    assert pv.shape[-1] == ctmc_chunk.pv_width(kind, n_seg) \
        == 16 + hazards.hazard_col_count(kind, n_seg) + 3
    assert us.shape[-1] == ctmc_chunk.n_uniforms(kind) \
        == tv._n_uniforms(kind)
    B = state["phase"].shape[0]
    assert lay["n_rows"] == B == P * R
    assert (lay["R"], lay["P"], lay["n_steps"]) == (R, P, 5)
    assert lay["R_draw"] == tv._next_pow2(R) >= R
    assert lay["max_runs"] == state["run_durations"].shape[1]
    assert lay["pv_stride"] == (0 if pv.ndim == 1 else pv.shape[1])
    assert lay["pointers"]["us"] == us.data_ptr()
    for k, v in state.items():
        assert lay["pointers"][k] == v.data_ptr(), k
    if "hist" in state:
        assert lay["n_sel"] == len(channels) == state["hist"].shape[1]
        assert lay["n_edges"] == state["hist_edges"].shape[0]
        assert lay["chan"][:len(channels)] == tuple(
            HIST_CHANNELS.index(c) for c in channels)
    else:
        assert lay["n_sel"] == lay["n_edges"] == 0
    args = ctmc_chunk._args(lay)
    assert args.n_rows == B and args.R == R and args.pv_stride \
        == lay["pv_stride"]
    assert (args.kind, args.n_seg) == (lay["kind"], n_seg)
    assert list(args.comp) == [lay["pointers"][k]
                               for k in ctmc_chunk.COMPARTMENTS]
    assert (args.run_durations or 0) == (lay["pointers"]["run_durations"]
                                         if lay["max_runs"] else 0)


def _valid():
    state, pv, R, P, channels = _setup("default", "cpu")
    return state, _draw(R, 0, n_steps=2), pv, R, P, channels


def test_wrapper_refuses_cpu_tensors():
    state, us, pv, R, P, channels = _valid()
    ctmc_chunk.chunk_layout(state, us, pv, R, P, channels)   # valid layout
    before = (ctmc_chunk.LAUNCHES, ctmc_chunk.STEPS)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels)
    assert (ctmc_chunk.LAUNCHES, ctmc_chunk.STEPS) == before


@pytest.mark.parametrize("key", ["shock_lane", "slot_t", "n_repair_queue"])
def test_wrapper_refuses_unknown_state_key(key):
    state, us, pv, R, P, channels = _valid()
    state[key] = torch.zeros_like(state["t"])
    with pytest.raises(ValueError, match="does not carry"):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels)
    with pytest.raises(ValueError, match=key):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels)


@pytest.mark.parametrize("key,dtype", [("age", torch.float64),
                                       ("t", torch.float64),
                                       ("phase", torch.int64),
                                       ("n_runs", torch.float32),
                                       ("run", torch.float64),
                                       ("hist", torch.float64)])
def test_wrapper_refuses_wrong_lane_dtype(key, dtype):
    """Every lane but ``age`` refuses another dtype by name.  A float64
    ``age`` was refused too until float64 age was ported (ROADMAP queue 1
    item 8b): with exponential repairs it needs no ``repair_rem`` partner,
    so the layout now takes it for the float64 twin, and on CPU tensors the
    wrapper refuses only the device."""
    state, us, pv, R, P, channels = _valid()
    state[key] = state[key].to(dtype)
    if key == "age":
        lay = ctmc_chunk.chunk_layout(state, us, pv, R, P, channels)
        assert lay["age64"] and lay["plan"] is None
        assert lay["pointers"]["age"] == state["age"].data_ptr()
        with pytest.raises(ValueError, match="not a CUDA device"):
            ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels)
        return
    with pytest.raises(ValueError, match=f"{key} has dtype"):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels)


@pytest.mark.parametrize("what", ["missing", "shape", "uniforms", "pv",
                                  "channels", "batch"])
def test_layout_refuses_bad_shapes(what):
    state, us, pv, R, P, channels = _valid()
    if what == "missing":
        del state["n_runs"]
    elif what == "shape":
        state["timer"] = state["timer"][:-1]
    elif what == "uniforms":
        us = us[:, :R - 1]
    elif what == "pv":
        pv = pv[:12]
    elif what == "channels":
        channels = channels + ("goodput",)
    elif what == "batch":
        P = 2
    with pytest.raises(ValueError, match="ctmc_chunk"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels)


def test_kernel_families_are_the_engines():
    assert ctmc_chunk.KINDS == hazards.HAZARD_KINDS
    assert set(ctmc_chunk.LAUNCHES_BY_KIND) == set(hazards.HAZARD_KINDS)
    assert set(hazards.FAILURE_SAMPLERS) == set(ctmc_chunk.KINDS[1:])


def _family_valid(name):
    state, pv, R, P, channels = _setup(f"family_{name}", "cpu")
    kind, n_seg = _family(CASES[f"family_{name}"][0])
    return state, _draw(R, 0, n_steps=2, kind=kind), pv, R, P, channels, \
        kind, n_seg


@pytest.mark.parametrize("name", ["weibull", "bathtub", "lognormal",
                                  "empirical"])
def test_layout_checks_each_family(name):
    """A family's instance takes its own pv width and a 9-lane draw, and
    refuses the exponential path's (and the reverse)."""
    state, us, pv, R, P, channels, kind, n_seg = _family_valid(name)
    ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, kind=kind,
                            n_seg=n_seg)
    with pytest.raises(ValueError, match="uniforms"):
        ctmc_chunk.chunk_layout(state, us[..., :8].contiguous(), pv, R, P,
                                channels, kind=kind, n_seg=n_seg)
    with pytest.raises(ValueError, match="uniforms"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels)
    with pytest.raises(ValueError, match="columns"):
        ctmc_chunk.chunk_layout(state, us, pv[:-1], R, P, channels,
                                kind=kind, n_seg=n_seg)
    # another segment count reads another width
    with pytest.raises(ValueError, match="columns"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels,
                                kind="empirical", n_seg=n_seg + 2)


@pytest.mark.parametrize("kind,n_seg,match", [
    ("gamma", 0, "not one of"), ("Weibull", 0, "not one of"),
    ("empirical", 1, "segments"), ("empirical", 65, "segments"),
    ("weibull", 2, "n_seg")])
def test_layout_refuses_unknown_family(kind, n_seg, match):
    state, us, pv, R, P, channels, _, _ = _family_valid("weibull")
    with pytest.raises(ValueError, match=match):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, kind=kind,
                                n_seg=n_seg)
    before = dict(ctmc_chunk.LAUNCHES_BY_KIND)
    with pytest.raises(ValueError, match=match):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels, kind=kind,
                                   n_seg=n_seg)
    assert ctmc_chunk.LAUNCHES_BY_KIND == before


def _repair_valid(name="weibull"):
    state, pv, R, P, channels = _setup(f"repair_{name}", "cpu")
    fam = _fam_kw(CASES[f"repair_{name}"][0])
    us = _draw(R, 0, n_steps=2, kind=fam["kind"], rkind=fam["rkind"])
    return state, us, pv, R, P, channels, fam


@pytest.mark.parametrize("key", ["repair_rem", "repair_cls",
                                 "repair_stage"])
def test_layout_refuses_a_bad_slot_lane(key):
    """Each slot lane is refused in the wrong dtype and the wrong shape,
    and an exponential launch refuses it outright."""
    state, us, pv, R, P, channels, fam = _repair_valid()
    ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    good = state[key]
    wrong = torch.int32 if good.dtype == torch.float32 else torch.float32
    state[key] = good.to(wrong)
    with pytest.raises(ValueError, match=f"{key} has dtype"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    state[key] = good[:-1]
    with pytest.raises(ValueError, match=f"{key} has shape"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    state[key] = good
    exp_state, exp_us, exp_pv, *_ = _valid()
    exp_state[key] = good[:exp_state["t"].shape[0]]
    with pytest.raises(ValueError, match="repair-slot lane"):
        ctmc_chunk.chunk_layout(exp_state, exp_us, exp_pv, R, P, channels)


def test_kernel_repair_families_are_the_engines():
    assert ctmc_chunk.REPAIR_KINDS == hazards.REPAIR_KINDS
    assert set(ctmc_chunk.LAUNCHES_BY_REPAIR) == set(hazards.REPAIR_KINDS)
    assert set(hazards.REPAIR_SAMPLERS) == set(ctmc_chunk.REPAIR_KINDS[1:])
    state = tv._initial_state_batch([REPAIRS["weibull"]], 4, 3, "cpu",
                                    "weibull", 8)
    assert set(state) == set(ctmc_chunk.WRITTEN + ctmc_chunk.CARRIED
                             + ctmc_chunk.SLOT_LANES + ("hist_edges",))


@pytest.mark.parametrize("name", ["weibull", "lognormal", "deterministic",
                                  "empirical", "combined",
                                  "weibull_failures", "bathtub_failures",
                                  "empirical_failures", "overflow",
                                  "width_44"])
def test_layout_of_each_slot_instance(name):
    state, us, pv, R, P, channels, fam = _repair_valid(name)
    lay = ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    n_slots = state["repair_rem"].shape[1]
    assert lay["n_slots"] == n_slots == tv._repair_slots_for(
        CASES[f"repair_{name}"][0], fam["rkind"])
    assert (lay["rkind"], lay["n_rseg"]) == (
        ctmc_chunk.REPAIR_KINDS.index(fam["rkind"]), fam["n_rseg"])
    assert lay["plan"] == ctmc_chunk.slot_plan(n_slots, lay["n_edges"])
    assert pv.shape[-1] == ctmc_chunk.pv_width(
        fam["kind"], fam["n_seg"], fam["rkind"], fam["n_rseg"])
    assert us.shape[-1] == ctmc_chunk.n_uniforms(fam["kind"], fam["rkind"]) \
        == 9 + (fam["kind"] != "exponential")
    args = ctmc_chunk._args(lay)
    assert (args.rkind, args.n_rseg, args.n_slots) == (
        lay["rkind"], fam["n_rseg"], n_slots)
    assert args.repair_rem == state["repair_rem"].data_ptr()
    assert args.n_repair_overflow == state["n_repair_overflow"].data_ptr()
    # the exponential-repair draw and parameter row are refused
    with pytest.raises(ValueError, match="uniforms"):
        ctmc_chunk.chunk_layout(state, us[..., :-1].contiguous(), pv, R, P,
                                channels, **fam)
    with pytest.raises(ValueError, match="repair-slot lane|uniforms"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels,
                                kind=fam["kind"], n_seg=fam["n_seg"])


@pytest.mark.parametrize("rkind,n_rseg,match", [
    ("gamma", 0, "not one of"), ("empirical", 1, "segments"),
    ("empirical", 65, "segments"), ("weibull", 2, "n_rseg")])
def test_layout_refuses_unknown_repair_family(rkind, n_rseg, match):
    state, us, pv, R, P, channels, fam = _repair_valid()
    fam.update(rkind=rkind, n_rseg=n_rseg)
    with pytest.raises(ValueError, match=match):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    before = dict(ctmc_chunk.LAUNCHES_BY_REPAIR)
    with pytest.raises(ValueError, match=match):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels, **fam)
    assert ctmc_chunk.LAUNCHES_BY_REPAIR == before


def test_layout_refuses_a_missing_slot_lane():
    state, us, pv, R, P, channels, fam = _repair_valid()
    del state["repair_stage"]
    with pytest.raises(ValueError, match="lacks"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)


@pytest.mark.parametrize("n_slots,n_edges", [(1, 0), (36, 130), (128, 130),
                                             (4360, 130), (28990, 130),
                                             (29056, 0)])
def test_slot_plan_takes_every_width_to_the_physical_cap(n_slots, n_edges):
    """Any lane up to 4,360 slots (Table I's every server in the shop)
    fits a block: one warp a row, the edges padded to 16 bytes, 8 bytes
    a slot, within an H100 block's 227 KB."""
    plan = ctmc_chunk.slot_plan(n_slots, n_edges)
    assert plan["threads"] == 32
    assert plan["smem_bytes"] == 4 * (-(-n_edges // 4) * 4 + 2 * n_slots)
    assert plan["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("n_slots,n_edges", [(0, 130), (-3, 0),
                                             (28991, 130), (29057, 0)])
def test_slot_plan_refuses(n_slots, n_edges):
    with pytest.raises(ValueError, match="ctmc_chunk"):
        ctmc_chunk.slot_plan(n_slots, n_edges)
    if n_slots > 1000:
        with pytest.raises(ValueError, match="Params.repair_slots"):
            ctmc_chunk.slot_plan(n_slots, n_edges)


def test_library_hash_covers_headers_and_flags(tmp_path, monkeypatch):
    path = ctmc_chunk.LIBRARY.library_path()
    assert path.name.startswith("ctmc_chunk_") and path.suffix == ".so"
    assert "-fmad=false" in ctmc_chunk.LIBRARY.flags
    assert "-fmad=false" not in des_step.LIBRARY.flags
    other = _build.CudaLibrary("ctmc_chunk", ctmc_chunk._bind)
    assert other.library_path() != path                 # flags differ
    # an edited header names another library
    (tmp_path / "ctmc_chunk.cu").write_bytes(ctmc_chunk.LIBRARY.source
                                             .read_bytes())
    (tmp_path / "event_race.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    lib = _build.CudaLibrary("ctmc_chunk", ctmc_chunk._bind)
    first = lib.library_path()
    (tmp_path / "event_race.cuh").write_text("// two\n")
    assert lib.library_path() != first


@pytest.mark.parametrize("name", ["scen_exponential", "scen_lognormal",
                                  "scen_empirical", "scen_rate_grid",
                                  "scen_shocks_only"])
def test_layout_of_each_scenario_instance(name):
    state, pv, R, P, channels = _setup(name, "cpu")
    fam = _fam_kw(CASES[name][0])
    n_dom, codes = fam["scen"]
    us = _draw(R, 0, n_steps=2, kind=fam["kind"])
    lay = ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    assert lay["scen"] and (lay["n_dom"], lay["n_camp"], lay["codes"]) == (
        n_dom, len(codes), codes)
    assert pv.shape[-1] == ctmc_chunk.pv_width(
        fam["kind"], fam["n_seg"], n_dom=n_dom, n_camp=len(codes))
    assert set(state) & set(ctmc_chunk.SCEN_LANES) == set(
        ctmc_chunk.scenario_lanes(fam["scen"]))
    codes_t = torch.tensor(codes, dtype=torch.int32) if codes else None
    args = ctmc_chunk._args(lay, codes_t)
    assert (args.scen, args.n_dom, args.n_camp) == (1, n_dom, len(codes))
    assert args.deficit == state["deficit"].data_ptr()
    assert list(args.scen_metric) == [state[k].data_ptr()
                                      for k in ctmc_chunk.SCEN_METRICS]
    assert (args.camp_codes or 0) == (codes_t.data_ptr() if codes else 0)
    assert (args.domain_shocks or 0) == (
        state["domain_shocks"].data_ptr() if n_dom else 0)
    # the scenario-free launch refuses the lanes, and the parameter row's
    # trailing columns are counted
    with pytest.raises(ValueError, match="fault-domain scenario"):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels,
                                kind=fam["kind"], n_seg=fam["n_seg"])
    with pytest.raises(ValueError, match="columns"):
        ctmc_chunk.chunk_layout(state, us, pv[..., :-1].contiguous(), R, P,
                                channels, **fam)


@pytest.mark.parametrize("what", ["slots", "codes", "domains", "lane",
                                  "missing", "dtype"])
def test_layout_refuses_a_bad_scenario(what):
    state, pv, R, P, channels = _setup("scen_exponential", "cpu")
    fam = _fam_kw(CASES["scen_exponential"][0])
    us = _draw(R, 0, n_steps=2)
    match = "ctmc_chunk"
    if what == "slots":
        fam.update(rkind="weibull")
        match = "exponential repairs"
    elif what == "codes":
        fam["scen"] = (fam["scen"][0], (0, 7))
        match = "scenario key"
    elif what == "domains":
        fam["scen"] = (fam["scen"][0] + 1, fam["scen"][1])
        match = "domain_shocks has shape"
    elif what == "lane":
        fam["scen"] = (fam["scen"][0], (0,))       # no window: no maint
        match = "does not carry"
    elif what == "missing":
        del state["deficit"]
        match = "lacks"
    elif what == "dtype":
        state["camp_idx"] = state["camp_idx"].float()
        match = "camp_idx has dtype"
    with pytest.raises(ValueError, match=match):
        ctmc_chunk.chunk_layout(state, us, pv, R, P, channels, **fam)
    before = dict(ctmc_chunk.LAUNCHES_BY_SCEN)
    with pytest.raises(ValueError, match="ctmc_chunk"):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, P, channels, **fam)
    assert ctmc_chunk.LAUNCHES_BY_SCEN == before


def _scenario_reach(state, us, pv, R, P, channels, fam):
    """What the plain chunk reaches of a scenario over ``us``'s steps, a
    step at a time: shock steps, campaign kills, window starts and ends,
    stalls owing more than one server, kills during a checkpoint write."""
    n = dict.fromkeys(("shock", "kill", "window_start", "window_end",
                       "deep_stall", "kill_in_write"), 0)
    codes = fam["scen"][1]
    for k in range(us.shape[0]):
        before = state
        state = tv._steps_ref(state, us[k:k + 1], pv, R, P, "ref", channels,
                              fam["kind"], fam["n_seg"], fam["rkind"],
                              fam["n_rseg"], fam["scen"])
        n["shock"] += int((state["n_domain_shocks"]
                           > before["n_domain_shocks"]).sum())
        if codes:
            fired = state["camp_idx"] > before["camp_idx"]
            code = torch.tensor(codes)[before["camp_idx"].clamp(
                max=len(codes) - 1).long().cpu()]
            n["kill"] += int((fired.cpu() & (code == 0)).sum())
            n["window_start"] += int((fired.cpu() & (code == 1)).sum())
            n["window_end"] += int((fired.cpu() & (code == 2)).sum())
        n["deep_stall"] += int(((state["phase"] == tv.STALL)
                                & (before["phase"] != tv.STALL)
                                & (state["deficit"] > 1.0)).sum())
        n["kill_in_write"] += int(((before["in_ckpt"] > 0)
                                   & (state["n_shock_killed"]
                                      > before["n_shock_killed"])).sum())
    return n


#: the scenario cases whose first chunk must reach every branch
SCEN_CHUNK_CASES = tuple(f"scen_{name}" for name in SCENARIOS)


@pytest.mark.parametrize("name", SCEN_CHUNK_CASES)
def test_scenario_chunk_reaches_every_branch(name):
    """The first 64 steps of each scenario case hold a shock step, the
    campaign kill, the window's start and end, a stall owing more than
    one server and a kill during a checkpoint write (so the card cases
    below hold the kernel's every scenario branch against the plain
    chunk)."""
    state, pv, R, P, channels = _setup(name, "cpu")
    fam = _fam_kw(CASES[name][0])
    reach = _scenario_reach(state, _draw(R, 0, kind=fam["kind"]), pv, R, P,
                            channels, fam)
    assert min(reach.values()) > 0, reach


# ---------------------------------------------------------------------------
# the plain chunk (CPU)
# ---------------------------------------------------------------------------

def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["default", "ckpt_paid", "hist_all",
                                  "sweep_p3_r20", "sweep_p3_r20_bucketed"])
def test_steps_ref_is_the_prefactoring_loop(name):
    state, pv, R, P, channels = _setup(name, "cpu")
    us = _draw(R, 3, n_steps=20)
    got = tv._steps_ref(state, us, pv, R, P, None, channels)
    # the loop as run_chunk ran it before the plain chunk was factored out
    want = state
    tiled = us[:, :R] if us.shape[1] != R else us
    if P > 1:
        tiled = tiled.repeat(1, P, 1)
    for k in range(tiled.shape[0]):
        want = tv._step_u(want, tiled[k], pv, None, channels)
    _assert_same(got, want)


def test_chunk_loop_on_cpu_takes_the_plain_chunk():
    state, pv, R, P, channels = _setup("small", "cpu")
    before = (ctmc_chunk.LAUNCHES, des_step.LAUNCHES)
    out = tv._chunk_loop(pv, 0, P, R, 64, 2, 5, None, False, channels, state)
    assert (ctmc_chunk.LAUNCHES, des_step.LAUNCHES) == before
    want = state
    for i, n in ((0, 64), (1, 64), (2, 5)):
        want = tv._steps_ref(want, _draw(R, i, n_steps=n, seed=0), pv, R, P,
                             "ref", channels)
    for k in want:
        assert torch.equal(out[k], want[k]), k
    with pytest.raises(ValueError, match="ctmc_chunk impl='cuda'"):
        tv._chunk_loop(pv, 0, P, R, 64, 1, 0, "cuda", True, channels, state)


@pytest.fixture(scope="module")
def jax_vectorized():
    pytest.importorskip("jax")
    from repro.core import vectorized as jv
    return jv


@pytest.mark.parametrize("name", ["default", "ckpt_paid", "hist_all"])
def test_steps_ref_64_steps_against_jax(name, jax_vectorized):
    """64 steps of the plain chunk against 64 calls of the reference's
    ``_step_u`` on the same numpy uniforms, each package on its own state:
    at least 99% of rows end with identical integer lanes (the pick-flip
    budget of ``test_torch_step.py::test_trajectory_integer_lanes_agree``)."""
    import jax
    import jax.numpy as jnp

    from repro.core.params import Params as JParams
    jv = jax_vectorized
    pts, R, mr, _, _, _ = CASES[name]
    jp = JParams.from_dict(pts[0].to_dict())
    mr = jp.max_run_records if mr is None else mr
    js = jv._initial_state(jp, R, mr)
    ts = tv.state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                             "cpu")
    channels = jv._hist_channels([jp])
    step = jax.jit(lambda s, u, pv: jv._step_u(
        s, u, pv, "ref", "exponential", "exponential", channels))
    rng = np.random.default_rng(29)
    us = rng.uniform(1e-12, 1.0, (64, R, 8)).astype(np.float32)
    jpv = jv._params_vector(jp)
    for k in range(64):
        js = step(js, jnp.asarray(us[k]), jpv)
    ts = tv._steps_ref(ts, torch.as_tensor(us),
                       torch.as_tensor(tv._params_vector(pts[0])), R, 1,
                       None, channels)
    same = np.ones(R, bool)
    for k in ("phase", "n_runs", "n_failures", "n_random_failures",
              "n_systematic_failures", "n_preemptions", "n_auto_repairs",
              "n_manual_repairs", "n_failed_repairs", "n_host_selections",
              "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed", "run",
              "sb", "fw", "fs", "auto", "man"):
        a, b = np.asarray(js[k]), ts[k].numpy()
        same &= (a == b).reshape(R, -1).all(-1)
    assert same.mean() >= 0.99, same.mean()
    assert float(ts["n_failures"].sum()) > 0


# ---------------------------------------------------------------------------
# the kernel against the plain chunk (card)
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _compare_states(got, want, label):
    """Integer lanes and histogram counts exact, float lanes within 1e-6
    relative; returns the count of bit-different float elements."""
    assert sorted(got) == sorted(want), label
    bits = 0
    for k in want:
        a, b = got[k].cpu(), want[k].cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k)
        if k == "hist" or not a.dtype.is_floating_point:
            assert torch.equal(a, b), (label, k)
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0,
                                   err_msg=f"{label} {k}")
        bits += int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return bits


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_chunk_kernel_matches_steps_ref(name):
    _needs_card()
    state, pv, R, P, channels = _setup(name, "cuda")
    fam = _fam_kw(CASES[name][0])
    kind, rkind = fam["kind"], fam["rkind"]
    snapshot = {k: v.clone() for k, v in state.items()}
    n_chunks = CASES[name][5]
    got = want = state
    for i in range(n_chunks):
        us = _draw(R, i, device="cuda", kind=kind, rkind=rkind)
        launches, steps = ctmc_chunk.LAUNCHES, ctmc_chunk.STEPS
        by_kind = ctmc_chunk.LAUNCHES_BY_KIND[kind]
        by_repair = ctmc_chunk.LAUNCHES_BY_REPAIR[rkind]
        race = des_step.LAUNCHES
        scen_launches = ctmc_chunk.LAUNCHES_BY_SCEN[kind]
        got = ctmc_chunk.ctmc_chunk_cuda(got, us, pv, R, P, channels, **fam)
        if fam["scen"] is not None and i == 0:
            reach = _scenario_reach(want, us, pv, R, P, channels, fam)
        want = tv._steps_ref(want, us, pv, R, P, "ref", channels, kind,
                             fam["n_seg"], rkind, fam["n_rseg"], fam["scen"])
        torch.cuda.synchronize()
        assert ctmc_chunk.LAUNCHES_BY_SCEN[kind] == scen_launches + (
            fam["scen"] is not None)
        assert ctmc_chunk.LAUNCHES == launches + 1
        assert ctmc_chunk.LAUNCHES_BY_KIND[kind] == by_kind + 1
        assert ctmc_chunk.LAUNCHES_BY_REPAIR[rkind] == by_repair + 1
        assert ctmc_chunk.STEPS == steps + 64
        assert des_step.LAUNCHES == race
        assert _compare_states(got, want, f"{name} chunk {i}") == 0
    for k, v in snapshot.items():                 # the caller's dict
        assert torch.equal(state[k], v), k
    assert float(want["n_failures"].sum()) > 0
    if name in ("finish_mid_chunk", "repair_short"):
        done = want["phase"] == tv.DONE
        assert 0.2 < float(done.float().mean()) <= 1.0
    if name == "repair_overflow":
        assert float(want["n_repair_overflow"].sum()) > 0
    if name == "repair_width_44":
        assert int(torch.isfinite(want["repair_rem"]).sum(-1).max()) > 32
    if name.startswith("scen_") and name in SCEN_CHUNK_CASES:
        assert min(reach.values()) > 0, reach


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [1, 7])
def test_chunk_kernel_short_chunks_and_inplace(n_steps):
    _needs_card()
    state, pv, R, P, channels = _setup("sweep_structural", "cuda")
    us = _draw(R, 0, n_steps=n_steps, device="cuda")
    want = tv._steps_ref(state, us, pv, R, P, "ref", channels)
    own = {k: v.clone() for k, v in state.items()}
    got = ctmc_chunk.ctmc_chunk_cuda(own, us, pv, R, P, channels,
                                     inplace=True)
    torch.cuda.synchronize()
    for k in ctmc_chunk.WRITTEN:
        if k in own:
            assert got[k].data_ptr() == own[k].data_ptr(), k
    assert _compare_states(got, want, f"{n_steps} steps") == 0


@pytest.mark.gpu
@pytest.mark.parametrize("repairs", ["exponential", "weibull"])
def test_sweep_through_the_kernel_matches_the_plain_loop(repairs):
    _needs_card()
    base = SMALL if repairs == "exponential" else SMALL.replace(
        repair_distribution=repairs, distribution_kwargs={"k": 0.7})
    grid = [base.replace(warm_standbys=w) for w in (0, 1, 2)]
    kw = dict(n_replicas=40, seed=6, device="cuda")
    launches, steps = ctmc_chunk.LAUNCHES, ctmc_chunk.STEPS
    race = des_step.LAUNCHES
    fused = tv.simulate_ctmc_sweep(grid, **kw)
    assert ctmc_chunk.LAUNCHES > launches
    assert ctmc_chunk.STEPS == steps + 64 * (ctmc_chunk.LAUNCHES - launches)
    plain = tv.simulate_ctmc_sweep(grid, impl="ref", **kw)
    assert des_step.LAUNCHES == race
    for a, b in zip(fused, plain):
        assert a["completed"].all()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
