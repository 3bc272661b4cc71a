"""Float64 age (``Params.age_dtype="float64"``) on the port's CTMC engine.

The reference keeps the failure-age lane ``age`` and the repair-slot lane
``repair_rem`` in float64 under this knob, its carve-out for the
cancellation of the Weibull inversion ``(a**k + E/C)**(1/k) - a`` at large
ages; every other lane stays float32.  On the CPU: ``_step_u`` in lockstep
with the reference's (JAX's x64 flag on, in a fixture that puts back what
it was) for 200 steps from the reference's state on the same numpy
uniforms, under Weibull failures with Weibull repairs, Weibull failures
alone, bathtub failures (a thinning family, whose hazards read the float32
view of the age) and Weibull failures under fault domains.  Every lane has
the reference's dtype; integer lanes are identical on every row-step
(a budget of 0.2% of row-steps for pick flips within an ulp, as
tests/test_torch_repairs.py allows; none is seen); float32 lanes agree
within 1e-6 of their scale; ``age``, and each ``repair_rem`` slot that
counted down, agree within 1e-12 of their value plus four float32 ulps of
the step's dt -- dt is the race's float32 output, which the two packages
may round an ulp apart, and a lane moved in float32 would miss this by an
ulp of its own value -- and a slot drawn in the step (a float32 quantile,
cast) within 1e-6 of itself.  Then the reference's large-age and end-to-end
tests on the port, the float64 layouts of the chunk kernel and the
mixed-pair refusal, and the sweep's grouping by age dtype.  On the card
(marked ``gpu``): every float64 instance of the chunk kernel bit for bit
against the plain chunk.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import faultdomains, hazards
from repro_torch.core import vectorized as tv
from repro_torch.core.faultdomains import (Campaign, CampaignEvent,
                                           FaultTopology)
from repro_torch.core.params import MINUTES_PER_DAY as DAY
from repro_torch.core.params import Params
from repro_torch.kernels import ctmc_chunk

torch.set_num_threads(1)

F32 = np.float32
F64 = torch.float64

#: tests/test_repair_dist.py's base (and test_nonexp's), float64 age
BASE = Params(job_size=24, working_pool_size=32, spare_pool_size=4,
              warm_standbys=2, job_length=2 * DAY,
              random_failure_rate=2.0 / DAY,
              systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
              auto_repair_time=30.0, manual_repair_time=120.0, seed=5,
              age_dtype="float64")
WEIBULL = dict(failure_distribution="weibull", distribution_kwargs={"k": 1.5})
TOPO = FaultTopology(n_racks=4, racks_per_pod=2, rack_shock_rate=2e-3,
                     pod_shock_rate=6e-4)
#: name -> Params keyword overrides of BASE, for the lockstep
LOCKSTEP = {
    "weibull_weibull_repairs": dict(WEIBULL, repair_distribution="weibull"),
    "weibull": WEIBULL,
    "bathtub": dict(failure_distribution="bathtub",
                    distribution_kwargs={"infant_factor": 8.0,
                                         "infant_tau": 0.25 * DAY}),
    "weibull_fault_domains": dict(WEIBULL, fault_domains=TOPO),
}


@pytest.fixture
def x64():
    """JAX with its x64 flag on for the test, then back to what it was."""
    jax = pytest.importorskip("jax")
    prev = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", True)
    try:
        yield jax
    finally:
        jax.config.update("jax_enable_x64", prev)


def _jparams(p: Params):
    from repro.core.params import Params as JParams
    return JParams.from_dict(p.to_dict())


# ---------------------------------------------------------------------------
# the step in lockstep with the reference, under x64
# ---------------------------------------------------------------------------

R = 128
_EXACT = ("phase", "n_runs", "n_failures", "n_random_failures",
          "n_systematic_failures", "n_preemptions", "n_auto_repairs",
          "n_manual_repairs", "n_failed_repairs", "n_host_selections",
          "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed",
          "n_repair_overflow", "n_domain_shocks", "n_shock_killed",
          "domain_shocks", "run", "sb", "fw", "fs", "auto", "man", "hist",
          "repair_cls", "repair_stage")


def _within_dt(a, b, prev):
    """``b`` is ``a`` within 1e-12 of ``a`` plus four float32 ulps of the
    step's change ``a - prev``: the float64 lane moved by the race's
    float32 dt, which the two packages may round an ulp apart, and a lane
    moved in float32 misses this by an ulp of its own value."""
    dt = np.abs(a - prev)
    ulp = np.spacing(dt.astype(F32)).astype(np.float64)
    return bool((np.abs(b - a) <= 1e-12 * np.abs(a) + 4 * ulp).all())


@pytest.mark.parametrize("name", list(LOCKSTEP))
def test_step_lockstep_float64_matches_reference(name, x64):
    import jax.numpy as jnp
    from repro.core import faultdomains as jf
    from repro.core import hazards as jh
    from repro.core import vectorized as jv
    p = BASE.replace(**LOCKSTEP[name])
    ref = _jparams(p)
    kind, rkind = jh.hazard_kind(ref), jh.repair_kind(ref)
    n_seg, n_rseg = jh.hazard_segment_count(ref), jh.repair_segment_count(ref)
    scen = jf.scenario_key(ref)
    assert (kind, rkind, scen) == (hazards.hazard_kind(p),
                                   hazards.repair_kind(p),
                                   faultdomains.scenario_key(p))
    channels = jv._hist_channels([ref])
    step = x64.jit(functools.partial(
        jv._step_u, impl="ref", kind=kind, rkind=rkind,
        hist_channels=channels, n_seg=n_seg, n_rseg=n_rseg, scen=scen))
    js = jv._initial_state(ref, R, None)
    assert np.asarray(js["age"]).dtype == np.float64
    pv = jv._params_vector(ref)
    tpv = torch.as_tensor(tv._params_vector(p))
    n_u = jv._n_uniforms(kind, rkind)
    rng = np.random.default_rng(13)
    flips = 0
    for _ in range(200):
        u = rng.uniform(1e-12, 1.0, (R, n_u)).astype(F32)
        before = {k: np.asarray(v) for k, v in js.items()}
        j_out = step(js, jnp.asarray(u), pv)
        t_out = tv._step_u(tv.state_from_numpy(before, "cpu"),
                           torch.as_tensor(u), tpv, None, channels, kind,
                           n_seg, rkind, n_rseg, scen)
        assert sorted(t_out) == sorted(j_out)
        same = np.ones(R, bool)
        for k in _EXACT:
            if k in j_out:
                a, b = np.asarray(j_out[k]), t_out[k].numpy()
                same &= (a == b).reshape(R, -1).all(-1)
        flips += int((~same).sum())
        for k, v in j_out.items():
            a, b = np.asarray(v), t_out[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in _EXACT or a.dtype.kind != "f" or k == "hist_edges":
                continue
            a, b = a[same], b[same]
            assert np.array_equal(np.isinf(a), np.isinf(b)), k
            fin = np.isfinite(a)
            if k == "age":
                # reset rows are 0 in both; elsewhere age advanced by the
                # step's dt, read back exactly in float64
                assert _within_dt(a, b, before[k][same]), k
                continue
            if k == "repair_rem":
                # a slot drawn this step (entered: it was free; escalated:
                # its stage went 0 -> 1) holds a float32 quantile draw; any
                # other slot counted down by the step's dt in float64 (0 on
                # a finished row)
                prev = before[k][same]
                stage = (before["repair_stage"][same],
                         np.asarray(j_out["repair_stage"])[same])
                drawn = fin & (np.isinf(prev)
                               | ((stage[0] == 0) & (stage[1] == 1)))
                np.testing.assert_allclose(b[drawn], a[drawn], rtol=1e-6,
                                           atol=0, err_msg=k)
                kept = fin & ~drawn
                assert _within_dt(a[kept], b[kept], prev[kept]), k
                continue
            prev = before[k].astype(np.float64)
            prev = prev[np.isfinite(prev)]
            scale = float(np.abs(prev).max()) if prev.size else 0.0
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=k)
        js = j_out
    assert flips <= 0.002 * 200 * R, flips
    final = {k: np.asarray(v) for k, v in js.items()}
    assert final["n_failures"].sum() > 0
    assert final["age"].max() > 10.0
    if rkind != "exponential":
        assert final["repair_rem"].dtype == np.float64
        assert np.isfinite(final["repair_rem"]).any()
    if scen is not None:
        assert final["n_domain_shocks"].sum() > 0


# ---------------------------------------------------------------------------
# the reference's large-age and end-to-end tests, on the port
# ---------------------------------------------------------------------------

def test_float64_carve_out_closes_large_age_cancellation(x64):
    """At age ~1e4 the float32 inversion ``(a^k + E/C)^(1/k) - a`` loses
    ~1e-3 min to cancellation; the float64 path pins the error orders of
    magnitude lower, and equals the reference's float64 inversion."""
    import jax.numpy as jnp
    from repro.core import hazards as jh
    age, k = 1.0e4, 1.5
    C, E = 1.0e-6, 0.1            # E/C << age^k: the cancellation regime
    ref = (age ** k + E / C) ** (1.0 / k) - age      # python float64

    def port(dtype):
        t = functools.partial(torch.tensor, dtype=dtype)
        out = hazards.weibull_conditional_ttf(t(age), t(C), t(k), t(E))
        assert out.dtype == torch.float32
        return float(out)

    f32, f64 = port(torch.float32), port(F64)
    err32, err64 = abs(f32 - ref), abs(f64 - ref)
    assert err32 > 1e-5, "test must sit in the cancellation regime"
    assert err64 < err32 / 10.0
    assert err64 < 1e-4 * max(ref, 1.0)
    j64 = float(jh.weibull_conditional_ttf(
        jnp.float64(age), jnp.float64(C), k, jnp.float64(E)))
    assert abs(f64 - j64) <= float(np.spacing(F32(j64)))


def test_age_dtype_float64_end_to_end():
    """The whole run keeps float64 age and repair-slot lanes and stays
    statistically on top of the float32 run."""
    p64 = BASE.replace(repair_distribution="weibull",
                       distribution_kwargs={"k": 0.7},
                       job_length=0.5 * DAY, max_run_records=19)
    p32 = p64.replace(age_dtype="float32")
    state = tv._initial_state(p64, 4)
    assert state["age"].dtype == state["repair_rem"].dtype == F64
    assert state["t"].dtype == torch.float32
    o64 = tv.simulate_ctmc(p64, n_replicas=256, seed=0, device="cpu")
    o32 = tv.simulate_ctmc(p32, n_replicas=256, seed=0, device="cpu")
    assert o64["completed"].mean() > 0.99
    for m in ("total_time", "n_failures", "n_auto_repairs"):
        a, b = o64[m], o32[m]
        assert a.dtype == b.dtype == F32
        se = np.sqrt(a.std() ** 2 / len(a) + b.std() ** 2 / len(b))
        assert abs(a.mean() - b.mean()) / max(se, 1e-9) < 3.5, m


# ---------------------------------------------------------------------------
# sweeps: one batch per age dtype
# ---------------------------------------------------------------------------

def test_sweep_splits_by_age_dtype_and_keeps_the_lanes(monkeypatch):
    wb = BASE.replace(**WEIBULL, job_length=0.25 * DAY)
    grid = [wb, wb.replace(age_dtype="float32"), wb.replace(warm_standbys=0)]
    dtypes = []
    loop = tv._chunk_loop

    def spy(*args, **kw):
        dtypes.append(args[10]["age"].dtype)
        return loop(*args, **kw)

    monkeypatch.setattr(tv, "_chunk_loop", spy)
    kw = dict(n_replicas=12, seed=4, max_steps=192, device="cpu")
    out = tv.simulate_ctmc_sweep(grid, **kw)
    assert sorted(map(str, dtypes)) == ["torch.float32", "torch.float64"]
    flat = tv.simulate_ctmc_sweep(grid, bucketed=False, **kw)
    for i, p in enumerate(grid):
        alone = tv.simulate_ctmc_sweep([p], **kw)[0]
        for k in alone:
            np.testing.assert_array_equal(out[i][k], alone[k], k)
            np.testing.assert_array_equal(out[i][k], flat[i][k], k)


def test_bucket_padding_keeps_the_age_dtype():
    p = BASE.replace(repair_distribution="weibull",
                     distribution_kwargs={"k": 0.7})
    state = tv._initial_state_batch([p, p], 3, 4, "cpu", "weibull", 8)
    padded = tv._bucket_pad_state(state, 2, 3, 2, 4)
    for k, v in state.items():
        assert padded[k].dtype == v.dtype, k
    assert padded["age"].dtype == padded["repair_rem"].dtype == F64


# ---------------------------------------------------------------------------
# the chunk kernel's float64 layouts (CPU)
# ---------------------------------------------------------------------------

#: one case a kind of instance: plain, slot, scenario
LAYOUTS = {
    "plain": BASE.replace(**WEIBULL),
    "slot": BASE.replace(**WEIBULL, repair_distribution="weibull"),
    "scenario": BASE.replace(**WEIBULL, fault_domains=TOPO),
}


def _layout_state(p, R=8):
    rkind = hazards.repair_kind(p)
    state = tv._initial_state_batch([p], R, 4, "cpu", rkind,
                                    tv._repair_slots_for([p], rkind),
                                    faultdomains.scenario_key(p))
    pv = torch.as_tensor(tv._params_vector(p))
    us = torch.rand((3, R, tv._n_uniforms(hazards.hazard_kind(p), rkind)))
    fam = dict(kind=hazards.hazard_kind(p), n_seg=0, rkind=rkind, n_rseg=0,
               scen=faultdomains.scenario_key(p))
    return state, us, pv, R, tv._hist_channels([p]), fam


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_of_the_float64_twins(name):
    state, us, pv, R, channels, fam = _layout_state(LAYOUTS[name])
    lay = ctmc_chunk.chunk_layout(state, us, pv, R, 1, channels, **fam)
    assert lay["age64"] and state["age"].dtype == F64
    if name == "slot":
        n_slots = state["repair_rem"].shape[1]
        assert state["repair_rem"].dtype == F64
        edges = state["hist_edges"].numel()
        assert lay["plan"] == ctmc_chunk.slot_plan(n_slots, edges, 8)
        assert lay["plan"]["smem_bytes"] == 4 * (-(-edges // 4) * 4) \
            + 12 * n_slots
    else:
        assert lay["plan"] is None
    f32 = {k: (v.float() if v.dtype == F64 else v) for k, v in state.items()}
    assert not ctmc_chunk.chunk_layout(f32, us, pv, R, 1, channels,
                                       **fam)["age64"]
    with pytest.raises(ValueError, match="not a CUDA device"):
        ctmc_chunk.ctmc_chunk_cuda(state, us, pv, R, 1, channels, **fam)


@pytest.mark.parametrize("age_dtype,rem_dtype", [(F64, torch.float32),
                                                 (torch.float32, F64)])
def test_layout_refuses_a_mixed_age_pair(age_dtype, rem_dtype):
    state, us, pv, R, channels, fam = _layout_state(LAYOUTS["slot"])
    state["age"] = state["age"].to(age_dtype)
    state["repair_rem"] = state["repair_rem"].to(rem_dtype)
    with pytest.raises(ValueError, match="repair_rem has dtype"):
        ctmc_chunk.chunk_layout(state, us, pv, R, 1, channels, **fam)


def test_layout_refuses_another_age_dtype():
    state, us, pv, R, channels, fam = _layout_state(LAYOUTS["plain"])
    state["age"] = state["age"].to(torch.float16)
    with pytest.raises(ValueError, match="age has dtype"):
        ctmc_chunk.chunk_layout(state, us, pv, R, 1, channels, **fam)


def test_float64_slot_plan_fits_and_refuses_by_name():
    assert ctmc_chunk.slot_plan(128, 130, 8) == {"threads": 32,
                                                 "smem_bytes": 2064}
    widest = (227 * 1024 - 4 * 132) // 12
    assert ctmc_chunk.slot_plan(widest, 130, 8)["smem_bytes"] \
        <= 227 * 1024
    with pytest.raises(ValueError, match=f"Params.repair_slots.*{widest}"):
        ctmc_chunk.slot_plan(widest + 1, 130, 8)
    # the float32 plan is what it was
    assert ctmc_chunk.slot_plan(4360, 130)["smem_bytes"] == 35408


# ---------------------------------------------------------------------------
# on the card: every float64 instance against the plain chunk
# ---------------------------------------------------------------------------

NONEXP = BASE.replace(job_length=2 * DAY)
FAMILIES = {
    "exponential": {},
    "weibull": WEIBULL,
    "bathtub": LOCKSTEP["bathtub"],
    "lognormal": dict(failure_distribution="lognormal",
                      distribution_kwargs={"sigma": 1.0}),
    "empirical": dict(failure_distribution="empirical",
                      distribution_kwargs={"edges": [0.4, 2.0],
                                           "rates": [0.3, 1.5, 0.7]}),
}
CAMPAIGN = Campaign(events=(
    CampaignEvent(time=60.0, kind="kill", domain=5),
    CampaignEvent(time=100.0, kind="maintenance", duration=60.0)))


def _slot_kw(name):
    """Each failure family with a non-exponential repair family (the
    empirical family with empirical repairs, as the float32 cases)."""
    kw = dict(FAMILIES[name])
    dkw = dict(kw.get("distribution_kwargs", {}))
    dkw.setdefault("k", 0.7)
    kw["distribution_kwargs"] = dkw
    kw["repair_distribution"] = {"exponential": "lognormal",
                                 "empirical": "empirical"}.get(name,
                                                               "weibull")
    if name == "exponential":
        kw["distribution_kwargs"] = {"sigma": 1.2}
    if name == "empirical":
        kw["distribution_kwargs"] = {"edges": [0.4, 2.0],
                                     "rates": [0.3, 1.5, 0.7]}
    return kw


#: name -> (points, replicas a point, per-row pv and bucketed, chunks)
GPU_CASES = {
    **{f"plain_{n}": ([NONEXP.replace(**kw)], 64, False, 3)
       for n, kw in FAMILIES.items()},
    **{f"slot_{n}": ([NONEXP.replace(**_slot_kw(n))], 48, False, 3)
       for n in FAMILIES},
    **{f"scen_{n}": ([NONEXP.replace(**kw, fault_domains=TOPO,
                                     campaign=CAMPAIGN, warm_standbys=1,
                                     checkpoint_interval=10.0,
                                     checkpoint_cost=4.0)], 48, False, 1)
       for n, kw in FAMILIES.items()},
    # a bucketed Weibull sweep with checkpoints, and Weibull repairs with
    # long jobs: ages reach the thousands of minutes
    "weibull_grid": ([NONEXP.replace(**WEIBULL, checkpoint_interval=60.0,
                                     checkpoint_cost=2.0, warm_standbys=w)
                      for w in (0, 1, 2)], 20, True, 3),
    "weibull_large_age": ([NONEXP.replace(
        **dict(WEIBULL, repair_distribution="weibull"),
        random_failure_rate=0.05 / DAY, systematic_failure_rate=0.1 / DAY,
        job_length=30 * DAY)], 32, False, 4),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gpu_setup(name):
    pts, R, per_row, n_chunks = GPU_CASES[name]
    p = pts[0]
    kind, rkind = hazards.hazard_kind(p), hazards.repair_kind(p)
    fam = dict(kind=kind, n_seg=hazards.hazard_segment_count(p),
               rkind=rkind, n_rseg=hazards.repair_segment_count(p),
               scen=faultdomains.scenario_key(p))
    P = len(pts)
    state = tv._initial_state_batch(pts, R, 4, "cuda", rkind,
                                    tv._repair_slots_for(pts, rkind),
                                    fam["scen"])
    rows = np.stack([tv._params_vector(q) for q in pts])
    if per_row:
        P_run, R_run = tv._next_pow2(P), tv._next_pow2(R)
        state = tv._bucket_pad_state(state, P, R, P_run, R_run)
        rows = np.concatenate([rows, np.repeat(rows[-1:], P_run - P, 0)])
        P, R = P_run, R_run
        pv = torch.as_tensor(np.repeat(rows, R, axis=0), device="cuda")
    else:
        pv = torch.as_tensor(rows[0], device="cuda")
    return state, pv, R, P, tv._hist_channels(pts), fam, n_chunks


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GPU_CASES))
def test_float64_instance_matches_steps_ref(name):
    """Each float64 twin against the plain chunk on the same state and
    draw: every lane bit for bit (integer lanes and histograms exact,
    float lanes compared as bits)."""
    _needs_card()
    state, pv, R, P, channels, fam, n_chunks = _gpu_setup(name)
    assert state["age"].dtype == F64
    got = want = state
    for i in range(n_chunks):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(tv._chunk_seed(17, i))
        us = torch.rand((64, tv._next_pow2(R),
                         tv._n_uniforms(fam["kind"], fam["rkind"])),
                        generator=gen, device="cuda").clamp_min_(1e-12)
        before = ctmc_chunk.LAUNCHES_BY_AGE["float64"]
        got = ctmc_chunk.ctmc_chunk_cuda(got, us, pv, R, P, channels, **fam)
        want = tv._steps_ref(want, us, pv, R, P, "ref", channels,
                             fam["kind"], fam["n_seg"], fam["rkind"],
                             fam["n_rseg"], fam["scen"])
        torch.cuda.synchronize()
        assert ctmc_chunk.LAUNCHES_BY_AGE["float64"] == before + 1
        for k, w in want.items():
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, i, k)
            if w.dtype.is_floating_point:
                bits = torch.int64 if w.dtype == F64 else torch.int32
                assert torch.equal(g.view(bits), w.view(bits)), (name, i, k)
            else:
                assert torch.equal(g, w), (name, i, k)
    assert float(want["n_failures"].sum()) > 0
    if name == "weibull_large_age":
        assert float(want["age"].max()) > 1e3


@pytest.mark.gpu
def test_float64_sweep_through_the_kernel_matches_the_plain_loop():
    _needs_card()
    base = NONEXP.replace(**WEIBULL, repair_distribution="weibull",
                          job_length=0.5 * DAY)
    grid = [base.replace(warm_standbys=w) for w in (0, 1, 2)]
    kw = dict(n_replicas=40, seed=6, device="cuda")
    before = ctmc_chunk.LAUNCHES_BY_AGE["float64"]
    fused = tv.simulate_ctmc_sweep(grid, **kw)
    assert ctmc_chunk.LAUNCHES_BY_AGE["float64"] > before
    plain = tv.simulate_ctmc_sweep(grid, impl="ref", **kw)
    for a, b in zip(fused, plain):
        assert a["completed"].all()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
