"""The port's fault domains and campaigns on its CTMC path, against the
reference's.

Host helpers (``scenario_key``, ``scenario_columns``,
``scenario_budget``) and what the engine derives from them (the parameter
row and the step budget) must equal the reference's (``==``) on
tests/test_faultdomains.py's topology, campaign and scenario and on the
40-rack Table-I topology of examples/capacity_planning.py.  Then the
port's ``_step_u`` in lockstep with the reference's for 200 steps on a
scenario with shocks, a kill, a maintenance window and checkpoint writes,
under exponential, lognormal and Weibull failures (Weibull also with fault
domains alone, no campaign slot among the residuals), each step from the
reference's state on the same numpy uniforms: integer lanes, ``camp_idx``
and ``domain_shocks`` identical on every row-step (the lognormal and
Weibull accepts may flip within an ulp on at most 0.2% of row-steps, as
in tests/test_torch_hazards.py), float lanes within 1e-6 of their scale
(2e-6 for Weibull, whose inversion cancels, as there).
Inside the port: the inert scenario equals the scenario-free run bit for
bit, campaigns and maintenance windows are exact, and run parity against
the port's event engine holds at |z| < 3.5.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import faultdomains as tfd
from repro_torch.core import vectorized as tv
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
from repro.core import faultdomains as jfd  # noqa: E402
from repro.core import hazards as jh  # noqa: E402
from repro.core import vectorized as jv  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

F32 = np.float32

#: tests/test_faultdomains.py's topology, campaign, base and scenario
TOPO = jc.FaultTopology(n_racks=4, racks_per_pod=2, rack_shock_rate=1.2e-4,
                        pod_shock_rate=3e-5)
CAMPAIGN = jc.Campaign(events=(
    jc.CampaignEvent(time=400.0, kind="kill", domain=2),
    jc.CampaignEvent(time=900.0, kind="maintenance", duration=300.0)))
BASE = JParams(job_size=24, working_pool_size=32, spare_pool_size=8,
               warm_standbys=4, job_length=3000.0, random_failure_rate=2e-4,
               systematic_failure_rate=1e-3, recovery_time=10.0, seed=5)
SCENARIO = BASE.replace(fault_domains=TOPO, campaign=CAMPAIGN)
#: examples/capacity_planning.py's rack-outage topology at Table-I width
#: and benchmarks/engine_perf.py's campaign on it (45 domains, 3 entries)
RACKS40 = jc.FaultTopology(n_racks=40, racks_per_pod=8,
                           rack_shock_rate=1e-5, pod_shock_rate=2e-6)
TABLE_I = JParams(job_length=8 * DAY)
CONFIGS = {
    "topology": BASE.replace(fault_domains=TOPO),
    "maintenance_only": BASE.replace(campaign=jc.Campaign(events=(
        jc.CampaignEvent(time=900.0, kind="maintenance", duration=300.0),))),
    "scenario": SCENARIO,
    "inert": BASE.replace(fault_domains=jc.FaultTopology(
        n_racks=4, racks_per_pod=2), campaign=jc.Campaign()),
    "racks40": TABLE_I.replace(fault_domains=jc.FaultTopology(
        n_racks=40, racks_per_pod=8, rack_shock_rate=5e-6)),
    "racks40_campaign": TABLE_I.replace(
        failure_distribution="lognormal", distribution_kwargs={"sigma": 1.0},
        fault_domains=RACKS40, campaign=jc.Campaign(events=(
            jc.CampaignEvent(time=2 * DAY, kind="kill", domain=3),
            jc.CampaignEvent(time=4 * DAY, kind="maintenance",
                             duration=0.4 * DAY)))),
}


def _port(p: JParams) -> TParams:
    return TParams.from_dict(p.to_dict())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_helpers_equal_the_reference(name):
    ref = CONFIGS[name]
    port = _port(ref)
    assert tfd.scenario_key(port) == jfd.scenario_key(ref)
    cols, want = tfd.scenario_columns(port), jfd.scenario_columns(ref)
    assert cols.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(cols, want)
    for horizon in (ref.job_length, 1.7 * ref.job_length):
        assert tfd.scenario_budget(port, horizon) \
            == jfd.scenario_budget(ref, horizon)
    pv, jpv = tv._params_vector(port), np.asarray(jv._params_vector(ref))
    assert pv.dtype == jpv.dtype == F32
    np.testing.assert_array_equal(pv, jpv)
    assert tv.default_max_steps(port) == jv.default_max_steps(ref)
    assert tv.supports(port) and jv.supports(ref)


def test_state_lanes_are_the_references():
    for name, ref in CONFIGS.items():
        port = _port(ref)
        js = jv._initial_state(ref, 4, None)
        ts = tv._initial_state(port, 4)
        assert sorted(ts) == sorted(js), name
        for k in ts:
            a, b = np.asarray(js[k]), ts[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (name, k)


# ---------------------------------------------------------------------------
# the step in lockstep with the reference
# ---------------------------------------------------------------------------

R = 128
#: SCENARIO with busier shocks and paid checkpoint writes, so 200 steps
#: hold shocks, the kill, the window and shocks during writes
LOCKSTEP = SCENARIO.replace(
    fault_domains=jc.FaultTopology(n_racks=4, racks_per_pod=2,
                                   rack_shock_rate=1e-3, pod_shock_rate=3e-4),
    checkpoint_interval=60.0, checkpoint_cost=2.0)
_WEIBULL = {"failure_distribution": "weibull",
            "distribution_kwargs": {"k": 1.5}}
LOCKSTEP_FAMILIES = {
    "exponential": {},
    "lognormal": {"failure_distribution": "lognormal",
                  "distribution_kwargs": {"sigma": 1.0}},
    # the failure arrives on the hazard residual, whose event index is
    # rebased past the campaign's slot, and past none without a campaign
    "weibull": _WEIBULL,
    "weibull_domains_only": {**_WEIBULL, "campaign": None},
}
_EXACT = ("phase", "n_runs", "n_failures", "n_random_failures",
          "n_systematic_failures", "n_preemptions", "n_auto_repairs",
          "n_manual_repairs", "n_failed_repairs", "n_host_selections",
          "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed",
          "n_domain_shocks", "n_shock_killed", "n_campaign_events",
          "run", "sb", "fw", "fs", "auto", "man", "hist", "deficit",
          "domain_shocks", "camp_idx", "maint")


@functools.lru_cache(maxsize=None)
def _jax_step(kind, channels, scen):
    return jax.jit(functools.partial(
        jv._step_u, impl="ref", kind=kind, rkind="exponential",
        hist_channels=channels, scen=scen))


@pytest.mark.parametrize("name", list(LOCKSTEP_FAMILIES))
def test_step_lockstep_matches_reference(name):
    ref = LOCKSTEP.replace(**LOCKSTEP_FAMILIES[name])
    kind, scen = jh.hazard_kind(ref), jfd.scenario_key(ref)
    has_camp = ref.campaign is not None
    assert scen == (6, (0, 1, 2) if has_camp else ())
    # a scenario draws no uniform of its own
    n_u = jv._n_uniforms(kind)
    assert tv._n_uniforms(kind) == n_u == (8 if name == "exponential"
                                           else 9)
    channels = jv._hist_channels([ref])
    step = _jax_step(kind, channels, scen)
    js = jv._initial_state(ref, R, None)
    pv = jv._params_vector(ref)
    tpv = torch.as_tensor(tv._params_vector(_port(ref)))
    rng = np.random.default_rng(19)
    rtol = 2e-6 if kind == "weibull" else 1e-6
    flips = 0
    reached = dict.fromkeys(("shock", "kill", "window", "in_write"), 0)
    for _ in range(200):
        u = rng.uniform(1e-12, 1.0, (R, n_u)).astype(F32)
        before = {k: np.asarray(v) for k, v in js.items()}
        j_out = step(js, jnp.asarray(u), pv)
        t_out = tv._step_u(tv.state_from_numpy(before, "cpu"),
                           torch.as_tensor(u), tpv, None, channels, kind,
                           0, "exponential", 0, scen)
        assert sorted(t_out) == sorted(j_out)
        assert ("camp_idx" in j_out) == has_camp
        same = np.ones(R, bool)
        for k in (k for k in _EXACT if k in j_out):
            a, b = np.asarray(j_out[k]), t_out[k].numpy()
            same &= (a == b).reshape(R, -1).all(-1)
        flips += int((~same).sum())
        for k, v in j_out.items():
            a, b = np.asarray(v), t_out[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in _EXACT or a.dtype.kind != "f" or k == "hist_edges":
                continue
            assert np.array_equal(np.isinf(a[same]), np.isinf(b[same])), k
            prev = before[k].astype(np.float64)
            prev = prev[np.isfinite(prev)]
            scale = float(np.abs(prev).max()) if prev.size else 0.0
            fin = np.isfinite(a[same])
            np.testing.assert_allclose(b[same][fin], a[same][fin],
                                       rtol=rtol, atol=rtol * scale,
                                       err_msg=k)
        after = {k: np.asarray(v) for k, v in j_out.items()}
        struck = after["n_shock_killed"] > before["n_shock_killed"]
        reached["shock"] += int((after["n_domain_shocks"]
                                 > before["n_domain_shocks"]).sum())
        if has_camp:
            reached["kill"] += int((struck & (before["camp_idx"] == 0)
                                    & (after["camp_idx"] == 1)).sum())
            reached["window"] += int((after["maint"]
                                      > before["maint"]).sum())
        reached["in_write"] += int((struck & (before["in_ckpt"] > 0)).sum())
        js = j_out
    if kind == "exponential":
        assert flips == 0, flips
    else:
        assert flips <= 0.002 * 200 * R, flips
    if not has_camp:
        del reached["kill"], reached["window"]
    assert min(reached.values()) > 0, reached
    final = {k: np.asarray(v) for k, v in js.items()}
    assert (final["deficit"] > 1.0).any() or reached["shock"] > R


# ---------------------------------------------------------------------------
# the port's engine
# ---------------------------------------------------------------------------

def test_inert_scenario_is_the_scenario_free_run():
    """Zero shock rates and an empty campaign add +0 lanes to in-order sums
    and draw nothing: every lane of every replica equals the plain run."""
    plain = tv.simulate_ctmc(_port(BASE), n_replicas=64, seed=3,
                             max_steps=4096, device="cpu")
    scen = tv.simulate_ctmc(_port(CONFIGS["inert"]), n_replicas=64, seed=3,
                            max_steps=4096, device="cpu")
    assert set(scen) == set(plain) | {"domain_shocks"}
    for k in plain:
        np.testing.assert_array_equal(plain[k], scen[k], err_msg=k)
    assert scen["domain_shocks"].shape == (64, 6)
    assert scen["domain_shocks"].sum() == 0


def test_campaign_kill_is_exact_ctmc():
    """tests/test_faultdomains.py's case on the port: schedule counts are
    exact per replica; the kill size (10 servers of rack 2) exact in
    expectation -- the CTMC strikes ``fraction x count`` per compartment
    with systematic rounding."""
    p = _port(SCENARIO.replace(fault_domains=jc.FaultTopology(
        n_racks=4, racks_per_pod=2)))
    out = tv.simulate_ctmc(p, n_replicas=256, seed=2, device="cpu")
    np.testing.assert_array_equal(out["n_campaign_events"], 3.0)
    np.testing.assert_array_equal(out["n_domain_shocks"], 0.0)
    killed = np.asarray(out["n_shock_killed"], float)
    assert np.all((killed >= 7) & (killed <= 13))
    assert abs(killed.mean() - 10.0) < 0.3


def test_maintenance_pauses_repairs_resume_with_remaining():
    """tests/test_faultdomains.py's case on the port's event engine
    (deterministic repairs go there): a repair in flight when the window
    opens finishes exactly ``window length`` later than it would have."""
    window = tc.CampaignEvent(time=60.0, kind="maintenance", duration=500.0)
    p = _port(BASE).replace(
        job_size=8, working_pool_size=12, spare_pool_size=4,
        warm_standbys=0, job_length=2000.0,
        random_failure_rate=2e-3, systematic_failure_rate=0.0,
        automated_repair_probability=1.0,
        auto_repair_failure_probability=0.0,
        manual_repair_failure_probability=0.0,
        repair_distribution="deterministic", auto_repair_time=100.0,
        campaign=tc.Campaign(events=(window,)))
    assert tc.resolve_engine(p, "auto") == "event"
    sim = tc.ClusterSimulation(p, seed=4)
    tracer = tc.Tracer()
    tracer.attach(sim)
    sim.run()
    starts: dict = {}
    for e in tracer.events:
        if e.kind == "repair_start":
            starts.setdefault(e.server, []).append(e.time)
    dones = [(e.server, e.time) for e in tracer.events
             if e.kind == "repair_done"]
    assert dones, "need at least one completed repair"
    w0, w1 = window.time, window.time + window.duration
    for sid, t_done in dones:
        t0 = starts[sid].pop(0)
        expect = t0 + p.auto_repair_time
        if t0 < w1 and expect > w0:
            expect += w1 - max(t0, w0) if t0 >= w0 else window.duration
        assert not (w0 < t_done < w1), (sid, t_done)
        assert t_done == pytest.approx(expect, abs=1e-6), (sid, t0, t_done)


def test_maintenance_gates_ctmc_repairs():
    """On the CTMC path a window gates the exponential repair clocks to
    zero: no repair completes on a step that starts inside it, and repairs
    resume after it."""
    p = _port(BASE).replace(
        job_length=2000.0, random_failure_rate=2e-3,
        campaign=tc.Campaign(events=(tc.CampaignEvent(
            time=60.0, kind="maintenance", duration=500.0),)))
    scen = tfd.scenario_key(p)
    state = tv._initial_state(p, 64)
    pv = torch.as_tensor(tv._params_vector(p))
    rng = np.random.default_rng(5)
    inside = after = 0
    for _ in range(300):
        u = torch.as_tensor(rng.uniform(1e-12, 1.0, (64, 8)).astype(F32))
        new = tv._step_u(state, u, pv, None, tv._hist_channels([p]),
                         "exponential", 0, "exponential", 0, scen)
        repaired = (new["n_auto_repairs"] + new["n_manual_repairs"]
                    > state["n_auto_repairs"] + state["n_manual_repairs"])
        in_window = state["maint"] > 0
        assert not bool((repaired & in_window).any())
        inside += int(in_window.sum())
        after += int((repaired & (state["camp_idx"] == 2)).sum())
        state = new
    assert inside > 0 and after > 0


def test_scenario_matches_the_event_engine():
    """SCENARIO (shocks, a mid-run kill, a maintenance window) on the
    port's CTMC engine against its event engine (bit for bit the
    reference's): metric means within |z| < 3.5."""
    p = _port(SCENARIO)
    out = tv.simulate_ctmc(p, n_replicas=768, seed=6, device="cpu")
    assert out["completed"].mean() > 0.99
    res = tc.simulate(p, 48, base_seed=5)
    for m in ("total_time", "n_failures", "n_standby_swaps",
              "n_host_selections", "n_preemptions", "recovery_overhead",
              "n_domain_shocks", "n_shock_killed", "n_campaign_events"):
        ev = np.array([getattr(r, m) for r in res], float)
        a = np.asarray(out[m], float)
        se = np.sqrt(a.std() ** 2 / len(a) + ev.std(ddof=1) ** 2 / len(ev))
        z = float((ev.mean() - a.mean()) / max(se, 1e-9))
        assert abs(z) < 3.5, (m, ev.mean(), float(a.mean()), z)
    np.testing.assert_allclose(out["domain_shocks"].sum(axis=1),
                               out["n_domain_shocks"], rtol=1e-6)


def test_shock_rate_sweep_csv_columns_match_the_reference(tmp_path):
    """``rack_shock_rate`` is a sweep axis of the port's CTMC engine, and
    its sweep table has the reference's columns."""
    base = SCENARIO.replace(job_length=500.0, campaign=None)
    kw = dict(n_replications=8, engine="ctmc")
    ref = jc.OneWaySweep("shock", "rack_shock_rate", [0.0, 4e-4],
                         base_params=base, **kw).run()
    port = tc.OneWaySweep("shock", "rack_shock_rate", [0.0, 4e-4],
                          base_params=_port(base), device="cpu", **kw).run()
    assert [pt.engine for pt in port.points] == ["ctmc", "ctmc"]
    rows = port.to_rows()
    assert rows[0]["n_domain_shocks"] == 0.0 < rows[1]["n_domain_shocks"]
    paths = {}
    for tag, res in (("ref", ref), ("port", port)):
        paths[tag] = tmp_path / f"{tag}.csv"
        res.write_csv(str(paths[tag]))
    header = paths["port"].read_text().splitlines()[0]
    assert header == paths["ref"].read_text().splitlines()[0]
    assert "n_domain_shocks" in header and "n_incomplete" in header
