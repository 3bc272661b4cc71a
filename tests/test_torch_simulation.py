"""The port's event engine against the reference's, bit for bit.

The event engine is pure Python and numpy in both packages, so the same
Params and seed must give the same ``RunResult`` -- every float compared
with ``==``, every per-run list element for element -- over configs taken
from the reference's simulation, extension, fault-domain and empirical
tests.  The backend's event route (``run_replications(engine="event")``)
must give the same statistics and histogram counts (edges within a
tolerance).  Inside the port, the CTMC engine on the CPU and the event
engine agree in pooled-SE units (z < 3.5) on the configs of the
reference's ``tests/test_vectorized.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import distributions as t_dist
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402


def tiny(**kw) -> JParams:
    """tests/test_core_simulation.py's base config."""
    base = dict(job_size=32, working_pool_size=40, spare_pool_size=8,
                warm_standbys=4, job_length=2 * DAY, seed=123)
    base.update(kw)
    return JParams(**base)


#: tests/test_faultdomains.py's fleet, topology and campaign
_FD_BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=8,
                warm_standbys=4, job_length=3000.0,
                random_failure_rate=2e-4, systematic_failure_rate=1e-3,
                recovery_time=10.0, seed=5)
_TOPO = jc.FaultTopology(n_racks=4, racks_per_pod=2,
                         rack_shock_rate=1.2e-4, pod_shock_rate=3e-5)
_CAMPAIGN = jc.Campaign(events=(
    jc.CampaignEvent(time=400.0, kind="kill", domain=2),
    jc.CampaignEvent(time=900.0, kind="maintenance", duration=300.0)))

#: tests/test_empirical.py's base config
_EMP_BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=4,
                 warm_standbys=2, job_length=2 * DAY,
                 random_failure_rate=2.0 / DAY,
                 systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
                 auto_repair_time=30.0, manual_repair_time=120.0, seed=5)

#: name -> (reference Params, replications)
CONFIGS = {
    "default": (tiny(random_failure_rate=1.0 / DAY), 3),
    "zero_failures": (tiny(random_failure_rate=0.0,
                           systematic_failure_rate=0.0), 1),
    "stall": (tiny(job_size=16, warm_standbys=0, working_pool_size=16,
                   spare_pool_size=1, random_failure_rate=4.0 / DAY,
                   job_length=2 * DAY, diagnosis_probability=1.0,
                   auto_repair_time=2 * DAY, manual_repair_time=10 * DAY), 2),
    "preemption": (tiny(job_size=32, warm_standbys=2, working_pool_size=34,
                        spare_pool_size=10, random_failure_rate=2.0 / DAY,
                        auto_repair_time=50 * DAY,
                        manual_repair_time=50 * DAY), 2),
    "diagnosis": (tiny(diagnosis_probability=0.5, diagnosis_uncertainty=0.5,
                       random_failure_rate=1.0 / DAY, job_length=4 * DAY,
                       seed=9), 2),
    "retirement": (tiny(retirement_threshold=2, retirement_window=100 * DAY,
                        systematic_failure_fraction=0.5,
                        systematic_failure_rate=20 * 0.01 / DAY,
                        random_failure_rate=0.01 / DAY,
                        auto_repair_failure_probability=1.0,
                        manual_repair_failure_probability=1.0,
                        diagnosis_probability=1.0, auto_repair_time=5.0,
                        manual_repair_time=10.0, job_length=16 * DAY,
                        working_pool_size=64, spare_pool_size=32), 1),
    "checkpoint": (tiny(checkpoint_interval=60.0, checkpoint_cost=2.0,
                        random_failure_rate=2.0 / DAY), 2),
    "lognormal": (tiny(failure_distribution="lognormal",
                       random_failure_rate=0.5 / DAY, job_length=DAY), 2),
    "weibull": (tiny(failure_distribution="weibull",
                     distribution_kwargs={"k": 1.5},
                     repair_distribution="weibull",
                     random_failure_rate=0.5 / DAY, job_length=DAY), 2),
    "bad_set_regeneration": (tiny(bad_set_regeneration_period=0.5 * DAY,
                                  random_failure_rate=0.5 / DAY), 2),
    "bathtub": (JParams(job_size=16, working_pool_size=22, spare_pool_size=4,
                        warm_standbys=2, job_length=1 * DAY,
                        failure_distribution="bathtub",
                        random_failure_rate=1.0 / DAY,
                        distribution_kwargs={"infant_factor": 15.0,
                                             "infant_tau": 0.5 * DAY},
                        seed=3), 2),
    "failing_standbys": (tiny(standbys_can_fail=True,
                              random_failure_rate=1.0 / DAY), 2),
    "repair_servers": (tiny(repair_servers=2, random_failure_rate=2.0 / DAY,
                            auto_repair_time=240.0), 2),
    "shocks_and_campaign": (JParams(fault_domains=_TOPO, campaign=_CAMPAIGN,
                                    **_FD_BASE), 3),
    "maintenance_deterministic_repairs": (JParams(**{
        **_FD_BASE, "job_size": 8, "working_pool_size": 12,
        "spare_pool_size": 4, "warm_standbys": 0, "job_length": 2000.0,
        "random_failure_rate": 2e-3, "systematic_failure_rate": 0.0,
        "automated_repair_probability": 1.0,
        "auto_repair_failure_probability": 0.0,
        "manual_repair_failure_probability": 0.0,
        "repair_distribution": "deterministic", "auto_repair_time": 100.0,
        "campaign": jc.Campaign(events=(jc.CampaignEvent(
            time=60.0, kind="maintenance", duration=500.0),))}), 2),
    "campaign_weibull_repairs": (JParams(**{
        **_FD_BASE, "job_length": 1500.0, "fault_domains": _TOPO,
        "campaign": _CAMPAIGN, "repair_distribution": "weibull",
        "distribution_kwargs": {"repair_k": 1.5}}), 2),
    "empirical_failures": (JParams(failure_distribution="empirical",
                                   distribution_kwargs={
                                       "edges": [0.4, 2.0],
                                       "rates": [0.3, 1.5, 0.7]},
                                   **_EMP_BASE), 2),
    "empirical_repairs": (JParams(repair_distribution="empirical",
                                  distribution_kwargs={
                                      "edges": [0.5], "rates": [0.1, 2.0]},
                                  **_EMP_BASE), 2),
    "histogram_checkpoints": (tiny(
        checkpoint_interval=90.0, random_failure_rate=1.5 / DAY,
        histogram=jc.HistogramSpec(low=0.01, high=1e4, n_bins=24)), 2),
}


def _port(p: JParams) -> TParams:
    return TParams.from_dict(p.to_dict())


def _assert_same_results(port_results, ref_results):
    assert len(port_results) == len(ref_results)
    for a, b in zip(port_results, ref_results):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.to_dict() == b.to_dict()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_results_bit_identical(name):
    ref, n = CONFIGS[name]
    port = _port(ref)
    _assert_same_results(tc.simulate(port, n, base_seed=ref.seed),
                         jc.simulate(ref, n, base_seed=ref.seed))


@pytest.mark.parametrize("name", ["default", "shocks_and_campaign",
                                  "histogram_checkpoints"])
def test_event_route_statistics_and_histograms(name):
    ref, n = CONFIGS[name]
    t = tc.run_replications(_port(ref), n, engine="event")
    j = jc.run_replications(ref, n, engine="event")
    assert t.engine == j.engine == "event"
    _assert_same_results(t.results, j.results)
    assert set(t.stats) == set(j.stats)
    for key, stat in j.stats.items():
        assert dataclasses.asdict(t.stats[key]) == dataclasses.asdict(stat), \
            key
    assert set(t.histograms) == set(j.histograms) != set()
    for ch, h in j.histograms.items():
        np.testing.assert_array_equal(t.histograms[ch].counts, h.counts)
        np.testing.assert_allclose(t.histograms[ch].edges, h.edges,
                                   rtol=1e-6)
    assert tc.summarize(t.results) == jc.summarize(j.results)


def test_single_replication_and_tracer_identical():
    ref = CONFIGS["shocks_and_campaign"][0]
    events = []
    for core, p in ((tc, _port(ref)), (jc, ref)):
        sim = core.ClusterSimulation(p, seed=9)
        tracer = core.Tracer()
        tracer.attach(sim)
        result = sim.run()
        events.append(([dataclasses.astuple(e) for e in tracer.events],
                       result.to_dict(), tracer.counts()))
    assert events[0] == events[1]
    assert tc.simulate_one(_port(ref), seed=4).to_dict() == \
        jc.simulate_one(ref, seed=4).to_dict()


@pytest.mark.parametrize("n_jobs", [1, 2])
def test_multijob_bit_identical(n_jobs):
    """tests/test_extensions.py's two-job cluster (and one job alone)."""
    cluster = JParams(job_size=16, working_pool_size=64, spare_pool_size=8,
                      warm_standbys=2, job_length=1 * DAY,
                      random_failure_rate=1.0 / DAY, seed=11,
                      histogram=jc.HistogramSpec())
    specs = [dict(job_size=16, job_length=1 * DAY, warm_standbys=2),
             dict(job_size=24, job_length=0.5 * DAY, warm_standbys=2,
                  start_time=60.0)][:n_jobs]
    t = tc.simulate_multijob(_port(cluster), [tc.JobSpec(**s) for s in specs],
                             n_replications=2, base_seed=5)
    j = jc.simulate_multijob(cluster, [jc.JobSpec(**s) for s in specs],
                             n_replications=2, base_seed=5)
    for a, b in zip(t, j):
        assert (a.makespan, a.stall_events, a.queue_events,
                a.total_failures) == (b.makespan, b.stall_events,
                                      b.queue_events, b.total_failures)
        _assert_same_results(a.per_job, b.per_job)
        assert dataclasses.asdict(a.cluster) == dataclasses.asdict(b.cluster)
        for ha, hb in zip(a.per_job_histograms(_port(cluster).histogram),
                          b.per_job_histograms(cluster.histogram)):
            assert set(ha) == set(hb) != set()
            for ch, h in hb.items():
                np.testing.assert_array_equal(ha[ch].counts, h.counts)
                np.testing.assert_allclose(ha[ch].edges, h.edges, rtol=1e-6)


class _StepDist:
    """A registered two-segment hazard (tests/test_empirical.py's)."""

    def __init__(self, mean_value):
        self.mean_value = mean_value

    def sample(self, rng):
        return float(rng.exponential(self.mean_value))

    def hazard_segments(self):
        r = 1.0 / self.mean_value
        return (np.array([self.mean_value]), np.array([0.5 * r, 2.0 * r]))

    @property
    def mean(self):
        return self.mean_value


def test_registered_distribution_bit_identical():
    """Both registries get the same family, and lose it afterwards."""
    for dist in (t_dist, j_dist):
        base = type("StepDist", (_StepDist, dist.Distribution), {})
        dist.register_distribution("stepdist",
                                   lambda mean, _b=base, **_: _b(mean))
    try:
        ref = tiny(failure_distribution="stepdist",
                   random_failure_rate=1.0 / DAY)
        _assert_same_results(tc.simulate(_port(ref), 2),
                             jc.simulate(ref, 2))
        assert jc.resolve_engine(ref) == "ctmc"
        assert tc.resolve_engine(_port(ref)) == "ctmc"
        assert tc.resolve_engine(_port(ref), "event") == "event"
    finally:
        t_dist._REGISTRY.pop("stepdist", None)
        j_dist._REGISTRY.pop("stepdist", None)


#: tests/test_vectorized.py's configs and compared metrics
PARITY = {
    "default": (dict(job_size=64, working_pool_size=72, spare_pool_size=16,
                     warm_standbys=4, job_length=4 * DAY,
                     random_failure_rate=0.5 / DAY, seed=3),
                ["total_time", "n_failures", "n_random_failures",
                 "n_systematic_failures", "n_auto_repairs",
                 "n_manual_repairs", "n_standby_swaps", "recovery_overhead"]),
    "starved": (dict(job_size=32, working_pool_size=33, spare_pool_size=2,
                     warm_standbys=1, job_length=2 * DAY,
                     random_failure_rate=2.0 / DAY, auto_repair_time=240.0,
                     manual_repair_time=2880.0, diagnosis_probability=1.0,
                     seed=5),
                ["total_time", "n_failures", "n_preemptions",
                 "n_host_selections", "stall_time"]),
    "diagnosis": (dict(job_size=48, working_pool_size=56, spare_pool_size=8,
                       warm_standbys=4, job_length=2 * DAY,
                       random_failure_rate=1.0 / DAY,
                       diagnosis_probability=0.6, diagnosis_uncertainty=0.3,
                       seed=7),
                  ["total_time", "n_failures", "n_undiagnosed",
                   "n_misdiagnosed"]),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_ctmc_matches_event_oracle(name):
    """The port's CTMC engine (768 replicas, CPU) against the port's
    event engine (48): |z| < 3.5 for every compared metric."""
    kw, metrics = PARITY[name]
    p = TParams(**kw)
    out = tc.simulate_ctmc(p, n_replicas=768, seed=0, device="cpu")
    assert out["completed"].mean() > 0.99
    res = tc.simulate(p, 48)
    for m in metrics:
        ev = np.array([getattr(r, m) for r in res], float)
        ct = out[m]
        se = np.sqrt(ct.std() ** 2 / len(ct) + ev.std(ddof=1) ** 2 / len(ev))
        z = (ev.mean() - ct.mean()) / max(se, 1e-9)
        assert abs(z) < 3.5, (m, ev.mean(), ct.mean(), z)
