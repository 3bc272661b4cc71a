"""Run parity and invariants of the port's CTMC engine, on the CPU.

Metric means of ``repro_torch`` runs agree with the JAX engine in
pooled-SE units (z < 3.5) -- the two use different random streams, so
the comparison is statistical.  Inside the port, early exit, pow2
bucketing, structure grouping and common random numbers are exact:
those comparisons are bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import backend as tb
from repro_torch.core import vectorized as tv
from repro_torch.core.faultdomains import Campaign, FaultTopology
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402
from repro.core.vectorized import simulate_ctmc as j_simulate  # noqa: E402

N = 512
PARITY = {
    "default": (JParams(job_size=64, working_pool_size=72,
                        spare_pool_size=16, warm_standbys=4,
                        job_length=4 * DAY, random_failure_rate=0.5 / DAY,
                        seed=3),
                ["total_time", "n_failures", "n_random_failures",
                 "n_systematic_failures", "n_auto_repairs",
                 "n_manual_repairs", "n_standby_swaps", "recovery_overhead"]),
    "starved": (JParams(job_size=32, working_pool_size=33, spare_pool_size=2,
                        warm_standbys=1, job_length=2 * DAY,
                        random_failure_rate=2.0 / DAY, auto_repair_time=240.0,
                        manual_repair_time=2880.0, diagnosis_probability=1.0,
                        seed=5),
                ["total_time", "n_failures", "n_preemptions",
                 "n_host_selections", "stall_time"]),
    "diagnosis": (JParams(job_size=48, working_pool_size=56,
                          spare_pool_size=8, warm_standbys=4,
                          job_length=2 * DAY, random_failure_rate=1.0 / DAY,
                          diagnosis_probability=0.6,
                          diagnosis_uncertainty=0.3, seed=7),
                  ["total_time", "n_failures", "n_undiagnosed",
                   "n_misdiagnosed"]),
}

SMALL = TParams(job_size=16, working_pool_size=20, spare_pool_size=4,
                warm_standbys=2, job_length=0.5 * DAY,
                random_failure_rate=2.0 / DAY)


def _port(p: JParams) -> TParams:
    return TParams.from_dict(p.to_dict())


@pytest.mark.parametrize("name", list(PARITY))
def test_run_parity_with_jax_engine(name):
    p, metrics = PARITY[name]
    ref = j_simulate(p, n_replicas=N, seed=0)
    out = tv.simulate_ctmc(_port(p), n_replicas=N, seed=0, device="cpu")
    assert out["completed"].mean() == 1.0
    assert set(out) == set(ref)
    for m in metrics:
        a, b = np.asarray(ref[m], np.float64), out[m].astype(np.float64)
        se = np.sqrt(a.var() / len(a) + b.var() / len(b))
        z = (a.mean() - b.mean()) / max(se, 1e-9)
        assert abs(z) < 3.5, (m, a.mean(), b.mean(), z)
    # the histogram medians agree within one bin of the default spec
    edges = out["hist_edges"]
    width = edges[1] / edges[0]
    for ch in ("run_duration", "recovery"):
        from repro_torch.core.histograms import Histogram
        med_t = Histogram(edges, out[f"hist_{ch}"].sum(0)).percentile(50)
        med_j = Histogram(np.asarray(ref["hist_edges"]),
                          np.asarray(ref[f"hist_{ch}"]).sum(0)).percentile(50)
        assert max(med_t, med_j) / min(med_t, med_j) <= width, ch


def test_zero_failures_exact():
    p = TParams(job_size=16, working_pool_size=20, spare_pool_size=2,
                warm_standbys=2, job_length=1 * DAY,
                random_failure_rate=0.0, systematic_failure_rate=0.0)
    out = tv.simulate_ctmc(p, n_replicas=8, max_steps=128, device="cpu")
    np.testing.assert_allclose(
        out["total_time"], p.host_selection_time + p.job_length, rtol=1e-5)
    assert (out["n_failures"] == 0).all()
    assert (out["useful_work"] == np.float32(p.job_length)).all()


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_early_exit_bit_identical():
    kw = dict(n_replicas=32, seed=4, max_steps=700, device="cpu")
    on = tv.simulate_ctmc(SMALL, early_exit=True, **kw)
    off = tv.simulate_ctmc(SMALL, early_exit=False, **kw)
    assert on["completed"].all()
    _equal(on, off)


def test_bucketed_sweep_bit_identical_to_unbucketed():
    grid = [SMALL, SMALL.replace(warm_standbys=0),
            SMALL.replace(job_size=12)]
    kw = dict(n_replicas=20, seed=9, max_steps=600, device="cpu")
    b = tv.simulate_ctmc_sweep(grid, bucketed=True, **kw)
    u = tv.simulate_ctmc_sweep(grid, bucketed=False, **kw)
    s = tv.simulate_ctmc_sweep(grid, padded=False, **kw)
    for x, y, z in zip(b, u, s):
        assert x["n_failures"].shape == (20,)
        _equal(x, y)
        _equal(x, z)


def test_sweep_point_matches_single_point_sweep_crn():
    """Common random numbers: one point of a 3-point sweep is the same
    run as a 1-point sweep of that point with the same seed and budget."""
    grid = [SMALL.replace(warm_standbys=w) for w in (0, 1, 2)]
    kw = dict(n_replicas=24, seed=2, max_steps=640, device="cpu")
    three = tv.simulate_ctmc_sweep(grid, **kw)
    for i in (0, 2):
        _equal(three[i], tv.simulate_ctmc_sweep([grid[i]], **kw)[0])


def test_conservation_of_servers():
    p = TParams(job_size=32, working_pool_size=40, spare_pool_size=8,
                warm_standbys=4, job_length=1 * DAY,
                random_failure_rate=2.0 / DAY, seed=9)
    state = tv._initial_state(p, 16)
    out = tv._chunk_loop(torch.as_tensor(tv._params_vector(p)), 0, 1, 16, 64,
                         4, 0, None, False, tv._hist_channels([p]), state)
    total = sum(out[k].sum(-1) for k in ("run", "sb", "auto", "man", "fw",
                                         "fs"))
    assert (total == p.working_pool_size + p.spare_pool_size).all()
    for k in ("run", "sb", "auto", "man", "fw", "fs"):
        assert (out[k] >= 0).all(), k
    assert float(out["n_failures"].sum()) > 0


def test_padding_rows_stay_inert():
    state = tv._initial_state_batch([SMALL, SMALL], 3, 4, "cpu")
    padded = tv._bucket_pad_state(state, 2, 3, 4, 4)
    phase = padded["phase"].reshape(4, 4)
    assert (phase[:2, :3] == tv.COMPUTE).all()
    assert (phase[2:] == tv.DONE).all() and (phase[:, 3] == tv.DONE).all()
    assert float(padded["run"].reshape(4, 4, 4)[2:].abs().sum()) == 0.0


@pytest.mark.parametrize("kw", [
    {"fault_domains": FaultTopology(n_racks=8, rack_shock_rate=1e-5),
     "engine_shards": 2},
    {"campaign": Campaign(events=({"time": 10.0, "kind": "maintenance",
                                   "duration": 5.0},)),
     "age_dtype": "float64"},
    {"engine_shards": 2}, {"age_dtype": "float64"}])
def test_unported_params_refused(kw):
    """These Params pinned the port's refusals of replica sharding and
    float64 age (ROADMAP items 11 and 8b), alone and with fault domains or
    a campaign, until both were ported: the port's CTMC engine now takes
    them, ``auto`` routes them to it, and a 4-replica CPU run completes,
    with its age lane in the requested dtype."""
    p = SMALL.replace(**kw)
    assert tv.supports(p) and tv.unsupported_reasons(p) == []
    assert tb.resolve_engine(p, "auto") == "ctmc"
    out = tv.simulate_ctmc(p, n_replicas=4, device="cpu")
    assert out["completed"].all() and out["n_failures"].sum() > 0
    state = tv._initial_state(p, 4)
    assert state["age"].dtype == tv._age_dtype(p) == (
        torch.float64 if p.age_dtype == "float64" else torch.float32)


def test_fault_domains_refused():
    """Fault domains run on the port's CTMC engine (ROADMAP queue 1 item 9
    is done): a rack-shock sweep completes, and its counters agree."""
    p = SMALL.replace(fault_domains=FaultTopology(n_racks=8,
                                                  rack_shock_rate=1e-3))
    assert tv.supports(p) and tb.resolve_engine(p, "auto") == "ctmc"
    out = tv.simulate_ctmc_sweep([p, p.replace(fault_domains=FaultTopology(
        n_racks=8))], n_replicas=16, device="cpu")
    assert all(o["completed"].all() for o in out)
    shocked, calm = out
    assert shocked["n_domain_shocks"].sum() > 0
    assert shocked["n_shock_killed"].sum() >= shocked["n_domain_shocks"].sum()
    np.testing.assert_array_equal(shocked["domain_shocks"].sum(1),
                                  shocked["n_domain_shocks"])
    assert shocked["domain_shocks"].shape == (16, 8)
    assert calm["n_domain_shocks"].sum() == calm["n_shock_killed"].sum() == 0
    assert (shocked["n_campaign_events"] == 0).all()


def test_engine_dispatch_refuses_loudly():
    assert tb.resolve_engine(TParams(), "auto") == "ctmc"
    assert tb.resolve_engine(TParams(), "ctmc") == "ctmc"
    assert tb.resolve_engine(TParams(), "event") == "event"
    with pytest.raises(ValueError, match="unknown engine"):
        tb.resolve_engine(TParams(), "gpu")
    with pytest.raises(ValueError, match="event-engine-only"):
        tb.run_replications(SMALL.replace(retirement_threshold=2), 4,
                            engine="ctmc", device="cpu")
    # the reference's CTMC engine refuses retirement too: auto runs the
    # event engine, as the reference's auto does
    rep = tb.run_replications(SMALL.replace(retirement_threshold=2), 4,
                              device="cpu")
    assert rep.engine == "event" and len(rep.results) == 4


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tv.simulate_ctmc(SMALL, n_replicas=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.run_replications_batch([SMALL], 4)


def test_cuda_impl_on_cpu_raises():
    with pytest.raises(ValueError, match="impl='cuda'"):
        tv.simulate_ctmc(SMALL, n_replicas=4, impl="cuda", device="cpu")


def test_run_replications_stats_and_truncation_warning():
    rep = tb.run_replications(SMALL, 16, base_seed=1, device="cpu")
    assert rep.engine == "ctmc" and rep.n == 16
    assert rep.stats["completed"].mean == 1.0
    assert set(rep.histograms) == {"run_duration", "recovery", "waiting"}
    with pytest.warns(RuntimeWarning, match="step budget"):
        cut = tb.run_replications(SMALL, 16, max_steps=8, device="cpu")
    assert cut.stats["n_incomplete"].mean > 0


def test_max_runs_zero_keeps_mean_run_duration_exact():
    kw = dict(n_replicas=16, seed=5, device="cpu")
    full = tv.simulate_ctmc(SMALL, **kw)
    none = tv.simulate_ctmc(SMALL, max_runs=0, **kw)
    assert none["run_durations"].shape == (16, 0)
    for k in ("total_time", "n_runs", "cur_run", "useful_work"):
        np.testing.assert_array_equal(full[k], none[k])
