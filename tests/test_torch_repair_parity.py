"""The port's CTMC engine under non-exponential repairs.

Run parity: the CTMC engine (the repair-slot lane) against the port's
event engine (bit for bit the reference's, tests/test_torch_simulation.py)
on the configs of tests/test_repair_dist.py and tests/test_empirical.py,
768 CTMC and 40 event replicas, every compared mean within |z| < 3.5 on
pinned seeds and no slot-lane overflow; the stall-bound recovery
histogram within one bin; Weibull k = 1 repairs against the exponential
repair program.  Then the engine's contracts, exact: a repair in flight
when the job completes is dropped and one that ends exactly at
``total_time`` counts (tests/test_repair_dist.py:274-350); a full slot lane
is counted and warned about; a one-segment ``Empirical`` repair runs the
exponential program bit for bit; a single-point sweep equals
``simulate_ctmc``; a bucketed sweep equals the unbucketed one on its real
rows; a grid mixing repair families comes back in input order.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import hazards
from repro_torch.core import vectorized as tv
from repro_torch.core.metrics import (histograms_from_arrays,
                                      histograms_from_results)
from repro_torch.core.params import MINUTES_PER_DAY as DAY
from repro_torch.core.params import Params

torch.set_num_threads(1)

BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=4,
            warm_standbys=2, job_length=2 * DAY,
            random_failure_rate=2.0 / DAY,
            systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
            auto_repair_time=30.0, manual_repair_time=120.0, seed=5)
WB_REPAIR = Params(repair_distribution="weibull",
                   distribution_kwargs={"k": 0.7}, **BASE)
LN_REPAIR = Params(repair_distribution="lognormal",
                   distribution_kwargs={"sigma": 1.2}, **BASE)
DET_REPAIR = Params(repair_distribution="deterministic", **BASE)
COMBINED = Params(failure_distribution="lognormal",
                  repair_distribution="weibull",
                  distribution_kwargs={"k": 0.7, "sigma": 1.0}, **BASE)
EMP_REPAIR = Params(repair_distribution="empirical",
                    distribution_kwargs={"edges": [0.5],
                                         "rates": [0.1, 2.0]}, **BASE)

#: name -> (Params, compared metrics), as tests/test_repair_dist.py and
#: tests/test_empirical.py compare them
PARITY = {
    "weibull": (WB_REPAIR, ("total_time", "n_failures", "n_auto_repairs",
                            "n_manual_repairs", "n_failed_repairs",
                            "recovery_overhead", "n_standby_swaps",
                            "useful_work")),
    "lognormal": (LN_REPAIR, ("total_time", "n_failures", "n_auto_repairs",
                              "n_manual_repairs", "recovery_overhead")),
    "deterministic": (DET_REPAIR, ("total_time", "n_failures",
                                   "n_auto_repairs", "n_manual_repairs",
                                   "n_failed_repairs")),
    "combined": (COMBINED, ("total_time", "n_failures", "n_auto_repairs",
                            "n_manual_repairs", "recovery_overhead")),
    "empirical": (EMP_REPAIR, ("total_time", "n_failures", "n_auto_repairs",
                               "n_manual_repairs", "recovery_overhead")),
}


def _z(ct, ev):
    se = np.sqrt(ct.std() ** 2 / len(ct) + ev.std(ddof=1) ** 2 / len(ev))
    return (ev.mean() - ct.mean()) / max(se, 1e-9)


@pytest.mark.parametrize("name", list(PARITY))
def test_run_parity_with_the_event_engine(name):
    p, metrics = PARITY[name]
    assert tc.resolve_engine(p) == "ctmc"
    out = tv.simulate_ctmc(p, n_replicas=768, seed=0, device="cpu")
    assert out["completed"].mean() > 0.99
    assert out["n_repair_overflow"].sum() == 0
    res = tc.simulate(p, 40)
    for m in metrics:
        z = _z(out[m], np.array([getattr(r, m) for r in res], float))
        assert abs(z) < 3.5, (m, z)


def test_stall_bound_recovery_histogram_within_one_bin():
    """Starved pools: every failure stalls until its own repair returns,
    so the recovery histogram is the repair duration's distribution."""
    p = Params(job_size=8, working_pool_size=9, spare_pool_size=0,
               warm_standbys=0, job_length=1 * DAY,
               random_failure_rate=4.0 / DAY,
               systematic_failure_rate=8.0 / DAY, recovery_time=5.0,
               auto_repair_time=45.0, manual_repair_time=180.0,
               diagnosis_probability=1.0, repair_distribution="weibull",
               distribution_kwargs={"k": 0.7}, seed=11)
    out = tv.simulate_ctmc(p, n_replicas=512, seed=2, device="cpu")
    assert out["stall_time"].mean() > 0
    hc = histograms_from_arrays(out)
    he = histograms_from_results(tc.simulate(p, 64), p.histogram)
    for ch in ("recovery", "run_duration"):
        assert np.abs(hc[ch].cdf() - he[ch].cdf()).max() < 0.08, ch
    hrec, erec = hc["recovery"], he["recovery"]
    assert hrec.total > 500 and erec.total > 500
    for q in (50, 90, 99):
        est, emp = hrec.percentile(q), erec.percentile(q)
        assert abs(est - emp) <= hrec.bin_width_at(emp), (q, est, emp)


def test_weibull_k1_repairs_reduce_to_exponential():
    pw = WB_REPAIR.replace(distribution_kwargs={"k": 1.0})
    exp_out = tv.simulate_ctmc(Params(**BASE), n_replicas=768, seed=0,
                               device="cpu")
    wb_out = tv.simulate_ctmc(pw, n_replicas=768, seed=1, device="cpu")
    for m in ("total_time", "n_failures", "n_auto_repairs",
              "n_manual_repairs", "recovery_overhead"):
        assert abs(_z(exp_out[m], wb_out[m])) < 3.5, m


# ---------------------------------------------------------------------------
# truncated horizons
# ---------------------------------------------------------------------------

def test_repairs_in_flight_at_completion_dropped_on_both_engines():
    """A repair unfinished when the job completes counts on neither
    engine; the pool is large enough that the job never stalls."""
    p = Params(job_size=4, working_pool_size=40, spare_pool_size=0,
               warm_standbys=8, job_length=0.5 * DAY,
               random_failure_rate=2.0 / DAY, systematic_failure_rate=0.0,
               recovery_time=2.0, diagnosis_probability=1.0,
               repair_distribution="deterministic",
               auto_repair_time=10 * DAY, manual_repair_time=10 * DAY,
               seed=7)
    out = tv.simulate_ctmc(p, n_replicas=256, seed=0, device="cpu")
    res = tc.simulate(p, 64)
    assert out["n_failures"].mean() > 0.3
    assert out["n_auto_repairs"].max() == 0
    assert max(r.n_auto_repairs for r in res) == 0
    assert any(r.n_failures > 0 for r in res)


def test_repair_completing_exactly_at_total_time_counts():
    """An exact tie of the slot residual with the job's completion: the
    repair resolves first and the job completes at the same instant on
    the next step, as the event engine's heap orders them."""
    p = Params(job_size=4, working_pool_size=8, spare_pool_size=0,
               warm_standbys=0, job_length=100.0, host_selection_time=0.0,
               random_failure_rate=0.0, systematic_failure_rate=0.0,
               auto_repair_failure_probability=0.0,
               repair_distribution="deterministic", auto_repair_time=100.0,
               seed=0)
    state = tv._initial_state(p, 1, device="cpu")
    state["repair_rem"][0, 0] = 100.0
    state["repair_cls"][0, 0] = 1
    pv = torch.as_tensor(tv._params_vector(p))
    u = torch.full((1, tv._n_uniforms("exponential", "deterministic")), 0.5)
    step = dict(hist_channels=tv._hist_channels([p]),
                rkind="deterministic")
    s1 = tv._step_u(state, u, pv, **step)
    assert float(s1["n_auto_repairs"][0]) == 1.0
    assert int(s1["phase"][0]) != tv.DONE
    assert float(s1["work_left"][0]) == 0.0
    assert bool(torch.isinf(s1["repair_rem"]).all())
    t_tie = float(s1["t"][0])
    s2 = tv._step_u(s1, u, pv, **step)
    assert int(s2["phase"][0]) == tv.DONE
    assert float(s2["total_time"][0]) == t_tie
    assert float(s2["n_auto_repairs"][0]) == 1.0
    edges = s2["hist_edges"].numpy()
    want_bin = int(np.searchsorted(edges, 100.0, side="right"))
    assert float(s2["hist"][0, 0, want_bin]) >= 1.0


def test_repair_slot_overflow_is_surfaced():
    p = Params(job_size=8, working_pool_size=16, spare_pool_size=0,
               warm_standbys=4, job_length=0.5 * DAY,
               random_failure_rate=8.0 / DAY, recovery_time=2.0,
               diagnosis_probability=1.0,
               repair_distribution="deterministic",
               auto_repair_time=5 * DAY, manual_repair_time=5 * DAY,
               repair_slots=1, seed=3)
    assert tv._repair_slots_for([p], "deterministic") == 1
    with pytest.warns(RuntimeWarning, match="repair-slot lane"):
        rep = tc.run_replications(p, 64, engine="ctmc", device="cpu")
    assert rep.stats["n_repair_overflow"].mean > 0


# ---------------------------------------------------------------------------
# identities
# ---------------------------------------------------------------------------

def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_one_segment_empirical_repairs_are_the_exponential_program():
    one = Params(**BASE, repair_distribution="empirical",
                 distribution_kwargs={"rates": [2.0]})
    plain = Params(**BASE)
    assert hazards.repair_kind(one) == "exponential"
    assert tv.supports(one) and tc.resolve_engine(one) == "ctmc"
    np.testing.assert_array_equal(tv._params_vector(one),
                                  tv._params_vector(plain))
    assert "repair_rem" not in tv._initial_state(one, 2)
    kw = dict(n_replicas=64, seed=4, device="cpu")
    _assert_same(tv.simulate_ctmc(one, **kw), tv.simulate_ctmc(plain, **kw))


@pytest.mark.parametrize("p", [WB_REPAIR, COMBINED, EMP_REPAIR],
                         ids=["weibull", "combined", "empirical"])
def test_single_point_sweep_is_simulate_ctmc(p):
    short = p.replace(job_length=0.5 * DAY)
    kw = dict(n_replicas=21, seed=9, max_steps=300, device="cpu")
    _assert_same(tv.simulate_ctmc_sweep([short], **kw)[0],
                 tv.simulate_ctmc(short, **kw))


def test_bucketed_sweep_equals_unbucketed_on_real_rows():
    grid = [LN_REPAIR.replace(job_length=0.5 * DAY, auto_repair_time=v)
            for v in (20.0, 40.0, 60.0)]
    kw = dict(n_replicas=20, seed=8, max_steps=200, device="cpu")
    for a, b in zip(tv.simulate_ctmc_sweep(grid, bucketed=True, **kw),
                    tv.simulate_ctmc_sweep(grid, bucketed=False, **kw)):
        _assert_same(a, b)


def test_mixed_repair_family_grid_keeps_input_order():
    short = dict(job_length=0.25 * DAY)
    grid = [Params(**BASE).replace(**short), WB_REPAIR.replace(**short),
            COMBINED.replace(**short), DET_REPAIR.replace(**short),
            WB_REPAIR.replace(auto_repair_time=60.0, **short)]
    kw = dict(n_replicas=24, seed=1, max_steps=256, device="cpu")
    mixed = tv.simulate_ctmc_sweep(grid, **kw)
    for i in range(len(grid)):
        key = (hazards.hazard_kind(grid[i]), hazards.repair_kind(grid[i]))
        alone = [j for j, q in enumerate(grid)
                 if (hazards.hazard_kind(q), hazards.repair_kind(q)) == key]
        own = tv.simulate_ctmc_sweep([grid[j] for j in alone], **kw)
        _assert_same(mixed[i], own[alone.index(i)])
    assert not np.array_equal(mixed[1]["total_time"],
                              mixed[4]["total_time"])


def test_sweep_engine_auto_takes_the_ctmc_engine():
    sweep = tc.OneWaySweep("rp", "auto_repair_time", [20.0, 60.0],
                           n_replications=16, base_params=WB_REPAIR.replace(
                               job_length=0.25 * DAY), engine="auto",
                           device="cpu")
    res = sweep.run()
    assert [pt.engine for pt in res.points] == ["ctmc", "ctmc"]
    assert all(pt.stats["completed"].mean == 1.0 for pt in res.points)
