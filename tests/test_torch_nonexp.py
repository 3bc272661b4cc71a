"""The port's CTMC engine under non-exponential failure hazards.

Run parity: the CTMC engine against the port's event engine (bit for bit
the reference's, ``tests/test_torch_simulation.py``) on the configs of
``tests/test_nonexp.py`` and ``tests/test_empirical.py`` and a lognormal
on the same base, every compared mean within |z| < 3.5 on pinned seeds.
The bathtub config (about 760 failures a job) runs a 1-day job, 256 CTMC
and 16 event replicas instead of 2 days, 768 and 40, to keep its CPU time
near 8 s; the full config runs on the card (``chip_smoke.py`` phase 15).

Then the engine's own identities, exact: a one-segment ``Empirical`` runs
the exponential program bit for bit; a single-point sweep equals
``simulate_ctmc``; a pow2-bucketed sweep equals the unbucketed one on its
real rows; and a grid mixing families comes back in input order, each
point equal to its family's batch alone.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import hazards
from repro_torch.core import vectorized as tv
from repro_torch.core.params import MINUTES_PER_DAY as DAY
from repro_torch.core.params import Params

torch.set_num_threads(1)

BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=4,
            warm_standbys=2, job_length=2 * DAY,
            random_failure_rate=2.0 / DAY,
            systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
            auto_repair_time=30.0, manual_repair_time=120.0, seed=5)
WEIBULL = Params(failure_distribution="weibull",
                 distribution_kwargs={"k": 1.5}, **BASE)
WEIBULL_INFANT = Params(failure_distribution="weibull",
                        distribution_kwargs={"k": 0.8}, **BASE)
BATHTUB = Params(failure_distribution="bathtub",
                 distribution_kwargs={"infant_factor": 8.0,
                                      "infant_tau": 0.25 * DAY}, **BASE)
EMPIRICAL = Params(failure_distribution="empirical",
                   distribution_kwargs={"edges": [0.4, 2.0],
                                        "rates": [0.3, 1.5, 0.7]}, **BASE)
LOGNORMAL = Params(failure_distribution="lognormal",
                   distribution_kwargs={"sigma": 1.0}, **BASE)

#: name -> (Params, compared metrics, CTMC replicas, event replicas)
PARITY = {
    "weibull": (WEIBULL, ("total_time", "n_failures", "n_random_failures",
                          "n_systematic_failures", "n_auto_repairs",
                          "n_manual_repairs", "recovery_overhead",
                          "useful_work"), 768, 40),
    "weibull_infant": (WEIBULL_INFANT, ("total_time", "n_failures",
                                        "stall_time", "n_standby_swaps"),
                       768, 40),
    "bathtub": (BATHTUB.replace(job_length=1 * DAY),
                ("total_time", "n_failures", "n_random_failures",
                 "n_systematic_failures", "n_auto_repairs",
                 "recovery_overhead"), 256, 16),
    "empirical": (EMPIRICAL, ("total_time", "n_failures",
                              "n_random_failures", "n_systematic_failures",
                              "n_auto_repairs", "recovery_overhead"),
                  768, 40),
    "lognormal": (LOGNORMAL, ("total_time", "n_failures",
                              "n_random_failures", "n_systematic_failures",
                              "n_auto_repairs", "recovery_overhead"),
                  768, 40),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_run_parity_with_the_event_engine(name):
    p, metrics, n_ctmc, n_event = PARITY[name]
    assert tc.resolve_engine(p) == "ctmc"
    out = tv.simulate_ctmc(p, n_replicas=n_ctmc, seed=0, device="cpu")
    assert out["completed"].mean() > 0.99
    res = tc.simulate(p, n_event)
    for m in metrics:
        ev = np.array([getattr(r, m) for r in res], float)
        ct = out[m]
        se = np.sqrt(ct.std() ** 2 / len(ct) + ev.std(ddof=1) ** 2 / len(ev))
        z = (ev.mean() - ct.mean()) / max(se, 1e-9)
        assert abs(z) < 3.5, (m, ev.mean(), ct.mean(), z)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_one_segment_empirical_is_the_exponential_program():
    one = Params(**BASE, failure_distribution="empirical",
                 distribution_kwargs={"rates": [2.0]})
    plain = Params(**BASE)
    assert hazards.hazard_kind(one) == "exponential"
    assert tv.supports(one) and tc.resolve_engine(one) == "ctmc"
    np.testing.assert_array_equal(tv._params_vector(one),
                                  tv._params_vector(plain))
    kw = dict(n_replicas=64, seed=4, device="cpu")
    _assert_same(tv.simulate_ctmc(one, **kw), tv.simulate_ctmc(plain, **kw))


@pytest.mark.parametrize("p", [WEIBULL, EMPIRICAL], ids=["weibull",
                                                       "empirical"])
def test_single_point_sweep_is_simulate_ctmc(p):
    short = p.replace(job_length=0.5 * DAY)
    kw = dict(n_replicas=48, seed=2, max_steps=300, device="cpu")
    _assert_same(tv.simulate_ctmc_sweep([short], **kw)[0],
                 tv.simulate_ctmc(short, **kw))


def test_bucketed_sweep_equals_unbucketed_on_real_rows():
    grid = [LOGNORMAL.replace(job_length=0.5 * DAY, warm_standbys=w)
            for w in (0, 2, 3)]
    kw = dict(n_replicas=20, seed=8, max_steps=200, device="cpu")
    for a, b in zip(tv.simulate_ctmc_sweep(grid, bucketed=True, **kw),
                    tv.simulate_ctmc_sweep(grid, bucketed=False, **kw)):
        _assert_same(a, b)


def test_mixed_family_grid_keeps_input_order():
    short = dict(job_length=0.5 * DAY)
    grid = [WEIBULL.replace(**short), Params(**BASE).replace(**short),
            EMPIRICAL.replace(**short), WEIBULL_INFANT.replace(**short),
            BATHTUB.replace(job_length=0.1 * DAY),
            LOGNORMAL.replace(**short)]
    assert [hazards.hazard_kind(p) for p in grid] == [
        "weibull", "exponential", "empirical", "weibull", "bathtub",
        "lognormal"]
    kw = dict(n_replicas=24, seed=1, max_steps=320, device="cpu")
    mixed = tv.simulate_ctmc_sweep(grid, **kw)
    for i in (0, 2, 4, 5, 1):
        alone = [j for j, q in enumerate(grid)
                 if hazards.hazard_kind(q) == hazards.hazard_kind(grid[i])]
        own = tv.simulate_ctmc_sweep([grid[j] for j in alone], **kw)
        _assert_same(mixed[i], own[alone.index(i)])
    # the two Weibull points share one batch and keep their own shapes
    assert not np.array_equal(mixed[0]["n_failures"], mixed[3]["n_failures"])


def test_backend_runs_each_family_on_the_ctmc_engine():
    pts = [p.replace(job_length=0.25 * DAY) for p in
           (WEIBULL, BATHTUB, LOGNORMAL, EMPIRICAL)]
    reps = tc.run_replications_batch(pts, 16, device="cpu")
    assert [r.engine for r in reps] == ["ctmc"] * 4
    for r in reps:
        assert r.stats["completed"].mean == 1.0
        assert np.isfinite(r.stats["total_time"].mean)
