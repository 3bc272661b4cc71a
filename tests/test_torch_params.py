"""Contract layer of the PyTorch port against the JAX reference.

``Params`` round-trips field for field in both directions, histogram bin
layouts and percentiles match on the same counts, ``aggregate_arrays``
gives the same statistics on the same arrays, and the closed forms and
host-side hazard helpers return the same values.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import analytical as t_analytical
from repro_torch.core import hazards as t_hazards
from repro_torch.core import histograms as t_hist
from repro_torch.core import metrics as t_metrics
from repro_torch.core import vectorized as t_vec
from repro_torch.core.faultdomains import (Campaign, CampaignEvent,
                                           FaultTopology)
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core import analytical as j_analytical  # noqa: E402
from repro.core import faultdomains as j_fd  # noqa: E402
from repro.core import hazards as j_hazards  # noqa: E402
from repro.core import histograms as j_hist  # noqa: E402
from repro.core import metrics as j_metrics  # noqa: E402
from repro.core import vectorized as j_vec  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

REF_CONFIGS = [
    JParams(),
    JParams(job_size=64, working_pool_size=72, spare_pool_size=16,
            warm_standbys=4, job_length=4 * DAY,
            random_failure_rate=0.5 / DAY, seed=3),
    JParams(checkpoint_interval=60.0, checkpoint_cost=2.0,
            histogram=j_hist.HistogramSpec(low=0.01, high=1.0, n_bins=16,
                                           channels=("goodput",))),
    JParams(histogram=None, max_run_records=7, event_race_impl="ref"),
    JParams(fault_domains=j_fd.FaultTopology(n_racks=8, racks_per_pod=2,
                                             rack_shock_rate=1e-5),
            campaign=j_fd.Campaign(events=(
                j_fd.CampaignEvent(time=5.0, kind="kill", domain=1),
                j_fd.CampaignEvent(time=9.0, kind="maintenance",
                                   duration=3.0)))),
    JParams(failure_distribution="weibull", distribution_kwargs={"k": 1.5}),
]


def test_params_fields_and_defaults_match():
    tf = {f.name: f for f in dataclasses.fields(TParams)}
    jf = {f.name: f for f in dataclasses.fields(JParams)}
    assert list(tf) == list(jf)
    assert TParams().to_dict() == JParams().to_dict()


@pytest.mark.parametrize("idx", range(len(REF_CONFIGS)))
def test_params_round_trip_both_ways(idx):
    ref = REF_CONFIGS[idx]
    port = TParams.from_dict(ref.to_dict())
    assert port.to_dict() == ref.to_dict()
    back = JParams.from_dict(port.to_dict())
    assert back == ref
    assert TParams.from_dict(port.to_dict()) == port


def test_params_nested_types_are_the_ports_own():
    port = TParams.from_dict(REF_CONFIGS[4].to_dict())
    assert isinstance(port.fault_domains, FaultTopology)
    assert isinstance(port.campaign, Campaign)
    assert all(isinstance(e, CampaignEvent) for e in port.campaign.events)
    assert isinstance(port.histogram, t_hist.HistogramSpec)
    assert t_vec.faultdomains.scenario_key(port) == \
        j_fd.scenario_key(REF_CONFIGS[4])


def test_params_validate_port_impls():
    TParams(event_race_impl="cuda").validate()
    TParams(event_race_impl="ref").validate()
    with pytest.raises(ValueError, match="event_race_impl"):
        TParams(event_race_impl="pallas").validate()
    with pytest.raises(ValueError, match="working pool"):
        TParams(job_size=10, working_pool_size=5).validate()


@pytest.mark.parametrize("spec_kw", [
    {}, {"low": 1.0, "high": 100.0, "n_bins": 2},
    {"low": 0.01, "high": 1.0, "n_bins": 16, "channels": ("goodput",)}])
def test_histogram_edges_and_percentiles_match(spec_kw):
    ts = t_hist.HistogramSpec(**spec_kw)
    js = j_hist.HistogramSpec(**spec_kw)
    np.testing.assert_array_equal(ts.edges(), js.edges())
    assert ts.n_counts == js.n_counts
    rng = np.random.default_rng(1)
    counts = rng.poisson(3.0, (40, ts.n_counts)).astype(np.float64)
    counts[0] = 0.0                               # an empty row -> NaN
    for q in (25, 50, 90, 99, 99.9):
        np.testing.assert_array_equal(
            t_hist.percentiles_per_row(ts, counts, q),
            j_hist.percentiles_per_row(js, counts, q))
        th = t_hist.Histogram(ts, counts.sum(0))
        jh = j_hist.Histogram(js, counts.sum(0))
        assert th.percentile(q) == jh.percentile(q)
    assert th.mean() == jh.mean() and th.std() == jh.std()
    vals = rng.lognormal(2.0, 2.0, 500)
    np.testing.assert_array_equal(t_hist.Histogram.from_values(ts, vals)
                                  .counts,
                                  j_hist.Histogram.from_values(js, vals)
                                  .counts)


def _arrays(R=64, max_runs=6, with_hist=True):
    rng = np.random.default_rng(7)
    a = {m: rng.integers(0, 9, R).astype(np.float32) for m in t_vec._METRICS}
    a["total_time"] = rng.uniform(100, 200, R).astype(np.float32)
    a["useful_work"] = rng.uniform(50, 100, R).astype(np.float32)
    a["completed"] = (rng.uniform(size=R) > 0.1).astype(np.float32)
    a["n_runs"] = rng.integers(0, 2 * max_runs + 3, R).astype(np.int32)
    a["run_durations"] = rng.uniform(0, 30, (R, max_runs)).astype(np.float32)
    a["cur_run"] = rng.uniform(0, 5, R).astype(np.float32)
    if with_hist:
        spec = t_hist.HistogramSpec()
        for ch in ("run_duration", "recovery", "waiting"):
            a[f"hist_{ch}"] = rng.poisson(0.2, (R, spec.n_counts)) \
                .astype(np.float64)
        a["hist_edges"] = spec.edges().astype(np.float32).astype(np.float64)
    return a


@pytest.mark.parametrize("max_runs,with_hist", [(6, True), (0, False)])
def test_aggregate_arrays_matches_reference(max_runs, with_hist):
    arrays = _arrays(max_runs=max_runs, with_hist=with_hist)
    ts = t_metrics.aggregate_arrays(arrays)
    js = j_metrics.aggregate_arrays(arrays)
    assert list(ts) == list(js)
    for k in js:
        a, b = dataclasses.asdict(ts[k]), dataclasses.asdict(js[k])
        np.testing.assert_equal(a, b, err_msg=k)
    assert set(t_metrics.histograms_from_arrays(arrays)) == \
        set(j_metrics.histograms_from_arrays(arrays))


def test_stat_of_matches_reference():
    xs = np.random.default_rng(3).normal(size=50)
    assert dataclasses.asdict(t_metrics.Stat.of(xs)) == \
        dataclasses.asdict(j_metrics.Stat.of(xs))
    empty = dataclasses.asdict(t_metrics.Stat.of([]))
    assert all(math.isnan(v) for k, v in empty.items() if k != "percentiles")
    r = t_metrics.RunResult(total_time=10.0, useful_work=8.0)
    assert r.goodput == j_metrics.RunResult(total_time=10.0,
                                            useful_work=8.0).goodput


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_analytical_closed_forms_match(idx):
    ref = REF_CONFIGS[idx]
    port = TParams.from_dict(ref.to_dict())
    for name in ("cluster_failure_rate", "expected_total_time",
                 "expected_failures", "repair_shop_occupancy",
                 "spare_capacity_bound"):
        assert getattr(t_analytical, name)(port) == \
            getattr(j_analytical, name)(ref), name
    assert dataclasses.asdict(t_analytical.plan_checkpoints(port, 5.0)) == \
        dataclasses.asdict(j_analytical.plan_checkpoints(ref, 5.0))


@pytest.mark.parametrize("idx", [0, 1, 2, 3])
def test_host_hazards_and_budget_match(idx):
    ref = REF_CONFIGS[idx]
    port = TParams.from_dict(ref.to_dict())
    assert t_hazards.hazard_kind(port) == j_hazards.hazard_kind(ref)
    assert t_hazards.repair_kind(port) == j_hazards.repair_kind(ref)
    np.testing.assert_array_equal(t_hazards.hazard_columns(port),
                                  j_hazards.hazard_columns(ref))
    np.testing.assert_array_equal(t_hazards.repair_columns(port),
                                  j_hazards.repair_columns(ref))
    assert t_hazards.effective_event_rate(port) == \
        j_hazards.effective_event_rate(ref)
    assert t_hazards.phantom_steps(port) == j_hazards.phantom_steps(ref)
    assert t_vec.default_max_steps(port) == j_vec.default_max_steps(ref)
    np.testing.assert_array_equal(t_vec._params_vector(port),
                                  np.asarray(j_vec._params_vector(ref)))
    assert t_vec._struct_key(port) == j_vec._struct_key(ref)


@pytest.mark.parametrize("kw", [
    {}, {"retirement_threshold": 3}, {"repair_servers": 8},
    {"bad_set_regeneration_period": 10.0}, {"standbys_can_fail": True},
    {"failure_distribution": "deterministic"}])
def test_supports_keeps_the_reference_reasons(kw):
    """Every reference refusal stays a refusal with the same reason."""
    for reason in j_vec.unsupported_reasons(JParams(**kw)):
        assert reason in t_vec.unsupported_reasons(TParams(**kw))
    if not kw:
        assert t_vec.supports(TParams())
