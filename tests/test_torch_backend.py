"""The port's engine routing and experiment files against the reference's.

Routing table: for each Params, where the reference's ``engine="auto"``
answers ``event``, the port answers ``event`` too and runs the event
engine; where the reference answers ``ctmc``, the port answers ``ctmc`` or
would raise, naming the ROADMAP item that brings the missing part -- it
never moves such a study onto the host.  Since float64 age and replica
sharding were ported, no route raises.  ``load_experiment`` reads the
reference's yaml experiment (and the same spec as json); with
``engine: event`` its rows equal the reference's exactly.
"""

import json

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import backend as tb
from repro_torch.core import distributions as t_dist
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.core import backend as jb  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

SMALL = dict(job_size=8, working_pool_size=12, spare_pool_size=4,
             warm_standbys=1, job_length=0.5 * DAY,
             random_failure_rate=1.0 / DAY, seed=2)

#: name -> (reference Params keyword overrides, ROADMAP item the port
#: names when only its CTMC engine is short, else None)
ROUTES = {
    "exponential": ({}, None),
    "retirement": ({"retirement_threshold": 3}, None),
    "bad_set_regeneration": ({"bad_set_regeneration_period": 300.0}, None),
    "failing_standbys": ({"standbys_can_fail": True}, None),
    "repair_servers": ({"repair_servers": 2}, None),
    "deterministic_failures": ({"failure_distribution": "deterministic"},
                               None),
    "lognormal_sigma0": ({"failure_distribution": "lognormal",
                          "distribution_kwargs": {"sigma": 0.0}}, None),
    "bathtub_infant_below_1": ({"failure_distribution": "bathtub",
                                "distribution_kwargs": {
                                    "infant_factor": 0.5}}, None),
    "empirical_duplicate_edges": ({"failure_distribution": "empirical",
                                   "distribution_kwargs": {
                                       "edges": [5.0, 5.0],
                                       "rates": [1.0, 2.0, 3.0]}}, None),
    "fault_domains_weibull_repairs": ({
        "fault_domains": jc.FaultTopology(n_racks=4, rack_shock_rate=1e-4),
        "repair_distribution": "weibull"}, None),
    "campaign_lognormal_repairs": ({
        "fault_domains": jc.FaultTopology(n_racks=4),
        "campaign": jc.Campaign(events=(jc.CampaignEvent(
            time=60.0, kind="kill", domain=1),)),
        "repair_distribution": "lognormal"}, None),
    "weibull": ({"failure_distribution": "weibull",
                 "distribution_kwargs": {"k": 1.5}}, None),
    "bathtub": ({"failure_distribution": "bathtub"}, None),
    "one_segment_empirical": ({"failure_distribution": "empirical",
                               "distribution_kwargs": {"rates": [2.0]}},
                              None),
    "lognormal": ({"failure_distribution": "lognormal",
                   "distribution_kwargs": {"sigma": 1.0}}, None),
    "empirical": ({"failure_distribution": "empirical",
                   "distribution_kwargs": {"edges": [0.4, 2.0],
                                           "rates": [0.3, 1.5, 0.7]}}, None),
    "lognormal_repairs": ({"repair_distribution": "lognormal"}, None),
    "weibull_repairs": ({"failure_distribution": "weibull",
                         "repair_distribution": "weibull"}, None),
    "deterministic_repairs": ({"repair_distribution": "deterministic"},
                              None),
    "empirical_repairs": ({"repair_distribution": "empirical",
                           "distribution_kwargs": {"edges": [0.5],
                                                   "rates": [0.1, 2.0]}},
                          None),
    "one_segment_empirical_repairs": ({"repair_distribution": "empirical",
                                       "distribution_kwargs": {
                                           "rates": [2.0]}}, None),
    "age_float64": ({"age_dtype": "float64"}, None),
    "fault_domains": ({"fault_domains": jc.FaultTopology(
        n_racks=4, rack_shock_rate=1e-4)}, None),
    "campaign": ({"campaign": jc.Campaign(events=(jc.CampaignEvent(
        time=60.0, kind="maintenance", duration=30.0),))}, None),
    "engine_shards": ({"engine_shards": 2}, None),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_auto_routes_as_the_reference(name):
    """``engine="auto"`` picks the reference's engine and runs a 2-replica
    study on it, or names the ROADMAP item where only the port is short.
    ``[age_float64]`` and ``[engine_shards]`` pinned that refusal for
    float64 age and replica sharding (items 8b and 11) until both were
    ported: they now route to ``ctmc`` as the reference does and run, the
    second on two shards."""
    kw, item = ROUTES[name]
    ref = JParams(**SMALL, **kw)
    port = TParams.from_dict(ref.to_dict())
    want = jb.resolve_engine(ref, "auto")
    if item is None:
        assert tb.resolve_engine(port, "auto") == want
    else:
        assert want == "ctmc"
        with pytest.raises(ValueError, match=f"ROADMAP queue 1 {item}"):
            tb.resolve_engine(port, "auto")
        with pytest.raises(ValueError, match=f"ROADMAP queue 1 {item}"):
            tb.run_replications(port, 2, device="cpu")
        with pytest.raises(ValueError, match=f"ROADMAP queue 1 {item}"):
            tb.resolve_engine(port, "ctmc")
        assert tb.resolve_engine(port, "event") == "event"
        return
    rep = tb.run_replications(port, 2, device="cpu")
    assert rep.engine == want
    if want == "event":
        ref_rep = jb.run_replications(ref, 2)
        assert [r.to_dict() for r in rep.results] == \
            [r.to_dict() for r in ref_rep.results]
        with pytest.raises(ValueError, match="event-engine-only|fast-path|"
                                             "repair-shop|require"):
            tb.resolve_engine(port, "ctmc")
    assert tb.resolve_engine(port, "event") == "event"


@pytest.mark.parametrize("repairs", ["weibull", "lognormal"])
def test_scenario_with_nonexp_repairs_goes_to_the_event_engine(repairs):
    """Fault domains or campaigns with non-exponential repairs run on the
    event engine, for the reference's own reason, word for word."""
    ref = JParams(**SMALL, repair_distribution=repairs,
                  fault_domains=jc.FaultTopology(n_racks=4,
                                                 rack_shock_rate=1e-4))
    port = TParams.from_dict(ref.to_dict())
    from repro.core import vectorized as jv
    from repro_torch.core import vectorized as tv
    reason = ("fault domains / campaigns require exponential repairs on "
              "the fast path (a struck in-shop server would need a "
              "per-slot redraw)")
    assert tv.reference_reasons(port) == jv.unsupported_reasons(ref) \
        == [reason]
    assert tv.port_reasons(port) == []
    assert tb.resolve_engine(port, "auto") == "event" \
        == jb.resolve_engine(ref, "auto")
    with pytest.raises(ValueError, match="per-slot redraw"):
        tb.resolve_engine(port, "ctmc")


def test_registered_family_routes_by_its_instance():
    """A re-registered builtin name that no longer builds the builtin
    class goes to the event engine in both packages."""
    class NotWeibull:
        def __init__(self, mean_value):
            self.mean_value = mean_value

        def sample(self, rng):
            return float(rng.uniform(0, 2 * self.mean_value))

        @property
        def mean(self):
            return self.mean_value

    saved = (t_dist._REGISTRY["weibull"], j_dist._REGISTRY["weibull"])
    for dist in (t_dist, j_dist):
        cls = type("NotWeibull", (NotWeibull, dist.Distribution), {})
        dist.register_distribution("weibull",
                                   lambda mean, _c=cls, **_: _c(mean))
    try:
        ref = JParams(**SMALL, failure_distribution="weibull")
        port = TParams.from_dict(ref.to_dict())
        assert jb.resolve_engine(ref) == tb.resolve_engine(port) == "event"
        assert tb.run_replications(port, 2).engine == "event"
    finally:
        t_dist._REGISTRY["weibull"], j_dist._REGISTRY["weibull"] = saved
    assert tb.resolve_engine(port) == "ctmc"   # the builtin Weibull is back


def test_mixed_batch_keeps_input_order_and_progress_order():
    """CTMC points report progress up front, event points one by one;
    results come back in input order."""
    ctmc = TParams(**SMALL)
    event = ctmc.replace(retirement_threshold=3)
    seen = []
    reps = tb.run_replications_batch([event, ctmc, event, ctmc], 4,
                                     progress=seen.append, device="cpu")
    assert [r.engine for r in reps] == ["event", "ctmc", "event", "ctmc"]
    assert seen == [1, 3, 0, 2]
    ref = jb.run_replications_batch(
        [JParams.from_dict(event.to_dict())], 4)[0]
    assert [r.to_dict() for r in reps[0].results] == \
        [r.to_dict() for r in ref.results]


#: tests/test_sweeps.py's experiment file
SPEC = {
    "base_params": {"job_size": 16, "working_pool_size": 22,
                    "spare_pool_size": 4, "warm_standbys": 2,
                    "job_length": 0.25 * DAY},
    "n_replications": 2,
    "sweeps": [
        {"title": "recovery", "parameter": "recovery_time",
         "values": [10, 20]},
        {"title": "grid", "parameter_a": "recovery_time",
         "values_a": [10], "parameter_b": "warm_standbys",
         "values_b": [0, 2]},
    ],
}


def _write(tmp_path, spec, suffix):
    path = str(tmp_path / f"exp{suffix}")
    with open(path, "w") as f:
        if suffix == ".yaml":
            yaml = pytest.importorskip("yaml")
            yaml.safe_dump(spec, f)
        else:
            json.dump(spec, f)
    return path


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_load_experiment_runs_on_ctmc(tmp_path, suffix):
    sweeps = tc.load_experiment(_write(tmp_path, SPEC, suffix),
                                device="cpu")
    assert [type(s).__name__ for s in sweeps] == ["OneWaySweep",
                                                  "TwoWaySweep"]
    for sweep in sweeps:
        res = sweep.run()
        assert len(res.points) == 2
        assert {p.engine for p in res.points} == {"ctmc"}
        for row in res.to_rows():
            assert np.isfinite(row["total_time"])


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_load_experiment_event_rows_equal_reference(tmp_path, suffix):
    path = _write(tmp_path, {**SPEC, "engine": "event"}, suffix)
    port = [s.run() for s in tc.load_experiment(path)]
    ref = [s.run() for s in jc.load_experiment(path)]
    assert {p.engine for res in port for p in res.points} == {"event"}
    np.testing.assert_equal([r.to_rows() for r in port],   # nan == nan
                            [r.to_rows() for r in ref])
