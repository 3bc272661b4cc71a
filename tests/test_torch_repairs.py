"""The port's non-exponential repairs against the reference's.

Repair quantiles (the samplers' inverse CDFs drawn at slot entry) against
their JAX twins on seeded numpy uniforms in ``[1e-12, 1)``: rtol 1e-6
(deterministic exactly).

Host columns, segment counts, occupancy estimates and slot widths must
equal the reference's (``==``) on the configs of tests/test_repair_dist.py
and tests/test_empirical.py.  Then ``_step_u`` in lockstep with the
reference's for 200 steps per repair family and for lognormal failures
with Weibull repairs, each step from the reference's state: integer lanes,
``repair_cls`` and ``repair_stage`` identical on every row-step (COMBINED's
lognormal accept may flip within an ulp, on at most 0.2% of row-steps as
in tests/test_torch_hazards.py), float lanes within 1e-6 of their scale.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import hazards as th
from repro_torch.core import vectorized as tv
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import hazards as jh  # noqa: E402
from repro.core import vectorized as jv  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

F32 = np.float32

#: tests/test_repair_dist.py's base (and tests/test_empirical.py's)
BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=4,
            warm_standbys=2, job_length=2 * DAY,
            random_failure_rate=2.0 / DAY,
            systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
            auto_repair_time=30.0, manual_repair_time=120.0, seed=5)
#: name -> reference Params keyword overrides: tests/test_repair_dist.py:
#: 48-62, tests/test_empirical.py:61 and the edges of the slot sizing
CONFIGS = {
    "weibull": dict(repair_distribution="weibull",
                    distribution_kwargs={"k": 0.7}),
    "lognormal": dict(repair_distribution="lognormal",
                      distribution_kwargs={"sigma": 1.2}),
    "deterministic": dict(repair_distribution="deterministic"),
    "combined": dict(failure_distribution="lognormal",
                     repair_distribution="weibull",
                     distribution_kwargs={"k": 0.7, "sigma": 1.0}),
    "empirical": dict(repair_distribution="empirical",
                      distribution_kwargs={"edges": [0.5],
                                           "rates": [0.1, 2.0]}),
    "empirical_one_segment": dict(repair_distribution="empirical",
                                  distribution_kwargs={"rates": [2.0]}),
    "weibull_k1": dict(repair_distribution="weibull",
                       distribution_kwargs={"k": 1.0}),
    "weibull_infinite_manual": dict(repair_distribution="weibull",
                                    distribution_kwargs={"k": 0.7},
                                    manual_repair_time=float("inf")),
    "weibull_nan_regime": dict(repair_distribution="weibull",
                               distribution_kwargs={"k": 0.7},
                               manual_repair_time=float("inf"),
                               automated_repair_probability=1.0),
    "weibull_failures_weibull_repairs": dict(
        failure_distribution="weibull", repair_distribution="weibull",
        distribution_kwargs={"k": 1.5}),
    "deterministic_slots_1": dict(repair_distribution="deterministic",
                                  repair_slots=1),
    "lognormal_slots_override": dict(repair_distribution="lognormal",
                                     distribution_kwargs={"sigma": 1.2},
                                     repair_slots=5),
    "weibull_k_negative": dict(repair_distribution="weibull",
                               distribution_kwargs={"k": -1.0}),
    "table_i_weibull": dict(repair_distribution="weibull",
                            distribution_kwargs={"k": 0.7}),
}
#: configs that keep Table I's pools (the rest take BASE's 36 servers)
TABLE_I = ("table_i_weibull",)


def _ref(name):
    kw = CONFIGS[name]
    return JParams(**kw) if name in TABLE_I else JParams(**{**BASE, **kw})


def _t(x):
    return torch.as_tensor(np.asarray(x, F32))


def _j(x):
    return jnp.asarray(np.asarray(x, F32))


# ---------------------------------------------------------------------------
# quantiles against the JAX samplers
# ---------------------------------------------------------------------------

def _uniforms(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-12, 1.0, n).astype(F32)
    # the ends of the range the step's draws span
    return np.concatenate([u, [1e-12, 1e-6, 0.5, np.nextafter(F32(1), 0)]]) \
        .astype(F32)


@pytest.mark.parametrize("shape", [0.5, 0.7, 1.0, 1.5, 3.0])
@pytest.mark.parametrize("scale", [0.0, 30.0, 2880.0])
def test_weibull_quantile(shape, scale):
    u = _uniforms(seed=int(shape * 10))
    want = np.asarray(jh.REPAIR_SAMPLERS["weibull"].quantile(
        _j(u), F32(scale), F32(shape)))
    got = th.REPAIR_SAMPLERS["weibull"].quantile(_t(u), _t(scale),
                                                 _t(shape)).numpy()
    assert got.dtype == np.float32
    if scale == 0.0:
        assert np.isposinf(got).all() and np.isposinf(want).all()
        return
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("sigma", [0.4, 1.0, 1.2])
@pytest.mark.parametrize("scale", [0.0, 15.0, 500.0])
def test_lognormal_quantile(sigma, scale):
    u = _uniforms(seed=int(sigma * 10) + 1)
    want = np.asarray(jh.REPAIR_SAMPLERS["lognormal"].quantile(
        _j(u), F32(scale), F32(sigma)))
    got = th.REPAIR_SAMPLERS["lognormal"].quantile(_t(u), _t(scale),
                                                   _t(sigma)).numpy()
    if scale == 0.0:
        assert np.isposinf(got).all() and np.isposinf(want).all()
        return
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 30.0, 120.0])
def test_deterministic_quantile(scale):
    u = _uniforms()
    want = np.asarray(jh.REPAIR_SAMPLERS["deterministic"].quantile(
        _j(u), F32(scale), F32(0.0)))
    got = th.REPAIR_SAMPLERS["deterministic"].quantile(
        _t(u), _t(scale), _t(0.0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == F32(scale)).all()


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("name", ["empirical", "disabled"])
def test_empirical_quantile(name, per_row):
    u = _uniforms(seed=7)
    edges = np.array([15.0], F32)
    rates = np.array([0.1, 2.0], F32) / 30.0
    if name == "disabled":
        edges, rates = np.array([1.0], F32), np.zeros(2, F32)
    if per_row:
        scale = np.random.default_rng(2).uniform(0.5, 2.0, (u.size, 1))
        edges = (edges[None, :] * scale).astype(F32)
        rates = (rates[None, :] / scale).astype(F32)
    want = np.asarray(jh.REPAIR_SAMPLERS["empirical"].quantile(
        _j(u), _j(edges), _j(rates)))
    got = th.REPAIR_SAMPLERS["empirical"].quantile(_t(u), _t(edges),
                                                   _t(rates)).numpy()
    if name == "disabled":
        assert np.isposinf(got).all() and np.isposinf(want).all()
        return
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_repair_samplers_are_the_references():
    assert th.REPAIR_KINDS == jh.REPAIR_KINDS
    assert set(th.REPAIR_SAMPLERS) == set(jh.REPAIR_SAMPLERS) \
        == set(th.REPAIR_KINDS[1:])
    with pytest.raises(NotImplementedError):
        th.FAILURE_SAMPLERS["bathtub"].quantile(_t([0.5]), _t(1.0), _t(1.0))


# ---------------------------------------------------------------------------
# host columns, occupancy and slot widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_columns_and_slot_widths_equal_the_reference(name):
    ref = _ref(name)
    port = TParams.from_dict(ref.to_dict())
    rkind = jh.repair_kind(ref)
    assert th.repair_kind(port) == rkind
    assert th.repair_segment_count(port) == jh.repair_segment_count(ref)
    cols = th.repair_columns(port)
    assert cols.dtype == np.float32
    np.testing.assert_array_equal(cols, jh.repair_columns(ref))
    occ_t, occ_j = (th.expected_repair_occupancy(port),
                    jh.expected_repair_occupancy(ref))
    assert occ_t == occ_j or (np.isnan(occ_t) and np.isnan(occ_j))
    np.testing.assert_array_equal(tv._params_vector(port),
                                  np.asarray(jv._params_vector(ref)))
    assert tv.default_max_steps(port) == jv.default_max_steps(ref)
    if rkind is None:
        assert not tv.supports(port) and not jv.supports(ref)
        return
    assert tv.supports(port)
    kind = jh.hazard_kind(ref)
    assert tv._n_uniforms(kind, rkind) == jv._n_uniforms(kind, rkind)
    assert cols.size == th.repair_col_count(rkind,
                                            th.repair_segment_count(port))
    assert tv._repair_slots_for([port], rkind) \
        == jv._repair_slots_for([ref], rkind)
    state = tv._initial_state(port, 3, device="cpu")
    jstate = jv._initial_state(ref, 3)
    assert list(state) == list(jstate)
    for k, v in jstate.items():
        assert state[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_slot_widths_of_the_sizing_edges():
    """A grid's width is its widest point's; an infinite-mean stage takes
    the physical cap, 36 servers, a width that is not a power of two;
    Table I's 4,360 servers take 128 slots."""
    pts = {n: TParams.from_dict(_ref(n).to_dict()) for n in CONFIGS}
    width = functools.partial(tv._repair_slots_for, rkind="weibull")
    assert width([pts["weibull"]]) == 32
    assert width([pts["table_i_weibull"]]) == 128
    assert width([pts["weibull_infinite_manual"]]) == 36
    assert width([pts["weibull_nan_regime"]]) == 36
    assert width([pts["lognormal_slots_override"]]) == 8
    assert width([pts["deterministic_slots_1"]]) == 1
    assert width([pts["deterministic_slots_1"], pts["weibull"]]) == 32
    assert width([pts["weibull"], pts["weibull_infinite_manual"]]) == 36
    assert tv._repair_slots_for([pts["weibull"]], "exponential") == 0


# ---------------------------------------------------------------------------
# the step in lockstep with the reference
# ---------------------------------------------------------------------------

R = 128
STEP_FAMILIES = ("weibull", "lognormal", "deterministic", "empirical",
                 "combined")
_EXACT = ("phase", "n_runs", "n_failures", "n_random_failures",
          "n_systematic_failures", "n_preemptions", "n_auto_repairs",
          "n_manual_repairs", "n_failed_repairs", "n_host_selections",
          "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed",
          "n_repair_overflow", "run", "sb", "fw", "fs", "auto", "man",
          "hist", "repair_cls", "repair_stage")


@functools.lru_cache(maxsize=None)
def _jax_step(kind, rkind, n_seg, n_rseg, channels):
    return jax.jit(functools.partial(
        jv._step_u, impl="ref", kind=kind, rkind=rkind,
        hist_channels=channels, n_seg=n_seg, n_rseg=n_rseg))


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_step_lockstep_matches_reference(name):
    """200 steps, each from the reference's state, on the same numpy
    uniforms (9 or 10 lanes).  The shop is kept busy: the slot lane
    fills and drains many times over the run."""
    ref = _ref(name)
    kind, rkind = jh.hazard_kind(ref), jh.repair_kind(ref)
    n_seg, n_rseg = jh.hazard_segment_count(ref), jh.repair_segment_count(ref)
    channels = jv._hist_channels([ref])
    step = _jax_step(kind, rkind, n_seg, n_rseg, channels)
    js = jv._initial_state(ref, R, None)
    assert "repair_rem" in js
    pv = jv._params_vector(ref)
    tpv = torch.as_tensor(tv._params_vector(TParams.from_dict(ref.to_dict())))
    n_u = jv._n_uniforms(kind, rkind)
    rng = np.random.default_rng(13)
    flips = 0
    for _ in range(200):
        u = rng.uniform(1e-12, 1.0, (R, n_u)).astype(F32)
        before = {k: np.asarray(v) for k, v in js.items()}
        j_out = step(js, jnp.asarray(u), pv)
        t_out = tv._step_u(tv.state_from_numpy(before, "cpu"),
                           torch.as_tensor(u), tpv, None, channels, kind,
                           n_seg, rkind, n_rseg)
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
            assert np.array_equal(np.isinf(a[same]), np.isinf(b[same])), k
            prev = before[k].astype(np.float64)
            prev = prev[np.isfinite(prev)]
            scale = float(np.abs(prev).max()) if prev.size else 0.0
            fin = np.isfinite(a[same])
            np.testing.assert_allclose(b[same][fin], a[same][fin],
                                       rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)
        js = j_out
    if kind == "lognormal":
        assert flips <= 0.002 * 200 * R, flips
    else:
        assert flips == 0, flips
    final = {k: np.asarray(v) for k, v in js.items()}
    assert final["n_auto_repairs"].sum() > 0
    assert final["n_manual_repairs"].sum() > 0
    assert np.isfinite(final["repair_rem"]).any()
    assert (final["repair_stage"] == 1).any()
