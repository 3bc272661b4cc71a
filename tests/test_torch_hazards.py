"""The port's failure-hazard math and host columns against the reference's.

Torch hazard functions against their JAX twins on the same numpy inputs,
with these tolerances:

* bathtub shape, piecewise hazards and windows: rtol 1e-6 (the shape
  takes one ``exp``; the piecewise ones only select and subtract, and
  agree exactly);
* Weibull inversion ``(a**k + E/C)**(1/k) - a``: 4e-7 of ``a + s``, a few
  float32 ulps of the larger term, as the subtraction cancels at large
  ages (ages up to 1e4 here);
* lognormal hazard: 2e-4 relative plus 1e-37 absolute.  At ``|z|`` up to
  30 ``log h`` is the difference of two terms near ``z**2 / 2`` (~450),
  each exact only to a few ulps of that size, and where ``h`` underflows
  one package may give 0 and the other a subnormal.

Host columns, segment counts, step budgets and parameter rows must equal
the reference's (``==``) on a table of Params, degenerate ones included.
Then ``_step_u`` in lockstep with the reference's ``_step_u(kind=...)``
for 200 steps on the same state and 9-lane numpy uniforms, per family.
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

from repro.core import distributions as j_dist  # noqa: E402
from repro.core import hazards as jh  # noqa: E402
from repro.core import vectorized as jv  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402

F32 = np.float32


def _t(x):
    return torch.as_tensor(np.asarray(x, F32))


def _j(x):
    return jnp.asarray(np.asarray(x, F32))


# ---------------------------------------------------------------------------
# torch hazard functions against the JAX twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [(8.0, 360.0, 1000.0, 2000.0),
                                  (1.0, 10.0, 0.0, 1.0),
                                  (3.0, 0.25 * DAY, 5.0 * DAY, 30.0 * DAY)])
def test_bathtub_shape(cols):
    t = np.linspace(0.0, 2e4, 801).astype(F32)
    want = np.asarray(jh.bathtub_shape(_j(t), *map(F32, cols)))
    got = th.bathtub_shape(_t(t), *map(_t, cols)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got >= 1.0).all()


@pytest.mark.parametrize("k", [0.5, 0.8, 1.0, 1.5, 3.0])
@pytest.mark.parametrize("C", [0.0, 1e-9, 1e-6, 3e-3])
def test_weibull_conditional_ttf(k, C):
    rng = np.random.default_rng(int(k * 10) + 7)
    ages = np.concatenate([[0.0], np.logspace(-3, 4, 300)]).astype(F32)
    E = rng.exponential(size=ages.size).astype(F32)
    want = np.asarray(jh.weibull_conditional_ttf(_j(ages), F32(C), F32(k),
                                                 _j(E)))
    got = th.weibull_conditional_ttf(_t(ages), _t(C), _t(k), _t(E)).numpy()
    assert got.dtype == np.float32
    if C == 0.0:
        assert np.isinf(got).all() and np.isinf(want).all()
        return
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 4e-7 * (ages + np.abs(want)) + 1e-30)


@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("scale", [0.0, 7.0, 500.0])
def test_lognormal_hazard_deep_tail(sigma, scale):
    z = np.linspace(-30.0, 30.0, 1201)
    t = (max(scale, 1.0) * np.exp(sigma * z)).astype(F32)
    want = np.asarray(jh.lognormal_hazard(_j(t), F32(scale), F32(sigma)))
    got = th.lognormal_hazard(_t(t), _t(scale), _t(sigma)).numpy()
    assert np.isfinite(got).all()
    if scale == 0.0:
        assert (got == 0).all() and (want == 0).all()
        return
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-37)
    assert (got > 0).sum() > 500


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
def test_lognormal_window_majorant(sigma):
    rng = np.random.default_rng(3)
    scale, mode = F32(900.0), F32(jh._lognormal_mode_rel(sigma))
    age = rng.uniform(0, 5000, 400).astype(F32)
    win = F32(0.25 * mode * scale)
    want = np.asarray(jh.lognormal_window_majorant(_j(age), win, scale,
                                                   F32(sigma), mode))
    got = th.lognormal_window_majorant(_t(age), _t(win), _t(scale),
                                       _t(sigma), _t(mode)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-37)
    # a majorant bounds the hazard over its window
    for frac in (0.0, 0.3, 0.7, 1.0):
        h = th.lognormal_hazard(_t(age + frac * win), _t(scale),
                                _t(sigma)).numpy()
        assert (h <= got * (1 + 1e-5)).all()


def _segments(per_row):
    rng = np.random.default_rng(5)
    edges = np.array([0.4, 2.0, 9.0], F32) * 300.0
    rates = np.array([0.3, 1.5, 0.7, 0.2], F32) / 300.0
    t = np.concatenate([rng.uniform(0, 4000, 300), edges,
                        np.nextafter(edges, F32(0)), [0.0]]).astype(F32)
    if per_row:
        scale = rng.uniform(0.5, 2.0, (t.size, 1)).astype(F32)
        edges, rates = edges[None, :] * scale, rates[None, :] / scale
    return t, edges, rates


@pytest.mark.parametrize("per_row", [False, True])
def test_piecewise_functions(per_row):
    t, e, r = _segments(per_row)
    for name in ("piecewise_hazard",):
        want = np.asarray(getattr(jh, name)(_j(t), _j(e), _j(r)))
        got = getattr(th, name)(_t(t), _t(e), _t(r)).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jh.piecewise_next_edge(_j(t), _j(e)))
    got = th.piecewise_next_edge(_t(t), _t(e)).numpy()
    np.testing.assert_array_equal(got, want)
    win = np.full(t.shape, F32(500.0))
    want = np.asarray(jh.piecewise_window_majorant(_j(t), _j(win), _j(e),
                                                   _j(r)))
    got = th.piecewise_window_majorant(_t(t), _t(win), _t(e), _t(r)).numpy()
    np.testing.assert_array_equal(got, want)
    E = np.random.default_rng(9).exponential(size=t.size).astype(F32)
    want = np.asarray(jh.piecewise_conditional_residual(_j(t), _j(e), _j(r),
                                                        _j(E)))
    got = th.piecewise_conditional_residual(_t(t), _t(e), _t(r),
                                            _t(E)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_samplers_dispatch_to_the_functions():
    assert set(th.FAILURE_SAMPLERS) == set(jh.FAILURE_SAMPLERS)
    assert th.HAZARD_KINDS == jh.HAZARD_KINDS
    t = _t(np.linspace(0, 3000, 50))
    cols = tuple(map(_t, (8.0, 360.0, 1000.0, 2000.0)))
    bt = th.FAILURE_SAMPLERS["bathtub"]
    assert torch.equal(bt.hazard(t, cols), th.bathtub_shape(t, *cols))
    assert (bt.majorant(t, _t(90.0), cols) >= bt.hazard(t, cols)).all()
    _, e, r = _segments(False)
    pe = th.FAILURE_SAMPLERS["empirical"]
    assert torch.equal(pe.hazard(t, (_t(e), _t(r))),
                       th.piecewise_hazard(t, _t(e), _t(r)))
    with pytest.raises(NotImplementedError):
        th.FAILURE_SAMPLERS["weibull"].hazard(t, ())


# ---------------------------------------------------------------------------
# host columns and budgets
# ---------------------------------------------------------------------------

_BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=4,
             warm_standbys=2, job_length=2 * DAY,
             random_failure_rate=2.0 / DAY,
             systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
             auto_repair_time=30.0, manual_repair_time=120.0, seed=5)
#: name -> reference Params keyword overrides
HOST = {
    "exponential": {},
    "weibull": dict(failure_distribution="weibull",
                    distribution_kwargs={"k": 1.5}),
    "weibull_infant": dict(failure_distribution="weibull",
                           distribution_kwargs={"k": 0.8}),
    "weibull_no_systematic": dict(failure_distribution="weibull",
                                  distribution_kwargs={"k": 2.0},
                                  systematic_failure_rate=0.0),
    "weibull_k_negative": dict(failure_distribution="weibull",
                               distribution_kwargs={"k": -1.0}),
    "bathtub": dict(failure_distribution="bathtub",
                    distribution_kwargs={"infant_factor": 8.0,
                                         "infant_tau": 0.25 * DAY}),
    "bathtub_default": dict(failure_distribution="bathtub"),
    "bathtub_infant_below_1": dict(failure_distribution="bathtub",
                                   distribution_kwargs={
                                       "infant_factor": 0.5}),
    "lognormal": dict(failure_distribution="lognormal",
                      distribution_kwargs={"sigma": 1.0}),
    "lognormal_no_systematic": dict(failure_distribution="lognormal",
                                    distribution_kwargs={"sigma": 0.4},
                                    systematic_failure_rate=0.0),
    "lognormal_sigma0": dict(failure_distribution="lognormal",
                             distribution_kwargs={"sigma": 0.0}),
    "empirical": dict(failure_distribution="empirical",
                      distribution_kwargs={"edges": [0.4, 2.0],
                                           "rates": [0.3, 1.5, 0.7]}),
    "empirical_one_segment": dict(failure_distribution="empirical",
                                  distribution_kwargs={"rates": [2.0]}),
    "empirical_duplicate_edges": dict(failure_distribution="empirical",
                                      distribution_kwargs={
                                          "edges": [5.0, 5.0],
                                          "rates": [1.0, 2.0, 3.0]}),
    "deterministic": dict(failure_distribution="deterministic"),
    "checkpointed_bathtub": dict(failure_distribution="bathtub",
                                 checkpoint_interval=60.0,
                                 checkpoint_cost=2.0),
}


@pytest.mark.parametrize("name", list(HOST))
def test_host_columns_and_budgets_equal_the_reference(name):
    ref = JParams(**{**_BASE, **HOST[name]})
    port = TParams.from_dict(ref.to_dict())
    assert th.hazard_kind(port) == jh.hazard_kind(ref)
    assert th.hazard_segment_count(port) == jh.hazard_segment_count(ref)
    cols = th.hazard_columns(port)
    assert cols.dtype == np.float32
    np.testing.assert_array_equal(cols, jh.hazard_columns(ref))
    assert th.effective_event_rate(port) == jh.effective_event_rate(ref)
    assert th.phantom_steps(port) == jh.phantom_steps(ref)
    assert tv.default_max_steps(port) == jv.default_max_steps(ref)
    np.testing.assert_array_equal(tv._params_vector(port),
                                  np.asarray(jv._params_vector(ref)))
    kind = jh.hazard_kind(ref)
    if kind is not None:
        assert tv._n_uniforms(kind) == jv._n_uniforms(kind)
        assert cols.size == th.hazard_col_count(
            kind, th.hazard_segment_count(port))


def test_host_helpers_equal_the_reference():
    for sigma in (0.25, 1.0, 2.0):
        assert th._lognormal_mode_rel(sigma) == jh._lognormal_mode_rel(sigma)
        assert th._lognormal_peak_hazard(300.0, sigma) \
            == jh._lognormal_peak_hazard(300.0, sigma)
        assert th._lognormal_log_hazard_host(0.3, sigma) \
            == jh._lognormal_log_hazard_host(0.3, sigma)
    assert th._lognormal_peak_hazard(0.0, 1.0) == 0.0
    assert th.BATHTUB_WINDOW_FRACTION == jh.BATHTUB_WINDOW_FRACTION
    assert th.LOGNORMAL_WINDOW_FRACTION == jh.LOGNORMAL_WINDOW_FRACTION
    for k, mean in ((1.5, 300.0), (0.7, 1e4)):
        assert th._weibull_clock_coeff(t_dist.Weibull(mean, k)) \
            == jh._weibull_clock_coeff(j_dist.Weibull(mean, k))
    e = t_dist._REGISTRY["empirical"]
    je = j_dist._REGISTRY["empirical"]
    a = (e(100.0, edges=[1.0, 3.0], rates=[1.0, 0.5, 2.0]),
         e(40.0, rates=[2.0, 1.0], edges=[0.5]))
    b = (je(100.0, edges=[1.0, 3.0], rates=[1.0, 0.5, 2.0]),
         je(40.0, rates=[2.0, 1.0], edges=[0.5]))
    assert th._padded_pair_count(*a) == jh._padded_pair_count(*b) == 3
    for m in (3, 5):
        np.testing.assert_array_equal(th._pair_segment_columns(*a, m),
                                      jh._pair_segment_columns(*b, m))


# ---------------------------------------------------------------------------
# the step in lockstep with the reference
# ---------------------------------------------------------------------------

R = 128
STEP_FAMILIES = ("weibull", "weibull_infant", "bathtub", "lognormal",
                 "empirical", "checkpointed_bathtub")
#: integer and histogram lanes (exact), the rest are float lanes
_EXACT = ("phase", "n_runs", "n_failures", "n_random_failures",
          "n_systematic_failures", "n_preemptions", "n_auto_repairs",
          "n_manual_repairs", "n_failed_repairs", "n_host_selections",
          "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed", "run", "sb",
          "fw", "fs", "auto", "man", "hist")


@functools.lru_cache(maxsize=None)
def _jax_step(kind, n_seg, channels):
    return jax.jit(functools.partial(
        jv._step_u, impl="ref", kind=kind, rkind="exponential",
        hist_channels=channels, n_seg=n_seg))


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_step_lockstep_matches_reference(name):
    """200 steps; each step starts both packages from the reference's
    state.  Integer lanes must match on every row-step but a budget of
    0.2% for decisions within an ulp (an accept ``u * h_bar`` against
    ``h``, a pick ``u`` against a cdf entry, computed through float32
    functions that differ by an ulp); the other float lanes within 1e-6
    of their scale (2e-6 for Weibull, whose inversion cancels) on the
    rows whose integer lanes match."""
    ref = JParams(**{**_BASE, **HOST[name]})
    kind, n_seg = jh.hazard_kind(ref), jh.hazard_segment_count(ref)
    channels = jv._hist_channels([ref])
    step = _jax_step(kind, n_seg, channels)
    js = jv._initial_state(ref, R, None)
    pv = jv._params_vector(ref)
    tpv = torch.as_tensor(tv._params_vector(TParams.from_dict(ref.to_dict())))
    rng = np.random.default_rng(11)
    rtol = 2e-6 if kind == "weibull" else 1e-6
    flips = 0
    for _ in range(200):
        u = rng.uniform(1e-12, 1.0, (R, 9)).astype(F32)
        before = {k: np.asarray(v) for k, v in js.items()}
        j_out = step(js, jnp.asarray(u), pv)
        t_out = tv._step_u(tv.state_from_numpy(before, "cpu"),
                           torch.as_tensor(u), tpv, None, channels, kind,
                           n_seg)
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
            prev = before[k].astype(np.float64)
            prev = prev[np.isfinite(prev)]
            scale = float(np.abs(prev).max()) if prev.size else 0.0
            np.testing.assert_allclose(b[same], a[same], rtol=rtol,
                                       atol=rtol * scale, err_msg=k)
        js = j_out
    assert flips <= 0.002 * 200 * R, flips
    assert float(np.asarray(js["n_failures"]).sum()) > 0
    assert float(np.asarray(js["n_systematic_failures"]).sum()) > 0
