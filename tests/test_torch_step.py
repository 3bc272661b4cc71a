"""Step parity: one CTMC transition of the port against the JAX reference.

The same state and the same ``(B, 8)`` numpy uniforms go through
``repro.core.vectorized._step_u`` (event race ``impl="ref"``) and the
port's ``_step_u``.  Integer lanes must match exactly.  Float lanes must
match within rtol 1e-6 of the lane's own scale: the two packages sum the
16 rates in another order and use another float32 ``log``, so ``dt``
differs by an ulp or so, and a lane such as ``timer`` that subtracts
``dt`` from a larger value carries that ulp of the larger value.

Over a 200-step trajectory in which each package advances its own state
on the same uniforms, at least 99% of rows must end with identical
integer lanes; the rest is the budget for pick flips where a uniform lies
within an ulp of a cdf entry.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import vectorized as tv
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core import vectorized as jv  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

R = 128
_DEFAULT = dict(job_size=64, working_pool_size=72, spare_pool_size=16,
                warm_standbys=4, job_length=4 * DAY,
                random_failure_rate=0.5 / DAY, seed=3)
CONFIGS = {
    "default": (JParams(**_DEFAULT), None),
    "starved": (JParams(job_size=32, working_pool_size=33, spare_pool_size=2,
                        warm_standbys=1, job_length=2 * DAY,
                        random_failure_rate=2.0 / DAY, auto_repair_time=240.0,
                        manual_repair_time=2880.0, diagnosis_probability=1.0,
                        seed=5), None),
    "diagnosis": (JParams(job_size=48, working_pool_size=56,
                          spare_pool_size=8, warm_standbys=4,
                          job_length=2 * DAY, random_failure_rate=1.0 / DAY,
                          diagnosis_probability=0.6,
                          diagnosis_uncertainty=0.3, seed=7), None),
    "checkpoint": (JParams(checkpoint_interval=60.0, checkpoint_cost=2.0,
                           **_DEFAULT), None),
    "no_histogram": (JParams(histogram=None, **_DEFAULT), None),
    "no_ring_buffer": (JParams(**_DEFAULT), 0),
}


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    p, _ = CONFIGS[name]
    return jax.jit(functools.partial(
        jv._step_u, impl="ref", kind="exponential", rkind="exponential",
        hist_channels=jv._hist_channels([p])))


def _setup(name):
    p, max_runs = CONFIGS[name]
    tp = TParams.from_dict(p.to_dict())
    js = jv._initial_state(p, R, max_runs)
    pv = jv._params_vector(p)
    tpv = torch.as_tensor(tv._params_vector(tp))
    return p, tp, js, pv, tpv


def _uniforms(rng):
    return rng.uniform(1e-12, 1.0, (R, 8)).astype(np.float32)


def _to_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_initial_state_matches(name):
    p, tp, js, pv, tpv = _setup(name)
    ts = tv._initial_state(tp, R, CONFIGS[name][1])
    assert list(ts) == list(js)
    for k, v in _to_np(js).items():
        t = ts[k].numpy()
        assert t.dtype == v.dtype and t.shape == v.shape, k
        np.testing.assert_array_equal(t, v, err_msg=k)
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(pv))


def _assert_step_matches(before, j_out, t_out):
    assert sorted(t_out) == sorted(j_out)
    for k, jv_ in j_out.items():
        a, b = np.asarray(jv_), t_out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        prev = np.asarray(before[k], np.float64)
        prev = prev[np.isfinite(prev)]
        scale = float(np.abs(prev).max()) if prev.size else 0.0
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_lockstep_matches_reference(name):
    """Every step from the reference's own trajectory, fed to both."""
    p, tp, js, pv, tpv = _setup(name)
    step = _jax_step(name)
    channels = jv._hist_channels([p])
    rng = np.random.default_rng(11)
    for _ in range(80):
        u = _uniforms(rng)
        before = _to_np(js)
        j_out = step(js, jax.numpy.asarray(u), pv)
        t_out = tv._step_u(tv.state_from_numpy(before, "cpu"),
                           torch.as_tensor(u), tpv, None, channels)
        _assert_step_matches(before, j_out, t_out)
        js = j_out
    # the trajectory went somewhere: failures, repairs and restarts
    assert float(np.asarray(js["n_failures"]).sum()) > 0
    assert float(np.asarray(js["n_auto_repairs"]).sum()) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_integer_lanes_agree(name):
    p, tp, js, pv, tpv = _setup(name)
    step = _jax_step(name)
    channels = jv._hist_channels([p])
    ts = tv.state_from_numpy(_to_np(js), "cpu")
    rng = np.random.default_rng(23)
    for _ in range(200):
        u = _uniforms(rng)
        js = step(js, jax.numpy.asarray(u), pv)
        ts = tv._step_u(ts, torch.as_tensor(u), tpv, None, channels)
    same = np.ones(R, bool)
    for k in ("phase", "n_runs", "n_failures", "n_random_failures",
              "n_systematic_failures", "n_preemptions", "n_auto_repairs",
              "n_manual_repairs", "n_failed_repairs", "n_host_selections",
              "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed", "run",
              "sb", "fw", "fs", "auto", "man"):
        a, b = np.asarray(js[k]), ts[k].numpy()
        same &= (a == b).reshape(R, -1).all(-1)
    assert same.mean() >= 0.99, same.mean()


def test_step_leaves_input_state_unchanged():
    p, tp, js, pv, tpv = _setup("default")
    ts = tv.state_from_numpy(_to_np(js), "cpu")
    snapshot = {k: v.clone() for k, v in ts.items()}
    u = torch.as_tensor(_uniforms(np.random.default_rng(0)))
    for _ in range(3):
        tv._step_u(ts, u, tpv, None, jv._hist_channels([p]))
    for k, v in snapshot.items():
        assert torch.equal(ts[k], v), k


def test_state_numpy_round_trip():
    p, tp, js, pv, tpv = _setup("checkpoint")
    arrays = _to_np(js)
    back = tv.state_to_numpy(tv.state_from_numpy(arrays, "cpu"))
    assert list(back) == list(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
