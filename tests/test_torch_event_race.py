"""Event race of the PyTorch port against the JAX reference and its kernel.

The port's plain version (``repro_torch.kernels.ref.event_race_ref``) is
held against the JAX reference ``ref.event_race_ref`` and against the
Pallas kernel in interpret mode on the same numpy inputs: events exactly,
``dt`` within rtol 1e-6 (float32 sums taken in another order and another
``log`` implementation differ by an ulp or so).  The CUDA kernel is held
against the port's plain version on the card (marked ``gpu``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import des_step, ops
from repro_torch.kernels.ref import event_race_ref

torch.set_num_threads(1)

SHAPES = [
    (64, 4, 2), (256, 16, 4), (1024, 18, 2),
    # ragged shapes the TPU kernel padded: no multiple of a block or of 8
    (100, 3, 1), (8, 1, 1), (130, 9, 5), (96, 23, 7),
]


@pytest.fixture(scope="module")
def jax_kernels():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jops, jref


def _inputs(R, Ke, Kd):
    rng = np.random.default_rng(R)
    rates = rng.uniform(0, 2, (R, Ke)).astype(np.float32)
    rates[:, Ke // 2] = 0.0                   # one family switched off
    resid = rng.uniform(0.01, 5, (R, Kd)).astype(np.float32)
    resid[: R // 4, 0] = np.inf               # some timers off
    ut = rng.uniform(1e-6, 1, R).astype(np.float32)
    up = rng.uniform(0, 1, R).astype(np.float32)
    return rates, resid, ut, up


def _port(rates, resid, ut, up, **kw):
    dt, ev = ops.event_race(*(torch.as_tensor(a) for a in
                              (rates, resid, ut, up)), **kw)
    return dt.numpy(), ev.numpy()


@pytest.mark.parametrize("R,Ke,Kd", SHAPES)
def test_event_race_matches_jax_ref(jax_kernels, R, Ke, Kd):
    jops, jref = jax_kernels
    args = _inputs(R, Ke, Kd)
    dt_j, ev_j = jref.event_race_ref(*args)
    dt_t, ev_t = _port(*args)
    assert ev_t.dtype == np.int32 and dt_t.dtype == np.float32
    np.testing.assert_array_equal(ev_t, np.asarray(ev_j))
    np.testing.assert_allclose(dt_t, np.asarray(dt_j), rtol=1e-6)


@pytest.mark.parametrize("R,Ke,Kd", SHAPES)
def test_event_race_matches_pallas_interpret(jax_kernels, R, Ke, Kd):
    jops, jref = jax_kernels
    args = _inputs(R, Ke, Kd)
    dt_p, ev_p = jops.event_race(*args, impl="pallas_interpret", block_r=64)
    dt_t, ev_t = _port(*args, impl="ref")
    np.testing.assert_array_equal(ev_t, np.asarray(ev_p))
    np.testing.assert_allclose(dt_t, np.asarray(dt_p), rtol=1e-6)


def test_event_race_all_rates_zero_picks_deterministic():
    R = 64
    rates = torch.zeros((R, 4))
    resid = torch.tensor([[3.0, 1.5]]).repeat(R, 1)
    u = torch.full((R,), 0.5)
    dt, ev = ops.event_race(rates, resid, u, u)
    assert torch.allclose(dt, torch.tensor(1.5))
    assert (ev == 4 + 1).all()


def test_event_race_ties_and_empty_rows(jax_kernels):
    """Residual ties go to the first lane; a row with no live clock at
    all (zero rates, all-+inf residuals) resolves to the clipped
    exponential pick, dt +inf; an exponential/deterministic tie goes to
    the exponential side -- on both packages."""
    _, jref = jax_kernels
    u = np.asarray([0.5, 0.5, 0.25], np.float32)
    t_tie = float(-torch.log(torch.tensor(0.25)))
    rates = np.asarray([[0, 0], [0, 0], [1, 0]], np.float32)
    resid = np.asarray([[2, 2], [np.inf, np.inf], [t_tie, np.inf]],
                       np.float32)
    up = np.full(3, 0.5, np.float32)
    dt, ev = _port(rates, resid, u, up)
    assert ev.tolist() == [2, 1, 0]
    assert dt[0] == 2.0 and np.isinf(dt[1]) and dt[2] == np.float32(t_tie)
    dt_j, ev_j = jref.event_race_ref(rates, resid, u, up)
    np.testing.assert_array_equal(ev, np.asarray(ev_j))


def test_event_race_statistics():
    """The winning-family distribution matches the rate proportions."""
    R = 100_000
    rng = np.random.default_rng(0)
    rates = torch.tensor([[1.0, 3.0, 0.0, 6.0]]).repeat(R, 1)
    resid = torch.full((R, 2), np.inf)
    ut = torch.as_tensor(rng.uniform(1e-9, 1, R).astype(np.float32))
    up = torch.as_tensor(rng.uniform(0, 1, R).astype(np.float32))
    dt, ev = ops.event_race(rates, resid, ut, up)
    freq = np.bincount(ev.numpy(), minlength=4) / R
    np.testing.assert_allclose(freq[:4], [0.1, 0.3, 0.0, 0.6], atol=6e-3)
    np.testing.assert_allclose(float(dt.mean()), 1 / 10.0, rtol=2e-2)


def test_event_race_unknown_impl_refused():
    x = torch.ones((8, 2))
    u = torch.full((8,), 0.5)
    with pytest.raises(ValueError, match="impl"):
        ops.event_race(x, x, u, u, impl="pallas")


def test_event_race_zero_lane_refused():
    u = torch.full((16,), 0.5)
    with pytest.raises(ValueError, match="zero-width lane"):
        ops.event_race(torch.ones((16, 2)), torch.zeros((16, 0)), u, u)
    with pytest.raises(ValueError, match="zero-width lane"):
        ops.event_race(torch.zeros((16, 0)), torch.ones((16, 2)), u, u)


def test_event_race_cuda_on_cpu_refused():
    """An explicit kernel request for CPU tensors names the alternatives
    instead of quietly running the plain version."""
    x = torch.ones((8, 2))
    u = torch.full((8,), 0.5)
    with pytest.raises(ValueError, match="impl='ref'"):
        ops.event_race(x, x, u, u, impl="cuda")


def test_event_race_kernel_wrapper_refuses_cpu_tensors():
    x = torch.ones((8, 2))
    u = torch.full((8,), 0.5)
    with pytest.raises(ValueError, match="not a CUDA device"):
        des_step.event_race_cuda(x, x, u, u)


def test_kernel_library_named_by_source_hash():
    path = des_step.library_path()
    assert path.parent.name == "repro_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("event_race_") and path.suffix == ".so"


@pytest.mark.gpu
@pytest.mark.parametrize("R,Ke,Kd", SHAPES + [(4096, 16, 3)])
def test_event_race_cuda_kernel_matches_ref(R, Ke, Kd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rates, resid, ut, up = (torch.as_tensor(a).cuda()
                            for a in _inputs(R, Ke, Kd))
    rates[::5] = 0.0                          # all-zero-rate rows
    before = des_step.LAUNCHES
    dt_k, ev_k = ops.event_race(rates, resid, ut, up)
    assert des_step.LAUNCHES == before + 1
    dt_r, ev_r = event_race_ref(rates, resid, ut, up)
    torch.cuda.synchronize()
    assert torch.equal(ev_k, ev_r)
    np.testing.assert_allclose(dt_k.cpu().numpy(), dt_r.cpu().numpy(),
                               rtol=1e-6)
