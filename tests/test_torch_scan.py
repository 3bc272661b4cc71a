"""Mamba selective scan of the PyTorch port against the JAX reference.

The port's plain version (``repro_torch.kernels.ref.selective_scan_ref``,
the CPU path of ``ops.selective_scan``) is held against the JAX reference
``ref.selective_scan_ref`` and against the Pallas kernel in interpret
mode on the same numpy inputs, with the tolerances of
``tests/test_kernels.py``: 1e-4 in float32 (another summation order over
N), 3e-2 in bfloat16 (y is rounded to bf16, and the state integrates
bf16 inputs).  The CUDA kernel is held against the port's plain version
on the card (marked ``gpu``), at the same shapes and at ragged ones.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan, ops
from repro_torch.kernels.ref import selective_scan_ref

torch.set_num_threads(1)

#: the SCAN_CASES of tests/test_kernels.py: (B, S, di, N, chunk, block_d)
SCAN_CASES = [
    (1, 64, 64, 8, 16, 32),
    (2, 128, 128, 16, 32, 64),
    (2, 64, 256, 16, 64, 128),
]
#: S and d_inner that divide no block: (B, S, di, N)
RAGGED_CASES = [(1, 100, 96, 16), (3, 37, 200, 8)]
DTYPES = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 3e-2)}


@pytest.fixture(scope="module")
def jax_scan():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jax, jops, jref


def _inputs(B, S, di, N, seed=0):
    """x, dt (softplus * 0.1), A (negative), B, C -- as tests/test_kernels.py
    draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((B, S, di)), 0).astype(
        np.float32) * 0.1
    A = -np.exp(rng.standard_normal((di, N)).astype(np.float32) * 0.5)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _to_torch(arrays, dtype):
    x, dt, A, Bm, Cm = (torch.as_tensor(a) for a in arrays)
    t = DTYPES[dtype][0]
    return x.to(t), dt.to(t), A, Bm.to(t), Cm.to(t)


def _to_jax(jax, arrays, dtype):
    jnp = jax.numpy
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in arrays)
    t = getattr(jnp, dtype)
    return x.astype(t), dt.astype(t), A, Bm.astype(t), Cm.astype(t)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_jax_ref_and_pallas(jax_scan, case, dtype):
    jax, jops, jref = jax_scan
    B, S, di, N, chunk, block_d = case
    arrays = _inputs(B, S, di, N, seed=S + di)
    tol = DTYPES[dtype][1]
    y, h = ops.selective_scan(*_to_torch(arrays, dtype))
    assert y.dtype == DTYPES[dtype][0] and h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    jargs = _to_jax(jax, arrays, dtype)
    y_r, h_r = jref.selective_scan_ref(*jargs)
    _assert_close(y, y_r, tol)
    _assert_close(h, h_r, tol)
    y_p, h_p = jops.selective_scan(*jargs, impl="pallas_interpret",
                                   chunk=chunk, block_d=block_d)
    _assert_close(y, y_p, tol)
    _assert_close(h, h_p, tol)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_shapes_match_jax(jax_scan, case):
    """S and d_inner that divide no block (the JAX ops sent these to its
    reference)."""
    jax, jops, _ = jax_scan
    arrays = _inputs(*case, seed=11)
    y, h = ops.selective_scan(*_to_torch(arrays, "float32"))
    y_j, h_j = jops.selective_scan(*_to_jax(jax, arrays, "float32"),
                                   impl="pallas_interpret")
    _assert_close(y, y_j, 1e-4)
    _assert_close(h, h_j, 1e-4)


def test_initial_state_continuation(jax_scan):
    """Scanning [0:S] equals scanning [0:S/2] then [S/2:S] from its h, and
    the JAX kernel's continuation from the same h0."""
    jax, jops, _ = jax_scan
    arrays = _inputs(1, 64, 64, 8, seed=30)
    x, dt, A, Bm, Cm = _to_torch(arrays, "float32")
    y_full, h_full = ops.selective_scan(x, dt, A, Bm, Cm)
    half = 32
    y1, h1 = ops.selective_scan(x[:, :half], dt[:, :half], A, Bm[:, :half],
                                Cm[:, :half])
    y2, h2 = ops.selective_scan(x[:, half:], dt[:, half:], A, Bm[:, half:],
                                Cm[:, half:], h0=h1)
    _assert_close(torch.cat([y1, y2], dim=1), y_full.numpy(), 1e-4)
    _assert_close(h2, h_full.numpy(), 1e-4)
    jx, jdt, jA, jB, jC = _to_jax(jax, arrays, "float32")
    y2_j, h2_j = jops.selective_scan(
        jx[:, half:], jdt[:, half:], jA, jB[:, half:], jC[:, half:],
        h0=jax.numpy.asarray(h1.numpy()), impl="pallas_interpret",
        chunk=16, block_d=32)
    _assert_close(y2, y2_j, 1e-4)
    _assert_close(h2, h2_j, 1e-4)


def test_step_decode_equals_scan(jax_scan):
    """Decode steps replay the scan one token at a time, and each step
    matches JAX's ``selective_scan_step``."""
    jax, jops, _ = jax_scan
    arrays = _inputs(2, 8, 32, 8, seed=40)
    x, dt, A, Bm, Cm = _to_torch(arrays, "float32")
    y_full, h_full = ops.selective_scan(x, dt, A, Bm, Cm)
    h = torch.zeros((2, 32, 8))
    ys = []
    for t in range(8):
        h_prev = h
        y_t, h = ops.selective_scan_step(x[:, t], dt[:, t], A, Bm[:, t],
                                         Cm[:, t], h)
        y_j, h_j = jops.selective_scan_step(
            *(jax.numpy.asarray(a.numpy()) for a in
              (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h_prev)))
        _assert_close(y_t, y_j, 1e-5)
        _assert_close(h, h_j, 1e-5)
        ys.append(y_t)
    _assert_close(torch.stack(ys, dim=1), y_full.numpy(), 1e-4)
    _assert_close(h, h_full.numpy(), 1e-4)


def test_refusals():
    x, dt, A, Bm, Cm = _to_torch(_inputs(1, 8, 16, 8), "float32")
    with pytest.raises(ValueError, match="impl='ref'"):
        ops.selective_scan(x, dt, A, Bm, Cm, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.selective_scan(x, dt, A, Bm, Cm, impl="pallas")
    x4, dt4, A4, B4, C4 = _to_torch(_inputs(1, 8, 16, 4), "float32")
    with pytest.raises(ValueError, match="N=4"):
        mamba_scan.selective_scan_cuda(x4, dt4, A4, B4, C4)
    with pytest.raises(ValueError, match="not a CUDA device"):
        mamba_scan.selective_scan_cuda(x, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="dtypes"):
        mamba_scan.selective_scan_cuda(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="h0"):
        mamba_scan.selective_scan_cuda(x, dt, A, Bm, Cm,
                                       h0=torch.zeros((1, 16, 8)).double())


def test_kernel_library_named_by_source_hash():
    path = mamba_scan.LIBRARY.library_path()
    assert path.parent.name == "repro_torch"
    assert path.name.startswith("mamba_scan_") and path.suffix == ".so"


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[:4] for c in SCAN_CASES] + RAGGED_CASES
                         + [(4, 512, 8192, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, dt, A, Bm, Cm = (t.cuda() for t in _to_torch(_inputs(*case, seed=5),
                                                     dtype))
    B, S, di, N = case
    h0 = torch.randn((B, di, N), device="cuda") * 0.1
    before = mamba_scan.LAUNCHES
    y, h = ops.selective_scan(x, dt, A, Bm, Cm, h0)
    assert mamba_scan.LAUNCHES == before + 1
    y_r, h_r = selective_scan_ref(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    tol = DTYPES[dtype][1]
    _assert_close(y.cpu(), y_r.float().cpu().numpy(), tol)
    _assert_close(h.cpu(), h_r.cpu().numpy(), tol)
