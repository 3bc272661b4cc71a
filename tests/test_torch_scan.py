"""Mamba selective scan of the PyTorch port against the JAX reference.

The port's plain version (``repro_torch.kernels.ref.selective_scan_ref``,
the CPU path of ``ops.selective_scan``) is held against the JAX reference
``ref.selective_scan_ref`` and against the Pallas kernel in interpret
mode on the same numpy inputs, with the tolerances of
``tests/test_kernels.py``: 1e-4 in float32 (another summation order over
N), 3e-2 in bfloat16 (y is rounded to bf16, and the state integrates
bf16 inputs).  A numpy model of the CUDA kernel's own arithmetic
(``ex2.approx`` on a pre-scaled A at its worst error, flush to zero, the
lanes' partial sums in the kernel's shuffle order) is held against the
same references on the CPU, and the kernel's launch plan (lanes, copy
widths from alignment, shared memory) is checked there too.  The CUDA
kernel is held against the port's plain version on the card (marked
``gpu``), at the same shapes and at every edge of its plan.
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
#: every other channel's A scaled so that some dt * A fall where expf
#: returns a denormal and ex2.approx.ftz returns 0: (B, S, di, N)
UNDERFLOW_CASE = (2, 40, 64, 16)
DTYPES = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 3e-2)}

#: log2(e) in float32 and ex2.approx.ftz.f32's largest relative error
#: (the PTX ISA), as the kernel uses them
LOG2E = np.float32(1.4426950408889634)
EX2_REL_ERR = 2.0 ** -22


@pytest.fixture(scope="module")
def jax_scan():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jax, jops, jref


def _inputs(B, S, di, N, seed=0, underflow=False):
    """x, dt (softplus * 0.1), A (negative), B, C -- as tests/test_kernels.py
    draws them, from numpy; ``underflow`` scales every other channel's A
    by 400, so that dt * A reaches -100 and below."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((B, S, di)), 0).astype(
        np.float32) * 0.1
    A = -np.exp(rng.standard_normal((di, N)).astype(np.float32) * 0.5)
    if underflow:
        A[::2] *= 400
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


def _fma(a, b, c):
    """float32 a * b + c rounded once (through float64, where a * b is
    exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _kernel_model(x, dt, A, Bm, Cm, h0, lanes, rel_err):
    """csrc/mamba_scan.cu's arithmetic in numpy float32: decay =
    2^(dt * A2) with A2 = float32(A * log2e), off by ``rel_err`` relative
    (ex2.approx's error) and flushed to 0 below 2^-126; h = fma(decay, h,
    dx * B); each of ``lanes`` lanes sums h * C over its N / lanes states
    by fma, and the lanes' sums meet in the kernel's shuffle tree.
    Inputs are float32 arrays (already rounded to the working type);
    returns (y float32, h float32)."""
    Bsz, S, di = x.shape
    N = A.shape[1]
    K = N // lanes
    A2 = A * LOG2E
    h = h0.astype(np.float32).copy()
    y = np.empty((Bsz, S, di), np.float32)
    for t in range(S):
        d = dt[:, t]
        dx = d * x[:, t]
        arg = d[..., None] * A2[None]
        decay = (np.exp2(arg.astype(np.float64)) * (1 + rel_err)).astype(
            np.float32)
        decay[decay < np.float32(2.0 ** -126)] = 0
        h = _fma(decay, h, dx[..., None] * Bm[:, t, None, :])
        part = np.zeros((Bsz, di, lanes), np.float32)
        for j in range(K):
            part = _fma(h[..., j::K], Cm[:, t, None, j::K], part)
        while part.shape[-1] > 1:       # lane m adds lane m ^ 1, then m ^ 2
            part = part[..., 0::2] + part[..., 1::2]
        y[:, t] = part[..., 0]
    return y, h


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


@pytest.mark.parametrize("case", [c[:4] for c in SCAN_CASES] + RAGGED_CASES
                         + [UNDERFLOW_CASE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("err_sign", [-1, 1])
def test_kernel_arithmetic_matches_jax(jax_scan, case, dtype, err_sign):
    """The CUDA kernel's arithmetic, with ex2.approx's error at its bound
    in one direction on every element, stays within the tolerances of the
    JAX reference and of the Pallas kernel in interpret mode."""
    jax, jops, jref = jax_scan
    B, S, di, N = case
    underflow = case == UNDERFLOW_CASE
    arrays = _inputs(B, S, di, N, seed=S + di + 1, underflow=underflow)
    x, dt, A, Bm, Cm = (t.float().numpy() for t in _to_torch(arrays, dtype))
    if underflow:   # expf gives denormals here, the kernel's ex2 zeros
        arg = dt[..., None] * A[None, None]
        assert ((arg < -88) & (arg > -103)).any() and (arg < -104).any()
    tol = DTYPES[dtype][1]
    y, h = _kernel_model(x, dt, A, Bm, Cm, np.zeros((B, di, N)),
                         mamba_scan.LANES, err_sign * EX2_REL_ERR)
    y = torch.as_tensor(y).to(DTYPES[dtype][0])
    jargs = _to_jax(jax, arrays, dtype)
    y_r, h_r = jref.selective_scan_ref(*jargs)
    _assert_close(y, y_r, tol)
    _assert_close(torch.as_tensor(h), h_r, tol)
    y_p, h_p = jops.selective_scan(*jargs, impl="pallas_interpret")
    _assert_close(y, y_p, tol)
    _assert_close(torch.as_tensor(h), h_p, tol)


def _strided(B, S, N, dtype, offset):
    """B and C as column slices of one (B, S, offset + 2N) projection,
    the way the Mamba layer splits x_proj's output."""
    dbc = torch.zeros((B, S, offset + 2 * N), dtype=dtype)
    return dbc[..., offset:offset + N], dbc[..., offset + N:]


@pytest.mark.parametrize("N", [8, 16])
def test_launch_plan_lanes_and_grid(N):
    x = torch.zeros((3, 5, 200), dtype=torch.bfloat16)
    Bm, Cm = _strided(3, 5, N, torch.bfloat16, 0)
    plan = mamba_scan.launch_plan(x, x, Bm, Cm)
    assert plan.lanes == mamba_scan.LANES == 2
    assert plan.threads == mamba_scan.BLOCK_CHANNELS * 2 + 32
    assert plan.grid == (4, 3)          # 200 channels: 3 blocks + 8 more


@pytest.mark.parametrize("dtype, di, offset, widths", [
    # falcon-mamba's prefill: x, dt contiguous; B, C after dt_rank 256
    (torch.bfloat16, 8192, 256, (16, 16, 16, 16, 16)),
    (torch.float32, 8192, 256, (16, 16, 16, 16, 16)),
    # d_inner not a multiple of 8: 8-byte, then one-element copies in bf16
    (torch.bfloat16, 100, 0, (8, 8, 16, 16, 8)),
    (torch.bfloat16, 97, 0, (2, 2, 16, 16, 2)),
    (torch.float32, 97, 0, (4, 4, 16, 16, 4)),
    # B, C slices at an odd offset: rows start on 2 (bf16), 4 (fp32) bytes
    (torch.bfloat16, 128, 3, (16, 16, 2, 2, 16)),
    (torch.float32, 128, 3, (16, 16, 4, 4, 16)),
    (torch.bfloat16, 128, 4, (16, 16, 8, 8, 16)),
])
def test_launch_plan_copy_widths(dtype, di, offset, widths):
    x = torch.zeros((2, 9, di), dtype=dtype)
    dt = torch.zeros((2, 9, di), dtype=dtype)
    Bm, Cm = _strided(2, 9, 16, dtype, offset)
    assert mamba_scan.launch_plan(x, dt, Bm, Cm).widths == widths


def test_launch_plan_widths_follow_offsets_and_strides():
    """A view that starts 2 bytes in, or steps rows by an odd count, takes
    narrower copies; the stride of a dim of size 1 is never used."""
    base = torch.zeros((2, 9, 130), dtype=torch.bfloat16)
    x = base[..., 2:]                   # 4 bytes in, rows of 260 bytes
    Bm, Cm = _strided(2, 9, 16, torch.bfloat16, 0)
    assert mamba_scan.launch_plan(x, x, Bm, Cm).widths[:2] == (4, 4)
    one = torch.zeros((1, 1, 135), dtype=torch.bfloat16)[..., :128]
    B1, C1 = _strided(1, 1, 16, torch.bfloat16, 0)
    assert mamba_scan.launch_plan(one, one, B1, C1).widths == (16,) * 5


@pytest.mark.parametrize("dtype, N, smem", [
    (torch.bfloat16, 16, 36864), (torch.bfloat16, 8, 30720),
    (torch.float32, 16, 57344), (torch.float32, 8, 53248)])
def test_launch_plan_shared_memory(dtype, N, smem):
    """Two spans of the inputs, of y and (bf16) of B and C in fp32; four
    blocks fit the 228 KiB of an SM (1 KiB more a block is the system's),
    as the kernel's launch bounds ask."""
    x = torch.zeros((1, 4, 64), dtype=dtype)
    Bm, Cm = _strided(1, 4, N, dtype, 0)
    plan = mamba_scan.launch_plan(x, x, Bm, Cm)
    assert plan.smem_bytes == smem
    assert 4 * (smem + 1024) <= 228 * 1024


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


#: the kernel's edges on the card: (B, S, di, N, B/C column offset in one
#: projection, what else)
CUDA_EDGE_CASES = [
    (2, 70, 200, 8, 0, ""),            # N 8; di not a multiple of 64
    (2, 45, 100, 16, 0, ""),           # di % 8 == 4: 8-byte copies (bf16)
    (1, 33, 97, 16, 0, ""),            # odd di: one-element copies (bf16)
    (3, 1, 128, 16, 0, ""),            # S = 1
    (2, 77, 192, 16, 0, ""),           # S not a multiple of the span
    (2, 64, 256, 16, 256, ""),         # falcon-mamba's B/C (dt_rank 256)
    (2, 40, 128, 8, 3, ""),            # B/C slices at an odd offset
    (2, 96, 128, 16, 0, "continue"),   # [0, 40) then [40, 96) through h0
    UNDERFLOW_CASE + (0, "underflow"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[:4] for c in SCAN_CASES] + RAGGED_CASES
                         + [(4, 512, 8192, 16)] + CUDA_EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, S, di, N, offset, what = (tuple(case) + (0, ""))[:6]
    x, dt, A, Bm, Cm = (t.cuda() for t in _to_torch(
        _inputs(B, S, di, N, seed=5, underflow=what == "underflow"), dtype))
    if offset:
        Bs, Cs = _strided(B, S, N, x.dtype, offset)
        Bs, Cs = Bs.cuda(), Cs.cuda()
        Bs.copy_(Bm)
        Cs.copy_(Cm)
        Bm, Cm = Bs, Cs
    h0 = torch.randn((B, di, N), device="cuda") * 0.1
    before = mamba_scan.LAUNCHES
    if what == "continue":
        y1, h1 = ops.selective_scan(x[:, :40], dt[:, :40], A, Bm[:, :40],
                                    Cm[:, :40], h0)
        y2, h = ops.selective_scan(x[:, 40:], dt[:, 40:], A, Bm[:, 40:],
                                   Cm[:, 40:], h1)
        y = torch.cat([y1, y2], 1)
        assert mamba_scan.LAUNCHES == before + 2
    else:
        y, h = ops.selective_scan(x, dt, A, Bm, Cm, h0)
        assert mamba_scan.LAUNCHES == before + 1
    y_r, h_r = selective_scan_ref(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    tol = DTYPES[dtype][1]
    assert y.dtype == x.dtype and h.dtype == torch.float32
    _assert_close(y.cpu(), y_r.float().cpu().numpy(), tol)
    _assert_close(h.cpu(), h_r.cpu().numpy(), tol)
