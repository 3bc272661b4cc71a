"""The attention and scan kernels under autograd (``kernels/ops.py``).

Where the kernel is taken, ``ops.flash_attention`` and
``ops.selective_scan`` are ``torch.autograd.Function``s: the forward is
the CUDA kernel, one launch a call, and the backward is the plain
version's gradient, recomputed from the saved inputs, launching nothing.

On the CPU the kernel wrapper is swapped for a counting stand-in (the
plain version on the same inputs), which checks the Function's plumbing:
one forward launch a call, none in the backward, gradients equal to plain
autograd's for q, k, v and for all six scan inputs (``h0`` included), a
non-contiguous ``grad_output``, non-contiguous projection views, and
``h_final``'s gradient alone.  On the card (marked ``gpu``): the kernels
themselves, outputs and the gradients of a fixed random cotangent against
``impl="ref"``, in float32 (rtol 2e-5 of the scale; the kernel's forward
and the plain forward sum in another order) and bfloat16 (2e-2, the
serving tolerance), with the launch counts.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _attn_inputs(dtype=torch.float32, device="cpu", B=2, S=24, Hq=4, Hkv=2,
                 d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            .to(device=device, dtype=dtype).requires_grad_()
            for s in ((B, S, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d))]


def _scan_inputs(dtype=torch.float32, device="cpu", B=2, S=20, di=24, N=8,
                 seed=1, h0=True):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=torch.float32).to(device=device,
                                                       dtype=dt)
    x = t(rng.standard_normal((B, S, di)))
    dt = t(np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2.0)))
    A = t(-np.exp(rng.standard_normal((di, N)) * 0.5), torch.float32)
    BC = t(rng.standard_normal((B, S, 2 * N)))  # B and C: column views
    h = t(rng.standard_normal((B, di, N)) * 0.1, torch.float32) \
        if h0 else None
    leaves = [x, dt, A, BC] + ([h] if h0 else [])
    for leaf in leaves:
        leaf.requires_grad_()
    return leaves, (x, dt, A, BC[..., :N], BC[..., N:], h)


@pytest.fixture
def stand_ins(monkeypatch):
    """The kernels swapped for the plain versions, counting launches."""
    count = {"attn": 0, "scan": 0}

    def attn(q, k, v, *, causal, q_offset, kv_len):
        count["attn"] += 1
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        assert not torch.is_grad_enabled()
        return ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len)

    def scan(*args):
        count["scan"] += 1
        assert not torch.is_grad_enabled()
        return ref.selective_scan_ref(*args)

    monkeypatch.setattr(ops._attn, "flash_attention_cuda", attn)
    monkeypatch.setattr(ops._scan, "selective_scan_cuda", scan)
    monkeypatch.setattr(ops, "_use_kernel", lambda name, impl, t: True)
    return count


@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_gradients_are_plain(stand_ins, causal):
    q, k, v = _attn_inputs()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert stand_ins["attn"] == 1 and out.grad_fn is not None
    g = torch.randn(out.shape[::-1]).permute(3, 2, 1, 0)   # non-contiguous
    got = torch.autograd.grad(out, (q, k, v), g)
    assert stand_ins["attn"] == 1                        # none in backward
    want = torch.autograd.grad(
        ref.attention_ref(q, k, v, causal=causal), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attention_function_takes_projection_views(stand_ins):
    x = torch.randn(2, 12, 32, requires_grad=True)
    w = torch.randn(32, 3, 4, 8)
    qkv = torch.einsum("bsd,dthk->tbshk", x, w)          # views of one
    q, k, v = qkv[0], qkv[1][:, :, :2], qkv[2][:, :, :2]
    assert not k.is_contiguous()
    out = ops.flash_attention(q, k, v)
    (gx,) = torch.autograd.grad(out.sum(), (x,), retain_graph=True)
    (want,) = torch.autograd.grad(ref.attention_ref(q, k, v).sum(), (x,))
    torch.testing.assert_close(gx, want, rtol=0, atol=0)


@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zero_h0"])
def test_scan_function_gradients_are_plain(stand_ins, h0):
    leaves, args = _scan_inputs(h0=h0)
    y, hf = ops.selective_scan(*args)
    assert stand_ins["scan"] == 1 and y.grad_fn is not None
    gy = torch.randn(y.shape[::-1]).permute(2, 1, 0)     # non-contiguous
    gh = torch.randn(hf.shape)
    got = torch.autograd.grad((y, hf), leaves, (gy, gh))
    assert stand_ins["scan"] == 1
    want = torch.autograd.grad(ref.selective_scan_ref(*args), leaves,
                               (gy, gh))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the final state's gradient alone (y unused)
    y, hf = ops.selective_scan(*args)
    got = torch.autograd.grad(hf, leaves, gh)
    want = torch.autograd.grad(ref.selective_scan_ref(*args)[1], leaves, gh)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_path_is_plain_autograd():
    q, k, v = _attn_inputs()
    out = ops.flash_attention(q, k, v)                   # CPU: the plain path
    assert type(out.grad_fn).__name__ != "BackwardCFunction"
    leaves, args = _scan_inputs()
    y, _ = ops.selective_scan(*args)
    assert type(y.grad_fn).__name__ != "BackwardCFunction"


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
def test_cuda_attention_under_autograd(dtype, tol):
    _needs_cuda()
    q, k, v = _attn_inputs(dtype, "cuda", B=2, S=160, Hq=8, Hkv=2, d=64)
    before = fa.LAUNCHES
    out = ops.flash_attention(q, k, v, impl="cuda")
    assert fa.LAUNCHES - before == 1
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert fa.LAUNCHES - before == 1
    want_out = ops.flash_attention(q, k, v, impl="ref")
    want = torch.autograd.grad(want_out, (q, k, v), g)
    assert _err(out, want_out) <= tol
    for a, b in zip(got, want):
        assert _err(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
def test_cuda_scan_under_autograd(dtype, tol):
    _needs_cuda()
    leaves, args = _scan_inputs(dtype, "cuda", B=2, S=96, di=256, N=16)
    before = ms.LAUNCHES
    y, hf = ops.selective_scan(*args, impl="cuda")
    assert ms.LAUNCHES - before == 1
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, gy)
    assert ms.LAUNCHES - before == 1
    want_y, _ = ops.selective_scan(*args, impl="ref")
    want = torch.autograd.grad(want_y, leaves, gy)
    assert _err(y, want_y) <= tol
    for a, b in zip(got, want):
        assert _err(a, b) <= tol
