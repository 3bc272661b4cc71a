"""Kernel dispatch of the port: the device picks a kernel or its plain twin.

Counterpart of ``src/repro/kernels/ops.py``.  Every entry point takes
``impl``: ``None`` chooses by the tensors' device -- the CUDA kernel for
CUDA tensors, the plain PyTorch version in :mod:`.ref` for CPU tensors;
``"ref"`` forces the plain version on any device; ``"cuda"`` forces the
kernel and raises for CPU tensors.  On a CUDA tensor the kernel launches
or raises: no shape, offset or length gives way to the plain version
(the JAX ``ops`` fell back to its reference for traced offsets and
shapes that did not divide its blocks; these kernels take runtime
offsets and any shape).

Gradients: where the kernel is taken, :func:`flash_attention` and
:func:`selective_scan` are ``torch.autograd.Function``s, as the JAX
``ops`` wraps its Pallas calls in ``jax.custom_vjp``: the forward is the
CUDA kernel (one launch a call), and the backward recomputes the plain
version (:mod:`.ref`) on the saved inputs under ``torch.enable_grad()``
and takes ``torch.autograd.grad`` through it, launching no kernel.  The
plain path is plain autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import des_step, flash_attention as _attn, mamba_scan as _scan, ref

#: accepted ``impl`` values of every entry point
IMPLS = (None, "ref", "cuda")


def _use_kernel(name: str, impl: Optional[str], t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"{name} impl={impl!r} must be None, 'ref' or "
                         "'cuda'")
    on_cuda = t.device.type == "cuda"
    if impl == "cuda" and not on_cuda:
        raise ValueError(
            f"{name} impl='cuda' needs CUDA tensors (got tensors on "
            f"{t.device}); use impl='ref' or impl=None for the plain "
            f"PyTorch version on the CPU")
    return impl != "ref" and on_cuda


def event_race(rates: torch.Tensor, residuals: torch.Tensor,
               u_time: torch.Tensor, u_pick: torch.Tensor, *,
               impl: Optional[str] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-event race; see ``csrc/event_race.cu`` for what it computes.

    Zero-width lane blocks are refused on every path.  With all rates
    zero the deterministic side wins and the event index is
    ``K_exp + argmin(residuals)``:

    >>> rates = torch.zeros((1, 2))
    >>> resid = torch.tensor([[3.0, 1.5]])
    >>> u = torch.tensor([0.5])
    >>> dt, ev = event_race(rates, resid, u, u)
    >>> float(dt[0]), int(ev[0])
    (1.5, 3)
    """
    use_kernel = _use_kernel("event_race", impl, rates)
    k_exp, k_det = rates.shape[-1], residuals.shape[-1]
    if k_exp == 0 or k_det == 0:
        raise ValueError(
            f"event_race needs at least one exponential and one "
            f"deterministic lane (got K_exp={k_exp}, K_det={k_det}); a "
            f"zero-width lane block has no next event to race -- disable "
            f"the empty side with zero rates / +inf residuals instead")
    if not use_kernel:
        return ref.event_race_ref(rates, residuals, u_time, u_pick)
    return des_step.event_race_cuda(rates, residuals, u_time, u_pick)


class _AttentionFn(torch.autograd.Function):
    """The attention kernel forward, the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len, return_lse):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, q_offset, kv_len)
        # the kernel reads a contiguous head dim and, in bfloat16, rows on
        # 16 bytes: a projection's view may be neither
        if not return_lse:
            return _attn.flash_attention_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal, q_offset=q_offset, kv_len=kv_len)
        out, lse = _attn.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            q_offset=q_offset, kv_len=kv_len, return_lse=True)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, *_):
        causal, q_offset, kv_len = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.attention_ref(*inputs, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len)
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None, None)


class _ScanFn(torch.autograd.Function):
    """The scan kernel forward, the plain version's gradient (all six
    inputs, ``h0`` included)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, h0):
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, h0)
        return _scan.selective_scan_cuda(x, dt, A, Bmat, Cmat, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ref.selective_scan_ref(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (g_y, g_h)) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs], inputs,
                                   [g for _, g in pairs])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    impl: Optional[str] = None, return_lse: bool = False):
    """GQA attention. q (B,Sq,Hq,d), k/v (B,Sk,Hkv,d) -> (B,Sq,Hq,d).

    See ``csrc/flash_attention.cu`` for what it computes.  ``q_offset``
    and ``kv_len`` are host integers; ``kv_len < 1`` and a negative
    ``q_offset`` are refused on every path (no query row may be left
    without a key).  Differentiable on both paths: the kernel path's
    backward is the plain version's, recomputed from q, k and v.

    q, k and v may differ in dtype (a training cross-attention's bf16
    queries over float32 encoder states): the math runs in their
    promoted type and the output is in q's, as in the plain version (the
    kernel takes one dtype, so its inputs are cast first).

    ``return_lse``: also return each query row's log-sum-exp of its
    visible scaled scores, (B, Sq, Hq) float32, which the kernel writes
    in the same launch (it carries no gradient): partial attentions over
    disjoint blocks of keys combine by these weights.
    """
    use_kernel = _use_kernel("flash_attention", impl, q)
    q_offset = int(q_offset)
    kv_len = None if kv_len is None else int(kv_len)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if kv_len is not None and kv_len < 1:
        raise ValueError(f"flash_attention: kv_len {kv_len} < 1 would leave "
                         "every query row without a key")
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len, return_lse=return_lse)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = _AttentionFn.apply(q.to(dt), k.to(dt), v.to(dt), causal, q_offset,
                             kv_len, return_lse)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   impl: Optional[str] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba scan. x/dt (B,S,di), A (di,N), B/C (B,S,N), h0 (B,di,N).

    Returns ``(y (B, S, di) in x's dtype, h_final (B, di, N) float32)``;
    see ``csrc/mamba_scan.cu`` for what it computes.  Differentiable on
    both paths: the kernel path's backward is the plain version's,
    recomputed from the six inputs (``h0`` as zeros when None).
    """
    if not _use_kernel("selective_scan", impl, x):
        return ref.selective_scan_ref(x, dt, A, Bmat, Cmat, h0)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2], A.shape[-1]),
                         dtype=torch.float32, device=x.device)
    return _ScanFn.apply(x, dt, A, Bmat, Cmat, h0)


def selective_scan_step(x_t: torch.Tensor, dt_t: torch.Tensor,
                        A: torch.Tensor, B_t: torch.Tensor,
                        C_t: torch.Tensor, h: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the scan: plain PyTorch on every device, as in
    the reference (it has no TPU kernel either)."""
    return ref.selective_scan_step_ref(x_t, dt_t, A, B_t, C_t, h)
