"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the yardstick the hand-written
CUDA kernels are held against on the card.  Counterpart of
``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: the reference's finite mask value: a masked score is -1e30, not -inf,
#: so a fully masked row softmaxes to uniform weights as in JAX
NEG_INF = -1e30


def event_race_ref(rates: torch.Tensor, residuals: torch.Tensor,
                   u_time: torch.Tensor, u_pick: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Race K_exp exponential clocks against K_det deterministic timers.

    rates:     (R, K_exp) propensities (0 = clock off)
    residuals: (R, K_det) remaining deterministic times (+inf = off)
    u_time, u_pick: (R,) uniforms in (0, 1)

    Returns ``(dt (R,) float32, event (R,) int32)``: ``event < K_exp``
    indexes the winning exponential family (inverse-CDF pick of
    ``u_pick`` over the rate cumsum; ties ``t_exp <= t_det`` go to the
    exponential side), ``event >= K_exp`` is ``K_exp + argmin`` of the
    residuals (first lane on ties; an all-+inf row gives lane 0).

    The sum and the cumsum run lane by lane in order, so the result is
    the same on every device and matches the CUDA kernel
    (``csrc/event_race.cu``) bit for bit in the pick.

    >>> rates = torch.zeros((1, 2))
    >>> resid = torch.tensor([[3.0, 1.5]])
    >>> u = torch.tensor([0.5])
    >>> dt, ev = event_race_ref(rates, resid, u, u)
    >>> float(dt[0]), int(ev[0])
    (1.5, 3)
    """
    k_exp = rates.shape[-1]
    cum = []
    acc = rates[:, 0]
    cum.append(acc)
    for j in range(1, k_exp):
        acc = acc + rates[:, j]
        cum.append(acc)
    total = acc
    safe_total = total.clamp_min(1e-30)
    t_exp = -torch.log(u_time) / safe_total
    t_exp = torch.where(total > 0, t_exp, torch.inf)

    cdf = torch.stack(cum, dim=-1) / safe_total[:, None]
    pick_exp = (u_pick[:, None] >= cdf).sum(-1)
    pick_exp = pick_exp.clamp_max(k_exp - 1).to(torch.int32)

    t_det, arg = residuals.min(-1)
    pick_det = arg.to(torch.int32) + k_exp

    dt = torch.minimum(t_exp, t_det)
    event = torch.where(t_exp <= t_det, pick_exp, pick_det)
    return dt, event


# ---------------------------------------------------------------------------
# attention (GQA, causal/full, optional kv-length mask)
# ---------------------------------------------------------------------------

def _attn_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_pos: torch.Tensor, k_pos: torch.Tensor,
                kv_len: Optional[int], return_lse: bool = False):
    """Full-materialization attention for one query block.

    q: (B, Sq, Hkv, G, d), k/v: (B, Sk, Hkv, d) -> (B, Sq, Hkv, G, d) fp32
    (with ``return_lse``, and each row's log-sum-exp of its scores
    (B, Sq, Hkv, G) fp32).
    """
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]           # (Sq, Sk)
    if kv_len is not None:
        len_mask = k_pos[None, :] < kv_len                 # (1, Sk)
        mask = len_mask if mask is None else (mask & len_mask)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, -1).permute(0, 3, 1, 2)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  q_block: Optional[int] = None, return_lse: bool = False):
    """Grouped-query attention, math in fp32, output in q's dtype.

    q: (B, Sq, Hq, d); k/v: (B, Sk, Hkv, d); Hq % Hkv == 0 (GQA by a
    reshape of the query heads, no copies of k/v).  ``q_offset``: absolute
    position of q[0]; ``kv_len``: keys at positions >= kv_len are masked.
    Masked scores are the finite :data:`NEG_INF`.  ``q_block``: if set,
    smaller than Sq and a divisor of it, queries go through in blocks of
    that size (memory O(q_block * Sk) instead of O(Sq * Sk)), as in the
    reference.  ``return_lse``: also each query row's log-sum-exp of its
    scaled, masked scores, (B, Sq, Hq) fp32 -- what the kernel writes on
    request.
    """
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"attention_ref: {Hq} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, d)
    k_pos = torch.arange(Sk, device=q.device)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    if q_block is None or Sq <= q_block or Sq % q_block:
        blocks = [(qg, q_pos)]
    else:
        blocks = [(qg[:, i:i + q_block], q_pos[i:i + q_block])
                  for i in range(0, Sq, q_block)]
    parts = [_attn_block(qb, k, v, causal=causal, q_pos=pb, k_pos=k_pos,
                         kv_len=kv_len, return_lse=return_lse)
             for qb, pb in blocks]
    if return_lse:
        out = torch.cat([o for o, _ in parts], dim=1)
        lse = torch.cat([l for _, l in parts], dim=1)
        return (out.reshape(B, Sq, Hq, d).to(q.dtype),
                lse.reshape(B, Sq, Hq))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return out.reshape(B, Sq, Hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# mamba selective scan
# ---------------------------------------------------------------------------

def selective_scan_step_ref(x_t: torch.Tensor, dt_t: torch.Tensor,
                            A: torch.Tensor, B_t: torch.Tensor,
                            C_t: torch.Tensor, h: torch.Tensor,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: x_t/dt_t (B, di); B_t/C_t (B, N); h (B, di, N) fp32.

    Returns ``(y_t (B, di) in x_t's dtype, h_new (B, di, N) fp32)``.
    """
    dtf = dt_t.float()
    decay = torch.exp(dtf[..., None] * A.float()[None])
    drive = (dtf * x_t.float())[..., None] * B_t.float()[:, None, :]
    h_new = decay * h + drive
    y = (h_new * C_t.float()[:, None, :]).sum(-1)
    return y.to(x_t.dtype), h_new


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bmat: torch.Tensor, Cmat: torch.Tensor,
                       h0: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan, a loop over time in fp32.

    x, dt: (B, S, di); A: (di, N); Bmat, Cmat: (B, S, N); h0 (B, di, N).
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t,
    y_t = (h_t * C_t).sum(N).  Returns ``(y (B, S, di) in x's dtype,
    h_final (B, di, N) fp32)``.
    """
    Bsz, S, di = x.shape
    h = (torch.zeros((Bsz, di, A.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        y_t, h = selective_scan_step_ref(x[:, t].float(), dt[:, t], A,
                                         Bmat[:, t], Cmat[:, t], h)
        ys.append(y_t)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, di), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), h
