"""Mixture-of-Experts layer: token-choice top-k routing, sort-based dispatch.

Counterpart of ``src/repro/models/moe.py``.  Tokens are
ranked into per-expert capacity slots with a stable argsort over their
expert assignments (a token whose rank within its expert reaches the
capacity is dropped; each batch row is a dispatch group), gathered once
into an (E, B*C, D) buffer, run through the experts as one batched GEMM
a projection over it -- each expert's weights are read once a call
whatever B is -- and combined back with their gate weights.

On a mesh (a step's ``parallel.context`` scope) each rank holds its
batch groups and, where the experts divide the "model" axis, its block
of E/tp experts.  ``moe_buffer_mode`` "shard_map", "ep", "ep_local" and
"dp" all dispatch to the local experts alone (:func:`moe_shard_map`, the
reference's explicit EP) and sum the (B_l, S, D) partials once over
"model", in fp32: a token's rank within its expert does not depend on
the other experts, so ranking every expert's slots and keeping the local
block, as the reference's GSPMD layouts do, gives the same slots.
"none" (and experts that do not divide the axis) gathers every expert
and runs the one-device layer on the local batch.  Every mode is the
same function.  The aux losses are the global batch's.

Under sequence parallelism the layer's input shards are all-gathered
along the sequence first (``context.enter_sublayer``): the router, the
capacity and the drops are the whole sequence's, as without it (routing
a shard would change C).  The split modes' partials are reduce-scattered
back to the shards; "none" keeps the rank's positions of its output.
The router runs alike on every rank and its aux losses are every rank's,
so its gradient reaches the gathered input at the rank's own positions
alone (``context.replicated``) and its gate weights enter the experts'
computation summed over "model" (``context.enter_split``).

Gradients flow through the top-k values, the gathers and the combine
weights; the integer paths carry none, and a dropped slot has weight 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import context
from .config import ModelConfig
from .layers import MLP
from .module import dense_init_, empty_param

Aux = Dict[str, torch.Tensor]


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    """Per-group (batch-row) expert capacity, padded to a multiple of 8."""
    ideal = cfg.top_k * seq / cfg.n_experts * cfg.capacity_factor
    cap = max(cfg.top_k, int(-(-ideal // 1)))
    return min(-(-cap // 8) * 8, cfg.top_k * seq)


def _slots(top_idx: torch.Tensor, top_w: torch.Tensor, e_lo: int,
           n_local: int, capacity: int,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of every group (batch row) to the experts
    ``[e_lo, e_lo + n_local)``; assignments outside them are dropped.

    top_idx/top_w: (B, S, k).  Returns tok_slot (B, E*C) int32, w_slot
    (B, E*C) and slot_of (B, S, k): tok_slot[b, i] is the source token of
    slot i (S for an empty slot), w_slot its gate weight (0 when empty),
    slot_of the slot of each assignment (E*C when dropped), with E =
    n_local and C = capacity.  Slots past the last are written into one
    sentinel column that is cut off, where the reference's scatter drops
    them.
    """
    B, S, k = top_idx.shape
    n_slots = n_local * capacity
    top_idx = top_idx.long()
    in_range = (top_idx >= e_lo) & (top_idx < e_lo + n_local)
    eid = torch.where(in_range, top_idx - e_lo, n_local).reshape(B, S * k)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_sorted = torch.gather(eid, 1, order)
    experts = torch.arange(n_local, device=eid.device).expand(B, n_local)
    starts = torch.searchsorted(eid_sorted, experts.contiguous(),
                                side="left")                    # (B, E)
    rank = torch.arange(S * k, device=eid.device) - torch.gather(
        starts, 1, eid_sorted.clamp(max=n_local - 1))
    valid = (eid_sorted < n_local) & (rank < capacity)
    slot_sorted = torch.where(valid, eid_sorted * capacity + rank, n_slots)
    tok_sorted = order // k
    tok_slot = torch.full((B, n_slots + 1), S, dtype=torch.int32,
                          device=eid.device).scatter_(
        1, slot_sorted, tok_sorted.to(torch.int32))[:, :n_slots]
    w_sorted = torch.gather(top_w.reshape(B, S * k), 1, order)
    w_slot = torch.zeros((B, n_slots + 1), dtype=top_w.dtype,
                         device=eid.device).scatter(
        1, slot_sorted, torch.where(valid, w_sorted, 0.0))[:, :n_slots]
    slot_of = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    return tok_slot, w_slot, slot_of.reshape(B, S, k)


def _gather(x: torch.Tensor, tok_slot: torch.Tensor) -> torch.Tensor:
    """The slots' tokens, zeros for an empty slot: x (B, S, D) and
    tok_slot (..., B, n) -> (..., B, n, D)."""
    B, S, D = x.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    rows = torch.arange(B, device=x.device)[:, None]
    return x_pad[rows, tok_slot.long()]


def _dispatch_one_group(x: torch.Tensor, top_idx: torch.Tensor,
                        top_w: torch.Tensor, n_experts: int, capacity: int,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's per-group dispatch, batched over the groups:
    (buffer (B, E*C, D), tok_slot (B, E*C), w_slot (B, E*C))."""
    return _dispatch_local_experts(x, top_idx, top_w, 0, n_experts,
                                   capacity)


def _dispatch_local_experts(x: torch.Tensor, top_idx: torch.Tensor,
                            top_w: torch.Tensor, e_lo: int, n_local: int,
                            capacity: int,
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Dispatch to the local expert slice ``[e_lo, e_lo + n_local)`` (one
    device's share under expert parallelism); assignments outside it are
    dropped here, as the device owning them handles them."""
    tok_slot, w_slot, _ = _slots(top_idx, top_w, e_lo, n_local, capacity)
    return _gather(x, tok_slot), tok_slot, w_slot


class MoE(nn.Module):
    """Token-choice top-k MoE with SwiGLU experts, an optional shared
    expert (kimi) and an optional dense residual MLP (arctic).  The
    router is float32 whatever the model's dtype, as the reference's."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        self.cfg = cfg
        self.router = empty_param((D, E), device, torch.float32)
        self.wg = empty_param((E, D, Fe), device, dtype)
        self.wu = empty_param((E, D, Fe), device, dtype)
        self.wd = empty_param((E, Fe, D), device, dtype)
        if cfg.n_shared_experts > 0:
            self.shared = MLP(cfg, cfg.n_shared_experts * Fe, device, dtype)
        if cfg.dense_residual:
            self.dense = MLP(cfg, cfg.d_ff, device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The router and the experts (the shared and dense MLPs reset
        themselves).  An expert at a time: at full width one projection's
        float32 draw is the size of all the model's weights in bf16."""
        dense_init_(self.router, gen)
        for w in (self.wg, self.wu, self.wd):
            for e in range(w.shape[0]):
                dense_init_(w[e], gen)

    def route(self, x: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
        """fp32 router logits and probabilities (B, S, E), and each
        token's top-k weights, normalised, and experts (B, S, k)."""
        logits = torch.einsum("bsd,de->bse", x.float(),
                              context.full(self, "router"))
        probs = torch.softmax(logits, dim=-1)
        top_w, top_idx = torch.topk(probs, self.cfg.top_k, dim=-1)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, top_w, top_idx

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Aux]:
        """x: (B, S, D) -> (y (B, S, D), aux losses)."""
        E, k = self.cfg.n_experts, self.cfg.top_k
        sc = context.current()
        split = not (sc is None or sc.pcfg.moe_buffer_mode == "none"
                     or E % sc.tp.size)
        xw, xs = context.enter_sublayer(x, split)
        B, S, D = xw.shape
        C = moe_capacity(self.cfg, S)
        logits, probs, top_w, top_idx = self.route(context.replicated(xw))
        ce = context.batch_mean(F.one_hot(top_idx[..., 0], E).float().mean(
            (0, 1)))
        aux = {"moe_load_balance": E * torch.sum(
                   context.batch_mean(probs.mean((0, 1))) * ce),
               "moe_z_loss": context.batch_mean(torch.mean(
                   torch.logsumexp(logits, -1) ** 2))}

        if not split:
            w = {n: context.full(self, n, partial=True)
                 for n in ("wg", "wu", "wd")}
            tw = context.enter_split(top_w) if context.sharded() else top_w
            tok_slot, w_slot, slot_of = _slots(top_idx, tw, 0, E, C)
            # gathered straight into the experts' (E, B*C, D) layout
            buf = _gather(xw, tok_slot.view(B, E, C).transpose(0, 1))
            y = context.leave_sublayer(_combine(
                xw, buf.reshape(E, B * C, D), w, w_slot, slot_of, E,
                C).to(x.dtype), False)
            n_routed = torch.sum((tok_slot < S).float())
        else:
            y, n_routed = moe_shard_map(self, xs, top_idx, top_w, sc.tp.rank,
                                        sc.tp.size)
        if self.cfg.n_shared_experts > 0:
            y = y + self.shared(x)
        if self.cfg.dense_residual:
            y = y + self.dense(x)
        aux["moe_drop_fraction"] = 1.0 - context.batch_mean(n_routed) \
            / (B * S * k)
        return y, aux


def _combine(x: torch.Tensor, buf: torch.Tensor,
             w: Dict[str, torch.Tensor], w_slot: torch.Tensor,
             slot_of: torch.Tensor, n_local: int, C: int) -> torch.Tensor:
    """``n_local`` experts, weights ``w``, on their (n_local, B*C, D) slot
    buffer, combined back into each token's fp32 sum (B, S, D): each
    token's slots in ascending slot order (the order in which the
    reference's scatter-add applies them), gathered from the (E, B, C)
    layout and weighted.  ``slot_of`` (B, S, k) holds each assignment's
    slot in the local experts' layout (outside ``[0, n_local * C)``:
    dropped, or another rank's) and ``w_slot`` (B, n_local * C) the gate
    weight of each local slot."""
    B, S, D = x.shape
    k = slot_of.shape[-1]
    # the gate runs in fp32 and rounds once, as the dense MLP's
    gate = F.silu(torch.bmm(buf, w["wg"]).float()) \
        * torch.bmm(buf, w["wu"]).float()
    y_buf = torch.bmm(gate.to(x.dtype), w["wd"]).reshape(n_local * B * C, D)

    slots = torch.sort(slot_of, dim=-1).values                # (B, S, k)
    kept = (slots >= 0) & (slots < n_local * C)
    b = torch.arange(B, device=x.device)[:, None, None]
    rows = torch.where(kept, slots // C * (B * C) + b * C + slots % C, 0)
    wt = torch.gather(w_slot, 1, slots.clamp(0, n_local * C - 1).reshape(
        B, S * k)).reshape(B, S, k).to(x.dtype).float()
    y = None
    for j in range(k):
        part = torch.where(kept[..., j, None],
                           y_buf[rows[..., j]].float() * wt[..., j, None],
                           0.0)
        y = part if y is None else y + part
    return y


def _expert_weights(moe: MoE, r: int, n: int) -> Dict[str, torch.Tensor]:
    """Rank ``r`` of ``n``'s block of the experts' weights, gathered over
    the FSDP axes."""
    ranges = context.ranges_of(r, n, moe.cfg.n_experts)
    return {name: context.part(moe, name, 0, ranges)
            for name in ("wg", "wu", "wd")}


def moe_shard_map(moe: MoE, xs: torch.Tensor, top_idx: torch.Tensor,
                  top_w: torch.Tensor, r: int, n: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert parallelism, the reference's ``moe_shard_map``:
    rank ``r`` of ``n`` on "model" holds experts ``[r * E/n, (r+1) *
    E/n)`` and its batch groups' tokens ``xs`` (the layer's input
    entering the split: replicated over "model", or gathered along the
    sequence under SP); it ranks the tokens into its own experts' slots
    alone (the local dispatch of :func:`_dispatch_local_experts`, ``e_lo
    = r * E/n``), runs them with their weights all-gathered over the FSDP
    axes, and the (B_l, S, D) partials are summed once over "model" in
    fp32 (``context.leave_sublayer``).  Returns the output and the routed
    count over every expert."""
    B, S, D = xs.shape
    E = moe.cfg.n_experts
    C = moe_capacity(moe.cfg, S)
    E_l = E // n
    tw = context.enter_split(top_w)
    tok_slot, w_slot, slot_of = _slots(top_idx, tw, r * E_l, E_l, C)
    buf = _gather(xs, tok_slot.view(B, E_l, C).transpose(0, 1))
    y = _combine(xs, buf.reshape(E_l, B * C, D), _expert_weights(moe, r, n),
                 w_slot, slot_of, E_l, C)
    routed = context.leave_split(torch.sum((tok_slot < S).float()))
    return context.leave_sublayer(y, True).to(xs.dtype), routed

