"""Mamba-1 selective state-space block.

Counterpart of ``src/repro/models/ssm.py``.  Structure (falcon-mamba /
jamba SSM layers):

    x, z = in_proj(u)                   # (B, S, di) each, di = expand*D
    x    = silu(causal_conv1d(x))       # depthwise, width ssm_conv
    dt, B, C = x_proj(x)                # dt via low-rank + softplus
    y    = selective_scan(x, dt, A, B, C) + D * x
    out  = out_proj(y * silu(z))

Prefill runs the scan through :func:`repro_torch.kernels.ops.selective_scan`
(the CUDA kernel on the card); decode keeps a (conv window, ssm state)
cache and takes one plain step a token.

On a mesh whose "model" axis divides ``d_inner``, each rank keeps its
block of the channels (the conv, the scan and the gate are per channel,
so the scan kernel runs on the local channels) and the two products
that sum over them, ``x_proj`` and ``out_proj``, are summed in float32:
``x_proj``'s all-reduced, ``out_proj``'s the block's exit
(``context.leave_sublayer``: reduce-scattered along the sequence under
sequence parallelism, whose gathered input gives the conv and the scan
the whole sequence); off a mesh the weights are the module's own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..parallel import context
from .config import ModelConfig
from .module import TensorSpec, dense_init_, empty_param

Cache = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it.

    ``torch.nn.functional.softplus`` returns x itself above its
    ``threshold=20``; JAX does not, so the port writes it out.
    """
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 window: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv via shifted adds. x (B,S,di), w (W,di), the
    previous inputs ``window`` (B,W-1,di).

    Returns the output in fp32 and the padded input ``(B, S+W-1, di)``,
    whose last W-1 rows are the next conv window.
    """
    W = w.shape[0]
    xp = torch.cat([window.to(x.dtype), x], dim=1)         # (B, S+W-1, di)
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S, :].float() * w[i].float()
    return out + b.float(), xp


def mamba_cache_spec(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     ) -> Dict[str, TensorSpec]:
    return {
        "conv": TensorSpec((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype),
        "ssm": TensorSpec((batch, cfg.d_inner, cfg.ssm_state), dtype),
    }


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        D, di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        W = cfg.ssm_conv
        self.cfg = cfg
        self.in_proj = empty_param((D, 2 * di), device, dtype)
        self.conv_w = empty_param((W, di), device, dtype)
        self.conv_b = empty_param((di,), device, dtype)
        self.x_proj = empty_param((di, R + 2 * N), device, dtype)
        self.dt_w = empty_param((R, di), device, dtype)
        self.dt_b = empty_param((di,), device, dtype)
        self.A_log = empty_param((di, N), device, torch.float32)
        self.D = empty_param((di,), device, torch.float32)
        self.out_proj = empty_param((di, D), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        dense_init_(self.in_proj, gen)
        dense_init_(self.conv_w, gen, scale=1.0 / math.sqrt(cfg.ssm_conv))
        dense_init_(self.x_proj, gen)
        dense_init_(self.dt_w, gen)
        dense_init_(self.out_proj, gen, scale=1.0 / math.sqrt(cfg.d_inner))
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_b.fill_(-4.6)                          # softplus^-1(0.01)
            # S4D-real initialization: A = -(1..N) for every channel
            n = torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32,
                             device=self.A_log.device)
            self.A_log.copy_(torch.log(n).expand(cfg.d_inner, -1))
            self.D.fill_(1.0)

    def forward(self, u: torch.Tensor, *, cache: Optional[Cache],
                impl: Optional[str] = None) -> torch.Tensor:
        """u: (B, S, D) -> out (B, S, D).

        cache: {"conv": (B, W-1, di), "ssm": (B, di, N)}, both fp32,
        overwritten **in place** with the state after the last token.  S > 1
        is a prefill from the cached state, S == 1 a decode step.  The
        conv window holds the pre-conv x.  ``cache=None`` is the training
        forward: the conv causal over the sequence from a zero window, the
        scan from a zero state, nothing written, under autograd.

        The elementwise chains between two products (conv + silu, the dt
        softplus, the D skip and the z gate) run in fp32 and round to the
        model's dtype once at their end, where XLA's fusions round too.
        """
        R, N, di = self.cfg.dt_rank, self.cfg.ssm_state, self.cfg.d_inner
        split = context.tp_split(di)
        w = self._weights(split)
        _, us = context.enter_sublayer(u, split is not None)

        def summed(eq, a, b, last=False):
            """A product over the channels (``eq`` None: a matmul):
            whole, or this rank's channels' partial sum, summed over
            "model" in fp32; ``last``: the block's output."""
            if split is None:
                y = a @ b if eq is None else torch.einsum(eq, a, b)
                return context.leave_sublayer(y, False) if last else y
            a32, b32 = a.float(), b.float()
            part = a32 @ b32 if eq is None else torch.einsum(eq, a32, b32)
            part = (context.leave_sublayer(part, True) if last
                    else context.leave_split(part))
            return part.to(a.dtype)

        def enter(*ts):
            return ts if split is None else tuple(context.enter_split(t)
                                                  for t in ts)

        xz = torch.einsum("bsd,de->bse", us, w["in_proj"])
        x, z = xz.chunk(2, dim=-1)                         # (B, S, di)
        A = -torch.exp(w["A_log"])                         # (di, N) fp32

        if cache is None:
            W = self.cfg.ssm_conv
            window = torch.zeros((u.shape[0], W - 1, x.shape[-1]),
                                 dtype=x.dtype, device=x.device)
            xc, _ = _causal_conv(x, w["conv_w"], w["conv_b"], window)
            xc = F.silu(xc).to(u.dtype)
            dbc = summed("bsd,de->bse", xc, w["x_proj"])
            dt_low, Bm, Cm = enter(*torch.split(dbc, [R, N, N], dim=-1))
            dt = softplus(torch.einsum("bsr,rd->bsd", dt_low,
                                       w["dt_w"]).float()
                          + w["dt_b"].float()).to(u.dtype)
            y, _ = ops.selective_scan(xc, dt, A, Bm, Cm, None, impl=impl)
        elif us.shape[1] == 1:
            # ---- decode step: conv from the cached window, one scan step
            window = torch.cat([cache["conv"], x.to(cache["conv"].dtype)],
                               dim=1)                      # (B, W, di)
            xc = (torch.einsum("bwd,wd->bd", window.float(),
                               w["conv_w"].float()) + w["conv_b"].float())
            xc = F.silu(xc).to(u.dtype)                    # (B, di)
            dbc = summed(None, xc, w["x_proj"])
            dt_low, Bm, Cm = enter(*torch.split(dbc, [R, N, N], dim=-1))
            dt = softplus((dt_low @ w["dt_w"]).float()
                          + w["dt_b"].float()).to(u.dtype)
            y, h_new = ops.selective_scan_step(xc, dt, A, Bm, Cm,
                                               cache["ssm"])
            cache["conv"].copy_(window[:, 1:])
            cache["ssm"].copy_(h_new)
            y, xc = y[:, None, :], xc[:, None, :]
        else:
            # ---- prefill ----
            xc, xp = _causal_conv(x, w["conv_w"], w["conv_b"],
                                  cache["conv"])
            xc = F.silu(xc).to(u.dtype)
            dbc = summed("bsd,de->bse", xc, w["x_proj"])
            dt_low, Bm, Cm = enter(*torch.split(dbc, [R, N, N], dim=-1))
            dt = softplus(torch.einsum("bsr,rd->bsd", dt_low,
                                       w["dt_w"]).float()
                          + w["dt_b"].float()).to(u.dtype)
            y, h_final = ops.selective_scan(xc, dt, A, Bm, Cm, cache["ssm"],
                                            impl=impl)
            W = self.cfg.ssm_conv
            cache["conv"].copy_(xp[:, xp.shape[1] - (W - 1):])
            cache["ssm"].copy_(h_final)

        out = ((y.float() + xc.float() * w["D"]) * F.silu(z.float())
               ).to(u.dtype)
        return summed("bse,ed->bsd", out, w["out_proj"], last=True)

    #: parameter -> the dimension of its d_inner channels
    _CHANNEL_DIM = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
                    "dt_w": 1, "dt_b": 0, "A_log": 0, "D": 0, "out_proj": 0}

    def _weights(self, split) -> Dict[str, torch.Tensor]:
        """The weights this rank computes with: whole (``split`` None),
        or its block of the channels (``in_proj``'s x and z halves
        each)."""
        if split is None:
            return {n: context.full(self, n, partial=True)
                    for n in self._CHANNEL_DIM}
        di = self.cfg.d_inner
        out = {}
        for n, dim in self._CHANNEL_DIM.items():
            offsets = (0, di) if n == "in_proj" else (0,)
            out[n] = context.part(self, n, dim,
                                  context.ranges_of(*split, di, offsets))
        return out
