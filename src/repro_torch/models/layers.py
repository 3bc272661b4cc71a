"""Core transformer layers: norms, RoPE, GQA attention, MLPs, embeddings.

Counterpart of ``src/repro/models/layers.py``, as ``nn.Module``s.  Weights
keep the reference's layouts -- wq (D, Hq, hd), wo (Hq, hd, D) -- so
carrying JAX weights across is a copy.  Attention routes through
:func:`repro_torch.kernels.ops.flash_attention` (the CUDA kernel on the
card, the plain version on the CPU); the projections are plain
``einsum``s, as the reference left them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ModelConfig
from .module import TensorSpec, dense_init_, empty_param

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, d) with even d; positions: (S,).

    Half-split rotation (the first half of the head dim against the
    second, not interleaved pairs), angles in fp32, as the reference.
    """
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.float()[..., None] * freqs            # (S, half)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (self, with optional KV cache)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA self-attention.  Cross-attention (encoder-decoder, VLM) is not
    ported yet; :func:`repro_torch.models.build_model` refuses configs
    that need it."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = empty_param((D, Hq, hd), device, dtype)
        self.wk = empty_param((D, Hkv, hd), device, dtype)
        self.wv = empty_param((D, Hkv, hd), device, dtype)
        self.wo = empty_param((Hq, hd, D), device, dtype)
        if cfg.qkv_bias:
            self.bq = empty_param((Hq, hd), device, dtype)
            self.bk = empty_param((Hkv, hd), device, dtype)
            self.bv = empty_param((Hkv, hd), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        Hq, hd = self.cfg.n_heads, self.cfg.head_dim
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, gen)
        dense_init_(self.wo, gen, scale=1.0 / math.sqrt(Hq * hd))
        if self.cfg.qkv_bias:
            with torch.no_grad():
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()

    def forward(self, x: torch.Tensor, *, cache: Optional[Cache],
                pos: int = 0, causal: bool = True,
                impl: Optional[str] = None) -> torch.Tensor:
        """x: (B, S, D) -> out (B, S, D).

        cache: {"k", "v"}: (B, S_max, Hkv, hd); ``pos`` (a host integer)
        is the absolute position of x[0].  The new keys and values are
        written into the cache **in place** at ``pos`` (slice
        assignment).  Prefill (S > 1) attends over the fresh keys; decode
        (S == 1) over the cache with ``kv_len = pos + 1``.  ``cache=None``
        is the training forward: no cache, the fresh keys only, under
        autograd.
        """
        S = x.shape[1]
        q = torch.einsum("bsd,dhk->bshk", x, self.wq)
        k = torch.einsum("bsd,dhk->bshk", x, self.wk)
        v = torch.einsum("bsd,dhk->bshk", x, self.wv)
        if self.cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        positions = pos + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        if cache is None:
            out = ops.flash_attention(q, k, v, causal=causal, q_offset=pos,
                                      impl=impl)
            return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), self.wo)

        s_max = cache["k"].shape[1]
        if pos < 0 or pos + S > s_max:
            raise ValueError(f"attention: positions {pos}..{pos + S - 1} "
                             f"do not fit a cache of {s_max} slots")
        cache["k"][:, pos:pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + S] = v.to(cache["v"].dtype)
        if S == 1:
            out = ops.flash_attention(q, cache["k"], cache["v"], causal=False,
                                      kv_len=pos + 1, impl=impl)
        else:
            out = ops.flash_attention(q, k, v, causal=causal, q_offset=0,
                                      impl=impl)
        return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), self.wo)


def attn_cache_spec(cfg: ModelConfig, batch: int, s_max: int,
                    dtype: torch.dtype) -> Dict[str, TensorSpec]:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU MLP (``act="silu"``, every config the port serves)."""

    def __init__(self, cfg: ModelConfig, width: int, device=None,
                 dtype=None):
        super().__init__()
        D = cfg.d_model
        self.wg = empty_param((D, width), device, dtype)
        self.wu = empty_param((D, width), device, dtype)
        self.wd = empty_param((width, D), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wg, self.wu, self.wd):
            dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the gate runs in fp32 and rounds once, where XLA's fusion does
        gate = F.silu((x @ self.wg).float()) * (x @ self.wu).float()
        return gate.to(x.dtype) @ self.wd


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)
