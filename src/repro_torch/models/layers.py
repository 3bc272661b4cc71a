"""Core transformer layers: norms, RoPE, GQA attention, MLPs, embeddings.

Counterpart of ``src/repro/models/layers.py``, as ``nn.Module``s.  Weights
keep the reference's layouts -- wq (D, Hq, hd), wo (Hq, hd, D) -- so
carrying JAX weights across is a copy.  Attention routes through
:func:`repro_torch.kernels.ops.flash_attention` (the CUDA kernel on the
card, the plain version on the CPU); the projections are plain
``einsum``s, as the reference left them to XLA.

Mixed dtypes promote as JAX promotes them: a projection of float32
activations (an encoder fed float32 frames) by bf16 weights runs in
float32 (:func:`promoted_einsum`), where ``torch.einsum`` would refuse
the pair.
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


def promoted_einsum(eq: str, x: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the result type of ``x`` and ``w``, as
    ``jnp.einsum`` promotes a mixed pair (a no-op cast when they agree)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(dt), w.to(dt))


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
# attention (self / cross, with optional KV cache)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention: self-attention (``cross=False``) or cross-attention
    over encoder or image states (``cross=True``; the same weights)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None,
                 cross: bool = False):
        super().__init__()
        D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg, self.cross = cfg, cross
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

    def _kv(self, src: torch.Tensor):
        k = promoted_einsum("bsd,dhk->bshk", src, self.wk)
        v = promoted_einsum("bsd,dhk->bshk", src, self.wv)
        if self.cfg.qkv_bias:
            k, v = k + self.bk, v + self.bv
        return k, v

    def _out(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return promoted_einsum("bshk,hkd->bsd", out.to(x.dtype), self.wo)

    def forward(self, x: torch.Tensor, *, cache: Optional[Cache],
                pos: int = 0, causal: bool = True,
                impl: Optional[str] = None,
                kv_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, S, D) -> out (B, S, D).

        Self-attention: cache {"k", "v"}: (B, S_max, Hkv, hd); ``pos`` (a
        host integer) is the absolute position of x[0].  The new keys and
        values are written into the cache **in place** at ``pos`` (slice
        assignment).  Prefill (S > 1) attends over the fresh keys; decode
        (S == 1) over the cache with ``kv_len = pos + 1``.  ``cache=None``
        is the training forward (or the encoder's): no cache, the fresh
        keys only, under autograd.

        Cross-attention: :meth:`_cross_attention`.
        """
        q = promoted_einsum("bsd,dhk->bshk", x, self.wq)
        if self.cfg.qkv_bias:
            q = q + self.bq
        if self.cross:
            return self._cross_attention(q, x, kv_src, cache, impl)
        S = x.shape[1]
        k, v = self._kv(x)
        positions = pos + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        if cache is None:
            out = ops.flash_attention(q, k, v, causal=causal, q_offset=pos,
                                      impl=impl)
            return self._out(out, x)

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
        return self._out(out, x)

    def _cross_attention(self, q: torch.Tensor, x: torch.Tensor,
                         kv_src: Optional[torch.Tensor],
                         cache: Optional[Cache],
                         impl: Optional[str]) -> torch.Tensor:
        """Queries from ``x``, keys and values from ``kv_src`` (B, L, D)
        (training and prefill) or from the cross cache (decode,
        ``kv_src=None``); no RoPE, every key visible.  In prefill the fresh
        keys and values are cast to the cache's dtype and written into the
        (B, L, Hkv, hd) cross cache **in place**, then attended over from
        there, as the reference attends over its cast copy; a source of
        another length than the cache's is refused.  Without a cache
        (training) a float32 source and bf16 queries promote to float32
        inside ``ops.flash_attention``."""
        if kv_src is None:
            if cache is None:
                raise ValueError("cross-attention needs its source (kv_src) "
                                 "or a filled cross cache")
            k, v = cache["k"], cache["v"]
        else:
            k, v = self._kv(kv_src)
            if cache is not None:
                if kv_src.shape[:2] != cache["k"].shape[:2]:
                    raise ValueError(
                        f"cross-attention: a source of {kv_src.shape[1]} "
                        f"positions for batch {kv_src.shape[0]} does not fit "
                        f"a cross cache of {cache['k'].shape[1]} positions "
                        f"for batch {cache['k'].shape[0]}")
                cache["k"].copy_(k)
                cache["v"].copy_(v)
                k, v = cache["k"], cache["v"]
        out = ops.flash_attention(q, k, v, causal=False, impl=impl)
        return self._out(out, x)


def attn_cache_spec(cfg: ModelConfig, batch: int, s_max: int,
                    dtype: torch.dtype) -> Dict[str, TensorSpec]:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU MLP (``act="silu"``) or the two-matmul GELU MLP
    (``act="gelu"``: whisper), under the reference's parameter names."""

    def __init__(self, cfg: ModelConfig, width: int, device=None,
                 dtype=None):
        super().__init__()
        D = cfg.d_model
        self.gelu = cfg.act == "gelu"
        if self.gelu:
            self.wi = empty_param((D, width), device, dtype)
            self.bi = empty_param((width,), device, dtype)
            self.wo_mlp = empty_param((width, D), device, dtype)
            self.bo = empty_param((D,), device, dtype)
        else:
            self.wg = empty_param((D, width), device, dtype)
            self.wu = empty_param((D, width), device, dtype)
            self.wd = empty_param((width, D), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if not self.gelu:
            for w in (self.wg, self.wu, self.wd):
                dense_init_(w, gen)
            return
        for w in (self.wi, self.wo_mlp):
            dense_init_(w, gen)
        with torch.no_grad():
            self.bi.zero_()
            self.bo.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # each elementwise chain runs in fp32 and rounds once, where XLA's
        # fusion does; the products round to their type first
        if self.gelu:
            dt = torch.promote_types(x.dtype, self.wi.dtype)
            h = F.gelu(promoted_einsum("bsd,df->bsf", x, self.wi).float()
                       + self.bi.float(), approximate="tanh")
            out = promoted_einsum("bsf,fd->bsd", h.to(dt),
                                  self.wo_mlp).float()
            return (out + self.bo.float()).to(dt)
        gate = F.silu((x @ self.wg).float()) * (x @ self.wu).float()
        return gate.to(x.dtype) @ self.wd


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)
