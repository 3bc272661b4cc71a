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

On a mesh (a step's :mod:`repro_torch.parallel.context` scope) the
weights come through ``context.full`` / ``context.part``, and attention
and the MLP keep their heads and columns local over "model" where they
divide it, summing the out-projection's partials once in float32
(``context.enter_sublayer`` / ``leave_sublayer``: under sequence
parallelism the input's shards are all-gathered along the sequence and
the partials reduce-scattered back to them; a sublayer that does not
split computes whole and keeps its rank's positions); off a mesh those
return the module's own tensors and the code is the one-device path.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..parallel import comm, context
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
        # under SP the norm runs on the rank's positions
        return rmsnorm(context.full(self, "scale", partial=True), x,
                       self.eps)


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

    def _layout(self) -> Optional[Tuple[Tuple[int, int], Tuple[int, int],
                                       bool]]:
        """This rank's query heads, the kv heads they read and whether
        the kv projections split with them, where the heads split over
        "model" (None: attention runs whole on every rank, or off a
        mesh).  Query heads split when they divide the axis; kv heads
        split with them when they divide it too, and otherwise every rank
        computes all of them (the cache keeps them all, as its spec) and
        reads the one its query heads share."""
        Hq, Hkv = self.cfg.n_heads, self.cfg.n_kv_heads
        split = context.tp_split(Hq)
        if split is None:
            return None
        r, n = split
        q = (r * Hq // n, (r + 1) * Hq // n)
        if Hkv % n == 0:
            return q, (r * Hkv // n, (r + 1) * Hkv // n), True
        if n % Hkv:
            return None
        lo = q[0] // (Hq // Hkv)
        return q, (lo, lo + 1), False

    def _weights(self, lay) -> Dict[str, torch.Tensor]:
        """The projections this rank computes with: whole (``lay`` None),
        or its query heads and, where they split, its kv heads.  Under
        SP the whole weights see only this rank's share of the gradient
        (``partial``), except a cross-attention's kv projections, which
        read the whole source."""
        names = ["wq", "wk", "wv", "wo"] + (
            ["bq", "bk", "bv"] if self.cfg.qkv_bias else [])
        if lay is None:
            return {n: context.full(self, n, partial=True) for n in names}
        q, kv, kv_split = lay
        dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0,
                "bv": 0}
        out = {}
        for n in names:
            if n in ("wq", "wo", "bq"):
                out[n] = context.part(self, n, dims[n], [q])
            elif kv_split:
                out[n] = context.part(self, n, dims[n], [kv])
            else:
                out[n] = context.full(self, n, partial=not self.cross)
        return out

    def _kv(self, src: torch.Tensor, w: Dict[str, torch.Tensor], lay,
            src_split: Optional[torch.Tensor] = None):
        """Keys and values of ``src``: this rank's kv heads where they
        split (from ``src_split``, ``src`` entering the split), else all
        of them."""
        if lay is not None and lay[2]:
            src = src_split
        k = promoted_einsum("bsd,dhk->bshk", src, w["wk"])
        v = promoted_einsum("bsd,dhk->bshk", src, w["wv"])
        if self.cfg.qkv_bias:
            k, v = k + w["bk"], v + w["bv"]
        return k, v

    @staticmethod
    def _heads(t: torch.Tensor, lay, own: bool = False) -> torch.Tensor:
        """The kv heads this rank's query heads read, of a tensor holding
        every kv head (its keys or values, or a cache).  ``own``: keys or
        values of the layer's own input, which under SP is gathered along
        the sequence with each rank's gradient its share -- the heads are
        then taken plainly, where a ``copy_to`` would count the other
        ranks' heads' gradients on every rank."""
        if lay is None or lay[2]:
            return t
        lo, hi = lay[1]
        if own and context.sharded():
            return t[:, :, lo:hi]
        return context.enter_split(t)[:, :, lo:hi]

    def _out(self, out: torch.Tensor, x: torch.Tensor,
             w: Dict[str, torch.Tensor], lay) -> torch.Tensor:
        if lay is None:
            return context.leave_sublayer(promoted_einsum(
                "bshk,hkd->bsd", out.to(x.dtype), w["wo"]), False)
        dt = torch.promote_types(x.dtype, w["wo"].dtype)
        part = torch.einsum("bshk,hkd->bsd", out.to(x.dtype).float(),
                            w["wo"].float())
        return context.leave_sublayer(part, True).to(dt)

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
        lay = self._layout()
        w = self._weights(lay)
        x, xs = context.enter_sublayer(x, lay is not None)
        q = promoted_einsum("bsd,dhk->bshk", xs, w["wq"])
        if self.cfg.qkv_bias:
            q = q + w["bq"]
        if self.cross:
            return self._cross_attention(q, x, kv_src, cache, impl, w, lay)
        S = x.shape[1]
        k, v = self._kv(x, w, lay, xs)
        positions = pos + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        if cache is None:
            out = ops.flash_attention(q, self._heads(k, lay, True),
                                      self._heads(v, lay, True),
                                      causal=causal, q_offset=pos, impl=impl)
            return self._out(out, x, w, lay)

        seq = context.seq_split()
        s_max = cache["k"].shape[1]
        lo = 0 if seq is None else seq[0] * s_max
        total = s_max if seq is None else s_max * seq[1]
        if pos < 0 or pos + S > total:
            raise ValueError(f"attention: positions {pos}..{pos + S - 1} "
                             f"do not fit a cache of {total} slots")
        _write(cache, k, v, pos - lo)
        ck, cv = self._heads(cache["k"], lay), self._heads(cache["v"], lay)
        if S == 1 and seq is not None:
            out = _seq_attention(q, ck, cv, pos + 1 - lo, seq, impl)
        elif S == 1:
            out = ops.flash_attention(q, ck, cv, causal=False,
                                      kv_len=pos + 1, impl=impl)
        else:
            out = ops.flash_attention(q, self._heads(k, lay, True),
                                      self._heads(v, lay, True),
                                      causal=causal, q_offset=0, impl=impl)
        return self._out(out, x, w, lay)

    def _cross_attention(self, q: torch.Tensor, x: torch.Tensor,
                         kv_src: Optional[torch.Tensor],
                         cache: Optional[Cache],
                         impl: Optional[str], w: Dict[str, torch.Tensor],
                         lay) -> torch.Tensor:
        """Queries from ``x``, keys and values from ``kv_src`` (B, L, D)
        (training and prefill) or from the cross cache (decode,
        ``kv_src=None``); no RoPE, every key visible.  In prefill the fresh
        keys and values are cast to the cache's dtype and written into the
        (B, L, Hkv, hd) cross cache **in place**, then attended over from
        there, as the reference attends over its cast copy; a source of
        another length than the cache's is refused.  Without a cache
        (training) a float32 source and bf16 queries promote to float32
        inside ``ops.flash_attention``.  Where a decode step shards the
        caches' sequence axis, each rank keeps its block of the L
        positions and decode combines the ranks' partial attention."""
        seq = context.seq_split() if cache is not None else None
        if kv_src is None:
            if cache is None:
                raise ValueError("cross-attention needs its source (kv_src) "
                                 "or a filled cross cache")
            k, v = self._heads(cache["k"], lay), self._heads(cache["v"], lay)
            if seq is not None:
                out = _seq_attention(q, k, v, k.shape[1], seq, impl)
                return self._out(out, x, w, lay)
        else:
            if lay is None and context.sharded():
                # the query rows are the rank's alone: so is the source's
                # gradient, summed over "model"
                kv_src = context.enter_split(kv_src)
            src_s = None if lay is None else context.enter_split(kv_src)
            k, v = self._kv(kv_src, w, lay, src_s)
            if cache is not None:
                n_seq = 1 if seq is None else seq[1]
                if (kv_src.shape[0], kv_src.shape[1]) != (
                        cache["k"].shape[0], cache["k"].shape[1] * n_seq):
                    raise ValueError(
                        f"cross-attention: a source of {kv_src.shape[1]} "
                        f"positions for batch {kv_src.shape[0]} does not fit "
                        f"a cross cache of {cache['k'].shape[1] * n_seq} "
                        f"positions for batch {cache['k'].shape[0]}")
                if seq is None:
                    cache["k"].copy_(k)
                    cache["v"].copy_(v)
                    k, v = cache["k"], cache["v"]
                else:
                    _write(cache, k, v, -seq[0] * cache["k"].shape[1])
                    k, v = (k.to(cache["k"].dtype), v.to(cache["v"].dtype))
            k, v = self._heads(k, lay), self._heads(v, lay)
        out = ops.flash_attention(q, k, v, causal=False, impl=impl)
        return self._out(out, x, w, lay)


def _write(cache: Cache, k: torch.Tensor, v: torch.Tensor, at: int) -> None:
    """Write ``k`` and ``v`` (B, S, H, d) into the cache at slot ``at``
    (negative, or past its end: the part that falls inside it), in the
    cache's dtype."""
    S, s_max = k.shape[1], cache["k"].shape[1]
    a, b = max(at, 0), min(at + S, s_max)
    if a < b:
        cache["k"][:, a:b] = k[:, a - at:b - at].to(cache["k"].dtype)
        cache["v"][:, a:b] = v[:, a - at:b - at].to(cache["v"].dtype)


def _seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: int, seq, impl: Optional[str]) -> torch.Tensor:
    """Attention over a cache whose positions are split over ranks: each
    rank attends over its block (the kernel, with its first ``kv_len``
    keys visible), and the blocks' results are combined by the
    log-sum-exp of each row's visible scores, which the kernel returns
    beside them."""
    _, _, group = seq
    kv_len = min(max(kv_len, 0), k.shape[1])
    if kv_len > 0:
        out, lse = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len,
                                       impl=impl, return_lse=True)
        out = out.float()
    else:
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], -math.inf, device=q.device)
    outs = comm.all_gather_stack(out, group)
    lses = comm.all_gather_stack(lse, group)
    wts = torch.exp(lses - lses.max(0).values)
    return ((wts[..., None] * outs).sum(0)
            / wts.sum(0)[..., None]).to(q.dtype)


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
        self.width = width
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
        # fusion does; the products round to their type first.  On a mesh
        # the columns split over "model" where they divide it, and the
        # down projection's partials are summed in fp32
        split = context.tp_split(self.width)
        cols = None if split is None else context.ranges_of(*split,
                                                            self.width)
        _, xs = context.enter_sublayer(x, split is not None)

        def w(name, dim):
            if split is None:
                return context.full(self, name, partial=True)
            return context.part(self, name, dim, cols)

        def down(h, wd):
            if split is None:
                return context.leave_sublayer(
                    promoted_einsum("bsf,fd->bsd", h, wd), False)
            return context.leave_sublayer(torch.einsum(
                "bsf,fd->bsd", h.float(), wd.float()), True)

        if self.gelu:
            wi = w("wi", 1)
            dt = torch.promote_types(x.dtype, wi.dtype)
            h = F.gelu(promoted_einsum("bsd,df->bsf", xs, wi).float()
                       + w("bi", 0).float(), approximate="tanh")
            out = down(h.to(dt), w("wo_mlp", 0)).float()
            # the bias is added on the rank's positions under SP
            bo = context.full(self, "bo", partial=True)
            return (out + bo.float()).to(dt)
        gate = F.silu((xs @ w("wg", 1)).float()) * (xs @ w("wu", 1)).float()
        if split is None:
            return context.leave_sublayer(gate.to(x.dtype) @ w("wd", 0),
                                          False)
        return down(gate.to(x.dtype), w("wd", 0)).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)
