"""Unified architecture configuration for the assigned model families.

One frozen dataclass describes every architecture in the pool: dense GQA
transformers, MoE (token-choice top-k, optional shared experts / dense
residual), Mamba-1 SSM, hybrid attention/SSM interleaves, encoder-decoder
(whisper backbone), and VLM cross-attention layers.

Layer patterns are expressed as a repeating *super-block* so that
scan-over-layers works for heterogeneous stacks (jamba: 1 attention + 7
mamba per period of 8; llama-vision: 1 cross-attention per period of 5).

A copy of ``src/repro/models/config.py``, which imports no framework.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                    # dense-MLP width (and expert width unless set)
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # ---- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0         # 0 -> d_ff
    n_shared_experts: int = 0    # always-on experts (kimi)
    dense_residual: bool = False # dense MLP in parallel with MoE (arctic)
    moe_period: int = 1          # MoE on layers with i % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # ---- SSM (mamba-1) -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0             # 0 -> d_model // 16
    # hybrid interleave: attention on layers with i % attn_period == attn_offset;
    # attn_period == 1 means all-attention, 0 means attention-free.
    attn_period: int = 1
    attn_offset: int = 0

    # ---- encoder-decoder (whisper backbone; audio frontend stubbed) ---------
    encoder_layers: int = 0
    encoder_seq: int = 1500      # frames after the (stubbed) conv frontend

    # ---- VLM cross-attention (llama-3.2-vision backbone; frontend stubbed) --
    cross_attn_period: int = 0   # cross-attn on layers i % period == offset
    cross_attn_offset: int = 0
    n_image_tokens: int = 0
    d_image: int = 0             # stub patch-embedding dim (0 -> d_model)

    # ---- misc ------------------------------------------------------------------
    qkv_bias: bool = False
    act: str = "silu"            # silu (SwiGLU) | gelu (2-matmul MLP)
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # remat policy for scan-over-layers: nothing | dots | full
    remat_policy: str = "nothing"

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_ff_expert == 0 and self.n_experts > 0:
            object.__setattr__(self, "d_ff_expert", self.d_ff)
        if self.dt_rank == 0 and self.ssm_state > 0:
            object.__setattr__(self, "dt_rank", max(1, self.d_model // 16))

    # ---- layer pattern ---------------------------------------------------------
    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for the mixer of layer i."""
        if self.ssm_state > 0:
            if self.attn_period == 0:
                return "ssm"
            return "attn" if i % self.attn_period == self.attn_offset else "ssm"
        return "attn"

    def layer_has_cross_attn(self, i: int) -> bool:
        return (self.cross_attn_period > 0
                and i % self.cross_attn_period == self.cross_attn_offset)

    def layer_is_moe(self, i: int) -> bool:
        return (self.n_experts > 0
                and i % self.moe_period == self.moe_offset)

    @property
    def superblock_size(self) -> int:
        """Smallest repeating period of the layer pattern."""
        period = 1
        if self.ssm_state > 0 and self.attn_period > 1:
            period = _lcm(period, self.attn_period)
        if self.cross_attn_period > 0:
            period = _lcm(period, self.cross_attn_period)
        if self.n_experts > 0 and self.moe_period > 1:
            period = _lcm(period, self.moe_period)
        return period

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % self.superblock_size:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"superblock={self.superblock_size}")
        return self.n_layers // self.superblock_size

    def superblock_pattern(self) -> List[Dict[str, object]]:
        """Per-layer spec of one super-block."""
        return [
            {
                "kind": self.layer_kind(i),
                "cross_attn": self.layer_has_cross_attn(i),
                "moe": self.layer_is_moe(i),
                # pure-SSM archs (falcon-mamba) have no MLP sublayer
                "mlp": (not self.layer_is_moe(i)) and self.d_ff > 0,
            }
            for i in range(self.superblock_size)
        ]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM / hybrid) -> long_500k runs."""
        return self.ssm_state > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (roofline + checkpoint sizing) ---------------------
    def param_count(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D  # input embedding
        if not self.tie_embeddings:
            total += V * D  # output head
        total += D  # final norm

        def attn_params() -> int:
            qk = D * self.n_heads * self.head_dim
            kv = D * self.n_kv_heads * self.head_dim
            n = 2 * qk + 2 * kv  # wq, wo, wk, wv
            if self.qkv_bias:
                n += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            return n

        def mlp_params(width: int) -> int:
            if self.act == "gelu":
                return 2 * D * width + width + D  # 2 matmuls + biases
            return 3 * D * width  # SwiGLU

        def ssm_params() -> int:
            di, N, R = self.d_inner, self.ssm_state, self.dt_rank
            n = D * 2 * di            # in_proj (x and z branches)
            n += di * self.ssm_conv + di  # depthwise conv + bias
            n += di * (R + 2 * N)     # x -> (dt_rank, B, C)
            n += R * di + di          # dt proj + bias
            n += di * N + di          # A_log, D
            n += di * D               # out_proj
            return n

        for i in range(self.n_layers):
            total += D  # pre-mixer norm
            if self.layer_is_moe(i) or self.d_ff > 0:
                total += D  # pre-mlp/moe norm
            if self.layer_kind(i) == "attn":
                total += attn_params()
            else:
                total += ssm_params()
            if self.layer_has_cross_attn(i):
                total += attn_params() + D  # extra norm
            if self.layer_is_moe(i):
                total += self.n_experts * 3 * D * self.d_ff_expert
                total += D * self.n_experts  # router
                total += self.n_shared_experts * 3 * D * self.d_ff_expert
                if self.dense_residual:
                    total += mlp_params(F)
            else:
                total += mlp_params(F)

        for i in range(self.encoder_layers):
            total += 2 * D + attn_params() + mlp_params(F)
        if self.encoder_layers:
            total += D  # encoder final norm
        if self.cross_attn_period > 0 and self.d_image not in (0, D):
            total += self.d_image * D  # patch-embedding projector (stub)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared instead of all)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.d_ff_expert * n_moe_layers
        return full - inactive


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)
