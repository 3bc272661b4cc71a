"""Model assembly: layer -> stack of layers, and the decode caches.

Counterpart of ``src/repro/models/transformer.py``.  The reference stacks
the parameters of ``n_superblocks`` repetitions of the superblock pattern
and runs them with ``lax.scan``; here the stack is an ``nn.ModuleList``
of ``n_layers`` layers in pattern order (layer ``i`` follows
``pattern[i % superblock_size]``), run by a Python loop, and the cache is
a list with one dict per layer.  The reference's sharding constraint on
the activations between superblocks is a no-op off a mesh and is left
out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import MLP, Attention, RMSNorm, attn_cache_spec
from .module import TensorSpec
from .ssm import Mamba, mamba_cache_spec

#: where the ROADMAP queues the families this slice refuses
MOE_ITEM = "ROADMAP.md queue 1, item 12b (MoE layers)"
CROSS_ITEM = ("ROADMAP.md queue 1, item 12c (cross-attention: "
              "encoder-decoder and VLM)")

LayerCache = Dict[str, Dict[str, torch.Tensor]]


class Layer(nn.Module):
    """Pre-norm residual layer: norm1 -> attention or Mamba, then
    norm2 -> MLP where the pattern has one (falcon-mamba has none)."""

    def __init__(self, cfg: ModelConfig, spec: Dict[str, Any], device=None,
                 dtype=None):
        super().__init__()
        if spec["moe"]:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet ({MOE_ITEM})")
        if spec["cross_attn"]:
            raise NotImplementedError(
                f"{cfg.name}: cross-attention layers are not ported yet "
                f"({CROSS_ITEM})")
        self.kind = spec["kind"]
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)
        if self.kind == "attn":
            self.attn = Attention(cfg, device, dtype)
        else:
            self.ssm = Mamba(cfg, device, dtype)
        self.has_mlp = spec["mlp"]
        if self.has_mlp:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)
            self.mlp = MLP(cfg, cfg.d_ff, device, dtype)

    def forward(self, x: torch.Tensor, *, cache: Optional[LayerCache],
                pos: int, causal: bool, impl: Optional[str]) -> torch.Tensor:
        """One layer; the layer's cache is updated in place (``None``: the
        training forward, no cache)."""
        h = self.norm1(x)
        if self.kind == "attn":
            h = self.attn(h, cache=None if cache is None else cache["self"],
                          pos=pos, causal=causal, impl=impl)
        else:
            h = self.ssm(h, cache=None if cache is None else cache["ssm"],
                         impl=impl)
        x = x + h
        if self.has_mlp:
            x = x + self.mlp(self.norm2(x))
        return x


class Stack(nn.ModuleList):
    """The decoder's ``n_layers`` layers, in superblock-pattern order."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        pattern = cfg.superblock_pattern()
        if cfg.n_layers % len(pattern):
            raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not "
                             f"divisible by superblock={len(pattern)}")
        super().__init__(
            Layer(cfg, pattern[i % len(pattern)], device, dtype)
            for i in range(cfg.n_layers))

    def forward(self, x: torch.Tensor, *,
                caches: Optional[List[LayerCache]], pos: int = 0,
                causal: bool = True,
                impl: Optional[str] = None) -> torch.Tensor:
        """All layers; each layer's cache is updated in place (``caches=
        None``: the training forward, no cache)."""
        for layer, cache in zip(self, caches or [None] * len(self)):
            x = layer(x, cache=cache, pos=pos, causal=causal, impl=impl)
        return x


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def stack_cache_spec(cfg: ModelConfig, batch: int, s_max: int,
                     dtype: torch.dtype) -> List[Dict[str, Dict[str,
                                                              TensorSpec]]]:
    """One dict a layer: ``{"self": {"k", "v"}}`` for attention (in the
    model's dtype), ``{"ssm": {"conv", "ssm"}}`` for Mamba (fp32)."""
    pattern = cfg.superblock_pattern()
    out = []
    for i in range(cfg.n_layers):
        if pattern[i % len(pattern)]["kind"] == "attn":
            out.append({"self": attn_cache_spec(cfg, batch, s_max, dtype)})
        else:
            out.append({"ssm": mamba_cache_spec(cfg, batch)})
    return out


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype: torch.dtype,
               device) -> List[LayerCache]:
    return [{kind: {name: torch.zeros(spec.shape, dtype=spec.dtype,
                                      device=device)
                    for name, spec in entries.items()}
             for kind, entries in layer.items()}
            for layer in stack_cache_spec(cfg, batch, s_max, dtype)]
