"""Model construction for serving: config -> (init, prefill, decode, cache).

Counterpart of the serving half of ``src/repro/models/model_zoo.py``, for
decoder-only LMs whose layers are attention, Mamba and dense MLPs (the
dense and SSM families, and hybrids of the two).  MoE layers and the
cross-attention of encoder-decoder and VLM models are refused, naming the
ROADMAP item that ports them; training (``forward_train``, ``loss_fn``)
comes with the training slice.

Two entry points per model, as in the reference:
  * prefill(model, batch, cache)         -> last-position logits, cache
  * decode_step(model, token, cache, pos) -> logits, cache

The cache is updated in place and returned.  :func:`params_from_jax`
carries a JAX parameter tree (as numpy) across, for parity tests.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import RMSNorm, embed
from .module import dense_init_, embed_init_, empty_param, tree_paths
from .transformer import (CROSS_ITEM, MOE_ITEM, LayerCache, Stack,
                          init_cache, stack_cache_spec)


def unported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` yet (None when it can)."""
    if cfg.n_experts > 0:
        return (f"{cfg.name} has MoE layers (n_experts={cfg.n_experts}), "
                f"not ported yet: {MOE_ITEM}")
    if cfg.is_encdec or cfg.cross_attn_period > 0:
        return (f"{cfg.name} needs cross-attention (family {cfg.family!r}), "
                f"not ported yet: {CROSS_ITEM}")
    if cfg.act != "silu":
        return (f"{cfg.name} uses a {cfg.act!r} MLP; the port's MLP is "
                "SwiGLU (the reference's other MLP serves only "
                f"encoder-decoder models: {CROSS_ITEM})")
    return None


def _refuse_unported(cfg: ModelConfig) -> None:
    reason = unported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(reason)


class LM(nn.Module):
    """Decoder-only LM: embed -> stack -> final norm -> (tied) head."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        _refuse_unported(cfg)
        self.cfg = cfg
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = empty_param((V, D), device, dtype)
        self.stack = Stack(cfg, device, dtype)
        self.final_norm = RMSNorm(D, cfg.norm_eps, device, dtype)
        if not cfg.tie_embeddings:
            self.head = empty_param((D, V), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from ``gen``, with the reference's distributions."""
        embed_init_(self.embed, gen)
        if not self.cfg.tie_embeddings:
            dense_init_(self.head, gen)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return x @ head

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: List[LayerCache],
                impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """Process the prompt, filling the caches. Returns last-position
        logits (B, 1, V) and the cache."""
        x = embed(self.embed, tokens)
        x = self.stack(x, caches=cache, pos=0, causal=True, impl=impl)
        x = self.final_norm(x[:, -1:, :])
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: List[LayerCache],
                    pos: int, impl: Optional[str] = None,
                    ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """One decode step. token: (B, 1) integer ids; pos: host integer,
        the position of ``token``."""
        x = embed(self.embed, token)
        x = self.stack(x, caches=cache, pos=int(pos), causal=True,
                       impl=impl)
        x = self.final_norm(x)
        return self._logits(x), cache


def prefill(model: LM, batch: Mapping[str, torch.Tensor],
            cache: List[LayerCache], impl: Optional[str] = None,
            ) -> Tuple[torch.Tensor, List[LayerCache]]:
    """Process the prompt ``batch["tokens"]`` (B, S), writing the caches.
    Returns last-position logits (B, 1, V) and the cache."""
    extra = set(batch) - {"tokens"}
    if extra:
        raise NotImplementedError(
            f"prefill: inputs {sorted(extra)} feed cross-attention, not "
            f"ported yet: {CROSS_ITEM}")
    return model.prefill(batch["tokens"], cache, impl=impl)


def decode_step(model: LM, token: torch.Tensor, cache: List[LayerCache],
                pos: int, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, List[LayerCache]]:
    """One decode step. token: (B, 1) integer ids; pos: host integer."""
    return model.decode_step(token, cache, pos, impl=impl)


# ---------------------------------------------------------------------------
# bundle
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], LM]
    prefill: Callable[..., Tuple[torch.Tensor, List[LayerCache]]]
    decode: Callable[..., Tuple[torch.Tensor, List[LayerCache]]]
    make_cache: Callable[[int, int], List[LayerCache]]
    cache_spec: Callable[[int, int], List[Dict[str, Any]]]


def build_model(cfg: ModelConfig, device=None,
                dtype: Optional[torch.dtype] = None) -> ModelBundle:
    """The serving bundle of ``cfg`` on ``device`` (None: the card, which
    raises without one; pass ``device="cpu"`` for the CPU).  ``dtype``
    overrides ``cfg.dtype`` for weights and KV caches (SSM state stays
    fp32).  ``init(seed)`` returns an :class:`LM` with random weights made
    on the device from ``seed``."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype) if dtype is None else dtype

    def init(seed: int) -> LM:
        model = LM(cfg, device=dev, dtype=dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.reset_parameters(gen)
        return model.eval()

    return ModelBundle(
        cfg=cfg, device=dev, init=init,
        prefill=prefill, decode=decode_step,
        make_cache=lambda batch, s_max: init_cache(cfg, batch, s_max, dt,
                                                   dev),
        cache_spec=lambda batch, s_max: stack_cache_spec(cfg, batch, s_max,
                                                         dt))


# ---------------------------------------------------------------------------
# JAX parameters -> the port's state dict
# ---------------------------------------------------------------------------

_STACK_PATH = re.compile(r"stack/layer(\d+)/(.+)")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":               # ml_dtypes' numpy bf16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(cfg: ModelConfig,
                    tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree as numpy (``jax.tree.map(np.asarray, params)``)
    -> the port's state dict (CPU tensors, the tree's dtypes).

    The leading superblock axis of ``stack/layer{j}/...`` is unstacked
    into layers ``sb * superblock_size + j``.  A tree whose paths or leaf
    shapes do not match ``cfg`` is refused.  Load the result with
    ``model.load_state_dict(sd)``.
    """
    _refuse_unported(cfg)
    want = {k: tuple(v.shape)
            for k, v in LM(cfg, device="meta").state_dict().items()}
    size = cfg.superblock_size
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in tree_paths(tree):
        leaf = np.asarray(leaf)
        m = _STACK_PATH.fullmatch(path)
        if m is None:
            out[path.replace("/", ".")] = _to_tensor(leaf)
            continue
        j, rest = int(m.group(1)), m.group(2).replace("/", ".")
        if leaf.ndim == 0 or leaf.shape[0] != cfg.n_superblocks:
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{leaf.shape}, not {cfg.n_superblocks} "
                             "stacked superblocks")
        for sb in range(leaf.shape[0]):
            out[f"stack.{sb * size + j}.{rest}"] = _to_tensor(leaf[sb])
    if set(out) != set(want):
        raise ValueError(
            f"params_from_jax: the tree does not match {cfg.name}: "
            f"missing {sorted(set(want) - set(out))}, unexpected "
            f"{sorted(set(out) - set(want))}")
    for k, t in out.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"params_from_jax: {k} has shape "
                             f"{tuple(t.shape)}, {cfg.name} needs {want[k]}")
    return out
