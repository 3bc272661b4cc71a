"""Model assembly: layer -> stack of layers, and the decode caches.

Counterpart of ``src/repro/models/transformer.py``.  The reference stacks
the parameters of ``n_superblocks`` repetitions of the superblock pattern
and runs them with ``lax.scan``; here the stack is an ``nn.ModuleList``
of ``n_layers`` layers in pattern order (layer ``i`` follows
``pattern[i % superblock_size]``), run by a Python loop, and the cache is
a list with one dict per layer.  The reference's sharding constraint on
the activations between superblocks (``constrain_activations``: the
sequence over "model", Megatron SP) is the mesh steps' sequence
parallelism: its caller (``model_zoo``) hands the stack the rank's
positions inside ``context.sequence_sharded``, and every sublayer
gathers and scatters them itself, so the inner boundaries of a
superblock (jamba's 8 layers, llama-vision's 5) are sharded too -- the
same function.  Off a mesh the stack sees the whole sequence.  The same
:class:`Stack` runs an encoder-decoder's encoder (its
``encoder_config``: attention and MLP layers, ``causal=False``, no
cache).

The training forward remats as the reference's scan body does: each
superblock (``superblock_size`` consecutive layers) runs under
``torch.utils.checkpoint`` when ``REMAT_POLICIES`` holds the config's
``remat_policy`` -- ``"nothing"`` saves nothing and recomputes the
superblock in the backward, ``"dots"`` saves the matmul outputs
(``mm``, ``addmm``, ``bmm``, ``baddbmm``), ``"dots_no_batch"`` those
without batch dimensions (``mm``, ``addmm``); any other name
(``"full"``) keeps every activation.  The numbers are the same under
every policy; the memory and the FLOPs are not.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..parallel import context
from .config import ModelConfig
from .layers import MLP, Attention, RMSNorm, attn_cache_spec
from .module import TensorSpec
from .moe import Aux, MoE
from .ssm import Mamba, mamba_cache_spec

LayerCache = Dict[str, Dict[str, torch.Tensor]]


class Layer(nn.Module):
    """Pre-norm residual layer: norm1 -> attention or Mamba, then
    norm_x -> cross-attention where the pattern has it (whisper's decoder,
    llama-vision's every fifth layer), then norm2 -> MoE or MLP where the
    pattern has one (falcon-mamba has none)."""

    def __init__(self, cfg: ModelConfig, spec: Dict[str, Any], device=None,
                 dtype=None):
        super().__init__()
        self.kind = spec["kind"]
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)
        if self.kind == "attn":
            self.attn = Attention(cfg, device, dtype)
        else:
            self.ssm = Mamba(cfg, device, dtype)
        self.has_cross = spec["cross_attn"]
        if self.has_cross:
            self.norm_x = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)
            self.cross = Attention(cfg, device, dtype, cross=True)
        self.has_moe, self.has_mlp = spec["moe"], spec["mlp"]
        if self.has_moe or self.has_mlp:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)
        if self.has_moe:
            self.moe = MoE(cfg, device, dtype)
        elif self.has_mlp:
            self.mlp = MLP(cfg, cfg.d_ff, device, dtype)

    def forward(self, x: torch.Tensor, *, cache: Optional[LayerCache],
                pos: int, causal: bool, impl: Optional[str],
                aux: Optional[Aux] = None,
                cross_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One layer; the layer's cache is updated in place (``None``: the
        training forward, no cache).  A MoE layer adds its aux losses
        into ``aux`` (``None``: they are dropped).  A cross-attention
        layer attends over ``cross_src`` (B, L, D), or over its cross
        cache where that is ``None`` (decode)."""
        h = self.norm1(x)
        if self.kind == "attn":
            h = self.attn(h, cache=None if cache is None else cache["self"],
                          pos=pos, causal=causal, impl=impl)
        else:
            h = self.ssm(h, cache=None if cache is None else cache["ssm"],
                         impl=impl)
        x = x + h
        if self.has_cross:
            x = x + self.cross(
                self.norm_x(x), cache=None if cache is None
                else cache["cross"], impl=impl, kv_src=cross_src)
        if self.has_moe:
            h, layer_aux = self.moe(self.norm2(x))
            x = x + h
            if aux is not None:
                for k, v in layer_aux.items():
                    aux[k] = aux[k] + v if k in aux else v
        elif self.has_mlp:
            x = x + self.mlp(self.norm2(x))
        return x


_aten = torch.ops.aten
_MM = (_aten.mm.default, _aten.addmm.default)
_BMM = (_aten.bmm.default, _aten.baddbmm.default)

#: remat policy -> the aten ops whose outputs a superblock saves (the
#: reference's ``jax.checkpoint_policies``: ``nothing_saveable``,
#: ``checkpoint_dots``, ``checkpoint_dots_with_no_batch_dims``)
REMAT_POLICIES = {"nothing": (), "dots": _MM + _BMM, "dots_no_batch": _MM}


def _saving(ops):
    """``checkpoint``'s ``context_fn`` that saves the outputs of ``ops``
    and recomputes the rest (none: a plain checkpoint)."""
    if not ops:
        return noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return lambda: create_selective_checkpoint_contexts(policy)


class Superblock(nn.ModuleList):
    """``superblock_size`` consecutive layers of a :class:`Stack` (the
    same modules, not copies): the reference's scan body, the unit of
    remat."""

    def forward(self, x: torch.Tensor, **kw) -> Tuple[torch.Tensor,
                                                       List[Aux]]:
        """The layers in turn; each MoE layer's aux losses in a dict of
        their own (a recompute runs this again and must not add them
        twice)."""
        auxes: List[Aux] = []
        for layer in self:
            auxes.append({})
            x = layer(x, aux=auxes[-1], **kw)
        return x, auxes


def _remat_superblock(block: Superblock, scope, names, x, *tensors, **kw):
    """``block`` on its parameters ``tensors`` (by ``names``), under the
    mesh step's ``scope``: what a checkpoint recomputes in the backward,
    after the step's ``functional_call`` and scope have ended (under
    sequence parallelism the sharded scope, so the recompute gathers its
    saved shard again)."""
    with context.activation_sharding_scope(scope):
        return torch.func.functional_call(
            block, dict(zip(names, tensors)), (x,), kw, strict=True)


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
        self.remat_policy = cfg.remat_policy
        n = len(pattern)
        # kept off the module tree: the layers' names stay "stack.{i}...."
        object.__setattr__(self, "_superblocks", [
            Superblock(list(self)[i:i + n]) for i in range(0, len(self), n)])

    def forward(self, x: torch.Tensor, *,
                caches: Optional[List[LayerCache]], pos: int = 0,
                causal: bool = True, impl: Optional[str] = None,
                cross_src: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Aux]:
        """All layers; each layer's cache is updated in place (``caches=
        None``: the training forward, no cache); the cross-attention
        layers attend over ``cross_src`` (``None``: their caches).
        Returns the output and the MoE layers' aux losses, summed and
        divided by ``n_layers`` -- every layer, not the MoE layers alone,
        as the reference's ``apply_stack`` divides ({} without MoE
        layers)."""
        aux: Aux = {}
        if caches is not None:
            for layer, cache in zip(self, caches):
                x = layer(x, cache=cache, pos=pos, causal=causal, impl=impl,
                          aux=aux, cross_src=cross_src)
            return x, {k: v / len(self) for k, v in aux.items()}
        kw = dict(cache=None, pos=pos, causal=causal, impl=impl,
                  cross_src=cross_src)
        ops = REMAT_POLICIES.get(self.remat_policy)
        remat = ops is not None and torch.is_grad_enabled()
        for block in self._superblocks:
            if remat:
                names, tensors = zip(*block.named_parameters())
                x, auxes = checkpoint(
                    _remat_superblock, block, context.current(), names, x,
                    *tensors, use_reentrant=False, context_fn=_saving(ops),
                    **kw)
            else:
                x, auxes = block(x, **kw)
            for layer_aux in auxes:
                for k, v in layer_aux.items():
                    aux[k] = aux[k] + v if k in aux else v
        return x, {k: v / len(self) for k, v in aux.items()}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def stack_cache_spec(cfg: ModelConfig, batch: int, s_max: int,
                     dtype: torch.dtype, cross_len: int = 0,
                     ) -> List[Dict[str, Dict[str, TensorSpec]]]:
    """One dict a layer: ``{"self": {"k", "v"}}`` for attention (in the
    model's dtype), ``{"ssm": {"conv", "ssm"}}`` for Mamba (fp32), and
    beside either ``{"cross": {"k", "v"}}`` of ``cross_len`` positions
    for a cross-attention layer (in the model's dtype)."""
    pattern = cfg.superblock_pattern()
    out = []
    for i in range(cfg.n_layers):
        spec = pattern[i % len(pattern)]
        if spec["kind"] == "attn":
            layer = {"self": attn_cache_spec(cfg, batch, s_max, dtype)}
        else:
            layer = {"ssm": mamba_cache_spec(cfg, batch)}
        if spec["cross_attn"]:
            layer["cross"] = attn_cache_spec(cfg, batch, cross_len, dtype)
        out.append(layer)
    return out


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype: torch.dtype,
               device, cross_len: int = 0) -> List[LayerCache]:
    return [{kind: {name: torch.zeros(spec.shape, dtype=spec.dtype,
                                      device=device)
                    for name, spec in entries.items()}
             for kind, entries in layer.items()}
            for layer in stack_cache_spec(cfg, batch, s_max, dtype,
                                          cross_len)]
