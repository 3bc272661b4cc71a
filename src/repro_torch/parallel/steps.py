"""Step builders: train_step / prefill_step / decode_step, on a mesh.

Counterpart of ``src/repro/parallel/steps.py``.  Each builder returns a
:class:`BuiltStep`: the step ``fn``, the shapes and dtypes of its inputs
(``in_specs``, from a ``device="meta"`` build: nothing is allocated),
their specs (``in_shardings``, ``parallel.sharding``'s rules) and the
specs of its outputs.  Where the reference donates an argument (the
train state, a cache), the port's step updates it in place.  ``place`` cuts whole tensors (from
``params_from_jax``, an init or a checkpoint) into this rank's parts and
``gather`` puts parts back together.

On a :class:`launch.mesh.HostMesh` a step is the one-device step.  On a
:class:`launch.mesh.RankMesh` every rank calls ``fn`` on its own parts
(plain local tensors) inside the step's ``parallel.context`` scope: the
layers all-gather their FSDP-sharded weights before use, keep heads,
columns, channels and experts local over "model" and sum the partial
sums over it -- in the train and prefill steps, under
``ParallelConfig.shard_sequence`` (the default), with the activation
between sublayers sharded along the sequence over "model" (Megatron SP:
all-gather in, reduce-scatter out), and otherwise all-reduced (see
``parallel.context``).  The train step's gradients flow through those
collectives; its gradient norm is the global one.  A one-rank mesh
computes what the one-device step computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.shapes import ShapeSpec
from ..launch.mesh import RankMesh
from ..models.config import ModelConfig
from ..models.model_zoo import (LM, ModelBundle, _cross_input, call_lm,
                                decayed_names)
from ..models.module import TensorSpec
from ..train.optimizer import OptimizerConfig, adamw_update
from . import comm, sharding
from .context import Scope, activation_sharding_scope
from .sharding import (ParallelConfig, batch_shardings, batch_spec,
                       cache_shardings, params_shardings, spec_axes)

Params = Dict[str, Any]

#: the reference's ``moe_buffer_mode`` values
MOE_MODES = ("ep", "dp", "none", "ep_local", "shard_map")


# ---------------------------------------------------------------------------
# input specs (shapes and dtypes of every model input)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Placeholder inputs for an (arch, shape) cell -- no allocation."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "train":
        specs = {"tokens": TensorSpec((B, S), i32),
                 "labels": TensorSpec((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": TensorSpec((B, S), i32)}
    else:  # decode
        specs = {"tokens": TensorSpec((B, 1), i32)}
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            specs["frames"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model),
                                         dt)
        elif cfg.cross_attn_period > 0:
            specs["image_embeds"] = TensorSpec(
                (B, cfg.n_image_tokens, cfg.d_image), dt)
    return specs


def param_specs(bundle: ModelBundle) -> Dict[str, TensorSpec]:
    """Shape and dtype of every parameter, from a ``device="meta"``
    build."""
    lm = LM(bundle.cfg, device="meta", dtype=bundle.dtype)
    return {k: TensorSpec(tuple(v.shape), v.dtype)
            for k, v in lm.state_dict().items()}


def state_specs(bundle: ModelBundle, opt_cfg: OptimizerConfig) -> Params:
    """Shapes and dtypes of the train state (params + Adam moments)."""
    p = param_specs(bundle)
    dt = getattr(torch, opt_cfg.state_dtype)
    mom = {k: TensorSpec(v.shape, dt) for k, v in p.items()}
    return {"params": p, "opt": {"m": mom, "v": dict(mom),
                                 "step": TensorSpec((), torch.int32)}}


# ---------------------------------------------------------------------------
# the built step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BuiltStep:
    fn: Callable                    # the step, on placed arguments
    in_specs: Tuple[Any, ...] = ()  # TensorSpecs of the whole arguments
    in_shardings: Tuple[Any, ...] = ()
    out_shardings: Tuple[Any, ...] = ()
    mesh: Any = None

    def place(self, *args) -> Tuple[Any, ...]:
        """This rank's parts of the whole arguments ``args``."""
        return tuple(sharding.place(a, s, self.mesh)
                     for a, s in zip(args, self.in_shardings))

    def gather(self, tree: Any, shardings: Any) -> Any:
        """The whole tensors of the parts ``tree`` under ``shardings``
        (an entry of ``in_shardings`` or ``out_shardings``)."""
        return sharding.gather(tree, shardings, self.mesh)


def _scope(mesh, shape: ShapeSpec, pcfg: ParallelConfig,
           p_sh: Dict[str, Any], c_sh=None) -> Optional[Scope]:
    """The step's context on a mesh of ranks (None on one device)."""
    if pcfg.moe_buffer_mode not in MOE_MODES:
        raise ValueError(f"moe_buffer_mode {pcfg.moe_buffer_mode!r} is not "
                         f"one of {MOE_MODES}")
    if not isinstance(mesh, RankMesh):
        return None
    seq = any(spec[1] is not None for layer in (c_sh or [])
              for kind, entries in layer.items() if kind != "ssm"
              for spec in entries.values())
    # the reference installs its sequence sharding in train and prefill
    return Scope(
        mesh=mesh, pcfg=pcfg, specs=p_sh,
        batch_axes=spec_axes(batch_spec(mesh, shape.global_batch, pcfg)[0]),
        cache_seq=seq,
        seq_parallel=pcfg.shard_sequence and shape.kind != "decode")


def _logits_spec(mesh, shape: ShapeSpec, pcfg: ParallelConfig):
    return batch_spec(mesh, shape.global_batch, pcfg) + (None,)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(bundle: ModelBundle, mesh, shape: ShapeSpec,
                    opt_cfg: OptimizerConfig = OptimizerConfig(),
                    impl: Optional[str] = None, *,
                    pcfg: ParallelConfig = ParallelConfig()) -> BuiltStep:
    """``fn(state, batch)`` for ``state = {"params": {name: tensor},
    "opt": init_opt_state(...)}`` and a batch ``{"tokens", "labels"}`` of
    ``(global_batch, seq_len)`` integer tensors on the mesh's device, with
    an encoder-decoder's ``frames`` or a VLM's ``image_embeds`` beside
    them (``SyntheticTokenPipeline.with_frontend_stubs``'s, float32),
    which the loss feeds to the cross-attention layers: returns the
    updated state (its tensors updated in place) and the reference's
    metrics ``loss``, ``ce_loss``, ``grad_norm`` and ``lr`` (0-dim
    tensors).  Weight decay falls where the reference's falls on
    its stacked tree (``decayed_names``).  On a mesh of ranks the state
    and batch are each rank's parts (``place``) and the metrics the
    global batch's."""
    if shape.kind != "train":
        raise ValueError(f"make_train_step: shape {shape.name!r} is a "
                         f"{shape.kind} shape")
    st_specs = state_specs(bundle, opt_cfg)
    p_sh = params_shardings(st_specs["params"], mesh, pcfg)
    state_sh = {"params": p_sh,
                "opt": sharding.opt_state_shardings(st_specs["opt"], p_sh,
                                                    mesh)}
    b_specs = input_specs(bundle.cfg, shape)
    b_sh = batch_shardings(b_specs, mesh, pcfg)
    scope = _scope(mesh, shape, pcfg, p_sh)

    def train_step(state: Params, batch: Params):
        params = state["params"]
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with activation_sharding_scope(scope):
            loss, metrics = bundle.loss(leaves, batch, impl=impl)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        norm = None if scope is None else _global_norm(grads, p_sh, mesh)
        new_params, new_opt, stats = adamw_update(
            params, grads, state["opt"], opt_cfg,
            decayed=set(decayed_names(params)), grad_norm=norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(stats)
        return {"params": new_params, "opt": new_opt}, metrics

    return BuiltStep(fn=train_step, in_specs=(st_specs, b_specs),
                     in_shardings=(state_sh, b_sh),
                     out_shardings=(state_sh, None), mesh=mesh)


def _global_norm(grads: Params, p_sh: Dict[str, Any],
                 mesh: RankMesh) -> torch.Tensor:
    """The norm of the whole gradient from this rank's shards: each
    shard's sum of squares weighted by the share of the ranks that hold
    that shard, summed over every rank (float32)."""
    total = sum(torch.sum(torch.square(g.float()))
                * (sharding._axis_size(mesh, tuple(
                    a for e in p_sh[k] for a in spec_axes(e)) or None)
                   / mesh.size)
                for k, g in grads.items())
    if mesh.size > 1:
        total = comm.all_reduce(total, None, mesh.size)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(bundle: ModelBundle, mesh, shape: ShapeSpec,
                      pcfg: ParallelConfig = ParallelConfig(),
                      impl: Optional[str] = None) -> BuiltStep:
    """``fn(params, batch, cache)``: the prompt ``batch["tokens"]`` (with
    a cross-attention model's input) run through the model on the
    parameter dict ``params``, filling ``cache`` (``bundle.make_cache(
    global_batch, seq_len)``'s layout) in place; returns the
    last-position logits (B, 1, V) and the cache."""
    cfg = bundle.cfg
    p_specs = param_specs(bundle)
    p_sh = params_shardings(p_specs, mesh, pcfg)
    b_specs = input_specs(cfg, shape)
    b_sh = batch_shardings(b_specs, mesh, pcfg)
    c_specs = bundle.cache_spec(shape.global_batch, shape.seq_len)
    c_sh = cache_shardings(c_specs, mesh, pcfg)
    scope = _scope(mesh, shape, pcfg, p_sh, c_sh)

    def prefill_step(params, batch, cache):
        cross = _cross_input(cfg, batch, ("tokens",))
        with activation_sharding_scope(scope), mesh:
            return call_lm(cfg, "prefill", params, batch["tokens"], cache,
                           impl=impl, cross_input=cross)

    return BuiltStep(fn=prefill_step, in_specs=(p_specs, b_specs, c_specs),
                     in_shardings=(p_sh, b_sh, c_sh),
                     out_shardings=(_logits_spec(mesh, shape, pcfg), c_sh),
                     mesh=mesh)


def make_decode_step(bundle: ModelBundle, mesh, shape: ShapeSpec,
                     pcfg: Optional[ParallelConfig] = None,
                     impl: Optional[str] = None) -> BuiltStep:
    """``fn(params, token, cache, pos)``: one decode step of the (B, 1)
    ``token`` at host position ``pos`` against ``cache``, updated in
    place; returns the logits (B, 1, V) and the cache.  At global batch
    1 the default config shards the caches' sequence axis over "data"
    (the batch cannot shard), each rank attending over its block."""
    cfg = bundle.cfg
    if pcfg is None:
        # long-context single-request decode: shard the KV cache sequence
        # axis over the data axes (batch cannot be sharded at B == 1)
        pcfg = ParallelConfig(
            cache_seq_axis=("data",) if shape.global_batch == 1 else None)
    p_specs = param_specs(bundle)
    p_sh = params_shardings(p_specs, mesh, pcfg)
    t_spec = TensorSpec((shape.global_batch, 1), torch.int32)
    t_sh = batch_shardings(t_spec, mesh, pcfg)
    c_specs = bundle.cache_spec(shape.global_batch, shape.seq_len)
    c_sh = cache_shardings(c_specs, mesh, pcfg)
    pos_spec = TensorSpec((), torch.int32)
    scope = _scope(mesh, shape, pcfg, p_sh, c_sh)

    def decode_step(params, token, cache, pos):
        with activation_sharding_scope(scope), mesh:
            return call_lm(cfg, "decode_step", params, token, cache,
                           int(pos), impl=impl)

    return BuiltStep(fn=decode_step,
                     in_specs=(p_specs, t_spec, c_specs, pos_spec),
                     in_shardings=(p_sh, t_sh, c_sh, ()),
                     out_shardings=(_logits_spec(mesh, shape, pcfg), c_sh),
                     mesh=mesh)


def build_step(bundle: ModelBundle, mesh, shape: ShapeSpec,
               opt_cfg: OptimizerConfig = OptimizerConfig(),
               pcfg: Optional[ParallelConfig] = None,
               impl: Optional[str] = None) -> BuiltStep:
    """Dispatch on the shape kind (train / prefill / decode)."""
    if shape.kind == "train":
        return make_train_step(bundle, mesh, shape, opt_cfg, impl,
                               pcfg=pcfg or ParallelConfig())
    if shape.kind == "prefill":
        return make_prefill_step(bundle, mesh, shape,
                                 pcfg or ParallelConfig(), impl)
    return make_decode_step(bundle, mesh, shape, pcfg, impl)


__all__ = ["BuiltStep", "MOE_MODES", "build_step", "input_specs", "make_decode_step", "make_prefill_step",
           "make_train_step", "param_specs", "state_specs"]
