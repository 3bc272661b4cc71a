"""Model construction: config -> (init, loss, forward, prefill, decode).

Counterpart of ``src/repro/models/model_zoo.py``, for every family the
reference builds:
  * decoder-only LMs (dense / MoE / SSM / hybrid) -- tokens in, logits out;
  * encoder-decoder (whisper backbone) -- the audio conv frontend is a
    STUB, as in the reference: ``frames`` arrive as precomputed
    (B, encoder_seq, d_model) embeddings and run through the encoder;
  * VLM (llama-3.2-vision backbone) -- the patch frontend is a STUB:
    ``image_embeds`` arrive as (B, n_image_tokens, d_image) and are
    projected into d_model for the cross-attention layers.

Entry points per model, as in the reference:
  * forward_train(params, cfg, batch)    -> logits, aux
  * loss_fn(params, cfg, batch)          -> loss, metrics (chunked fp32 CE)
  * prefill(model, batch, cache)         -> last-position logits, cache
  * decode_step(model, token, cache, pos) -> logits, cache

A batch holds ``tokens`` (and ``labels`` for the loss) and, for the
cross-attention families, the cross input :func:`cross_input_key` names;
decode reads the cross caches that prefill filled.  Training takes the
parameters as the port's parameter dict (name -> tensor,
``LM.state_dict()``'s names) and runs the model's modules on them
(``torch.func.functional_call``), under autograd; serving runs an
:class:`LM` and updates its cache in place.  :func:`params_from_jax` and
:func:`train_state_from_jax` carry a JAX parameter tree and train state
(as numpy) across, for parity tests and for a checkpoint the JAX package
wrote.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel import context
from .config import ModelConfig
from .layers import RMSNorm, embed, promoted_einsum
from .module import dense_init_, embed_init_, empty_param, tree_paths
from .moe import Aux
from .transformer import LayerCache, Stack, init_cache, stack_cache_spec


def unported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` (None: it runs every family the
    reference builds, so this is None for every config)."""
    return None


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """Whisper encoder: uniform bidirectional attention + dense MLP."""
    return cfg.replace(n_layers=cfg.encoder_layers, encoder_layers=0,
                       cross_attn_period=0, ssm_state=0, attn_period=1,
                       n_experts=0, top_k=0)


def cross_input_key(cfg: ModelConfig) -> Optional[str]:
    """The batch key that feeds ``cfg``'s cross-attention: ``"frames"``
    for an encoder-decoder, ``"image_embeds"`` for a VLM, None for a
    decoder-only model."""
    if cfg.is_encdec:
        return "frames"
    return "image_embeds" if cfg.cross_attn_period > 0 else None


def cross_len(cfg: ModelConfig) -> int:
    """Positions of the cross caches: the encoder's frames, the image
    tokens, or 0 without cross-attention."""
    return (cfg.encoder_seq if cfg.is_encdec
            else cfg.n_image_tokens if cfg.cross_attn_period else 0)


def _cross_input(cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
                 known: Tuple[str, ...]) -> Optional[torch.Tensor]:
    """``batch``'s cross input for ``cfg`` (None where it has none);
    refuses keys other than ``known`` and that input's."""
    key = cross_input_key(cfg)
    extra = set(batch) - set(known) - {key}
    if extra:
        raise ValueError(
            f"{cfg.name}: inputs {sorted(extra)} are not used "
            + (f"(its cross-attention reads {key!r})" if key else
               "(it has no cross-attention layers)"))
    return batch.get(key)


class Encoder(nn.Module):
    """An encoder-decoder's encoder: a :class:`Stack` of
    :func:`encoder_config` run bidirectionally with no cache, then its own
    final norm."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.stack = Stack(encoder_config(cfg), device, dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)

    def forward(self, frames: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
        # on a mesh with sequence parallelism, by the encoder's own length;
        # the output, the cross-attention source, is whole
        with context.sequence_sharded(frames.shape[1]):
            h, _ = self.stack(context.shard_sequence(frames), caches=None,
                              causal=False, impl=impl)
            return context.gather_sequence(self.final_norm(h))


class LM(nn.Module):
    """LM: embed -> stack -> final norm -> (tied) head; an encoder-decoder
    also holds its :class:`Encoder` (``encoder``), a VLM whose image width
    is not ``d_model`` its patch projection ``img_proj`` (d_image, D)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = empty_param((V, D), device, dtype)
        self.stack = Stack(cfg, device, dtype)
        self.final_norm = RMSNorm(D, cfg.norm_eps, device, dtype)
        if not cfg.tie_embeddings:
            self.head = empty_param((D, V), device, dtype)
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, device, dtype)
        if cfg.cross_attn_period > 0 and cfg.d_image not in (0, D):
            self.img_proj = empty_param((cfg.d_image, D), device, dtype)
        # each module's prefix in the state dict, by which a mesh step's
        # scope finds its parameters' specs (parallel.context)
        for name, m in self.named_modules():
            m._pname = f"{name}." if name else ""

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from ``gen``, with the reference's distributions."""
        embed_init_(self.embed, gen)
        if not self.cfg.tie_embeddings:
            dense_init_(self.head, gen)
        if hasattr(self, "img_proj"):
            dense_init_(self.img_proj, gen)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def cross_source(self, cross_input: Optional[torch.Tensor],
                     impl: Optional[str] = None,
                     ) -> Optional[torch.Tensor]:
        """The states the cross-attention layers attend over: the encoder's
        output on ``frames`` (in the frames' and weights' promoted type,
        as JAX promotes them), or ``image_embeds`` through ``img_proj``
        and cast to the model's dtype; None without cross-attention."""
        key = cross_input_key(self.cfg)
        if key is None:
            return None
        if cross_input is None:
            raise ValueError(f"{self.cfg.name}: the batch needs {key!r}, "
                             "the input of its cross-attention layers")
        if self.cfg.is_encdec:
            return self.encoder(cross_input, impl)
        img = cross_input
        if hasattr(self, "img_proj"):
            img = promoted_einsum("bnd,de->bne", img,
                                  context.full(self, "img_proj"))
        return img.to(self.embed.dtype)

    def forward(self, tokens: torch.Tensor, impl: Optional[str] = None,
                cross_input: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Aux]:
        """The training forward: final-norm activations (B, S, D) of the
        whole sequence, causal, with no cache and under autograd, and the
        MoE layers' aux losses (:func:`forward_train` and :func:`loss_fn`
        run it on a parameter dict).  ``cross_input``: the batch's
        ``frames`` or ``image_embeds``."""
        x = embed(context.full(self, "embed"), tokens)
        cross = self.cross_source(cross_input, impl)
        # sequence parallelism: the stack and the final norm on the rank's
        # positions, the head on the whole sequence
        with context.sequence_sharded(x.shape[1]):
            x, aux = self.stack(context.shard_sequence(x), caches=None,
                                pos=0, causal=True, impl=impl,
                                cross_src=cross)
            return context.gather_sequence(self.final_norm(x)), aux

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = (context.full(self, "embed").T if self.cfg.tie_embeddings
                else context.full(self, "head"))
        return x @ head

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: List[LayerCache],
                impl: Optional[str] = None,
                cross_input: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """Process the prompt, filling the caches (the cross caches from
        ``cross_input``, through the encoder for an encoder-decoder).
        Returns last-position logits (B, 1, V) and the cache."""
        x = embed(context.full(self, "embed"), tokens)
        cross = self.cross_source(cross_input, impl)
        # under sequence parallelism the last position is the last rank's
        # last row: each rank's last row gathered
        with context.sequence_sharded(x.shape[1]):
            x, _ = self.stack(context.shard_sequence(x), caches=cache,
                              pos=0, causal=True, impl=impl, cross_src=cross)
            x = context.gather_sequence(x[:, -1:])
        x = self.final_norm(x[:, -1:, :])
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: List[LayerCache],
                    pos: int, impl: Optional[str] = None,
                    ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """One decode step. token: (B, 1) integer ids; pos: host integer,
        the position of ``token``.  Cross-attention reads its caches."""
        x = embed(context.full(self, "embed"), token)
        x, _ = self.stack(x, caches=cache, pos=int(pos), causal=True,
                          impl=impl)
        x = self.final_norm(x)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# forward / loss (training)
# ---------------------------------------------------------------------------

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3
CE_CHUNK = 512


@functools.lru_cache(maxsize=None)
def _skeleton(cfg: ModelConfig) -> LM:
    """The module structure of ``cfg`` with no storage, which
    ``functional_call`` runs on a parameter dict."""
    return LM(cfg, device="meta")


class _Method(nn.Module):
    """An :class:`LM` method as a module's forward, for
    ``functional_call``."""

    def __init__(self, lm: LM, method: str):
        super().__init__()
        self.lm, self.method = lm, method

    def forward(self, *args, **kwargs):
        return getattr(self.lm, self.method)(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def _method(cfg: ModelConfig, method: str) -> _Method:
    return _Method(_skeleton(cfg), method)


def call_lm(cfg: ModelConfig, method: str,
            params: Mapping[str, torch.Tensor], *args, **kwargs):
    """``LM.<method>(*args, **kwargs)`` of ``cfg`` run on the parameter
    dict ``params`` (the mesh steps' serving calls: ``"prefill"``,
    ``"decode_step"``)."""
    return torch.func.functional_call(
        _method(cfg, method), {f"lm.{k}": v for k, v in params.items()},
        args, kwargs, strict=True)


def _hidden(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor],
            impl: Optional[str]) -> Tuple[torch.Tensor, Aux]:
    """The final-norm activations (B, S, D) of ``batch["tokens"]`` and
    the MoE layers' aux losses, the model's modules run on ``params``
    (the cross input, where ``cfg`` has one, through its encoder or
    projection)."""
    cross = _cross_input(cfg, batch, ("tokens", "labels"))
    return torch.func.functional_call(
        _skeleton(cfg), dict(params), (batch["tokens"],),
        {"impl": impl, "cross_input": cross}, strict=True)


def _head(params: Mapping[str, torch.Tensor], cfg: ModelConfig):
    if cfg.tie_embeddings:
        return context.full_param("embed", params["embed"]).T
    return context.full_param("head", params["head"])


def forward_train(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  batch: Mapping[str, torch.Tensor],
                  impl: Optional[str] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Logits (B, S, V) of the whole sequence, causal, no cache; and the
    layers' aux losses (none without MoE layers)."""
    x, aux = _hidden(params, cfg, batch, impl)
    return x @ _head(params, cfg), aux


def _ce_chunk(head: torch.Tensor, xc: torch.Tensor, yc: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = (xc @ head).float()                        # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, yc.clamp_min(0)[..., None])[..., 0]
    mask = (yc >= 0).float()
    return torch.sum((lse - lab) * mask), torch.sum(mask)


def _chunked_ce(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum CE and token count over S in chunks of ``chunk``, each chunk's
    fp32 logits recomputed in the backward (``torch.utils.checkpoint``,
    where the reference's scan body is ``jax.checkpoint``ed), so the fp32
    logit tensor never fully materializes."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # fall back to single chunk for odd lengths
    ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        s, n = checkpoint(_ce_chunk, head, x[:, i:i + chunk],
                          labels[:, i:i + chunk], use_reentrant=False)
        ce_sum, n_tok = ce_sum + s, n_tok + n
    return ce_sum, n_tok


def loss_fn(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor], impl: Optional[str] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the labels >= 0, in fp32 (on a
    mesh, over the global batch), plus
    the MoE aux losses (``MOE_LB_WEIGHT`` x load balance + ``MOE_Z_WEIGHT``
    x z-loss) where the model has MoE layers; the metrics ``{"ce_loss",
    "loss"}`` and the aux losses ``moe_load_balance``, ``moe_z_loss`` and
    ``moe_drop_fraction``."""
    x, aux = _hidden(params, cfg, batch, impl)
    ce_sum, n_tok = _chunked_ce(_head(params, cfg), x, batch["labels"],
                                CE_CHUNK)
    # on a mesh: the global batch's sums, each rank's own tokens local
    ce_sum, n_tok = context.batch_sum(ce_sum), context.batch_sum(n_tok)
    loss = ce_sum / torch.clamp(n_tok, min=1.0)
    metrics = {"ce_loss": loss, **aux}
    if "moe_load_balance" in aux:
        loss = (loss + MOE_LB_WEIGHT * aux["moe_load_balance"]
                + MOE_Z_WEIGHT * aux["moe_z_loss"])
    metrics["loss"] = loss
    return loss, metrics


def prefill(model: LM, batch: Mapping[str, torch.Tensor],
            cache: List[LayerCache], impl: Optional[str] = None,
            ) -> Tuple[torch.Tensor, List[LayerCache]]:
    """Process the prompt ``batch["tokens"]`` (B, S), writing the caches
    (the cross caches from the batch's ``frames`` or ``image_embeds``).
    Returns last-position logits (B, 1, V) and the cache."""
    cross = _cross_input(model.cfg, batch, ("tokens",))
    return model.prefill(batch["tokens"], cache, impl=impl,
                         cross_input=cross)


def decode_step(model: LM, token: torch.Tensor, cache: List[LayerCache],
                pos: int, impl: Optional[str] = None,
                ) -> Tuple[torch.Tensor, List[LayerCache]]:
    """One decode step. token: (B, 1) integer ids; pos: host integer.
    The cross-attention layers read the cross caches that prefill wrote."""
    return model.decode_step(token, cache, pos, impl=impl)


# ---------------------------------------------------------------------------
# bundle
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], LM]
    loss: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    forward: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[..., Tuple[torch.Tensor, List[LayerCache]]]
    decode: Callable[..., Tuple[torch.Tensor, List[LayerCache]]]
    make_cache: Callable[[int, int], List[LayerCache]]
    cache_spec: Callable[[int, int], List[Dict[str, Any]]]
    dtype: Optional[torch.dtype] = None      # weights' and KV caches'


def build_model(cfg: ModelConfig, device=None,
                dtype: Optional[torch.dtype] = None) -> ModelBundle:
    """The serving bundle of ``cfg`` on ``device`` (None: the card, which
    raises without one; pass ``device="cpu"`` for the CPU).  ``dtype``
    overrides ``cfg.dtype`` for weights and KV caches (SSM state stays
    fp32).  ``init(seed)`` returns an :class:`LM` with random weights made
    on the device from ``seed``; ``loss(params, batch, impl=None)`` and
    ``forward(params, batch, impl=None)`` are :func:`loss_fn` and
    :func:`forward_train` on a parameter dict.  The caches'
    cross-attention entries have the reference's ``cross_len``:
    ``encoder_seq`` for an encoder-decoder, ``n_image_tokens`` for a
    VLM."""
    dev = resolve_device(device)
    n_cross = cross_len(cfg)
    dt = getattr(torch, cfg.dtype) if dtype is None else dtype

    def init(seed: int) -> LM:
        model = LM(cfg, device=dev, dtype=dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.reset_parameters(gen)
        return model.eval()

    return ModelBundle(
        cfg=cfg, device=dev, init=init,
        loss=functools.partial(
            lambda p, b, c=cfg, **kw: loss_fn(p, c, b, **kw)),
        forward=functools.partial(
            lambda p, b, c=cfg, **kw: forward_train(p, c, b, **kw)),
        prefill=prefill, decode=decode_step,
        make_cache=lambda batch, s_max: init_cache(cfg, batch, s_max, dt,
                                                   dev, n_cross),
        cache_spec=lambda batch, s_max: stack_cache_spec(cfg, batch, s_max,
                                                         dt, n_cross),
        dtype=dt)


# ---------------------------------------------------------------------------
# JAX parameters -> the port's state dict
# ---------------------------------------------------------------------------

_STACK_PATH = re.compile(r"(encoder/)?stack/layer(\d+)/(.+)")


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):              # a restored checkpoint's
        return a.clone()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":               # ml_dtypes' numpy bf16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(cfg: ModelConfig,
                    tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree as numpy (``jax.tree.map(np.asarray, params)``)
    or as CPU tensors (a restored checkpoint's) -> the port's state dict
    (CPU tensors, the tree's dtypes).

    The leading superblock axis of ``stack/layer{j}/...`` is unstacked
    into layers ``sb * superblock_size + j``, and so is an encoder's
    ``encoder/stack/layer{j}/...`` over the superblocks of
    :func:`encoder_config`.  A tree whose paths or leaf shapes do not
    match ``cfg`` is refused.  Load the result with
    ``model.load_state_dict(sd)``.
    """
    want = {k: tuple(v.shape)
            for k, v in LM(cfg, device="meta").state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in tree_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        m = _STACK_PATH.fullmatch(path)
        if m is None:
            out[path.replace("/", ".")] = _to_tensor(leaf)
            continue
        enc, j, rest = m.group(1), int(m.group(2)), m.group(3)
        stack_cfg = encoder_config(cfg) if enc else cfg
        n_sb, size = stack_cfg.n_superblocks, stack_cfg.superblock_size
        if leaf.ndim == 0 or leaf.shape[0] != n_sb:
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{leaf.shape}, not {n_sb} stacked superblocks")
        prefix = "encoder.stack" if enc else "stack"
        for sb in range(n_sb):
            out[f"{prefix}.{sb * size + j}.{rest.replace('/', '.')}"] = \
                _to_tensor(leaf[sb])
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


def decayed_names(params: Mapping[str, torch.Tensor]) -> List[str]:
    """The parameters AdamW decays as the reference does: its optimizer
    decays the leaves of two or more dimensions of its tree, which stacks
    every layer's parameter over the superblocks (an encoder's too), so a
    layer's vector (norm scale, bias, ``D``) is decayed there and the
    final norms are not.

    >>> decayed_names({"stack.0.norm1.scale": torch.ones(4),
    ...                "encoder.stack.1.norm2.scale": torch.ones(4),
    ...                "encoder.final_norm.scale": torch.ones(4),
    ...                "final_norm.scale": torch.ones(4),
    ...                "embed": torch.ones(2, 4)})
    ['stack.0.norm1.scale', 'encoder.stack.1.norm2.scale', 'embed']
    """
    return [k for k, p in params.items()
            if p.ndim >= 2 or _STACK_NAME.match(k)]


_STACK_NAME = re.compile(r"(encoder\.)?stack\.\d+\.")


def opt_state_from_jax(cfg: ModelConfig, opt: Mapping[str, Any],
                       ) -> Dict[str, Any]:
    """The JAX optimizer state ``{"m", "v", "step"}`` (as numpy; ``m``
    and ``v`` mirror the parameter tree) -> the port's: the moments under
    the port's parameter names (CPU tensors, their dtypes), the step an
    int32 scalar."""
    step = np.asarray(opt["step"]).reshape(-1)[0]
    return {"m": params_from_jax(cfg, opt["m"]),
            "v": params_from_jax(cfg, opt["v"]),
            "step": torch.tensor(int(step), dtype=torch.int32)}


def train_state_from_jax(cfg: ModelConfig, state: Mapping[str, Any],
                         ) -> Dict[str, Any]:
    """A JAX train state ``{"params", "opt"}`` -> the port's, for
    ``parallel.make_train_step``'s step and ``train.loop.train``.  Takes
    it as numpy (``jax.tree.map(np.asarray, state)``) or as
    ``train.checkpoint.restore_checkpoint`` reads a directory that the
    JAX package wrote."""
    return {"params": params_from_jax(cfg, state["params"]),
            "opt": opt_state_from_jax(cfg, state["opt"])}
