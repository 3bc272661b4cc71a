"""The train step on one device.

Counterpart of the ``make_train_step`` half of
``src/repro/parallel/steps.py``, for one device: the reference's GSPMD
shardings, donation and activation constraints are a no-op on one device
and are left out (the multi-device steps are ROADMAP item 12e).  The step
runs the loss forward and backward under autograd (the attention and scan
kernels carry their gradient: ``kernels/ops.py``), then ``adamw_update``,
which updates the state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.shapes import ShapeSpec
from ..models.model_zoo import decayed_names
from ..train.optimizer import OptimizerConfig, adamw_update

Params = Dict[str, Any]


@dataclass(frozen=True)
class BuiltStep:
    fn: Callable                    # fn(state, batch) -> (state, metrics)


def make_train_step(bundle, mesh, shape: ShapeSpec,
                    opt_cfg: OptimizerConfig = OptimizerConfig(),
                    impl: Optional[str] = None) -> BuiltStep:
    """``fn(state, batch)`` for ``state = {"params": {name: tensor},
    "opt": init_opt_state(...)}`` and a batch ``{"tokens", "labels"}`` of
    ``(global_batch, seq_len)`` integer tensors on the mesh's device, with
    an encoder-decoder's ``frames`` or a VLM's ``image_embeds`` beside
    them (``SyntheticTokenPipeline.with_frontend_stubs``'s, float32),
    which the loss feeds to the cross-attention layers: returns the
    updated state (its tensors updated in place) and the reference's
    metrics ``loss``, ``ce_loss``, ``grad_norm`` and ``lr`` (0-dim
    tensors).  Weight decay falls where the reference's falls on
    its stacked tree (``decayed_names``)."""
    if shape.kind != "train":
        raise ValueError(f"make_train_step: shape {shape.name!r} is a "
                         f"{shape.kind} shape")

    def train_step(state: Params, batch: Params):
        params = state["params"]
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, metrics = bundle.loss(leaves, batch, impl=impl)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        new_params, new_opt, stats = adamw_update(
            params, grads, state["opt"], opt_cfg,
            decayed=set(decayed_names(params)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(stats)
        return {"params": new_params, "opt": new_opt}, metrics

    return BuiltStep(fn=train_step)
