"""AdamW optimizer with warmup-cosine schedule and global-norm clipping.

Counterpart of ``src/repro/train/optimizer.py`` on the port's parameter
dict (name -> tensor, as ``LM.state_dict()`` names them).  The moments
``m`` and ``v`` mirror the parameters in ``state_dtype`` (float32 by
default); the update runs in float32 and is cast back to each
parameter's dtype, in the reference's order of operations, and weight
decay applies to tensors of two or more dimensions only.

Unlike the reference's pure update, :func:`adamw_update` writes the new
parameters and moments into the given tensors **in place**, so a step
holds one copy of the train state on the card (at qwen2.5-3b's full width
the bf16 parameters and float32 moments are ~30 GB; a second copy would
not fit beside the activations).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Collection, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_fraction: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # bf16 for the 400B+ configs


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_fraction, in float32.

    >>> cfg = OptimizerConfig(learning_rate=1.0, warmup_steps=10,
    ...                       total_steps=100)
    >>> [round(float(lr_at(cfg, torch.tensor(s))), 4) for s in (0, 5, 10)]
    [0.0, 0.5, 1.0]
    """
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * progress))
    frac = cfg.min_lr_fraction + (1 - cfg.min_lr_fraction) * cosine
    return cfg.learning_rate * warm * frac


def init_opt_state(params: Params, cfg: OptimizerConfig) -> Dict:
    """Zero moments in ``state_dtype`` beside each parameter, and the
    step (an int32 scalar on the parameters' device)."""
    dt = getattr(torch, cfg.state_dtype)
    device = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict,
                 cfg: OptimizerConfig,
                 decayed: Optional[Collection[str]] = None,
                 grad_norm: Optional[torch.Tensor] = None,
                 ) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    """One clipped AdamW step; returns ``(params, state, {"grad_norm",
    "lr"})`` with the parameters and moments updated in place.

    Weight decay applies to the tensors of two or more dimensions, or to
    the names in ``decayed`` where given: the reference decays the leaves
    of its tree, where a layer's vector is stacked over the superblocks
    into a matrix (``models.model_zoo.decayed_names``).  ``grad_norm``:
    the gradients' global norm where ``grads`` are one rank's shards (a
    mesh step's), else it is theirs."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), step_f)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if (p.ndim >= 2 if decayed is None else k in decayed):
            # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
