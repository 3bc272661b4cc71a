"""Initialisers and parameter-tree utilities of the port's models.

Counterpart of ``src/repro/models/module.py``.  The initialisers fill a
tensor in place from an explicit ``torch.Generator`` on the tensor's
device, with the reference's distributions: truncated-normal fan-in
(std ``1/sqrt(shape[-2])``, cut at +-3 sigma, drawn in fp32 and cast),
embeddings ``N(0, 0.02)``.  The bits differ from JAX's (another
generator); tests carry JAX weights across with
:func:`repro_torch.models.params_from_jax` instead.
"""

from __future__ import annotations

import math
from typing import Any, Iterator, Mapping, NamedTuple, Optional, Tuple

import torch


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (a cache entry)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def empty_param(shape, device, dtype) -> torch.nn.Parameter:
    """An uninitialised weight (serving only: no gradient)."""
    return torch.nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                              requires_grad=False)


def dense_init_(t: torch.Tensor, gen: torch.Generator,
                scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LLM standard), in place."""
    fan_in = t.shape[-2] if t.ndim >= 2 else t.shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -3.0, 3.0, generator=gen)
    with torch.no_grad():
        return t.copy_(draw.mul_(std))


def embed_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``N(0, 0.02)``, drawn in fp32 and cast, in place."""
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.normal_(draw, 0.0, 1.0, generator=gen)
    with torch.no_grad():
        return t.copy_(draw.mul_(0.02))


# ---------------------------------------------------------------------------
# tree utilities (nested dicts, or flat state dicts; tree_paths also
# walks numpy trees)
# ---------------------------------------------------------------------------

def tree_paths(params: Mapping[str, Any],
               prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield (path, leaf) with '/'-joined dict keys, in sorted key order."""
    for k in sorted(params.keys()):
        v = params[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from tree_paths(v, p)
        else:
            yield p, v


def tree_param_count(params: Mapping[str, Any]) -> int:
    return sum(leaf.numel() for _, leaf in tree_paths(params))


def tree_size_bytes(params: Mapping[str, Any]) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in tree_paths(params))
