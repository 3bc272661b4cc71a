"""Input-shape registry for the assigned (architecture x shape) grid.

Four LM-family shapes; ``train_*`` lowers train_step, ``prefill_*`` lowers
serve_prefill, ``decode_*``/``long_*`` lower serve_decode (one new token
against a KV cache of seq_len).  ``long_500k`` requires sub-quadratic
sequence mixing and is skipped (with a recorded reason) for pure
full-attention architectures, per the assignment rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: O(L^2) attention at 524k "
                       "context; long_500k reserved for SSM/hybrid/linear "
                       "mixers (DESIGN.md §Arch-applicability)")
    return True, ""
