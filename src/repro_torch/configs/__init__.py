"""Architecture config registry: ``--arch <id>`` resolution.

A copy of ``src/repro/configs`` (data only, no framework).  Every
architecture resolves; :func:`repro_torch.models.build_model` refuses the
families the port does not run yet (MoE, encoder-decoder, VLM).

Ten assigned architectures (each with a reduced SMOKE_CONFIG of the same
family) plus the paper's own cluster config for the reliability simulator.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, ShapeSpec, applicable

#: arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "whisper-base": "whisper_base",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-34b": "granite_34b",
    "yi-9b": "yi_9b",
    "minicpm-2b": "minicpm_2b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "arctic-480b": "arctic_480b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "all_configs", "applicable",
           "get_config"]
