"""Model zoo of the port: the serving path of decoder-only LMs in PyTorch."""

from .config import ModelConfig
from .model_zoo import (LM, ModelBundle, build_model, decode_step,
                        params_from_jax, prefill)

__all__ = ["LM", "ModelBundle", "ModelConfig", "build_model", "decode_step",
           "params_from_jax", "prefill"]
