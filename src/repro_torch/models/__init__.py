"""Model zoo of the port: decoder-only, encoder-decoder and VLM LMs in
PyTorch, for serving and training."""

from .config import ModelConfig
from .model_zoo import (LM, ModelBundle, build_model, decode_step,
                        forward_train, loss_fn, opt_state_from_jax,
                        params_from_jax, prefill, train_state_from_jax)

__all__ = ["LM", "ModelBundle", "ModelConfig", "build_model", "decode_step",
           "forward_train", "loss_fn", "opt_state_from_jax",
           "params_from_jax", "prefill", "train_state_from_jax"]
