"""minicpm-2b [dense]: 40L, d_model=2304, 36H (MHA kv=36), d_ff=5760,
vocab=122753.  WSD schedule; arch is llama-like MHA.
[arXiv:2404.06395; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256)
