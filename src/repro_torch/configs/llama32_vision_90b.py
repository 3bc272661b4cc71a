"""llama-3.2-vision-90b [vlm]: 100L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256.  Cross-attention image layers every 5th layer
(80 self + 20 cross); the vision patch frontend is a STUB — the model
consumes precomputed (B, 1600, 1280) patch embeddings projected into
d_model.  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, cross_attn_period=5, cross_attn_offset=3,
    n_image_tokens=1600, d_image=1280, rope_theta=5e5,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_image_tokens=16, d_image=32)
