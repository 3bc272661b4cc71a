"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048,
vocab=51865.  Encoder-decoder; the audio conv frontend is a STUB — the
model consumes precomputed (B, 1500, 512) frame embeddings.
[arXiv:2212.04356; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865, encoder_layers=6, encoder_seq=1500,
    cross_attn_period=1, cross_attn_offset=0,  # every decoder layer
    act="gelu",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, encoder_layers=2, encoder_seq=32)
