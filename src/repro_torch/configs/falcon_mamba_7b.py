"""falcon-mamba-7b [ssm]: 64L, d_model=4096, attention-free Mamba-1,
ssm_state=16, vocab=65024.  No MLP sublayer (pure Mamba blocks).
[arXiv:2410.05355; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024, ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_period=0,  # attention-free
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, vocab_size=256, ssm_state=8)
