"""jamba-1.5-large-398b [hybrid]: 72L, d_model=8192, 64H (GQA kv=8),
d_ff=24576, vocab=65536.  Mamba+attention 1:7 interleave (attention at
layer 4 of each 8-layer block), MoE 16e top-2 on every other layer.
[arXiv:2403.19887; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_period=8, attn_offset=4,       # 1 attention per 8 layers
    n_experts=16, top_k=2, moe_period=2, moe_offset=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, ssm_state=8, n_experts=4, top_k=2)
