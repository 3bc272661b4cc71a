"""kimi-k2-1t-a32b [moe]: 61L, d_model=7168, 64H (GQA kv=8, head_dim=128),
d_ff_expert=2048, vocab=163840.  MoE 384 experts top-8 + 1 shared expert
on every layer — trillion-param MoE, ~32B active.
[arXiv:2501.kimi2; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1,
    moe_period=1, rope_theta=5e4,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, d_ff_expert=32, vocab_size=256, n_experts=8, top_k=2,
    n_shared_experts=1)
