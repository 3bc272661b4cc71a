"""arctic-480b [moe]: 35L, d_model=7168, 56H (GQA kv=8), d_ff=4864,
vocab=32000.  128 experts top-2 with a DENSE RESIDUAL MLP in parallel
(Snowflake Arctic dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000,
    n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True,
    moe_period=1,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    d_ff_expert=64, vocab_size=256, n_experts=4, top_k=2)
