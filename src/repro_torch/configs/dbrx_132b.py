"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100_352, head_dim=128, ffn_act="swiglu",
    rope_theta=500_000.0, norm_eps=1e-5,
    block_pattern=("aM",), n_experts=16, n_experts_per_tok=4,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, ffn_act="swiglu",
    block_pattern=("aM",), n_experts=4, n_experts_per_tok=2,
)
