"""mistral-large-123b [dense] — GQA.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab_size=32_768, head_dim=128, ffn_act="swiglu",
    rope_theta=1_000_000.0, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, ffn_act="swiglu",
)
