"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab_size=151_936, head_dim=128, qk_norm=True, ffn_act="swiglu",
    rope_theta=1_000_000.0, norm_eps=1e-6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-1.7b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, qk_norm=True, ffn_act="swiglu",
    norm_eps=1e-6, tie_embeddings=True,
)
