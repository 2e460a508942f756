"""qwen2.5-3b [dense] — GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151_936, head_dim=128, qkv_bias=True, ffn_act="swiglu",
    rope_theta=1_000_000.0, norm_eps=1e-6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, qkv_bias=True, ffn_act="swiglu",
    norm_eps=1e-6, tie_embeddings=True,
)
