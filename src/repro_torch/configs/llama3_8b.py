"""llama3-8b — the paper's primary evaluation model (DeepSeek-R1-Distill-
Llama3-8B shares this architecture). [hf:meta-llama/Meta-Llama-3-8B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128_256, head_dim=128, ffn_act="swiglu",
    rope_theta=500_000.0, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, ffn_act="swiglu",
)
