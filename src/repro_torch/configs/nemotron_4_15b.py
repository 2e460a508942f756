"""nemotron-4-15b [dense] — GQA, squared-ReLU FFN. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256_000, head_dim=128, ffn_act="relu2",
    rope_theta=10_000.0, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, ffn_act="relu2",
)
