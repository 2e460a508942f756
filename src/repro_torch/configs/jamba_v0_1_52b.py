"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE every 2nd layer.

[arXiv:2403.19887; hf]. Period-8 block pattern (attn at offset 4, MoE at odd
offsets — HF attn_layer_period=8/offset=4, expert_layer_period=2/offset=1).
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = ("sm", "sM", "sm", "sM", "am", "sM", "sm", "sM")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65_536, head_dim=128, ffn_act="swiglu", norm_eps=1e-6,
    block_pattern=_PATTERN, n_experts=16, n_experts_per_tok=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=32, ffn_act="swiglu", norm_eps=1e-6,
    block_pattern=_PATTERN, n_experts=4, n_experts_per_tok=2,
    ssm_state=4, ssm_conv=4, ssm_expand=2,
)
