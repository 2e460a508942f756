"""deepseek-v3-671b — MLA attention, 1 shared + 256 routed top-8 experts,
multi-token prediction. [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]

d_ff=18432 is the dense FFN of the first 3 layers; moe_d_ff=2048 the
routed experts'. MLA caches the 512-d latent ``c`` and the 64-d rope key
``kr`` per token; Cassandra's per-token KV pruning acts on both. The
routed layers run ``models.ffn.moe`` (the routed experts and the router
stay unpacked, as in the reference); serving ignores the MTP head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129_280, ffn_act="swiglu",
    rope_theta=10_000.0, norm_eps=1e-6,
    block_pattern=("aM",), n_experts=256, n_experts_per_tok=8,
    n_shared_experts=1, first_dense_layers=3, moe_d_ff=2048,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, ffn_act="swiglu", norm_eps=1e-6,
    block_pattern=("aM",), n_experts=4, n_experts_per_tok=2,
    n_shared_experts=1, first_dense_layers=1, moe_d_ff=64,
    mla=True, q_lora_rank=64, kv_lora_rank=64,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32, mtp_depth=1,
)
