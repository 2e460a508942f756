"""phi-3-vision-4.2b [vlm] — the phi3-mini backbone with a CLIP frontend
stub. [hf:microsoft/Phi-3-vision-128k-instruct]

The transformer backbone only is modeled: precomputed patch embeddings
(``patch_embeds``, (B, 256, d_model)) are prepended to the text tokens.
head_dim 96, so a KV vector keeps ``kv_keep(96) = 64`` values.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32_064, head_dim=96, ffn_act="swiglu",
    rope_theta=10_000.0, norm_eps=1e-5,
    frontend="vision", frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, head_dim=32, ffn_act="swiglu",
    frontend="vision", frontend_tokens=16,
)
