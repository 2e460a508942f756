"""whisper-medium [audio] — encoder-decoder; the mel/conv frontend is a
stub. [arXiv:2212.04356]

24 encoder + 24 decoder layers; precomputed frame embeddings (B, 1500,
d_model) arrive as ``frame_embeds``. The decoder's self-attention KV cache
is Cassandra-packed. Cross-attention K/V are computed once per request at
prefill and cached as plain bf16: the reference's docstring says "also
packed", its cache code (``serving/kvcache.py``) keeps them plain, and the
port follows the code.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51_865, head_dim=64, ffn_act="gelu",
    norm_eps=1e-5, n_encoder_layers=24, cross_attention=True,
    frontend="audio", frontend_tokens=1500, max_wavelength_pos=32_768,
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, head_dim=32, ffn_act="gelu",
    n_encoder_layers=2, cross_attention=True,
    frontend="audio", frontend_tokens=32, max_wavelength_pos=1024,
)
