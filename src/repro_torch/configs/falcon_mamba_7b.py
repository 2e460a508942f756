"""falcon-mamba-7b [ssm] — attention-free mamba-1. [arXiv:2410.05355; unverified]

64 pure mamba-1 blocks (no FFN, no attention, no KV cache). Cassandra's KV
technique does not apply; the draft pass reads the packed projections of
each mixer (weights-only speculation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65_024, block_pattern=("s-",),
    ssm_state=16, ssm_conv=4, ssm_expand=2, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=512, block_pattern=("s-",),
    ssm_state=4, ssm_conv=4, ssm_expand=2,
)
