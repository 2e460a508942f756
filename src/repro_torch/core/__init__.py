"""Cassandra core: format transformation + speculative acceptance."""
from repro_torch.core.format import (  # noqa: F401
    CassandraConfig,
    PAPER_DEFAULT,
    format_weight,
    draft_weight,
    target_weight,
    format_kv,
    draft_kv,
    target_kv,
    compression_summary,
    tree_nbytes,
)
from repro_torch.core.speculative import (  # noqa: F401
    AcceptResult,
    greedy_accept,
    rejection_sample,
    expected_tokens_per_cycle,
    speedup_model,
)
