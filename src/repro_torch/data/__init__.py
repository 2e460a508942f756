"""Data pipeline (port of ``data/``): the deterministic synthetic and
file-backed token streams."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    Prefetcher,
    host_shard_iterator,
    synthetic_batches,
)
