"""Sharded checkpoints (port of ``checkpoint/``): atomic manifest, elastic
resharding, auto-resume, in the reference's on-disk format."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
