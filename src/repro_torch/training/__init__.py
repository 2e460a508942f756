"""Training (port of ``training/``): AdamW with fp32 or int8 moments,
``train_step`` with gradient accumulation."""
from repro_torch.training.optim import (  # noqa: F401
    OptConfig,
    apply_updates,
    init_opt_state,
)
from repro_torch.training.trainer import TrainConfig, train_step  # noqa: F401
