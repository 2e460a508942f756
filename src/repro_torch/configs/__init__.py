"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port knows the paper's two models (llama3-8b, qwen3-4b), the dense
GQA family (qwen3-1.7b, qwen2.5-3b, nemotron-4-15b, mistral-large-123b),
the MoE models (dbrx-132b, deepseek-v3-671b with MLA) and the Mamba-1
models (falcon-mamba-7b, and jamba-v0.1-52b, a hybrid of Mamba, GQA and
MoE layers), the encoder-decoder audio model (whisper-medium) and the
vision-frontend backbone (phi-3-vision-4.2b): every architecture the
reference registers.
``smoke=True`` returns the reduced same-family config the CPU tests use.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LayerGroup,
    ModelConfig,
    layer_groups,
)

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2.5-3b": "qwen2_5_3b",
    "nemotron-4-15b": "nemotron_4_15b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-medium": "whisper_medium",
    # the paper's own evaluation models
    "llama3-8b": "llama3_8b",
    "qwen3-4b": "qwen3_4b",
}


# the reference's registry order: its first ten keys are the assigned
# architectures, then the paper's own evaluation models
ASSIGNED = ("qwen3-1.7b", "mistral-large-123b", "qwen2.5-3b",
            "nemotron-4-15b", "falcon-mamba-7b", "phi-3-vision-4.2b",
            "whisper-medium", "dbrx-132b", "deepseek-v3-671b",
            "jamba-v0.1-52b")
PAPER_MODELS = ("llama3-8b", "qwen3-4b")
ALL_ARCHS = ASSIGNED + PAPER_MODELS


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
