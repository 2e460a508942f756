"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port knows the paper's primary model and deepseek-v3-671b (MLA; its
routed-expert layers raise until MoE is ported); the other families join
with their ROADMAP Queue 1 slices. ``smoke=True`` returns the reduced
same-family config the CPU tests use.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LayerGroup,
    ModelConfig,
    layer_groups,
)

_MODULES = {
    "llama3-8b": "llama3_8b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_MODULES)} (other families: ROADMAP "
                       "Queue 1 step 9)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
