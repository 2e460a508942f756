"""Feed-forward blocks (port of ``models/ffn.py``): the dense SwiGLU MLP.

MoE (``ffn.moe``) joins with its slice (ROADMAP Queue 1 step 9).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime


def mlp(rt: Runtime, p: dict, x: torch.Tensor, path: str = "ffn") -> torch.Tensor:
    """Dense SwiGLU FFN: w_down(silu(w_gate x) * w_up x)."""
    if "w_gate" not in p:
        raise NotImplementedError(
            f"ffn_act={rt.cfg.ffn_act!r}: the port has SwiGLU only; other "
            "activations come with their families (ROADMAP Queue 1 step 9)")
    g = L.dense(rt, p["w_gate"], x, f"{path}.gate")
    u = L.dense(rt, p["w_up"], x, f"{path}.up")
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return L.dense(rt, p["w_down"], h, f"{path}.down")
