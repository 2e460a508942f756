"""Primitive layers (port of ``models/layers.py``).

Every matmul weight is a plain bf16 tensor or a Cassandra-packed
``{"spec", "verif", "kernel"}`` dict, resolved per the runtime ``view``:

* ``plain``  — a plain tensor (bf16 baseline);
* ``draft``  — the draft pass: every packed product runs through the
  draft-matmul kernel wrapper (the plain version on CPU tensors);
* ``target`` — the exact weight, rebuilt from speculation + verification
  data one matrix at a time and freed after its product.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.format import CassandraConfig, draft_weight, target_weight
from repro_torch.kernels import draft_matmul as DM


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Static per-call context threaded through all layer functions.

    It names no device: every function follows its tensors' device, and
    each kernel wrapper launches the hand-written kernel on CUDA tensors
    and its plain version on CPU tensors (``kernels/draft_matmul.py``,
    ``kernels/paged_attention.py``).

    ``attn_kernel`` chooses the cached-decode attention of a paged cache:
    ``"off"`` gathers each row's prefix through its block table and
    attends densely (the reference's gather path); ``"on"`` walks the
    table through ``kernels/paged_attention`` and never gathers. It needs
    a paged cache (``serving.engine.validate_serving_knobs``).
    """
    cfg: ModelConfig
    cass: CassandraConfig | None = None
    view: str = "plain"                 # plain | draft | target
    attn_kernel: str = "off"            # off | on
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024


def is_packed(w) -> bool:
    return isinstance(w, dict) and "spec" in w


packed_shape = DM.packed_shape


def resolve_weight(rt: Runtime, w, path: str = "") -> torch.Tensor:
    """Materialise a weight leaf per the runtime view."""
    if not is_packed(w):
        return w
    if rt.cass is None:
        raise ValueError(f"packed weight {path} but no CassandraConfig")
    shape = packed_shape(w)
    if rt.view == "draft":
        return draft_weight(w["spec"], rt.cass, shape)
    if rt.view == "target":
        return target_weight(w["spec"], w["verif"], rt.cass, shape)
    raise ValueError(f"packed weight {path} under view={rt.view!r}")


def dense(rt: Runtime, p: dict, x: torch.Tensor, path: str = "") -> torch.Tensor:
    """x @ W (+ b). ``p`` = {"w": tensor-or-packed, optional "b"}."""
    w = p["w"]
    if is_packed(w) and rt.view == "draft":
        y = DM.packed_matmul(x, w, rt.cass)
    else:
        y = torch.matmul(x, resolve_weight(rt, w, path).to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def norm(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        raise NotImplementedError("layernorm belongs to the encoder-decoder "
                                  "slice: ROADMAP Queue 1 step 9")
    return rmsnorm(p, x, rt.cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B,S,H,D) with positions (B,S) or (S,). Half-split convention."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # (B,S,D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.to(torch.int64)]


def unembed(rt: Runtime, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final projection to vocab logits (f32)."""
    if rt.cfg.tie_embeddings:
        w = params["embed"]["table"].T
        return torch.matmul(x, w.to(x.dtype)).to(torch.float32)
    return dense(rt, params["lm_head"], x, "lm_head").to(torch.float32)
