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
import functools
from typing import Any

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

    ``collector`` is a calibration stats collector (``packing.Calibrator``):
    ``dense`` and ``unembed`` hand it each product's input, keyed by the
    weight's path.

    ``moe_capacity_factor`` sizes each expert's slots against a perfectly
    balanced router (``ffn.moe_capacity``). At ``n_experts /
    n_experts_per_tok`` or more no token is ever dropped, so no row's
    output depends on what else rides in its batch.

    ``remat`` recomputes each layer block's activations in the backward
    pass of a ``mode="train"`` forward (``torch.utils.checkpoint``, non-
    reentrant) instead of keeping them: ``remat_policy`` ``"full"`` keeps
    the block's input only, ``"dots"`` the outputs of its matrix products
    without batch dimensions too (the reference's
    ``dots_with_no_batch_dims_saveable``: ``aten.mm`` / ``addmm``, not the
    attention's batched products). The reference's ``unroll`` serves XLA's
    cost analysis; the port's layer loops are Python loops already.

    There is no ``ssm_chunk``: the reference's scan chunk sizes its
    associative scan, and the port's Mamba recurrence runs step by step
    (``models/ssm.py``), which has no chunk.
    """
    cfg: ModelConfig
    cass: CassandraConfig | None = None
    view: str = "plain"                 # plain | draft | target
    collector: Any = None               # calibration stats collector
    attn_kernel: str = "off"            # off | on
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    moe_capacity_factor: float = 1.25   # per-expert slots vs perfect balance
    remat: bool = False                 # checkpoint each layer block (train)
    remat_policy: str = "full"          # full | dots (save matmul outputs)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of products without batch dimensions, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(rt: Runtime, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``rt.remat`` is
    set and autograd records (otherwise there is nothing to keep)."""
    if not (rt.remat and torch.is_grad_enabled()):
        return fn(*args)
    from torch.utils import checkpoint as C
    if rt.remat_policy == "dots":
        kw = {"context_fn": functools.partial(
            C.create_selective_checkpoint_contexts, _save_dots)}
    elif rt.remat_policy == "full":
        kw = {}
    else:
        raise ValueError(f"unknown remat_policy {rt.remat_policy!r}")
    return C.checkpoint(fn, *args, use_reentrant=False, **kw)


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
    """x @ W (+ b). ``p`` = {"w": tensor-or-packed, optional "b"};
    ``path`` is the weight's key in its layer (``attn.wq``)."""
    if rt.collector is not None:
        rt.collector.observe(path, x)
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


def layernorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 layer norm with the population variance (``jnp.var``), as the
    reference's: never torch's default unbiased ``var``."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def norm(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    """A norm with a ``bias`` (the audio family's) is a layer norm, any
    other an RMS norm."""
    if "bias" in p:
        return layernorm(p, x, rt.cfg.norm_eps)
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
        if rt.collector is not None:
            rt.collector.observe("lm_head", x)
        return torch.matmul(x, w.to(x.dtype)).to(torch.float32)
    return dense(rt, params["lm_head"], x, "lm_head").to(torch.float32)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal table (n, d) f32: sines, then cosines, of
    position x exp(-log(10000) i / (d/2 - 1))."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    log_t = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                   device=device))
    inv = torch.exp(-log_t * torch.arange(d // 2, dtype=torch.float32,
                                          device=device)
                    / max(d // 2 - 1, 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "swiglu":  # handled by ffn (gated)
        return torch.nn.functional.silu
    if name == "relu2":
        return _relu2
    if name == "gelu":
        return _gelu
    raise ValueError(f"unknown activation {name}")
