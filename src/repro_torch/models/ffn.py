"""Feed-forward blocks (port of ``models/ffn.py``): the dense MLP (SwiGLU,
squared-ReLU or GELU) and capacity-bounded top-k MoE.

MoE dispatch is sort-based, as in the reference: token→expert assignments
are argsorted (stably) by expert id, each gets a rank within its expert,
and every (expert, slot) of a static (E, C, d) buffer gathers its token
(a padded zero row where the slot is empty); assignments ranked past the
capacity C are dropped and counted. The experts run as batched products
over the buffer, and each token's k slots are gathered back through the
inverse order and summed in f32. Nothing here reads a device value on the
host: the drop count stays a tensor.

The routed experts and the router are never packed (``core/packing.py``
takes 2-D and 3-D leaves only and skips ``router``), so their products are
plain ``torch.matmul``; a shared expert is a dense MLP and is packed like
any other.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime


def mlp(rt: Runtime, p: dict, x: torch.Tensor, path: str = "ffn") -> torch.Tensor:
    """Dense FFN. SwiGLU has a gate; relu2/gelu are single-branch."""
    if rt.cfg.ffn_act == "swiglu" or "w_gate" in p:
        g = L.dense(rt, p["w_gate"], x, f"{path}.w_gate")
        u = L.dense(rt, p["w_up"], x, f"{path}.w_up")
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = L.dense(rt, p["w_up"], x, f"{path}.w_up")
        h = L.act_fn(rt.cfg.ffn_act)(h.to(torch.float32)).to(x.dtype)
    return L.dense(rt, p["w_down"], h, f"{path}.w_down")


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def moe_capacity(n_tokens: int, n_experts: int, topk: int,
                 factor: float = 1.25) -> int:
    """Static per-expert slot count, padded to a multiple of 8."""
    c = int(n_tokens * topk / n_experts * factor) + 1
    return max(8, -(-c // 8) * 8)


def _batched_expert_mlp(rt: Runtime, p: dict,
                        xs: torch.Tensor) -> torch.Tensor:
    """xs (E, C, d) through per-expert FFN weights (E, d, ff)/(E, ff, d):
    one batched product per weight. The experts are never packed, so the
    calibration collector (which scores packed weights only) skips them,
    as the reference's traced expert map does."""
    if rt.collector is not None:
        rt = dataclasses.replace(rt, collector=None)
    return mlp(rt, p, xs, "moe.experts")


def _route(cfg, p: dict, xt: torch.Tensor):
    """(router probs (T,E) f32, top_p (T,k) f32 renormalised, top_e (T,k)
    int64): the router product in f32, unpacked, and the k largest
    probabilities in descending order, ties to the lower expert id as
    ``lax.top_k`` breaks them."""
    rlogits = torch.matmul(xt.to(torch.float32),
                           p["router"]["w"].to(torch.float32))
    rprobs = torch.softmax(rlogits, dim=-1)
    top_p, top_e = torch.sort(rprobs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_tok
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return rprobs, top_p, top_e


def moe(rt: Runtime, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Top-k MoE over x (B,S,d). Returns (out, aux): ``dropped`` (assignments
    past their expert's capacity), ``load`` (assignments per expert) and
    the switch-style ``balance_loss``, all tensors on x's device.

    p = {"router": {"w"}, "experts": {w_gate/w_up/w_down stacked (E,…)},
         optional "shared": dense-FFN params (deepseek shared expert)}
    """
    cfg = rt.cfg
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    t = b * s
    c = moe_capacity(t, e, k, rt.moe_capacity_factor)
    dev = x.device
    xt = x.reshape(t, d)
    rprobs, top_p, top_e = _route(cfg, p, xt)

    # --- sort-based dispatch: each expert's assignments in token order ---
    flat_e = top_e.reshape(-1)                                    # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(sorted_e, experts, side="left")
    n_assign = t * k
    rank = torch.arange(n_assign, device=dev) - starts[sorted_e]
    ok = rank < c
    src_tok = order // k
    # (the end marker is filled on the device: a host tensor copied in
    # would wait for the stream)
    counts = torch.diff(torch.cat([starts, torch.full(
        (1,), n_assign, dtype=starts.dtype, device=dev)]))
    # slot (e_i, r) is fed by sorted assignment starts[e_i] + r when
    # r < counts[e_i], else by the zero row t
    slot_r = torch.arange(c, device=dev).repeat(e)                # (E*C,)
    slot_e = experts.repeat_interleave(c)
    j_for_slot = starts[slot_e] + slot_r
    slot_valid = slot_r < counts[slot_e]
    src_for_slot = torch.where(
        slot_valid, src_tok[j_for_slot.clamp(0, n_assign - 1)], t)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    expert_in = xt_pad[src_for_slot].reshape(e, c, d)
    expert_out = _batched_expert_mlp(rt, p["experts"], expert_in)

    # --- combine: invert the sort, gather each token's k slots ---
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n_assign, device=dev)
    slot_by_assign = torch.where(ok, sorted_e * c + rank, e * c)[inv_order]
    flat_out = torch.cat([expert_out.reshape(e * c, d),
                          expert_out.new_zeros((1, d))])
    gathered = flat_out[slot_by_assign].reshape(t, k, d)
    w = (top_p * ok[inv_order].reshape(t, k)).to(torch.float32)
    out = (gathered.to(torch.float32) * w[..., None]).sum(1).to(x.dtype)

    if "shared" in p:
        out = out + mlp(rt, p["shared"], xt, "moe.shared")

    # counts is the reference's bincount(flat_e, length=e): the sorted ids
    # give it without a histogram
    aux = {
        "dropped": (~ok).sum(),
        "load": counts,
        "balance_loss": (rprobs.mean(0) * counts.to(torch.float32)
                         / max(n_assign, 1)).sum() * e,
    }
    return out.reshape(b, s, d), aux


def moe_reference(rt: Runtime, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Oracle: loop over experts densely (tests only — E× compute)."""
    cfg = rt.cfg
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, top_p, top_e = _route(cfg, p, xt)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for ei in range(cfg.n_experts):
        pw = {name: {kk: vv[ei] for kk, vv in leaf.items()}
              for name, leaf in p["experts"].items()}
        y = mlp(rt, pw, xt).to(torch.float32)
        wgt = torch.where(top_e == ei, top_p, 0.0).sum(-1)
        out = out + y * wgt[:, None]
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + mlp(rt, p["shared"], xt)
    return out.reshape(b, s, d)
