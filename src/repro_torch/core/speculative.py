"""Speculative-decoding acceptance (port of ``core/speculative.py``).

* **greedy** — a drafted token is accepted iff it equals the target's
  argmax at that position, which preserves the target output exactly (the
  lossless Table III rule);
* **rejection sampling** (paper Eq. 1) — accept token i iff
  ``r_i <= p_i(x)/q_i(x)``; on the first rejection, resample from
  ``normalize(max(p - q, 0))``, so the output is distributed exactly as
  sampling from the target.

Every draw comes from the caller's ``torch.Generator`` on the tensors'
device, and nothing here reads a device value on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AcceptResult(NamedTuple):
    n_accepted: torch.Tensor   # (B,) int32 — drafted tokens accepted
    next_token: torch.Tensor   # (B,) int32 — bonus token appended after
    tokens: torch.Tensor       # (B, gamma+1) int32 — accepted prefix + next
    valid: torch.Tensor        # (B, gamma+1) bool — which slots are real


def _assemble(draft_tokens: torch.Tensor, n: torch.Tensor,
              next_token: torch.Tensor):
    b, gamma = draft_tokens.shape
    iota = torch.arange(gamma + 1, device=draft_tokens.device)[None, :]
    keep_draft = iota < n[:, None]
    padded = torch.cat([draft_tokens, draft_tokens.new_zeros((b, 1))], dim=1)
    tokens = torch.where(keep_draft, padded, 0)
    tokens = torch.where(iota == n[:, None], next_token[:, None], tokens)
    valid = iota <= n[:, None]
    return tokens.to(torch.int32), valid


def greedy_accept(draft_tokens: torch.Tensor, target_logits: torch.Tensor,
                  tie_margin: float = 0.0) -> AcceptResult:
    """Greedy rule. draft_tokens (B, gamma); target_logits (B, gamma+1, V).

    ``tie_margin > 0`` also accepts a drafted token whose target logit is
    within the margin of the target max (a near-tie the two views may rank
    differently); 0.0 is the strict lossless rule.
    """
    target_argmax = torch.argmax(target_logits, dim=-1).to(torch.int32)
    gamma = draft_tokens.shape[1]
    match = draft_tokens == target_argmax[:, :gamma]
    if tie_margin > 0.0:
        tl = target_logits[:, :gamma].to(torch.float32)
        tmax = tl.amax(-1)
        dlog = torch.gather(tl, -1, draft_tokens[..., None].long())[..., 0]
        match = match | (dlog >= tmax - tie_margin)
    n = torch.cumprod(match.to(torch.int32), dim=1).sum(1).to(torch.int32)
    next_token = torch.gather(target_argmax, 1, n[:, None].long())[:, 0]
    tokens, valid = _assemble(draft_tokens, n, next_token)
    return AcceptResult(n, next_token, tokens, valid)


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` over the last axis, as
    ``jax.random.categorical`` draws it: the argmax of the logits plus
    Gumbel noise. The uniforms come from ``generator``; a uniform of 0
    gives -inf noise, never a pick. Returns int32 (...,)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.to(torch.float32) + gumbel,
                        dim=-1).to(torch.int32)


def rejection_sample(draft_tokens: torch.Tensor, draft_probs: torch.Tensor,
                     target_probs: torch.Tensor, generator: torch.Generator,
                     r: torch.Tensor | None = None) -> AcceptResult:
    """Paper Eq. 1. draft_probs (B, gamma, V); target_probs (B, gamma+1, V).

    ``r`` (B, gamma) overrides the uniform draws (for deterministic tests).
    Draws from ``generator``: the uniforms ``r`` (unless given), then one
    categorical draw per row from the residual.
    """
    b, gamma = draft_tokens.shape
    dev = draft_tokens.device
    if r is None:
        r = torch.rand((b, gamma), generator=generator, device=dev,
                       dtype=torch.float32)
    idx = draft_tokens.to(torch.int64)[..., None]
    px = torch.gather(target_probs[:, :gamma], -1, idx)[..., 0]
    qx = torch.gather(draft_probs, -1, idx)[..., 0]
    reject = r > px / torch.clamp(qx, min=1e-20)
    # n = index of the first rejection, or gamma if none (Eq. 1)
    any_rej = reject.any(dim=1)
    first_rej = torch.argmax(reject.to(torch.int32), dim=1)
    n = torch.where(any_rej, first_rej, gamma).to(torch.int32)
    # residual distribution at the stopping position
    v = target_probs.shape[-1]
    pick = n.to(torch.int64)[:, None, None].expand(-1, 1, v)
    pn = torch.gather(target_probs, 1, pick)[:, 0]
    qn = torch.gather(torch.cat([draft_probs,
                                 torch.zeros_like(draft_probs[:, :1])], 1),
                      1, pick)[:, 0]
    residual = torch.where(any_rej[:, None], torch.clamp(pn - qn, min=0.0),
                           pn)
    residual = residual / torch.clamp(residual.sum(-1, keepdim=True),
                                       min=1e-20)
    next_token = categorical(torch.log(torch.clamp(residual, min=1e-20)),
                             generator)
    tokens, valid = _assemble(draft_tokens, n, next_token)
    return AcceptResult(n, next_token, tokens, valid)


def expected_tokens_per_cycle(alpha: float, gamma: int) -> float:
    """E[tokens generated per speculative cycle] for i.i.d. acceptance alpha."""
    if alpha >= 1.0:
        return float(gamma + 1)
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)


def speedup_model(alpha: float, gamma: int, draft_cost_ratio: float,
                  verify_cost_ratio: float = 1.0) -> float:
    """Analytical speedup over autoregressive decoding (paper §II-B)."""
    e = expected_tokens_per_cycle(alpha, gamma)
    return e / (gamma * draft_cost_ratio + verify_cost_ratio)
