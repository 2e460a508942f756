"""Speculative-decoding acceptance (port of ``core/speculative.py``).

The greedy rule: a drafted token is accepted iff it equals the target's
argmax at that position, which preserves the target output exactly (the
lossless Table III rule). Rejection sampling (paper Eq. 1) joins with a
``torch.Generator`` in a later slice (ROADMAP Queue 1).
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


def rejection_sample(*args, **kwargs):
    raise NotImplementedError(
        "rejection sampling is not ported yet: ROADMAP Queue 1 "
        "(rejection_sample with a torch.Generator)")


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
