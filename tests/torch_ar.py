"""Autoregressive harnesses for the port's losslessness tests (no JAX, so
the card's tests use them too).

``Engine.generate(speculative=False)`` runs the reference's width-1
autoregressive step. A verify pass runs at width γ+1, and on the card the
two widths sum their products in different orders. ``ar_steps`` runs the
autoregressive loop at any width straight through ``forward_decode`` and
``commit`` (the current token repeated, position 0 read), so speculative
tokens can also be held to an autoregressive run with the verify pass's
own numerics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.serving import engine as E, kvcache as KC


def prefill(eng, tokens: torch.Tensor, s_max: int):
    """(last-position logits, cache) of the target view after the prompt."""
    rt = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(eng.cfg, eng.cass, tokens.shape[0], s_max,
                          packed=eng.cass is not None,
                          device=tokens.device)
    lg, cache = M.forward_prefill(rt, eng.params, {"tokens": tokens}, cache)
    return lg[:, -1], cache


def ar_steps(eng, tokens: torch.Tensor, n: int, width: int):
    """Greedy autoregressive decode of ``n`` tokens with every step run at
    ``width``. Returns (tokens (B,n) int32, logits (B,n,V) f32: the
    prefill's last position, then each step's position 0)."""
    rt = dataclasses.replace(eng.rt, view="target")
    b = tokens.shape[0]
    with torch.inference_mode():
        lg, cache = prefill(eng, tokens, tokens.shape[1] + n + width)
        logits = [lg.to(torch.float32)]
        toks = [torch.argmax(lg, -1).to(torch.int32)[:, None]]
        zeros = torch.zeros(b, dtype=torch.int32, device=tokens.device)
        for _ in range(n - 1):
            lo, upd = M.forward_decode(rt, eng.params,
                                       toks[-1].expand(-1, width), cache)
            logits.append(lo[:, 0].to(torch.float32))
            toks.append(torch.argmax(lo[:, 0], -1).to(torch.int32)[:, None])
            cache = E.commit(rt, cache, upd, zeros)
    return torch.cat(toks, 1), torch.stack(logits, 1)


def verify_gap(eng, tokens: torch.Tensor, gamma: int, width: int) -> float:
    """Largest |logit| difference between γ+1 autoregressive steps at
    ``width`` and one verify pass over the same tokens (the first γ+1
    positions after the prompt)."""
    toks, logits = ar_steps(eng, tokens, gamma + 2, width)
    rt = dataclasses.replace(eng.rt, view="target")
    with torch.inference_mode():
        _, cache = prefill(eng, tokens, tokens.shape[1] + gamma + 1)
        lv, _ = M.forward_decode(rt, eng.params, toks[:, :gamma + 1], cache)
    return float((logits[:, 1:] - lv.to(torch.float32)).abs().max())


def top2_margins(logits: torch.Tensor) -> np.ndarray:
    """Top-1 minus top-2 logit per position, as numpy."""
    return E.top2_margin(logits).cpu().numpy()


def tau_prefix(spec_tokens: np.ndarray, ar_tokens: np.ndarray,
               margins: np.ndarray, tau: float, n: int):
    """The near-tie rule: per row, compare tokens up to (not including)
    the first position whose AR top-1/top-2 margin is below ``tau``.

    Returns (number of positions compared, positions cut)."""
    compared = 0
    for row in range(ar_tokens.shape[0]):
        low = np.flatnonzero(margins[row, :n] < tau)
        stop = int(low[0]) if low.size else n
        np.testing.assert_array_equal(spec_tokens[row, :stop],
                                      ar_tokens[row, :stop],
                                      err_msg=f"row {row}")
        compared += stop
    return compared, ar_tokens.shape[0] * n - compared
