"""Autoregressive harnesses for the port's losslessness tests (no JAX, so
the card's tests use them too).

``Engine.generate(speculative=False)`` runs the reference's width-1
autoregressive step. A verify pass runs at width γ+1, and on the card the
two widths sum their products in different orders. ``ar_steps`` runs the
autoregressive loop at any width straight through ``forward_decode`` and
``commit`` (the current token repeated, position 0 read), so speculative
tokens can also be held to an autoregressive run with the verify pass's
own numerics. ``extra`` carries a frontend's embeddings (``frame_embeds``
or ``patch_embeds``) into the prefill, as ``Engine.generate`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.serving import engine as E, kvcache as KC


def prefill(eng, tokens: torch.Tensor, s_max: int,
            extra: dict | None = None):
    """(last-position logits, cache) of the target view after the prompt
    (and a vision frontend's patches, which ``s_max`` need not count)."""
    rt = dataclasses.replace(eng.rt, view="target")
    if eng.cfg.frontend == "vision":
        s_max += eng.cfg.frontend_tokens
    cache = KC.init_cache(eng.cfg, eng.cass, tokens.shape[0], s_max,
                          packed=eng.cass is not None,
                          device=tokens.device)
    lg, cache = M.forward_prefill(rt, eng.params,
                                  {"tokens": tokens, **(extra or {})}, cache)
    return lg[:, -1], cache


def ar_steps(eng, tokens: torch.Tensor, n: int, width: int,
             extra: dict | None = None):
    """Greedy autoregressive decode of ``n`` tokens with every step run at
    ``width``. Returns (tokens (B,n) int32, logits (B,n,V) f32: the
    prefill's last position, then each step's position 0)."""
    rt = dataclasses.replace(eng.rt, view="target")
    b = tokens.shape[0]
    with torch.inference_mode():
        lg, cache = prefill(eng, tokens, tokens.shape[1] + n + width, extra)
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


def verify_gap(eng, tokens: torch.Tensor, gamma: int, width: int,
               extra: dict | None = None) -> float:
    """Largest |logit| difference between γ+1 autoregressive steps at
    ``width`` and one verify pass over the same tokens (the first γ+1
    positions after the prompt)."""
    toks, logits = ar_steps(eng, tokens, gamma + 2, width, extra)
    rt = dataclasses.replace(eng.rt, view="target")
    with torch.inference_mode():
        _, cache = prefill(eng, tokens, tokens.shape[1] + gamma + 1, extra)
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


def chunk_start_outputs(cfg, device, seed: int = 0, windowed: bool = True):
    """One paged attention layer (the kernels' path: ``paged_gqa`` or
    ``paged_mla`` and the suffix merge) run on the same prompt tokens
    under two chunk partitions, the second starting mid-grid as a prefix
    hit or a resume does: pass A takes positions 32..47 in one 16-wide
    chunk from a pool holding 0..31; pass B takes 40..47 from the pool
    holding 0..39, its 32..39 the K/V (latents) pass A computed. Returns
    (A's outputs at 40..47, B's outputs at 40..47); ``windowed`` passes
    ``engine.window_start`` as the serving steps do."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import _index, init_params
    gen = torch.Generator(device=device).manual_seed(seed)
    p = _index(init_params(cfg, gen, device=device)["dec"][0]["e0"]["attn"],
               0)
    rt = Runtime(cfg=cfg, cass=None, view="plain", attn_kernel="on")
    b, t, bs, mb = 2, 16, 4, 12
    nb = b * mb + 1
    table = (1 + torch.arange(b * mb, device=device)).reshape(b, mb).to(
        torch.int32)
    x = torch.randn((b, 48, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    dims = E.KC.store_dims(cfg)
    heads = E.KC.store_heads(cfg)
    pools = {nm: (torch.randn((nb, bs, *heads, d), generator=gen,
                              device=device) * 0.5).to(torch.bfloat16)
             for nm, d in dims.items()}

    def layer(lo: int, valid: int):
        length = torch.full((b,), lo, dtype=torch.int32, device=device)
        xs = torch.zeros((b, t, cfg.d_model), dtype=torch.bfloat16,
                         device=device)
        xs[:, :valid] = x[:, lo:lo + valid]
        pos = length[:, None] + torch.arange(t, device=device)
        start = (E.window_start(length, torch.full_like(length, valid), t)
                 if windowed else None)
        kw = dict(table=table, length=length, scratch=None, scratch_len=0,
                  suffix_from=start)
        if cfg.mla:
            return A.mla_attention_paged(rt, p, xs, pos, c_pool=pools["c"],
                                         kr_pool=pools["kr"], **kw)
        return A.gqa_attention_paged(
            rt, p, xs, pos, kv_pools=("plain", pools["k"], pools["v"]), **kw)

    with torch.inference_mode():
        out_a, new_a = layer(32, 16)
        for (nm, pool), new in zip(pools.items(), new_a):
            for row in range(b):              # commit 32..39 as pass A did
                blocks = table[row, 8:10].to(torch.int64)
                pool[blocks] = new[row, :8].reshape(2, bs, *new.shape[2:])
        out_b, _ = layer(40, 8)
    return out_a[:, 8:16], out_b[:, :8]
