"""GQA attention (port of the GQA parts of ``models/attention.py``).

``_attend_dense`` serves decode (q = 1 or γ+1) and prompts up to 2048
tokens; ``_attend_flash`` is the chunked online-softmax path beyond that,
f32 accumulators throughout. ``gqa_attention_paged`` is cached decode
over a paged cache through the table-walking kernels
(``kernels/paged_attention``). MLA and cross-attention join with later
slices (ROADMAP Queue 1 step 9).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime
from repro_torch.serving import kvcache as KC

NEG_INF = -1e30
DEFAULT_CHUNK_Q = 1024
DEFAULT_CHUNK_K = 1024


def _attend_dense(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D), mask (B|1,1,Sq,Sk) bool or None."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _attend_flash(q, k, v, *, causal: bool, q_offset: int,
                  chunk_q: int = DEFAULT_CHUNK_Q,
                  chunk_k: int = DEFAULT_CHUNK_K) -> torch.Tensor:
    """Chunked online-softmax attention; the reference's scan as loops."""
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    while sq % cq:
        cq -= 1
    while sk % ck:
        ck -= 1
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    outs = []
    for qi in range(sq // cq):
        qc = q[:, qi * cq:(qi + 1) * cq].reshape(b, cq, hkv, g, d).to(
            torch.float32)
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, cq), device=dev)
        acc = torch.zeros((b, hkv, g, cq, dv), device=dev)
        for kj in range(sk // ck):
            kc = k[:, kj * ck:(kj + 1) * ck].to(torch.float32)
            vc = v[:, kj * ck:(kj + 1) * ck].to(torch.float32)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            if causal:
                kpos = kj * ck + torch.arange(ck, device=dev)
                cm = qpos[:, None] >= kpos[None, :]
                s = torch.where(cm[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vc)
            m = m_new
        out = acc / l[..., None].clamp_min(1e-30)            # (b,hkv,g,cq,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (b,cq,hkv,g,dv)
    out = torch.cat(outs, dim=1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def causal_mask(sq: int, sk: int, q_offset, device=None) -> torch.Tensor:
    """(1,1,Sq,Sk) bool: query at abs pos q_offset+i sees keys 0..pos."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    return (qpos[:, None] >= kpos[None, :])[None, None]


def full_mask(prefix_valid: torch.Tensor, sq: int) -> torch.Tensor:
    """(B|1,1,Sq,P+Sq): prefix keys per validity mask + causal among new."""
    p = prefix_valid.shape[-1]
    b = prefix_valid.shape[0] if prefix_valid.ndim == 2 else 1
    pm = prefix_valid.reshape(b, 1, 1, p).expand(b, 1, sq, p)
    tri = causal_mask(sq, sq, 0, prefix_valid.device).expand(b, 1, sq, sq)
    return torch.cat([pm, tri], dim=-1)


def position_mask(prefix_valid: torch.Tensor, positions: torch.Tensor,
                  sq: int) -> torch.Tensor:
    """(B|1,1,Sq,S) for keys at absolute positions: query j sees the valid
    prefix keys before the first new position and the new keys up to its
    own — ``full_mask``'s key set, in the absolute-position layout."""
    s = prefix_valid.shape[-1]
    pos = positions if positions.ndim == 2 else positions[None]
    kpos = torch.arange(s, device=pos.device)
    valid = prefix_valid if prefix_valid.ndim == 2 else prefix_valid[None]
    seen = valid[:, None, :] | (kpos >= pos[:, :1, None])       # (B,1,S)
    return (seen & (kpos <= pos[:, :, None]))[:, None]          # (B,1,Sq,S)


def place_at_positions(prefix_kv: tuple, new_kv: tuple,
                       positions: torch.Tensor) -> tuple:
    """Copies of the prefix (k, v) (B,S,…) with the new (k, v) (B,q,…)
    written at the absolute positions (B,q) or (q,). Positions past S are
    dropped (``kvcache.row_slots``); only a row already past its region
    has any."""
    b, q = new_kv[0].shape[0], new_kv[0].shape[1]
    pos = positions if positions.ndim == 2 else positions[None].expand(b, q)
    slots = KC.row_slots(pos, prefix_kv[0].shape[1])
    return tuple(KC.write_rows(p.clone(), n, slots)
                 for p, n in zip(prefix_kv, new_kv))


def gqa_project_kv(rt: Runtime, p: dict, x: torch.Tensor, positions):
    """K/V projections (+qk-norm on K, +rope). Returns (k, v) (B,S,Hkv,hd)."""
    cfg = rt.cfg
    b, s, _ = x.shape
    k = L.dense(rt, p["wk"], x, "attn.wk").reshape(b, s, cfg.n_kv_heads,
                                                   cfg.hd)
    v = L.dense(rt, p["wv"], x, "attn.wv").reshape(b, s, cfg.n_kv_heads,
                                                   cfg.hd)
    if cfg.qk_norm:
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_project_q(rt: Runtime, p: dict, x: torch.Tensor, positions):
    cfg = rt.cfg
    b, s, _ = x.shape
    q = L.dense(rt, p["wq"], x, "attn.wq").reshape(b, s, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
    if positions is not None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
    return q


def gqa_attention(rt: Runtime, p: dict, x: torch.Tensor, positions, *,
                  causal: bool = True, prefix_kv=None, prefix_valid=None,
                  cross_kv=None):
    """Full GQA layer. Returns (out, new_kv).

    * full sequence (prefill): ``prefix_kv`` None;
    * cached decode: ``prefix_kv`` = materialised (k, v) (B,S,Hkv,hd)
      with every key at its absolute position (cache view, draft scratch
      placed after it) and ``prefix_valid`` (B|·,S) marking them; the new
      tokens' K/V are placed at ``positions`` and returned to commit.

    The reference appends the new keys after the prefix instead. Keying by
    absolute position gives a query the same key array, in the same order,
    whichever pass computes it, so two passes of one width over the same
    tokens (a width-(γ+1) verify pass, and autoregressive steps run at
    that width) agree bit for bit on every row they share.
    """
    if cross_kv is not None:
        raise NotImplementedError("cross-attention belongs to the "
                                  "encoder-decoder slice: ROADMAP Queue 1 "
                                  "step 9")
    cfg = rt.cfg
    b, sq, _ = x.shape
    scale = 1.0 / (cfg.hd ** 0.5)
    q = gqa_project_q(rt, p, x, positions)
    if prefix_kv is not None:
        new_k, new_v = gqa_project_kv(rt, p, x, positions)
        k, v = place_at_positions(prefix_kv, (new_k, new_v), positions)
        out = _attend_dense(q, k, v, position_mask(prefix_valid, positions,
                                                   sq), scale)
        new_kv = (new_k, new_v)
    else:
        k, v = gqa_project_kv(rt, p, x, positions)
        if sq > 2048:
            out = _attend_flash(q, k, v, causal=causal, q_offset=0,
                                chunk_q=rt.attn_chunk_q,
                                chunk_k=rt.attn_chunk_k)
        else:
            mask = causal_mask(sq, k.shape[1], 0, x.device) if causal else None
            out = _attend_dense(q, k, v, mask, scale)
        new_kv = (k, v)
    out = out.reshape(b, sq, cfg.n_heads * out.shape[-1])
    return L.dense(rt, p["wo"], out, "attn.wo"), new_kv


# ---------------------------------------------------------------------------
# Paged-kernel decode (attn_kernel="on"): the pool walk runs in
# kernels/paged_attention; the scratch/new-token suffix, which lives outside
# the pool, is folded in with one more flash step, then wo as usual.
# ---------------------------------------------------------------------------

def _suffix_valid(b: int, sq: int, g_scratch: int, scratch_len,
                  device=None) -> torch.Tensor:
    """(B, Sq, g_scratch + Sq) bool: scratch validity + causal triangle."""
    parts = []
    if g_scratch:
        gv = torch.arange(g_scratch, device=device) < scratch_len
        parts.append(gv[None, None].expand(b, sq, g_scratch))
    tri = causal_mask(sq, sq, 0, device)[0]                # (1, Sq, Sq)
    parts.append(tri.expand(b, sq, sq))
    return torch.cat(parts, dim=-1)


def gqa_attention_paged(rt: Runtime, p: dict, x: torch.Tensor, positions, *,
                        kv_pools: tuple, table: torch.Tensor,
                        length: torch.Tensor, scratch: dict | None,
                        scratch_len):
    """GQA cached decode through the paged-attention kernels.

    ``kv_pools`` is ``("plain", k_pool, v_pool)`` (bf16 (NB,BS,Hkv,hd)
    pools) or ``("packed", k_spec, v_spec, book, keep)`` (the speculation
    leaf dicts; the decode runs inside the kernel). The pool holds each
    row's committed prefix (``length`` tokens); the draft scratch and the
    new tokens form the suffix. Returns (out, (new_k, new_v)).
    """
    cfg = rt.cfg
    b, sq, _ = x.shape
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    scale = 1.0 / (cfg.hd ** 0.5)
    q = gqa_project_q(rt, p, x, positions)
    new_k, new_v = gqa_project_kv(rt, p, x, positions)
    qg = q.reshape(b, sq, hkv, g, cfg.hd)
    length = length.to(torch.int32).reshape(-1).expand(b).contiguous()
    if kv_pools[0] == "packed":
        _, k_spec, v_spec, book, keep = kv_pools
        acc, m, l = PA.paged_gqa_packed(
            qg, k_spec, v_spec, table, length, book, d=cfg.hd, keep=keep,
            trunc=rt.cass.kv_trunc, exp_bits=rt.cass.exp_bits, scale=scale)
    else:
        _, k_pool, v_pool = kv_pools
        acc, m, l = PA.paged_gqa(qg, k_pool, v_pool, table, length,
                                 scale=scale)
    if scratch is not None:
        g_s = scratch["k"].shape[1]
        suf_k = torch.cat([scratch["k"], new_k.to(scratch["k"].dtype)], dim=1)
        suf_v = torch.cat([scratch["v"], new_v.to(scratch["v"].dtype)], dim=1)
    else:
        g_s = 0
        suf_k, suf_v = new_k, new_v
    suf_valid = _suffix_valid(b, sq, g_s, scratch_len, x.device)
    out = PA.merge_gqa_suffix(acc, m, l, qg, suf_k, suf_v, suf_valid,
                              scale=scale)                 # (B,Sq,hkv,g,hd)
    out = out.reshape(b, sq, cfg.n_heads * cfg.hd).to(x.dtype)
    return L.dense(rt, p["wo"], out, "attn.wo"), (new_k, new_v)
