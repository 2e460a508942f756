"""Model assembly for dense-FFN decoders with GQA or MLA attention (port
of ``models/model.py``).

``forward_prefill`` — full-prompt pass that writes the (packed) KV cache
                      and returns last-position logits.
``forward_decode``  — q new tokens (1 for autoregressive/draft, γ+1 for
                      verification) against the cache; returns per-layer
                      K/V updates for the engine to commit.

Parameters keep the reference's tree: stacked ``(R, …)`` leaves per layer
group, ``(in, out)`` weights. The reference's ``lax.scan`` over R is a
Python loop here (``_scan_groups``). MLA (deepseek) runs in the layers
before its first routed-expert layer (``first_dense_layers``); MoE, SSM and
encoder-decoder models are ROADMAP Queue 1, training too. Multi-token
prediction heads (``mtp_depth``) feed only the reference's training loss,
so serving neither builds nor reads them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_groups
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime
from repro_torch.serving import kvcache as KC

Params = dict
_FAMILY = ("the port covers dense-FFN decoders with GQA or MLA attention; "
           "{what} is ROADMAP Queue 1")
# The reference fails on this combination too (paged_gqa_packed reads the
# Cassandra-1 exponent leaves: KeyError 'exp_words'); neither package has a
# Cassandra-2 packed attention kernel.
C2_PACKED_ATTN = (
    "Cassandra-2 (variant=2) with attn_kernel='on': the packed paged-"
    "attention kernel (paged_gqa_packed) decodes Cassandra-1 leaves only, "
    "and the reference fails here as well (KeyError: 'exp_words'); serve "
    "Cassandra-2 with attn_kernel='off'")


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run. A config with experts runs
    only when every layer is one of its ``first_dense_layers`` (deepseek-
    v3 cut to its first 3 layers); ``mtp_depth`` is ignored (training
    only)."""
    routed = cfg.n_experts and cfg.n_layers > cfg.first_dense_layers
    for what, off in (("MoE (routed-expert layers)", routed),
                      ("SSM", cfg.sub_quadratic), ("enc-dec", cfg.is_encdec),
                      ("a modality frontend", cfg.frontend),
                      ("a non-SwiGLU FFN", cfg.ffn_act != "swiglu"),
                      ("the audio family", cfg.family == "audio")):
        if off:
            raise NotImplementedError(_FAMILY.format(what=what))


def _normal(gen, shape, std, dtype, device):
    """N(0, std²) drawn in f32 from ``gen``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def _dense_init(gen, r, n_in, n_out, dtype, device, bias=False, std=None):
    std = std if std is not None else n_in ** -0.5
    p = {"w": torch.stack([_normal(gen, (n_in, n_out), std, dtype, device)
                           for _ in range(r)])}
    if bias:
        p["b"] = torch.zeros((r, n_out), dtype=dtype, device=device)
    return p


def _init_mla(gen, r: int, cfg: ModelConfig, dtype, device, ones) -> dict:
    """The reference's ``_init_mla`` tree: low-rank q (q_a → norm → q_b),
    the joint latent/rope projection kv_a, kv_b (latent → per-head k_nope
    and v) and wo."""
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    hv = cfg.n_heads * cfg.v_head_dim
    return {
        "q_a": _dense_init(gen, r, cfg.d_model, cfg.q_lora_rank, dtype,
                           device),
        "q_a_norm": ones(r, cfg.q_lora_rank),
        "q_b": _dense_init(gen, r, cfg.q_lora_rank, cfg.n_heads * qk, dtype,
                           device),
        "kv_a": _dense_init(gen, r, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_dim, dtype,
                            device),
        "kv_a_norm": ones(r, cfg.kv_lora_rank),
        "kv_b": _dense_init(gen, r, cfg.kv_lora_rank,
                            cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                            dtype, device),
        "wo": _dense_init(gen, r, hv, cfg.d_model, dtype, device,
                          std=hv ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights with the reference's distributions (``model.py``
    ``_dense_init``/``init_params``): N(0, 1/n_in) projections, output
    projections scaled by 1/sqrt(2·n_layers), N(0, 0.02²) embedding and
    lm_head, unit norms. Draws come from ``generator`` (on ``device``),
    one layer at a time, so no full-depth f32 tensor ever exists. The
    tree is the reference's without its ``mtp`` head (training only)."""
    _check_dense(cfg)
    hd = cfg.hd
    ones = lambda r, d: {"scale": torch.ones((r, d), dtype=torch.float32,
                                             device=device)}
    dec = []
    for g in layer_groups(cfg):
        r = g.repeats
        gdict = {}
        for j, _entry in enumerate(g.entries):
            if cfg.mla:
                attn = _init_mla(generator, r, cfg, dtype, device, ones)
            else:
                attn = {
                    "wq": _dense_init(generator, r, cfg.d_model,
                                      cfg.n_heads * hd, dtype, device,
                                      cfg.qkv_bias),
                    "wk": _dense_init(generator, r, cfg.d_model,
                                      cfg.n_kv_heads * hd, dtype, device,
                                      cfg.qkv_bias),
                    "wv": _dense_init(generator, r, cfg.d_model,
                                      cfg.n_kv_heads * hd, dtype, device,
                                      cfg.qkv_bias),
                    "wo": _dense_init(generator, r, cfg.n_heads * hd,
                                      cfg.d_model, dtype, device,
                                      std=(cfg.n_heads * hd) ** -0.5
                                      / (2 * cfg.n_layers) ** 0.5),
                }
                if cfg.qk_norm:
                    attn["q_norm"] = ones(r, hd)
                    attn["k_norm"] = ones(r, hd)
            ffn = {
                "w_up": _dense_init(generator, r, cfg.d_model, cfg.d_ff,
                                    dtype, device),
                "w_down": _dense_init(generator, r, cfg.d_ff, cfg.d_model,
                                      dtype, device,
                                      std=cfg.d_ff ** -0.5
                                      / (2 * cfg.n_layers) ** 0.5),
                "w_gate": _dense_init(generator, r, cfg.d_model, cfg.d_ff,
                                      dtype, device),
            }
            gdict[f"e{j}"] = {"norm1": ones(r, cfg.d_model), "attn": attn,
                              "ffn": ffn, "norm2": ones(r, cfg.d_model)}
        dec.append(gdict)
    params: Params = {
        "embed": {"table": _normal(generator, (cfg.vocab_size, cfg.d_model),
                                   0.02, dtype, device)},
        "final_norm": {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                           device=device)},
        "dec": dec,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _normal(generator,
                                          (cfg.d_model, cfg.vocab_size),
                                          0.02, dtype, device)}
    return params


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _attn_entry(rt: Runtime, bp: dict, x, positions, *, causal, centry,
                scratch, length, scratch_len, book, s_max, ventry=None,
                table=None):
    """Attention sub-block. Returns (out, upd).

    ``ventry`` — optional pre-materialised dense view of the packed cache
    entry (decoded once per speculative cycle and reused by the γ drafts).
    ``table`` — the (B,MB) block table of a paged cache: with
    ``rt.attn_kernel == "on"`` the pool is walked in-kernel
    (``_attn_entry_paged``); otherwise each row's prefix is gathered
    through the table and attended like a slot row of MB·BS positions.
    """
    cfg = rt.cfg
    view = "draft" if rt.view == "draft" else "target"
    if centry is None:                       # prefill: full sequence
        if cfg.mla:
            out, lat = A.mla_attention(rt, bp["attn"], x, positions,
                                       causal=causal)
            return out, {"c": lat[0], "kr": lat[1]}
        out, kv = A.gqa_attention(rt, bp["attn"], x, positions,
                                  causal=causal)
        return out, {"k": kv[0], "v": kv[1]}
    if rt.attn_kernel == "on":
        if table is None:
            raise ValueError("attn_kernel='on' walks a block table: it "
                             "needs a paged cache")
        return _attn_entry_paged(rt, bp, x, positions, centry=centry,
                                 scratch=scratch, length=length,
                                 scratch_len=scratch_len, book=book,
                                 ventry=ventry, table=table)
    # prefix = cache view with the draft scratch placed after each row's
    # length: every key (MLA: latent) at its absolute position (see
    # gqa_attention)
    dev = x.device
    start = length[:, None] if length.ndim == 1 else length
    valid = torch.arange(s_max, device=dev) < start + scratch_len
    dims = KC.store_dims(cfg)
    if ventry is not None:
        pre = tuple(ventry[nm] for nm in dims)
        if table is not None:
            pre = tuple(KC.gather_block_leaf(p, table) for p in pre)
    else:
        gather = (lambda st: st) if table is None else (
            lambda st: KC.gather_store(st, table))
        pre = tuple(KC.read_store(rt.cass, gather(centry[nm]), d, view, book)
                    for nm, d in dims.items())
    if scratch is not None:
        new = tuple(scratch[nm] for nm in dims)
        spos = start + torch.arange(new[0].shape[1], device=dev)
        pre = A.place_at_positions(pre, new, spos)
    if cfg.mla:
        out, (nc, nkr) = A.mla_attention(rt, bp["attn"], x, positions,
                                         prefix_latent=pre,
                                         prefix_valid=valid)
        return out, {"c": nc, "kr": nkr}
    out, (nk, nv) = A.gqa_attention(rt, bp["attn"], x, positions,
                                    prefix_kv=pre, prefix_valid=valid)
    return out, {"k": nk, "v": nv}


def _attn_entry_paged(rt: Runtime, bp: dict, x, positions, *, centry,
                      scratch, length, scratch_len, book, ventry, table):
    """Cached decode through ``kernels/paged_attention``.

    The pool stays in pool layout and no row's prefix is gathered. A
    packed GQA cache feeds the draft pass its speculation leaves directly:
    the Cassandra decode runs inside the kernel. The verify pass (target
    view) reads a dense pool (``ventry`` or ``read_store`` over the whole
    pool) through the plain kernel. MLA pools, packed or not, are read as
    dense views the same way (both passes) and walked by ``paged_mla``:
    neither package has a packed MLA kernel.
    """
    cfg, cass = rt.cfg, rt.cass
    view = "draft" if rt.view == "draft" else "target"
    if cfg.mla:
        pc, pkr = (ventry[nm] if ventry is not None
                   else KC.read_store(cass, centry[nm], d, view, book)
                   for nm, d in KC.store_dims(cfg).items())
        out, (nc, nkr) = A.mla_attention_paged(
            rt, bp["attn"], x, positions, c_pool=pc.contiguous(),
            kr_pool=pkr.contiguous(), table=table, length=length,
            scratch=scratch, scratch_len=scratch_len)
        return out, {"c": nc, "kr": nkr}
    if ventry is None and KC.is_packed(centry["k"]) and view == "draft":
        if cass.variant != 1:
            raise ValueError(C2_PACKED_ATTN)
        kv_pools = ("packed", centry["k"]["spec"], centry["v"]["spec"],
                    book[0], cass.kv_keep(cfg.hd))
    else:
        if ventry is not None:
            pk, pv = ventry["k"], ventry["v"]
        else:
            pk = KC.read_store(cass, centry["k"], cfg.hd, view, book)
            pv = KC.read_store(cass, centry["v"], cfg.hd, view, book)
        kv_pools = ("plain", pk, pv)
    out, (nk, nv) = A.gqa_attention_paged(
        rt, bp["attn"], x, positions, kv_pools=kv_pools, table=table,
        length=length, scratch=scratch, scratch_len=scratch_len)
    return out, {"k": nk, "v": nv}


def _block(rt: Runtime, bp: dict, entry: str, x, positions, *, mode,
           causal=True, centry=None, scratch=None, length=None,
           scratch_len=None, book=None, s_max=0, ventry=None, table=None):
    """One transformer block. Returns (x, cache_update)."""
    h = L.norm(rt, bp["norm1"], x)
    out, kv_upd = _attn_entry(rt, bp, h, positions, causal=causal,
                              centry=centry, scratch=scratch, length=length,
                              scratch_len=scratch_len, book=book,
                              s_max=s_max, ventry=ventry, table=table)
    upd = dict(kv_upd) if mode in ("decode", "prefill") else {}
    x = x + out
    h = L.norm(rt, bp["norm2"], x)
    x = x + F.mlp(rt, bp["ffn"], h)
    return x, upd


def _index(tree, r: int):
    """Layer ``r`` of a stacked (R, …) tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, r) for v in tree]
    return tree[r]


def _stack_updates(per_layer: list[dict]) -> dict:
    if not per_layer or not per_layer[0]:
        return {}
    out = {}
    for ekey in per_layer[0]:
        out[ekey] = {nm: torch.stack([u[ekey][nm] for u in per_layer])
                     for nm in per_layer[0][ekey]}
    return out


def _scan_groups(rt: Runtime, groups_params, entries_per_group, x,
                 positions, *, mode, causal=True, cache_groups=None,
                 scratch_groups=None, length=None, scratch_len=None,
                 book=None, s_max=0, view_groups=None, table=None):
    """Run all layer groups; a loop over the repeats R of each group.

    Returns (x, updates_groups) with updates stacked along R like the
    reference's scan outputs."""
    updates_groups = []
    for gi, entries in enumerate(entries_per_group):
        gp = groups_params[gi]
        repeats = next(iter(gp["e0"]["norm1"].values())).shape[0]
        per_layer = []
        for r in range(repeats):
            g_upd = {}
            for j, entry in enumerate(entries):
                ekey = f"e{j}"
                pick = lambda grp: (_index(grp[gi][ekey], r)
                                    if grp is not None and ekey in grp[gi]
                                    else None)
                x, upd = _block(
                    rt, _index(gp[ekey], r), entry, x, positions, mode=mode,
                    causal=causal, centry=pick(cache_groups),
                    scratch=pick(scratch_groups), length=length,
                    scratch_len=scratch_len, book=book, s_max=s_max,
                    ventry=pick(view_groups), table=table)
                if upd:
                    g_upd[ekey] = upd
            per_layer.append(g_upd)
        updates_groups.append(_stack_updates(per_layer))
    return x, updates_groups


def _entries(cfg: ModelConfig):
    return [g.entries for g in layer_groups(cfg)]


# ---------------------------------------------------------------------------
# Public forwards
# ---------------------------------------------------------------------------

def forward_prefill(rt: Runtime, params: Params, batch: dict, cache: dict):
    """Process the prompt, write the cache. Returns (last_logits, cache)."""
    cfg = rt.cfg
    _check_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    book = KC.cache_codebook(cache)
    x, upd = _scan_groups(rt, params["dec"], _entries(cfg), x, positions,
                          mode="prefill")
    cache = _commit_prefill(rt, cache, upd, s, book)
    x = L.norm(rt, params["final_norm"], x[:, -1:])
    return L.unembed(rt, params, x), cache


def _commit_prefill(rt: Runtime, cache, updates_groups, s, book):
    """Encode the prompt's K/V (packed caches) and write them at offset 0."""
    cfg, cass = rt.cfg, rt.cass
    for gi, g_upd in enumerate(updates_groups):
        for ekey, upd in g_upd.items():
            centry = cache["dec"][gi][ekey]
            for name, d in KC.store_dims(cfg).items():
                new = upd[name]                              # (R,B,S,…,d)
                enc = (KC.encode_store(cass, new, d, book)
                       if book is not None else new)
                for r in range(new.shape[0]):
                    KC.append_store(_index(centry[name], r),
                                    _index(enc, r), 0)
    cache["length"] = torch.full_like(cache["length"], s)
    return cache


def materialize_cache_view(rt: Runtime, cache: dict) -> list | None:
    """Decode the packed cache's draft/target view once into dense stores
    (slot rows, or whole pools of a paged cache).

    The speculative engine reuses it across the γ draft steps. Returns
    None for plain caches.
    """
    cfg, cass = rt.cfg, rt.cass
    book = KC.cache_codebook(cache)
    if book is None:
        return None
    view = "draft" if rt.view == "draft" else "target"
    groups = []
    for gi, g in enumerate(layer_groups(cfg)):
        gdict = {}
        for j, _entry in enumerate(g.entries):
            centry = cache["dec"][gi][f"e{j}"]
            gdict[f"e{j}"] = {
                nm: KC.read_store(cass, centry[nm], d, view, book)
                for nm, d in KC.store_dims(cfg).items()}
        groups.append(gdict)
    return groups


def forward_decode(rt: Runtime, params: Params, tokens: torch.Tensor,
                   cache: dict, scratch: list | None = None,
                   scratch_len=None, cache_view: list | None = None):
    """q new tokens against the cache. Returns (logits, updates).

    ``updates`` mirrors the cache groups: per attention entry the new
    tokens' K/V (R,B,q,Hkv,hd) or MLA latents (R,B,q,·) for the engine to
    commit. Rows are
    independent: per-row ``length`` offsets positions and masks. A paged
    cache's ``block_table`` addresses its pools.
    """
    cfg = rt.cfg
    _check_dense(cfg)
    length = cache["length"]
    slen = scratch_len if scratch_len is not None else 0
    q = tokens.shape[1]
    ar = torch.arange(q, device=tokens.device)
    if length.ndim == 1:
        positions = length[:, None] + slen + ar[None, :]
    else:
        positions = length + slen + ar
    x = L.embed(params["embed"], tokens)
    book = KC.cache_codebook(cache)
    x, upd = _scan_groups(
        rt, params["dec"], _entries(cfg), x, positions, mode="decode",
        cache_groups=cache["dec"], scratch_groups=scratch, length=length,
        scratch_len=slen, book=book, s_max=_cache_s_max(cfg, cache),
        view_groups=cache_view, table=cache.get("block_table"))
    x = L.norm(rt, params["final_norm"], x)
    return L.unembed(rt, params, x), upd


def _cache_s_max(cfg: ModelConfig, cache: dict) -> int:
    """Per-request token capacity: the S axis of a slot cache, or the
    table width MB × the block size BS of a paged one."""
    mb = cache["block_table"].shape[1] if KC.is_paged(cache) else 1
    for g in cache["dec"]:
        for e in g.values():
            leaf = next(iter(e.values()))
            if KC.is_packed(leaf):
                leaf = leaf["spec"]["bitmap"]
            return mb * leaf.shape[2]                 # (R,B,S,…) | (R,NB,BS,…)
    return 0
