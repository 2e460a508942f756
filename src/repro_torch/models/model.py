"""Model assembly (port of ``models/model.py``): decoders with GQA or MLA
attention, Mamba-1 mixers and dense or MoE FFNs, the encoder-decoder audio
family and a vision frontend's backbone.

``forward_prefill`` — full-prompt pass that writes the (packed) KV cache,
                      the SSM state and the cross-attention K/V, and
                      returns last-position logits.
``forward_decode``  — q new tokens (1 for autoregressive/draft, γ+1 for
                      verification) against the cache; returns per-layer
                      K/V updates and SSM states for the engine to commit.
``forward_train``   — full-sequence pass with no cache, all positions'
                      logits (or the final hidden states): the Wanda
                      calibration forward and the training forward.
``loss_fn``         — the training loss: the fused, chunked unembed + CE
                      (``_chunked_ce``), the z-loss, MoE's balance term and
                      DeepSeek's multi-token-prediction term; its backward
                      is autograd's (``training/trainer.py``).

Parameters keep the reference's tree: stacked ``(R, …)`` leaves per layer
group, ``(in, out)`` weights. The reference's ``lax.scan`` over R is a
Python loop here (``_scan_groups``). A block's mixer is attention
(``'a'``: GQA, with ``qk_norm`` / ``qkv_bias`` where the config says, or
MLA for deepseek) or a Mamba-1 SSM (``'s'``, ``models/ssm.py``); its FFN
is a dense MLP (``'m'``: SwiGLU, squared-ReLU or GELU), top-k MoE (``'M'``,
``ffn.moe``; deepseek's first ``first_dense_layers`` are dense) or none
(``'-'``, falcon-mamba). The MoE aux (drops, balance loss) is summed over
the blocks; ``forward_train`` returns it and serving ignores it, as in the
reference.

The audio family (whisper) has layer norms (a norm with a ``bias``),
biased projections, learned decoder positions (``pos_embed``) and no
rope; its encoder (``enc``, ``enc_norm``) runs the frame embeddings plus
sinusoidal positions through non-causal blocks, and each decoder
attention block adds cross-attention (``xattn``, ``norm_x``) over the
encoder output, whose K/V the prefill caches as plain bf16. A vision
frontend's patch embeddings are prepended to the text tokens.

Training runs ``mode="train"`` with autograd: each layer group's stacked
leaves are split with ``torch.unbind`` (whose backward stacks the R layer
gradients once, where indexing would add R full-size zero tensors), and
with ``Runtime.remat`` each layer block runs under
``torch.utils.checkpoint``. A multi-token-prediction head (``mtp``,
``mtp_depth > 0``) feeds only the training loss: ``init_mtp`` builds it
beside ``init_params``' tree, and ``format_params`` and serving leave it
out.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_groups
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import Runtime
from repro_torch.serving import kvcache as KC

Params = dict
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

def cfg_has_moe(cfg: ModelConfig) -> bool:
    return any(e[1] == "M" for e in cfg.block_pattern)


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


def _init_ssm(gen, r: int, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's ``_init_ssm``: N(0, 1/n_in) projections (``out_proj``
    scaled by 1/sqrt(2·n_layers), ``dt_proj`` N(0, 1/dt_r)), ``conv_w``
    N(0, 1/d_conv), zero ``conv_b``, ``dt_bias`` the inverse softplus of a
    dt drawn log-uniform in [1e-3, 1e-1], ``A_log = log(1..n)`` and ``D =
    1``; the last three f32."""
    di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_r
    f32 = torch.float32
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dt = torch.stack([torch.exp(
        lo + (hi - lo) * torch.rand((di,), generator=gen, dtype=f32,
                                    device=device)) for _ in range(r)])
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=device))
    return {
        "in_proj": _dense_init(gen, r, cfg.d_model, 2 * di, dtype, device),
        "out_proj": _dense_init(gen, r, di, cfg.d_model, dtype, device,
                                std=di ** -0.5 / (2 * cfg.n_layers) ** 0.5),
        "conv_w": torch.stack([_normal(gen, (cfg.ssm_conv, di),
                                       cfg.ssm_conv ** -0.5, dtype, device)
                               for _ in range(r)]),
        "conv_b": torch.zeros((r, di), dtype=dtype, device=device),
        "x_proj": _dense_init(gen, r, di, dtr + 2 * n, dtype, device),
        "dt_proj": _dense_init(gen, r, dtr, di, dtype, device,
                               std=dtr ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": a_log.expand(r, di, n).contiguous(),
        "D": torch.ones((r, di), dtype=f32, device=device),
    }


def _init_mlp(gen, r: int, cfg: ModelConfig, d_ff: int, dtype,
              device) -> dict:
    """The reference's ``_init_mlp``: up and down projections (biased in
    the audio family), and a gate for SwiGLU."""
    bias = cfg.family == "audio"
    p = {"w_up": _dense_init(gen, r, cfg.d_model, d_ff, dtype, device, bias),
         "w_down": _dense_init(gen, r, d_ff, cfg.d_model, dtype, device, bias,
                               std=d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)}
    if cfg.ffn_act == "swiglu":
        p["w_gate"] = _dense_init(gen, r, cfg.d_model, d_ff, dtype, device)
    return p


def _experts_init(gen, r: int, e: int, n_in: int, n_out: int, dtype,
                  device, std=None) -> dict:
    """Stacked (R, E, n_in, n_out) expert weights, drawn one expert at a
    time into the preallocated tensor (no f32 copy of the stack)."""
    std = std if std is not None else n_in ** -0.5
    w = torch.empty((r, e, n_in, n_out), dtype=dtype, device=device)
    for ri in range(r):
        for ei in range(e):
            w[ri, ei] = _normal(gen, (n_in, n_out), std, dtype, device)
    return {"w": w}


def _init_moe(gen, r: int, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's ``_init_moe`` tree: an f32 router, the experts
    stacked along E (per layer: (E, in, out)) and the optional shared
    expert, a dense MLP ``n_shared_experts`` experts wide."""
    e, ff, d = cfg.n_experts, cfg.expert_ff, cfg.d_model
    experts = {
        "w_up": _experts_init(gen, r, e, d, ff, dtype, device),
        "w_down": _experts_init(gen, r, e, ff, d, dtype, device,
                                std=ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)}
    if cfg.ffn_act == "swiglu":
        experts["w_gate"] = _experts_init(gen, r, e, d, ff, dtype, device)
    p = {"router": {"w": _normal(gen, (r, d, e), 0.02, torch.float32,
                                 device)},
         "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = _init_mlp(gen, r, cfg, ff * cfg.n_shared_experts,
                                dtype, device)
    return p


def _norm_init(cfg: ModelConfig, lead: tuple, device) -> dict:
    """A block's (or the model's) norm: unit f32 scales, and for the audio
    family zero f32 biases, which make it a layer norm (the reference's
    ``_norm_init``)."""
    p = {"scale": torch.ones((*lead, cfg.d_model), dtype=torch.float32,
                             device=device)}
    if cfg.family == "audio":
        p["bias"] = torch.zeros((*lead, cfg.d_model), dtype=torch.float32,
                                device=device)
    return p


def _init_gqa(gen, r: int, cfg: ModelConfig, dtype, device, ones) -> dict:
    """The reference's ``_init_gqa``: wq, wk, wv (biased with ``qkv_bias``
    or in the audio family), wo (biased in the audio family) and the
    ``qk_norm`` scales."""
    hd, audio = cfg.hd, cfg.family == "audio"
    bias = cfg.qkv_bias or audio
    p = {"wq": _dense_init(gen, r, cfg.d_model, cfg.n_heads * hd, dtype,
                           device, bias),
         "wk": _dense_init(gen, r, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                           device, bias),
         "wv": _dense_init(gen, r, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                           device, bias),
         "wo": _dense_init(gen, r, cfg.n_heads * hd, cfg.d_model, dtype,
                           device, audio,
                           std=(cfg.n_heads * hd) ** -0.5
                           / (2 * cfg.n_layers) ** 0.5)}
    if cfg.qk_norm:
        p["q_norm"] = ones(r, hd)
        p["k_norm"] = ones(r, hd)
    return p


def _init_groups(gen, cfg: ModelConfig, cross: bool, dtype,
                 device) -> list:
    """The layer groups' stacked trees (the reference's ``_init_groups``):
    per entry its norms, mixer, FFN and, with ``cross``, an attention
    entry's cross-attention (``xattn``, a GQA tree, and ``norm_x``)."""
    ones = lambda r, d: {"scale": torch.ones((r, d), dtype=torch.float32,
                                             device=device)}
    groups = []
    for g in layer_groups(cfg):
        r = g.repeats
        gdict = {}
        for j, kind in enumerate(g.entries):
            if kind[0] == "s":
                mixer = {"ssm": _init_ssm(gen, r, cfg, dtype, device)}
            elif cfg.mla:
                mixer = {"attn": _init_mla(gen, r, cfg, dtype, device, ones)}
            else:
                mixer = {"attn": _init_gqa(gen, r, cfg, dtype, device, ones)}
            entry = {"norm1": _norm_init(cfg, (r,), device), **mixer}
            if cross and kind[0] == "a":
                entry["xattn"] = _init_gqa(gen, r, cfg, dtype, device, ones)
                entry["norm_x"] = _norm_init(cfg, (r,), device)
            if kind[1] == "m":
                entry["ffn"] = _init_mlp(gen, r, cfg, cfg.d_ff, dtype, device)
            elif kind[1] == "M":
                entry["moe"] = _init_moe(gen, r, cfg, dtype, device)
            if kind[1] in "mM":
                entry["norm2"] = _norm_init(cfg, (r,), device)
            gdict[f"e{j}"] = entry
        groups.append(gdict)
    return groups


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights with the reference's distributions (``model.py``
    ``_dense_init``/``init_params``): N(0, 1/n_in) projections, output
    projections scaled by 1/sqrt(2·n_layers), N(0, 0.02²) embedding and
    lm_head, unit norms (zero biases: the audio family's biased
    projections and layer norms); MoE blocks an N(0, 0.02²) f32 router and
    experts as ``_init_moe``; an encoder-decoder model its encoder groups
    (no cross-attention) and ``enc_norm``; the audio family an N(0, 0.02²)
    ``pos_embed`` table of ``max_wavelength_pos + 128`` rows. Draws come
    from ``generator`` (on ``device``), one layer (an expert) at a time,
    so no full-depth f32 tensor ever exists. The tree is the reference's
    without its ``mtp`` head, which only the training loss reads:
    ``init_mtp`` adds it (``launch/train.py`` does for ``mtp_depth > 0``)."""
    params: Params = {
        "dec": _init_groups(generator, cfg, cfg.cross_attention, dtype,
                            device),
        "embed": {"table": _normal(generator, (cfg.vocab_size, cfg.d_model),
                                   0.02, dtype, device)},
        "final_norm": _norm_init(cfg, (), device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _normal(generator,
                                          (cfg.d_model, cfg.vocab_size),
                                          0.02, dtype, device)}
    if cfg.is_encdec:
        params["enc"] = _init_groups(generator, cfg, False, dtype, device)
        params["enc_norm"] = _norm_init(cfg, (), device)
    if cfg.family == "audio":
        params["pos_embed"] = {"table": _normal(
            generator, (cfg.max_wavelength_pos + 128, cfg.d_model), 0.02,
            dtype, device)}
    return params


def init_mtp(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.bfloat16, device="cuda") -> dict:
    """The reference's ``params["mtp"]`` (``init_params``, ``mtp_depth >
    0``): the norms of the hidden state and of the next token's embedding,
    ``proj`` (2·d_model → d_model, N(0, 1/(2·d_model))), one unstacked
    ``"am"`` block (the model's attention, a dense MLP of ``d_ff``) and a
    final norm."""
    ones = lambda r, d: {"scale": torch.ones((r, d), dtype=torch.float32,
                                             device=device)}
    attn = (_init_mla(generator, 1, cfg, dtype, device, ones) if cfg.mla
            else _init_gqa(generator, 1, cfg, dtype, device, ones))
    block = {"norm1": _norm_init(cfg, (1,), device), "attn": attn,
             "ffn": _init_mlp(generator, 1, cfg, cfg.d_ff, dtype, device),
             "norm2": _norm_init(cfg, (1,), device)}
    return {
        "norm_h": _norm_init(cfg, (), device),
        "norm_e": _norm_init(cfg, (), device),
        "proj": _index(_dense_init(generator, 1, 2 * cfg.d_model,
                                   cfg.d_model, dtype, device), 0),
        "block": _index(block, 0),
        "final_norm": _norm_init(cfg, (), device),
    }


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _attn_entry(rt: Runtime, bp: dict, x, positions, *, causal, centry,
                scratch, length, scratch_len, book, s_max, ventry=None,
                table=None, suffix_from=None):
    """Attention sub-block. Returns (out, upd).

    ``ventry`` — optional pre-materialised dense view of the packed cache
    entry (decoded once per speculative cycle and reused by the γ drafts).
    ``table`` — the (B,MB) block table of a paged cache: with
    ``rt.attn_kernel == "on"`` the pool is walked in-kernel
    (``_attn_entry_paged``); otherwise each row's prefix is gathered
    through the table and attended like a slot row of MB·BS positions.
    ``suffix_from`` — a target pass's window start for the kernel path
    (``attention._window``); the gather path keys every entry by its
    absolute position already.
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
                                 ventry=ventry, table=table,
                                 suffix_from=suffix_from)
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
                      scratch, length, scratch_len, book, ventry, table,
                      suffix_from=None):
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
            scratch=scratch, scratch_len=scratch_len,
            suffix_from=suffix_from)
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
        length=length, scratch=scratch, scratch_len=scratch_len,
        suffix_from=suffix_from)
    return out, {"k": nk, "v": nv}


def _ssm_entry(rt: Runtime, bp: dict, x, *, mode, centry, scratch):
    """Mamba sub-block. Mode ``decode`` reads the state from ``scratch``
    (the draft passes' copy) if given, else from the cache entry, and
    returns ``h_all`` / ``conv_win`` beside the final state for the
    engine's rollback; mode ``prefill`` returns the final ``(conv, h)``;
    mode ``train`` runs from zero state and returns nothing. Returns
    (out, upd)."""
    state = None
    if mode == "decode":
        src = scratch if scratch is not None else centry
        state = (src["conv"], src["h"])
    out, (conv, h), extras = S.mamba(rt, bp["ssm"], x, state=state,
                                     with_states=mode == "decode")
    if mode not in ("decode", "prefill"):
        return out, {}
    upd = {"conv": conv, "h": h}
    if extras is not None:
        upd.update(extras)
    return out, upd


def _block(rt: Runtime, bp: dict, entry: str, x, positions, *, mode,
           causal=True, centry=None, scratch=None, length=None,
           scratch_len=None, book=None, s_max=0, ventry=None, table=None,
           suffix_from=None, cross_entry=None, enc_out=None):
    """One block: an attention or Mamba mixer, cross-attention (a decoder
    block of an encoder-decoder model: over ``enc_out``, projected here,
    in train and prefill, whose K/V a prefill returns as ``ck`` / ``cv``;
    over the cached ``cross_entry`` in decode), then the FFN. Returns (x,
    cache_update, moe_aux): the aux of an ``'M'`` block (``ffn.moe``),
    None for any other."""
    h = L.norm(rt, bp["norm1"], x)
    if entry[0] == "s":
        out, upd = _ssm_entry(rt, bp, h, mode=mode, centry=centry,
                              scratch=scratch)
    else:
        out, kv_upd = _attn_entry(rt, bp, h, positions, causal=causal,
                                  centry=centry, scratch=scratch,
                                  length=length, scratch_len=scratch_len,
                                  book=book, s_max=s_max, ventry=ventry,
                                  table=table, suffix_from=suffix_from)
        upd = dict(kv_upd) if mode in ("decode", "prefill") else {}
    x = x + out
    if cross_entry is not None or (enc_out is not None and entry[0] == "a"):
        hx = L.norm(rt, bp["norm_x"], x)
        if enc_out is not None:
            ck, cv = A.gqa_project_kv(rt, bp["xattn"], enc_out, None,
                                      "xattn")
            if mode == "prefill":
                upd["ck"], upd["cv"] = ck, cv
        else:
            ck, cv = cross_entry["ck"], cross_entry["cv"]
        xo, _ = A.gqa_attention(rt, bp["xattn"], hx, None, cross_kv=(ck, cv),
                                label="xattn")
        x = x + xo
    aux = None
    if entry[1] == "m":
        h = L.norm(rt, bp["norm2"], x)
        x = x + F.mlp(rt, bp["ffn"], h)
    elif entry[1] == "M":
        h = L.norm(rt, bp["norm2"], x)
        out, aux = F.moe(rt, bp["moe"], h)
        x = x + out
    return x, upd, aux


def _add_aux(total: dict, aux: dict) -> dict:
    """The reference's running aux: balance loss in f32, drops in int32."""
    bl = aux["balance_loss"].to(torch.float32)
    dropped = aux["dropped"].to(torch.int32)
    if not total:
        return {"balance_loss": bl, "dropped": dropped}
    return {"balance_loss": total["balance_loss"] + bl,
            "dropped": total["dropped"] + dropped}


def _index(tree, r: int):
    """Layer ``r`` of a stacked (R, …) tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, r) for v in tree]
    return tree[r]


def _unbind(tree, repeats: int) -> list:
    """The R layers of a stacked (R, …) tree, through ``torch.unbind``
    (views; one stack of the R gradients in the backward)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, repeats) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(repeats)]
    if isinstance(tree, list):
        parts = [_unbind(v, repeats) for v in tree]
        return [[p[r] for p in parts] for r in range(repeats)]
    return list(torch.unbind(tree, 0))


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
                 book=None, s_max=0, view_groups=None, table=None,
                 suffix_from=None, cross_groups=None, enc_out=None,
                 scope: str = "dec"):
    """Run all layer groups; a loop over the repeats R of each group.
    ``scope`` is the groups' subtree (``dec``, or ``enc`` for the
    encoder), under which the calibrator observes.

    Returns (x, aux, updates_groups): updates stacked along R like the
    reference's scan outputs, aux the MoE blocks' summed aux ({} without
    one). In ``mode="train"`` the layers come from ``_unbind`` and, with
    ``rt.remat``, each block runs under ``layers.remat_call``."""
    aux = {}
    updates_groups = []
    for gi, entries in enumerate(entries_per_group):
        gp = groups_params[gi]
        repeats = next(iter(gp["e0"]["norm1"].values())).shape[0]
        layers = _unbind(gp, repeats) if mode == "train" else None
        per_layer = []
        for r in range(repeats):
            g_upd = {}
            for j, entry in enumerate(entries):
                ekey = f"e{j}"
                if rt.collector is not None:
                    rt.collector.layer(f"{scope}[{gi}].{ekey}", r)
                if mode == "train":
                    bp = layers[r][ekey]
                    x, upd, baux = L.remat_call(
                        rt, lambda xx, bp=bp, entry=entry: _block(
                            rt, bp, entry, xx, positions, mode=mode,
                            causal=causal, enc_out=enc_out), x)
                else:
                    pick = lambda grp: (_index(grp[gi][ekey], r)
                                        if grp is not None
                                        and ekey in grp[gi] else None)
                    x, upd, baux = _block(
                        rt, _index(gp[ekey], r), entry, x, positions,
                        mode=mode, causal=causal,
                        centry=pick(cache_groups),
                        scratch=pick(scratch_groups), length=length,
                        scratch_len=scratch_len, book=book, s_max=s_max,
                        ventry=pick(view_groups), table=table,
                        suffix_from=suffix_from,
                        cross_entry=pick(cross_groups), enc_out=enc_out)
                if upd:
                    g_upd[ekey] = upd
                if baux is not None:
                    aux = _add_aux(aux, baux)
            per_layer.append(g_upd)
        updates_groups.append(_stack_updates(per_layer))
    if rt.collector is not None:
        rt.collector.layer(None)
    return x, aux, updates_groups


def _entries(cfg: ModelConfig):
    return [g.entries for g in layer_groups(cfg)]


# ---------------------------------------------------------------------------
# Embedding and the encoder
# ---------------------------------------------------------------------------

def _embed_inputs(rt: Runtime, params, tokens, patch_embeds=None,
                  positions=None):
    """Token embeddings, after a vision frontend's ``patch_embeds``; the
    audio family adds its learned positions (``pos_embed``) at
    ``positions`` (default 0 .. S-1)."""
    cfg = rt.cfg
    x = L.embed(params["embed"], tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    if cfg.family == "audio":
        pos = (positions if positions is not None
               else torch.arange(x.shape[1], device=x.device))
        x = x + params["pos_embed"]["table"][pos.to(torch.int64)].to(x.dtype)
    return x


def _run_encoder(rt: Runtime, params, frame_embeds):
    """The encoder over the frontend's frame embeddings (bf16, plus the
    sinusoidal positions): its groups run without a cache and, unless
    ``causal_encoder``, without a causal mask, then ``enc_norm``."""
    cfg = rt.cfg
    x = frame_embeds.to(torch.bfloat16)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)[None]
    x, _, _ = _scan_groups(rt, params["enc"], _entries(cfg), x, None,
                           mode="train", causal=cfg.causal_encoder,
                           scope="enc")
    return L.norm(rt, params["enc_norm"], x)


def _encode(rt: Runtime, params, batch: dict):
    """The encoder output of an encoder-decoder model, else None."""
    if not rt.cfg.is_encdec:
        return None
    return _run_encoder(rt, params, batch["frame_embeds"])


# ---------------------------------------------------------------------------
# Public forwards
# ---------------------------------------------------------------------------

def forward_train(rt: Runtime, params: Params, batch: dict,
                  return_hidden: bool = False):
    """Full-sequence pass with no cache (the reference's
    ``forward_train``). ``batch`` holds ``tokens``, and ``frame_embeds``
    (an encoder-decoder model) or ``patch_embeds`` (a vision frontend,
    prepended). Returns (logits (B,S,V) f32, or with ``return_hidden`` the
    final-normed hidden states (B,S,d), aux): aux holds the MoE blocks'
    summed ``balance_loss`` (f32) and ``dropped`` (int32), zeros without
    one, as the reference's, and with an ``mtp`` head ``mtp_hidden``
    (``_mtp_hidden``). With ``rt.collector`` set it is the Wanda
    calibration forward."""
    cfg = rt.cfg
    enc_out = _encode(rt, params, batch)
    x = _embed_inputs(rt, params, batch["tokens"], batch.get("patch_embeds"))
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _scan_groups(rt, params["dec"], _entries(cfg), x, positions,
                             mode="train", enc_out=enc_out)
    if not aux:
        aux = {"balance_loss": torch.zeros((), dtype=torch.float32,
                                           device=x.device),
               "dropped": torch.zeros((), dtype=torch.int32,
                                      device=x.device)}
    x = L.norm(rt, params["final_norm"], x)
    if "mtp" in params:
        aux["mtp_hidden"] = _mtp_hidden(rt, params, x, batch["tokens"])
    if return_hidden:
        return x, aux
    return L.unembed(rt, params, x), aux


def _mtp_hidden(rt: Runtime, params, h, tokens):
    """DeepSeek's multi-token prediction: the hidden state predicting token
    t+2 from (h_t, embed(token t+1)), through ``proj``, one ``"am"`` block
    and a final norm (reference ``_mtp_hidden``)."""
    mp = params["mtp"]
    h_in = L.norm(rt, mp["norm_h"], h[:, :-1])
    e_in = L.norm(rt, mp["norm_e"], L.embed(params["embed"], tokens[:, 1:]))
    z = L.dense(rt, mp["proj"], torch.cat([h_in, e_in], dim=-1), "mtp.proj")
    positions = torch.arange(z.shape[1], device=z.device)
    z, _, _ = _block(rt, mp["block"], "am", z, positions, mode="train")
    return L.norm(rt, mp["final_norm"], z)


def forward_prefill(rt: Runtime, params: Params, batch: dict, cache: dict):
    """Process the prompt (``batch`` as ``forward_train``'s), write the
    cache: the packed K/V at offset 0 and, for an encoder-decoder model,
    the cross-attention K/V. Returns (last_logits, cache)."""
    cfg = rt.cfg
    enc_out = _encode(rt, params, batch)
    x = _embed_inputs(rt, params, batch["tokens"], batch.get("patch_embeds"))
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    book = KC.cache_codebook(cache)
    x, _, upd = _scan_groups(rt, params["dec"], _entries(cfg), x, positions,
                             mode="prefill", enc_out=enc_out)
    cache = _commit_prefill(rt, cache, upd, s, book)
    x = L.norm(rt, params["final_norm"], x[:, -1:])
    return L.unembed(rt, params, x), cache


def _commit_prefill(rt: Runtime, cache, updates_groups, s, book):
    """Encode the prompt's K/V (packed caches) and write them at offset 0;
    an SSM entry takes the prompt's final ``conv`` and ``h`` (new tensors,
    as ``engine.commit`` gives them); cross-attention K/V are copied into
    the cache's plain bf16 ``cross`` stores, as the reference writes them,
    never packed."""
    cfg, cass = rt.cfg, rt.cass
    for gi, g_upd in enumerate(updates_groups):
        for ekey, upd in g_upd.items():
            centry = cache["dec"][gi][ekey]
            if KC.is_ssm(upd):
                centry["conv"] = upd["conv"].to(centry["conv"].dtype)
                centry["h"] = upd["h"].to(centry["h"].dtype)
                continue
            for name, d in KC.store_dims(cfg).items():
                new = upd[name]                              # (R,B,S,…,d)
                enc = (KC.encode_store(cass, new, d, book)
                       if book is not None else new)
                for r in range(new.shape[0]):
                    KC.append_store(_index(centry[name], r),
                                    _index(enc, r), 0)
            if "ck" in upd:
                xentry = cache["cross"][gi][ekey]
                xentry["ck"].copy_(upd["ck"])
                xentry["cv"].copy_(upd["cv"])
    cache["length"] = torch.full_like(cache["length"], s)
    return cache


def materialize_cache_view(rt: Runtime, cache: dict) -> list | None:
    """Decode the packed cache's draft/target view once into dense stores
    (slot rows, or whole pools of a paged cache), for the attention
    entries (an SSM entry's state is never packed).

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
        for j, entry in enumerate(g.entries):
            if entry[0] != "a":
                continue
            centry = cache["dec"][gi][f"e{j}"]
            gdict[f"e{j}"] = {
                nm: KC.read_store(cass, centry[nm], d, view, book)
                for nm, d in KC.store_dims(cfg).items()}
        groups.append(gdict)
    return groups


def forward_decode(rt: Runtime, params: Params, tokens: torch.Tensor,
                   cache: dict, scratch: list | None = None,
                   scratch_len=None, cache_view: list | None = None,
                   suffix_from=None):
    """q new tokens against the cache. Returns (logits, updates).

    ``updates`` mirrors the cache groups: per attention entry the new
    tokens' K/V (R,B,q,Hkv,hd) or MLA latents (R,B,q,·), per SSM entry
    {"conv", "h", "h_all", "conv_win"} (the state after all q tokens, h
    after each, and the conv inputs they slide over) for the engine to
    commit. Rows are
    independent: per-row ``length`` offsets positions and masks. A paged
    cache's ``block_table`` addresses its pools; a target pass through the
    paged kernels may give each row's window start ``suffix_from`` (B,)
    (``engine.window_start``). An encoder-decoder model reads the
    cross-attention K/V the prefill cached; the audio family adds the
    learned positions of the new tokens.
    """
    cfg = rt.cfg
    length = cache["length"]
    slen = scratch_len if scratch_len is not None else 0
    q = tokens.shape[1]
    ar = torch.arange(q, device=tokens.device)
    if length.ndim == 1:
        positions = length[:, None] + slen + ar[None, :]
    else:
        positions = length + slen + ar
    x = _embed_inputs(rt, params, tokens, positions=positions)
    book = KC.cache_codebook(cache)
    x, _, upd = _scan_groups(
        rt, params["dec"], _entries(cfg), x, positions, mode="decode",
        cache_groups=cache["dec"], scratch_groups=scratch, length=length,
        scratch_len=slen, book=book, s_max=_cache_s_max(cfg, cache),
        view_groups=cache_view, table=cache.get("block_table"),
        suffix_from=suffix_from, cross_groups=cache.get("cross"))
    x = L.norm(rt, params["final_norm"], x)
    return L.unembed(rt, params, x), upd


def _cache_s_max(cfg: ModelConfig, cache: dict) -> int:
    """Per-request token capacity: the S axis of a slot cache, or the
    table width MB × the block size BS of a paged one."""
    mb = cache["block_table"].shape[1] if KC.is_paged(cache) else 1
    for g in cache["dec"]:
        for e in g.values():
            if KC.is_ssm(e):                          # no token axis
                continue
            leaf = next(iter(e.values()))
            if KC.is_packed(leaf):
                leaf = leaf["spec"]["bitmap"]
            return mb * leaf.shape[2]                 # (R,B,S,…) | (R,NB,BS,…)
    return 0


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(rt: Runtime, params: Params, batch: dict,
            z_loss: float = 1e-4, balance_coef: float = 1e-2,
            mtp_coef: float = 0.3):
    """Causal LM loss (the reference's ``loss_fn``): CE + ``z_loss`` · z
    over the hidden states that predict ``labels[:, 1:]`` (a vision
    model's patches, which come first, left out), MoE's ``balance_coef`` ·
    balance loss, and for ``mtp_depth > 0`` ``mtp_coef`` · the MTP head's
    CE on ``labels[:, 2:]``. Returns (loss, metrics): ``ce``, ``z``, and
    ``balance`` / ``dropped`` (MoE), ``mtp_ce``, ``loss``."""
    cfg = rt.cfg
    if cfg.mtp_depth > 0 and "mtp" not in params:
        raise ValueError(f"{cfg.name} has mtp_depth {cfg.mtp_depth} but the "
                         "parameters have no 'mtp' head (model.init_mtp)")
    hidden, aux = forward_train(rt, params, batch, return_hidden=True)
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:      # vlm: patches prepended
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    ce, z = _chunked_ce(rt, params, hidden[:, :-1], labels[:, 1:])
    loss = ce + z_loss * z
    metrics = {"ce": ce, "z": z}
    if cfg_has_moe(cfg):
        loss = loss + balance_coef * aux["balance_loss"]
        metrics["balance"] = aux["balance_loss"]
        metrics["dropped"] = aux["dropped"]
    if cfg.mtp_depth > 0:
        mtp_h = aux["mtp_hidden"]                # predicts t+2 at index t
        mce, _ = _chunked_ce(rt, params, mtp_h[:, :-1], labels[:, 2:])
        loss = loss + mtp_coef * mce
        metrics["mtp_ce"] = mce
    metrics["loss"] = loss
    return loss, metrics


def _chunked_ce(rt: Runtime, params, hidden, labels, chunk: int = 512):
    """Fused unembed + cross-entropy over sequence chunks (f32): per chunk
    of ``ch`` positions (512, or the largest divisor of S below it) the f32
    logits (B,ch,V), logsumexp minus the gold logit, and the squared
    logsumexp for the z-loss, summed chunk by chunk in order. Under
    autograd each chunk's body runs under ``torch.utils.checkpoint``, so
    its logits are recomputed in the backward and never kept. Returns
    (mean CE, mean lse²) over the B·S positions."""
    b, s, _ = hidden.shape
    ch = min(chunk, s)
    while s % ch:                                # largest divisor <= chunk
        ch -= 1

    def step(h, lab):
        logits = L.unembed(rt, params, h)        # (B,ch,V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].to(torch.int64))[
            ..., 0]
        return torch.sum(lse - gold), torch.sum(torch.square(lse))

    ce_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                 device=hidden.device)
    for i in range(s // ch):
        args = (hidden[:, i * ch:(i + 1) * ch], labels[:, i * ch:(i + 1) * ch])
        if torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint
            c, z = checkpoint(step, *args, use_reentrant=False)
        else:
            c, z = step(*args)
        ce_sum, z_sum = ce_sum + c, z_sum + z
    n = torch.tensor(b * s, dtype=torch.float32, device=hidden.device)
    return ce_sum / n, z_sum / n
