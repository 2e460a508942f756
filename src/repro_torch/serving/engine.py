"""Speculative serving engine (port of ``serving/engine.py``).

One ``spec_decode_step`` per cycle:

1. γ draft steps with ``view="draft"``: every packed product goes through
   the draft-matmul kernel and the KV cache is read through its draft view
   (decoded once per cycle). Draft K/V live in a γ-slot scratch, a Mamba
   layer's draft state in a copy of its committed state.
2. One verify pass with ``view="target"`` over the γ+1 tokens: the exact
   weights, rebuilt one matrix at a time, and the exact K/V.
3. Acceptance, greedy (exact match) or paper Eq. 1 rejection sampling
   (``greedy=False``: drafts drawn from ``softmax(logits / temperature)``,
   every draw from the caller's ``torch.Generator``): per-row accepted
   counts ``n``.
4. Commit: the target's K/V for the accepted prefix are encoded online and
   written at per-row offsets; rejected slots stay masked stale data. A
   Mamba layer's state rolls back to each row's accepted position.

The autoregressive baseline is ``autoregressive_step``: one token per
full-model read, at width 1 like the reference.

``unified_step`` fuses the cycle with chunked prefill admission: one
mixed-role batch where each row is PREFILL (committing prompt-chunk
tokens), DRAFT+VERIFY or IDLE; ``chunk_prefill_step`` is the wide
single-role prefill. The continuous-batching ``serving.scheduler`` drives
both over a slot or a paged cache.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, layer_groups
from repro_torch.core import speculative as SP
from repro_torch.core.format import CassandraConfig
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import kvcache as KC
from repro_torch.serving import telemetry as TM
from repro_torch.serving.blockpool import blocks_needed


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    gamma: int = 5
    greedy: bool = True
    temperature: float = 1.0
    # shape-stable draft: every draft step runs at the verify width γ+1
    # over the growing token prefix (no scratch), so draft and verify see
    # the same operand shapes.
    stable_draft: bool = False
    # greedy near-tie acceptance margin (speculative.greedy_accept); 0.0
    # is the strict lossless rule.
    tie_margin: float = 0.0


ATTN_KERNELS = ("off", "on")


def validate_serving_knobs(cfg: ModelConfig, *, gamma: int, num_slots: int,
                           s_max: int, chunk_size: int, fused: bool,
                           speculative: bool, paged: bool, block_size: int,
                           num_blocks: int | None,
                           max_prefill_tokens_per_step: int | None,
                           prefix_cache: bool = False,
                           prefix_cache_blocks: int | None = None,
                           swap: bool = False,
                           swap_store_blocks: int | None = None,
                           ttft_deadline_ms: float | None = None,
                           itl_target_ms: float | None = None,
                           attn_kernel: str = "off",
                           variant: int = 1) -> None:
    """Fail fast on inconsistent serving knobs, as one-line ValueErrors.

    ``variant`` is the Cassandra format of the cache (0: plain bf16).

    The SLO kwargs cover callers that apply one default SLO to every
    request (``launch.serve``); per-request values go through
    ``validate_request_slos`` at ``submit()`` time."""
    validate_request_slos(ttft_deadline_ms=ttft_deadline_ms,
                          itl_target_ms=itl_target_ms)
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1 (got {num_slots})")
    if s_max < gamma + 2:
        raise ValueError(
            f"s_max={s_max} cannot hold even a 1-token prompt plus the "
            f"γ+1={gamma + 1} speculative horizon")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1 (got {chunk_size})")
    if fused and speculative and chunk_size < gamma + 1:
        raise ValueError(
            f"chunk_size={chunk_size} < γ+1={gamma + 1}: the wide "
            "admission bucket would prefill slower than riding fused "
            "cycles, inverting the planner's cost model — raise "
            "chunk_size or lower gamma")
    if (max_prefill_tokens_per_step is not None
            and max_prefill_tokens_per_step < 1):
        raise ValueError(
            "max_prefill_tokens_per_step must be >= 1 (or None): a "
            "zero budget would strand prefilling rows forever")
    if paged:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1 (got {block_size})")
        if num_blocks is not None and num_blocks < 2:
            raise ValueError(
                f"num_blocks={num_blocks}: the pool needs at least one "
                "allocatable block besides the reserved trash block")
    if attn_kernel not in ATTN_KERNELS:
        raise ValueError(f"attn_kernel={attn_kernel!r}: expected one of "
                         f"{'|'.join(ATTN_KERNELS)}")
    if attn_kernel != "off" and not paged:
        raise ValueError(
            "attn_kernel walks the (B,MB) block table in-kernel — it "
            "requires the paged layout (paged=True)")
    if attn_kernel != "off" and variant == 2:
        raise ValueError(M.C2_PACKED_ATTN)
    attention_only = all(e[0] == "a" for g in layer_groups(cfg)
                         for e in g.entries)
    if prefix_cache_blocks is not None and not prefix_cache:
        raise ValueError("prefix_cache_blocks is set but the prefix "
                         "cache is off")
    if prefix_cache:
        if not paged:
            raise ValueError(
                "the prefix cache shares physical pool blocks through "
                "block tables — it requires the paged layout (paged=True)")
        if not attention_only:
            raise ValueError(
                f"{cfg.name}: prefix caching requires pure-attention "
                "archs — SSM recurrent state is per-request and cannot "
                "be reconstructed from shared KV blocks")
        if chunk_size % block_size != 0:
            raise ValueError(
                f"chunk_size={chunk_size} must be a multiple of "
                f"block_size={block_size} when the prefix cache is on: "
                "cache hits seed prefill at block boundaries, and "
                "aligned chunks keep warm-start pass boundaries a subset "
                "of the cold run's (the bitwise-identity condition)")
        if num_blocks is not None and prefix_cache_blocks is not None \
                and prefix_cache_blocks > num_blocks - 1:
            raise ValueError(
                f"prefix_cache_blocks={prefix_cache_blocks} exceeds the "
                f"pool's {num_blocks - 1} allocatable blocks")
    if swap_store_blocks is not None and not swap:
        raise ValueError("swap_store_blocks is set but preemption/swap "
                         "is off")
    if swap:
        if not paged:
            raise ValueError(
                "preemption/swap spills and restores pool blocks through "
                "block tables — it requires the paged layout (paged=True)")
        if not attention_only:
            raise ValueError(
                f"{cfg.name}: preemption requires pure-attention archs — "
                "SSM recurrent state lives per-slot (no pool axis), and a "
                "recycled slot would clobber the victim's state")
        if swap_store_blocks is not None and block_size >= 1:
            row_blocks = blocks_needed(s_max, block_size)
            if swap_store_blocks < row_blocks:
                raise ValueError(
                    f"swap_store_blocks={swap_store_blocks} cannot hold "
                    f"even one full row chain ({row_blocks} blocks at "
                    f"s_max={s_max}, block_size={block_size}) — no victim "
                    "would ever be eligible")


def validate_request_slos(*, ttft_deadline_ms: float | None = None,
                          itl_target_ms: float | None = None) -> None:
    """Each SLO is None (unconstrained) or a finite number of ms > 0."""
    for name, val in (("ttft_deadline_ms", ttft_deadline_ms),
                      ("itl_target_ms", itl_target_ms)):
        if val is None:
            continue
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            raise ValueError(f"{name} must be a number in ms or None "
                             f"(got {val!r})")
        if not math.isfinite(val) or val <= 0:
            raise ValueError(f"{name} must be finite and > 0 ms "
                             f"(got {val})")


# ---------------------------------------------------------------------------
# Scratch (draft-side transient state)
# ---------------------------------------------------------------------------

def make_scratch(cfg: ModelConfig, cache: dict, gamma: int) -> list:
    """γ-slot scratch per attention entry and store, bf16: (R,B,γ,Hkv,hd)
    K and V for GQA, (R,B,γ,L) ``c`` and (R,B,γ,R) ``kr`` for MLA (the
    batch comes from ``length``: paged pools have no batch axis). An SSM
    entry's scratch is its committed ``conv`` and ``h`` (the tensors
    themselves: nothing writes into them), which each draft step
    replaces with its own (reference ``make_scratch``)."""
    b = cache["length"].shape[0]
    dev = cache["length"].device
    groups = []
    for gi, g in enumerate(layer_groups(cfg)):
        gdict = {}
        for j, entry in enumerate(g.entries):
            centry = cache["dec"][gi][f"e{j}"]
            if entry[0] == "s":
                gdict[f"e{j}"] = {"conv": centry["conv"], "h": centry["h"]}
                continue
            gdict[f"e{j}"] = {
                nm: torch.zeros((g.repeats, b, gamma, *KC.store_heads(cfg),
                                 d), dtype=torch.bfloat16, device=dev)
                for nm, d in KC.store_dims(cfg).items()}
        groups.append(gdict)
    return groups


def _scratch_write(scratch: list, updates: list, slot: int) -> list:
    """Place draft-step updates (R,B,1,…) into scratch slot ``slot``; an
    SSM entry takes the step's final ``conv`` and ``h``."""
    for gdict, gupd in zip(scratch, updates):
        for ekey, upd in gupd.items():
            se = gdict[ekey]
            if KC.is_ssm(upd):
                se["conv"] = upd["conv"].to(se["conv"].dtype)
                se["h"] = upd["h"]
                continue
            for nm, new in upd.items():
                se[nm][:, :, slot:slot + 1] = new.to(se[nm].dtype)
    return scratch


# ---------------------------------------------------------------------------
# Commit (target-side cache update)
# ---------------------------------------------------------------------------

def _ssm_rollback(cfg: ModelConfig, centry: dict, upd: dict,
                  n: torch.Tensor) -> None:
    """Set an SSM entry to each row's state after its ``n[b]+1`` accepted
    tokens (reference ``commit``): ``h = h_all[:, b, n[b]]`` and the conv
    window ``conv_win[:, b, n[b]+1 : n[b]+d_conv]``, gathered on the
    device (no host read of ``n``). The entry gets new tensors; the old
    ones are left as they were."""
    h_all, win = upd["h_all"], upd["conv_win"]      # (R,B,q,di,ns), (R,B,·,di)
    r, b = h_all.shape[:2]
    idx = n.to(torch.int64).reshape(1, b, 1, 1, 1).expand(
        r, b, 1, *h_all.shape[3:])
    centry["h"] = torch.gather(h_all, 2, idx)[:, :, 0]
    dc = cfg.ssm_conv
    widx = (n.to(torch.int64).reshape(1, b, 1, 1) + 1
            + torch.arange(dc - 1, device=n.device).reshape(1, 1, -1, 1))
    centry["conv"] = torch.gather(
        win, 2, widx.expand(r, b, dc - 1, win.shape[3])).to(
        centry["conv"].dtype)


def commit(rt: Runtime, cache: dict, updates: list,
           n: torch.Tensor) -> dict:
    """Append target-recomputed K/V (MLA: latents) for n+1 accepted tokens
    per row: into each row's slot region, or through the block table into
    the pool; roll each SSM entry back to the state after the row's n+1
    accepted tokens (``_ssm_rollback``). The new ``length`` is a new
    tensor; the stores are written in place, the SSM state replaced."""
    cfg, cass = rt.cfg, rt.cass
    book = KC.cache_codebook(cache)
    length = cache["length"]
    table = cache.get("block_table")
    for gi, gupd in enumerate(updates):
        for ekey, upd in gupd.items():
            centry = cache["dec"][gi][ekey]
            if KC.is_ssm(upd):
                _ssm_rollback(cfg, centry, upd, n)
                continue
            for nm, d in KC.store_dims(cfg).items():
                new = upd[nm]                                  # (R,B,q,…)
                if book is not None:
                    new = KC.encode_store(cass, new, d, book)
                for r in range(upd[nm].shape[0]):
                    KC.append_batched(M._index(centry[nm], r),
                                      M._index(new, r), length, table)
    cache["length"] = length + n.to(length.dtype) + 1
    return cache


# ---------------------------------------------------------------------------
# Decode steps
# ---------------------------------------------------------------------------

def _need_generator(greedy: bool, generator) -> None:
    if not greedy and generator is None:
        raise ValueError("greedy=False draws its samples from a "
                         "torch.Generator: pass generator=")


def _draw(logits: torch.Tensor, greedy: bool, temperature: float,
          generator: torch.Generator | None) -> torch.Tensor:
    """(B,) int32: the argmax, or one draw from ``softmax(logits /
    temperature)`` in f32 over the whole vocabulary."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return SP.categorical(logits.to(torch.float32) / temperature, generator)


def _run_drafts(rt: Runtime, params, cache: dict, cur_tokens: torch.Tensor,
                ecfg: EngineConfig, generator: torch.Generator | None = None):
    """γ draft steps with ``view="draft"``; reads the cache, never writes
    it, so rows whose draft inputs are garbage (prefill and idle rows of a
    fused cycle) are harmless. Returns (draft_tokens (B,γ), per-step draft
    logits). ``greedy=False`` draws each draft token from ``generator``
    (``_draw``).

    The cache's draft view is decoded once for the γ passes — unless the
    paged-attention kernel is on: it decodes the packed pool inside the
    kernel on every pass, so materialising would waste the decode and
    reroute the drafts onto the plain kernel."""
    _need_generator(ecfg.greedy, generator)
    cfg = rt.cfg
    gamma = ecfg.gamma

    rt_d = dataclasses.replace(rt, view="draft" if rt.cass else "plain")
    if rt.attn_kernel == "on" and KC.is_paged(cache):
        draft_view = None
    else:
        draft_view = M.materialize_cache_view(rt_d, cache)
    draft_tokens, draft_logits = [], []
    if ecfg.stable_draft:
        toks = torch.cat([cur_tokens, cur_tokens.new_zeros(
            (cur_tokens.shape[0], gamma))], dim=1)
        for i in range(gamma):
            logits, _ = M.forward_decode(rt_d, params, toks, cache,
                                         cache_view=draft_view)
            lg = logits[:, i]
            nxt = _draw(lg, ecfg.greedy, ecfg.temperature, generator)
            draft_tokens.append(nxt)
            draft_logits.append(lg)
            toks = toks.clone()
            toks[:, i + 1] = nxt
    else:
        scratch = make_scratch(cfg, cache, gamma)
        tok = cur_tokens
        for i in range(gamma):
            logits, upd = M.forward_decode(rt_d, params, tok, cache,
                                           scratch=scratch, scratch_len=i,
                                           cache_view=draft_view)
            scratch = _scratch_write(scratch, upd, i)
            lg = logits[:, -1]
            nxt = _draw(lg, ecfg.greedy, ecfg.temperature, generator)
            draft_tokens.append(nxt)
            draft_logits.append(lg)
            tok = nxt[:, None]
    return torch.stack(draft_tokens, dim=1), draft_logits


def _accept(draft_tokens, draft_logits, t_logits, ecfg: EngineConfig,
            generator: torch.Generator | None = None) -> SP.AcceptResult:
    if ecfg.greedy:
        return SP.greedy_accept(draft_tokens, t_logits[:, :ecfg.gamma + 1],
                                tie_margin=ecfg.tie_margin)
    t = ecfg.temperature
    dprobs = torch.softmax(
        torch.stack(draft_logits, dim=1).to(torch.float32) / t, dim=-1)
    tprobs = torch.softmax(
        t_logits[:, :ecfg.gamma + 1].to(torch.float32) / t, dim=-1)
    return SP.rejection_sample(draft_tokens, dprobs, tprobs, generator)


def spec_decode_step(rt: Runtime, params, cache: dict,
                     cur_tokens: torch.Tensor, ecfg: EngineConfig,
                     generator: torch.Generator | None = None):
    """One speculative cycle. cur_tokens (B,1) = last committed token.
    Returns (AcceptResult, cache). ``generator`` feeds every draw of a
    non-greedy cycle, in order: the γ drafts, then Eq. 1's uniforms and
    its residual draw."""
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    draft_tokens, draft_logits = _run_drafts(rt, params, cache, cur_tokens,
                                             ecfg, generator)
    ver_tokens = torch.cat([cur_tokens, draft_tokens], dim=1)
    t_logits, t_upd = M.forward_decode(rt_t, params, ver_tokens, cache)
    res = _accept(draft_tokens, draft_logits, t_logits, ecfg, generator)
    cache = commit(rt, cache, t_upd, res.n_accepted)
    return res, cache


def window_start(length: torch.Tensor, valid: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(B,) where a target pass's attention suffix begins, for the paged
    kernels (``attention._window``): a prefill row whose run of ``valid``
    tokens stays inside one ``width``-wide cell of the position grid
    starts it at the cell's start, every other row at its ``length``.
    The scheduler cuts prefill chunks at the cells' edges, so a prompt
    token's attention is summed in one order whichever position its
    row's prefill started from (0, a prefix hit, a resume)."""
    length = length.to(torch.int32)
    off = torch.remainder(length, width)
    inside = (valid > 0) & (off + valid.to(torch.int32) <= width)
    return length - torch.where(inside, off, 0)


def unified_step(rt: Runtime, params, cache: dict, cur_tokens: torch.Tensor,
                 chunk_tokens: torch.Tensor, prefill_valid: torch.Tensor,
                 decode_mask: torch.Tensor, ecfg: EngineConfig,
                 generator: torch.Generator | None = None):
    """One fused serving cycle over a mixed-role batch.

    * PREFILL rows (``prefill_valid[b] > 0``) commit their next
      ``prefill_valid[b]`` prompt tokens from ``chunk_tokens[b]``; the
      returned ``last[b]`` holds the logits at the chunk's last real
      token (the first generated token once the prompt is exhausted);
    * DRAFT+VERIFY rows (``decode_mask[b]``) run one speculative cycle on
      ``cur_tokens[b]``; results land in the returned ``AcceptResult``;
    * IDLE rows commit one garbage token into their masked stale region
      or the trash block; the caller freezes their ``length``.

    ``chunk_tokens`` is (B, γ+1): the fused pass width is the verify
    width, so decode rows see the operand shapes of ``spec_decode_step``.
    The γ draft passes run for every row (drafts write scratch only); one
    target pass then verifies decode rows and prefills prefill rows.

    Deferred-harvest contract: ``res`` and ``last`` are tensors of their
    own (the cache is written in place, never through them), so a caller
    may hold them a full cycle and copy them to the host late; ``commit``
    advances ``length`` on the device, so a later cycle can chain off
    ``res.next_token`` with no host push of lengths.

    A non-greedy cycle draws from ``generator`` for every row (the same
    draws whatever the roles), as ``spec_decode_step`` does.
    """
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    draft_tokens, draft_logits = _run_drafts(rt, params, cache, cur_tokens,
                                             ecfg, generator)
    is_prefill = prefill_valid > 0
    ver_tokens = torch.cat([cur_tokens, draft_tokens], dim=1)
    tokens = torch.where(is_prefill[:, None], chunk_tokens.to(torch.int32),
                         ver_tokens)
    t_logits, t_upd = M.forward_decode(
        rt_t, params, tokens, cache,
        suffix_from=window_start(cache["length"], prefill_valid,
                                 tokens.shape[1]))
    res = _accept(draft_tokens, draft_logits, t_logits, ecfg, generator)
    n = torch.where(is_prefill,
                    prefill_valid.to(torch.int32).clamp(min=1) - 1,
                    torch.where(decode_mask, res.n_accepted, 0))
    cache = commit(rt, cache, t_upd, n)
    last = torch.gather(t_logits, 1, n.to(torch.int64)[:, None, None].expand(
        -1, 1, t_logits.shape[-1]))[:, 0]
    return res, last, cache


def chunk_prefill_step(rt: Runtime, params, cache: dict,
                       tokens: torch.Tensor, valid: torch.Tensor):
    """One batched prefill chunk: q=C prompt tokens per row, appended at
    each row's ``length``; ``valid`` (B,) counts each row's real tokens (0
    for rows riding along, which commit one garbage token the caller
    freezes). Returns (logits at each row's last real token, cache)."""
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    logits, upd = M.forward_decode(
        rt_t, params, tokens, cache,
        suffix_from=window_start(cache["length"], valid, tokens.shape[1]))
    n = valid.to(torch.int32).clamp(min=1) - 1
    cache = commit(rt, cache, upd, n)
    last = torch.gather(logits, 1, n.to(torch.int64)[:, None, None].expand(
        -1, 1, logits.shape[-1]))[:, 0]
    return last, cache


def autoregressive_step(rt: Runtime, params, cache: dict,
                        cur_tokens: torch.Tensor,
                        generator: torch.Generator | None = None,
                        greedy: bool = True, temperature: float = 1.0):
    """bf16-baseline decode: one token per full-model read, the argmax or
    (``greedy=False``) a draw from ``softmax(logits / temperature)``.
    Returns (next (B,), top-1 minus top-2 logit margin (B,), cache)."""
    _need_generator(greedy, generator)
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    logits, upd = M.forward_decode(rt_t, params, cur_tokens, cache)
    lg = logits[:, -1]
    nxt = _draw(lg, greedy, temperature, generator)
    cache = commit(rt, cache, upd,
                   torch.zeros(lg.shape[0], dtype=torch.int32,
                               device=lg.device))
    return nxt, top2_margin(lg), cache


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    """Top-1 minus top-2 logit per row (f32): how near the argmax is a tie."""
    top = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


# ---------------------------------------------------------------------------
# Device-side output harvest
# ---------------------------------------------------------------------------

def scatter_tokens(buf: torch.Tensor, count: torch.Tensor,
                   tokens: torch.Tensor, valid: torch.Tensor,
                   adv: torch.Tensor):
    """Scatter a cycle's accepted tokens into a (B, cap) output buffer.

    Row b writes its valid tokens at offset ``count[b]``; invalid slots and
    slots at or past ``cap`` land in a q-wide overflow tail that is cut
    off, so the scatter needs no host read of the mask. ``adv`` is the
    per-row count advance.
    """
    b, q = tokens.shape
    cap = buf.shape[1]
    pos = count.to(torch.int64)[:, None] + torch.arange(q, device=buf.device)
    pos = torch.where(valid, pos, cap)
    wide = torch.cat([buf, buf.new_full((b, q), -1)], dim=1)
    wide.scatter_(1, pos, torch.where(valid, tokens.to(buf.dtype), -1))
    return wide[:, :cap], torch.clamp(count + adv.to(count.dtype), max=cap)


# ---------------------------------------------------------------------------
# Host-side generation loop
# ---------------------------------------------------------------------------

class Engine:
    """Prefill once, then speculative (or autoregressive) cycles.

    ``rt_extra`` sets further ``Runtime`` fields (the flash chunks; MoE's
    ``moe_capacity_factor``); the MoE aux is ignored, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, params,
                 cass: CassandraConfig | None = None,
                 ecfg: EngineConfig = EngineConfig(), device="cuda",
                 rt_extra: dict | None = None):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        self.cfg, self.cass, self.ecfg = cfg, cass, ecfg
        self.params = params
        self.device = torch.device(device)
        self.rt = Runtime(cfg=cfg, cass=cass,
                          view="target" if cass else "plain",
                          **(rt_extra or {}))

    @torch.inference_mode()
    def generate(self, batch: dict, max_new: int,
                 generator: torch.Generator | None = None,
                 speculative: bool = True, telemetry=None):
        """Returns (tokens (B, max_new+γ+1) int32, -1 beyond each row's
        output, every row holding ≥ max_new tokens), stats.

        ``batch`` holds ``tokens`` (B, S) and a frontend's embeddings:
        ``frame_embeds`` (an encoder-decoder model's encoder input) or
        ``patch_embeds`` (prepended to the text; the cache holds them too,
        as in the reference). ``generator`` feeds a non-greedy run's draws (default: one seeded
        with 0 on the engine's device, the reference's ``PRNGKey(0)``). As
        in the reference, the prefill token is the argmax, and
        ``speculative=False`` runs greedy whatever ``ecfg.greedy`` says.
        ``telemetry`` (a ``serving.telemetry.Telemetry``) gets one
        ``acceptance_len`` observation and one ``CYCLE`` event per active
        row and cycle and the ``cycles`` / ``accepted`` / ``drafted`` /
        ``committed`` counters, from host values the loop reads anyway.

        The loop's only host reads are one ``.cpu()`` of ``n_accepted``
        per speculative cycle and the final harvest. Autoregressive runs
        also return ``stats["margins"]``: per generated position the
        target logits' top-1 minus top-2 margin (the prefill token's
        first), the input of the near-tie rule that checks losslessness.
        """
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        batch = {k: v.to(self.device) for k, v in batch.items()}
        b, s = batch["tokens"].shape
        pad = self.ecfg.gamma + 1
        # a vision frontend's patches sit before the text in the cache
        s_total = s + (self.cfg.frontend_tokens
                       if self.cfg.frontend == "vision" else 0)
        s_max = s_total + max_new + pad
        if self.cfg.family == "audio" and \
                s_max > self.params["pos_embed"]["table"].shape[0]:
            raise ValueError(
                f"{s_max} decoder positions exceed the learned position "
                f"table ({self.params['pos_embed']['table'].shape[0]} rows)")
        cache = KC.init_cache(self.cfg, self.cass, b, s_max,
                              packed=self.cass is not None,
                              device=self.device)
        logits, cache = M.forward_prefill(self.rt, self.params, batch, cache)
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        buf = torch.full((b, max_new + pad), -1, dtype=torch.int32,
                         device=self.device)
        count = torch.zeros(b, dtype=torch.int32, device=self.device)
        ones_b = torch.ones(b, dtype=torch.int32, device=self.device)
        ones_valid = torch.ones((b, 1), dtype=torch.bool, device=self.device)
        buf, count = scatter_tokens(buf, count, cur, ones_valid, ones_b)
        margins = [top2_margin(logits[:, -1])]
        committed = np.ones(b, np.int64)
        cycles = accepted = drafted = 0
        while committed.min() < max_new:
            active = committed < max_new
            if speculative:
                res, cache = spec_decode_step(self.rt, self.params, cache,
                                              cur, self.ecfg, generator)
                buf, count = scatter_tokens(buf, count, res.tokens,
                                            res.valid, res.n_accepted + 1)
                n = res.n_accepted.cpu().numpy()
                committed += n + 1
                accepted += int(n[active].sum())
                drafted += self.ecfg.gamma * int(active.sum())
                cur = res.next_token[:, None]
                if telemetry is not None:
                    for row in np.flatnonzero(active):
                        telemetry.metrics.observe("acceptance_len",
                                                  int(n[row]))
                        telemetry.tracer.emit(
                            TM.CYCLE, rid=int(row), slot=int(row),
                            cycle=float(cycles + 1),
                            args=(self.ecfg.gamma, int(n[row]),
                                  int(n[row]) + 1))
            else:
                nxt, margin, cache = autoregressive_step(
                    self.rt, self.params, cache, cur)
                buf, count = scatter_tokens(buf, count, nxt[:, None],
                                            ones_valid, ones_b)
                margins.append(margin)
                committed += 1
                cur = nxt[:, None]
                if telemetry is not None:
                    for row in np.flatnonzero(active):
                        telemetry.tracer.emit(
                            TM.CYCLE, rid=int(row), slot=int(row),
                            cycle=float(cycles + 1), args=(0, 0, 1))
            cycles += 1
        delivered = count.cpu().numpy().astype(np.int64)
        stats = {"cycles": cycles,
                 "draft_passes": cycles * self.ecfg.gamma if speculative
                 else 0,
                 "tokens_per_cycle": float(delivered.mean() - 1)
                 / max(cycles, 1),
                 "acceptance": accepted / drafted if drafted else None}
        if not speculative:
            stats["margins"] = torch.stack(margins, dim=1).cpu().numpy()
        if telemetry is not None:
            telemetry.metrics.inc("cycles", cycles)
            telemetry.metrics.inc("accepted", accepted)
            telemetry.metrics.inc("drafted", drafted)
            telemetry.metrics.inc("committed", int(delivered.sum()) - b)
        return buf, stats
