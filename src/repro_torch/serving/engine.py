"""Speculative serving engine (port of ``serving/engine.py``).

One ``spec_decode_step`` per cycle:

1. γ draft steps with ``view="draft"``: every packed product goes through
   the draft-matmul kernel and the KV cache is read through its draft view
   (decoded once per cycle). Draft K/V live in a γ-slot scratch.
2. One verify pass with ``view="target"`` over the γ+1 tokens: the exact
   weights, rebuilt one matrix at a time, and the exact K/V.
3. Greedy acceptance: per-row accepted counts ``n``.
4. Commit: the target's K/V for the accepted prefix are encoded online and
   written at per-row offsets; rejected slots stay masked stale data.

The autoregressive baseline is ``autoregressive_step``: one token per
full-model read, at width 1 like the reference.

``unified_step`` fuses the cycle with chunked prefill admission: one
mixed-role batch where each row is PREFILL (committing prompt-chunk
tokens), DRAFT+VERIFY or IDLE; ``chunk_prefill_step`` is the wide
single-role prefill. The continuous-batching ``serving.scheduler`` drives
both over a slot or a paged cache. Sampling (rejection sampling with a
``torch.Generator``) is a later ROADMAP Queue 1 item.
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

_SAMPLING = ("sampling is not ported yet: ROADMAP Queue 1 "
             "(rejection_sample with a torch.Generator); use greedy=True")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    gamma: int = 5
    greedy: bool = True
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
                           ttft_deadline_ms: float | None = None,
                           itl_target_ms: float | None = None,
                           attn_kernel: str = "off") -> None:
    """Fail fast on inconsistent serving knobs, as one-line ValueErrors.

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
    """γ-slot KV scratch per attention entry, (R,B,γ,Hkv,hd) bf16 (the
    batch comes from ``length``: paged pools have no batch axis)."""
    b = cache["length"].shape[0]
    dev = cache["length"].device
    groups = []
    for g in layer_groups(cfg):
        shape = (g.repeats, b, gamma, cfg.n_kv_heads, cfg.hd)
        groups.append({f"e{j}": {nm: torch.zeros(shape, dtype=torch.bfloat16,
                                                 device=dev)
                                 for nm in ("k", "v")}
                       for j in range(len(g.entries))})
    return groups


def _scratch_write(scratch: list, updates: list, slot: int) -> list:
    """Place draft-step updates (R,B,1,…) into scratch slot ``slot``."""
    for gdict, gupd in zip(scratch, updates):
        for ekey, upd in gupd.items():
            for nm in ("k", "v"):
                gdict[ekey][nm][:, :, slot:slot + 1] = upd[nm].to(
                    gdict[ekey][nm].dtype)
    return scratch


# ---------------------------------------------------------------------------
# Commit (target-side cache update)
# ---------------------------------------------------------------------------

def commit(rt: Runtime, cache: dict, updates: list,
           n: torch.Tensor) -> dict:
    """Append target-recomputed K/V for n+1 accepted tokens per row: into
    each row's slot region, or through the block table into the pool. The
    new ``length`` is a new tensor; the stores are written in place."""
    cfg, cass = rt.cfg, rt.cass
    book = KC.cache_codebook(cache)
    length = cache["length"]
    table = cache.get("block_table")
    for gi, gupd in enumerate(updates):
        for ekey, upd in gupd.items():
            centry = cache["dec"][gi][ekey]
            for nm in ("k", "v"):
                new = upd[nm]                                  # (R,B,q,…)
                if book is not None:
                    new = KC.encode_store(cass, new, cfg.hd, book)
                for r in range(upd[nm].shape[0]):
                    KC.append_batched(M._index(centry[nm], r),
                                      M._index(new, r), length, table)
    cache["length"] = length + n.to(length.dtype) + 1
    return cache


# ---------------------------------------------------------------------------
# Decode steps
# ---------------------------------------------------------------------------

def _run_drafts(rt: Runtime, params, cache: dict, cur_tokens: torch.Tensor,
                ecfg: EngineConfig):
    """γ draft steps with ``view="draft"``; reads the cache, never writes
    it, so rows whose draft inputs are garbage (prefill and idle rows of a
    fused cycle) are harmless. Returns (draft_tokens (B,γ), per-step draft
    logits).

    The cache's draft view is decoded once for the γ passes — unless the
    paged-attention kernel is on: it decodes the packed pool inside the
    kernel on every pass, so materialising would waste the decode and
    reroute the drafts onto the plain kernel."""
    if not ecfg.greedy:
        raise NotImplementedError(_SAMPLING)
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
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
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
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            draft_tokens.append(nxt)
            draft_logits.append(lg)
            tok = nxt[:, None]
    return torch.stack(draft_tokens, dim=1), draft_logits


def _accept(draft_tokens, draft_logits, t_logits,
            ecfg: EngineConfig) -> SP.AcceptResult:
    if not ecfg.greedy:
        raise NotImplementedError(_SAMPLING)
    return SP.greedy_accept(draft_tokens, t_logits[:, :ecfg.gamma + 1],
                            tie_margin=ecfg.tie_margin)


def spec_decode_step(rt: Runtime, params, cache: dict,
                     cur_tokens: torch.Tensor, ecfg: EngineConfig):
    """One speculative cycle. cur_tokens (B,1) = last committed token.
    Returns (AcceptResult, cache)."""
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    draft_tokens, draft_logits = _run_drafts(rt, params, cache, cur_tokens,
                                             ecfg)
    ver_tokens = torch.cat([cur_tokens, draft_tokens], dim=1)
    t_logits, t_upd = M.forward_decode(rt_t, params, ver_tokens, cache)
    res = _accept(draft_tokens, draft_logits, t_logits, ecfg)
    cache = commit(rt, cache, t_upd, res.n_accepted)
    return res, cache


def unified_step(rt: Runtime, params, cache: dict, cur_tokens: torch.Tensor,
                 chunk_tokens: torch.Tensor, prefill_valid: torch.Tensor,
                 decode_mask: torch.Tensor, ecfg: EngineConfig):
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
    """
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    draft_tokens, draft_logits = _run_drafts(rt, params, cache, cur_tokens,
                                             ecfg)
    is_prefill = prefill_valid > 0
    ver_tokens = torch.cat([cur_tokens, draft_tokens], dim=1)
    tokens = torch.where(is_prefill[:, None], chunk_tokens.to(torch.int32),
                         ver_tokens)
    t_logits, t_upd = M.forward_decode(rt_t, params, tokens, cache)
    res = _accept(draft_tokens, draft_logits, t_logits, ecfg)
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
    logits, upd = M.forward_decode(rt_t, params, tokens, cache)
    n = valid.to(torch.int32).clamp(min=1) - 1
    cache = commit(rt, cache, upd, n)
    last = torch.gather(logits, 1, n.to(torch.int64)[:, None, None].expand(
        -1, 1, logits.shape[-1]))[:, 0]
    return last, cache


def autoregressive_step(rt: Runtime, params, cache: dict,
                        cur_tokens: torch.Tensor, greedy: bool = True):
    """bf16-baseline decode: one token per full-model read. Returns
    (next (B,), top-1 minus top-2 logit margin (B,), cache)."""
    if not greedy:
        raise NotImplementedError(_SAMPLING)
    rt_t = dataclasses.replace(rt, view="target" if rt.cass else "plain")
    logits, upd = M.forward_decode(rt_t, params, cur_tokens, cache)
    lg = logits[:, -1]
    nxt = torch.argmax(lg, dim=-1).to(torch.int32)
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
    """Prefill once, then speculative (or autoregressive) cycles."""

    def __init__(self, cfg: ModelConfig, params,
                 cass: CassandraConfig | None = None,
                 ecfg: EngineConfig = EngineConfig(), device="cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        if not ecfg.greedy:
            raise NotImplementedError(_SAMPLING)
        self.cfg, self.cass, self.ecfg = cfg, cass, ecfg
        self.params = params
        self.device = torch.device(device)
        self.rt = Runtime(cfg=cfg, cass=cass,
                          view="target" if cass else "plain")

    @torch.inference_mode()
    def generate(self, batch: dict, max_new: int, speculative: bool = True):
        """Returns (tokens (B, max_new+γ+1) int32, -1 beyond each row's
        output, every row holding ≥ max_new tokens), stats.

        The loop's only host reads are one ``.cpu()`` of ``n_accepted``
        per speculative cycle and the final harvest. Autoregressive runs
        also return ``stats["margins"]``: per generated position the
        target logits' top-1 minus top-2 margin (the prefill token's
        first), the input of the near-tie rule that checks losslessness.
        """
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        pad = self.ecfg.gamma + 1
        cache = KC.init_cache(self.cfg, self.cass, b, s + max_new + pad,
                              packed=self.cass is not None,
                              device=self.device)
        logits, cache = M.forward_prefill(self.rt, self.params,
                                          {"tokens": tokens}, cache)
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
                                              cur, self.ecfg)
                buf, count = scatter_tokens(buf, count, res.tokens,
                                            res.valid, res.n_accepted + 1)
                n = res.n_accepted.cpu().numpy()
                committed += n + 1
                accepted += int(n[active].sum())
                drafted += self.ecfg.gamma * int(active.sum())
                cur = res.next_token[:, None]
            else:
                nxt, margin, cache = autoregressive_step(
                    self.rt, self.params, cache, cur)
                buf, count = scatter_tokens(buf, count, nxt[:, None],
                                            ones_valid, ones_b)
                margins.append(margin)
                committed += 1
                cur = nxt[:, None]
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
        return buf, stats
