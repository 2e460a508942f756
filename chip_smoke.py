#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Drives the port (``src/repro_torch``), never the JAX package, through
these phases; any failure exits non-zero:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — every kernel under ``src/repro_torch/kernels/csrc`` with one
              ``nvcc`` per source, all started together;
3. setup    — full-width Llama-3-8B with random weights from ``--seed`` on
              the card, packed in Cassandra-1 (γ=3), and the ``[format]``
              byte report;
4. kernels  — each kernel of the main path against its plain PyTorch
              version at the main path's shapes (M=4, the model's own
              packed weights): decoded weights bit for bit (identity rows),
              y within rtol 2e-2 / atol 1e-3; kernel, plain, library and
              bound times per shape and per draft pass;
5. small    — the SMOKE config on the card against the same weights on
              the CPU (plain versions): prefill and draft-pass logits;
6. main     — ``Engine.generate`` on 4 requests × 128-token prompts ×
              32 new tokens, autoregressive (width 1) and speculative;
              spec tokens equal the tokens of AR steps run at the verify
              width under the near-tie rule over ≥ 90% of positions, and
              the engine's width-1 AR tokens under that rule (positions
              cut reported); the draft kernel launched exactly draft
              passes × (7·layers + 1) times; one verify pass timed;
4b. paged   — the paged-attention kernels against their plain versions
              on pools from the model's own K/V after a 128-token chunked
              prefill (4 rows, one of length 0, out-of-range table
              entries) and on synthetic 4 × 4096-token pools, T ∈ {1, 4,
              32}: the packed kernel's decode bit for bit, (acc, m, l) and
              the merged output within rtol 1e-4 / atol 1e-5; kernel,
              bound, plain and library µs per shape;
7. sched    — the paged continuous-batching ``Scheduler`` at full width on
              phase 6's prompts (4 slots, block 16, chunk 32, fused,
              overlap, ``attn_kernel="on"``): 32 tokens per request,
              launches = draft passes × layers (packed kernel) and target
              passes × layers (plain kernel), first-token logits within a
              tenth of the logit rms of the Engine's, tokens against
              phase 6's under the near-tie rule (share printed);
8. depth 2  — the same at 2 layers (full width): overlap on == off and
              fused == alternating bit for bit, kernel on == off under the
              near-tie rule over ≥ 90% of positions, the bf16
              autoregressive baseline (variant 0) against them;
9. report   — ``kernels: [...]``, one JSON line per the kernels table,
              and the last line ``{"ok": true, "device": {...}}``.

Phases run in the order 1-6, 4b, 7, 8, 9 (4b reads phase 6's prompts);
phases 1-6 draw their inputs from ``--seed`` as before, the later ones
from a generator of their own.

Every time is measured on the card in this run (CUDA events, or the host
clock around work that ends in ``torch.cuda.synchronize()``).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
RTOL, ATOL = 2e-2, 1e-3            # y vs the plain version (different sum order)
# flash state of the paged kernels vs their plain versions: the same f32
# steps summed in another order
PAGED_RTOL, PAGED_ATOL = 1e-4, 1e-5
BLOCK, CHUNK = 16, 32              # the paged phases' block and chunk sizes


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 4: the draft kernel against its plain version
# ---------------------------------------------------------------------------

def _weights_by_shape(packed, cfg) -> dict:
    """One packed weight of the model per distinct main-path shape, and how
    many products of that shape one draft pass runs."""
    e0 = packed["dec"][0]["e0"]
    r = cfg.n_layers
    return {
        "wq/wo": (e0["attn"]["wq"]["w"], 2 * r),
        "wk/wv": (e0["attn"]["wk"]["w"], 2 * r),
        "w_gate/w_up": (e0["ffn"]["w_gate"]["w"], 2 * r),
        "w_down": (e0["ffn"]["w_down"]["w"], r),
        "lm_head": (packed["lm_head"]["w"], 1),
    }


def _layer(w: dict, r: int) -> dict:
    """Layer ``r`` of a stacked packed weight (a 2-D weight is its own)."""
    if w["spec"]["bitmap"].ndim == 3:
        return w
    return {z: {k: v[r] for k, v in w[z].items()} for z in ("spec", "kernel")}


def kernel_phase(packed, cfg, cass, gen) -> dict:
    import torch
    from repro_torch.kernels import draft_matmul as DM

    m = 4
    rows, agg = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "bytes": 0, "ops": 0}
    max_err = 0.0
    for name, (w, per_pass) in _weights_by_shape(packed, cfg).items():
        n_in, n_out = DM.packed_shape(w)
        block = cass.weight_block(n_in)
        keep = cass.weight_keep(block)
        kw = dict(block=block, keep=keep, trunc=cass.weight_trunc,
                  exp_bits=cass.exp_bits)
        n_layers = 1 if w["spec"]["bitmap"].ndim == 3 else \
            w["spec"]["bitmap"].shape[0]

        def ops_of(r):
            lw = _layer(w, r)
            return (lw["spec"]["bitmap"], lw["spec"]["signmant"],
                    lw["kernel"]["exp3"], lw["kernel"]["emax"],
                    lw["kernel"]["book"])

        layer_ops = [ops_of(r) for r in range(n_layers)]
        x = torch.randn((m, n_in), generator=gen, device="cuda").to(
            torch.bfloat16)
        # (a) decoded weight, bit for bit (identity rows through the kernel)
        eye = torch.eye(n_in, dtype=torch.bfloat16, device="cuda")
        w_kernel = DM.draft_matmul(eye, *layer_ops[0], **kw).to(torch.bfloat16)
        del eye
        w_plain = DM.draft_weight_plain(*layer_ops[0], **kw)
        if not torch.equal(w_kernel.view(torch.int16),
                           w_plain.contiguous().view(torch.int16)):
            bad = (w_kernel.view(torch.int16)
                   != w_plain.contiguous().view(torch.int16)).sum().item()
            fail(f"{name}: decoded draft weight differs from the plain "
                 f"version in {bad} of {w_plain.numel()} values")
        del w_kernel
        # (b) y at M=4 against the plain version
        y = DM.draft_matmul(x, *layer_ops[0], **kw)
        y_plain = DM.draft_matmul_plain(x, *layer_ops[0], **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            fail(f"{name}: kernel output is not finite")
        err = (y - y_plain).abs().max().item()
        if not torch.allclose(y, y_plain, rtol=RTOL, atol=ATOL):
            fail(f"{name}: kernel y differs from the plain version "
                 f"(max abs err {err})")
        max_err = max(max_err, err)
        del y, y_plain
        # (c) times: one launch per layer in turn, so no weight is warm in
        # L2 from its previous launch (each shape's layers hold > 50 MB,
        # lm_head alone ~360 MB)
        def run_kernel():
            for o in layer_ops:
                DM.draft_matmul(x, *o, **kw)
        reps = max(1, 64 // n_layers)
        k_ms = cuda_ms(run_kernel, reps) / n_layers
        n_plain = min(n_layers, 2)
        plain_ms = cuda_ms(lambda: [DM.draft_matmul_plain(x, *o, **kw)
                                    for o in layer_ops[:n_plain]], 1) / n_plain
        dense = [w_plain] + [
            DM.draft_weight_plain(*o, **kw) for o in layer_ops[1:]]
        dense = [d.contiguous() for d in dense]
        del w_plain
        lib_ms = cuda_ms(lambda: [torch.matmul(x, d) for d in dense],
                         reps) / n_layers
        del dense
        bitmap, sm, e3, em, bk = layer_ops[0]
        nbytes = (x.numel() * 2 + sum(t.numel() * 4
                                      for t in (bitmap, sm, e3, em, bk))
                  + m * n_out * 4)
        ops = 2 * m * n_out * bitmap.shape[1] * keep
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
        rows.append((name, n_in, n_out, per_pass, k_ms, bound_ms, plain_ms,
                     lib_ms))
        for key, v in (("ms", k_ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound_ms)):
            agg[key] += per_pass * v
        agg["bytes"] += per_pass * nbytes
        agg["ops"] += per_pass * ops
        torch.cuda.empty_cache()
    say("[kernel] draft_matmul, M=4, (in,out) per shape; us per launch "
        "(mean over the model's layers, each launch on a cold weight):")
    for name, n_in, n_out, per_pass, k_ms, b_ms, p_ms, l_ms in rows:
        say(f"[kernel]   {name:12s} ({n_in},{n_out}) x{per_pass}/pass: "
            f"kernel {k_ms * 1e3:.1f}  bound {b_ms * 1e3:.1f}  "
            f"plain {p_ms * 1e3:.1f}  library {l_ms * 1e3:.1f}")
    say(f"[kernel] one draft pass ({7 * cfg.n_layers + 1} launches): kernel "
        f"{agg['ms']:.3f} ms, bound {agg['bound_ms']:.3f} ms "
        f"({agg['bytes'] / 1e9:.3f} GB, bytes-bound), plain "
        f"{agg['plain_ms']:.3f} ms, library {agg['library_ms']:.3f} ms; "
        f"max |y - plain| = {max_err:.3g}")
    agg["max_abs_err"] = max_err
    return agg


# ---------------------------------------------------------------------------
# Phase 5: small input, card against CPU
# ---------------------------------------------------------------------------

def _tree_to(tree, device, clone=False):
    import torch
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, clone) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, clone) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.to(device, copy=clone)


def small_phase(seed: int) -> None:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC

    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator().manual_seed(seed)
    packed_cpu = format_params(M.init_params(cfg, gen, device="cpu"), cass)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    out = {}
    for dev, tree in (("cpu", packed_cpu), ("cuda", _tree_to(packed_cpu,
                                                             "cuda"))):
        rt = Runtime(cfg=cfg, cass=cass, view="target")
        cache = KC.init_cache(cfg, cass, 2, 40, packed=True, device=dev)
        with torch.inference_mode():
            lg, cache = M.forward_prefill(rt, tree, {"tokens": tokens.to(dev)},
                                          cache)
            cur = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            dl, _ = M.forward_decode(dataclasses.replace(rt, view="draft"),
                                     tree, cur, cache)
        out[dev] = (lg.float().cpu(), dl.float().cpu())
    for i, what in enumerate(("prefill (target view)", "draft pass")):
        a, b = out["cpu"][i], out["cuda"][i]
        if not torch.isfinite(b).all():
            fail(f"small: {what} logits on the card are not finite")
        err = (a - b).abs().max().item()
        say(f"[small] SMOKE width, {what} logits card vs CPU: max abs diff "
            f"{err:.3g} (logit scale {a.abs().max().item():.3g})")
        if err > 2e-2 * max(1.0, a.abs().max().item()):
            fail(f"small: {what} logits differ between card and CPU by {err}")


# ---------------------------------------------------------------------------
# Phase 6: the main path
# ---------------------------------------------------------------------------

def tau_check(spec_tok, ar_tok, margins, tau: float, n: int,
              what: str = "main"):
    """Spec tokens equal AR tokens per row up to the first position whose AR
    top-1/top-2 margin is below ``tau``. Returns (compared, cut)."""
    compared = 0
    for row in range(ar_tok.shape[0]):
        low = [i for i in range(n) if margins[row, i] < tau]
        stop = low[0] if low else n
        if list(spec_tok[row, :stop]) != list(ar_tok[row, :stop]):
            fail(f"{what}: row {row} tokens {list(spec_tok[row, :stop])} "
                 f"!= reference tokens {list(ar_tok[row, :stop])}")
        compared += stop
    return compared, ar_tok.shape[0] * n - compared


def ar_steps(rt_t, params, cache, lg, n: int, width: int):
    """Greedy autoregressive decode of ``n`` tokens from a copy of the
    prefilled ``cache`` (``lg`` its last logits), every step run at
    ``width`` straight through ``forward_decode`` and ``commit`` (the
    current token repeated, position 0 read). Returns (tokens (B,n),
    logits (B,n,V) f32)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.engine import commit
    cache = _tree_to(cache, "cuda", clone=True)
    zeros = torch.zeros(lg.shape[0], dtype=torch.int32, device="cuda")
    logits = [lg.to(torch.float32)]
    toks = [torch.argmax(lg, -1).to(torch.int32)[:, None]]
    for _ in range(n - 1):
        lo, upd = M.forward_decode(rt_t, params, toks[-1].expand(-1, width),
                                   cache)
        logits.append(lo[:, 0].to(torch.float32))
        toks.append(torch.argmax(lo[:, 0], -1).to(torch.int32)[:, None])
        cache = commit(rt_t, cache, upd, zeros)
    return torch.cat(toks, 1), torch.stack(logits, 1)


def main_phase(packed, cfg, cass, gen, args) -> dict:
    import dataclasses

    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import (Engine, EngineConfig, _run_drafts,
                                           top2_margin)

    b, s, n, gamma = args.requests, args.prompt_len, args.max_new, cass.gamma
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                      device="cuda").to(torch.int32)}
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=gamma),
                 device="cuda")
    per_pass = 7 * cfg.n_layers + 1

    # tau per width: γ+1 AR steps at that width against one width-(γ+1)
    # verify pass over the same tokens from the same prefilled cache. The
    # width-(γ+1) run goes on to all n tokens: the harness that holds the
    # spec tokens to an AR run with the verify pass's own numerics.
    rt_t = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(cfg, cass, b, s + n + gamma + 1, packed=True,
                          device="cuda")
    gap, wide = {}, None
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt_t, packed, prompt, cache)
        lg = lg[:, -1]
        for width, steps in ((1, gamma + 2), (gamma + 1, n)):
            toks, logits = ar_steps(rt_t, packed, cache, lg, steps, width)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l_v, _ = M.forward_decode(rt_t, packed, toks[:, :gamma + 1],
                                      cache)
            torch.cuda.synchronize()
            verify_ms = (time.perf_counter() - t0) * 1e3
            if not torch.isfinite(l_v).all():
                fail("main: target logits are not finite")
            diff = logits[:, 1:gamma + 2] - l_v
            gap[width] = diff.abs().max().item()
            say(f"[main] AR steps at width {width} vs the verify pass, "
                f"target logits over {gamma + 1} positions: max abs diff "
                f"{gap[width]:.3g}, rms "
                f"{diff.square().mean().sqrt().item():.3g} (logit rms "
                f"{l_v.square().mean().sqrt().item():.3g})")
            if width > 1:
                wide = (toks.cpu().numpy(), top2_margin(logits).cpu().numpy())
            del toks, logits, l_v, diff
        say(f"[main] one verify pass (target view, width {gamma + 1}, "
            f"{cfg.n_layers} layers): {verify_ms:.1f} ms")
        # the draft side of one cycle: the cache's draft view, then γ passes
        rt_d = dataclasses.replace(eng.rt, view="draft")
        t0 = time.perf_counter()
        M.materialize_cache_view(rt_d, cache)
        torch.cuda.synchronize()
        view_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _run_drafts(eng.rt, packed, cache,
                    torch.argmax(lg, -1).to(torch.int32)[:, None], eng.ecfg)
        torch.cuda.synchronize()
        drafts_ms = (time.perf_counter() - t0) * 1e3
    say(f"[main] draft side of one cycle: {drafts_ms:.1f} ms = the cache's "
        f"draft view {view_ms:.1f} ms + {gamma} draft passes "
        f"{(drafts_ms - view_ms) / gamma:.1f} ms each")
    lg_cpu = lg.to(torch.float32).cpu()
    del cache, lg

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ar, st_ar = eng.generate(prompt, max_new=n, speculative=False)
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    DM.draft_matmul.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, st_sp = eng.generate(prompt, max_new=n, speculative=True)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    launches = DM.draft_matmul.launches
    peak = torch.cuda.max_memory_allocated()

    ar_np, sp_np = ar.cpu().numpy(), sp.cpu().numpy()
    for what, t in (("AR", ar_np), ("spec", sp_np)):
        if t.shape != (b, n + gamma + 1):
            fail(f"main: {what} tokens have shape {t.shape}")
        if not ((t[:, :n] >= 0) & (t[:, :n] < cfg.vocab_size)).all():
            fail(f"main: {what} tokens out of range: {t[:, :n]}")
    # lossless: against the AR run at the verify width (tau from its gap)
    tau = 2.0 * gap[gamma + 1]
    compared, cut = tau_check(sp_np, wide[0], wide[1], tau, n)
    share = compared / (b * n)
    say(f"[main] lossless: spec == AR at the verify width {gamma + 1} on "
        f"{compared} of {b * n} positions ({share:.1%}); tau = 2 x its max "
        f"abs diff = {tau:.3g} cut {cut}")
    if share < 0.9:
        fail(f"main: only {share:.1%} of positions compared under tau")
    # and against the engine's width-1 AR (tau from the width-1 gap)
    tau1 = 2.0 * gap[1]
    compared1, cut1 = tau_check(sp_np, ar_np, st_ar["margins"], tau1, n)
    say(f"[main] spec == Engine AR (width 1) on {compared1} of {b * n} "
        f"positions ({compared1 / (b * n):.1%}); tau = 2 x the width-1 max "
        f"abs diff = {tau1:.3g} cut {cut1}; AR margins below tau: "
        f"{int((st_ar['margins'][:, :n] < tau1).sum())} of {b * n}")
    expect = st_sp["draft_passes"] * per_pass
    say(f"[main] draft_matmul launches {launches} = draft passes "
        f"{st_sp['draft_passes']} x {per_pass}: {launches == expect}")
    if launches == 0 or launches != expect:
        fail(f"main: draft_matmul launched {launches} times, expected "
             f"{expect}")
    say(f"[main] spec: cycles {st_sp['cycles']}, acceptance "
        f"{st_sp['acceptance']:.3f}, tokens/cycle "
        f"{st_sp['tokens_per_cycle']:.3f}, {b * n / sp_s:.2f} tok/s "
        f"({sp_s:.1f} s)")
    say(f"[main] AR (Engine, width 1): cycles {st_ar['cycles']}, "
        f"{b * n / ar_s:.2f} tok/s ({ar_s:.1f} s)")
    say(f"[main] max_memory_allocated during the spec run "
        f"{peak / 2**30:.2f} GiB")
    return {"launches": launches, "prompt": prompt["tokens"], "lg": lg_cpu,
            "wide": wide}

# ---------------------------------------------------------------------------
# Phase 4b: the paged-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_prefill(packed, cfg, cass, prompt, n_new: int):
    """Chunked prefill of ``prompt`` (B,S) into a packed paged cache through
    the engine's own wide step, row b on blocks 1+b·MB .. (block 0 is the
    trash block). Returns (cache, the last prefill logits (B,V))."""
    import torch
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import engine as E, kvcache as KC
    from repro_torch.serving.blockpool import blocks_needed
    b, s = prompt.shape
    mb = blocks_needed(s + n_new + cass.gamma + 1, BLOCK)
    cache = KC.init_paged_cache(cfg, cass, b, b * mb + 1, BLOCK, mb,
                                packed=True, device="cuda")
    cache["block_table"] = (1 + torch.arange(b * mb, device="cuda")).reshape(
        b, mb).to(torch.int32)
    rt = Runtime(cfg=cfg, cass=cass, view="target", attn_kernel="on")
    valid = torch.full((b,), CHUNK, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for c0 in range(0, s, CHUNK):
            last, cache = E.chunk_prefill_step(
                rt, packed, cache, prompt[:, c0:c0 + CHUNK].contiguous(),
                valid)
    return cache, last


def _synthetic_store(cfg, cass, nb: int, gen):
    """A packed pool of random K or V on the card: scale 1/4 (the default
    book's unary mode); half the rows spread over 2^±4 (delta mode), and a
    quarter of the rows 70% zeros, so zeros are kept and their exponent 0
    takes the escape code. A wider spread would make the value sums cancel
    (2^±20 broke every relative tolerance at T=32)."""
    import torch
    from repro_torch.serving import kvcache as KC
    shape = (nb, BLOCK, cfg.n_kv_heads, cfg.hd)
    x = torch.randn(shape, generator=gen, device="cuda") * 0.25
    scale = torch.exp2(torch.randint(-4, 5, shape, generator=gen,
                                     device="cuda").float())
    rows = torch.rand((*shape[:-1], 1), generator=gen, device="cuda")
    x = torch.where(rows < 0.5, x * scale, x)
    holes = torch.rand(shape, generator=gen, device="cuda") < 0.7
    x = torch.where((rows > 0.75) & holes, 0.0, x).to(torch.bfloat16)
    return KC.encode_store(cass, x, cfg.hd, KC.default_kv_codebook("cuda"))


def _escapes(spec: dict, keep: int, exp_bits: int) -> int:
    """Escape codes among the delta-mode rows' exponent codes."""
    from repro_torch.kernels import paged_attention as PA
    words = spec["exp_words"].reshape(-1, spec["exp_words"].shape[-1])
    bits = PA._unpack_bits32(words, keep * exp_bits).reshape(-1, keep,
                                                             exp_bits)
    codes = sum(bits[..., i] << i for i in range(exp_bits))
    delta = spec["exp_mode"].reshape(-1) == 1
    return int((codes[delta] == (1 << exp_bits) - 1).sum())


def _paged_bound_ms(lengths, hkv, g, t, d, row_bytes: float) -> tuple:
    """(bound ms, bound_by, bytes, ops): each row's ``length`` tokens of K
    and V read once per kv head, q read, (acc, m, l) written; 4·G·T·D
    flops per token and head, at the bf16 tensor-core peak."""
    tokens = sum(int(x) for x in lengths)
    b = len(lengths)
    nbytes = (2 * tokens * hkv * row_bytes + b * t * hkv * g * d * 2
              + b * hkv * g * t * (d + 2) * 4)
    ops = 4 * tokens * hkv * g * t * d
    tb, to = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations", \
        nbytes, ops


def _library_ms(q, k_pool, v_pool, table, lengths, reps: int) -> float:
    """One ``scaled_dot_product_attention`` on the rows' gathered bf16 K/V
    (heads repeated for GQA, a length mask): a yardstick only."""
    import torch
    from repro_torch.serving import kvcache as KC
    b, t, hkv, g, d = q.shape
    kd = KC.gather_block_leaf(k_pool, table).permute(0, 2, 1, 3)
    vd = KC.gather_block_leaf(v_pool, table).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, t, d).contiguous()
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: f(qh, kd, vd, attn_mask=mask), reps)


def paged_phase(packed, cfg, cass, prompt, n_new: int, gen) -> dict:
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.attention import _suffix_valid
    from repro_torch.serving import kvcache as KC

    hkv, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    keep = cass.kv_keep(d)
    kw = dict(d=d, keep=keep, trunc=cass.kv_trunc, exp_bits=cass.exp_bits)
    scale = d ** -0.5
    wsm = (keep * (8 - cass.kv_trunc) + 31) // 32
    we = (keep * cass.exp_bits + 31) // 32
    packed_row = 4 * (d // 32 + wsm + we) + 2     # bytes per (token, head)

    # pools from the model's own K/V (layer 0) after a 128-token prefill
    t0 = time.perf_counter()
    cache, _ = paged_prefill(packed, cfg, cass, prompt, n_new)
    torch.cuda.synchronize()
    say(f"[paged] chunked prefill of {tuple(prompt.shape)} into a packed "
        f"paged cache: {time.perf_counter() - t0:.1f} s")
    book = cache["book_exp_of_rank"]
    layer0 = {nm: {z: {k: v[0] for k, v in cache["dec"][0]["e0"][nm][
        z].items()} for z in ("spec", "verif")} for nm in ("k", "v")}
    nb = layer0["k"]["spec"]["bitmap"].shape[0]
    table = cache["block_table"].clone()
    table[2, 1] = nb + 3                 # read as the trash block
    table[:, -1] = -1                    # past every row's length
    s = prompt.shape[1]
    model_case = {
        "name": f"model 4x{s}", "table": table,
        "lengths": torch.tensor([s, s, s - 51, 0], dtype=torch.int32,
                                device="cuda"),
        "spec": (layer0["k"]["spec"], layer0["v"]["spec"]),
        "pools": tuple(KC.read_store(cass, layer0[nm], d, "target",
                                     (book, cache["book_rank_of_exp"]))
                       .contiguous() for nm in ("k", "v"))}
    del cache
    # synthetic 4 rows x 4096 tokens
    rows, ctx = 4, 4096
    mbs = ctx // BLOCK
    nbs = rows * mbs + 1
    ks, vs = (_synthetic_store(cfg, cass, nbs, gen) for _ in range(2))
    dbook = KC.default_kv_codebook("cuda")
    sbook = torch.zeros(256, dtype=torch.uint8, device="cuda")
    sbook[:dbook[0].shape[0]] = dbook[0]
    stable = torch.full((rows, mbs + 1), nbs + 1, dtype=torch.int32,
                        device="cuda")
    stable[:, :mbs] = (1 + torch.arange(rows * mbs, device="cuda")).reshape(
        rows, mbs)
    synth_case = {
        "name": f"synthetic {rows}x{ctx}", "table": stable,
        "lengths": torch.full((rows,), ctx, dtype=torch.int32,
                              device="cuda"),
        "spec": (ks["spec"], vs["spec"]), "book": sbook,
        "pools": tuple(PA.decode_spec_pool_plain(st["spec"], sbook, **kw)
                       for st in (ks, vs))}
    model_case["book"] = book
    del ks, vs
    # the synthetic bf16 pools are the decoded ones, so the plain kernel
    # and the library read the same values as the packed kernel

    out = {"max_abs_err": 0.0, "rows": []}
    escapes = 0
    for case in (model_case, synth_case):
        cbook = case["book"]
        for nm, sp in zip("KV", case["spec"]):
            got = PA.decode_spec_pool(sp, cbook, **kw)
            want = PA.decode_spec_pool_plain(sp, cbook, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                bad = (got.view(torch.int16) != want.view(torch.int16)).sum()
                fail(f"paged: {case['name']} {nm}: decoded pool differs from "
                     f"the plain decode in {bad.item()} values")
            modes = sp["exp_mode"].float().mean().item()
            n_esc = _escapes(sp, keep, cass.exp_bits)
            escapes += n_esc
            say(f"[paged] {case['name']} {nm}: decoded pool bit for bit "
                f"({got.numel()} values, {modes:.0%} delta-mode rows, "
                f"{n_esc} escape codes)")
        kspec, vspec = case["spec"]
        tbl, lens = case["table"], case["lengths"]
        for t in (1, 4, 32):
            q = torch.randn((len(lens), t, hkv, g, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            suf_k, suf_v = (torch.randn((len(lens), t, hkv, d), generator=gen,
                                        device="cuda").to(torch.bfloat16)
                            for _ in range(2))
            suf_valid = _suffix_valid(len(lens), t, 0, 0, q.device)
            runs = {
                "paged_gqa": (
                    lambda: PA.paged_gqa(q, *case["pools"], tbl, lens,
                                         scale=scale),
                    lambda: PA.paged_gqa_plain(q, *case["pools"], tbl, lens,
                                               scale=scale),
                    2 * d),
                "paged_gqa_packed": (
                    lambda: PA.paged_gqa_packed(q, kspec, vspec, tbl, lens,
                                                cbook, scale=scale, **kw),
                    lambda: PA.paged_gqa_packed_plain(
                        q, kspec, vspec, tbl, lens, cbook, scale=scale, **kw),
                    packed_row)}
            lib_ms = _library_ms(q, *case["pools"], tbl, lens, 20)
            for name, (kern, plain, row_bytes) in runs.items():
                got, want = kern(), plain()
                merged = PA.merge_gqa_suffix(*got, q, suf_k, suf_v,
                                             suf_valid, scale=scale)
                merged_p = PA.merge_gqa_suffix(*want, q, suf_k, suf_v,
                                               suf_valid, scale=scale)
                torch.cuda.synchronize()
                err = 0.0
                for a, b_ in list(zip(got, want)) + [(merged, merged_p)]:
                    if not torch.isfinite(b_).all() or not torch.allclose(
                            a, b_, rtol=PAGED_RTOL, atol=PAGED_ATOL):
                        fail(f"paged: {name} {case['name']} T={t} differs "
                             f"from its plain version (max abs err "
                             f"{(a - b_).abs().max().item()})")
                    err = max(err, (a - b_).abs().max().item())
                out["max_abs_err"] = max(out["max_abs_err"], err)
                k_ms = cuda_ms(kern, 20)
                p_ms = cuda_ms(plain, 1)
                b_ms, by, nbytes, ops = _paged_bound_ms(
                    lens.tolist(), hkv, g, t, d, row_bytes)
                out["rows"].append({"kernel": name, "case": case["name"],
                                    "T": t, "ms": k_ms, "plain_ms": p_ms,
                                    "bound_ms": b_ms, "bound_by": by,
                                    "library_ms": lib_ms, "err": err,
                                    "bytes": nbytes})
                say(f"[paged] {name:16s} {case['name']:16s} T={t:2d}: kernel "
                    f"{k_ms * 1e3:.1f} us  bound {b_ms * 1e3:.2f} us ({by}, "
                    f"{nbytes / 1e6:.2f} MB)  plain {p_ms * 1e3:.1f} us  "
                    f"library {lib_ms * 1e3:.1f} us; max abs err {err:.3g}")
        del case["pools"], case["spec"]
        torch.cuda.empty_cache()
    if escapes == 0:
        fail("paged: no escape code among the decoded pools")
    return out


def paged_cycle_ms(packed, cfg, cass, prompt, n_new: int) -> tuple:
    """One verify pass and the draft side of one cycle (γ passes, packed
    kernel) on a paged cache after the prompt's chunked prefill. Returns
    (verify ms, draft-side ms)."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving.engine import EngineConfig, _run_drafts
    cache, last = paged_prefill(packed, cfg, cass, prompt, n_new)
    rt = Runtime(cfg=cfg, cass=cass, view="target", attn_kernel="on")
    cur = torch.argmax(last, -1).to(torch.int32)[:, None]
    with torch.inference_mode():
        toks = cur.expand(-1, cass.gamma + 1).contiguous()
        M.forward_decode(rt, packed, toks, cache)             # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.forward_decode(rt, packed, toks, cache)
        torch.cuda.synchronize()
        verify_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _run_drafts(dataclasses.replace(rt, view="target"), packed, cache,
                    cur, EngineConfig(gamma=cass.gamma))
        torch.cuda.synchronize()
        drafts_ms = (time.perf_counter() - t0) * 1e3
    return verify_ms, drafts_ms


# ---------------------------------------------------------------------------
# Phases 7 and 8: the paged continuous-batching scheduler
# ---------------------------------------------------------------------------

def serve_paged(cfg, params, cass, prompt, n: int, speculative=True, **kw):
    """Every request at arrival 0 through a paged ``Scheduler`` with one
    slot per request (so every admission takes the wide bucket). Returns
    (scheduler, tokens (B,n), each request's first-token logits (B,V),
    wall seconds)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.scheduler import Scheduler
    b, s = prompt.shape
    gamma = cass.gamma if cass is not None else 3
    sched = Scheduler(cfg, params, cass=cass,
                      ecfg=EngineConfig(gamma=gamma), num_slots=b,
                      s_max=s + n + gamma + 1, speculative=speculative,
                      paged=True, block_size=BLOCK, chunk_size=CHUNK,
                      device="cuda", **kw)
    first = {}
    finish = sched._finish_prefill

    def capture(req, last_logits, cycle=None):
        first[req.rid] = np.array(last_logits, dtype=np.float32)
        finish(req, last_logits, cycle=cycle)

    sched._finish_prefill = capture
    reqs = [sched.submit(p, max_new=n) for p in prompt.cpu().numpy()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if len(r.output) != n:
            fail(f"sched: request {r.rid} delivered {len(r.output)} tokens, "
                 f"expected {n}")
    tokens = np.array([r.output for r in reqs], dtype=np.int64)
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"sched: tokens out of range: {tokens}")
    return sched, tokens, np.stack([first[r.rid] for r in reqs]), wall


def _logit_gap(a, b) -> tuple:
    import numpy as np
    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs(diff).max()), float(np.sqrt((diff ** 2).mean()))


def _main_row(paged: dict, name: str, t: int) -> dict:
    """Phase 4b's row of ``name`` on the model's pools at width ``t``."""
    return next(r for r in paged["rows"] if r["kernel"] == name
                and r["case"].startswith("model") and r["T"] == t)


def sched_phase(packed, cfg, cass, args, main: dict, paged: dict,
                agg: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import paged_attention as PA

    prompt, n, layers = main["prompt"], args.max_new, cfg.n_layers
    verify_ms, drafts_ms = paged_cycle_ms(packed, cfg, cass, prompt, n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    DM.draft_matmul.launches = 0
    PA.paged_gqa.launches = PA.paged_gqa_packed.launches = 0
    sched, tokens, first, wall = serve_paged(cfg, packed, cass, prompt, n,
                                             attn_kernel="on")
    launches = {"draft_matmul": DM.draft_matmul.launches,
                "paged_gqa": PA.paged_gqa.launches,
                "paged_gqa_packed": PA.paged_gqa_packed.launches}
    peak = torch.cuda.max_memory_allocated()
    st = sched.summary()
    unified = st["cycles"] - st["prefill_cycles"] + st["mixed_cycles"]
    drafts, targets = cass.gamma * unified, st["cycles"]
    expect = {"draft_matmul": drafts * (7 * layers + 1),
              "paged_gqa": targets * layers,
              "paged_gqa_packed": drafts * layers}
    say(f"[sched] launches {launches}; expected draft passes {drafts} x "
        f"{7 * layers + 1} / target passes {targets} x {layers} / draft "
        f"passes x {layers}: {launches == expect}")
    if launches != expect or min(launches.values()) == 0:
        fail(f"sched: launches {launches} != expected {expect}")
    # the first cycle: the wide prefill's last logits against the Engine's
    # prefill logits at the same tokens
    lg = main["lg"].numpy()
    gmax, grms = _logit_gap(first, lg)
    lrms = float(np.sqrt((lg.astype(np.float64) ** 2).mean()))
    say(f"[sched] first-token logits vs the Engine's prefill: max abs diff "
        f"{gmax:.4g}, rms {grms:.4g} (logit rms {lrms:.4g}; limit "
        f"{0.1 * lrms:.4g})")
    if not gmax < 0.1 * lrms:
        fail(f"sched: first-token logits differ from the Engine's by {gmax}")
    wide_tok, wide_margins = main["wide"]
    tau = 2.0 * gmax
    compared, cut = tau_check(tokens, wide_tok, wide_margins, tau, n,
                              what="sched")
    b = tokens.shape[0]
    say(f"[sched] tokens == Engine (== AR at the verify width) on {compared} "
        f"of {b * n} positions ({compared / (b * n):.1%}) under tau = 2 x the "
        f"first-token max abs diff = {tau:.3g}, cut {cut}; equal at "
        f"{int((tokens == wide_tok).sum())} of {b * n}")
    walls = st["bucket_wall_ms"]
    uni, chunk = walls.get("unified", {}), walls.get("chunk", {})
    say(f"[sched] {b} requests x {n} tokens: cycles {st['cycles']} (wide "
        f"prefill {st['prefill_cycles'] - st['mixed_cycles']}, unified "
        f"{unified}), acceptance {st['acceptance']:.3f}, "
        f"{b * n / wall:.2f} tok/s ({wall:.1f} s); TTFT p50 "
        f"{st['ttft_cycles_p50']:.1f} cycles, ITL p50 "
        f"{st['itl_cycles_p50']:.1f} cycles / {st['itl_ms_p50']:.1f} ms; "
        f"step shapes {st['trace_counts']}")
    kern_ms = {"draft_matmul": cass.gamma * agg["ms"],
               "paged_gqa_packed": cass.gamma * layers * _main_row(
                   paged, "paged_gqa_packed", 1)["ms"],
               "paged_gqa": layers * _main_row(
                   paged, "paged_gqa", cass.gamma + 1)["ms"]}
    say(f"[sched] kernels per unified cycle (phase 4 / 4b times x launches): "
        f"draft_matmul {kern_ms['draft_matmul']:.1f} ms, paged_gqa_packed "
        f"{kern_ms['paged_gqa_packed'] * 1e3:.0f} us, paged_gqa "
        f"{kern_ms['paged_gqa'] * 1e3:.0f} us; {sum(kern_ms.values()):.1f} ms "
        f"in all")
    say(f"[sched] per cycle: unified step {uni.get('mean_ms', 0.0):.1f} ms "
        f"(x{uni.get('calls', 0)}), wide prefill "
        f"{chunk.get('mean_ms', 0.0):.1f} ms (x{chunk.get('calls', 0)}); "
        f"one verify pass {verify_ms:.1f} ms, draft side {drafts_ms:.1f} ms "
        f"({cass.gamma} passes, paged cache after the prefill); overlap "
        f"ratio {st['overlap_ratio']}")
    return {"launches": launches, "peak": peak, "cycles": st["cycles"],
            "unified": unified}


def depth_phase(args, gen) -> None:
    """Phase 8: the scheduler's bitwise gates at 2 layers, full width."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import top2_margin

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    cass = CassandraConfig(variant=1, gamma=3)
    gamma, n = cass.gamma, args.max_new
    plain = M.init_params(cfg, gen, device="cuda")
    packed = format_params(plain, cass)
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=gen, device="cuda").to(torch.int32)
    b, s = prompt.shape
    # reference trajectory: AR steps at the verify width on a slot cache
    rt_t = Runtime(cfg=cfg, cass=cass, view="target")
    cache = KC.init_cache(cfg, cass, b, s + n + gamma + 1, packed=True,
                          device="cuda")
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt_t, packed, {"tokens": prompt}, cache)
        lg = lg[:, -1]
        ref_tok, ref_logits = ar_steps(rt_t, packed, cache, lg, n, gamma + 1)
        w1_tok, w1_logits = ar_steps(rt_t, packed, cache, lg, gamma + 2, 1)
        l_v, _ = M.forward_decode(rt_t, packed, w1_tok[:, :gamma + 1], cache)
    gap1 = (w1_logits[:, 1:] - l_v).abs().max().item()
    ref_tok = ref_tok.cpu().numpy()
    margins = top2_margin(ref_logits).cpu().numpy()
    lg = lg.to(torch.float32).cpu().numpy()
    del cache, ref_logits, w1_logits, l_v

    runs = {}
    for name, params, c, spec, kw in (
            ("on", packed, cass, True, {"attn_kernel": "on"}),
            ("on, overlap off", packed, cass, True,
             {"attn_kernel": "on", "overlap": False}),
            ("on, alternating", packed, cass, True,
             {"attn_kernel": "on", "fused": False}),
            ("off", packed, cass, True, {}),
            ("variant 0 AR, on", plain, None, False, {"attn_kernel": "on"})):
        _, tokens, first, wall = serve_paged(cfg, params, c, prompt, n,
                                             speculative=spec, **kw)
        runs[name] = (tokens, first)
        say(f"[depth2] {name}: {b} x {n} tokens in {wall:.1f} s")
    for other in ("on, overlap off", "on, alternating"):
        same = np.array_equal(runs[other][0], runs["on"][0])
        say(f"[depth2] {other} == on, bit for bit: {same}")
        if not same:
            fail(f"depth2: tokens with {other} differ from the pipelined "
                 f"fused run")
    gaps = {k: _logit_gap(v[1], lg)[0] for k, v in runs.items()}
    onoff = _logit_gap(runs["on"][1], runs["off"][1])[0]
    tau = 2.0 * max(gaps["on"], gaps["off"], onoff)
    say(f"[depth2] first-token logits vs the slot prefill: max abs diff "
        f"{gaps}; on vs off {onoff:.4g}; width-1 vs verify-width gap "
        f"{gap1:.4g}; tau = {tau:.4g}")
    # the prefix rule's share depends on tau and the reference's margins
    # only, so it is one share for both kernel settings
    for name in ("on", "off"):
        compared, cut = tau_check(runs[name][0], ref_tok, margins, tau, n,
                                  what=f"depth2 {name}")
        share = compared / (b * n)
        say(f"[depth2] kernel {name} == AR at the verify width on {compared} "
            f"of {b * n} positions ({share:.1%}), cut {cut}; at least 90%: "
            f"{share >= 0.9}")
    same = int((runs["on"][0] == runs["off"][0]).sum())
    say(f"[depth2] kernel on == off at {same} of {b * n} positions")
    tau0 = 2.0 * max(gaps["variant 0 AR, on"], gap1, tau / 2)
    compared, cut = tau_check(runs["variant 0 AR, on"][0], ref_tok, margins,
                              tau0, n, what="depth2 variant 0")
    say(f"[depth2] variant 0 (bf16 pool, AR, paged_gqa at T=1) == spec "
        f"reference on {compared} of {b * n} positions "
        f"({compared / (b * n):.1%}) under tau = {tau0:.4g}, cut {cut}")


# ---------------------------------------------------------------------------

def run(args) -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on "
             "a machine with an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.core.format import CassandraConfig
        from repro_torch.core.packing import format_params, params_nbytes
        from repro_torch.kernels import build
        from repro_torch.launch.serve import format_line
        from repro_torch.models.model import init_params
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in f32 to the end (no bf16 split-K partials)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    say(smi[0])
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[build] {[b.name for b in built]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for b in built:
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build]   {b.name}: {line.strip()}")

    # 3. setup
    cfg = get_config("llama3-8b")
    if args.layers != cfg.n_layers:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = format_params(params, cass)
    torch.cuda.synchronize()
    t_fmt = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    say(f"[setup] {cfg.name} {cfg.n_layers} layers, d {cfg.d_model}, "
        f"init {t_init:.1f} s, format_params {t_fmt:.1f} s")
    say(format_line(params_nbytes(packed)))

    # 4. kernels against their plain versions
    agg = kernel_phase(packed, cfg, cass, gen)
    # 5. small input against the CPU
    small_phase(args.seed)
    # 6. main path
    main = main_phase(packed, cfg, cass, gen, args)
    gen2 = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    # 4b. paged kernels against their plain versions
    paged = paged_phase(packed, cfg, cass, main["prompt"], args.max_new, gen2)
    # 7. the paged scheduler at full width
    sched = sched_phase(packed, cfg, cass, args, main, paged, agg)
    say(f"[sched] max_memory_allocated during the scheduler run "
        f"{sched['peak'] / 2**30:.2f} GiB")
    del packed
    torch.cuda.empty_cache()
    # 8. the scheduler's bitwise gates at 2 layers
    depth_phase(args, gen2)

    # 9. report
    say('kernels: ["draft_matmul", "paged_gqa", "paged_gqa_packed"]')
    line = {"kernels": [{
        "name": "draft_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/draft_matmul.cu",
        "replaces": "src/repro/kernels/draft_matmul.py:97",
        "launches": main["launches"],
        "max_abs_err": agg["max_abs_err"],
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": "bytes"
        if agg["bytes"] / HBM_BYTES_PER_S >= agg["ops"] / BF16_OPS_PER_S
        else "operations",
        "library_ms": agg["library_ms"]}]}
    # the paged kernels at their main-path shape: the model's pools after
    # the prefill, T=1 for the drafts, T=γ+1 for the verify pass
    for name, line_no, t in (("paged_gqa", 337, cass.gamma + 1),
                             ("paged_gqa_packed", 416, 1)):
        row = _main_row(paged, name, t)
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_gqa.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{line_no}",
            "launches": sched["launches"][name],
            "max_abs_err": paged["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    for k in line["kernels"]:
        for v in k.values():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"non-finite number in the kernels line: {line}")
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth (32 is the model's own)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    run(ap.parse_args())


if __name__ == "__main__":
    main()
