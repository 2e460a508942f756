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
7. report   — ``kernels: [...]``, one JSON line per the kernels table,
              and the last line ``{"ok": true, "device": {...}}``.

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

def tau_check(spec_tok, ar_tok, margins, tau: float, n: int):
    """Spec tokens equal AR tokens per row up to the first position whose AR
    top-1/top-2 margin is below ``tau``. Returns (compared, cut)."""
    compared = 0
    for row in range(ar_tok.shape[0]):
        low = [i for i in range(n) if margins[row, i] < tau]
        stop = low[0] if low else n
        if list(spec_tok[row, :stop]) != list(ar_tok[row, :stop]):
            fail(f"main: row {row} spec tokens {list(spec_tok[row, :stop])} "
                 f"!= AR tokens {list(ar_tok[row, :stop])}")
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
    return {"launches": launches}


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

    # 7. report
    say('kernels: ["draft_matmul"]')
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
    for v in line["kernels"][0].values():
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
