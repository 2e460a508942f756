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
              packed weights): decoded weights bit for bit (identity rows,
              M = n_in, timed), y within rtol 2e-2 / atol 1e-3; kernel,
              plain, library and bound times per shape and per draft pass
              (kernel and library by CUDA-graph replay, eager beside);
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
              bound, plain and library µs per shape (kernel and library by
              CUDA-graph replay, eager beside);
4c. codec   — ``unary_decode`` on the C-1 model's own exponent regions
              and arbitrary words; ``kv_topk``, ``kv_encode`` and
              ``kv_view`` (draft and target) on a prefill's K and V and on
              edge rows (ties, +-0, all-equal, NaN payloads, inf,
              subnormals, mode 1), ``kv_view`` on one layer of a 4 ×
              4096-token pool: bit for bit against their plain versions
              (``kv_encode`` / ``kv_view`` against the plain chains the
              main path ran before them); kernel (graph replay and eager),
              bound, plain (and, for ``kv_topk``, ``torch.topk`` as the
              nearest library call) µs;
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
9. c2       — Cassandra-2 (MX) at full width from ``--seed``: packed bytes
              and the share of weight values the target view returns
              exactly; ``mx_view``'s draft (bf16 and f32) and target views
              of every packed weight matrix bit for bit against the plain
              chain, and per shape (replay, eager, bound, plain chain, the
              product that follows); ``mx_decode`` bit for bit against its
              plain version on the model's w_gate (draft and target
              lanes) and a KV store, and ``mx_view``'s views of that store
              against the chain; ``Engine.generate`` on phase 6's prompts,
              spec tokens equal to AR steps of the C-2 target view at the
              verify width on every position; one verify pass and the
              draft side timed;
10. c2 sched — Cassandra-2 through the paged ``Scheduler`` at 2 layers
              (full width, attention kernel off): every request its
              tokens, overlap on == off and fused == alternating bit for
              bit, ``attn_kernel="on"`` refused with the reference's
              limitation;
11. mla kernels — DeepSeek-V3 at full width cut to its 3 dense layers
              (no routed expert), random weights from ``--seed`` on a
              generator of its own, Cassandra-1 (γ=3): ``draft_matmul``
              per shape on the model's own weights as in phase 4 (q_a, q_b,
              kv_a, o, gate/up, down, lm_head); ``paged_mla``
              against its plain version on the model's own pools after a
              128-token chunked prefill (NaN in every pool row no valid
              position reads, an empty row, out-of-range table entries)
              and on synthetic 4 × 4096-token pools, T ∈ {1, 4, 32}:
              (acc / l, m, l) and the merged context within rtol 1e-4 /
              atol 1e-5 (acc's own rounding grows with l, a sum of up to
              4096 unnormalised terms), two launches equal bit for bit;
              kernel (graph replay and eager), the TF32 and the f32
              CUDA-core bounds, plain and SDPA µs; ``kv_topk``,
              ``kv_encode``, ``kv_view`` and ``unary_decode`` on the
              prefill's c (d 512) and kr (d 64), bit for bit;
12. mla engine — ``Engine.generate`` on the MLA model (4 × 128-token
              prompts × 32 new): spec tokens equal AR steps at the verify
              width on every position; packed bytes, one verify pass, tok/s
              and peak memory; launches as the passes imply;
13. mla sched — the paged ``Scheduler`` on the MLA model with
              ``attn_kernel="on"``: ``paged_mla`` launches = passes ×
              layers, first-token logits within a tenth of the logit rms
              of the Engine's, overlap on == off and fused == alternating
              bit for bit, kernel on == off under the near-tie rule (share
              printed), and the bf16 autoregressive baseline with the
              kernel on and off;
14. report  — ``kernels: [...]``, one JSON line per the kernels table,
              and the last line ``{"ok": true, "device": {...}}``.

Phases run in the order 1-6, 4b, 4c, 7-14 (4b and 4c read phase 6's
prompts). Phases 6, 7, 9, 10, 12 and 13 set every kernel's launch count
to 0 before their run and check it after against what the passes imply
(the C-1 runs also count ``kv_encode``, one per KV store per commit,
``kv_view``, one per KV store view, and ``unary_decode``, MLA's kv_b
draft view; the C-2 runs ``kv_topk``, the KV encode's selection, and
``mx_view``, one per packed matrix and per KV store, view and pass).
Phases 1-6 draw their inputs from ``--seed``, the later ones from
generators of their own.

Every time is measured on the card in this run (CUDA events, or the host
clock around work that ends in ``torch.cuda.synchronize()``). Where a
kernel's row says "graph replay", the calls were captured in one CUDA
graph and replayed, so the time is the card's alone: an eager loop of
calls measures the host's launch rate wherever that is slower.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
TF32_OPS_PER_S = 495e12            # dense TF32 tensor-core peak
CORE_OPS_PER_S = 67e12             # f32 outside the tensor cores: the codec
                                   # kernels' integer and compare operations
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

def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls replayed from
    one CUDA graph: the kernels' own time. The eager loop of ``cuda_ms``
    measures the host instead wherever it launches slower than the card
    runs (the wrappers' Python and ctypes work, ~10-30 us a call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


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


def _mla_weights_by_shape(packed, cfg) -> dict:
    """The MLA model's draft products (its dense layers; kv_b's draft view
    is decoded per pass by ``resolve_weight``, not by the kernel)."""
    e0 = packed["dec"][0]["e0"]
    r = cfg.n_layers
    return {
        "q_a": (e0["attn"]["q_a"]["w"], r),
        "q_b": (e0["attn"]["q_b"]["w"], r),
        "kv_a": (e0["attn"]["kv_a"]["w"], r),
        "o": (e0["attn"]["wo"]["w"], r),
        "gate/up": (e0["ffn"]["w_gate"]["w"], 2 * r),
        "down": (e0["ffn"]["w_down"]["w"], r),
        "lm_head": (packed["lm_head"]["w"], 1),
    }


def _mla_target_by_shape(packed, cfg) -> dict:
    """The MLA model's target-pass weights: the draft products and kv_b."""
    out = _mla_weights_by_shape(packed, cfg)
    out["kv_b"] = (packed["dec"][0]["e0"]["attn"]["kv_b"]["w"], cfg.n_layers)
    return out


def _layer(w: dict, r: int) -> dict:
    """Layer ``r`` of a stacked packed weight (a 2-D weight is its own)."""
    if w["spec"]["bitmap"].ndim == 3:
        return w
    return {z: {k: v[r] for k, v in w[z].items()} for z in ("spec", "kernel")}


def _layer_sv(w: dict, r: int) -> tuple:
    """(spec, verif) of layer ``r`` of a stacked packed weight."""
    if w["spec"]["bitmap"].ndim == 3:
        return w["spec"], w["verif"]
    return tuple({k: v[r] for k, v in w[z].items()} for z in ("spec", "verif"))


def _n_layers(w: dict) -> int:
    bm = w["spec"]["bitmap"]
    return 1 if bm.ndim == 3 else bm.shape[0]


COLD_BYTES = 100e6                 # > 2 x the 50 MB L2: every launch cold


def draft_shapes(weights: dict, cass, gen, tag: str) -> dict:
    """``draft_matmul`` against its plain version at M=4 on a model's own
    packed weights, per shape: the decoded weight bit for bit (identity
    rows, M = n_in, timed), y within RTOL / ATOL; kernel and library
    (``torch.matmul`` on the decoded bf16 weights) timed on the card's
    clock by graph replay and eagerly, plain and bound per launch. Each
    timed launch reads a cold weight: the rotation runs over the model's
    layers, cloned until it holds COLD_BYTES."""
    import torch
    from repro_torch.kernels import draft_matmul as DM

    m = 4
    rows, agg = [], {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0,
                     "library_ms": 0.0, "library_eager_ms": 0.0,
                     "bound_ms": 0.0, "bytes": 0, "ops": 0, "launches": 0}
    max_err = 0.0
    for name, (w, per_pass) in weights.items():
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
        op_bytes = sum(t.numel() * 4 for t in layer_ops[0])
        copies = max(1, math.ceil(COLD_BYTES / (op_bytes * n_layers)))
        rot = layer_ops + [tuple(t.clone() for t in o)
                           for _ in range(copies - 1) for o in layer_ops]
        x = torch.randn((m, n_in), generator=gen, device="cuda").to(
            torch.bfloat16)
        # (a) decoded weight, bit for bit (identity rows through the kernel)
        eye = torch.eye(n_in, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w_kernel = DM.draft_matmul(eye, *layer_ops[0], **kw).to(torch.bfloat16)
        torch.cuda.synchronize()
        eye_s = time.perf_counter() - t0
        del eye
        w_plain = DM.draft_weight_plain(*layer_ops[0], **kw)
        if not torch.equal(w_kernel.view(torch.int16),
                           w_plain.contiguous().view(torch.int16)):
            bad = (w_kernel.view(torch.int16)
                   != w_plain.contiguous().view(torch.int16)).sum().item()
            fail(f"{tag} {name}: decoded draft weight differs from the plain "
                 f"version in {bad} of {w_plain.numel()} values")
        del w_kernel
        # (b) y at M=4 against the plain version
        y = DM.draft_matmul(x, *layer_ops[0], **kw)
        y_plain = DM.draft_matmul_plain(x, *layer_ops[0], **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            fail(f"{tag} {name}: kernel output is not finite")
        err = (y - y_plain).abs().max().item()
        if not torch.allclose(y, y_plain, rtol=RTOL, atol=ATOL):
            fail(f"{tag} {name}: kernel y differs from the plain version "
                 f"(max abs err {err})")
        max_err = max(max_err, err)
        del y, y_plain
        # (c) times, one launch per rotated weight in turn
        def run_kernel():
            for o in rot:
                DM.draft_matmul(x, *o, **kw)
        reps = max(1, 64 // len(rot))
        k_ms = graph_ms(run_kernel, reps) / len(rot)
        k_eager = cuda_ms(run_kernel, reps) / len(rot)
        n_plain = min(n_layers, 2)
        plain_ms = cuda_ms(lambda: [DM.draft_matmul_plain(x, *o, **kw)
                                    for o in layer_ops[:n_plain]], 1) / n_plain
        dense = [w_plain.contiguous()] + [
            DM.draft_weight_plain(*o, **kw).contiguous() for o in rot[1:]]
        del w_plain

        def run_library():
            for d in dense:
                torch.matmul(x, d)
        lib_ms = graph_ms(run_library, reps) / len(dense)
        lib_eager = cuda_ms(run_library, reps) / len(dense)
        del dense, rot
        bitmap, sm, e3, em, bk = layer_ops[0]
        nbytes = (x.numel() * 2 + sum(t.numel() * 4
                                      for t in (bitmap, sm, e3, em, bk))
                  + m * n_out * 4)
        ops = 2 * m * n_out * bitmap.shape[1] * keep
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
        chunk, splits = DM.plan(m, n_out, bitmap.shape[1])
        rows.append((name, n_in, n_out, per_pass, k_ms, k_eager, bound_ms,
                     plain_ms, lib_ms, lib_eager, splits, eye_s))
        for key, v in (("ms", k_ms), ("eager_ms", k_eager),
                       ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("library_eager_ms", lib_eager),
                       ("bound_ms", bound_ms)):
            agg[key] += per_pass * v
        agg["bytes"] += per_pass * nbytes
        agg["ops"] += per_pass * ops
        agg["launches"] += per_pass
        torch.cuda.empty_cache()
    say(f"[{tag}] draft_matmul, M=4, (in,out) per shape; us per launch, each "
        f"on a cold weight; kernel and library on the card's clock (graph "
        f"replay), eager per call in parentheses:")
    for (name, n_in, n_out, per_pass, k_ms, k_eg, b_ms, p_ms, l_ms, l_eg,
         splits, eye_s) in rows:
        say(f"[{tag}]   {name:12s} ({n_in},{n_out}) x{per_pass}/pass, "
            f"{splits} split(s): kernel {k_ms * 1e3:.1f} ({k_eg * 1e3:.1f})  "
            f"bound {b_ms * 1e3:.1f}  plain {p_ms * 1e3:.1f}  library "
            f"{l_ms * 1e3:.1f} ({l_eg * 1e3:.1f})  kernel/library "
            f"{k_ms / l_ms:.2f}; identity rows (M={n_in}) {eye_s:.2f} s")
    say(f"[{tag}] one draft pass ({agg['launches']} launches): kernel "
        f"{agg['ms']:.3f} ms (eager {agg['eager_ms']:.3f}), bound "
        f"{agg['bound_ms']:.3f} ms ({agg['bytes'] / 1e9:.3f} GB, "
        f"bytes-bound), plain {agg['plain_ms']:.3f} ms, library "
        f"{agg['library_ms']:.3f} ms (eager {agg['library_eager_ms']:.3f}); "
        f"max |y - plain| = {max_err:.3g}")
    agg["max_abs_err"] = max_err
    agg["rows"] = rows
    return agg


def kernel_phase(packed, cfg, cass, gen) -> dict:
    """Phase 4: ``draft_matmul`` per Llama-3-8B shape."""
    return draft_shapes(_weights_by_shape(packed, cfg), cass, gen, "kernel")


TD_OPS_PER_VALUE = 16              # target_decode's integer operations per
                                   # value (bit test, prefix counts, select,
                                   # field extraction and join), rounded up


def _packed_weights(packed):
    """Every packed weight of a model, in tree order, with its path."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if "spec" in node and "verif" in node:
                out.append((path, node))
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")

    walk(packed, "")
    return out


def target_all_bitwise(packed, cass, tag: str) -> float:
    """``target_decode`` on every packed weight matrix of the model (every
    layer of every stacked weight) bit for bit against the plain chain
    ``format.target_weight_plain``. Returns the largest absolute difference
    seen (0.0 when every value's bits agree)."""
    import torch
    from repro_torch.core import format as fmt
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import unary_decode as UD
    t0 = time.perf_counter()
    n = modes = 0
    max_err = 0.0
    for path, w in _packed_weights(packed):
        shape = DM.packed_shape(w)
        for r in range(_n_layers(w)):
            spec, verif = _layer_sv(w, r)
            got = UD.target_decode(spec, verif, cass, shape)
            want = fmt.target_weight_plain(spec, verif, cass, shape).T
            diff = got.view(torch.int16) != want.view(torch.int16)
            if bool(diff.any()):
                err = (got[diff].float() - want[diff].float()).abs().max()
                max_err = max(max_err, float(err))
                fail(f"{tag}: target_decode of {path} layer {r} differs from "
                     f"the plain chain in {int(diff.sum())} values (max abs "
                     f"diff {max_err})")
            modes += int(spec["exp_mode"].sum()) + int(
                verif.get("pruned_exp_mode", spec["exp_mode"][:0]).sum())
            n += 1
            del got, want, diff
    torch.cuda.synchronize()
    say(f"[{tag}] target_decode: all {n} packed weight matrices bit for bit "
        f"against the plain chain ({modes} mode-1 superblocks among them; "
        f"max abs diff {max_err}; {time.perf_counter() - t0:.1f} s)")
    return max_err


def target_bytes(spec: dict, verif: dict) -> int:
    """The bytes ``target_decode`` must read for one weight: every packed
    leaf, but a region's correction nibbles only for the superblocks whose
    mode byte is 1 (the only ones that use them)."""
    from repro_torch.core.format import tree_nbytes
    nbytes = tree_nbytes(spec) + tree_nbytes(verif)
    for corr, mode in (("exp_corr", spec.get("exp_mode")),
                       ("pruned_exp_corr", verif.get("pruned_exp_mode"))):
        if corr in verif:
            c = verif[corr]
            per_sb = c.shape[-1] * c.element_size()
            nbytes += per_sb * int(mode.sum()) - tree_nbytes(c)
    return nbytes


def target_shapes(weights: dict, cass, gen, tag: str, m: int) -> dict:
    """``target_decode`` per shape on a model's own packed weights: kernel
    time on the card's clock (graph replay) and eager, each launch on a
    cold weight (the rotation runs over the model's layers, cloned until
    it holds COLD_BYTES); the plain chain's time; the bound (the bytes
    ``target_bytes`` counts, averaged over the rotation's layers, read
    once and the bf16 view written once, at 3.35 TB/s; the integer
    operations at the CUDA cores' 67 T/s); and cuBLAS's time for
    the product that follows in the verify pass, x (m, n_in) @ the view
    (not the same function: the decode has no library equivalent)."""
    import torch
    from repro_torch.core import format as fmt
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import unary_decode as UD
    from repro_torch.core.format import tree_nbytes

    rows, agg = [], {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0,
                     "bound_ms": 0.0, "cublas_ms": 0.0, "bytes": 0,
                     "ops": 0, "launches": 0}
    for name, (w, per_pass) in weights.items():
        shape = DM.packed_shape(w)
        n_in, n_out = shape
        layers = [_layer_sv(w, r) for r in range(_n_layers(w))]
        held = tree_nbytes(layers[0])
        copies = max(1, math.ceil(COLD_BYTES / (held * len(layers))))
        # what the rotation's launches must read, per launch
        op_bytes = sum(target_bytes(*sv) for sv in layers) / len(layers)
        rot = layers + [tuple({k: v.clone() for k, v in t.items()}
                              for t in sv)
                        for _ in range(copies - 1) for sv in layers]

        def run_kernel():
            for spec, verif in rot:
                UD.target_decode(spec, verif, cass, shape)
        reps = max(1, 32 // len(rot))
        k_ms = graph_ms(run_kernel, reps) / len(rot)
        k_eager = cuda_ms(run_kernel, reps) / len(rot)
        plain_ms = cuda_ms(lambda: fmt.target_weight_plain(
            *layers[0], cass, shape), 1)
        x = torch.randn((m, n_in), generator=gen, device="cuda").to(
            torch.bfloat16)
        dense = [UD.target_decode(*sv, cass, shape) for sv in rot[:8]]

        def run_cublas():
            for d in dense:
                torch.matmul(x, d.T)
        c_ms = graph_ms(run_cublas, max(1, 32 // len(dense))) / len(dense)
        del dense, rot
        nbytes = op_bytes + n_in * n_out * 2
        ops = TD_OPS_PER_VALUE * n_in * n_out
        tb, to = nbytes / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
        bound_ms = max(tb, to) * 1e3
        rows.append((name, n_in, n_out, per_pass, k_ms, k_eager, bound_ms,
                     plain_ms, c_ms, "bytes" if tb >= to else "operations"))
        for key, v in (("ms", k_ms), ("eager_ms", k_eager),
                       ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("cublas_ms", c_ms)):
            agg[key] += per_pass * v
        agg["bytes"] += per_pass * nbytes
        agg["ops"] += per_pass * ops
        agg["launches"] += per_pass
        torch.cuda.empty_cache()
    say(f"[{tag}] target_decode, (in,out) per shape; us per launch, each on "
        f"a cold weight; kernel on the card's clock (graph replay), eager in "
        f"parentheses; cuBLAS: the product that follows, M={m}:")
    for (name, n_in, n_out, per_pass, k_ms, k_eg, b_ms, p_ms, c_ms,
         by) in rows:
        say(f"[{tag}]   {name:12s} ({n_in},{n_out}) x{per_pass}/pass: kernel "
            f"{k_ms * 1e3:.1f} ({k_eg * 1e3:.1f})  bound {b_ms * 1e3:.1f} "
            f"({by})  kernel/bound {k_ms / b_ms:.2f}  plain "
            f"{p_ms * 1e3:.1f}  cuBLAS product {c_ms * 1e3:.1f}")
    say(f"[{tag}] one target pass's decodes ({agg['launches']} launches): "
        f"kernel {agg['ms']:.3f} ms (eager {agg['eager_ms']:.3f}), bound "
        f"{agg['bound_ms']:.3f} ms ({agg['bytes'] / 1e9:.3f} GB), plain "
        f"{agg['plain_ms']:.1f} ms; the products after them in cuBLAS "
        f"{agg['cublas_ms']:.3f} ms")
    agg["rows"] = rows
    agg["bound_by"] = ("bytes" if agg["bytes"] / HBM_BYTES_PER_S
                       >= agg["ops"] / CORE_OPS_PER_S else "operations")
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
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, st_sp = eng.generate(prompt, max_new=n, speculative=True)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    launches = DM.draft_matmul.launches
    codec = codec_launches()
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
    # one target_decode per packed weight per target pass; one kv_view
    # per KV target view per layer per verify pass and per draft view of
    # the cache once per cycle; one kv_encode per store per commit
    cyc, mats = st_sp["cycles"], packed_matrices(packed)
    check_launches("main", codec, {
        "mx_decode": 0, "mx_view": 0, "kv_topk": 0,
        "kv_encode": 2 * (1 + cyc),
        "kv_view": 2 * cfg.n_layers * cyc + 2 * cyc, "unary_decode": 0,
        "target_decode": mats * (1 + cyc)})
    say(f"[main] spec: cycles {st_sp['cycles']}, acceptance "
        f"{st_sp['acceptance']:.3f}, tokens/cycle "
        f"{st_sp['tokens_per_cycle']:.3f}, {b * n / sp_s:.2f} tok/s "
        f"({sp_s:.1f} s)")
    say(f"[main] AR (Engine, width 1): cycles {st_ar['cycles']}, "
        f"{b * n / ar_s:.2f} tok/s ({ar_s:.1f} s)")
    say(f"[main] max_memory_allocated during the spec run "
        f"{peak / 2**30:.2f} GiB")
    return {"launches": launches, "codec": codec, "prompt": prompt["tokens"],
            "lg": lg_cpu, "wide": wide}

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


def _library_ms(q, k_pool, v_pool, table, lengths, reps: int) -> tuple:
    """One ``scaled_dot_product_attention`` on the rows' gathered bf16 K/V
    (heads repeated for GQA, a length mask): a yardstick only. Returns
    (graph-replay ms, eager ms)."""
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
    run = lambda: f(qh, kd, vd, attn_mask=mask)
    return graph_ms(run, reps), cuda_ms(run, reps)


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
            lib_ms, lib_eager = _library_ms(q, *case["pools"], tbl, lens,
                                            20)
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
                k_ms, k_eager = graph_ms(kern, 20), cuda_ms(kern, 20)
                p_ms = cuda_ms(plain, 1)
                b_ms, by, nbytes, ops = _paged_bound_ms(
                    lens.tolist(), hkv, g, t, d, row_bytes)
                out["rows"].append({"kernel": name, "case": case["name"],
                                    "T": t, "ms": k_ms, "eager_ms": k_eager,
                                    "plain_ms": p_ms, "bound_ms": b_ms,
                                    "bound_by": by, "library_ms": lib_ms,
                                    "library_eager_ms": lib_eager,
                                    "err": err, "bytes": nbytes})
                say(f"[paged] {name:16s} {case['name']:16s} T={t:2d}: kernel "
                    f"{k_ms * 1e3:.1f} us ({k_eager * 1e3:.1f})  bound "
                    f"{b_ms * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB)  plain "
                    f"{p_ms * 1e3:.1f} us  library {lib_ms * 1e3:.1f} us "
                    f"({lib_eager * 1e3:.1f}); max abs err {err:.3g}")
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
    # the capture closes a reference cycle (sched -> capture -> bound
    # method -> sched) that would keep the model alive until a full gc
    del sched._finish_prefill
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
                agg: dict, target: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import paged_attention as PA

    prompt, n, layers = main["prompt"], args.max_new, cfg.n_layers
    verify_ms, drafts_ms = paged_cycle_ms(packed, cfg, cass, prompt, n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sched, tokens, first, wall = serve_paged(cfg, packed, cass, prompt, n,
                                             attn_kernel="on")
    launches = {"draft_matmul": DM.draft_matmul.launches,
                "paged_gqa": PA.paged_gqa.launches,
                "paged_gqa_packed": PA.paged_gqa_packed.launches}
    codec = codec_launches()
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
    # the packed kernel decodes the draft KV itself: no draft view
    check_launches("sched", codec, {
        "mx_decode": 0, "mx_view": 0, "kv_topk": 0,
        "kv_encode": 2 * targets, "kv_view": targets * 2 * layers,
        "unary_decode": 0,
        "target_decode": targets * packed_matrices(packed)})
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
                   paged, "paged_gqa", cass.gamma + 1)["ms"],
               "target_decode": target["ms"]}
    say(f"[sched] kernels per unified cycle (phase 4 / 4b times x launches): "
        f"draft_matmul {kern_ms['draft_matmul']:.1f} ms, paged_gqa_packed "
        f"{kern_ms['paged_gqa_packed'] * 1e3:.0f} us, paged_gqa "
        f"{kern_ms['paged_gqa'] * 1e3:.0f} us, target_decode "
        f"{kern_ms['target_decode']:.1f} ms; {sum(kern_ms.values()):.1f} ms "
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
# Phase 4c: the codec kernels against their plain versions
# ---------------------------------------------------------------------------

def layer0_kv(packed, cfg, cass, prompt):
    """A prefill's layer-0 K and V (B,S,Hkv,hd) bf16, the vectors the KV
    encoder packs: norm1, the K/V projections (target view) and rope."""
    import torch
    from repro_torch.models import attention as A, layers as L, model as M
    from repro_torch.models.layers import Runtime
    rt = Runtime(cfg=cfg, cass=cass, view="target")
    p0 = M._index(packed["dec"][0]["e0"], 0)
    with torch.inference_mode():
        x = L.norm(rt, p0["norm1"], L.embed(packed["embed"], prompt))
        return A.gqa_project_kv(rt, p0["attn"], x, torch.arange(
            prompt.shape[1], device=prompt.device))


def _bits(t):
    import torch
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _max_err(a, b) -> float:
    if isinstance(a, dict):
        return max(_max_err(a[k], b[k]) for k in a)
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs().nan_to_num(0.0)
    return float(d.max())


def codec_row(kernel: str, case: str, run, plain, nbytes: int, ops: int,
              library=None, reps: int = 20) -> dict:
    """One codec kernel at one shape: bit for bit against its plain version
    (or plain chain) on the same inputs, then µs per launch by CUDA-graph
    replay and eagerly, the bound (the larger of the bytes at 3.35 TB/s
    and the integer/compare operations at the CUDA cores' 67 T/s) and the
    plain version's time; ``library`` is the nearest PyTorch call, timed
    as a yardstick only."""
    import torch
    got, want = run(), plain()
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        fail(f"codec: {kernel} {case} differs from its plain version")
    err = _max_err(got, want)
    del got, want
    k_ms = graph_ms(run, reps)
    k_eager = cuda_ms(run, reps)
    p_ms = cuda_ms(plain, 2)
    l_ms = graph_ms(library, reps) if library is not None else None
    tb, to = nbytes / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
    row = {"kernel": kernel, "case": case, "ms": k_ms, "eager_ms": k_eager,
           "plain_ms": p_ms, "bound_ms": max(tb, to) * 1e3,
           "bound_by": "bytes" if tb >= to else "operations",
           "library_ms": l_ms, "err": err, "bytes": nbytes}
    lib = f"  nearest library {l_ms * 1e3:.1f} us" if l_ms is not None \
        else "  library none"
    say(f"[codec] {kernel:12s} {case:40s}: bit for bit; kernel "
        f"{k_ms * 1e3:.1f} us (eager {k_eager * 1e3:.1f})  bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
        f"{nbytes / 1e6:.2f} MB; x{k_ms / row['bound_ms']:.2f})  plain "
        f"{p_ms * 1e3:.1f} us{lib}")
    return row


SELECT_OPS = 16                    # the radix select: 15 rounds + the ties


def kv_codec_rows(cass, x, d: int, case: str, book, views=True) -> list:
    """kv_topk, kv_encode and (``views``) kv_view's draft and target views
    on (…, d) vectors ``x``: each against its plain version or the plain
    chain the main path ran before them (``kvcache.encode_store_plain`` /
    ``read_store_plain``), bit for bit."""
    import torch
    from repro_torch.core.format import tree_nbytes
    from repro_torch.kernels import kv_topk as KT
    from repro_torch.serving import kvcache as KC
    x = x.reshape(-1, d).contiguous()
    r, kk = x.shape[0], cass.kv_keep(d)
    mag = x.float().abs()
    kw = dict(keep=kk, trunc=cass.kv_trunc, exp_bits=cass.exp_bits)
    rows = [codec_row(
        "kv_topk", f"{case} {r}x{d}->{kk}",
        lambda: KT.kv_topk(x, kk), lambda: KT.kv_topk_plain(x, kk),
        r * (2 * d + d // 8 + 2 * d), r * d * SELECT_OPS,
        library=lambda: torch.topk(mag, kk, dim=-1))]
    store = KC.encode_store(cass, x, d, book)
    rows.append(codec_row(
        "kv_encode", f"{case} {r}x{d}->{kk}",
        lambda: dict(zip(("spec", "verif"), KT.kv_encode(x, book[1], **kw))),
        lambda: KC.encode_store_plain(cass, x, d, book),
        r * 2 * d + tree_nbytes(store), r * d * SELECT_OPS))
    if views:
        rows += kv_view_rows(cass, store, d, f"{case} store", book)
    del store, mag
    return rows


def kv_view_rows(cass, store, d: int, case: str, book) -> list:
    """kv_view's draft and target views of a C-1 store against the plain
    chain (``kvcache.read_store_plain``), bit for bit."""
    from repro_torch.core.format import tree_nbytes
    from repro_torch.kernels import unary_decode as UD
    from repro_torch.serving import kvcache as KC
    kw = dict(d=d, keep=cass.kv_keep(d), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits)
    units = store["spec"]["bitmap"].numel() // (d // 32)
    rows = []
    for view in ("draft", "target"):
        verif = store["verif"] if view == "target" else None
        rows.append(codec_row(
            "kv_view", f"{case} {view} {units}x{d}",
            lambda v=verif: UD.kv_view(store["spec"], v, book[0], **kw),
            lambda w=view: KC.read_store_plain(cass, store, d, w, book),
            tree_nbytes(store["spec"]) + tree_nbytes(verif or {})
            + units * d * 2, units * d * 8))
    return rows


def codec_c1_phase(packed, cfg, cass, prompt, gen) -> list:
    """unary_decode on the C-1 model's own exponent regions (w_gate, layer
    0: kept and pruned) and arbitrary words; kv_topk, kv_encode and
    kv_view on a prefill's K and V and on synthetic edge rows (ties, +-0,
    all-equal, NaN payloads, inf, subnormals, mode 1); kv_view on one
    layer of a 4 x 4096-token pool."""
    import torch
    from repro_torch.kernels import unary_decode as UD
    from repro_torch.serving import kvcache as KC
    rows = []
    wg = packed["dec"][0]["e0"]["ffn"]["w_gate"]["w"]
    block = cass.weight_block(cfg.d_model)
    keep = cass.weight_keep(block)
    regions = (("w_gate kept exponent regions", wg["spec"]["exp_words"][0],
                keep),
               ("w_gate pruned exponent regions",
                wg["verif"]["pruned_exp_words"][0], block - keep))
    for case, words, k in regions:
        words = words.reshape(-1, words.shape[-1]).contiguous()
        r, w = words.shape
        rows.append(codec_row(
            "unary_decode", f"{case} {r}x{w}->{k}",
            lambda words=words, k=k: UD.unary_decode(words, k),
            lambda words=words, k=k: UD.unary_decode_plain(words, k),
            4 * r * (w + k), 32 * r * w))
    rnd = torch.randint(-2 ** 31, 2 ** 31 - 1, (16384, 30), generator=gen,
                        device="cuda", dtype=torch.int32)
    rnd[:64] = 0
    rnd[64:128] = -1                                     # no ones, all ones
    rows.append(codec_row(
        "unary_decode", "arbitrary words 16384x30->320",
        lambda: UD.unary_decode(rnd, keep),
        lambda: UD.unary_decode_plain(rnd, keep),
        4 * 16384 * (30 + keep), 32 * 16384 * 30))
    k, v = layer0_kv(packed, cfg, cass, prompt)
    d = cfg.hd
    book = KC.default_kv_codebook("cuda")
    for case, x in (("prefill K (layer 0)", k), ("prefill V (layer 0)", v),
                    ("synthetic edge rows", edge_rows(gen, 4096, d))):
        rows += kv_codec_rows(cass, x, d, case, book)
    del k, v
    # one layer of a 4 x 4096-token pool (the view a paged verify pass
    # reads per layer and store): half the vectors at scale 1/4, a quarter
    # spread over 2^+-8 (mode 1), a quarter mostly zeros
    x = synthetic_kv(gen, (4 * 4096, cfg.n_kv_heads, d))
    pool = KC.encode_store(cass, x, d, book)
    del x
    rows += kv_view_rows(cass, pool, d, "pool 4x4096 tokens", book)
    del pool
    torch.cuda.empty_cache()
    return rows


def edge_rows(gen, r: int, d: int):
    """(r, d) bf16 on the card: rows at scale 1/4, and every 8 rows one
    each of all equal, +-0 only, |v| ties (small integers), NaN payloads
    of every kind, inf, subnormals and a 2^+-12 spread."""
    import torch
    x = (torch.randn((r, d), generator=gen, device="cuda") * 0.25).to(
        torch.bfloat16)
    x[::8] = 1.0                                         # all equal
    x[1::8, ::2] = -0.0                                  # +-0 and ties
    x[1::8, 1::2] = 0.0
    x[2::8] = (x[2::8] * 8).round()
    b = x.view(torch.int16)
    b[3::8, ::5] = 0x7FC1                                # NaN payloads
    b[3::8, 2::7] = -0x7F                                # 0xFF81
    b[4::8, ::9] = 0x7F80                                # inf
    x[5::8] = (torch.randn((len(x[5::8]), d), generator=gen, device="cuda")
               * 2.0 ** -128).to(torch.bfloat16)         # subnormals
    x[6::8] = (torch.randn((len(x[6::8]), d), generator=gen, device="cuda")
               * torch.exp2(torch.randint(-12, 13, (len(x[6::8]), d),
                                          generator=gen, device="cuda")
                            .float())).to(torch.bfloat16)
    return x


def synthetic_kv(gen, shape):
    """bf16 K or V of ``shape`` on the card: half the vectors at scale
    1/4, a quarter spread over 2^+-8, a quarter 70% zeros."""
    import torch
    x = torch.randn(shape, generator=gen, device="cuda") * 0.25
    pick = torch.randint(0, 4, (*shape[:-1], 1), generator=gen,
                         device="cuda")
    spread = torch.exp2(torch.randint(-8, 9, shape, generator=gen,
                                      device="cuda").float())
    x = torch.where(pick == 0, x * spread, x)
    zeros = torch.rand(shape, generator=gen, device="cuda") < 0.7
    x = torch.where((pick == 1) & zeros, 0.0, x)
    return x.to(torch.bfloat16)


def codec_mx_phase(packed, cfg, cass, prompt) -> list:
    """mx_decode on the C-2 model's own w_gate (layer 0: the draft and the
    target containers of every kept lane) and on a KV store encoded from a
    prefill's K; mx_view's draft and target views of that store, bit for
    bit against the plain chain (``format.draft_tensor`` /
    ``target_tensor``)."""
    import torch
    from repro_torch.core import bitops, format as fmt, mx
    from repro_torch.core.format import tree_nbytes
    from repro_torch.kernels import mx_decode as MXD
    from repro_torch.serving import kvcache as KC
    db = cass.mx_draft_bits
    lo_bits = mx.CONTAINER_BITS - db
    block = cass.weight_block(cfg.d_model)
    wg = packed["dec"][0]["e0"]["ffn"]["w_gate"]["w"]
    k, _ = layer0_kv(packed, cfg, cass, prompt)
    kv = KC.encode_store(cass, k, cfg.hd, KC.default_kv_codebook("cuda"))

    def lanes(spec, verif, k_, target):
        code = bitops.unpack_codes(spec["signmant"], 1 + db, k_)
        m16 = (code & ((1 << db) - 1)) << lo_bits
        if target:
            m16 = m16 | bitops.unpack_codes(verif["mant_lo"], lo_bits, k_)
        sign = ((code >> db) & 1).to(torch.uint8)
        shape = (-1, k_)
        return (sign.reshape(shape).contiguous(),
                bitops.as_int16(m16).reshape(shape).contiguous(),
                spec["shared_exp"].reshape(-1, spec["shared_exp"].shape[-1])
                .contiguous())

    cases = []
    for target in (True, False):
        cases.append((f"w_gate {'target' if target else 'draft'} lanes",
                      lanes({n: t[0] for n, t in wg["spec"].items()},
                            {n: t[0] for n, t in wg["verif"].items()},
                            cass.weight_keep(block), target),
                      cass.mx_group))
    cases.append(("KV store target lanes (prefill K)",
                  lanes(kv["spec"], kv["verif"], cass.kv_keep(cfg.hd), True),
                  fmt.kv_group(cass, cfg.hd)))
    rows = []
    for case, (sg, m16, se), group in cases:
        r, kk = m16.shape
        rows.append(codec_row(
            "mx_decode", f"{case} {r}x{kk} g{group}",
            lambda a=(sg, m16, se), g=group: MXD.mx_decode(*a, g),
            lambda a=(sg, m16, se), g=group: MXD.mx_decode_plain(*a, g),
            r * kk * 5 + se.numel(), 12 * r * kk))
    d, keep = cfg.hd, cass.kv_keep(cfg.hd)
    g = fmt.kv_group(cass, d)
    units = kv["spec"]["bitmap"].numel() // (d // 32)
    for view in ("draft", "target"):
        verif = kv["verif"] if view == "target" else None
        chain = (fmt.draft_tensor, (kv["spec"],)) if verif is None else \
            (fmt.target_tensor, (kv["spec"], verif))
        nbytes = (tree_nbytes(kv["spec"]) + tree_nbytes(verif or {})
                  + units * d * 2)
        rows.append(codec_row(
            "mx_view", f"KV store {view} view (prefill K) {units}x{d}",
            lambda v=verif: MXD.mx_view(kv["spec"], v, block=d, keep=keep,
                                        group=g, draft_bits=db),
            lambda c=chain: c[0](*c[1], cass, d, keep, g, cass.kv_trunc, d),
            nbytes, TD_OPS_PER_VALUE * units * d))
    return rows


def packed_matrices(packed) -> int:
    """Packed weight matrices of a model (a stacked weight counts once per
    layer): one ``target_decode`` launch each per C-1 target pass, one
    ``mx_view`` launch each per C-2 draft or target pass."""
    return sum(_n_layers(w) for _, w in _packed_weights(packed))


def codec_launches() -> dict:
    from repro_torch.kernels import kv_topk as KT, mx_decode as MXD
    from repro_torch.kernels import unary_decode as UD
    return {"mx_decode": MXD.mx_decode.launches,
            "mx_view": MXD.mx_view.launches,
            "kv_topk": KT.kv_topk.launches,
            "kv_encode": KT.kv_encode.launches,
            "kv_view": UD.kv_view.launches,
            "unary_decode": UD.unary_decode.launches,
            "target_decode": UD.target_decode.launches}


def reset_launches() -> None:
    from repro_torch.kernels import draft_matmul as DM, kv_topk as KT
    from repro_torch.kernels import mx_decode as MXD
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import unary_decode as UD
    for fn in (DM.draft_matmul, PA.paged_gqa, PA.paged_gqa_packed,
               PA.paged_mla, MXD.mx_decode, MXD.mx_view, KT.kv_topk,
               KT.kv_encode, UD.kv_view, UD.unary_decode, UD.target_decode):
        fn.launches = 0


def check_launches(what: str, got: dict, expect: dict) -> None:
    say(f"[{what}] codec launches {got}; expected {expect}: {got == expect}")
    if got != expect:
        fail(f"{what}: codec kernel launches {got} != expected {expect}")


# ---------------------------------------------------------------------------
# Phases 10 and 11: Cassandra-2 (MX)
# ---------------------------------------------------------------------------

def exact_share(plain, packed, cass) -> tuple:
    """(weight values the C-2 target view returns bit for bit, all packed
    weight values): MX is exact only within a group's 2^8 exponent range."""
    import torch
    from repro_torch.core.format import target_weight
    from repro_torch.kernels.draft_matmul import packed_shape
    same = total = 0

    def walk(p, q):
        nonlocal same, total
        if isinstance(q, dict) and "spec" in q and "verif" in q:
            ws = p if p.ndim == 3 else p[None]
            for r in range(ws.shape[0]):
                one = (lambda t: t if p.ndim == 2 else t[r])
                tw = target_weight({k: one(v) for k, v in q["spec"].items()},
                                   {k: one(v) for k, v in q["verif"].items()},
                                   cass, packed_shape(q))
                same += int((tw.view(torch.int16)
                             == ws[r].view(torch.int16)).sum())
                total += tw.numel()
        elif isinstance(q, dict):
            for k in q:
                walk(p[k], q[k])
        elif isinstance(q, list):
            for a, b in zip(p, q):
                walk(a, b)

    walk(plain, packed)
    return same, total


def c2_views_bitwise(packed, cass) -> float:
    """``mx_view`` on every packed C-2 weight matrix of the model (every
    layer of every stacked weight): the draft view (bf16, and f32 as the
    draft product reads it) and the target view bit for bit against the
    plain chains ``format.draft_weight_plain`` / ``target_weight_plain``.
    Returns the largest absolute difference seen (0.0 when every value's
    bits agree)."""
    import torch
    from repro_torch.core import format as fmt
    from repro_torch.kernels import draft_matmul as DM
    t0 = time.perf_counter()
    n = 0
    for path, w in _packed_weights(packed):
        shape = DM.packed_shape(w)
        for r in range(_n_layers(w)):
            spec, verif = _layer_sv(w, r)
            plain_d = fmt.draft_weight_plain(spec, cass, shape)
            for view, got, want, wide in (
                    ("draft", fmt.draft_weight(spec, cass, shape), plain_d,
                     torch.int16),
                    ("draft f32", fmt.draft_weight_f32(spec, cass, shape),
                     plain_d.float(), torch.int32),
                    ("target", fmt.target_weight(spec, verif, cass, shape),
                     fmt.target_weight_plain(spec, verif, cass, shape),
                     torch.int16)):
                if got.shape != want.shape or not torch.equal(
                        got.contiguous().view(wide),
                        want.contiguous().view(wide)):
                    fail(f"c2: mx_view's {view} view of {path} layer {r} "
                         f"differs from the plain chain (max abs diff "
                         f"{_max_err(got.float(), want.float())})")
            n += 1
            del plain_d
    torch.cuda.synchronize()
    say(f"[c2] mx_view: the draft (bf16 and f32) and target views of all "
        f"{n} packed weight matrices bit for bit against the plain chain "
        f"({time.perf_counter() - t0:.1f} s)")
    return 0.0


def c2_view_shapes(weights: dict, cass, gen, m_t: int, m_d: int) -> dict:
    """``mx_view`` per shape on the C-2 model's own packed weights: the
    target view and the f32 draft view, each launch on a cold weight (a
    rotation over the model's layers, cloned until it holds COLD_BYTES),
    on the card's clock (graph replay) and eager; the bound (the packed
    leaves the view reads, read once, and the view written once, at 3.35
    TB/s); the plain chain's time; and the product that follows (the
    verify pass's bf16 x (m_t, n_in) @ view in cuBLAS, the draft pass's
    f32 x (m_d, n_in) @ view). Per-pass sums as ``target_shapes``."""
    import torch
    from repro_torch.core import format as fmt
    from repro_torch.core.format import tree_nbytes
    from repro_torch.kernels import draft_matmul as DM

    rows = []
    agg = {v: {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "product_ms": 0.0, "bytes": 0, "launches": 0}
           for v in ("target", "draft")}
    for name, (w, per_pass) in weights.items():
        shape = DM.packed_shape(w)
        n_in, n_out = shape
        layers = [_layer_sv(w, r) for r in range(_n_layers(w))]
        held = tree_nbytes(layers[0])
        copies = max(1, math.ceil(COLD_BYTES / (held * len(layers))))
        rot = layers + [tuple({k: v.clone() for k, v in t.items()}
                              for t in sv)
                        for _ in range(copies - 1) for sv in layers]
        for view in ("target", "draft"):
            if view == "target":
                one = lambda sv: fmt.target_weight(*sv, cass, shape)
                plain = lambda: fmt.target_weight_plain(*layers[0], cass,
                                                        shape)
                read = sum(tree_nbytes(sv) for sv in layers) / len(layers)
                x = torch.randn((m_t, n_in), generator=gen,
                                device="cuda").to(torch.bfloat16)
                out_b = 2
            else:
                one = lambda sv: fmt.draft_weight_f32(sv[0], cass, shape)
                plain = lambda: fmt.draft_weight_plain(
                    layers[0][0], cass, shape).float()
                read = sum(tree_nbytes(sv[0]) for sv in layers) / len(layers)
                x = torch.randn((m_d, n_in), generator=gen, device="cuda")
                out_b = 4

            def run_kernel():
                for sv in rot:
                    one(sv)
            reps = max(1, 32 // len(rot))
            k_ms = graph_ms(run_kernel, reps) / len(rot)
            k_eager = cuda_ms(run_kernel, reps) / len(rot)
            p_ms = cuda_ms(plain, 1)
            dense = [one(sv) for sv in rot[:8]]

            def run_product():
                for d in dense:
                    torch.matmul(x, d)
            c_ms = graph_ms(run_product, max(1, 32 // len(dense))) / len(
                dense)
            del dense
            nbytes = read + n_in * n_out * out_b
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append((name, view, n_in, n_out, per_pass, k_ms, k_eager,
                         b_ms, p_ms, c_ms))
            a = agg[view]
            for key, v in (("ms", k_ms), ("eager_ms", k_eager),
                           ("plain_ms", p_ms), ("bound_ms", b_ms),
                           ("product_ms", c_ms)):
                a[key] += per_pass * v
            a["bytes"] += per_pass * nbytes
            a["launches"] += per_pass
        del rot
        torch.cuda.empty_cache()
    say(f"[c2] mx_view, (in,out) per shape; us per launch, each on a cold "
        f"weight; kernel on the card's clock (graph replay), eager in "
        f"parentheses; bound: the packed leaves read and the view written "
        f"once at 3.35 TB/s; product: the verify pass's bf16 product "
        f"(M={m_t}, cuBLAS) after the target view, the draft pass's f32 "
        f"product (M={m_d}) after the f32 draft view:")
    for (name, view, n_in, n_out, per_pass, k_ms, k_eg, b_ms, p_ms,
         c_ms) in rows:
        say(f"[c2]   {name:12s} {view:6s} ({n_in},{n_out}) x{per_pass}/pass:"
            f" kernel {k_ms * 1e3:.1f} ({k_eg * 1e3:.1f})  bound "
            f"{b_ms * 1e3:.1f}  kernel/bound {k_ms / b_ms:.2f}  plain "
            f"{p_ms * 1e3:.1f}  product {c_ms * 1e3:.1f}")
    for view, a in agg.items():
        say(f"[c2] one {view} pass's views ({a['launches']} launches): "
            f"kernel {a['ms']:.3f} ms (eager {a['eager_ms']:.3f}), bound "
            f"{a['bound_ms']:.3f} ms ({a['bytes'] / 1e9:.3f} GB), plain "
            f"{a['plain_ms']:.1f} ms; the products after them "
            f"{a['product_ms']:.3f} ms")
    agg["rows"] = rows
    return agg


def c2_main_phase(cfg, args, prompt) -> dict:
    """Cassandra-2 through ``Engine.generate`` at full width: spec tokens
    equal AR steps of the C-2 target view at the verify width, bit for bit
    on every position; mx_decode and kv_topk launch counts as the passes
    imply."""
    import dataclasses

    import torch
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params, params_nbytes
    from repro_torch.launch.serve import format_line
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import Engine, EngineConfig, _run_drafts

    cass = CassandraConfig(variant=2, gamma=3)
    b, s, n, gamma = args.requests, args.prompt_len, args.max_new, cass.gamma
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    plain = init_params(cfg, gen, device="cuda")
    packed = format_params(plain, cass)
    torch.cuda.synchronize()
    say(f"[c2] {cfg.name} {cfg.n_layers} layers, Cassandra-2 (mx_group "
        f"{cass.mx_group}, draft bits {cass.mx_draft_bits}, KV group 16): "
        f"init + format_params {time.perf_counter() - t0:.1f} s")
    say(format_line(params_nbytes(packed)).replace("[format]", "[c2]"))
    same, total = exact_share(plain, packed, cass)
    say(f"[c2] the target view returns {same} of {total} weight values bit "
        f"for bit ({same / total:.4%})")
    del plain
    torch.cuda.empty_cache()
    views_err = c2_views_bitwise(packed, cass)
    views = c2_view_shapes(_weights_by_shape(packed, cfg), cass,
                           torch.Generator(device="cuda").manual_seed(
                               args.seed + 6), b * (gamma + 1), b)
    codec = codec_mx_phase(packed, cfg, cass, prompt)

    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=gamma),
                 device="cuda")
    rt_t = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(cfg, cass, b, s + n + gamma + 1, packed=True,
                          device="cuda")
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt_t, packed, {"tokens": prompt}, cache)
        lg = lg[:, -1]
        wide, logits = ar_steps(rt_t, packed, cache, lg, n, gamma + 1)
        if not torch.isfinite(logits).all():
            fail("c2: target logits are not finite")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        M.forward_decode(rt_t, packed, wide[:, :gamma + 1], cache)
        torch.cuda.synchronize()
        verify_ms = (time.perf_counter() - t0) * 1e3
        verify_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _run_drafts(eng.rt, packed, cache,
                    torch.argmax(lg, -1).to(torch.int32)[:, None], eng.ecfg)
        torch.cuda.synchronize()
        drafts_ms = (time.perf_counter() - t0) * 1e3
        drafts_peak = torch.cuda.max_memory_allocated()
    say(f"[c2] one verify pass (target view, width {gamma + 1}, "
        f"{cfg.n_layers} layers): {verify_ms:.1f} ms; draft side of one "
        f"cycle ({gamma} passes): {drafts_ms:.1f} ms; max_memory_allocated "
        f"{verify_peak / 2**30:.2f} / {drafts_peak / 2**30:.2f} GiB over "
        f"{resident / 2**30:.2f} GiB resident")
    wide = wide.cpu().numpy()
    del cache, lg, logits

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, st = eng.generate({"tokens": prompt}, max_new=n, speculative=True)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    launches = codec_launches()
    peak = torch.cuda.max_memory_allocated()
    sp = sp.cpu().numpy()
    equal = int((sp[:, :n] == wide).sum())
    say(f"[c2] lossless: spec == AR of the C-2 target view at the verify "
        f"width {gamma + 1} on {equal} of {b * n} positions")
    if equal != b * n:
        fail(f"c2: spec tokens differ from AR at the verify width on "
             f"{b * n - equal} positions")
    # one mx_view per packed matrix per pass (its target view in the
    # prefill and each verify pass, its f32 draft view in each draft
    # pass); the KV target view per layer per verify pass (K and V) and
    # the cache's draft view once per cycle; the KV encode per commit
    cyc, mats, layers = st["cycles"], packed_matrices(packed), cfg.n_layers
    check_launches("c2", launches, {
        "mx_decode": 0, "mx_view": mats * (1 + cyc) + 2 * layers * cyc
        + gamma * cyc * mats + 2 * cyc,
        "kv_topk": 2 * (1 + cyc), "kv_encode": 0, "kv_view": 0,
        "unary_decode": 0, "target_decode": 0})
    say(f"[c2] spec: cycles {cyc}, acceptance {st['acceptance']:.3f}, "
        f"tokens/cycle {st['tokens_per_cycle']:.3f}, {b * n / sp_s:.2f} tok/s "
        f"({sp_s:.1f} s); max_memory_allocated {peak / 2**30:.2f} GiB")
    return {"launches": launches, "codec": codec, "views": views,
            "views_err": views_err}


def c2_depth_phase(args, gen) -> None:
    """Cassandra-2 through the paged Scheduler at 2 layers (full width),
    attention kernel off: every request its tokens; overlap on == off and
    fused == alternating bit for bit; launch counts as the passes imply;
    the attention kernel refuses C-2 with the reference's limitation."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    cass = CassandraConfig(variant=2, gamma=3)
    n, gamma = args.max_new, cass.gamma
    packed = format_params(init_params(cfg, gen, device="cuda"), cass)
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=gen, device="cuda").to(torch.int32)
    runs = {}
    for name, kw in (("fused", {}), ("overlap off", {"overlap": False}),
                     ("alternating", {"fused": False})):
        reset_launches()
        sched, tokens, _, wall = serve_paged(cfg, packed, cass, prompt, n,
                                             **kw)
        runs[name] = tokens
        say(f"[c2-sched] {name}: {tokens.shape[0]} x {n} tokens in "
            f"{wall:.1f} s")
        if name == "fused":
            got = codec_launches()
            st = sched.summary()
            targets = st["cycles"]
            unified = st["cycles"] - st["prefill_cycles"] + st["mixed_cycles"]
            mats = packed_matrices(packed)
            check_launches("c2-sched", got, {
                "mx_decode": 0, "mx_view": targets * (mats + 2 * cfg.n_layers)
                + gamma * unified * mats + 2 * unified,
                "kv_topk": 2 * targets, "kv_encode": 0, "kv_view": 0,
                "unary_decode": 0, "target_decode": 0})
    for other in ("overlap off", "alternating"):
        same = np.array_equal(runs[other], runs["fused"])
        say(f"[c2-sched] {other} == fused with overlap, bit for bit: {same}")
        if not same:
            fail(f"c2-sched: tokens with {other} differ")
    try:
        serve_paged(cfg, packed, cass, prompt, n, attn_kernel="on")
    except ValueError as e:
        if "exp_words" not in str(e):
            raise
        say(f"[c2-sched] attn_kernel='on' refused: {e}")
    else:
        fail("c2-sched: attn_kernel='on' with Cassandra-2 was not refused")


# ---------------------------------------------------------------------------
# Phases 11-13: DeepSeek-V3 MLA (its three dense layers) under Cassandra-1
# ---------------------------------------------------------------------------

def mla_setup(args) -> dict:
    """DeepSeek-V3 at full width cut to its 3 dense layers (no routed
    expert), random weights from ``--seed`` on a generator of its own,
    packed in Cassandra-1; the prompts from the same generator."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params, params_nbytes
    from repro_torch.launch.serve import format_line
    from repro_torch.models.model import init_params

    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=full.first_dense_layers)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    plain = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = format_params(plain, cass)
    torch.cuda.synchronize()
    nb = params_nbytes(packed)
    n_par = sum(t.numel() for t in _leaves(plain))
    say(f"[mla] {cfg.name} cut to its {cfg.n_layers} dense layers (d "
        f"{cfg.d_model}, {cfg.n_heads} heads, q_lora {cfg.q_lora_rank}, "
        f"kv_lora {cfg.kv_lora_rank}, rope {cfg.qk_rope_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}): {n_par / 1e9:.3f}e9 "
        f"parameters; init {t_init:.1f} s, format_params "
        f"{time.perf_counter() - t0:.1f} s")
    say(format_line(nb).replace("[format]", "[mla]"))
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=gen, device="cuda").to(torch.int32)
    return {"cfg": cfg, "cass": cass, "plain": plain, "packed": packed,
            "prompt": prompt, "gen": gen}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _mla_bound_ms(lengths, h, t, lat, rope) -> dict:
    """The bounds of one ``paged_mla`` call: each row's ``length`` latent
    rows (c and kr, bf16) read once, q_eff and q_rope (f32) read, (acc, m,
    l) written; 2(L+R) + 2L flops per head, query and token. ``ms``: the
    kernel's arithmetic, the flops twice (the hi and lo TF32 products) at
    the dense TF32 tensor-core peak, against the bytes at 3.35 TB/s;
    ``f32_ms``: the same flops once at the f32 peak of the CUDA cores (the
    first kernel's arithmetic)."""
    tokens = sum(int(x) for x in lengths)
    b = len(lengths)
    nbytes = (tokens * (lat + rope) * 2 + b * t * h * (lat + rope) * 4
              + b * h * t * (lat + 2) * 4)
    ops = tokens * h * t * (2 * (lat + rope) + 2 * lat)
    tb = nbytes / HBM_BYTES_PER_S
    tt, tf = 2 * ops / TF32_OPS_PER_S, ops / CORE_OPS_PER_S
    return {"ms": max(tb, tt) * 1e3,
            "by": "bytes" if tb >= tt else "operations",
            "f32_ms": max(tb, tf) * 1e3, "bytes": nbytes, "ops": ops}


def _mla_library_ms(q_eff, q_rope, c_pool, kr_pool, table, lengths, scale,
                    reps: int) -> tuple:
    """One ``scaled_dot_product_attention`` over the rows' gathered latents:
    queries [q_eff | q_rope], keys [c | kr] and values c broadcast over the
    heads, the kernel's scale, a length mask. A yardstick only (it also
    normalises). Returns (graph-replay ms, eager ms)."""
    import torch
    from repro_torch.serving import kvcache as KC
    b, t, h, lat = q_eff.shape
    c = KC.gather_block_leaf(c_pool, table).float()
    kr = KC.gather_block_leaf(kr_pool, table).float()
    q = torch.cat([q_eff, q_rope], -1).permute(0, 2, 1, 3).contiguous()
    k = torch.cat([c, kr], -1)[:, None].expand(b, h, -1, -1)
    v = c[:, None].expand(b, h, -1, -1)
    mask = (torch.arange(c.shape[1], device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    run = lambda: f(q, k, v, attn_mask=mask, scale=scale)
    return graph_ms(run, reps), cuda_ms(run, reps)


def _mla_layer0_latents(m, prompt):
    """A prefill's layer-0 latents c (B,S,512) and kr (B,S,64), bf16: the
    vectors the KV encoder packs."""
    import torch
    from repro_torch.models import attention as A, layers as L, model as M
    from repro_torch.models.layers import Runtime
    rt = Runtime(cfg=m["cfg"], cass=m["cass"], view="target")
    p0 = M._index(m["packed"]["dec"][0]["e0"], 0)
    with torch.inference_mode():
        x = L.norm(rt, p0["norm1"], L.embed(m["packed"]["embed"], prompt))
        return A.mla_latent(rt, p0["attn"], x, torch.arange(
            prompt.shape[1], device=prompt.device))


def mla_kernel_phase(m, n_new: int) -> dict:
    """Phase 11: ``paged_mla`` against its plain version on the model's own
    pools after a chunked prefill (T = 1, 4, 32; NaN in every pool row no
    valid position reads) and on synthetic 4 x 4096-token pools; kv_topk,
    kv_encode, kv_view and unary_decode on the prefill's c and kr, bit for
    bit."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import unary_decode as UD
    from repro_torch.models.attention import _mla_scale, _suffix_valid
    from repro_torch.serving import kvcache as KC

    cfg, cass, gen = m["cfg"], m["cass"], m["gen"]
    h, lat, rope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    scale = _mla_scale(cfg)
    t0 = time.perf_counter()
    cache, _ = paged_prefill(m["packed"], cfg, cass, m["prompt"], n_new)
    torch.cuda.synchronize()
    say(f"[mla-kernels] chunked prefill of {tuple(m['prompt'].shape)} into "
        f"a packed paged cache (paged_mla on): "
        f"{time.perf_counter() - t0:.1f} s")
    book = (cache["book_exp_of_rank"], cache["book_rank_of_exp"])
    e0 = cache["dec"][0]["e0"]
    pools = tuple(KC.read_store(cass, {z: {k: v[0] for k, v in e0[nm][
        z].items()} for z in ("spec", "verif")}, d, "target", book)
        .contiguous() for nm, d in (("c", lat), ("kr", rope)))
    nb = pools[0].shape[0]
    table = cache["block_table"].clone()
    table[2, 1] = nb + 3                 # read as the trash block
    table[:, -1] = -1                    # past every row's length
    s = m["prompt"].shape[1]
    lengths = torch.tensor([s, s, s - 51, 0], dtype=torch.int32,
                           device="cuda")
    # NaN in every pool row no valid position of this walk reads
    live = torch.zeros(pools[0].shape[:2], dtype=torch.bool, device="cuda")
    for row in range(len(lengths)):
        for j in range(table.shape[1]):
            k = min(BLOCK, int(lengths[row]) - j * BLOCK)
            blk = int(table[row, j])
            if k > 0:
                live[blk if 0 <= blk < nb else 0, :k] = True
    nan_pools = tuple(torch.where(live[..., None], p, float("nan"))
                      for p in pools)
    del cache
    rows, ctx = 4, 4096
    mbs = ctx // BLOCK
    nbs = rows * mbs + 1
    synth = tuple((torch.randn((nbs, BLOCK, d), generator=gen,
                               device="cuda")).to(torch.bfloat16)
                  for d in (lat, rope))
    stable = torch.full((rows, mbs + 1), nbs + 1, dtype=torch.int32,
                        device="cuda")
    stable[:, :mbs] = (1 + torch.arange(rows * mbs, device="cuda")).reshape(
        rows, mbs)
    cases = ({"name": f"model 4x{s}", "pools": nan_pools, "clean": pools,
              "table": table, "lengths": lengths},
             {"name": f"synthetic {rows}x{ctx}", "pools": synth,
              "clean": synth, "table": stable,
              "lengths": torch.full((rows,), ctx, dtype=torch.int32,
                                    device="cuda")})
    out = {"max_abs_err": 0.0, "rows": []}
    for case in cases:
        tbl, lens = case["table"], case["lengths"]
        b = len(lens)
        for t in (1, 4, 32):
            q_eff = torch.randn((b, t, h, lat), generator=gen, device="cuda")
            q_rope = torch.randn((b, t, h, rope), generator=gen,
                                 device="cuda")
            run = (lambda: PA.paged_mla(q_eff, q_rope, *case["pools"], tbl,
                                        lens, scale=scale))
            plain = (lambda: PA.paged_mla_plain(q_eff, q_rope,
                                                *case["pools"], tbl, lens,
                                                scale=scale))
            got, want = run(), plain()
            suf_c, suf_kr = (torch.randn((b, t, d), generator=gen,
                                         device="cuda").to(torch.bfloat16)
                             for d in (lat, rope))
            suf_valid = _suffix_valid(b, t, 0, 0, q_eff.device)
            merged = PA.merge_mla_suffix(*got, q_eff, q_rope, suf_c, suf_kr,
                                         suf_valid, scale=scale)
            merged_p = PA.merge_mla_suffix(*want, q_eff, q_rope, suf_c,
                                           suf_kr, suf_valid, scale=scale)
            torch.cuda.synchronize()
            # acc is a sum of up to `length` unnormalised terms p·c over
            # 512 latent dims, so its rounding error grows with l (up to
            # 4e-5 at T=1 on the model's pools): it is held divided by
            # the plain version's l, the context the layer uses
            lz = want[2][..., None].clamp_min(1e-30)
            err = max((a - b_).abs().nan_to_num(float("inf")).max().item()
                      for a, b_ in zip(got, want))
            for a, b_ in ((got[0] / lz, want[0] / lz), (got[1], want[1]),
                          (got[2], want[2]), (merged, merged_p)):
                if not torch.isfinite(a).all() or not torch.allclose(
                        a, b_, rtol=PAGED_RTOL, atol=PAGED_ATOL):
                    fail(f"mla-kernels: paged_mla {case['name']} T={t} "
                         f"differs from its plain version (max abs err "
                         f"{(a - b_).abs().nan_to_num(float('inf')).max()}"
                         f"; raw (acc, m, l) {err:.3g})")
            if not (got[0][lens == 0] == 0).all():
                fail("mla-kernels: an empty row's state is not initial")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            again = run()
            if not all(torch.equal(a.view(torch.int32), a2.view(torch.int32))
                       for a, a2 in zip(got, again)):
                fail(f"mla-kernels: paged_mla {case['name']} T={t} differs "
                     f"between two launches")
            del again
            k_ms = graph_ms(run, 20)
            k_eager = cuda_ms(run, 20)
            p_ms = cuda_ms(plain, 1)
            lib_ms, lib_eager = _mla_library_ms(
                q_eff, q_rope, *case["clean"], tbl, lens, scale, 10)
            bd = _mla_bound_ms(lens.tolist(), h, t, lat, rope)
            bps, splits = PA.mla_split_plan(b, h, t, tbl.shape[1])
            out["rows"].append({"kernel": "paged_mla", "case": case["name"],
                                "T": t, "ms": k_ms, "eager_ms": k_eager,
                                "plain_ms": p_ms, "bound_ms": bd["ms"],
                                "bound_by": bd["by"],
                                "f32_bound_ms": bd["f32_ms"],
                                "library_ms": lib_ms,
                                "library_eager_ms": lib_eager, "err": err,
                                "bytes": bd["bytes"], "ops": bd["ops"],
                                "splits": splits})
            say(f"[mla-kernels] paged_mla {case['name']:16s} T={t:2d} "
                f"({splits} split{'s' if splits > 1 else ''}): kernel "
                f"{k_ms * 1e3:.1f} us (eager {k_eager * 1e3:.1f})  bound "
                f"{bd['ms'] * 1e3:.2f} us ({bd['by']}: "
                f"{bd['bytes'] / 1e6:.2f} MB / {bd['ops'] / 1e9:.3f} GFLOP, "
                f"x2 at the TF32 peak; f32 CUDA cores "
                f"{bd['f32_ms'] * 1e3:.2f} us)  plain {p_ms * 1e3:.1f} us  "
                f"SDPA {lib_ms * 1e3:.1f} us (eager {lib_eager * 1e3:.1f}); "
                f"max abs err {err:.3g}")
    del cases, synth, pools, nan_pools
    torch.cuda.empty_cache()
    # the KV encode (selection alone and whole), its views and the
    # exponent decode on the prefill's own latents (layer 0): c at
    # d = 512, kr at d = 64
    c, kr = _mla_layer0_latents(m, m["prompt"])
    dbook = KC.default_kv_codebook("cuda")
    codec = []
    for nm, x, d in (("c", c, lat), ("kr", kr, rope)):
        x = x.reshape(-1, d).contiguous()
        r, kk = x.shape[0], cass.kv_keep(d)
        codec += kv_codec_rows(cass, x, d, f"prefill {nm} (layer 0)", dbook)
        words = KC.encode_store(cass, x, d, dbook)["spec"]["exp_words"]
        words = words.reshape(-1, words.shape[-1]).contiguous()
        w = words.shape[1]
        codec.append(codec_row(
            "unary_decode", f"prefill {nm} exponent regions {r}x{w}->{kk}",
            lambda words=words, kk=kk: UD.unary_decode(words, kk),
            lambda words=words, kk=kk: UD.unary_decode_plain(words, kk),
            4 * r * (w + kk), 32 * r * w))
    out["codec"] = codec
    return out


def _kv_b_pieces(packed) -> int:
    """``ROW_CHUNK`` pieces of one layer's kv_b (its draft view is decoded
    with ``resolve_weight`` on every draft pass, one exponent decode each)."""
    from repro_torch.core.format import ROW_CHUNK
    from repro_torch.kernels.draft_matmul import packed_shape
    w = packed["dec"][0]["e0"]["attn"]["kv_b"]["w"]
    return -(-packed_shape(w)[1] // ROW_CHUNK)


def mla_engine_phase(m, args) -> dict:
    """Phase 12: ``Engine.generate`` on the MLA model: spec tokens equal AR
    steps at the verify width on every position; launch counts as the
    passes imply."""
    import dataclasses

    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import Engine, EngineConfig, top2_margin

    cfg, cass, packed, prompt = m["cfg"], m["cass"], m["packed"], m["prompt"]
    b, s, n, gamma = args.requests, args.prompt_len, args.max_new, cass.gamma
    layers = cfg.n_layers
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=gamma),
                 device="cuda")
    rt_t = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(cfg, cass, b, s + n + gamma + 1, packed=True,
                          device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt_t, packed, {"tokens": prompt}, cache)
        lg = lg[:, -1]
        wide, logits = ar_steps(rt_t, packed, cache, lg, n, gamma + 1)
        w1, l1 = ar_steps(rt_t, packed, cache, lg, gamma + 2, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        l_v, _ = M.forward_decode(rt_t, packed, wide[:, :gamma + 1], cache)
        torch.cuda.synchronize()
        verify_ms = (time.perf_counter() - t1) * 1e3
        l_v1, _ = M.forward_decode(rt_t, packed, w1[:, :gamma + 1], cache)
    if not torch.isfinite(logits).all() or not torch.isfinite(l_v).all():
        fail("mla-engine: target logits are not finite")
    gap = (logits[:, 1:gamma + 2] - l_v).abs().max().item()
    gap1 = (l1[:, 1:] - l_v1).abs().max().item()
    lrms = l_v.square().mean().sqrt().item()
    say(f"[mla-engine] reference runs (AR steps at the verify width, {n} "
        f"tokens; at width 1, {gamma + 2}) {time.perf_counter() - t0:.1f} s; "
        f"AR at width {gamma + 1} vs the verify pass: max abs diff {gap:.3g}; "
        f"at width 1: {gap1:.3g} (logit rms {lrms:.3g}); one verify pass "
        f"(target view, width {gamma + 1}, {layers} layers) {verify_ms:.1f} ms")
    ref = (wide.cpu().numpy(), top2_margin(logits).cpu().numpy())
    lg_cpu = lg.to(torch.float32).cpu()
    del cache, lg, logits, l_v, l1, l_v1

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, st = eng.generate({"tokens": prompt}, max_new=n, speculative=True)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    launches = {"draft_matmul": DM.draft_matmul.launches,
                "paged_mla": PA.paged_mla.launches, **codec_launches()}
    peak = torch.cuda.max_memory_allocated()
    sp = sp.cpu().numpy()
    if sp.shape != (b, n + gamma + 1) or not (
            (sp[:, :n] >= 0) & (sp[:, :n] < cfg.vocab_size)).all():
        fail(f"mla-engine: spec tokens malformed: {sp}")
    equal = int((sp[:, :n] == ref[0]).sum())
    say(f"[mla-engine] lossless: spec == AR at the verify width {gamma + 1} "
        f"on {equal} of {b * n} positions")
    if equal != b * n:
        fail(f"mla-engine: spec tokens differ from AR at the verify width on "
             f"{b * n - equal} positions")
    cyc, mats = st["cycles"], packed_matrices(packed)
    drafts = st["draft_passes"]
    expect = {"draft_matmul": drafts * (7 * layers + 1), "paged_mla": 0,
              "mx_decode": 0, "mx_view": 0, "kv_topk": 0,
              "kv_encode": 2 * (1 + cyc),
              # the KV target view per layer per verify pass and the draft
              # view once per cycle (kv_view); kv_b's draft view per layer
              # per draft pass (unary_decode, in ROW_CHUNK pieces); every
              # weight's target view once per target pass
              "kv_view": 2 * layers * cyc + 2 * cyc,
              "unary_decode": drafts * layers * _kv_b_pieces(packed),
              "target_decode": mats * (1 + cyc)}
    check_launches("mla-engine", launches, expect)
    say(f"[mla-engine] spec: cycles {cyc}, acceptance "
        f"{st['acceptance']:.3f}, tokens/cycle {st['tokens_per_cycle']:.3f}, "
        f"{b * n / sp_s:.2f} tok/s ({sp_s:.1f} s); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    return {"lg": lg_cpu, "wide": ref, "gap1": gap1, "launches": launches}


def mla_sched_phase(m, args, eng: dict) -> dict:
    """Phase 13: the paged ``Scheduler`` on the MLA model with
    ``attn_kernel="on"``: launches as the passes imply, first-token logits
    against the Engine's prefill, overlap on == off and fused ==
    alternating bit for bit, kernel on == off under the near-tie rule, and
    the bf16 autoregressive baseline with the kernel on and off."""
    import numpy as np
    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import paged_attention as PA

    cfg, cass, packed, prompt = m["cfg"], m["cass"], m["packed"], m["prompt"]
    n, layers, gamma = args.max_new, cfg.n_layers, cass.gamma
    b = prompt.shape[0]
    ref_tok, margins = eng["wide"]
    lg = eng["lg"].numpy()
    lrms = float(np.sqrt((lg.astype(np.float64) ** 2).mean()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sched, tokens, first, wall = serve_paged(cfg, packed, cass, prompt, n,
                                             attn_kernel="on")
    launches = {"draft_matmul": DM.draft_matmul.launches,
                "paged_mla": PA.paged_mla.launches,
                "paged_gqa": PA.paged_gqa.launches,
                "paged_gqa_packed": PA.paged_gqa_packed.launches,
                **codec_launches()}
    peak = torch.cuda.max_memory_allocated()
    st = sched.summary()
    del sched
    unified = st["cycles"] - st["prefill_cycles"] + st["mixed_cycles"]
    drafts, targets = gamma * unified, st["cycles"]
    expect = {"draft_matmul": drafts * (7 * layers + 1),
              "paged_mla": (targets + drafts) * layers,
              "paged_gqa": 0, "paged_gqa_packed": 0, "mx_decode": 0,
              "mx_view": 0, "kv_topk": 0, "kv_encode": 2 * targets,
              # per target pass the KV target view per layer (and every
              # weight's target view, target_decode); per draft pass the
              # KV draft view per layer (kv_view) and kv_b per layer
              # (unary_decode)
              "kv_view": (targets + drafts) * 2 * layers,
              "unary_decode": drafts * layers * _kv_b_pieces(packed),
              "target_decode": targets * packed_matrices(packed)}
    say(f"[mla-sched] launches {launches}; expected {expect}: "
        f"{launches == expect} (paged_mla: (target passes {targets} + draft "
        f"passes {drafts}) x {layers} layers)")
    if launches != expect:
        fail(f"mla-sched: launches {launches} != expected {expect}")
    gmax, grms = _logit_gap(first, lg)
    say(f"[mla-sched] first-token logits vs the Engine's prefill: max abs "
        f"diff {gmax:.4g}, rms {grms:.4g} (logit rms {lrms:.4g}; limit "
        f"{0.1 * lrms:.4g})")
    if not gmax < 0.1 * lrms:
        fail(f"mla-sched: first-token logits differ from the Engine's by "
             f"{gmax}")
    compared, cut = tau_check(tokens, ref_tok, margins, 2.0 * gmax, n,
                              what="mla-sched")
    walls = st["bucket_wall_ms"]
    uni, chunk = walls.get("unified", {}), walls.get("chunk", {})
    say(f"[mla-sched] {b} requests x {n} tokens: cycles {st['cycles']} "
        f"(unified {unified}), acceptance {st['acceptance']:.3f}, "
        f"{b * n / wall:.2f} tok/s ({wall:.1f} s); unified step "
        f"{uni.get('mean_ms', 0.0):.1f} ms (x{uni.get('calls', 0)}), wide "
        f"prefill {chunk.get('mean_ms', 0.0):.1f} ms "
        f"(x{chunk.get('calls', 0)}); TTFT p50 {st['ttft_cycles_p50']:.1f} "
        f"cycles; max_memory_allocated {peak / 2**30:.2f} GiB; tokens == "
        f"Engine (== AR at the verify width) on {compared} of {b * n} "
        f"positions under tau = 2 x the first-token gap = {2 * gmax:.3g}, "
        f"cut {cut}")
    runs = {"on": (tokens, first)}
    for name, params, c, spec, kw in (
            ("on, overlap off", packed, cass, True,
             {"attn_kernel": "on", "overlap": False}),
            ("on, alternating", packed, cass, True,
             {"attn_kernel": "on", "fused": False}),
            ("off", packed, cass, True, {}),
            ("bf16 AR, on", m["plain"], None, False, {"attn_kernel": "on"}),
            ("bf16 AR, off", m["plain"], None, False, {})):
        reset_launches()
        sched, tok, fst, w = serve_paged(cfg, params, c, prompt, n,
                                         speculative=spec, **kw)
        s2 = sched.summary()
        del sched
        passes = s2["cycles"] + (gamma * (s2["cycles"] - s2["prefill_cycles"]
                                          + s2["mixed_cycles"])
                                 if spec else 0)
        want = passes * layers if kw.get("attn_kernel") == "on" else 0
        got = PA.paged_mla.launches
        runs[name] = (tok, fst)
        say(f"[mla-sched] {name}: {b} x {n} tokens in {w:.1f} s; paged_mla "
            f"launches {got} (expected {want})")
        if got != want:
            fail(f"mla-sched: {name} launched paged_mla {got} times, "
                 f"expected {want}")
    for other in ("on, overlap off", "on, alternating"):
        same = np.array_equal(runs[other][0], tokens)
        say(f"[mla-sched] {other} == on, bit for bit: {same}")
        if not same:
            fail(f"mla-sched: tokens with {other} differ from the pipelined "
                 f"fused run")
    gaps = {k: _logit_gap(v[1], lg)[0] for k, v in runs.items()}
    onoff = _logit_gap(runs["on"][1], runs["off"][1])[0]
    tau = 2.0 * max(gaps["on"], gaps["off"], onoff)
    say(f"[mla-sched] first-token logits vs the Engine's prefill: max abs "
        f"diff {gaps}; on vs off {onoff:.4g}; tau = {tau:.4g}")
    for name in ("on", "off"):
        compared, cut = tau_check(runs[name][0], ref_tok, margins, tau, n,
                                  what=f"mla-sched {name}")
        say(f"[mla-sched] kernel {name} == AR at the verify width on "
            f"{compared} of {b * n} positions ({compared / (b * n):.1%}), "
            f"cut {cut}")
    same = int((runs["on"][0] == runs["off"][0]).sum())
    say(f"[mla-sched] kernel on == off at {same} of {b * n} positions")
    tau0 = 2.0 * max(gaps["bf16 AR, on"], gaps["bf16 AR, off"], eng["gap1"],
                     tau / 2)
    for name in ("bf16 AR, on", "bf16 AR, off"):
        compared, cut = tau_check(runs[name][0], ref_tok, margins, tau0, n,
                                  what=f"mla-sched {name}")
        say(f"[mla-sched] {name} == C-1 AR at the verify width on {compared}"
            f" of {b * n} positions ({compared / (b * n):.1%}) under tau = "
            f"{tau0:.4g}, cut {cut}")
    same = int((runs["bf16 AR, on"][0] == runs["bf16 AR, off"][0]).sum())
    say(f"[mla-sched] bf16 AR kernel on == off at {same} of {b * n} "
        f"positions")
    return {"launches": launches["paged_mla"]}


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
    # the target view of every weight, bit for bit and per shape (inputs
    # from a generator of their own: phase 6 draws its prompts from gen)
    td_err = target_all_bitwise(packed, cass, "kernel")
    target = target_shapes(_weights_by_shape(packed, cfg), cass,
                           torch.Generator(device="cuda").manual_seed(
                               args.seed + 4), "kernel",
                           args.requests * (cass.gamma + 1))
    # 5. small input against the CPU
    small_phase(args.seed)
    # 6. main path
    main = main_phase(packed, cfg, cass, gen, args)
    gen2 = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    # 4b. paged kernels against their plain versions
    paged = paged_phase(packed, cfg, cass, main["prompt"], args.max_new, gen2)
    # 4c. unary_decode and kv_topk against their plain versions (inputs
    # from a generator of their own: phase 8 draws from gen2 as before)
    codec = codec_c1_phase(packed, cfg, cass, main["prompt"],
                           torch.Generator(device="cuda").manual_seed(
                               args.seed + 2))
    # 7. the paged scheduler at full width
    sched = sched_phase(packed, cfg, cass, args, main, paged, agg, target)
    say(f"[sched] max_memory_allocated during the scheduler run "
        f"{sched['peak'] / 2**30:.2f} GiB")
    del packed
    gc.collect()                  # no C-1 tensor outlives its phases
    torch.cuda.empty_cache()
    # 8. the scheduler's bitwise gates at 2 layers
    depth_phase(args, gen2)
    # 9. Cassandra-2 through the Engine at full width (mx_decode checked
    # against its plain version there, on the C-2 model's own weights)
    c2 = c2_main_phase(cfg, args, main["prompt"])
    codec += c2["codec"]
    torch.cuda.empty_cache()
    # 10. Cassandra-2 through the paged scheduler at 2 layers
    c2_depth_phase(args, gen2)
    torch.cuda.empty_cache()
    # 11-13. DeepSeek-V3 MLA, its 3 dense layers at full width, C-1
    mla = mla_setup(args)
    # draft_matmul per shape on the MLA model's own weights (ragged N, deep
    # K), inputs from a generator of their own
    draft_shapes(_mla_weights_by_shape(mla["packed"], mla["cfg"]),
                 mla["cass"], torch.Generator(device="cuda").manual_seed(
                     args.seed + 3), "mla-kernels")
    td_err = max(td_err, target_all_bitwise(mla["packed"], mla["cass"],
                                            "mla-kernels"))
    target_shapes(_mla_target_by_shape(mla["packed"], mla["cfg"]),
                  mla["cass"], torch.Generator(device="cuda").manual_seed(
                      args.seed + 5), "mla-kernels",
                  args.requests * (mla["cass"].gamma + 1))
    mla_k = mla_kernel_phase(mla, args.max_new)
    codec += mla_k["codec"]
    mla_e = mla_engine_phase(mla, args)
    mla_s = mla_sched_phase(mla, args, mla_e)
    del mla
    gc.collect()
    torch.cuda.empty_cache()

    # 14. report
    say('kernels: ["draft_matmul", "paged_gqa", "paged_gqa_packed", '
        '"paged_mla", "mx_decode", "kv_topk", "unary_decode", '
        '"target_decode", "mx_view", "kv_encode", "kv_view"]')
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
    # paged_mla at its main-path shape: the MLA model's pools after the
    # prefill at T=1 (the draft passes: 3 of the 4 launches per cycle)
    row = next(r for r in mla_k["rows"] if r["case"].startswith("model")
               and r["T"] == 1)
    line["kernels"].append({
        "name": "paged_mla", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_mla.cu",
        "replaces": "src/repro/kernels/paged_attention.py:530",
        "launches": mla_s["launches"],
        "max_abs_err": mla_k["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]})
    # the codec kernels at their main-path shape: the w_gate target lanes
    # (mx_decode), a prefill's K (kv_topk), w_gate's kept exponent regions
    # (unary_decode); launches from the C-2 run (mx_decode, kv_topk) and
    # from phase 12's MLA run (unary_decode: kv_b's draft view). The C-2
    # path decodes through mx_view, so the standalone mx_decode's count
    # there is 0: only its codec rows launch it; the C-1 paths encode and
    # view their KV stores through kv_encode and kv_view
    for name, file, line_no, case, launches in (
            ("mx_decode", "mx_decode", 46, "w_gate target",
             c2["launches"]["mx_decode"]),
            ("kv_topk", "kv_topk", 43, "prefill K",
             c2["launches"]["kv_topk"]),
            ("unary_decode", "unary_decode", 51, "w_gate kept",
             mla_e["launches"]["unary_decode"]),
            # kv_encode replaces kv_topk with the reference's format_tensor
            # chain, kv_view unary_decode with its draft_tensor /
            # target_tensor chain; no PyTorch call computes either
            ("kv_encode", "kv_topk", 43, "prefill K",
             main["codec"]["kv_encode"]),
            ("kv_view", "unary_decode", 51, "prefill K (layer 0) store "
             "target", main["codec"]["kv_view"])):
        rows = [r for r in codec if r["kernel"] == name]
        row = next(r for r in rows if r["case"].startswith(case))
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{file}.cu",
            "replaces": f"src/repro/kernels/{file}.py:{line_no}",
            "launches": launches,
            "max_abs_err": max(r["err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    # target_decode: one verify pass's 225 decodes (phase 4's per-shape
    # times x launches per pass), launches from phase 6's C-1 run; it
    # replaces the TPU kernel together with the reference's target_tensor
    # chain around it, and no PyTorch call computes the same function
    line["kernels"].append({
        "name": "target_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/unary_decode.cu",
        "replaces": "src/repro/kernels/unary_decode.py:51",
        "launches": main["codec"]["target_decode"],
        "max_abs_err": td_err,
        "ms": target["ms"], "plain_ms": target["plain_ms"],
        "bound_ms": target["bound_ms"], "bound_by": target["bound_by"],
        "library_ms": None})
    # mx_view: one C-2 verify pass's 225 target views (phase 9's per-shape
    # times x launches per pass), launches from phase 9's run; it replaces
    # the TPU mx_decode with the reference's draft_tensor / target_tensor
    # chain around it, and no PyTorch call computes the same function
    tv = c2["views"]["target"]
    line["kernels"].append({
        "name": "mx_view", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mx_decode.cu",
        "replaces": "src/repro/kernels/mx_decode.py:46",
        "launches": c2["launches"]["mx_view"],
        "max_abs_err": max([c2["views_err"]] + [
            r["err"] for r in codec if r["kernel"] == "mx_view"]),
        "ms": tv["ms"], "plain_ms": tv["plain_ms"],
        "bound_ms": tv["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
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
