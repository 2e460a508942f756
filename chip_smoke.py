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
14. prefix + swap — the prefix cache and preemption with host swap
              through the paged ``Scheduler`` (4 slots, block 16, chunk
              32, fused, overlap), 8 prompts of 128 tokens × 32 new, for
              DeepSeek-V3's dense layers (C-1, ``paged_mla``), Llama-3-8B
              at full width (C-1, the attention kernels on) and at 2
              layers (C-2, the attention kernel off): (b) two waves of 4
              sharing a 72-token header (4.5 blocks: a copy-on-write per
              hit), the second submitted once the first is idle, with the
              cache on and off: tokens bit for bit, hits, matched tokens
              and copies > 0, fewer encode and target-attention launches
              with the cache on; (a) on that run's pool, a block copy and
              a spill / restore round trip through pinned host buffers bit
              for bit (sources, other blocks and block 0 untouched), µs
              and GB/s; (c) the prompts without the header arriving a
              quarter cycle apart at priorities 0 and 1, on a 24-block
              pool (preemptions, blocks spilled and restored) and on an
              ample one: tokens bit for bit, every request its tokens;
15. sampling — phase 3's model again (Llama-3-8B, C-1, γ=3, ``--seed``)
              on phase 6's prompts: (d) Wanda calibration, a
              ``Calibrator`` over the prompts through ``forward_train``,
              every packed weight's path with a norm, layer 0's ``wk``
              formatted bit for bit on the card and the CPU, the
              calibrated model lossless as in phase 6 (≥ 90% under the
              near-tie rule), its acceptance beside phase 6's; (a)
              ``Engine.generate`` sampled at T = 1.0 twice from one seed,
              bit for bit, every row its tokens, launches by phase 6's
              rule, acceptance beside phase 6's; (e) that run's telemetry:
              counters equal to the stats, one ``CYCLE`` event per active
              row and cycle, tokens equal with telemetry off; (b) the Eq. 1
              distribution gate: 512 copies of prompt 0 through one
              speculative cycle at the largest T whose 8 likeliest tokens
              hold half the mass (chosen before any draw), the first
              position's frequencies in those 8 bins and the rest within 5
              standard errors of the target's p; (c) the sampled paged
              ``Scheduler`` (kernels on) twice from one seed at full width
              and overlap on == off at 2 layers, bit for bit, C-2 at 2
              layers and phase 11's DeepSeek-V3 repeatable, launches as
              the passes imply;
16. families — the dense GQA family and top-k MoE, each from a generator
              of its own, C-1 (γ=3), 4 × 128-token prompts × 32 new: (a)
              qwen3-4b at full width, all 36 layers (``qk_norm``, tied
              embeddings: 252 ``draft_matmul`` launches a draft pass, no
              lm_head kernel): ``draft_matmul`` and ``target_decode`` per
              shape as phase 4, every packed matrix's target view bit for
              bit, phase 6's Engine gates and launch rules, the paged
              ``Scheduler`` (kernels on) with phase 7's first-token gate,
              and at 2 layers overlap on == off and fused ==
              alternating bit for bit; (b) DBRX at full width, 2 layers
              (16 experts, top-4; experts and router unpacked): its shapes
              as (a), ``moe`` against ``moe_reference`` on the card,
              phase 6's Engine gates, the ``Scheduler`` with the first-
              token gate, overlap on == off and fused == alternating bit
              for bit, all at ``moe_capacity_factor = n_experts /
              n_experts_per_tok`` (0 drops), and one run at the default
              1.25 with its drops printed; (c) DeepSeek-V3 at full width,
              4 layers (3 dense, 1 routed: 256 experts, top-8, the shared
              expert), the shared expert's shapes, ``moe`` against
              ``moe_reference``, phase 6's Engine gates and the
              ``Scheduler`` with ``paged_mla`` and the first-token gate,
              at the no-overflow capacity;
17. ssm      — the Mamba-1 family and the Jamba hybrid, each from a
              generator of its own, C-1 (γ=3), 4 × 128-token prompts × 32
              new: (a) falcon-mamba-7b at full width, all 64 layers (257
              ``draft_matmul`` launches a draft pass: in_proj, x_proj,
              dt_proj and out_proj a layer, and lm_head; no attention or
              KV-codec launch): ``draft_matmul`` and ``target_decode`` per
              shape as phase 4, every packed matrix's target view bit for
              bit, phase 6's Engine gates exact (spec == AR at the verify
              width on every position, the AR logits the verify pass's
              bit for bit), the recurrence's device time a verify and a
              draft pass (CUDA events) and the state's bytes a row, the
              paged ``Scheduler`` with its first-token logits bit for bit
              against the Engine's wide step over the same 32-token chunks
              and its tokens against AR steps at the verify width from
              that chunked cache on every position, the prefix cache and
              swap refused; an f32 witness on the served weights: the
              chunked prefill within 1e-3 of the logit rms of the one-pass
              one in f32, and the served first-token gap at most 3 × the
              bf16 one-pass prefill's own distance from f32; at 2 layers
              overlap on == off, fused == alternating, the plain model's
              stable draft accepted on every position and its scratch
              draft equal to width-1 AR steps bit for bit;
              (b) Jamba at full width cut to one 8-layer period (7 Mamba
              mixers, 1 GQA layer, 4 dense and 4 MoE FFNs), the same gates
              with the attention kernels on, ``moe`` against
              ``moe_reference``, 0 drops at ``moe_capacity_factor =
              n_experts / n_experts_per_tok``;
18. encdec   — the encoder-decoder audio family and the vision
              frontend's backbone, each from a generator of its own, C-1
              (γ=3), 4 × 128-token prompts × 32 new with N(0, 1) frontend
              embeddings: (a) whisper-medium at full width, 24 encoder and
              24 decoder layers, 1500 frames a request (193 ``draft_matmul``
              launches a draft pass: self-attention's four, cross-
              attention's wq and wo, up and down a layer, and lm_head
              1024 -> 51865, an odd N; a prefill's 385 ``target_decode``:
              the encoder's and the cross K/V projections too); (b)
              phi-3-vision-4.2b at full width, 32 layers, head_dim 96 (the
              KV stores encode and view at d = 96), 256 patches prepended:
              ``draft_matmul`` and ``target_decode`` per shape as phase 4,
              every packed matrix's target view bit for bit, ``kv_topk``,
              ``kv_encode`` and ``kv_view`` at d = 96 on the prefill's K
              and V and on edge rows bit for bit (phase 4c), phase 6's
              Engine gates exact (spec == AR at the verify width on every
              position), launches as the passes imply, the packed target
              view's first-token logits within a tenth of the logit rms of
              the plain model's, the Scheduler (and, for whisper, the paged
              cache) refusing with the reference's text, whisper's cross
              K/V written once at the prefill and unchanged after the
              cycles; each model freed before the next;
19. train    — from generators of its own, no kernel of its own: (a)
              Llama-3-8B at full width, all 32 layers, int8 moments,
              ``remat="full"``, 4 ``train_step``s on 1 x 1024 tokens of the
              synthetic stream: losses and grad norms finite, step 0's fused
              chunked CE equal to the f32 CE of the full logits within
              1e-3 relative, the peak at most 70 GiB, each step split into
              forward + backward and the update (CUDA events); (b) at 2
              layers, accumulation over one microbatch repeated against
              one pass and the int8 update's cosine to the fp32 one, and at
              SMOKE one ``train_step`` on the card against the CPU; (c) the
              SMOKE Llama trained with the reference's recipe (300 steps),
              the loss down by > 0.3, params + moments saved and restored
              bit for bit, ``launch/train.run`` resuming after an injected
              failure to the uninterrupted run's parameters bit for bit,
              then packed in C-1 and served on the reference's eval
              prompts: phase 6's Engine gates exact, the paged Scheduler
              (kernels on) under phase 7's rule, acceptance greedy and at
              T = 1.0 beside phase 6's;
20. format   — the paper's format selection (``core/dse.py``, Eq. 2) over
              its grid, prune {0.3, 0.4, 0.5, 0.6} x truncation {0, ...,
              5}, exp_bits 3, from a generator of its own: (a) one
              Llama-3-8B layer's seven matrices at full width packed on
              the card at each of the 24 weight points: ``draft_matmul``'s
              decoded weight bit for bit and y within rtol 2e-2 / atol
              1e-3, ``target_decode`` bit for bit against the plain chain
              and the bf16 weights, wk's leaves against the CPU's packing,
              ``compression_summary`` falling strictly along both axes,
              and the layer's draft launches timed beside Eq. 2's byte
              ratio; (b) K and V of a 128-token prefill of that layer at
              each of the 24 KV points under the default book and under
              ``calibrate_kv_codebook``'s: ``kv_encode`` / ``kv_view``
              against the chains, the target view the input, the packed
              attention on a pool of those stores (decode bit for bit, T
              = 1 and 4 within rtol 1e-4 / atol 1e-5), edge rows under the
              calibrated book; (c) the Engine at 2 layers at the grid's
              corners (weights (0.3, 0) with KV (0.6, 5), and the
              reverse): spec == AR at the verify width on every position,
              launches as implied, the paged Scheduler at the first corner
              under phase 7's rules; (d) ``grid_search`` on phase 19c's
              trained SMOKE Llama as ``examples/acceptance_sweep.py`` runs
              it (s_w 10, s_kv 1, 2 eval prompts x 12 new): 48 probes,
              each spec == AR at the verify width, the ranked table; (e)
              Fig. 6's entropy and unary code length of its weights and
              K/V, card against CPU within 1e-5;
21. report  — ``kernels: [...]``, one JSON line per the kernels table,
              and the last line ``{"ok": true, "device": {...}}``.

Phases run in the order 1-6, 4b, 4c, 7-21 (4b and 4c read phase 6's
prompts); ``--phase 18``, 19 or 20 runs phases 1, 2 and that phase alone
(no report; 20 trains phase 19c's SMOKE Llama first).
Phases 6, 7, 9, 10, 12, 13, each run of 14, the first of each pair in 15
and the Engine runs of 16-19 set every kernel's launch count to 0 before
their run and check it after against what the passes imply (the C-1 runs
also count ``kv_encode``, one per KV store per commit,
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


def attn_counts(cfg) -> tuple:
    """(attention layers, attention entries) of a model: a KV store is
    viewed once per attention layer and pass, and a stacked entry's
    stores encode (and take their draft view) in one launch each. For a
    model whose every layer attends: (n_layers, layer groups)."""
    from repro_torch.configs import layer_groups
    groups = layer_groups(cfg)
    return (sum(g.repeats * sum(e[0] == "a" for e in g.entries)
                for g in groups),
            sum(e[0] == "a" for g in groups for e in g.entries))


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


def main_phase(packed, cfg, cass, gen, args, tag: str = "main",
               rt_extra: dict | None = None, exact: bool = False,
               embeds: dict | None = None, tokens=None) -> dict:
    """Phase 6 (and phase 16's, 17's and 18's Engine runs, under ``tag``):
    AR steps at width 1 and at the verify width against one verify pass,
    the draft side of one cycle, then ``Engine.generate`` autoregressive
    and speculative; spec tokens against the verify-width AR run under the
    near-tie rule (>= 90% of positions), launches as the passes imply.
    ``exact``: the verify-width AR steps must equal the verify pass bit
    for bit and the spec tokens the AR run's on every position.
    ``rt_extra`` goes to the Engine's ``Runtime`` (MoE's capacity);
    ``embeds`` (a frontend's ``frame_embeds`` or ``patch_embeds``) to
    every prefill; ``tokens`` (B,S) int32 on the card replaces the random
    prompts (phase 19's prompts from the data stream)."""
    import dataclasses

    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import (Engine, EngineConfig, _run_drafts,
                                           top2_margin)

    b, s, n, gamma = args.requests, args.prompt_len, args.max_new, cass.gamma
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device="cuda").to(torch.int32)
    b, s = tokens.shape
    prompt = {"tokens": tokens, **(embeds or {})}
    s_total = s + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=gamma),
                 device="cuda", rt_extra=rt_extra)
    per_pass = draft_matrices(packed)

    # tau per width: γ+1 AR steps at that width against one width-(γ+1)
    # verify pass over the same tokens from the same prefilled cache. The
    # width-(γ+1) run goes on to all n tokens: the harness that holds the
    # spec tokens to an AR run with the verify pass's own numerics.
    rt_t = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(cfg, cass, b, s_total + n + gamma + 1, packed=True,
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
                fail(f"{tag}: target logits are not finite")
            diff = logits[:, 1:gamma + 2] - l_v
            gap[width] = diff.abs().max().item()
            say(f"[{tag}] AR steps at width {width} vs the verify pass, "
                f"target logits over {gamma + 1} positions: max abs diff "
                f"{gap[width]:.3g}, rms "
                f"{diff.square().mean().sqrt().item():.3g} (logit rms "
                f"{l_v.square().mean().sqrt().item():.3g})")
            if width > 1:
                wide = (toks.cpu().numpy(), top2_margin(logits).cpu().numpy())
            del toks, logits, l_v, diff
        say(f"[{tag}] one verify pass (target view, width {gamma + 1}, "
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
    say(f"[{tag}] draft side of one cycle: {drafts_ms:.1f} ms = the cache's "
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
            fail(f"{tag}: {what} tokens have shape {t.shape}")
        if not ((t[:, :n] >= 0) & (t[:, :n] < cfg.vocab_size)).all():
            fail(f"{tag}: {what} tokens out of range: {t[:, :n]}")
    # lossless: against the AR run at the verify width (tau from its gap)
    tau = 2.0 * gap[gamma + 1]
    if exact and gap[gamma + 1] != 0.0:
        fail(f"{tag}: AR steps at the verify width differ from the verify "
             f"pass by {gap[gamma + 1]}")
    compared, cut = tau_check(sp_np, wide[0], wide[1], tau, n)
    share = compared / (b * n)
    if exact and compared != b * n:
        fail(f"{tag}: spec == AR at the verify width on only {compared} of "
             f"{b * n} positions")
    say(f"[{tag}] lossless: spec == AR at the verify width {gamma + 1} on "
        f"{compared} of {b * n} positions ({share:.1%}); tau = 2 x its max "
        f"abs diff = {tau:.3g} cut {cut}")
    if share < 0.9:
        fail(f"{tag}: only {share:.1%} of positions compared under tau")
    # and against the engine's width-1 AR (tau from the width-1 gap)
    tau1 = 2.0 * gap[1]
    compared1, cut1 = tau_check(sp_np, ar_np, st_ar["margins"], tau1, n,
                                what=f"{tag} width 1")
    say(f"[{tag}] spec == Engine AR (width 1) on {compared1} of {b * n} "
        f"positions ({compared1 / (b * n):.1%}); tau = 2 x the width-1 max "
        f"abs diff = {tau1:.3g} cut {cut1}; AR margins below tau: "
        f"{int((st_ar['margins'][:, :n] < tau1).sum())} of {b * n}")
    expect = st_sp["draft_passes"] * per_pass
    say(f"[{tag}] draft_matmul launches {launches} = draft passes "
        f"{st_sp['draft_passes']} x {per_pass}: {launches == expect}")
    if launches == 0 or launches != expect:
        fail(f"{tag}: draft_matmul launched {launches} times, expected "
             f"{expect}")
    # one target_decode per packed weight per target pass; one kv_view
    # per KV target view per layer per verify pass and per draft view of
    # the cache once per cycle; one kv_encode per store per commit
    # (a layer group's stores encode and view in one launch each; the
    # prefill decodes an encoder's weights too)
    cyc, mats = st_sp["cycles"], pass_matrices(packed)
    layers, entries = attn_counts(cfg)
    check_launches(tag, codec, {
        "mx_decode": 0, "mx_view": 0, "kv_topk": 0,
        "kv_encode": 2 * entries * (1 + cyc),
        "kv_view": 2 * layers * cyc + 2 * entries * cyc,
        "unary_decode": (st_sp["draft_passes"] * layers
                         * _kv_b_pieces(packed) if cfg.mla else 0),
        "target_decode": packed_matrices(packed) + mats * cyc})
    say(f"[{tag}] spec: cycles {st_sp['cycles']}, acceptance "
        f"{st_sp['acceptance']:.3f}, tokens/cycle "
        f"{st_sp['tokens_per_cycle']:.3f}, {b * n / sp_s:.2f} tok/s "
        f"({sp_s:.1f} s)")
    say(f"[{tag}] AR (Engine, width 1): cycles {st_ar['cycles']}, "
        f"{b * n / ar_s:.2f} tok/s ({ar_s:.1f} s)")
    say(f"[{tag}] max_memory_allocated during the spec run "
        f"{peak / 2**30:.2f} GiB")
    return {"launches": launches, "codec": codec, "prompt": prompt["tokens"],
            "lg": lg_cpu, "wide": wide, "acceptance": st_sp["acceptance"],
            "verify_ms": verify_ms, "tok_s": b * n / sp_s,
            "cycle_ms": sp_s * 1e3 / st_sp["cycles"], "peak": peak,
            "gap1": gap[1]}

# ---------------------------------------------------------------------------
# Phase 4b: the paged-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_prefill(packed, cfg, cass, prompt, n_new: int,
                  rt_extra: dict | None = None, attn_kernel: str = "on",
                  f32: bool = False):
    """Chunked prefill of ``prompt`` (B,S) into a paged cache (packed when
    ``cass`` is given) through the engine's own wide step, row b on blocks
    1+b·MB .. (block 0 is the trash block); a last chunk shorter than
    CHUNK is zero-padded with its valid count, as the Scheduler pads it.
    ``f32``: every floating leaf of the cache in f32 (a plain f32 model's).
    Returns (cache, the last prefill logits (B,V))."""
    import torch
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import engine as E, kvcache as KC
    from repro_torch.serving.blockpool import blocks_needed
    b, s = prompt.shape
    gamma = cass.gamma if cass is not None else 3
    mb = blocks_needed(s + n_new + gamma + 1, BLOCK)
    cache = KC.init_paged_cache(cfg, cass, b, b * mb + 1, BLOCK, mb,
                                packed=cass is not None, device="cuda")
    if f32:
        _floats_to_f32(cache)
    cache["block_table"] = (1 + torch.arange(b * mb, device="cuda")).reshape(
        b, mb).to(torch.int32)
    rt = Runtime(cfg=cfg, cass=cass, view="target", attn_kernel=attn_kernel,
                 **(rt_extra or {}))
    with torch.inference_mode():
        for c0 in range(0, s, CHUNK):
            v = min(CHUNK, s - c0)
            chunk = torch.zeros((b, CHUNK), dtype=prompt.dtype,
                                device="cuda")
            chunk[:, :v] = prompt[:, c0:c0 + v]
            valid = torch.full((b,), v, dtype=torch.int32, device="cuda")
            last, cache = E.chunk_prefill_step(rt, packed, cache, chunk,
                                               valid)
    return cache, last


def _floats_to_f32(tree) -> None:
    """Every floating tensor of a nested dict / list in f32, in place (one
    leaf at a time, so a bf16 tree's peak is its f32 size and a leaf)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _floats_to_f32(v)
        elif getattr(v, "is_floating_point", lambda: False)():
            tree[k] = v.float()


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

def serve_paged(cfg, params, cass, prompt, n: int, speculative=True,
                ecfg=None, **kw):
    """Every request at arrival 0 through a paged ``Scheduler`` with one
    slot per request (so every admission takes the wide bucket); ``ecfg``
    defaults to greedy at the format's γ. Returns (scheduler, tokens
    (B,n), each request's first-token logits (B,V), wall seconds)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.scheduler import Scheduler
    b, s = prompt.shape
    gamma = cass.gamma if cass is not None else 3
    sched = Scheduler(cfg, params, cass=cass,
                      ecfg=ecfg or EngineConfig(gamma=gamma), num_slots=b,
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


def _in_pass(path: str) -> bool:
    """Whether a decode pass reads the packed weight at ``path``: not an
    encoder's (it runs at the prefill only), nor cross-attention's wk / wv
    (the prefill caches the cross K/V)."""
    return not path.startswith("/enc") and not path.endswith(
        ("/xattn/wk/w", "/xattn/wv/w"))


def pass_matrices(packed) -> int:
    """Packed weight matrices a decode pass reads: one ``target_decode``
    launch each per C-1 target pass (the prefill's are
    ``packed_matrices``: whisper's encoder and cross K/V projections
    too)."""
    return sum(_n_layers(w) for path, w in _packed_weights(packed)
               if _in_pass(path))


def draft_matrices(packed) -> int:
    """``draft_matmul`` launches per draft pass: one per packed weight
    matrix a pass reads (``pass_matrices``) but MLA's kv_b, whose draft
    view ``resolve_weight`` decodes (7 x layers + 1 for Llama-3-8B and
    DeepSeek-V3; 7 x layers for a tied-embedding model such as qwen3-4b,
    whose unembed is the bf16 table; 4 x layers + 1 for DBRX, whose
    routed experts and router stay unpacked; 8 x layers + 1 for whisper:
    self-attention's four, cross-attention's wq and wo, up and down)."""
    return sum(_n_layers(w) for path, w in _packed_weights(packed)
               if _in_pass(path) and not path.endswith("/kv_b/w"))


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
# Phase 14: the prefix cache (copy-on-write) and preemption with host swap
# ---------------------------------------------------------------------------

PS_REQUESTS = 8                    # two waves of 4 through 4 slots
PS_HEADER = 72                     # the shared header: 4.5 blocks of 16
PS_TIGHT_BLOCKS = 24               # the oversubscribed pool, trash included


def all_launches() -> dict:
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import paged_attention as PA
    return {"draft_matmul": DM.draft_matmul.launches,
            "paged_gqa": PA.paged_gqa.launches,
            "paged_gqa_packed": PA.paged_gqa_packed.launches,
            "paged_mla": PA.paged_mla.launches, **codec_launches()}


def pass_launches(kind: str, st: dict, cfg, cass, packed) -> dict:
    """Every kernel's launches a scheduler run's passes imply (the rules
    of phases 7, 10 and 13): ``kind`` "c1" (GQA, attention kernels on),
    "c2" (attention kernel off) or "mla" (``paged_mla``). Block copies,
    spills and restores are plain indexing: no launch."""
    gamma = cass.gamma
    layers, groups = attn_counts(cfg)   # an entry's stores encode at once
    unified = st["cycles"] - st["prefill_cycles"] + st["mixed_cycles"]
    drafts, targets = gamma * unified, st["cycles"]
    mats = packed_matrices(packed)
    out = dict.fromkeys(all_launches(), 0)
    if kind == "c1":
        out.update(draft_matmul=drafts * draft_matrices(packed),
                   paged_gqa=targets * layers,
                   paged_gqa_packed=drafts * layers,
                   kv_encode=2 * groups * targets,
                   kv_view=targets * 2 * layers,
                   target_decode=targets * mats)
    elif kind == "c2":
        out.update(mx_view=targets * (mats + 2 * layers)
                   + gamma * unified * mats + 2 * unified,
                   kv_topk=2 * targets)
    else:
        out.update(draft_matmul=drafts * draft_matrices(packed),
                   paged_mla=(targets + drafts) * layers,
                   kv_encode=2 * groups * targets,
                   kv_view=(targets + drafts) * 2 * layers,
                   unary_decode=drafts * layers * _kv_b_pieces(packed),
                   target_decode=targets * mats)
    return out


def serve_trace(tag: str, kind: str, cfg, params, cass, prompts, n: int, *,
                waves: bool, **kw):
    """One phase-14 trace through a paged ``Scheduler`` (4 slots, block 16,
    chunk 32, fused, overlap). ``waves``: the first half of the prompts
    run to idle, then the second half arrives and finds the first half's
    blocks indexed; otherwise arrivals come a quarter cycle apart with
    priorities 0 and 1 alternating. Launch counts are set to 0 before the
    run and held to the passes after it. Returns (scheduler, summary,
    tokens (R, n), wall s, launches)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(cfg, params, cass=cass,
                      ecfg=EngineConfig(gamma=cass.gamma), num_slots=4,
                      s_max=prompts.shape[1] + n + cass.gamma + 1,
                      paged=True, block_size=BLOCK, chunk_size=CHUNK,
                      device="cuda", **kw)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if waves:
        half = len(prompts) // 2
        reqs = [sched.submit(p, max_new=n) for p in prompts[:half]]
        sched.run()
        reqs += [sched.submit(p, max_new=n, arrival=sched.clock)
                 for p in prompts[half:]]
    else:
        reqs = [sched.submit(p, max_new=n, arrival=i / 4.0, priority=i % 2)
                for i, p in enumerate(prompts)]
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sched.summary()
    got, want = all_launches(), pass_launches(kind, st, cfg, cass, params)
    if got != want:
        fail(f"{tag}: launches {got} != expected {want}")
    sched.check_invariants()
    for r in reqs:
        if len(r.output) != n:
            fail(f"{tag}: request {r.rid} delivered {len(r.output)} tokens, "
                 f"expected {n}")
    tokens = np.array([r.output for r in reqs], dtype=np.int64)
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"{tag}: tokens out of range")
    return sched, st, tokens, wall, got


def _event_ms(fn) -> float:
    """CUDA-event ms from before ``fn``'s work is enqueued to its end
    (host gaps between its launches included)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def block_moves(tag: str, sched, reps: int = 5) -> dict:
    """(a) ``copy_pool_blocks`` and a spill / restore round trip through
    pinned host buffers on a scheduler's pool after its run (its indexed
    blocks hold prompt KV from the prefills): destinations bit for bit,
    sources and every other block untouched, block 0 unchanged,
    ``put_async`` + ``finalize`` giving the bytes ``put`` gives. Times by
    CUDA events; bytes as moved (the padded entries included)."""
    import numpy as np
    import torch
    from repro_torch.serving import kvcache as KC
    from repro_torch.core.tree import tree_leaves
    from repro_torch.serving.swapstore import SpillStore
    cache, nb, mb = sched.cache, sched.num_blocks, sched.max_blocks
    indexed = sorted(sched.prefix.by_block)
    spill_src = indexed[:min(8, mb)]
    free = [j for j in range(1, nb) if j not in indexed]
    n = len(spill_src)
    if len(indexed) < 3 or len(free) < 3 + n:
        fail(f"{tag}: too few blocks for the block checks ({indexed})")
    leaves = tree_leaves(cache["dec"])
    bb = sum(t[:, 0].numel() * t.element_size() for t in leaves)

    def untouched(now, was, changed) -> bool:
        rest = [j for j in range(nb) if j not in changed]
        return all(_same_bits(t[:, rest], w[:, rest])
                   for t, w in zip(now, was))
    # copy-on-write: 3 pairs and one trash -> trash pad, as the scheduler
    k = sched.num_slots
    src, dst = np.zeros(k, np.int32), np.zeros(k, np.int32)
    src[:3], dst[:3] = indexed[:3], free[:3]
    src_d, dst_d = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
    before = [t.clone() for t in leaves]
    KC.copy_pool_blocks(cache, src_d, dst_d)
    torch.cuda.synchronize()
    cow_ok = (all(_same_bits(t[:, free[:3]], w[:, indexed[:3]])
                  for t, w in zip(leaves, before))
              and untouched(leaves, before, free[:3]))
    cow_ms = cuda_ms(lambda: KC.copy_pool_blocks(cache, src_d, dst_d), 20)
    cow_bytes = 2 * k * bb
    # spill n blocks, padded to the row's table width, both ways
    vec = np.zeros(mb, np.int32)
    vec[:n] = spill_src
    vec_d = torch.from_numpy(vec).cuda()
    want = [t[:, spill_src].clone() for t in leaves]
    sync, staged = SpillStore(), SpillStore()
    chain = sync.put(0, KC.spill_pool_blocks(cache, vec_d), n, length=0,
                     pos=0, cur=0)
    spill_ms = []
    for i in range(reps):
        spill_ms.append(_event_ms(lambda: staged.put_async(
            i, KC.spill_pool_blocks(cache, vec_d), n, length=0, pos=0,
            cur=0)))
    staged.finalize()
    spill_ok = all(
        h.is_pinned() and _same_bits(h, w.cpu())
        for c in [chain] + [staged.get(i) for i in range(reps)]
        for h, w in zip(tree_leaves(c.data), want))
    # restore the chain into other blocks
    back = free[3:3 + n]
    vec2 = np.zeros(mb, np.int32)
    vec2[:n] = back
    vec2_d = torch.from_numpy(vec2).cuda()
    host = chain.slice_blocks(0, n, mb)
    before = [t.clone() for t in leaves]
    KC.restore_pool_blocks(cache, vec2_d, host)
    torch.cuda.synchronize()
    restore_ok = (all(_same_bits(t[:, back], w)
                      for t, w in zip(leaves, want))
                  and untouched(leaves, before, back)
                  and all(h.is_pinned() for h in tree_leaves(host)))
    restore_ms = [_event_ms(lambda: KC.restore_pool_blocks(
        cache, vec2_d, host)) for _ in range(reps)]
    trash_ok = all(_same_bits(t[:, 0], w[:, 0])
                   for t, w in zip(leaves, before))
    sp, rs = float(np.median(spill_ms)), float(np.median(restore_ms))
    say(f"[{tag}] block moves on the pool after the run ({len(leaves)} "
        f"leaves, {bb} B a block): copy-on-write of 3 blocks + 1 trash "
        f"pair bit for bit, sources and other blocks untouched: {cow_ok}; "
        f"{cow_ms * 1e3:.1f} us, {cow_bytes} B of HBM traffic, "
        f"{cow_bytes / cow_ms / 1e6:.2f} GB/s")
    say(f"[{tag}] spill of {n} blocks ({n * bb} B; the gather covers the "
        f"{mb}-block operand) into pinned host buffers, put and put_async + "
        f"finalize bit for bit: {spill_ok}; median {sp * 1e3:.1f} us of "
        f"{reps} (CUDA events, gather + device-to-host), "
        f"{n * bb / sp / 1e6:.2f} GB/s of the chain; HBM traffic "
        f"{(2 * mb + n) * bb} B")
    say(f"[{tag}] restore of the chain into {n} other blocks ({mb}-block "
        f"padded operand, {mb * bb} B host-to-device) bit for bit, other "
        f"blocks untouched: {restore_ok}; median {rs * 1e3:.1f} us of "
        f"{reps}, {n * bb / rs / 1e6:.2f} GB/s of the chain; block 0 "
        f"unchanged through all: {trash_ok}")
    if not (cow_ok and spill_ok and restore_ok and trash_ok):
        fail(f"{tag}: block moves not bit for bit (cow {cow_ok}, spill "
             f"{spill_ok}, restore {restore_ok}, trash {trash_ok})")
    return {"block_bytes": bb, "cow_us": cow_ms * 1e3,
            "cow_gbs": cow_bytes / cow_ms / 1e6, "spill_us": sp * 1e3,
            "restore_us": rs * 1e3}


def _wall(st: dict, name: str) -> str:
    w = st["bucket_wall_ms"].get(name, {"calls": 0, "mean_ms": 0.0})
    return f"{name} {w['mean_ms']:.3f} ms x{w['calls']}"


def prefix_swap_runs(tag: str, kind: str, cfg, params, cass, gen,
                     args) -> dict:
    """(b) the prefix cache on and off, (a) the block checks on the
    cache-on run's pool, and (c) swap on a tight pool and on an ample one,
    for one model. The gates are bitwise: the tokens with the cache on
    equal those with it off, and the tokens with swap equal those of the
    pool that never preempts."""
    import numpy as np
    import torch
    n = args.max_new
    prompts = torch.randint(0, cfg.vocab_size, (PS_REQUESTS,
                                                args.prompt_len),
                            generator=gen, device="cuda").cpu().numpy()
    shared = prompts.copy()
    shared[:, :PS_HEADER] = prompts[0, :PS_HEADER]
    attn = {"attn_kernel": "off" if kind == "c2" else "on"}
    encode = "kv_topk" if kind == "c2" else "kv_encode"
    attend = {"c1": "paged_gqa", "mla": "paged_mla"}.get(kind)
    on_s, on, on_tok, on_wall, on_l = serve_trace(
        f"{tag} prefix on", kind, cfg, params, cass, shared, n, waves=True,
        prefix_cache=True, **attn)
    _, off, off_tok, off_wall, off_l = serve_trace(
        f"{tag} prefix off", kind, cfg, params, cass, shared, n, waves=True,
        **attn)
    same = np.array_equal(on_tok, off_tok)
    say(f"[{tag}] prefix cache on == off, bit for bit: {same}")
    if not same:
        fail(f"{tag}: tokens with the prefix cache on differ from off: "
             f"equal at {int((on_tok == off_tok).sum())} of {on_tok.size}")
    fewer = on_l[encode] < off_l[encode] and (
        attend is None or on_l[attend] < off_l[attend])
    say(f"[{tag}] prefix: hit rate {on['prefix_hit_rate']:.3f} "
        f"({on['prefix_hits']} of {on['prefix_queries']} admissions), "
        f"matched {on['prefix_matched_tokens']} tokens, aliased "
        f"{on['prefix_blocks_aliased']} blocks, copy-on-write "
        f"{on['cow_copies']}; prefill tokens {on['prefill_tokens']} / "
        f"{off['prefill_tokens']} (saved "
        f"{off['prefill_tokens'] - on['prefill_tokens']}), prefill cycles "
        f"{on['prefill_cycles']} / {off['prefill_cycles']} (chunks saved "
        f"{off['prefill_cycles'] - on['prefill_cycles']}); cycles "
        f"{on['cycles']} / {off['cycles']}; wall {on_wall:.2f} / "
        f"{off_wall:.2f} s (on / off); {_wall(on, 'cow')}; step shapes "
        f"{on['trace_counts']}")
    say(f"[{tag}] launches, cache on: {on_l}; off: {off_l}; each as its "
        f"passes imply: True; {encode}"
        f"{'' if attend is None else ' and ' + attend} fewer with the "
        f"cache on: {fewer}")
    if not (on["prefix_hits"] > 0 and on["prefix_matched_tokens"] > 0
            and on["cow_copies"] >= 1 and fewer):
        fail(f"{tag}: the prefix cache was not exercised: {on}")
    moves = block_moves(tag, on_s)
    del on_s
    tight_s, tight, tight_tok, tight_wall, tight_l = serve_trace(
        f"{tag} swap", kind, cfg, params, cass, prompts, n, waves=False,
        swap=True, num_blocks=PS_TIGHT_BLOCKS, **attn)
    bb = moves["block_bytes"]
    del tight_s
    _, ample, ample_tok, ample_wall, _ = serve_trace(
        f"{tag} ample", kind, cfg, params, cass, prompts, n, waves=False,
        **attn)
    same = np.array_equal(tight_tok, ample_tok)
    say(f"[{tag}] swap on a {PS_TIGHT_BLOCKS}-block pool == a "
        f"{ample['pool_blocks'] + 1}-block pool that never preempts, bit for "
        f"bit: {same}")
    if not same:
        fail(f"{tag}: tokens with swap differ from the ample pool's: equal "
             f"at {int((tight_tok == ample_tok).sum())} of {tight_tok.size}")
    say(f"[{tag}] swap: preemptions {tight['preemptions']}, resumes "
        f"{tight['swap_resumes']}, blocks spilled {tight['swap_out_blocks']} "
        f"({tight['swap_out_blocks'] * bb} B) / restored "
        f"{tight['swap_in_blocks']} ({tight['swap_in_blocks'] * bb} B) / "
        f"re-aliased {tight['swap_matched_blocks']}, host peak "
        f"{tight['spill_peak_bytes']} B; walls {_wall(tight, 'spill')}, "
        f"{_wall(tight, 'spill.dispatch')}, {_wall(tight, 'restore')}, "
        f"{_wall(tight, 'restore.dispatch')}; cycles {tight['cycles']} / "
        f"{ample['cycles']}, wall {tight_wall:.2f} / {ample_wall:.2f} s "
        f"(swap / ample); ample preemptions {ample['preemptions']}; "
        f"launches {tight_l}; step shapes {tight['trace_counts']}")
    if not (tight["preemptions"] >= 1 and tight["swap_out_blocks"] >= 1
            and tight["swap_in_blocks"] >= 1
            and ample["preemptions"] == 0):
        fail(f"{tag}: swap was not exercised: {tight}")
    return {"on": on, "off": off, "tight": tight, "ample": ample,
            "launches": {"on": on_l, "off": off_l, "swap": tight_l},
            "moves": moves, "walls": (on_wall, off_wall, tight_wall,
                                      ample_wall)}


def chunk_start_outputs(cfg, windowed: bool):
    """One paged attention layer of ``cfg`` at full width (random weights,
    random bf16 pools) on the same prompt tokens under two chunk
    partitions: positions 32..47 in one 16-wide chunk from a pool holding
    0..31, and 40..47 from the pool holding 0..39 (its 32..39 the K/V or
    latents the first pass computed), as after a prefix hit or a resume.
    Returns the two passes' outputs at 40..47; ``windowed`` passes the
    serving steps' window start (``engine.window_start``)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import _index, init_params
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import window_start
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = _index(init_params(cfg, gen, device="cuda")["dec"][0]["e0"]["attn"],
               0)
    rt = Runtime(cfg=cfg, cass=None, view="plain", attn_kernel="on")
    b, t, mb = 2, 16, 4
    table = (1 + torch.arange(b * mb, device="cuda")).reshape(b, mb).to(
        torch.int32)
    x = torch.randn((b, 48, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pools = {nm: (torch.randn((b * mb + 1, BLOCK, *KC.store_heads(cfg), d),
                              generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16) for nm, d in KC.store_dims(cfg).items()}

    def layer(lo: int, valid: int):
        length = torch.full((b,), lo, dtype=torch.int32, device="cuda")
        xs = torch.zeros((b, t, cfg.d_model), dtype=torch.bfloat16,
                         device="cuda")
        xs[:, :valid] = x[:, lo:lo + valid]
        pos = length[:, None] + torch.arange(t, device="cuda")
        kw = dict(table=table, length=length, scratch=None, scratch_len=0,
                  suffix_from=window_start(
                      length, torch.full_like(length, valid), t)
                  if windowed else None)
        if cfg.mla:
            return A.mla_attention_paged(rt, p, xs, pos, c_pool=pools["c"],
                                         kr_pool=pools["kr"], **kw)
        return A.gqa_attention_paged(
            rt, p, xs, pos, kv_pools=("plain", pools["k"], pools["v"]), **kw)

    with torch.inference_mode():
        out_a, new_a = layer(32, 16)
        for pool, new in zip(pools.values(), new_a):
            pool[table[:, 2].to(torch.int64), :8] = new[:, :8]
        out_b, _ = layer(40, 8)
    torch.cuda.synchronize()
    return out_a[:, 8:16], out_b[:, :8]


def chunk_start_check() -> None:
    """A prompt token's attention output must not depend on where its
    chunk started (the prefix cache and resumes start chunks mid-grid):
    one layer of Llama-3-8B and of DeepSeek-V3 at full width, with the
    serving steps' window start (gate: bit for bit) and without it (the
    pool walk / suffix split moves with the chunk start; reported)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    for arch in ("llama3-8b", "deepseek-v3-671b"):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=1, first_dense_layers=min(
            full.first_dense_layers, 1))
        got = {}
        for windowed in (False, True):
            a, b = chunk_start_outputs(cfg, windowed)
            got[windowed] = (_same_bits(a, b),
                             float((a.float() - b.float()).abs().max()))
        say(f"[prefix-swap] {arch}, one layer at full width, a prompt "
            f"token's attention output with its chunk started on the grid "
            f"and mid-grid: without the window start bit for bit "
            f"{got[False][0]} (max abs diff {got[False][1]:.3g}); with it "
            f"{got[True][0]} (max abs diff {got[True][1]:.3g})")
        if not got[True][0]:
            fail(f"prefix-swap: {arch}'s attention depends on the chunk start")
        gc.collect()
        torch.cuda.empty_cache()


def prefix_swap_phase(args) -> dict:
    """Phase 14 on Llama-3-8B: the chunk-start check of one layer, then
    full width under Cassandra-1 with the attention kernels on, then 2
    layers under Cassandra-2 with the attention kernel off. Each model is
    new, from a generator of its own."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params
    from repro_torch.models.model import init_params
    chunk_start_check()
    out = {}
    for tag, kind, layers, variant, seed in (
            ("prefix-swap", "c1", args.layers, 1, args.seed + 6),
            ("c2-prefix-swap", "c2", 2, 2, args.seed + 7)):
        cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=layers)
        cass = CassandraConfig(variant=variant, gamma=3)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        packed = format_params(init_params(cfg, gen, device="cuda"), cass)
        torch.cuda.synchronize()
        say(f"[{tag}] {cfg.name} {layers} layers, Cassandra-{variant}, "
            f"set up in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out[kind] = prefix_swap_runs(tag, kind, cfg, packed, cass, gen, args)
        say(f"[{tag}] done in {time.perf_counter() - t0:.1f} s")
        del packed
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 15: rejection sampling (paper Eq. 1), Wanda calibration, telemetry
# ---------------------------------------------------------------------------

DIST_ROWS = 8192                   # copies of one prompt in the Eq. 1 gate
DIST_CHUNK = 512                   # of them in one cycle
DIST_SE = 5.0                      # its bound: 5 standard errors a bin
DIST_TOP = 8                       # bins: the 8 likeliest tokens and the rest
DIST_TEMPS = (1.0, 0.8, 0.6, 0.5, 0.4, 0.3, 0.25, 0.2, 0.15, 0.1, 0.07,
              0.05, 0.03, 0.02, 0.01)


def _leaf_at(tree, path: str):
    """The node at a ``format_params`` path (``dec[0].e0.attn.wq``)."""
    for part in path.replace("[", ".").replace("]", "").split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _flat_bits(tree) -> list:
    """(path, raw int tensor) of every tensor leaf: bf16 as int16."""
    import torch
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, torch.Tensor):
            out.append((path, node.view(torch.int16)
                        if node.dtype == torch.bfloat16 else node))
    walk(tree, "")
    return out


def _cycle_events_ok(events, st: dict, b: int, n: int, gamma: int) -> bool:
    """One CYCLE event per active row and cycle: each row's events carry
    the cycles 1..k in order, its committed tokens (the prefill token plus
    the events' n+1) reach ``n`` at its last event and not before, and
    every event proposes γ."""
    from repro_torch.serving.telemetry import CYCLE
    rows: dict = {}
    for ev in events:
        _, cycle, kind, rid, slot, evargs = ev
        if kind != CYCLE or rid != slot or evargs[0] != gamma \
                or evargs[2] != evargs[1] + 1:
            return False
        rows.setdefault(rid, []).append((cycle, evargs[2]))
    if sorted(rows) != list(range(b)):
        return False
    for evs in rows.values():
        if [c for c, _ in evs] != [float(i + 1) for i in range(len(evs))]:
            return False
        done = 1 + sum(d for _, d in evs)
        if done < n or done - evs[-1][1] >= n:
            return False
    return max(len(v) for v in rows.values()) == st["cycles"]


def sample_engine(cfg, packed, cass, prompt, args, main: dict) -> dict:
    """15a/15e: ``Engine.generate`` sampled at temperature 1.0, twice from
    one seed (telemetry on, then off): tokens bit for bit, every row its
    tokens, launches as phase 6's rule for the passes, the telemetry
    counters equal to the stats and one CYCLE event per active row and
    cycle."""
    import numpy as np
    import torch
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.telemetry import Telemetry

    b, n, gamma = args.requests, args.max_new, cass.gamma
    eng = Engine(cfg, packed, cass=cass, device="cuda",
                 ecfg=EngineConfig(gamma=gamma, greedy=False,
                                   temperature=1.0))
    runs = []
    for telemetry in (Telemetry(trace=True), None):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, st = eng.generate(
            {"tokens": prompt}, max_new=n, telemetry=telemetry,
            generator=torch.Generator(device="cuda").manual_seed(
                args.seed + 20))
        torch.cuda.synchronize()
        runs.append((toks.cpu().numpy(), st, time.perf_counter() - t0,
                     DM.draft_matmul.launches, codec_launches(), telemetry))
    (tok, st, wall, dm, codec, tel), (tok2, st2, wall2, *_) = runs
    same = np.array_equal(tok, tok2)
    say(f"[sample] Engine, T=1.0, seed {args.seed + 20} twice (telemetry on, "
        f"off): bit for bit {same}; {wall:.1f} s, {wall2:.1f} s")
    if not same or st != st2:
        fail("sample: two sampled Engine runs from one seed differ")
    counts = (tok >= 0).sum(1)
    if tok.shape != (b, n + gamma + 1) or (counts < n).any() \
            or not (tok[tok >= 0] < cfg.vocab_size).all():
        fail(f"sample: sampled tokens {tok.shape}, per row {counts}")
    per_pass = 7 * cfg.n_layers + 1
    cyc, mats = st["cycles"], packed_matrices(packed)
    expect = st["draft_passes"] * per_pass
    say(f"[sample] draft_matmul launches {dm} = draft passes "
        f"{st['draft_passes']} x {per_pass}: {dm == expect}")
    if dm != expect or dm == 0:
        fail(f"sample: draft_matmul launched {dm} times, expected {expect}")
    check_launches("sample", codec, {
        "mx_decode": 0, "mx_view": 0, "kv_topk": 0,
        "kv_encode": 2 * (1 + cyc),
        "kv_view": 2 * cfg.n_layers * cyc + 2 * cyc, "unary_decode": 0,
        "target_decode": mats * (1 + cyc)})
    say(f"[sample] spec, T=1.0: cycles {cyc}, acceptance "
        f"{st['acceptance']:.3f} (phase 6 greedy {main['acceptance']:.3f}), "
        f"tokens/cycle {st['tokens_per_cycle']:.3f}, {b * n / wall:.2f} tok/s")
    # Engine telemetry (15e)
    snap = tel.metrics.snapshot()
    events = tel.tracer.events()
    counters = {k: snap[k] for k in ("cycles", "accepted", "drafted",
                                     "committed")}
    drafted = gamma * len(events)
    want = {"cycles": cyc,
            "accepted": round(st["acceptance"] * drafted),
            "drafted": drafted, "committed": int(counts.sum()) - b}
    hist = snap["histograms"]["acceptance_len"]
    ok = (counters == want and hist["n"] == len(events)
          and sum(ev[5][1] for ev in events) == counters["accepted"]
          and _cycle_events_ok(events, st, b, n, gamma))
    say(f"[telemetry] Engine counters {counters}; from the stats {want}; "
        f"{len(events)} CYCLE events, one per active row and cycle: {ok}; "
        f"tokens telemetry on == off: {same}")
    if not ok:
        fail(f"telemetry: counters {counters} / events disagree with the "
             f"stats {want}")
    # the sampler's own cost in one cycle at this batch (eager, CUDA
    # events): Eq. 1 acceptance (two f32 softmaxes + rejection_sample)
    # against the greedy rule, and one draft token's draw
    from repro_torch.serving.engine import _accept, _draw
    v = cfg.vocab_size
    lg = torch.randn((b, gamma + 1, v), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    drafts = [lg[:, i] * 0.9 for i in range(gamma)]
    dtok = torch.argmax(torch.stack(drafts, 1), -1).to(torch.int32)
    g = torch.Generator(device="cuda").manual_seed(4)
    t_eq1 = cuda_ms(lambda: _accept(dtok, drafts, lg, eng.ecfg, g), 20)
    t_greedy = cuda_ms(lambda: _accept(
        dtok, drafts, lg, EngineConfig(gamma=gamma), None), 20)
    t_draw = cuda_ms(lambda: _draw(lg[:, 0], False, 1.0, g), 20)
    say(f"[sample] sampler at B={b}, γ={gamma}, V={v} (eager, CUDA events): "
        f"Eq. 1 acceptance {t_eq1 * 1e3:.1f} us, greedy acceptance "
        f"{t_greedy * 1e3:.1f} us, one draft draw {t_draw * 1e3:.1f} us; a "
        f"sampled cycle {wall / cyc * 1e3:.1f} ms (host clock)")
    return {"acceptance": st["acceptance"], "tokens": tok,
            "eq1_us": t_eq1 * 1e3}


def _gate_stat(first, ids, p_bins, rows: int):
    """The Eq. 1 gate's comparison: the frequencies of the ``DIST_TOP``
    bins ``ids`` and the rest in ``first`` against ``p_bins``. Returns
    (freq, max |freq - p| / SE, every bin within ``DIST_SE`` SE)."""
    import numpy as np
    freq = np.array([(first == i).mean() for i in ids]
                    + [(~np.isin(first, ids)).mean()])
    se = np.sqrt(p_bins * (1 - p_bins) / rows)
    dev = np.abs(freq - p_bins)
    return freq, float((dev / se).max()), bool((dev <= DIST_SE * se).all())


def distribution_gate(cfg, packed, cass, prompt0, gen_seed: int) -> dict:
    """15b: the exact guarantee of Eq. 1 at the first drafted position.
    ``DIST_ROWS`` copies of one prompt, one speculative cycle each, run
    ``DIST_CHUNK`` rows at a time from one prefilled cache; the
    frequencies of ``tokens[:, 0]`` against the target probabilities p of
    that position (every row has the same prefix: p from row 0 of the
    target logits / T at the verify width). T is the largest of
    ``DIST_TEMPS`` whose ``DIST_TOP`` likeliest tokens hold at least half
    of the mass, chosen before any draw. Bound fixed beforehand: each bin
    and the rest within ``DIST_SE`` standard errors sqrt(p(1-p)/N).

    The same comparison must reject two planted faults on the same drafts
    (each with draws of its own, so the real run's stream is untouched): a
    residual of p in place of max(p - q, 0), and every draft accepted
    (the output then follows q). Their expected statistics, from p and
    the draft's q at that position, are printed beside what they read."""
    import numpy as np
    import torch
    from repro_torch.core import speculative as SP
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import EngineConfig, spec_decode_step

    gamma, rows, chunk = cass.gamma, DIST_ROWS, DIST_CHUNK
    tokens = prompt0[None].expand(chunk, -1).contiguous()
    rt = Runtime(cfg=cfg, cass=cass, view="target")
    cache = KC.init_cache(cfg, cass, chunk, tokens.shape[1] + gamma + 2,
                          packed=True, device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt, packed, {"tokens": tokens}, cache)
        cur = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        # position 0 of the verify pass sees cur alone (causal): its
        # logits do not depend on the drafts that follow
        l0, _ = M.forward_decode(rt, packed, cur.expand(-1, gamma + 1),
                                 cache)
        l0 = l0[0, 0].to(torch.float32)
        temp = None
        for t in DIST_TEMPS:
            p = torch.softmax(l0 / t, -1)
            if p.topk(DIST_TOP).values.sum().item() >= 0.5:
                temp = t
                break
        if temp is None:
            fail("dist: no temperature puts half the mass on 8 tokens")
        top = p.topk(DIST_TOP)
        p_bins = np.append(top.values.cpu().numpy().astype(np.float64),
                           1.0 - top.values.sum().item())
        bound = DIST_SE * np.sqrt(p_bins * (1 - p_bins) / rows)
        say(f"[dist] {rows} copies of one {tokens.shape[1]}-token prompt "
            f"({rows // chunk} cycles of {chunk} rows), T = {temp} (the "
            f"largest of {list(DIST_TEMPS)} whose top {DIST_TOP} hold >= 0.5"
            f" of the mass: {p_bins[:-1].sum():.4f}); bound fixed before the "
            f"draws: |freq - p| <= {DIST_SE} x sqrt(p(1-p)/N) per bin")
        ecfg = EngineConfig(gamma=gamma, greedy=False, temperature=temp)
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        fault_gen = torch.Generator(device="cuda").manual_seed(gen_seed + 1)
        real = SP.rejection_sample
        firsts = {"Eq. 1": [], "residual p": [], "accept all": []}
        seen = {}

        def planted(draft_tokens, draft_probs, target_probs, generator,
                    r=None):
            res = real(draft_tokens, draft_probs, target_probs, generator, r)
            seen.setdefault("q", draft_probs[0, 0].clone())
            # every row's p at that position, as its verify pass gives it
            seen["p_gap"] = torch.maximum(
                seen.get("p_gap", torch.zeros((), device="cuda")),
                (target_probs[:, 0] - p).abs().amax())
            n = real(draft_tokens, draft_probs, target_probs,
                     fault_gen).n_accepted
            redraw = SP.categorical(torch.log(target_probs[:, 0]), fault_gen)
            firsts["residual p"].append(
                torch.where(n > 0, draft_tokens[:, 0], redraw))
            firsts["accept all"].append(draft_tokens[:, 0])
            return res

        length0 = cache["length"]
        n_acc = 0
        SP.rejection_sample = planted
        try:
            for _ in range(rows // chunk):
                # commit writes past length0 and sets a new length: the
                # next cycle starts from the same prefix
                res, _ = spec_decode_step(rt, packed,
                                          dict(cache, length=length0), cur,
                                          ecfg, gen)
                firsts["Eq. 1"].append(res.tokens[:, 0])
                n_acc += int((res.n_accepted > 0).sum())
        finally:
            SP.rejection_sample = real
        firsts = {k: torch.cat(v).cpu().numpy() for k, v in firsts.items()}
        q = seen["q"].double().cpu().numpy()
        p_gap = seen["p_gap"].item()
        pf = p.double().cpu().numpy()
    del cache
    ids = top.indices.cpu().numpy()
    se = np.sqrt(p_bins * (1 - p_bins) / rows)
    alpha = float(np.minimum(pf, q).sum())
    expect = {"Eq. 1": pf, "residual p": np.minimum(pf, q)
              + (1 - alpha) * pf, "accept all": q}
    stats = {}
    for name, first in firsts.items():
        f = expect[name]
        f_bins = np.append(f[ids], 1.0 - f[ids].sum())
        pred = float((np.abs(f_bins - p_bins) / se).max())
        freq, stat, ok = _gate_stat(first, ids, p_bins, rows)
        stats[name] = (stat, ok)
        say(f"[dist] {name}: freq {np.round(freq, 4).tolist()}; statistic "
            f"max |freq - p| / SE = {stat:.3f} (expected {pred:.3f}, bound "
            f"{DIST_SE}); within the bound: {ok}")
    say(f"[dist] p (8 bins + rest) {np.round(p_bins, 4).tolist()}; bound "
        f"{np.round(bound, 4).tolist()}; the draft's acceptance at the first"
        f" position sum(min(p, q)) = {alpha:.4f}, first drafts accepted in "
        f"{n_acc} of {rows} rows; every verify pass's p at that position "
        f"within {p_gap:.3g} of p; {time.perf_counter() - t0:.1f} s")
    if not stats["Eq. 1"][1]:
        fail(f"dist: first-position frequencies outside {bound} of p "
             f"{p_bins}")
    for name in ("residual p", "accept all"):
        if stats[name][1]:
            fail(f"dist: the gate passes the planted fault '{name}' "
                 f"(statistic {stats[name][0]:.3f})")
    return {"temperature": temp, "stat": stats["Eq. 1"][0],
            "faults": {k: v[0] for k, v in stats.items() if k != "Eq. 1"}}


def sample_sched(tag: str, kind: str, cfg, params, cass, prompt, args,
                 seed: int, runs=(("a", {}), ("b", {})), **kw) -> None:
    """Sampled requests (T=1.0) through the paged ``Scheduler`` (one slot
    per request), each run from a generator seeded with ``seed``: every
    run's tokens bit for bit the first's; the first's launches as its
    passes imply."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import EngineConfig
    ecfg = EngineConfig(gamma=cass.gamma, greedy=False, temperature=1.0)
    first = None
    for name, extra in runs:
        reset_launches()
        sched, tokens, _, wall = serve_paged(
            cfg, params, cass, prompt, args.max_new, ecfg=ecfg,
            generator=torch.Generator(device="cuda").manual_seed(seed),
            **kw, **extra)
        st = sched.summary()
        if first is None:
            first = tokens
            got, want = all_launches(), pass_launches(kind, st, cfg, cass,
                                                      params)
            say(f"[{tag}] {name}: {tokens.shape[0]} x {args.max_new} tokens, "
                f"acceptance {st['acceptance']:.3f}, cycles {st['cycles']}, "
                f"{wall:.1f} s; launches as the passes imply {got == want}")
            if got != want:
                fail(f"{tag}: launches {got} != {want}")
        else:
            same = np.array_equal(tokens, first)
            say(f"[{tag}] {name} == {runs[0][0]}, seed {seed}, bit for bit: "
                f"{same} ({wall:.1f} s)")
            if not same:
                fail(f"{tag}: sampled tokens of {name} differ")
        del sched


def calibration_phase(cfg, plain, packed, cass, prompt, args,
                      main: dict) -> None:
    """15d: a ``Calibrator`` over the prompts through ``forward_train`` on
    the card, ``format_params(calib=...)``; every packed weight's path has
    a norm; one layer's calibrated ``format_weight`` bit for bit against
    the CPU's; the calibrated model passes phase 6's losslessness gate."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.format import format_weight
    from repro_torch.core.packing import (Calibrator, format_params,
                                          packed_paths)
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import Engine, EngineConfig, top2_margin

    b, s, n, gamma = args.requests, args.prompt_len, args.max_new, cass.gamma
    calib = Calibrator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = M.forward_train(Runtime(cfg=cfg, collector=calib), plain,
                                    {"tokens": prompt})
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    if logits.shape != (b, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        fail(f"calib: forward_train logits {tuple(logits.shape)}")
    del logits
    paths = packed_paths(packed)
    missing = []
    for path in paths:
        norm = calib.act_norm(path)
        w = _leaf_at(plain, path)["w"]
        if norm is None or tuple(norm.shape) != tuple(w.shape[:-1]) \
                or not torch.isfinite(norm).all():
            missing.append(path)
    say(f"[calib] forward_train over {tuple(prompt.shape)} tokens "
        f"{t_fwd:.2f} s; {len(paths)} packed weight paths, every one with a "
        f"norm of its input width (one row per layer): {not missing}")
    if missing:
        fail(f"calib: no norm for {missing}")
    t0 = time.perf_counter()
    calibrated = format_params(plain, cass, calib=calib)
    torch.cuda.synchronize()
    t_fmt = time.perf_counter() - t0
    changed = sum(not torch.equal(_leaf_at(calibrated, p)["w"]["spec"]
                                  ["bitmap"],
                                  _leaf_at(packed, p)["w"]["spec"]["bitmap"])
                  for p in paths)
    say(f"[calib] format_params(calib=...) {t_fmt:.1f} s; bitmaps that Wanda "
        f"changed against |W|: {changed} of {len(paths)} paths; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB (bf16 weights and both formats)")
    # one layer's calibrated format_weight, card against CPU
    w = plain["dec"][0]["e0"]["attn"]["wk"]["w"][0]
    norm = calib.act_norm("dec[0].e0.attn.wk")[0]
    t0 = time.perf_counter()
    card = format_weight(w, norm, cass)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu = format_weight(w.cpu(), norm.cpu(), cass)
    a, c = _flat_bits(card), _flat_bits(cpu)
    diff = [pa for (pa, x), (_, y) in zip(a, c)
            if not torch.equal(x.cpu(), y)]
    layer0 = {k: v[0] for k, v in _leaf_at(
        calibrated, "dec[0].e0.attn.wk")["w"]["spec"].items()}
    same_fp = all(torch.equal(card[0][k], layer0[k]) for k in card[0])
    say(f"[calib] format_weight of layer 0's wk {tuple(w.shape)} with its "
        f"norms, card ({t_card * 1e3:.0f} ms) vs CPU: {len(a)} leaves bit "
        f"for bit {not diff and len(a) == len(c)}; == format_params' layer "
        f"0 spec: {same_fp}")
    if diff or len(a) != len(c) or not same_fp:
        fail(f"calib: format_weight differs between card and CPU at {diff}")
    del card, cpu
    # phase 6's losslessness gate on the calibrated model
    eng = Engine(cfg, calibrated, cass=cass, ecfg=EngineConfig(gamma=gamma),
                 device="cuda")
    rt_t = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(cfg, cass, b, s + n + gamma + 1, packed=True,
                          device="cuda")
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt_t, calibrated, {"tokens": prompt},
                                      cache)
        lg = lg[:, -1]
        toks, logits = ar_steps(rt_t, calibrated, cache, lg, n, gamma + 1)
        l_v, _ = M.forward_decode(rt_t, calibrated, toks[:, :gamma + 1],
                                  cache)
    gap = (logits[:, 1:gamma + 2] - l_v).abs().max().item()
    wide = (toks.cpu().numpy(), top2_margin(logits).cpu().numpy())
    del cache, logits, l_v, toks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, st = eng.generate({"tokens": prompt}, max_new=n)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    tau = 2.0 * gap
    compared, cut = tau_check(sp.cpu().numpy(), wide[0], wide[1], tau, n,
                              what="calib")
    share = compared / (b * n)
    say(f"[calib] lossless: spec == AR at the verify width {gamma + 1} on "
        f"{compared} of {b * n} positions ({share:.1%}); tau = 2 x its max "
        f"abs diff = {tau:.3g} cut {cut}")
    if share < 0.9:
        fail(f"calib: only {share:.1%} of positions compared under tau")
    say(f"[calib] greedy spec, calibrated: acceptance {st['acceptance']:.3f} "
        f"(magnitude-pruned, phase 6: {main['acceptance']:.3f}; random "
        f"weights: no claim), cycles {st['cycles']}, {b * n / sp_s:.2f} tok/s "
        f"({sp_s:.1f} s)")


def sampling_phase(args, main: dict, mla: dict) -> None:
    """Phase 15 at full Llama-3-8B width (C-1, γ=3, phase 3's weights from
    ``--seed``): calibration, the sampled Engine with its telemetry, the
    Eq. 1 distribution gate, the sampled paged Scheduler at full width and
    at 2 layers (overlap on == off), C-2 at 2 layers and DeepSeek-V3's
    dense layers sampled through the Scheduler."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params
    from repro_torch.models.model import init_params

    t_phase = time.perf_counter()
    cfg = get_config("llama3-8b")
    if args.layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cass = CassandraConfig(variant=1, gamma=3)
    prompt = main["prompt"]
    t0 = time.perf_counter()
    plain = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    packed = format_params(plain, cass)
    torch.cuda.synchronize()
    say(f"[sample] phase 3's model again ({cfg.n_layers} layers, C-1, seed "
        f"{args.seed}): {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    calibration_phase(cfg, plain, packed, cass, prompt, args, main)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    eng = sample_engine(cfg, packed, cass, prompt, args, main)
    dist = distribution_gate(cfg, packed, cass, prompt[0], args.seed + 21)
    sample_sched("sample-sched", "c1", cfg, packed, cass, prompt, args,
                 args.seed + 22, attn_kernel="on")
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    # 2 layers, full width: overlap on == off under sampling (phase 8's gate)
    cfg2 = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 23)
    packed2 = format_params(init_params(cfg2, gen, device="cuda"), cass)
    sample_sched("sample-depth2", "c1", cfg2, packed2, cass, prompt, args,
                 args.seed + 24, runs=(("overlap on", {}),
                                       ("overlap off", {"overlap": False})),
                 attn_kernel="on")
    del packed2
    # C-2 at 2 layers (attention kernel off) and the MLA dense layers
    c2 = CassandraConfig(variant=2, gamma=3)
    packed2 = format_params(init_params(cfg2, gen, device="cuda"), c2)
    sample_sched("sample-c2", "c2", cfg2, packed2, c2, prompt, args,
                 args.seed + 25)
    del packed2
    gc.collect()
    torch.cuda.empty_cache()
    sample_sched("sample-mla", "mla", mla["cfg"], mla["packed"], mla["cass"],
                 mla["prompt"], args, args.seed + 26, attn_kernel="on")
    faults = ", ".join(f"{k} {v:.3f}" for k, v in dist["faults"].items())
    say(f"[sample] phase 15 in {time.perf_counter() - t_phase:.1f} s "
        f"(sampled acceptance {eng['acceptance']:.3f}, Eq. 1 gate at T = "
        f"{dist['temperature']}, statistic {dist['stat']:.3f}; planted "
        f"faults {faults})")

# ---------------------------------------------------------------------------
# Phase 16: the dense GQA family (qwen3-4b) and top-k MoE (DBRX,
# DeepSeek-V3's routed layers)
# ---------------------------------------------------------------------------

def family_setup(tag: str, cfg, seed: int, keep_plain: bool = False) -> dict:
    """Random weights for ``cfg`` from ``seed`` on a generator of its own,
    packed in Cassandra-1 (γ=3; the routed experts and the router stay
    plain, as the reference's walk leaves them), the plain tree freed
    (``keep_plain``: returned as ``plain``).
    ``extra`` is the ``Runtime`` fields the bitwise gates run at: for an
    MoE model the capacity factor n_experts / n_experts_per_tok, at which
    no expert's capacity can overflow (overflow couples rows)."""
    import torch
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params, params_nbytes
    from repro_torch.launch.serve import format_line
    from repro_torch.models.model import cfg_has_moe, init_params

    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    plain = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _leaves(plain))
    t0 = time.perf_counter()
    packed = format_params(plain, cass)
    torch.cuda.synchronize()
    t_fmt = time.perf_counter() - t0
    if not keep_plain:
        del plain
        gc.collect()
        torch.cuda.empty_cache()
    mixer = (f"Mamba d_inner {cfg.d_inner}, state {cfg.ssm_state}, dt_r "
             f"{cfg.dt_r}, pattern {''.join(e[0] for e in cfg.block_pattern)}, "
             if cfg.sub_quadratic else "")
    if cfg.frontend:
        mixer += (f"{cfg.n_encoder_layers} encoder layers, cross-attention, "
                  if cfg.is_encdec else "") + (
            f"{cfg.frontend} frontend of {cfg.frontend_tokens} embeddings, "
            f"head_dim {cfg.hd}, ")
    say(f"[{tag}] {cfg.name}, {cfg.n_layers} layers at full width (d "
        f"{cfg.d_model}, {mixer}{cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, experts "
        f"{cfg.n_experts} top-{cfg.n_experts_per_tok}): "
        f"{n_par / 1e9:.3f}e9 parameters; init {t_init:.1f} s, "
        f"format_params {t_fmt:.1f} s; {draft_matrices(packed)} draft_matmul "
        f"launches a draft pass, {pass_matrices(packed)} target_decode a "
        f"target pass ({packed_matrices(packed)} at the prefill)")
    say(format_line(params_nbytes(packed)).replace("[format]", f"[{tag}]"))
    extra = ({"moe_capacity_factor": cfg.n_experts / cfg.n_experts_per_tok}
             if cfg_has_moe(cfg) else {})
    return {"cfg": cfg, "cass": cass, "packed": packed, "gen": gen,
            "extra": extra, **({"plain": plain} if keep_plain else {})}


class DropCounter:
    """Sums ``aux["dropped"]`` of every ``ffn.moe`` call while active: the
    sum stays on the card and is read once, at the end (serving itself
    ignores the aux, as the reference does)."""

    def __enter__(self):
        from repro_torch.models import ffn as F
        self._module, self._moe = F, F.moe
        self.total, self.calls = None, 0

        def counted(rt, p, x):
            out, aux = self._moe(rt, p, x)
            d = aux["dropped"]
            self.total = d if self.total is None else self.total + d
            self.calls += 1
            return out, aux

        F.moe = counted
        return self

    def __exit__(self, *exc):
        self._module.moe = self._moe

    @property
    def dropped(self) -> int:
        return 0 if self.total is None else int(self.total)


def family_sched(tag: str, m: dict, args, eng: dict, kind: str,
                 rt_extra: dict | None = None, chunked: bool = False) -> int:
    """The paged ``Scheduler`` (kernels on) on phase 16's or 17's model
    ``m`` over the Engine run's prompts: launches as the passes imply
    (``pass_launches``). Without ``chunked``: first-token logits within a
    tenth of the logit rms of the Engine's one-pass prefill, tokens against
    the Engine's AR at the verify width under the near-tie rule (share
    printed). ``chunked`` (the Mamba models): ``chunked_ar_check`` holds
    the first token and the tokens to the Engine's own steps from the same
    chunked cache, and the first-token gap to the one-pass prefill is
    kept in ``eng["sched_gap"]`` for ``chunk_witness`` to gate. Returns
    the MoE drops."""
    import numpy as np
    import torch

    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    n = args.max_new
    lg = eng["lg"].numpy()
    lrms = float(np.sqrt((lg.astype(np.float64) ** 2).mean()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with DropCounter() as drops:
        sched, tokens, first, wall = serve_paged(
            cfg, packed, cass, eng["prompt"], n, attn_kernel="on",
            rt_extra=rt_extra)
    got = all_launches()
    st = sched.summary()
    del sched
    expect = pass_launches(kind, st, cfg, cass, packed)
    say(f"[{tag}] launches {got}; expected {expect}: {got == expect}")
    if got != expect:
        fail(f"{tag}: launches {got} != expected {expect}")
    gmax, grms = _logit_gap(first, lg)
    if chunked:
        eng["sched_gap"] = gmax
        say(f"[{tag}] first-token logits vs the one-pass prefill: max abs "
            f"diff {gmax:.4g}, rms {grms:.4g} (logit rms {lrms:.4g}); gated "
            f"by the f32 witness below")
        compared, cut, ref = chunked_ar_check(tag, m, eng["prompt"], first,
                                              tokens, n, rt_extra)
    else:
        say(f"[{tag}] first-token logits vs the Engine's prefill: max abs "
            f"diff {gmax:.4g}, rms {grms:.4g} (logit rms {lrms:.4g}; limit "
            f"{0.1 * lrms:.4g})")
        if not gmax < 0.1 * lrms:
            fail(f"{tag}: first-token logits differ from the Engine's by "
                 f"{gmax}")
        ref_tok, margins = eng["wide"]
        compared, cut = tau_check(tokens, ref_tok, margins, 2.0 * gmax, n,
                                  what=tag)
        ref = (f"Engine (== AR at the verify width) under tau = 2 x the "
               f"first-token gap = {2 * gmax:.3g}")
    b = tokens.shape[0]
    unified = st["cycles"] - st["prefill_cycles"] + st["mixed_cycles"]
    uni = st["bucket_wall_ms"].get("unified", {})
    say(f"[{tag}] {b} requests x {n} tokens: cycles {st['cycles']} (unified "
        f"{unified}), acceptance {st['acceptance']:.3f}, {b * n / wall:.2f} "
        f"tok/s ({wall:.1f} s), unified step {uni.get('mean_ms', 0.0):.1f} "
        f"ms; tokens == {ref} on {compared} of {b * n} positions, cut {cut}; "
        f"MoE calls {drops.calls}, dropped {drops.dropped}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return drops.dropped


def chunked_ar_check(tag: str, m: dict, prompt, first, tokens, n: int,
                     rt_extra: dict | None) -> tuple:
    """The Scheduler's prefill and tokens against the Engine's own steps
    from the same chunked cache, bit for bit: ``paged_prefill`` (the
    Engine's wide step over the same 32-token chunks) must give the
    first-token logits, and ``ar_steps`` at the verify width from its
    cache every token, those AR steps equalling one verify pass over
    their tokens (the step-by-step recurrence reaches each position's
    state as an AR step does). Returns (compared, cut, what the tokens
    were held to)."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    gamma = cass.gamma
    cache, last = paged_prefill(packed, cfg, cass, prompt, n, rt_extra)
    same = np.array_equal(first, last.float().cpu().numpy())
    rt = Runtime(cfg=cfg, cass=cass, view="target", attn_kernel="on",
                 **(rt_extra or {}))
    with torch.inference_mode():
        ar_tok, ar_lg = ar_steps(rt, packed, cache, last, n, gamma + 1)
        l_v, _ = M.forward_decode(rt, packed, ar_tok[:, :gamma + 1], cache)
    gap = (ar_lg[:, 1:gamma + 2] - l_v.float()).abs().max().item()
    del cache, l_v
    b = tokens.shape[0]
    agree = int((tokens == ar_tok.cpu().numpy()).sum())
    say(f"[{tag}] first-token logits vs the Engine's wide step over the "
        f"same {len(first)} x {CHUNK}-token chunks: bit for bit: {same}; AR "
        f"steps at the verify width {gamma + 1} from that cache vs one "
        f"verify pass: max abs diff {gap:.4g}; tokens equal on {agree} of "
        f"{b * n} positions")
    if not same:
        fail(f"{tag}: first-token logits differ from the chunked prefill's")
    if gap != 0.0 or agree != b * n:
        fail(f"{tag}: AR steps differ from the verify pass by {gap}, or "
             f"tokens agree on only {agree} of {b * n} positions")
    return agree, b * n - agree, ("AR at the verify width from the chunked "
                                  "cache, bit for bit,")


def chunk_witness(tag: str, cfg, seed: int, prompt, n: int,
                  rt_extra: dict | None, served_gap: float) -> dict:
    """Whether the Scheduler's first-token gap (its 32-token chunks against
    the Engine's one 128-token pass) is rounding. The plain model of the
    served weights (``seed`` as ``family_setup``), attention on the gather
    path: the chunked prefill (``paged_prefill``) against the one-pass
    prefill in bf16, then with every leaf and cache in f32, where rounding
    is 2^16 times finer. Gates: the f32 gap below 1e-3 of the logit rms
    (a fault in the chunk's carry would not shrink), and the served gap
    at most 3 x the bf16 one-pass prefill's own distance from the f32
    one. Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    plain = M.init_params(cfg, gen, device="cuda")
    rt = Runtime(cfg=cfg, view="plain", **(rt_extra or {}))
    b, s = prompt.shape
    out = {}
    for dt in ("bf16", "f32"):
        if dt == "f32":
            _floats_to_f32(plain)
        cache = KC.init_cache(cfg, None, b, s + 1, packed=False,
                              device="cuda")
        if dt == "f32":
            _floats_to_f32(cache)
        with torch.inference_mode():
            lg, _ = M.forward_prefill(rt, plain, {"tokens": prompt}, cache)
        del cache
        _, last = paged_prefill(plain, cfg, None, prompt, n, rt_extra,
                                attn_kernel="off", f32=dt == "f32")
        out[dt] = (lg[:, -1].double().cpu().numpy(),
                   last.double().cpu().numpy())
        torch.cuda.empty_cache()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    (o16, c16), (o32, c32) = out["bf16"], out["f32"]
    lrms = float(np.sqrt((o32 ** 2).mean()))
    res = {"g16": float(np.abs(c16 - o16).max()),
           "g32": float(np.abs(c32 - o32).max()),
           "e_one": float(np.abs(o16 - o32).max()),
           "e_chunk": float(np.abs(c16 - o32).max()), "lrms": lrms,
           "served": served_gap}
    say(f"[{tag}] chunked vs one-pass prefill, plain model of the served "
        f"weights: bf16 max abs diff {res['g16']:.4g}, f32 "
        f"{res['g32']:.4g} (limit {1e-3 * lrms:.4g} = 1e-3 x the logit rms "
        f"{lrms:.4g}); bf16 vs f32: one-pass {res['e_one']:.4g}, chunked "
        f"{res['e_chunk']:.4g}; the served gap {served_gap:.4g} (limit 3 x "
        f"{res['e_one']:.4g} = {3 * res['e_one']:.4g}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not res["g32"] < 1e-3 * lrms:
        fail(f"{tag}: in f32 the chunked prefill differs from the one-pass "
             f"prefill by {res['g32']}")
    if not served_gap <= 3 * res["e_one"]:
        fail(f"{tag}: the served first-token gap {served_gap} exceeds 3 x "
             f"the bf16 prefill's own rounding {res['e_one']}")
    return res


def bitwise_runs(tag: str, cfg, packed, cass, prompt, n: int, runs,
                 rt_extra: dict | None = None) -> dict:
    """The paged ``Scheduler`` (kernels on) once per ``runs`` entry (name,
    extra keywords); every run's tokens must equal the first's bit for
    bit. Returns {name: (tokens, MoE drops)}."""
    import numpy as np
    out = {}
    for name, kw in runs:
        with DropCounter() as drops:
            _, tokens, _, wall = serve_paged(cfg, packed, cass, prompt, n,
                                             attn_kernel="on",
                                             rt_extra=rt_extra, **kw)
        out[name] = (tokens, drops.dropped)
        say(f"[{tag}] {name}: {tokens.shape[0]} x {n} tokens in {wall:.1f} "
            f"s; MoE dropped {drops.dropped} of {drops.calls} calls' tokens")
    first = runs[0][0]
    for name, _ in runs[1:]:
        same = np.array_equal(out[name][0], out[first][0])
        say(f"[{tag}] {name} == {first}, bit for bit: {same}")
        if not same:
            fail(f"{tag}: tokens with {name} differ from {first}")
    return out


def _qwen_weights_by_shape(packed, cfg) -> dict:
    """qwen3-4b's five draft-product shapes (wq 2560 -> 4096 and wo 4096 ->
    2560 differ: n_heads x hd != d_model) and their products a pass; the
    tied unembed multiplies the bf16 table, no kernel."""
    e0, r = packed["dec"][0]["e0"], cfg.n_layers
    return {"wq": (e0["attn"]["wq"]["w"], r),
            "wk/wv": (e0["attn"]["wk"]["w"], 2 * r),
            "wo": (e0["attn"]["wo"]["w"], r),
            "w_gate/w_up": (e0["ffn"]["w_gate"]["w"], 2 * r),
            "w_down": (e0["ffn"]["w_down"]["w"], r)}


def qwen_phase(args) -> dict:
    """Phase 16a: qwen3-4b at full width, all 36 layers, C-1 (γ=3)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    m = family_setup("qwen", get_config("qwen3-4b"), args.seed + 16)
    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    by_shape = _qwen_weights_by_shape(packed, cfg)
    draft_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 17), "qwen-kernels")
    err = target_all_bitwise(packed, cass, "qwen-kernels")
    target_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 18), "qwen-kernels",
        args.requests * (cass.gamma + 1))
    eng = main_phase(packed, cfg, cass, m["gen"], args, tag="qwen")
    family_sched("qwen-sched", m, args, eng, "c1")
    del m, packed
    gc.collect()
    torch.cuda.empty_cache()
    # the bitwise serving gates at 2 layers (full width)
    m2 = family_setup("qwen-depth2", dataclasses.replace(cfg, n_layers=2),
                      args.seed + 19)
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=m2["gen"], device="cuda").to(torch.int32)
    bitwise_runs("qwen-depth2", m2["cfg"], m2["packed"], m2["cass"], prompt,
                 args.max_new, [("on", {}), ("overlap off",
                                              {"overlap": False}),
                                ("alternating", {"fused": False})])
    del m2
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[qwen] phase 16a in {time.perf_counter() - t0:.1f} s")
    return {"err": err, "eng": eng}


def moe_oracle_check(tag: str, m: dict, x, rt_extra: dict) -> float:
    """The card's ``moe`` against ``moe_reference`` (a dense loop over the
    experts) on the card, on layer 0 of the first routed group (a shared
    expert in its target view), at a capacity that drops nothing: within
    2^-7 of the output's scale (a few bf16 ulps; the combine sums the k
    experts in another order). Returns the largest absolute
    difference."""
    import torch
    from repro_torch.models import ffn as F
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import _index
    cfg = m["cfg"]
    rt = Runtime(cfg=cfg, cass=m["cass"], view="target", **rt_extra)
    gi, ekey = next((i, k) for i, g in enumerate(m["packed"]["dec"])
                    for k, e in g.items() if "moe" in e)
    p = _index(m["packed"]["dec"][gi][ekey]["moe"], 0)
    with torch.inference_mode():
        out, aux = F.moe(rt, p, x)
        ref = F.moe_reference(rt, p, x)
        ms = cuda_ms(lambda: F.moe(rt, p, x), 3)
        ref_ms = cuda_ms(lambda: F.moe_reference(rt, p, x), 1)
    scale = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    say(f"[{tag}] moe vs moe_reference on the card, {tuple(x.shape)} "
        f"tokens, capacity factor {rt.moe_capacity_factor:g}: max abs diff "
        f"{err:.3g} (limit {2 ** -7 * max(scale, 1.0):.3g}), dropped "
        f"{int(aux['dropped'])}; moe {ms:.2f} ms, the dense loop "
        f"{ref_ms:.2f} ms (CUDA events)")
    if int(aux["dropped"]) != 0 or not err <= 2 ** -7 * max(scale, 1.0):
        fail(f"{tag}: moe differs from moe_reference by {err}")
    return err


def dbrx_phase(args) -> dict:
    """Phase 16b: DBRX at full width cut to 2 layers (16 experts, top-4),
    C-1 (γ=3)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=2)
    m = family_setup("dbrx", cfg, args.seed + 20)
    cass, packed, extra = m["cass"], m["packed"], m["extra"]
    e0, r = packed["dec"][0]["e0"], cfg.n_layers
    by_shape = {"wq/wo": (e0["attn"]["wq"]["w"], 2 * r),
                "wk/wv": (e0["attn"]["wk"]["w"], 2 * r),
                "lm_head": (packed["lm_head"]["w"], 1)}
    draft_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 21), "dbrx-kernels")
    err = target_all_bitwise(packed, cass, "dbrx-kernels")
    target_shapes(by_shape, cass, torch.Generator(device="cuda").manual_seed(
        args.seed + 22), "dbrx-kernels", args.requests * (cass.gamma + 1))
    x = (torch.randn((args.requests, CHUNK, cfg.d_model),
                     generator=m["gen"], device="cuda") * 0.5).to(
        torch.bfloat16)
    moe_oracle_check("dbrx", m, x, extra)
    with DropCounter() as drops:
        eng = main_phase(packed, cfg, cass, m["gen"], args, tag="dbrx",
                         rt_extra=extra)
    say(f"[dbrx] Engine runs at capacity factor "
        f"{extra['moe_capacity_factor']:g}: {drops.calls} MoE calls, "
        f"dropped {drops.dropped}")
    if drops.dropped:
        fail(f"dbrx: {drops.dropped} tokens dropped at a capacity that "
             f"cannot overflow")
    dropped = family_sched("dbrx-sched", m, args, eng, "c1",
                           rt_extra=extra)
    runs = bitwise_runs("dbrx-sched", cfg, packed, cass, eng["prompt"],
                        args.max_new, [("on", {}), ("overlap off",
                                                     {"overlap": False}),
                                       ("alternating", {"fused": False})],
                        rt_extra=extra)
    if dropped or any(d for _, d in runs.values()):
        fail("dbrx-sched: tokens dropped at a capacity that cannot overflow")
    # the reference's default capacity: overflow couples rows, so only
    # the drops are reported, and how many tokens still agree
    with DropCounter() as drops:
        _, tokens, _, wall = serve_paged(cfg, packed, cass, eng["prompt"],
                                         args.max_new, attn_kernel="on")
    same = int((tokens == runs["on"][0]).sum())
    say(f"[dbrx-sched] default capacity factor 1.25: {drops.calls} MoE "
        f"calls dropped {drops.dropped} token assignments; tokens equal to "
        f"the no-overflow run at {same} of {tokens.size} positions "
        f"({wall:.1f} s)")
    del m, packed
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[dbrx] phase 16b in {time.perf_counter() - t0:.1f} s")
    return {"err": err, "eng": eng}


def deepseek_moe_phase(args) -> dict:
    """Phase 16c: DeepSeek-V3 at full width cut to 4 layers (its 3 dense
    layers and 1 routed layer: 256 experts, top-8, a shared expert), MLA,
    C-1 (γ=3)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)
    m = family_setup("ds-moe", cfg, args.seed + 23)
    cass, packed, extra = m["cass"], m["packed"], m["extra"]
    shared = packed["dec"][1]["e0"]["moe"]["shared"]
    by_shape = {"shared gate/up": (shared["w_gate"]["w"], 2),
                "shared down": (shared["w_down"]["w"], 1)}
    draft_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 24), "ds-moe-kernels")
    err = target_all_bitwise(packed, cass, "ds-moe-kernels")
    target_shapes(by_shape, cass, torch.Generator(device="cuda").manual_seed(
        args.seed + 25), "ds-moe-kernels", args.requests * (cass.gamma + 1))
    x = (torch.randn((args.requests, cass.gamma + 1, cfg.d_model),
                     generator=m["gen"], device="cuda") * 0.5).to(
        torch.bfloat16)
    moe_oracle_check("ds-moe", m, x, extra)
    with DropCounter() as drops:
        eng = main_phase(packed, cfg, cass, m["gen"], args, tag="ds-moe",
                         rt_extra=extra)
    say(f"[ds-moe] Engine runs at capacity factor "
        f"{extra['moe_capacity_factor']:g}: {drops.calls} MoE calls, "
        f"dropped {drops.dropped}")
    if drops.dropped:
        fail(f"ds-moe: {drops.dropped} tokens dropped at a capacity that "
             f"cannot overflow")
    family_sched("ds-moe-sched", m, args, eng, "mla", rt_extra=extra)
    del m, packed
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[ds-moe] phase 16c in {time.perf_counter() - t0:.1f} s")
    return {"err": err, "eng": eng}


# ---------------------------------------------------------------------------
# Phase 17: the Mamba-1 family (falcon-mamba-7b) and the Jamba hybrid
# ---------------------------------------------------------------------------

def _ssm_weights_by_shape(packed, cfg) -> dict:
    """A Mamba model's packed mixer products per shape (layer group 0's
    first Mamba entry; products a pass: one per Mamba layer; all four at
    full width) and its lm_head."""
    from repro_torch.configs import layer_groups
    mixers = sum(g.repeats * sum(e[0] == "s" for e in g.entries)
                 for g in layer_groups(cfg))
    ssm = next(e["ssm"] for e in packed["dec"][0].values() if "ssm" in e)
    out = {nm: (ssm[nm]["w"], mixers)
           for nm in ("in_proj", "x_proj", "dt_proj", "out_proj")
           if isinstance(ssm[nm]["w"], dict)}   # dt_proj: packed from 64 in
    out["lm_head"] = (packed["lm_head"]["w"], 1)
    return out


def ssm_state_bytes(cfg) -> int:
    """Bytes of one row's recurrent state: every Mamba layer's conv window
    (bf16) and h (f32), as ``kvcache.ssm_state_specs`` lays them out."""
    from repro_torch.configs import layer_groups
    from repro_torch.serving import kvcache as KC
    total = 0
    for g in layer_groups(cfg):
        for e in g.entries:
            if e[0] == "s":
                for shape, dtype in KC.ssm_state_specs(
                        cfg, g.repeats, 1).values():
                    total += math.prod(shape) * dtype.itemsize
    return total


def scan_ms(m: dict, prompt, reps: int = 3) -> dict:
    """The Mamba recurrence's device time a pass (CUDA events around every
    ``ssm._selective_scan`` call, summed over the layers), beside the
    pass's own host-timed wall: a verify pass (width γ+1, the committed
    state) and a draft pass (width 1, the draft scratch) from the
    prefilled cache of ``prompt``; the median of ``reps``."""
    import dataclasses

    import torch
    from repro_torch.models import model as M, ssm as SS
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import engine as E, kvcache as KC
    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    gamma = cass.gamma
    rt = Runtime(cfg=cfg, cass=cass, view="target", **m["extra"])
    b, s = prompt.shape
    spans = []
    inner = SS._selective_scan

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    def one(fn):
        spans.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return sum(a.elapsed_time(z) for a, z in spans), wall, len(spans)

    cache = KC.init_cache(cfg, cass, b, s + gamma + 2, packed=True,
                          device="cuda")
    out = {}
    SS._selective_scan = timed
    try:
        with torch.inference_mode():
            _, cache = M.forward_prefill(rt, packed, {"tokens": prompt},
                                         cache)
            cur = prompt[:, -1:]
            rt_d = dataclasses.replace(rt, view="draft")
            passes = {
                "verify": lambda: M.forward_decode(
                    rt, packed, cur.expand(-1, gamma + 1).contiguous(),
                    cache),
                "draft": lambda: M.forward_decode(
                    rt_d, packed, cur, cache,
                    scratch=E.make_scratch(cfg, cache, gamma),
                    scratch_len=0)}
            for name, fn in passes.items():
                fn()
                runs = sorted(one(fn) for _ in range(reps))
                out[name] = runs[reps // 2]
    finally:
        SS._selective_scan = inner
    return out


def ssm_engine(tag: str, m: dict, args) -> dict:
    """Phase 6's Engine gates on a Mamba model, exact (``main_phase``
    with ``exact=True``): spec tokens equal AR at the verify width on
    every position; then the recurrence's time a pass and the state's
    bytes a row."""
    with DropCounter() as drops:
        eng = main_phase(m["packed"], m["cfg"], m["cass"], m["gen"], args,
                         tag=tag, rt_extra=m["extra"], exact=True)
    if drops.dropped:
        fail(f"{tag}: {drops.dropped} tokens dropped at a capacity that "
             f"cannot overflow")
    sc = scan_ms(m, eng["prompt"])
    (v_ms, v_wall, v_n), (d_ms, d_wall, d_n) = sc["verify"], sc["draft"]
    say(f"[{tag}] the recurrence (ssm._selective_scan, CUDA events, median "
        f"of 3): verify pass (width {m['cass'].gamma + 1}) {v_ms:.3f} ms "
        f"over {v_n} layers of a {v_wall:.1f} ms pass; draft pass (width 1) "
        f"{d_ms:.3f} ms of {d_wall:.1f} ms; SSM state "
        f"{ssm_state_bytes(m['cfg']) / 2**20:.2f} MiB a row; MoE calls "
        f"{drops.calls}, dropped {drops.dropped}")
    eng["scan"] = sc
    return eng


def ssm_refusals(tag: str, cfg) -> None:
    """The prefix cache and swap raise the reference's ``ValueError`` for
    an SSM model."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.scheduler import Scheduler
    for what, kw in (("prefix cache", {"prefix_cache": True}),
                     ("swap", {"swap": True})):
        try:
            Scheduler(cfg, None, ecfg=EngineConfig(gamma=3), num_slots=2,
                      s_max=64, paged=True, block_size=4, chunk_size=4,
                      device="cuda", **kw)
        except ValueError as e:
            say(f"[{tag}] {what} refused: {e}")
            continue
        fail(f"{tag}: the {what} was not refused for {cfg.name}")


def stable_draft_check(tag: str, cfg, seed: int, args,
                       rt_extra: dict) -> None:
    """The plain model (no Cassandra). With the shape-stable draft it
    accepts every draft: each draft pass re-feeds the prefix from the
    committed state at the verify width (reference ``tests/test_serving.py``'s
    ``test_plain_stable_draft_bitwise_acceptance``). With the scratch
    draft, one cycle's γ draft tokens and logits equal γ AR steps at width
    1 from the same prefilled cache, bit for bit: the same ops at the same
    M, so draft step i must read the state step i-1 left in the scratch."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import Engine, EngineConfig, _run_drafts
    gen = torch.Generator(device="cuda").manual_seed(seed)
    plain = M.init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=gen, device="cuda").to(torch.int32)
    eng = Engine(cfg, plain, cass=None,
                 ecfg=EngineConfig(gamma=3, stable_draft=True),
                 device="cuda", rt_extra=rt_extra)
    t0 = time.perf_counter()
    _, st = eng.generate({"tokens": prompt}, max_new=args.max_new)
    say(f"[{tag}] plain model, stable draft: acceptance {st['acceptance']} "
        f"over {st['cycles']} cycles ({time.perf_counter() - t0:.1f} s)")
    if st["acceptance"] != 1.0:
        fail(f"{tag}: the plain stable draft accepted {st['acceptance']}")
    eng = Engine(cfg, plain, cass=None, ecfg=EngineConfig(gamma=3),
                 device="cuda", rt_extra=rt_extra)
    rt_t = dataclasses.replace(eng.rt, view="target")
    cache = KC.init_cache(cfg, None, prompt.shape[0], prompt.shape[1] + 5,
                          packed=False, device="cuda")
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt_t, plain, {"tokens": prompt}, cache)
        toks, logits = ar_steps(rt_t, plain, cache, lg[:, -1], 4, 1)
        drafts, dlogits = _run_drafts(eng.rt, plain, cache, toks[:, :1],
                                      eng.ecfg)
    same_tok = torch.equal(drafts, toks[:, 1:])
    same_lg = all(torch.equal(d.float(), logits[:, i + 1])
                  for i, d in enumerate(dlogits))
    say(f"[{tag}] plain model, scratch draft: {len(dlogits)} draft steps vs "
        f"AR steps at width 1 from the same cache: tokens bit for bit "
        f"{same_tok}, logits bit for bit {same_lg}")
    if not (same_tok and same_lg):
        fail(f"{tag}: the scratch draft chain differs from width-1 AR steps")
    del eng, plain, cache
    gc.collect()
    torch.cuda.empty_cache()


def mamba_phase(args) -> dict:
    """Phase 17a: falcon-mamba-7b at full width, all 64 layers, C-1
    (γ=3)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = family_setup("mamba", get_config("falcon-mamba-7b"), args.seed + 26)
    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    by_shape = _ssm_weights_by_shape(packed, cfg)
    draft_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 27), "mamba-kernels")
    err = target_all_bitwise(packed, cass, "mamba-kernels")
    target_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 28), "mamba-kernels",
        args.requests * (cass.gamma + 1))
    eng = ssm_engine("mamba", m, args)
    family_sched("mamba-sched", m, args, eng, "c1", rt_extra=m["extra"],
                 chunked=True)
    ssm_refusals("mamba", cfg)
    del m, packed
    gc.collect()
    torch.cuda.empty_cache()
    wit = chunk_witness("mamba-witness", cfg, args.seed + 26, eng["prompt"],
                        args.max_new, {}, eng["sched_gap"])
    # the bitwise serving gates at 2 layers (full width)
    m2 = family_setup("mamba-depth2", dataclasses.replace(cfg, n_layers=2),
                      args.seed + 29)
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=m2["gen"], device="cuda").to(torch.int32)
    bitwise_runs("mamba-depth2", m2["cfg"], m2["packed"], m2["cass"], prompt,
                 args.max_new, [("on", {}), ("overlap off",
                                              {"overlap": False}),
                                ("alternating", {"fused": False})],
                 rt_extra=m2["extra"])
    del m2
    gc.collect()
    torch.cuda.empty_cache()
    stable_draft_check("mamba-depth2", dataclasses.replace(cfg, n_layers=2),
                       args.seed + 30, args, {})
    say(f"[mamba] phase 17a in {time.perf_counter() - t0:.1f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    return {"err": err, "eng": eng, "witness": wit}


def jamba_phase(args) -> dict:
    """Phase 17b: jamba-v0.1-52b at full width cut to one 8-layer period
    (7 Mamba mixers, 1 GQA layer, 4 dense and 4 MoE FFNs of 16 experts,
    top-2), C-1 (γ=3), at the no-overflow capacity."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    m = family_setup("jamba", cfg, args.seed + 31)
    cass, packed, extra = m["cass"], m["packed"], m["extra"]
    # the mixers' shapes are falcon-mamba's, the attention and dense FFN
    # Llama-3-8B's: only the vocabulary is new
    by_shape = {"lm_head": (packed["lm_head"]["w"], 1)}
    draft_shapes(by_shape, cass, torch.Generator(
        device="cuda").manual_seed(args.seed + 32), "jamba-kernels")
    err = target_all_bitwise(packed, cass, "jamba-kernels")
    target_shapes(by_shape, cass, torch.Generator(device="cuda").manual_seed(
        args.seed + 33), "jamba-kernels", args.requests * (cass.gamma + 1))
    x = (torch.randn((args.requests, CHUNK, cfg.d_model),
                     generator=m["gen"], device="cuda") * 0.5).to(
        torch.bfloat16)
    moe_oracle_check("jamba", m, x, extra)
    eng = ssm_engine("jamba", m, args)
    dropped = family_sched("jamba-sched", m, args, eng, "c1",
                           rt_extra=extra, chunked=True)
    runs = bitwise_runs("jamba-sched", cfg, packed, cass, eng["prompt"],
                        args.max_new, [("on", {}), ("overlap off",
                                                     {"overlap": False}),
                                       ("alternating", {"fused": False})],
                        rt_extra=extra)
    if dropped or any(d for _, d in runs.values()):
        fail("jamba-sched: tokens dropped at a capacity that cannot "
             "overflow")
    ssm_refusals("jamba", cfg)
    del m, packed
    gc.collect()
    torch.cuda.empty_cache()
    wit = chunk_witness("jamba-witness", cfg, args.seed + 31, eng["prompt"],
                        args.max_new, extra, eng["sched_gap"])
    stable_draft_check("jamba", cfg, args.seed + 34, args, extra)
    say(f"[jamba] phase 17b in {time.perf_counter() - t0:.1f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    return {"err": err, "eng": eng, "witness": wit}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 18: the encoder-decoder audio family and the vision frontend
# ---------------------------------------------------------------------------

def _encdec_weights_by_shape(packed, cfg) -> dict:
    """A decode pass's products per shape: every attention projection
    (whisper: self-attention's four and cross-attention's wq and wo; its
    cross wk / wv run at the prefill only), the FFN's and lm_head
    (whisper's 1024 -> 51865: an odd N)."""
    e0, r = packed["dec"][0]["e0"], cfg.n_layers
    ffn = e0["ffn"]
    out = {"attn": (e0["attn"]["wq"]["w"],
                    (6 if cfg.cross_attention else 4) * r)}
    if "w_gate" in ffn:
        out["w_gate/w_up"] = (ffn["w_gate"]["w"], 2 * r)
    else:
        out["w_up"] = (ffn["w_up"]["w"], r)
    out["w_down"] = (ffn["w_down"]["w"], r)
    out["lm_head"] = (packed["lm_head"]["w"], 1)
    return out


def _frontend_embeds(cfg, b: int, gen) -> dict:
    """The frontend stub's input for ``b`` requests: frame (audio) or
    patch (vision) embeddings, N(0, 1) in bf16 from ``gen``."""
    import torch
    key = "frame_embeds" if cfg.frontend == "audio" else "patch_embeds"
    return {key: torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                             generator=gen, device="cuda").to(torch.bfloat16)}


def encdec_refusals(tag: str, m: dict) -> None:
    """The reference's refusals: the Scheduler takes token prompts only
    (any frontend), a paged cache holds no cross-attention stores."""
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.scheduler import Scheduler
    cfg, cass = m["cfg"], m["cass"]
    checks = [("Scheduler", "scheduler admission is token-prompt only for "
               "now", lambda: Scheduler(cfg, m["packed"], cass=cass,
                                        device="cuda"))]
    if cfg.cross_attention:
        checks.append(("init_paged_cache", "paged caches do not support "
                       "cross-attention stores yet",
                       lambda: KC.init_paged_cache(cfg, cass, 2, 9, 16, 4,
                                                   True, device="cuda")))
    for what, text, make in checks:
        try:
            make()
        except NotImplementedError as e:
            if str(e) != text:
                fail(f"{tag}: {what} refused with {str(e)!r}, not the "
                     f"reference's {text!r}")
            say(f"[{tag}] {what} refused, as the reference: {text!r}")
        else:
            fail(f"{tag}: {what} did not refuse {cfg.name}")


def plain_first_token(tag: str, m: dict, prompt: dict, lg) -> float:
    """The plain model's first-token logits (bf16 weights, a plain cache)
    against the packed target view's (``lg``, the Engine run's prefill):
    phase 7's rule, max abs diff < 0.1 x the logit rms. Returns the
    gap."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC
    cfg = m["cfg"]
    b, s = prompt["tokens"].shape
    s_total = s + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    cache = KC.init_cache(cfg, None, b, s_total + 1, packed=False,
                          device="cuda")
    with torch.inference_mode():
        lp, _ = M.forward_prefill(Runtime(cfg=cfg, view="plain"),
                                  m["plain"], prompt, cache)
    del cache
    ref = lg.numpy().astype(np.float64)
    gap = float(np.abs(lp[:, -1].double().cpu().numpy() - ref).max())
    lrms = float(np.sqrt((ref ** 2).mean()))
    say(f"[{tag}] first-token logits, packed target view vs the plain "
        f"model: max abs diff {gap:.4g} (limit {0.1 * lrms:.4g} = 0.1 x the "
        f"logit rms {lrms:.4g})")
    if not gap < 0.1 * lrms:
        fail(f"{tag}: the packed target view's first-token logits differ "
             f"from the plain model's by {gap}")
    return gap


def cross_kv_check(tag: str, m: dict, prompt: dict, n: int) -> int:
    """whisper's cross K/V: the prefill writes them (bit for bit the
    xattn projections of the encoder output, first and last layer, plain
    bf16), and speculative cycles until every row holds ``n`` tokens
    leave their bits unchanged. Returns the cycles run."""
    import torch
    from repro_torch.models import attention as A, model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import engine as E, kvcache as KC
    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    b, s = prompt["tokens"].shape
    ecfg = E.EngineConfig(gamma=cass.gamma)
    rt = Runtime(cfg=cfg, cass=cass, view="target")
    cache = KC.init_cache(cfg, cass, b, s + n + cass.gamma + 1, packed=True,
                          device="cuda")
    with torch.inference_mode():
        lg, cache = M.forward_prefill(rt, packed, prompt, cache)
        enc = M._run_encoder(rt, packed, prompt["frame_embeds"])
        cross = cache["cross"][0]["e0"]
        for r in (0, cfg.n_layers - 1):
            ck, cv = A.gqa_project_kv(
                rt, M._index(packed["dec"][0]["e0"]["xattn"], r), enc, None,
                "xattn")
            if not (_same_bits(ck, cross["ck"][r])
                    and _same_bits(cv, cross["cv"][r])):
                fail(f"{tag}: the cached cross K/V of layer {r} differ from "
                     f"the projections of the encoder output")
        del enc
        before = {k: t.clone() for k, t in cross.items()}
        cur = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        held, cycles = torch.ones(b, dtype=torch.int64), 0
        while int(held.min()) < n:
            res, cache = E.spec_decode_step(rt, packed, cache, cur, ecfg)
            cur = res.next_token[:, None]
            held += res.n_accepted.cpu().to(torch.int64) + 1
            cycles += 1
    same = all(_same_bits(cache["cross"][0]["e0"][k], before[k])
               for k in before)
    say(f"[{tag}] cross K/V ({tuple(before['ck'].shape)} x 2, bf16, "
        f"{2 * before['ck'].numel() * 2 / 2**20:.1f} MiB): written at the "
        f"prefill as the xattn projections of the encoder output, bit for "
        f"bit; unchanged after {cycles} speculative cycles: {same}")
    if not same:
        fail(f"{tag}: the cross K/V changed after the prefill")
    return cycles


def d96_codec_rows(m: dict, prompt: dict, gen) -> list:
    """kv_topk, kv_encode and kv_view (draft, target) at d = 96 on the
    prefill's layer-0 K and V (patches and text) and on edge rows (ties,
    +-0, NaN payloads, inf, subnormals, a 2^+-12 spread), bit for bit
    against their plain versions."""
    import torch
    from repro_torch.models import attention as A, layers as L, model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC
    cfg, cass, packed = m["cfg"], m["cass"], m["packed"]
    d = cfg.hd
    rt = Runtime(cfg=cfg, cass=cass, view="target")
    p0 = M._index(packed["dec"][0]["e0"], 0)
    with torch.inference_mode():
        x = M._embed_inputs(rt, packed, prompt["tokens"],
                            prompt.get("patch_embeds"))
        x = L.norm(rt, p0["norm1"], x)
        k, v = A.gqa_project_kv(rt, p0["attn"], x, torch.arange(
            x.shape[1], device="cuda"))
    del x
    book = KC.default_kv_codebook("cuda")
    rows = []
    for case, t in (("d96 prefill K (layer 0)", k),
                    ("d96 prefill V (layer 0)", v),
                    ("d96 edge rows", edge_rows(gen, 4096, d))):
        rows += kv_codec_rows(cass, t, d, case, book)
    return rows


def encdec_model(tag: str, cfg, seed: int, args) -> dict:
    """One model of phase 18, C-1 (γ=3), from ``seed``: ``draft_matmul``
    and ``target_decode`` per shape on its own weights, every packed
    matrix's target view bit for bit (whisper's lm_head among them), at
    d = 96 the KV codec's rows; the Engine on 4 requests with the
    frontend's embeddings (``main_phase``, exact: spec == AR at the
    verify width on every position), the packed target view's first
    tokens against the plain model, the refusals, and (whisper) the cross
    K/V written once. Frees the model."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = family_setup(tag, cfg, seed, keep_plain=True)
    cass, packed = m["cass"], m["packed"]
    kgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    by_shape = _encdec_weights_by_shape(packed, cfg)
    draft = draft_shapes(by_shape, cass, kgen, f"{tag}-kernels")
    err = target_all_bitwise(packed, cass, f"{tag}-kernels")
    target = target_shapes(by_shape, cass, kgen, f"{tag}-kernels",
                           args.requests * (cass.gamma + 1))
    embeds = _frontend_embeds(cfg, args.requests, m["gen"])
    eng = main_phase(packed, cfg, cass, m["gen"], args, tag=tag, exact=True,
                     embeds=embeds)
    prompt = {"tokens": eng["prompt"], **embeds}
    gap = plain_first_token(tag, m, prompt, eng["lg"])
    del m["plain"]
    gc.collect()
    torch.cuda.empty_cache()
    codec = (d96_codec_rows(m, prompt, kgen) if cfg.hd == 96 else [])
    if cfg.cross_attention:
        cross_kv_check(tag, m, prompt, args.max_new)
    encdec_refusals(tag, m)
    del m, packed
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] {cfg.name} in {wall:.1f} s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    return {"err": max(err, draft["max_abs_err"]), "eng": eng,
            "codec": codec, "gap": gap, "wall": wall, "peak": peak,
            "target": target, "draft": draft}


def encdec_phase(args) -> dict:
    """Phase 18: whisper-medium at full width (24 + 24 layers, 1500
    frames) and phi-3-vision-4.2b at full width (32 layers, head_dim 96,
    256 patches), one after the other."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = {"whisper": encdec_model("whisper", get_config("whisper-medium"),
                                   args.seed + 40, args),
           "phi3v": encdec_model("phi3v", get_config("phi-3-vision-4.2b"),
                                 args.seed + 42, args)}
    say(f"[encdec] phase 18 in {time.perf_counter() - t0:.1f} s (peak "
        f"{max(v['peak'] for v in out.values()) / 2**30:.2f} GiB); launches "
        f"of the Engine runs: " + "; ".join(
            f"{k} {v['eng']['launches']} draft_matmul, "
            f"{v['eng']['codec']['target_decode']} target_decode, "
            f"{v['eng']['codec']['kv_view']} kv_view, "
            f"{v['eng']['codec']['kv_encode']} kv_encode"
            for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# Phase 19: training, then serving the trained model
# ---------------------------------------------------------------------------

TRAIN_TOKENS = 1024                # phase 19a: batch 1 x 1024 tokens
TRAIN_STEPS = 4
SMOKE_RECIPE = dict(steps=300, lr=1e-3, warmup=20, seq=64, batch=8, seed=0)


def _train_tree_bits(tree) -> list:
    """Every leaf of a tensor tree in tree order as integer bits on the
    host (bf16 as int16)."""
    import torch
    from repro_torch.core.tree import tree_leaves
    return [(t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
            .detach().cpu() for t in tree_leaves(tree)]


def _same_tree(a, b) -> bool:
    import torch
    x, y = _train_tree_bits(a), _train_tree_bits(b)
    return len(x) == len(y) and all(
        u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v)
        for u, v in zip(x, y))


def train_full_phase(args) -> dict:
    """Phase 19a: Llama-3-8B at full width (``--layers``, 32 by default),
    int8 moments, ``remat="full"``, 4 ``train_step``s on batch 1 x 1024
    tokens of the synthetic stream from random weights. Gates: every
    step's loss and grad norm finite; step 0's CE equal to the f32 CE of
    ``forward_train``'s full logits on the same batch within 1e-3
    relative (``_chunked_ce`` at V = 128256); the peak at most 70 GiB.
    Each step is timed with CUDA events, split into forward + backward
    (``grads_fn``) and the update (``apply_updates``): ``train_step`` is
    exactly the two."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _one_batch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.training import optim as O
    from repro_torch.training import trainer as T

    cfg = get_config("llama3-8b")
    if args.layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 60)
    params = M.init_params(cfg, gen, device="cuda")
    tcfg = T.TrainConfig(opt=O.OptConfig(state_dtype="int8", lr=1e-4,
                                         warmup_steps=1,
                                         total_steps=TRAIN_STEPS))
    opt = O.init_opt_state(params, tcfg.opt)
    rt = Runtime(cfg=cfg, remat=True, remat_policy="full")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_TOKENS,
                      global_batch=1, seed=args.seed)
    n_par = sum(t.numel() for t in O.tree_leaves(params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in O.tree_leaves(opt))
    torch.cuda.synchronize()
    say(f"[train] {cfg.name} {cfg.n_layers} layers at full width: "
        f"{n_par / 1e9:.3f}e9 parameters ({n_par * 2 / 1e9:.2f} GB bf16), "
        f"int8 moments + scales {state_bytes / 1e9:.2f} GB; remat full; "
        f"batch 1 x {TRAIN_TOKENS} tokens; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # the unfused f32 CE of step 0's batch, before any update
    batch = _one_batch(dcfg, 0, "cuda")
    with torch.no_grad():
        logits, _ = M.forward_train(rt, params, batch)
        lg = logits[:, :-1]
        lse = torch.logsumexp(lg, -1)
        gold = torch.gather(lg, -1, batch["labels"][:, 1:, None].long())[
            ..., 0]
        ce_full = (lse - gold).mean().item()
        z_full = lse.square().mean().item()
    del logits, lg, lse, gold
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    rows = []
    for step in range(TRAIN_STEPS):
        batch = _one_batch(dcfg, step, "cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        grads, metrics = T.grads_fn(rt, params, batch, tcfg)
        ev[1].record()
        params, opt, om = O.apply_updates(params, grads, opt, tcfg.opt)
        ev[2].record()
        del grads
        torch.cuda.synchronize()
        loss, gn = metrics["loss"].item(), om["grad_norm"].item()
        fb, up = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        rows.append({"loss": loss, "ce": metrics["ce"].item(), "gn": gn,
                     "fb_ms": fb, "upd_ms": up})
        say(f"[train] step {step}: loss {loss:.5f} (ce "
            f"{metrics['ce'].item():.5f}, z {metrics['z'].item():.3f}), "
            f"grad norm {gn:.4f}, lr {om['lr'].item():.3g}; "
            f"{fb + up:.1f} ms = forward + backward {fb:.1f} + update "
            f"{up:.1f}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            fail(f"train: step {step} loss {loss} / grad norm {gn} not "
                 f"finite")
    peak = torch.cuda.max_memory_allocated()
    rel = abs(rows[0]["ce"] - ce_full) / abs(ce_full)
    say(f"[train] step 0's fused chunked CE {rows[0]['ce']:.6f} vs the f32 "
        f"CE of forward_train's full logits {ce_full:.6f} (z {z_full:.3f}):"
        f" relative gap {rel:.3g} (limit 1e-3)")
    if not rel <= 1e-3:
        fail(f"train: fused CE {rows[0]['ce']} vs full-logit CE {ce_full}")
    steady = rows[1:]
    fb = sum(r["fb_ms"] for r in steady) / len(steady)
    up = sum(r["upd_ms"] for r in steady) / len(steady)
    say(f"[train] steps 1-{TRAIN_STEPS - 1}: {fb + up:.1f} ms a step = "
        f"forward + backward {fb:.1f} ms + update {up:.1f} ms "
        f"({TRAIN_TOKENS / ((fb + up) / 1e3):.0f} tokens/s); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB (limit 70)")
    if peak > 70 * 2**30:
        fail(f"train: peak {peak / 2**30:.2f} GiB above 70 GiB")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "peak": peak, "step_ms": fb + up, "fb_ms": fb,
            "upd_ms": up, "ce_rel": rel}


def train_smoke_vs_cpu(seed: int, card: str = "cuda") -> dict:
    """Phase 19b (2): one SMOKE ``train_step`` on ``card`` against the same
    step on the CPU (see ``train_depth_phase``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_unflatten
    from repro_torch.data.pipeline import DataConfig, _one_batch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.training import optim as O
    from repro_torch.training import trainer as T

    cfg = get_config("llama3-8b", smoke=True)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    tcfg = T.TrainConfig(opt=O.OptConfig(lr=1e-3, warmup_steps=1))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    out = {}
    for dev in ("cpu", card):
        p = _tree_to(cpu, dev, clone=True)
        g, m = T.grads_fn(Runtime(cfg=cfg), p, _one_batch(dcfg, 0, dev),
                          tcfg)
        graw = [x.cpu() for x in O.tree_leaves(g)]
        p, opt, _ = O.apply_updates(p, g, O.init_opt_state(p, tcfg.opt),
                                    tcfg.opt)
        host = lambda t: [x.float().cpu() for x in O.flat_up_to(p, t)]
        out[len(out)] = (m["loss"].item(), host(g), host(p), host(opt["m"]),
                         host(opt["v"]), graw)
    (lc, g_cpu, _, mc, vc, _), (lg, g_card, pg, mg, vg, graw) = (
        out[0], out[1])
    # the CPU's optimizer on the card's own gradients, same parameters
    p = _tree_to(cpu, "cpu", clone=True)
    p, opt, _ = O.apply_updates(p, tree_unflatten(p, graw),
                                O.init_opt_state(p, tcfg.opt), tcfg.opt)
    pr, mr, vr = (host(p), host(opt["m"]), host(opt["v"]))
    lrel = abs(lg - lc) / abs(lc)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    grel = max(rel(a, b) for a, b in zip(g_card, g_cpu))
    gcos = min((a.double() * b.double()).sum().item()
               / (a.double().norm() * b.double().norm()).item()
               for a, b in zip(g_card, g_cpu))
    mrel = max(rel(a, b) for a, b in zip(mg, mc))
    vrel = max(rel(a, b) for a, b in zip(vg, vc))
    # the card's update against the reference update, element by element:
    # new params within one ulp of max(|p_old|, |p_new|) in the leaf's
    # dtype plus 2^-20 of the step (the global norm sums in another order,
    # so the step's f32 roundings fall elsewhere), fp32 moments within
    # 2^-20 of themselves; a missing or sign-flipped update is lr off
    ulps, mom, kept, moved = 0.0, 0.0, 0, 0
    for p0, new, want, dt, g in zip(O.tree_leaves(cpu), pg, pr,
                                    [x.dtype for x in O.tree_leaves(cpu)],
                                    g_card):
        p0 = p0.float()
        big = torch.maximum(p0.abs(), torch.maximum(new.abs(), want.abs()))
        _, e = torch.frexp(torch.clamp(big, min=torch.finfo(dt).tiny))
        ulp = torch.ldexp(torch.ones_like(big),
                          e - (8 if dt == torch.bfloat16 else 24))
        ulps = max(ulps, ((new - want).abs()
                          / (ulp + 2 ** -20 * (want - p0).abs())).max()
                   .item())
        keep = g.abs() > 0.1 * g.square().mean().sqrt()
        kept += int(keep.sum())
        moved += int((new != p0)[keep].sum())
    for a, b in zip(mg + vg, mr + vr):
        mom = max(mom, ((a - b).abs() / (2 ** -20 * b.abs())).nan_to_num(
            0.0, posinf=float("inf")).max().item())
    say(f"[train-smoke] one train_step, card vs CPU: loss {lg:.6f} vs "
        f"{lc:.6f} (relative {lrel:.3g}, limit 1e-3); grads worst leaf "
        f"relative {grel:.4f} (limit 0.05), cosine {gcos:.5f} (limit "
        f"0.99); moments m {mrel:.4f} (limit 0.05), v {vrel:.4f} (limit "
        f"0.1); against the CPU's update on the card's gradients: new "
        f"params worst {ulps:.3f} of (1 ulp + 2^-20 of the step), moments "
        f"worst {mom:.3f} of 2^-20 of themselves (limits 1); moved "
        f"{moved / max(kept, 1):.4f} of the elements with |g| above a tenth "
        f"of the leaf's rms (limit 0.9)")
    if not (lrel <= 1e-3 and grel <= 0.05 and gcos >= 0.99 and mrel <= 0.05
            and vrel <= 0.1 and ulps <= 1 and mom <= 1
            and moved >= 0.9 * kept):
        fail("train-smoke: the card's train_step differs from the CPU's")
    return {"loss_rel": lrel, "grad_rel": grel, "m_rel": mrel,
            "v_rel": vrel, "ulps": ulps, "moment_gap": mom}


def train_depth_phase(args) -> dict:
    """Phase 19b: (1) Llama-3-8B at full width cut to 2 layers: the
    gradients of ``accum_steps=2`` over one 512-token microbatch repeated
    against one pass over it, within the reference's tolerance (rtol
    2e-2, atol 2e-4; bit for bit printed); the fp32 and int8 updates from
    one gradient, cosine > 0.99. (2) SMOKE width: one ``train_step`` on
    the card against the same step on the CPU (plain path), fp32 moments,
    lr 1e-3: the loss within 1e-3 relative; each gradient leaf within a
    relative error of 0.05 and a cosine of 0.99 (bf16 activations round
    at other places: cuBLAS sums in another order); the moments m within
    0.05 and v (the gradient squared) within 0.1 relative; and the card's
    optimizer against the CPU's on the card's own gradients, element by
    element: the new parameters within one ulp of max(|p_old|, |p_new|)
    plus 2^-20 of the step, the moments within 2^-20 of themselves, at
    least 90% of the elements whose gradient is above a tenth of its
    leaf's rms moved (a missing or sign-flipped update is lr off)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _one_batch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.training import optim as O
    from repro_torch.training import trainer as T

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 61)
    params = M.init_params(cfg, gen, device="cuda")
    rt = Runtime(cfg=cfg, remat=True)
    one = _one_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                                global_batch=1, seed=args.seed), 0,
                     "cuda")
    twice = {k: torch.cat([v, v]) for k, v in one.items()}
    g2, _ = T.grads_fn(rt, params, twice, T.TrainConfig(accum_steps=2))
    g1, _ = T.grads_fn(rt, params, one, T.TrainConfig())
    bitwise, worst = True, 0.0
    for a, b in zip(O.tree_leaves(g2), O.tree_leaves(g1)):
        b = b.to(torch.float32)
        bitwise &= torch.equal(a, b)
        excess = ((a - b).abs() - 2e-4 - 2e-2 * b.abs()).max().item()
        worst = max(worst, excess)
    say(f"[train-depth2] accum_steps=2 over one 512-token microbatch "
        f"repeated vs one pass: within rtol 2e-2 / atol 2e-4: "
        f"{worst <= 0}; bit for bit: {bitwise}")
    if worst > 0:
        fail("train-depth2: accumulated gradients differ from one pass")
    del g2
    deltas = {}
    for st in ("fp32", "int8"):
        ocfg = O.OptConfig(lr=1e-3, state_dtype=st)
        p = _tree_to(params, "cuda", clone=True)
        p, _, _ = O.apply_updates(p, g1, O.init_opt_state(p, ocfg), ocfg)
        deltas[st] = [(a.float() - b.float()).reshape(-1) for a, b in
                      zip(O.tree_leaves(p), O.tree_leaves(params))]
        del p
    num = sum((a * b).sum().item() for a, b in zip(deltas["fp32"],
                                                    deltas["int8"]))
    na = math.sqrt(sum(a.square().sum().item() for a in deltas["fp32"]))
    nb = math.sqrt(sum(b.square().sum().item() for b in deltas["int8"]))
    cos = num / (na * nb)
    say(f"[train-depth2] fp32 vs int8 moments, one gradient: update "
        f"direction cosine {cos:.5f} (limit > 0.99)")
    if not cos > 0.99:
        fail(f"train-depth2: int8 update cosine {cos}")
    del params, g1, deltas
    gc.collect()
    torch.cuda.empty_cache()

    smoke = train_smoke_vs_cpu(args.seed + 62)
    return {"cos": cos, "accum_bitwise": bitwise, **smoke}


def train_smoke(tag: str) -> dict:
    """The SMOKE Llama trained on the card with the reference's recipe
    (``SMOKE_RECIPE``: ``benchmarks/common.py``'s 300 steps, lr 1e-3,
    warm-up 20, seq 64, batch 8, seed 0; fp32 moments); fails unless the
    mean of the last five losses is more than 0.3 below the first five's.
    Returns the config, the trained parameters and their optimizer state
    on the card, the two means and the wall."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _one_batch
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.training import optim as O
    from repro_torch.training import trainer as T

    r = SMOKE_RECIPE
    cfg = get_config("llama3-8b", smoke=True)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        r["seed"]), device="cuda")
    tcfg = T.TrainConfig(opt=O.OptConfig(lr=r["lr"], total_steps=r["steps"],
                                         warmup_steps=r["warmup"]))
    opt = O.init_opt_state(params, tcfg.opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=r["seq"],
                      global_batch=r["batch"], seed=r["seed"])
    rt = Runtime(cfg=cfg)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(r["steps"]):
        params, opt, m = T.train_step(rt, params, opt,
                                      _one_batch(dcfg, step, "cuda"), tcfg)
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    wall = time.perf_counter() - t0
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    say(f"[{tag}] SMOKE Llama, {r['steps']} steps on the card "
        f"(lr {r['lr']}, warm-up {r['warmup']}, {r['batch']} x {r['seq']} "
        f"tokens): loss {first:.4f} -> {last:.4f} (drop {first - last:.4f}, "
        f"limit > 0.3); {wall:.1f} s, {wall * 1e3 / r['steps']:.1f} ms a "
        f"step")
    if not (np.isfinite(losses).all() and last < first - 0.3):
        fail(f"{tag}: loss {first} -> {last}")
    return {"cfg": cfg, "params": params, "opt": opt, "first": first,
            "last": last, "wall": wall}


def eval_prompt(cfg, n: int = 4):
    """The reference's ``eval_prompts`` (``benchmarks/common.py``): the
    data stream's batch at step 12345 from seed 7, its first 24 tokens, on
    the card (the first ``n`` of 4 rows)."""
    from repro_torch.data.pipeline import DataConfig, _one_batch
    edcfg = DataConfig(vocab_size=cfg.vocab_size,
                       seq_len=SMOKE_RECIPE["seq"], global_batch=4, seed=7)
    return _one_batch(edcfg, 12345, "cuda")["tokens"][:n, :24].contiguous()


def train_serve_phase(args, main: dict | None) -> dict:
    """Phase 19c: the SMOKE Llama trained on the card with the reference's
    recipe (``benchmarks/common.py``: 300 steps, lr 1e-3, warm-up 20, seq
    64, batch 8, seed 0; the mean of the last five losses more than 0.3
    below the first five's); params + fp32 moments saved and restored bit
    for bit; ``launch/train.run --device cuda --fail-at-step 6`` ending
    with an uninterrupted run's parameters bit for bit; then the trained
    weights packed in Cassandra-1 (γ=3) and served on the reference's
    ``eval_prompts`` (4 x 24 tokens of the stream at step 12345, seed 7) x
    32 new: phase 6's Engine gates exact (spec == AR at the verify width
    on every position, launches as the passes imply), the paged
    ``Scheduler`` with the attention kernels on (every request its tokens,
    launches as phase 7's rule, tokens equal to the Engine's under the
    near-tie rule on >= 90% of positions), and acceptance greedy and at
    T = 1.0 beside phase 6's random-weight acceptance."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.format import CassandraConfig
    from repro_torch.core.packing import format_params
    from repro_torch.launch import train as TR
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training import optim as O

    r = SMOKE_RECIPE
    trained = train_smoke("train-serve")
    cfg, params, opt = trained["cfg"], trained["params"], trained["opt"]
    first, last, wall = trained["first"], trained["last"], trained["wall"]

    work = ROOT / "build" / "phase19"
    shutil.rmtree(work, ignore_errors=True)
    save_checkpoint(str(work / "trained"), r["steps"], (params, opt))
    back = restore_checkpoint(str(work / "trained"), r["steps"],
                              (params, opt))
    same = _same_tree(back, (params, opt))
    say(f"[train-serve] params + fp32 moments saved and restored: bit for "
        f"bit: {same}; on the card: "
        f"{all(t.is_cuda for t in O.tree_leaves(back))}")
    if not same:
        fail("train-serve: the checkpoint does not restore bit for bit")
    del back
    cli = ["--arch", "llama3-8b", "--smoke", "--device", "cuda", "--steps",
           "12", "--batch", "8", "--seq", "64", "--ckpt-every", "4", "--lr",
           "1e-3"]
    t0 = time.perf_counter()
    p_fail, o_fail = TR.run(cli + ["--fail-at-step", "6", "--ckpt-dir",
                                   str(work / "fail")])
    p_ok, o_ok = TR.run(cli + ["--ckpt-dir", str(work / "ok")])
    same = _same_tree((p_fail, o_fail), (p_ok, o_ok))
    say(f"[train-serve] launch/train.run --device cuda, 12 steps: a "
        f"failure injected at step 6 (restored from step 4) ends with the "
        f"uninterrupted run's parameters and moments bit for bit: {same} "
        f"({time.perf_counter() - t0:.1f} s both)")
    if not same:
        fail("train-serve: the resumed run differs from the uninterrupted "
             "one")
    del p_fail, o_fail, p_ok, o_ok
    shutil.rmtree(work, ignore_errors=True)

    cass = CassandraConfig(variant=1, gamma=3)
    with torch.no_grad():
        packed = format_params(params, cass)
    prompt = eval_prompt(cfg)
    sargs = argparse.Namespace(requests=4, prompt_len=24, max_new=32)
    eng = main_phase(packed, cfg, cass, None, sargs, tag="trained",
                     exact=True, tokens=prompt)
    n = sargs.max_new
    reset_launches()
    sched, tokens, first_lg, swall = serve_paged(cfg, packed, cass, prompt,
                                                 n, attn_kernel="on")
    got = all_launches()
    st = sched.summary()
    del sched
    expect = pass_launches("c1", st, cfg, cass, packed)
    say(f"[trained-sched] launches {got}; expected {expect}: "
        f"{got == expect}")
    if got != expect:
        fail(f"trained-sched: launches {got} != expected {expect}")
    lg = eng["lg"].numpy()
    gmax, _ = _logit_gap(first_lg, lg)
    lrms = float(np.sqrt((lg.astype(np.float64) ** 2).mean()))
    if not gmax < 0.1 * lrms:
        fail(f"trained-sched: first-token logits differ by {gmax}")
    # phase 7's near-tie rule against the Engine's one-pass prefill: equal
    # up to each row's first near tie. The corpus's next token is one of
    # three equally likely ones, so a trained model's top logits sit in
    # near ties and the rule stops early: the share is printed, and the
    # tokens are held bit for bit to the Engine's own steps from the same
    # chunked cache (phase 17's rule) on every position
    ref_tok, margins = eng["wide"]
    compared, cut = tau_check(tokens, ref_tok, margins, 2.0 * gmax, n,
                              what="trained-sched")
    share = compared / tokens.size
    m = {"cfg": cfg, "cass": cass, "packed": packed}
    exact, _, _ = chunked_ar_check("trained-sched", m, prompt, first_lg,
                                   tokens, n, None)
    say(f"[trained-sched] {tokens.shape[0]} requests x {n} tokens, cycles "
        f"{st['cycles']}, acceptance {st['acceptance']:.3f}; first-token "
        f"gap to the one-pass prefill {gmax:.4g} (limit {0.1 * lrms:.4g}); "
        f"tokens == the Engine's under tau = {2 * gmax:.3g} on {compared} "
        f"of {tokens.size} positions ({share:.1%}; AR margins below tau "
        f"{int((margins[:, :n] < 2 * gmax).sum())} of {tokens.size}), == "
        f"the Engine's steps from the same chunked cache on {exact} of "
        f"{tokens.size}; {swall:.1f} s")
    sampled = Engine(cfg, packed, cass=cass,
                     ecfg=EngineConfig(gamma=3, greedy=False,
                                       temperature=1.0), device="cuda")
    _, sst = sampled.generate({"tokens": prompt}, max_new=n,
                              generator=torch.Generator(
                                  device="cuda").manual_seed(args.seed))
    rand = (f"{main['acceptance']:.3f}" if main is not None
            else "not run (--phase 19)")
    say(f"[trained-serve] acceptance of the trained SMOKE model: greedy "
        f"{eng['acceptance']:.3f} (Engine), {st['acceptance']:.3f} "
        f"(Scheduler), at T = 1.0 {sst['acceptance']:.3f}; phase 6's "
        f"random-weight Llama-3-8B greedy {rand}")
    return {"first": first, "last": last, "wall": wall, "cfg": cfg,
            "params": params, "prompt": prompt,
            "acceptance": eng["acceptance"],
            "sched_acceptance": st["acceptance"],
            "t1_acceptance": sst["acceptance"], "share": share}


def train_phase(args, main: dict | None) -> dict:
    """Phase 19, from generators of its own (19a ``--seed`` + 60, 19b +
    61 / + 62, 19c the recipe's seed 0)."""
    import torch
    t0 = time.perf_counter()
    out = {"full": train_full_phase(args), "depth": train_depth_phase(args),
           "serve": train_serve_phase(args, main)}
    torch.cuda.empty_cache()
    say(f"[train] phase 19 in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: format selection (paper Eq. 2, Fig. 6) over the paper's grid
# ---------------------------------------------------------------------------

GRID_PRUNES = (0.3, 0.4, 0.5, 0.6)         # core/dse.py's default grid
GRID_TRUNCS = (0, 1, 2, 3, 4, 5)
LAYER_MATRICES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                  ("attn", "wo"), ("ffn", "w_gate"), ("ffn", "w_up"),
                  ("ffn", "w_down"))
DSE_S_W, DSE_S_KV = 10.0, 1.0              # examples/acceptance_sweep.py
DSE_NEW = 12
STAT_TOL = 1e-5                            # Fig. 6's figures card vs CPU


def _grid_cass(w=(0.4, 4), kv=(0.4, 4)):
    from repro_torch.core.format import CassandraConfig
    return CassandraConfig(variant=1, gamma=3, weight_prune=w[0],
                           weight_trunc=w[1], kv_prune=kv[0],
                           kv_trunc=kv[1])


def grid_weights(layer: dict, gen) -> None:
    """Phase 20a: one Llama-3-8B layer's seven matrices packed on the card
    at every point of the grid (exp_bits 3). Per point and matrix:
    ``draft_matmul``'s decoded weight (identity rows) bit for bit against
    the plain draft view and y at M=4 within RTOL / ATOL;
    ``target_decode`` bit for bit against ``target_weight_plain`` and the
    bf16 weight; ``compression_summary``, whose ``spec_bytes`` must fall
    strictly as the prune or the truncation rises; wk's packed leaves bit
    for bit the CPU's packing of the same weight. Per point, the layer's
    seven ``draft_matmul`` launches at M=4 by graph replay beside Eq. 2's
    draft byte ratio (recorded, not gated), and its seven ``target_decode``
    launches likewise."""
    import torch
    from repro_torch.core import format as fmt
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.kernels import unary_decode as UD

    mats = [(nm, layer[grp][nm]) for grp, nm in LAYER_MATRICES]
    eyes = {}
    xs = {}
    for _, w in mats:
        n_in = w.shape[0]
        if n_in not in eyes:
            eyes[n_in] = torch.eye(n_in, dtype=torch.bfloat16, device="cuda")
            xs[n_in] = torch.randn((4, n_in), generator=gen,
                                   device="cuda").to(torch.bfloat16)
    wk_cpu = layer["attn"]["wk"].cpu()
    rows = []
    for p in GRID_PRUNES:
        for t in GRID_TRUNCS:
            cass = _grid_cass(w=(p, t))
            spec_b = verif_b = orig = 0
            err, ops_all, per_mat, packs = 0.0, [], {}, []
            for nm, w in mats:
                shape = tuple(w.shape)
                spec, verif = fmt.format_weight(w, None, cass)
                ops = DM.prepare_draft_operands(spec, cass, shape)
                block = cass.weight_block(shape[0])
                kw = dict(block=block, keep=cass.weight_keep(block),
                          trunc=t, exp_bits=cass.exp_bits)
                args = [ops[k] for k in ("bitmap", "signmant", "exp3",
                                         "emax", "book")]
                got = DM.draft_matmul(eyes[shape[0]], *args, **kw).to(
                    torch.bfloat16)
                want = DM.draft_weight_plain(*args, **kw).contiguous()
                if not torch.equal(got.view(torch.int16),
                                   want.view(torch.int16)):
                    fail(f"fmt-weights ({p}, {t}) {nm}: draft_matmul's "
                         f"decoded weight differs from the plain draft view "
                         f"in {int((got != want).sum())} values")
                del got, want
                x = xs[shape[0]]
                y = DM.draft_matmul(x, *args, **kw)
                y_plain = DM.draft_matmul_plain(x, *args, **kw)
                if not (torch.isfinite(y).all() and torch.allclose(
                        y, y_plain, rtol=RTOL, atol=ATOL)):
                    fail(f"fmt-weights ({p}, {t}) {nm}: y differs from the "
                         f"plain version by {(y - y_plain).abs().max()}")
                err = max(err, float((y - y_plain).abs().max()))
                tv = UD.target_decode(spec, verif, cass, shape)
                chain = fmt.target_weight_plain(spec, verif, cass, shape).T
                if not torch.equal(tv.view(torch.int16),
                                   chain.view(torch.int16)):
                    fail(f"fmt-weights ({p}, {t}) {nm}: target_decode "
                         f"differs from the plain chain")
                if not torch.equal(tv.T.view(torch.int16),
                                   w.view(torch.int16)):
                    fail(f"fmt-weights ({p}, {t}) {nm}: the target view "
                         f"differs from the bf16 weight in "
                         f"{int((tv.T != w).sum())} values")
                del tv, chain
                summ = fmt.compression_summary(spec, verif, w.numel() * 2)
                per_mat[nm] = summ["spec_bytes"]
                spec_b += summ["spec_bytes"]
                verif_b += summ["verif_bytes"]
                orig += w.numel() * 2
                if nm == "wk":
                    cs, cv = fmt.format_weight(wk_cpu, None, cass)
                    if not (_same_bits(_tree_to(spec, "cpu"), cs)
                            and _same_bits(_tree_to(verif, "cpu"), cv)):
                        fail(f"fmt-weights ({p}, {t}) wk: the card's packed "
                             f"leaves differ from the CPU's packing")
                ops_all.append((x, args, kw))
                packs.append((spec, verif, shape))
                del spec, verif, ops
            torch.cuda.synchronize()

            def layer_draft():
                for x, args, kw in ops_all:
                    DM.draft_matmul(x, *args, **kw)

            def layer_target():
                for spec, verif, shape in packs:
                    UD.target_decode(spec, verif, cass, shape)
            us = graph_ms(layer_draft, 10) * 1e3
            td_us = graph_ms(layer_target, 5) * 1e3
            rows.append({"p": p, "t": t, "keep": cass.weight_keep(512),
                         "spec_bytes": spec_b, "verif_bytes": verif_b,
                         "orig": orig, "per_mat": per_mat, "us": us,
                         "td_us": td_us, "eq2": (1 - p) * (16 - t) / 16,
                         "err": err})
            del ops_all, packs
            torch.cuda.empty_cache()
    by = {(r["p"], r["t"]): r for r in rows}
    for key in ("spec_bytes",) + tuple(nm for _, nm in LAYER_MATRICES):
        def val(r):
            return r["spec_bytes"] if key == "spec_bytes" else \
                r["per_mat"][key]
        for p in GRID_PRUNES:
            seq = [val(by[p, t]) for t in GRID_TRUNCS]
            if any(a <= b for a, b in zip(seq, seq[1:])):
                fail(f"fmt-weights: {key} spec bytes at prune {p} do not "
                     f"fall strictly with the truncation: {seq}")
        for t in GRID_TRUNCS:
            seq = [val(by[p, t]) for p in GRID_PRUNES]
            if any(a <= b for a, b in zip(seq, seq[1:])):
                fail(f"fmt-weights: {key} spec bytes at truncation {t} do "
                     f"not fall strictly with the prune: {seq}")
    base = by[0.4, 4]
    say(f"[fmt-weights] one Llama-3-8B layer's 7 matrices (wq, wk, wv, wo, "
        f"w_gate, w_up, w_down; {base['orig'] / 1e6:.1f} MB bf16) packed on "
        f"the card at the 24 points (exp_bits 3): draft_matmul's decoded "
        f"weight and target_decode bit for bit against their plain "
        f"versions, the target view the bf16 weights, wk's leaves the "
        f"CPU's, at every point; y within rtol {RTOL} / atol {ATOL}; "
        f"spec bytes fall strictly along both axes. Per point (prune, "
        f"trunc): keep of 512, compression_summary, the layer's 7 "
        f"draft_matmul launches at M=4 (graph replay) against the paper "
        f"default's, beside Eq. 2's draft byte ratio (1-p)(16-t)/16 "
        f"against the default's, and its 7 target_decode launches:")
    for r in rows:
        say(f"[fmt-weights]   ({r['p']}, {r['t']}) keep {r['keep']}: spec "
            f"{r['spec_bytes'] / 1e6:.2f} MB (draft_ratio "
            f"{r['spec_bytes'] / r['orig']:.4f}, total_ratio "
            f"{(r['spec_bytes'] + r['verif_bytes']) / r['orig']:.4f}); "
            f"draft layer {r['us']:.1f} us ({r['us'] / base['us']:.3f} of "
            f"the default) vs Eq. 2 {r['eq2']:.4f} ({r['eq2'] / base['eq2']:.3f}"
            f"), spec bytes {r['spec_bytes'] / base['spec_bytes']:.3f}; "
            f"target_decode layer {r['td_us']:.1f} us "
            f"({r['td_us'] / base['td_us']:.3f}); max |y - plain| "
            f"{r['err']:.3g}")
    n = len(rows)
    mx, my = (sum(r[k] for r in rows) / n for k in ("spec_bytes", "us"))
    cov = sum((r["spec_bytes"] - mx) * (r["us"] - my) for r in rows)
    sx = math.sqrt(sum((r["spec_bytes"] - mx) ** 2 for r in rows))
    sy = math.sqrt(sum((r["us"] - my) ** 2 for r in rows))
    say(f"[fmt-weights] draft time against spec bytes over the 24 points: "
        f"correlation {cov / (sx * sy):.4f}; {min(r['us'] for r in rows):.1f}"
        f"-{max(r['us'] for r in rows):.1f} us a layer")
    del eyes, xs
    torch.cuda.empty_cache()


def _kv_store_checks(cass, x, d: int, book, tag: str, exact: bool):
    """``kv_encode`` of (…, d) vectors on the card: every leaf bit for bit
    against ``encode_store_plain``; ``kv_view``'s draft and target views
    bit for bit against ``read_store_plain``; with ``exact`` the target
    view is the input bit for bit. Returns the store and its mode-1
    share."""
    import torch
    from repro_torch.kernels import kv_topk as KT
    from repro_torch.kernels import unary_decode as UD
    from repro_torch.serving import kvcache as KC
    kw = dict(keep=cass.kv_keep(d), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits)
    spec, verif = KT.kv_encode(x, book[1], **kw)
    store = {"spec": spec, "verif": verif}
    if not _same_bits(store, KC.encode_store_plain(cass, x, d, book)):
        fail(f"{tag}: kv_encode differs from the plain chain")
    for view in ("draft", "target"):
        got = UD.kv_view(spec, verif if view == "target" else None, book[0],
                         d=d, **kw)
        if not _same_bits(got, KC.read_store_plain(cass, store, d, view,
                                                   book)):
            fail(f"{tag}: kv_view's {view} view differs from the plain "
                 f"chain")
        if view == "target" and exact and not _same_bits(got, x):
            fail(f"{tag}: the target view differs from the input")
    return store, float(spec["exp_mode"].float().mean())


def grid_kv(k, v, gen) -> None:
    """Phase 20b: K and V of a prefill (B, S, Hkv, 128) at every point of
    the grid, under ``default_kv_codebook`` and under the book
    ``calibrate_kv_codebook`` makes from them: ``kv_encode`` and
    ``kv_view`` (draft and target) bit for bit against the plain chains,
    the target view the input; on a pool of those stores (block 16, a
    zero trash block, ragged lengths with an empty row, an entry past
    every length) ``decode_spec_pool`` bit for bit and
    ``paged_gqa_packed`` at T = 1 and 4 within PAGED_RTOL / PAGED_ATOL of
    its plain version; edge rows (phase 4c's) under the calibrated book,
    exponents it never saw included, against the chains."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving import kvcache as KC

    b, s, hkv, d = k.shape
    g = 4
    books = {"default": KC.default_kv_codebook("cuda"),
             "calibrated": KC.calibrate_kv_codebook(torch.cat([k, v]))}
    cal = books["calibrated"]
    unseen = int((cal[1] == 255).sum())
    edges = edge_rows(gen, 4096, d)
    eexp = (edges.view(torch.int16).int() >> 7) & 0xFF
    n_unseen = int((cal[1][eexp.long()] == 255).sum())
    nb = b * s // BLOCK
    pools = [torch.cat([torch.zeros((1, BLOCK, hkv, d), dtype=torch.bfloat16,
                                    device="cuda"),
                        x.reshape(nb, BLOCK, hkv, d)]) for x in (k, v)]
    table = torch.full((b, s // BLOCK + 1), -1, dtype=torch.int32,
                       device="cuda")
    table[:, :-1] = (1 + torch.arange(nb, device="cuda")).reshape(b, -1)
    lengths = torch.tensor([s, s, s - 51, 0][:b], dtype=torch.int32,
                           device="cuda")
    qs = {t: torch.randn((b, t, hkv, g, d), generator=gen,
                         device="cuda").to(torch.bfloat16) for t in (1, 4)}
    runs = modes = 0
    worst = 0.0
    times = []
    for p in GRID_PRUNES:
        for t in GRID_TRUNCS:
            cass = _grid_cass(kv=(p, t))
            kw = dict(d=d, keep=cass.kv_keep(d), trunc=t,
                      exp_bits=cass.exp_bits)
            for bname, book in books.items():
                tag = f"fmt-kv ({p}, {t}) {bname} book"
                specs = []
                for nm, pool in zip("KV", pools):
                    store, share = _kv_store_checks(cass, pool, d, book,
                                                    f"{tag} {nm}", True)
                    specs.append(store["spec"])
                    modes += share
                for sp in specs:
                    if not _same_bits(
                            PA.decode_spec_pool(sp, book[0], **kw),
                            PA.decode_spec_pool_plain(sp, book[0], **kw)):
                        fail(f"{tag}: decode_spec_pool differs from its "
                             f"plain decode")
                for t_q, q in qs.items():
                    got = PA.paged_gqa_packed(q, *specs, table, lengths,
                                              book[0], scale=d ** -0.5, **kw)
                    want = PA.paged_gqa_packed_plain(
                        q, *specs, table, lengths, book[0], scale=d ** -0.5,
                        **kw)
                    for a, b_ in zip(got, want):
                        if not torch.allclose(a, b_, rtol=PAGED_RTOL,
                                              atol=PAGED_ATOL):
                            fail(f"{tag}: paged_gqa_packed T={t_q} differs "
                                 f"from its plain version by "
                                 f"{(a - b_).abs().max()}")
                        worst = max(worst, float((a - b_).abs().max()))
                if bname == "default":
                    times.append((p, t, kw["keep"], *_kv_times(
                        pools[0], specs, book, table, lengths, qs[1], kw)))
                runs += 1
                del specs
            _kv_store_checks(cass, edges, d, cal,
                             f"fmt-kv ({p}, {t}) edge rows", False)
    torch.cuda.synchronize()
    say(f"[fmt-kv] K and V of a {s}-token prefill ({b} x {s} x {hkv} x {d}) "
        f"in a pool of {nb} blocks of {BLOCK} (+ the trash block), at the 24 "
        f"KV points x 2 books ({runs} runs): kv_encode, kv_view (draft and "
        f"target) and decode_spec_pool bit for bit against the plain "
        f"chains, the target view the input; paged_gqa_packed at T = 1 and "
        f"4 within rtol {PAGED_RTOL} / atol {PAGED_ATOL} (max abs err "
        f"{worst:.3g}); mean mode-1 share {modes / (2 * runs):.4f}. The "
        f"calibrated book leaves {unseen} of 256 exponents unseen (rank 255); "
        f"{n_unseen} of the {edges.numel()} edge-row values (ties, +-0, NaN "
        f"payloads, inf, subnormals, a 2^+-12 spread) carry one, and every "
        f"edge row's store and views equal the chains at every point. Per "
        f"point (prune, trunc), default book, us by graph replay: kv_encode "
        f"of the K pool, kv_view's target and draft views of it, "
        f"paged_gqa_packed at T = 1:")
    for p, t, keep, enc, tv, dv, att in times:
        say(f"[fmt-kv]   ({p}, {t}) keep {keep}: kv_encode {enc:.2f}  kv_view "
            f"target {tv:.2f} / draft {dv:.2f}  paged_gqa_packed {att:.2f}")


def _kv_times(pool, specs, book, table, lengths, q, kw) -> tuple:
    """µs per launch by graph replay at one KV point: ``kv_encode`` of a
    pool, ``kv_view``'s target and draft views of its store, and
    ``paged_gqa_packed`` at T = 1 over the K and V stores."""
    from repro_torch.kernels import kv_topk as KT
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import unary_decode as UD
    ckw = {k: kw[k] for k in ("keep", "trunc", "exp_bits")}
    spec, verif = KT.kv_encode(pool, book[1], **ckw)
    d = kw["d"]
    runs = (lambda: KT.kv_encode(pool, book[1], **ckw),
            lambda: UD.kv_view(spec, verif, book[0], d=d, **ckw),
            lambda: UD.kv_view(spec, None, book[0], d=d, **ckw),
            lambda: PA.paged_gqa_packed(q, *specs, table, lengths, book[0],
                                        scale=d ** -0.5, **kw))
    return tuple(graph_ms(fn, 20) * 1e3 for fn in runs)


def grid_corners(args, gen) -> None:
    """Phase 20c: Llama-3-8B at full width, 2 layers, at two corners of
    the grid (weights (0.3, 0) with KV (0.6, 5); weights (0.6, 5) with KV
    (0.3, 0)): phase 6's Engine gates exact (spec == AR at the verify
    width on every position, launches as the passes imply); at the first
    corner the paged ``Scheduler`` with the attention kernels on, under
    phase 7's rules (launches as the passes imply, first-token logits
    within a tenth of the logit rms of the Engine's, tokens against the
    Engine's under the near-tie rule)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.packing import format_params
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    params = init_params(cfg, gen, device="cuda")
    for i, (wf, kf) in enumerate((((0.3, 0), (0.6, 5)),
                                  ((0.6, 5), (0.3, 0)))):
        cass = _grid_cass(w=wf, kv=kf)
        tag = f"fmt-corner w{wf} kv{kf}"
        packed = format_params(params, cass)
        eng = main_phase(packed, cfg, cass, gen, args, tag=tag, exact=True)
        if i == 0:
            prompt, n = eng["prompt"], args.max_new
            reset_launches()
            sched, tokens, first, _ = serve_paged(cfg, packed, cass, prompt,
                                                  n, attn_kernel="on")
            got, st = all_launches(), sched.summary()
            del sched
            expect = pass_launches("c1", st, cfg, cass, packed)
            say(f"[{tag} sched] launches {got}; expected {expect}: "
                f"{got == expect}")
            if got != expect:
                fail(f"{tag} sched: launches {got} != expected {expect}")
            lg = eng["lg"].numpy()
            gmax, _ = _logit_gap(first, lg)
            lrms = float(np.sqrt((lg.astype(np.float64) ** 2).mean()))
            if not gmax < 0.1 * lrms:
                fail(f"{tag} sched: first-token logits differ by {gmax}")
            compared, cut = tau_check(tokens, *eng["wide"], 2.0 * gmax, n,
                                      what=f"{tag} sched")
            say(f"[{tag} sched] first-token gap {gmax:.4g} (limit "
                f"{0.1 * lrms:.4g}); tokens == the Engine's on {compared} of "
                f"{tokens.size} positions under tau = {2 * gmax:.3g} (cut "
                f"{cut}); acceptance {st['acceptance']:.3f}")
        del packed
        gc.collect()
        torch.cuda.empty_cache()


def dse_search(trained: dict) -> None:
    """Phase 20d: ``core/dse.grid_search`` on the trained SMOKE Llama with
    its default grid and ``examples/acceptance_sweep.py``'s settings
    (s_w 10, s_kv 1: 24 weight points with the KV at (0.4, 4), then 24 KV
    points with the weights at their best; C-1, γ = 3, greedy, no
    calibration, 2 eval prompts x 12 new). Every probe is an
    ``Engine.generate`` whose tokens equal autoregressive steps at the
    verify width on every position, its ``draft_matmul`` launches draft
    passes x the packed matrices; every point's J equals ``objective`` on
    the CPU for its alpha."""
    import dataclasses

    import torch
    from repro_torch.core import dse
    from repro_torch.core.packing import format_params
    from repro_torch.kernels import draft_matmul as DM
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg, params = trained["cfg"], trained["params"]
    prompt = trained["prompt"][:2]
    b, s = prompt.shape
    probes = []

    def acceptance_fn(w_p, w_t, kv_p, kv_t):
        cass = _grid_cass(w=(w_p, w_t), kv=(kv_p, kv_t))
        with torch.no_grad():
            packed = format_params(params, cass)
        eng = Engine(cfg, packed, cass=cass,
                     ecfg=EngineConfig(gamma=3, greedy=True), device="cuda")
        DM.draft_matmul.launches = 0
        spec, st = eng.generate({"tokens": prompt}, max_new=DSE_NEW,
                                speculative=True)
        launches = DM.draft_matmul.launches
        rt_t = dataclasses.replace(eng.rt, view="target")
        cache = KC.init_cache(cfg, cass, b, s + DSE_NEW + 5, packed=True,
                              device="cuda")
        with torch.inference_mode():
            lg, cache = M.forward_prefill(rt_t, packed, {"tokens": prompt},
                                          cache)
            ar, _ = ar_steps(rt_t, packed, cache, lg[:, -1], DSE_NEW, 4)
        if not torch.equal(spec[:, :DSE_NEW].to(torch.int32),
                           ar.to(torch.int32)):
            fail(f"dse ({w_p}, {w_t}, {kv_p}, {kv_t}): spec tokens differ "
                 f"from AR at the verify width")
        if launches != st["draft_passes"] * draft_matrices(packed):
            fail(f"dse ({w_p}, {w_t}, {kv_p}, {kv_t}): draft_matmul "
                 f"launched {launches} times in {st['draft_passes']} passes")
        probes.append((w_p, w_t, kv_p, kv_t, st["acceptance"],
                       st["cycles"], launches))
        return st["acceptance"]

    t0 = time.perf_counter()
    points = dse.grid_search(acceptance_fn, DSE_S_W, DSE_S_KV)
    wall = time.perf_counter() - t0
    if len(probes) != 48 or len(points) != 48:
        fail(f"dse: {len(probes)} probes, {len(points)} points (expected 48)")
    for pt in points:
        j = dse.objective(pt.alpha, DSE_S_W, DSE_S_KV, pt.weight_prune,
                          pt.weight_trunc, pt.kv_prune, pt.kv_trunc)
        if j != pt.objective:
            fail(f"dse: J {pt.objective} != objective on the CPU {j}")
    say(f"[dse] Eq. 2 grid search on the trained SMOKE Llama (s_w "
        f"{DSE_S_W}, s_kv {DSE_S_KV}: the weight term first, then the KV "
        f"term at the weights' best): {len(probes)} probes, each an "
        f"Engine.generate on {b} eval prompts x {DSE_NEW} new, spec == AR "
        f"at the verify width on every position, launches as the passes "
        f"imply; every J equal to objective() on the CPU; {wall:.1f} s. "
        f"Ranked (w_p, w_t, kv_p, kv_t): alpha, J, draft_ratio:")
    for i, pt in enumerate(points):
        say(f"[dse]   {i + 1:2d}. ({pt.weight_prune}, {pt.weight_trunc}, "
            f"{pt.kv_prune}, {pt.kv_trunc}): alpha {pt.alpha:.4f}  J "
            f"{pt.objective:.6f}  draft_ratio {pt.draft_ratio:.4f}")


def _bf16_leaves(tree, min_size: int = 4096) -> list:
    """Every bf16 leaf of at least ``min_size`` values, flattened, in tree
    order (``benchmarks/entropy.py``'s ``_collect_weights``)."""
    import torch
    from repro_torch.core.tree import tree_leaves
    return [t.reshape(-1) for t in tree_leaves(tree)
            if t.dtype == torch.bfloat16 and t.numel() >= min_size]


def fig6_stats(trained: dict) -> None:
    """Phase 20e: Fig. 6 on the trained SMOKE Llama by
    ``benchmarks/entropy.py``'s procedure: its bf16 leaves of at least
    4096 values, and K/V from a plain prefill of 2 eval prompts, zeros
    dropped; ``shannon_entropy`` and ``avg_code_bits`` (under each
    sample's own ``build_codebook``) on the card and on the CPU, equal
    within STAT_TOL."""
    import torch
    from repro_torch.core import bitops, coding
    from repro_torch.models import model as M
    from repro_torch.models.layers import Runtime
    from repro_torch.serving import kvcache as KC

    cfg, params = trained["cfg"], trained["params"]
    prompt = trained["prompt"][:2]
    cache = KC.init_cache(cfg, None, 2, prompt.shape[1] + 8, packed=False,
                          device="cuda")
    with torch.inference_mode():
        _, cache = M.forward_prefill(Runtime(cfg=cfg), params,
                                     {"tokens": prompt}, cache)
    kv = [e[nm].reshape(-1) for g in cache["dec"] for e in g.values()
          for nm in ("k", "v", "c", "kr") if nm in e]
    for name, data in (("weights", torch.cat(_bf16_leaves(params))),
                       ("KV", torch.cat(kv))):
        data = data[data != 0]
        card, cpu = ((float(coding.shannon_entropy(exps)),
                      float(coding.avg_code_bits(
                          exps, coding.build_codebook(exps)[1])))
                     for exps in (bitops.split_fields(x)[1]
                                  for x in (data, data.cpu())))
        gap = max(abs(a - b) for a, b in zip(card, cpu))
        say(f"[fig6] {name} ({data.numel()} nonzero values): entropy "
            f"{card[0]:.5f} bits (CPU {cpu[0]:.5f}), unary code "
            f"{card[1]:.5f} bits a value (CPU {cpu[1]:.5f}); card vs CPU "
            f"{gap:.3g} (limit "
            f"{STAT_TOL}). The paper's figures (Fig. 6, trained 4-8B "
            f"models): entropy ~2.6 (weights) / ~2.7 (KV) bits, unary "
            f"code 2.85 bits")
        if not gap <= STAT_TOL:
            fail(f"fig6: {name} statistics differ card vs CPU by {gap}")


def format_selection_phase(args, trained: dict | None) -> None:
    """Phase 20, from generators of its own (``--seed`` + 70): (a) and (b)
    on one full-width Llama-3-8B layer and its K/V, (c) at 2 layers, (d)
    and (e) on phase 19c's trained SMOKE Llama (trained here when phase
    19 did not run)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 70)
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=1)
    params = init_params(cfg, gen, device="cuda")
    layer = {grp: {nm: params["dec"][0]["e0"][grp][nm]["w"][0]
                   for g2, nm in LAYER_MATRICES if g2 == grp}
             for grp in ("attn", "ffn")}
    grid_weights(layer, gen)
    ta = time.perf_counter()
    prompt = torch.randint(0, cfg.vocab_size, (args.requests,
                                               args.prompt_len),
                           generator=gen, device="cuda").to(torch.int32)
    k, v = layer0_kv(params, cfg, None, prompt)
    del params, layer
    gc.collect()
    torch.cuda.empty_cache()
    grid_kv(k, v, gen)
    del k, v
    tb = time.perf_counter()
    grid_corners(args, gen)
    tc = time.perf_counter()
    if trained is None:
        trained = train_smoke("fmt-train")
        trained["prompt"] = eval_prompt(trained["cfg"])
    td0 = time.perf_counter()
    dse_search(trained)
    td = time.perf_counter()
    fig6_stats(trained)
    say(f"[fmt] phase 20 in {time.perf_counter() - t0:.1f} s ((a) "
        f"{ta - t0:.1f}, (b) {tb - ta:.1f}, (c) {tc - tb:.1f}, (d) "
        f"{td - td0:.1f}, (e) {time.perf_counter() - td:.1f})")
    torch.cuda.empty_cache()


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
    if args.phase is not None:
        {18: encdec_phase, 19: lambda a: train_phase(a, None),
         20: lambda a: format_selection_phase(a, None)}[args.phase](args)
        say(f"[done] phase {args.phase} alone in "
            f"{time.perf_counter() - t_start:.1f} s (no kernels line: the "
            f"other phases did not run)")
        return

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
    # 14. the prefix cache and swap: DeepSeek-V3's dense layers (phase 11's
    # model, a generator of its own), then Llama-3-8B at full width under
    # C-1 and at 2 layers under C-2
    t0 = time.perf_counter()
    ps = {"mla": prefix_swap_runs(
        "mla-prefix-swap", "mla", mla["cfg"], mla["packed"], mla["cass"],
        torch.Generator(device="cuda").manual_seed(args.seed + 8), args)}
    gc.collect()
    torch.cuda.empty_cache()
    ps.update(prefix_swap_phase(args))
    say(f"[prefix-swap] phase 14 in {time.perf_counter() - t0:.1f} s")
    # 15. rejection sampling, calibration and Engine telemetry: phase 3's
    # model, phase 6's prompts, and phase 11's MLA model
    sampling_phase(args, main, mla)
    del mla
    gc.collect()
    torch.cuda.empty_cache()
    # 16. the dense GQA family and top-k MoE: qwen3-4b at full width, DBRX
    # (2 layers) and DeepSeek-V3 (3 dense + 1 routed layer) at full width
    t0 = time.perf_counter()
    fam = {"qwen": qwen_phase(args), "dbrx": dbrx_phase(args),
           "ds-moe": deepseek_moe_phase(args)}
    say(f"[family] phase 16 in {time.perf_counter() - t0:.1f} s; launches "
        f"of the Engine runs: " + "; ".join(
            f"{k} {v['eng']['launches']} draft_matmul, "
            f"{v['eng']['codec']['target_decode']} target_decode, "
            f"{v['eng']['codec']['kv_view']} kv_view, "
            f"{v['eng']['codec']['kv_encode']} kv_encode"
            for k, v in fam.items()))
    td_err = max([td_err] + [v["err"] for v in fam.values()])
    # 17. the Mamba-1 family and the Jamba hybrid: falcon-mamba-7b at full
    # width (64 layers), Jamba at full width cut to one 8-layer period
    t0 = time.perf_counter()
    ssm = {"mamba": mamba_phase(args), "jamba": jamba_phase(args)}
    say(f"[ssm] phase 17 in {time.perf_counter() - t0:.1f} s; launches of "
        f"the Engine runs: " + "; ".join(
            f"{k} {v['eng']['launches']} draft_matmul, "
            f"{v['eng']['codec']['target_decode']} target_decode, "
            f"{v['eng']['codec']['kv_view']} kv_view, "
            f"{v['eng']['codec']['kv_encode']} kv_encode"
            for k, v in ssm.items()))
    td_err = max([td_err] + [v["err"] for v in ssm.values()])
    # 18. the encoder-decoder audio family and the vision frontend:
    # whisper-medium and phi-3-vision-4.2b at full width
    encdec = encdec_phase(args)
    codec += encdec["phi3v"]["codec"]
    td_err = max([td_err] + [v["err"] for v in encdec.values()])
    # 19. training: Llama-3-8B at full width (int8 moments, remat), at 2
    # layers and at SMOKE against the CPU; the SMOKE model trained, saved,
    # resumed and served through the Engine and the paged Scheduler
    trained = train_phase(args, main)["serve"]
    # 20. format selection: every kernel at every point of the paper's
    # grid at full width, the grid's corners end to end, the Eq. 2 search
    # and Fig. 6's statistics on phase 19c's trained SMOKE Llama
    format_selection_phase(args, trained)
    del trained
    gc.collect()
    torch.cuda.empty_cache()

    # 21. report
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
    ap.add_argument("--phase", type=int, choices=[18, 19, 20], default=None,
                    help="run the device, build and this phase only (no "
                    "kernels or ok line)")
    run(ap.parse_args())


if __name__ == "__main__":
    main()
