"""Serving entry point of the port: requests through the fixed-batch Cassandra
engine, or through the continuous-batching scheduler, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --variant 1 --gamma 3 --max-new 32 --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --variant 1 --scheduler --paged --attn-kernel on --slots 4

``--variant 0`` runs the bf16 autoregressive baseline, ``--variant 2``
Cassandra-2 (MX; with ``--paged`` only with ``--attn-kernel off``, as in
the reference). ``--smoke`` takes
the reduced config; ``--device cpu`` runs the plain versions on the CPU.
Weights are random, drawn from ``--seed``. ``--arch`` takes every name
of ``repro_torch.configs`` (llama3-8b, qwen3-4b, qwen3-1.7b, qwen2.5-3b,
nemotron-4-15b, mistral-large-123b, dbrx-132b, deepseek-v3-671b,
falcon-mamba-7b, jamba-v0.1-52b, whisper-medium, phi-3-vision-4.2b).
whisper-medium and phi-3-vision-4.2b get zero frame / patch embeddings, as
in the reference, and run through the Engine only: ``--scheduler`` raises
the reference's ``NotImplementedError`` (its admission takes token
prompts only). At full depth mistral-large-123b,
dbrx-132b, deepseek-v3-671b and jamba-v0.1-52b exceed one 80 GB card: serve
them at ``--smoke`` or cut their depth through the Python API
(``chip_smoke.py`` phases 16 and 17). The Mamba models refuse
``--prefix-cache`` and ``--swap``, as the reference does. MoE layers route with the
reference's default capacity factor (``Runtime.moe_capacity_factor``,
1.25); the reference's serve has no flag for it either.

With ``--scheduler --paged``, ``--prefix-cache`` shares cached prompt-prefix
blocks across requests (``--shared-header`` gives every request the first
request's first half, so the cache has something to hit, and the same
trace runs with the cache off too: the tokens must agree) and ``--swap``
lets the queue head preempt a resident row to host memory; the ``[prefix]``
and ``[swap]`` lines report them.

``--calibrate`` runs a Wanda calibration forward over the prompts
(``forward_train`` with a ``Calibrator``) before formatting. ``--greedy`` is
the reference's flag and, as there, cannot be turned off: sampled decoding
(``EngineConfig(greedy=False)``) runs through the Python API. The Engine
path draws from a generator seeded from ``--seed`` and writes
``--trace-out`` / ``--metrics-out`` from the telemetry it collects:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --device cpu --scheduler --paged --prefix-cache \
      --shared-header --slots 2 --requests 5 --prompt-len 12 --max-new 8 \
      --block-size 4 --chunk-size 8
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.core.packing import Calibrator, format_params, params_nbytes
from repro_torch.core.speculative import speedup_model
from repro_torch.models.layers import Runtime
from repro_torch.models.model import forward_train, init_params
from repro_torch.serving.engine import (Engine, EngineConfig,
                                        validate_request_slos)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.telemetry import (Telemetry, format_stats_lines,
                                           write_metrics, write_trace)


def format_line(nb: dict) -> str:
    """The ``[format]`` byte report: the packed weights' spec and verif
    bytes against their bf16 size, and the draft kernel's prepared operands
    (exp3/emax/book), resident beside the spec."""
    bf16 = max(nb["bf16"], 1)
    return (f"[format] spec={nb['spec'] / 1e6:.1f}MB "
            f"verif={nb['verif'] / 1e6:.1f}MB "
            f"plain={nb['plain'] / 1e6:.1f}MB; packed weights as bf16 "
            f"{nb['bf16'] / 1e6:.1f}MB: spec {nb['spec'] / bf16:.1%}, "
            f"spec+verif {(nb['spec'] + nb['verif']) / bf16:.1%}; "
            f"kernel operands {nb['kernel'] / 1e6:.1f}MB extra resident "
            f"({nb['kernel'] / bf16:.1%} of bf16)")


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--variant", type=int, default=1, choices=[0, 1, 2],
                    help="0=bf16 baseline, 1=Cassandra-1, 2=Cassandra-2 (MX)")
    ap.add_argument("--gamma", type=int, default=3)
    ap.add_argument("--greedy", action="store_true", default=True,
                    help="greedy decoding (the reference's flag: always on "
                    "here; sampling runs through the Python API)")
    ap.add_argument("--calibrate", action="store_true",
                    help="Wanda calibration pass over the prompts before "
                    "formatting")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scheduler", action="store_true",
                    help="continuous batching through --slots cache rows")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: a block pool + per-request block tables "
                    "(scheduler mode only)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="pool blocks incl. the trash block (default: the "
                    "slot layout's capacity + 1); a smaller pool makes "
                    "admission wait for blocks")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="wide prefill chunk (one step bucket for every "
                    "admission)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share cached prompt-prefix blocks across "
                    "requests (radix index + copy-on-write; requires "
                    "--paged)")
    ap.add_argument("--shared-header", action="store_true",
                    help="give all requests a common prompt header (half "
                    "the prompt) so the prefix cache has something to "
                    "hit; the same trace with the cache off prints the "
                    "same tokens")
    ap.add_argument("--prefix-cache-blocks", type=int, default=None,
                    help="max evictable blocks the prefix cache may keep "
                    "parked after their requests retire (default: bounded "
                    "only by the pool)")
    ap.add_argument("--swap", action="store_true",
                    help="preemption + host swap: when the queue head "
                    "cannot reserve, swap a resident victim's KV blocks "
                    "to a host spill store and admit at once (requires "
                    "--paged)")
    ap.add_argument("--swap-store-blocks", type=int, default=None,
                    help="max pool blocks the host spill store may hold "
                    "(default: unbounded); a full store stops preemption, "
                    "never drops a chain")
    ap.add_argument("--alternating", action="store_true",
                    help="the prefill/decode-alternating scheduler instead "
                    "of the fused mixed-role step")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable the pipelined dispatch/harvest overlap "
                    "(same tokens either way)")
    ap.add_argument("--max-prefill-tokens-per-step", type=int, default=None,
                    help="fused mode: cap prefill tokens per mixed cycle")
    ap.add_argument("--stop-token", type=int, action="append", default=None,
                    help="per-request stop token id(s), applied to odd-"
                    "numbered requests (repeatable)")
    ap.add_argument("--priority", type=int, action="append", default=None,
                    help="per-request priority (repeatable, cycled over "
                    "requests): higher admitted first, lower preempted "
                    "first")
    ap.add_argument("--ttft-deadline-ms", type=float, default=None,
                    help="per-request TTFT SLO (every request)")
    ap.add_argument("--itl-target-ms", type=float, default=None,
                    help="per-request inter-token SLO (every request)")
    ap.add_argument("--fifo", action="store_true",
                    help="keep priority-then-FIFO admission even when "
                    "requests declare SLOs")
    ap.add_argument("--attn-kernel", default="off", choices=["off", "on"],
                    help="'on' walks the block tables in the paged "
                    "attention kernels (requires --paged); 'off' gathers "
                    "each row's prefix and attends densely")
    ap.add_argument("--attn-chunk-q", type=int, default=None,
                    help="flash-attention query chunk of the dense "
                    "prefill path beyond 2048 tokens (default 1024)")
    ap.add_argument("--attn-chunk-k", type=int, default=None,
                    help="flash-attention key chunk of the dense prefill "
                    "path beyond 2048 tokens (default 1024)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the request "
                    "lifecycle")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics as JSON lines")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="lifecycle tracer ring bound (events)")
    args = ap.parse_args(argv)
    validate_request_slos(ttft_deadline_ms=args.ttft_deadline_ms,
                          itl_target_ms=args.itl_target_ms)
    if args.paged and not args.scheduler:
        ap.error("--paged requires --scheduler (the fixed-batch engine "
                 "has no block pool)")
    if args.prefix_cache and not args.paged:
        ap.error("--prefix-cache requires --paged (sharing aliases "
                 "physical pool blocks through block tables)")
    if args.swap and not args.paged:
        ap.error("--swap requires --paged (preemption spills and "
                 "restores pool blocks through block tables)")
    if args.attn_kernel != "off" and not args.paged:
        ap.error("--attn-kernel requires --paged (the kernel walks the "
                 "block table in-kernel)")

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            ap.error("--device cuda but CUDA is not available "
                     "(pass --device cpu for the plain versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    prompt = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.requests, args.prompt_len), generator=gen,
        device=args.device, dtype=torch.int64).to(torch.int32)}
    if args.shared_header:
        # a shared system-prompt header (half the prompt) so the prefix
        # cache has something to hit on this synthetic trace
        half = args.prompt_len // 2
        prompt["tokens"][:, :half] = prompt["tokens"][0, :half]
    if cfg.frontend:
        # the frontends are stubs: zero embeddings, as the reference feeds
        key = "patch_embeds" if cfg.frontend == "vision" else "frame_embeds"
        prompt[key] = torch.zeros(
            (args.requests, cfg.frontend_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=args.device)

    cass = None
    if args.variant:
        cass = CassandraConfig(variant=args.variant, gamma=args.gamma)
        calib = None
        if args.calibrate:
            calib = Calibrator()
            with torch.inference_mode():
                forward_train(Runtime(cfg=cfg, collector=calib), params,
                              prompt)
        params = format_params(params, cass, calib=calib)
        print(format_line(params_nbytes(params)))

    ecfg = EngineConfig(gamma=args.gamma, greedy=args.greedy)
    rt_extra = {}
    if args.attn_chunk_q is not None:
        rt_extra["attn_chunk_q"] = args.attn_chunk_q
    if args.attn_chunk_k is not None:
        rt_extra["attn_chunk_k"] = args.attn_chunk_k
    telem = Telemetry(trace=args.trace_out is not None,
                      trace_capacity=args.trace_capacity)
    if args.scheduler:
        run_scheduler(args, cfg, params, cass, prompt["tokens"], ecfg,
                      rt_extra, telem)
        return
    eng = Engine(cfg, params, cass=cass, ecfg=ecfg, device=args.device,
                 rt_extra=rt_extra)
    t0 = time.perf_counter()
    tokens, stats = eng.generate(
        prompt, max_new=args.max_new,
        generator=torch.Generator(device=args.device).manual_seed(args.seed),
        speculative=args.variant != 0, telemetry=telem)
    dt = time.perf_counter() - t0
    if args.trace_out:
        write_trace(args.trace_out, telem.tracer)
        print(f"[telemetry] perfetto trace -> {args.trace_out}")
    if args.metrics_out:
        write_metrics(args.metrics_out, telem.metrics.snapshot())
        print(f"[telemetry] metrics jsonl -> {args.metrics_out}")
    print(f"[serve] {tokens.shape[0]} reqs, cycles={stats['cycles']}, "
          f"tokens/cycle={stats['tokens_per_cycle']:.2f}, "
          f"acceptance={stats['acceptance']}, wall={dt:.1f}s "
          f"on {args.device}")
    if args.variant and stats["acceptance"] is not None:
        est = speedup_model(stats["acceptance"], args.gamma,
                            draft_cost_ratio=0.33)
        print(f"[model] bandwidth-model speedup estimate at this "
              f"acceptance: {est:.2f}x over bf16")
    print("first request tokens:",
          [int(t) for t in tokens[0].tolist() if t >= 0][:24])


def run_scheduler(args, cfg, params, cass, tokens: torch.Tensor,
                  ecfg: EngineConfig, rt_extra: dict,
                  telem: Telemetry) -> None:
    """Requests through the continuous-batching scheduler: arrivals every
    quarter cycle, odd requests carrying ``--stop-token``."""
    s_max = args.prompt_len + args.max_new + args.gamma + 1
    sched = Scheduler(cfg, params, cass=cass, ecfg=ecfg,
                      num_slots=args.slots, s_max=s_max,
                      speculative=args.variant != 0, paged=args.paged,
                      block_size=args.block_size, num_blocks=args.num_blocks,
                      chunk_size=args.chunk_size,
                      fused=not args.alternating,
                      max_prefill_tokens_per_step=(
                          args.max_prefill_tokens_per_step),
                      prefix_cache=args.prefix_cache,
                      prefix_cache_blocks=args.prefix_cache_blocks,
                      swap=args.swap,
                      swap_store_blocks=args.swap_store_blocks,
                      slo_aware=not args.fifo, attn_kernel=args.attn_kernel,
                      overlap=not args.no_overlap, telemetry=telem,
                      device=args.device, rt_extra=rt_extra)
    prompts = tokens.cpu().numpy()
    t0 = time.perf_counter()
    for i in range(args.requests):
        prio = args.priority[i % len(args.priority)] if args.priority else 0
        sched.submit(prompts[i % len(prompts)], max_new=args.max_new,
                     arrival=i / 4.0,
                     stop_tokens=args.stop_token if i % 2 else None,
                     priority=prio, ttft_deadline_ms=args.ttft_deadline_ms,
                     itl_target_ms=args.itl_target_ms)
    done = sched.run()
    dt = time.perf_counter() - t0
    s = sched.summary()
    mode = "fused" if sched.fused else "alternating"
    for line in format_stats_lines(s, mode=mode, wall_s=dt,
                                   n_done=len(done), slots=args.slots):
        print(line)
    print(f"[shapes] one operand shape per step: {s['trace_counts']} "
          f"on {args.device}")
    if args.trace_out:
        write_trace(args.trace_out, sched.telemetry.tracer)
        print(f"[telemetry] perfetto trace -> {args.trace_out}")
    if args.metrics_out:
        write_metrics(args.metrics_out, s)
        print(f"[telemetry] metrics jsonl -> {args.metrics_out}")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: {len(r.output)} tokens, first {r.output[:8]}")


if __name__ == "__main__":
    run()
