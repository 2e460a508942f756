"""Serving entry point of the port: requests through the fixed-batch Cassandra
engine, or through the continuous-batching scheduler, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --variant 1 --gamma 3 --max-new 32 --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --variant 1 --scheduler --paged --attn-kernel on --slots 4

``--variant 0`` runs the bf16 autoregressive baseline. ``--smoke`` takes
the reduced config; ``--device cpu`` runs the plain versions on the CPU.
Weights are random, drawn from ``--seed``. The prefix cache
(``--prefix-cache``, ``--shared-header``) and preemption (``--swap``) come
with ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.core.packing import format_params, params_nbytes
from repro_torch.core.speculative import speedup_model
from repro_torch.models.model import init_params
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
    ap.add_argument("--variant", type=int, default=1, choices=[0, 1],
                    help="0=bf16 baseline, 1=Cassandra-1")
    ap.add_argument("--gamma", type=int, default=3)
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
                    "requests): higher admitted first")
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

    cass = None
    if args.variant:
        cass = CassandraConfig(variant=args.variant, gamma=args.gamma)
        params = format_params(params, cass)
        print(format_line(params_nbytes(params)))

    if args.scheduler:
        run_scheduler(args, cfg, params, cass, prompt["tokens"])
        return
    eng = Engine(cfg, params, cass=cass,
                 ecfg=EngineConfig(gamma=args.gamma), device=args.device)
    t0 = time.perf_counter()
    tokens, stats = eng.generate(prompt, max_new=args.max_new,
                                 speculative=args.variant != 0)
    dt = time.perf_counter() - t0
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


def run_scheduler(args, cfg, params, cass, tokens: torch.Tensor) -> None:
    """Requests through the continuous-batching scheduler: arrivals every
    quarter cycle, odd requests carrying ``--stop-token``."""
    s_max = args.prompt_len + args.max_new + args.gamma + 1
    telem = Telemetry(trace=args.trace_out is not None,
                      trace_capacity=args.trace_capacity)
    sched = Scheduler(cfg, params, cass=cass,
                      ecfg=EngineConfig(gamma=args.gamma),
                      num_slots=args.slots, s_max=s_max,
                      speculative=args.variant != 0, paged=args.paged,
                      block_size=args.block_size, num_blocks=args.num_blocks,
                      chunk_size=args.chunk_size,
                      fused=not args.alternating,
                      max_prefill_tokens_per_step=(
                          args.max_prefill_tokens_per_step),
                      slo_aware=not args.fifo, attn_kernel=args.attn_kernel,
                      overlap=not args.no_overlap, telemetry=telem,
                      device=args.device)
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
