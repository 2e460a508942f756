"""Serving driver for the port: batched requests through the fixed-batch
Cassandra engine on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --variant 1 --gamma 3 --max-new 32 --requests 4

``--variant 0`` runs the bf16 autoregressive baseline. ``--smoke`` takes
the reduced config; ``--device cpu`` runs the plain versions on the CPU.
Weights are random, drawn from ``--seed``. The continuous-batching
scheduler's flags come with the paged slice (ROADMAP Queue 1 step 6).
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
from repro_torch.serving.engine import Engine, EngineConfig


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
    args = ap.parse_args(argv)

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


if __name__ == "__main__":
    run()
