"""Fault-tolerant training launcher (port of ``launch/train.py``):
checkpoint and auto-resume, a step-time straggler watchdog and failure
injection.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64

Runs on the card unless ``--device cpu``. A run that starts from step 0
saves a checkpoint of its initial state first; an injected failure (or
any ``RuntimeError`` of a step) restores the last complete checkpoint
and replays the data from its step, so a run that fails ends with the
parameters of one that did not. ``--ckpt-dir`` defaults to a directory
per architecture under the system's temporary directory (``TMPDIR``):
a run resumes from whatever complete checkpoint lies there. (The
reference reassigns its data iterator inside the ``for`` loop that
iterates the old one, so its replay never happens; the port's loop takes
the new iterator.)
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Prefetcher, synthetic_batches
from repro_torch.models.layers import Runtime
from repro_torch.models.model import init_mtp, init_params
from repro_torch.training import OptConfig, init_opt_state, train_step
from repro_torch.training.trainer import TrainConfig


class StragglerWatchdog:
    """EWMA step-time monitor: flags persistent stragglers.

    A step slower than ``threshold`` × the running mean is a strike;
    ``patience`` strikes in a row make a straggler, a normal step clears
    them. The policy is deterministic (tested on synthetic traces)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 patience: int = 3):
        self.threshold, self.alpha, self.patience = threshold, alpha, patience
        self.ewma: float | None = None
        self.strikes = 0

    def observe(self, dt: float) -> str:
        if self.ewma is None:
            self.ewma = dt
            return "ok"
        slow = dt > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.strikes += 1
            if self.strikes >= self.patience:
                return "straggler"
            return "slow"
        self.strikes = 0
        return "ok"


def run(argv=None):
    """Train; returns the final (params, opt_state)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: <TMPDIR>/repro_torch_ckpt/<arch>[-smoke]")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="failure injection: raise at this step once")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(
            tempfile.gettempdir(), "repro_torch_ckpt",
            args.arch + ("-smoke" if args.smoke else ""))
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            ap.error("--device cuda but CUDA is not available "
                     "(pass --device cpu for the plain versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch, smoke=args.smoke)
    rt = Runtime(cfg=cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, total_steps=args.steps,
                                     warmup_steps=max(args.steps // 10, 1)))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend=cfg.frontend,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model)

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    if cfg.mtp_depth > 0:
        params["mtp"] = init_mtp(cfg, gen, device=args.device)
    opt_state = init_opt_state(params, tcfg.opt)
    ckpt = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every,
                             async_save=True)
    start, (params, opt_state) = ckpt.resume((params, opt_state))
    if start:
        print(f"[resume] from step {start}")
    else:
        # a failure before the first periodic save restores this state:
        # the update writes the parameters in place
        ckpt.maybe_save(0, (params, opt_state))

    watchdog = StragglerWatchdog()
    failed_once = False
    data = Prefetcher(synthetic_batches(dcfg, start, args.device))
    while True:
        step, batch = next(data)
        if step >= args.steps:
            break
        t0 = time.time()
        try:
            if step == args.fail_at_step and not failed_once:
                failed_once = True
                raise RuntimeError("injected device failure")
            params, opt_state, metrics = train_step(rt, params, opt_state,
                                                    batch, tcfg)
            loss = float(metrics["loss"])
        except RuntimeError as e:
            # supervision: restore from the last checkpoint, replay its data
            print(f"[failure] step {step}: {e} — restoring")
            ckpt.wait()
            start, (params, opt_state) = ckpt.resume((params, opt_state))
            data = Prefetcher(synthetic_batches(dcfg, start, args.device))
            continue
        dt = time.time() - t0
        verdict = watchdog.observe(dt)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}")
        ckpt.maybe_save(step + 1, (params, opt_state))
        if step % 5 == 0 or verdict != "ok":
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f}ms [{verdict}]")
    ckpt.wait()
    print("done.")
    return params, opt_state


if __name__ == "__main__":
    run()
