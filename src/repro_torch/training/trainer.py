"""train_step: loss, gradients (with microbatch accumulation) and AdamW
(port of ``training/trainer.py``).

The reference differentiates its jitted loss with ``jax.value_and_grad``;
here autograd does it eagerly: the parameter leaves are detached from the
caller's tree (the same storage) and marked ``requires_grad``, the loss is
``models.model.loss_fn`` and ``torch.autograd.grad`` returns one gradient
per leaf in the leaf's dtype (bf16 for bf16 weights, as the reference's).
The optimizer then writes the caller's tree in place. Gradient
compression (int8 round trip, ``sharding.collectives.compress_grads``)
hooks in with ``TrainConfig.grad_compress``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime
from repro_torch.training import optim as O


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptConfig = O.OptConfig()
    accum_steps: int = 1
    z_loss: float = 1e-4
    balance_coef: float = 1e-2
    grad_compress: bool = False     # int8 error-feedback gradient exchange


def _value_and_grad(rt: Runtime, params, batch, tcfg: TrainConfig):
    """(metrics, grads): the loss's metrics (detached) and its gradient
    with respect to every parameter leaf, in the leaf's dtype."""
    flat = tree_leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(rt, tree_unflatten(params, leaves),
                                  batch,
                                  z_loss=tcfg.z_loss,
                                  balance_coef=tcfg.balance_coef)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_unflatten(params, grads)


def grads_fn(rt: Runtime, params, batch: dict, tcfg: TrainConfig):
    """(grads, metrics) with optional microbatch accumulation: the batch
    splits into ``accum_steps`` microbatches along its first axis, their
    gradients are summed in f32 and divided by their number (f32 grads,
    as the reference's scan gives); the metrics are the last
    microbatch's."""
    if tcfg.accum_steps <= 1:
        metrics, grads = _value_and_grad(rt, params, batch, tcfg)
        return grads, metrics
    n = tcfg.accum_steps
    rows, rest = divmod(next(iter(batch.values())).shape[0], n)
    if rest:
        raise ValueError(f"a batch of {rows * n + rest} rows does not split "
                         f"into {n} microbatches")
    acc = None
    for i in range(n):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        metrics, g = _value_and_grad(rt, params, mb, tcfg)
        flat = [x.to(torch.float32) for x in tree_leaves(g)]
        acc = flat if acc is None else [a + x for a, x in zip(acc, flat)]
        del g
    nt = torch.tensor(n, dtype=torch.float32, device=acc[0].device)
    return tree_unflatten(params, [a / nt for a in acc]), metrics


def train_step(rt: Runtime, params, opt_state, batch,
               tcfg: TrainConfig = TrainConfig()):
    """One optimizer step; writes ``params`` and ``opt_state``'s moments in
    place. Returns (params, opt_state, metrics): the loss's metrics, with
    ``compress_err`` under ``grad_compress``, and the optimizer's
    ``grad_norm`` and ``lr``."""
    grads, metrics = grads_fn(rt, params, batch, tcfg)
    if tcfg.grad_compress:
        from repro_torch.sharding import collectives as C
        grads, err = C.compress_grads(grads)
        metrics = dict(metrics)
        metrics["compress_err"] = err
    params, opt_state, opt_metrics = O.apply_updates(
        params, grads, opt_state, tcfg.opt)
    return params, opt_state, {**metrics, **opt_metrics}
