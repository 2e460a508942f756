"""Offline model-to-Cassandra-format transformation (port of
``core/packing.py``).

``format_params`` walks a parameter tree and replaces every large matmul
weight with its packed ``{"spec", "verif"}`` partition; embeddings, norms
and biases stay full precision. Stacked (R, in, out) weights are packed
layer by layer and their leaves stacked back along R, as the reference's
``vmap`` does.

Unlike the reference, which rebuilds the draft kernel's operands inside
every draft matmul, ``format_params`` then prepares them once
(``kernels.draft_matmul.prepare_params``): each packed weight gains a
``"kernel"`` dict (``exp3``/``emax``/``book``) resident beside its spec.
The verify pass still reads ``exp_words``, so ``exp3`` is extra resident
bytes, the size of ``exp_words`` (~11% of bf16 at the paper defaults);
``params_nbytes`` reports them as their own zone.

Wanda calibration (``Calibrator``) joins in a later slice (ROADMAP
Queue 1); without it the score is |W|, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import format as fmt
from repro_torch.core.format import CassandraConfig

_SKIP_PARENTS = {"router"}


def _should_pack(parent_key: str, w: torch.Tensor) -> bool:
    if parent_key in _SKIP_PARENTS:
        return False
    if w.ndim not in (2, 3):
        return False
    n_in, n_out = w.shape[-2], w.shape[-1]
    if n_in < 64 or n_out < 8:
        return False
    return n_in % 32 == 0


def _stack(trees: list[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _pack_weight(w: torch.Tensor, cass: CassandraConfig, trim: bool) -> dict:
    def one(wl):
        wt = wl.T.contiguous()
        scores = wt.to(torch.float32).abs()
        block = cass.weight_block(wl.shape[0])
        keep = cass.weight_keep(block)
        return fmt.format_tensor(wt, scores, cass, block, keep,
                                 cass.mx_group, cass.weight_trunc)

    if w.ndim == 2:
        spec, verif = one(w)
    else:
        parts = [one(w[r]) for r in range(w.shape[0])]
        spec = _stack([p[0] for p in parts])
        verif = _stack([p[1] for p in parts])
    if trim:
        spec, verif = fmt._trim_lossless(spec, verif, cass.variant)
    return {"spec": spec, "verif": verif}


def format_params(params, cass: CassandraConfig, calib=None,
                  trim: bool = True):
    """Replace packable weights with Cassandra partitions and prepare the
    draft kernel's operands beside each spec (see module doc)."""
    if calib is not None:
        raise NotImplementedError(
            "Wanda calibration is not ported yet: ROADMAP Queue 1 "
            "(Calibrator / --calibrate)")
    from repro_torch.kernels.draft_matmul import prepare_params

    def walk(node, parent_key: str):
        if isinstance(node, dict):
            if "w" in node and not isinstance(node["w"], dict):
                if _should_pack(parent_key, node["w"]):
                    out = dict(node)
                    out["w"] = _pack_weight(node["w"], cass, trim)
                    return out
                return node
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, parent_key) for v in node]
        return node

    return prepare_params(walk(params, ""), cass)


def params_nbytes(params) -> dict[str, int]:
    """Byte accounting: plain vs spec vs verif vs prepared kernel operands,
    and ``bf16``: what the packed weights would take as bf16."""
    acc = {"plain": 0, "spec": 0, "verif": 0, "kernel": 0, "bf16": 0}

    def walk(node, zone):
        if isinstance(node, dict):
            if "spec" in node and "verif" in node:
                acc["bf16"] += node["spec"]["bitmap"].numel() * 32 * 2
                for z in ("spec", "verif", "kernel"):
                    if z in node:
                        walk(node[z], z)
                return
            for v in node.values():
                walk(v, zone)
        elif isinstance(node, list):
            for v in node:
                walk(v, zone)
        elif isinstance(node, torch.Tensor):
            acc[zone] += node.numel() * node.element_size()

    walk(params, "plain")
    return acc
