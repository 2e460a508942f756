"""Offline model-to-Cassandra-format transformation (port of
``core/packing.py``).

``format_params`` walks a parameter tree and replaces every large matmul
weight with its packed ``{"spec", "verif"}`` partition; embeddings, norms
and biases stay full precision. Stacked (R, in, out) weights are packed
layer by layer and their leaves stacked back along R, as the reference's
``vmap`` does. As in the reference, only 2-D and 3-D leaves pack: MoE
experts, stacked (R, E, in, out), stay plain bf16, the router (under
``router``) stays f32, and a shared expert packs like a dense MLP.

Unlike the reference, which rebuilds the draft kernel's operands inside
every draft matmul, ``format_params`` then prepares them once
(``kernels.draft_matmul.prepare_params``): each packed weight gains a
``"kernel"`` dict (``exp3``/``emax``/``book``) resident beside its spec.
The verify pass still reads ``exp_words``, so ``exp3`` is extra resident
bytes, the size of ``exp_words`` (~11% of bf16 at the paper defaults);
``params_nbytes`` reports them as their own zone.

Wanda calibration: ``Calibrator`` records per-input-channel activation
L2 norms during a calibration forward (``models.model.forward_train`` with
``Runtime(collector=...)``); ``format_params`` looks each weight up by its
path in the tree (``dec[0].e0.attn.wq``, ``lm_head``), as the reference
walks it. Without calibration, or for a weight with no norm, the score is
|W| (magnitude pruning).

The reference observes inside its layer scan, where the values are traced
and skipped, and under the layer functions' own labels (``attn.wq``,
``ffn.gate``), which its walk never asks for: only ``lm_head`` is
calibrated there. The port's layers are a Python loop, so
``model._scan_groups`` tells the calibrator which layer runs
(``Calibrator.layer``) and each layer function observes under its weight's
key in the tree: every packed weight of a stacked group gets an (R, in)
norm, one row per layer.
"""
from __future__ import annotations

import torch

from repro_torch.core import format as fmt
from repro_torch.core.format import CassandraConfig

_SKIP_PARENTS = {"router"}


class Calibrator:
    """Collects per-path activation L2 norms (Wanda's ||act||_2).

    Sums of squares accumulate in f32 on the activations' device, per path
    and, inside a layer group (``layer``), per layer: ``act_norm`` of a
    group's path stacks its layers in order, (R, in), as the stacked
    weight (R, in, out) it scores.
    """

    def __init__(self):
        self.sq_sums: dict[str, torch.Tensor | dict] = {}
        self.counts: dict[str, int] = {}
        self._scope: tuple[str, int] | None = None

    def layer(self, prefix: str | None, r: int | None = None) -> None:
        """Observe under ``prefix`` (a group entry's tree path, e.g.
        ``dec[0].e0``) as layer ``r``; ``None`` leaves the scope."""
        self._scope = None if prefix is None else (prefix, r)

    def observe(self, path: str, x: torch.Tensor) -> None:
        flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
        sq = flat.square().sum(0)
        if self._scope is None:
            key, slot = path, self.sq_sums
            name = path
        else:
            prefix, r = self._scope
            key = f"{prefix}.{path}"
            slot = self.sq_sums.setdefault(key, {})
            name = r
        prev = slot.get(name)
        slot[name] = sq if prev is None or prev.shape != sq.shape \
            else prev + sq
        self.counts[key] = self.counts.get(key, 0) + flat.shape[0]

    def act_norm(self, path: str) -> torch.Tensor | None:
        sq = self.sq_sums.get(path)
        if sq is None:
            return None
        if isinstance(sq, dict):
            if sorted(sq) != list(range(len(sq))):
                return None
            sq = torch.stack([sq[r] for r in range(len(sq))])
        return torch.sqrt(sq)


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


def _pack_weight(w: torch.Tensor, act_norm, cass: CassandraConfig,
                 trim: bool) -> dict:
    if w.ndim == 2:
        spec, verif = fmt.weight_parts(w, act_norm, cass)
    else:
        parts = [fmt.weight_parts(w[r], None if act_norm is None
                                  else act_norm[r], cass)
                 for r in range(w.shape[0])]
        spec = _stack([p[0] for p in parts])
        verif = _stack([p[1] for p in parts])
    if trim:
        spec, verif = fmt._trim_lossless(spec, verif, cass.variant)
    return {"spec": spec, "verif": verif}


def format_params(params, cass: CassandraConfig,
                  calib: Calibrator | None = None, trim: bool = True):
    """Replace packable weights with Cassandra partitions and prepare the
    draft kernel's operands beside each spec (see module doc). With
    ``calib``, a weight whose path has a norm of its input width is scored
    by Wanda, any other by |W|. A multi-token-prediction head (``mtp``,
    read by the training loss only) is left out of the served tree."""
    from repro_torch.kernels.draft_matmul import prepare_params

    def walk(node, parent_key: str, path: str):
        if isinstance(node, dict):
            if "w" in node and not isinstance(node["w"], dict):
                w = node["w"]
                if _should_pack(parent_key, w):
                    an = calib.act_norm(path) if calib is not None else None
                    if an is not None and (an.shape[-1] != w.shape[-2]
                                           or an.ndim != w.ndim - 1):
                        an = None
                    out = dict(node)
                    out["w"] = _pack_weight(w, an, cass, trim)
                    return out
                return node
            return {k: walk(v, k, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, parent_key, f"{path}[{i}]")
                    for i, v in enumerate(node)]
        return node

    params = {k: v for k, v in params.items() if k != "mtp"}
    return prepare_params(walk(params, "", ""), cass)


def packed_paths(params) -> list[str]:
    """The tree path of every packed weight, as ``format_params`` walks
    them (the keys ``Calibrator.act_norm`` is asked for)."""
    out = []

    def walk(node, path: str):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], dict) \
                    and "spec" in node["w"]:
                out.append(path)
                return
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")

    walk(params, "")
    return out


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
