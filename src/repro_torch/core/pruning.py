"""Fixed-count per-superblock selection (port of ``core/pruning.py``).

Weights keep a fixed count per 512-value superblock (rounded to a multiple
of 32), KV vectors per head_dim (multiple of 16). Ties at the threshold go
to the earlier position, and kept values stay in position order so that
de-sparsification is a prefix-sum scatter. Wanda scores (calibration)
join with ``Calibrator`` in a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops

WEIGHT_BLOCK = 512
WEIGHT_KEEP_MULTIPLE = 32
KV_KEEP_MULTIPLE = 16


def keep_count(block: int, prune_ratio: float, multiple: int) -> int:
    """Static keep count for a block: round((1-p)*block) to a multiple."""
    k = int(round(block * (1.0 - prune_ratio) / multiple)) * multiple
    return max(multiple, min(block, k))


def select_topk_blocked(values: torch.Tensor, scores: torch.Tensor,
                        keep: int, block: int) -> dict:
    """Partition a (..., N) tensor into kept/pruned per block of ``block``.

    Returns ``bitmap`` (..., NB, block//32) int32 words, ``kept``
    (..., NB, keep) in position order and ``pruned`` (..., NB, block-keep).
    """
    n = values.shape[-1]
    if n % block != 0:
        raise ValueError(f"last dim {n} not divisible by block {block}")
    nb = n // block
    v = values.reshape(*values.shape[:-1], nb, block)
    s = scores.reshape(*scores.shape[:-1], nb, block).to(torch.float32)
    kth = torch.sort(s, dim=-1, descending=True).values[..., keep - 1:keep]
    ge = s > kth
    eq = s == kth
    n_ge = ge.sum(-1, keepdim=True, dtype=torch.int32)
    eq_rank = torch.cumsum(eq, dim=-1, dtype=torch.int32) - 1
    take_eq = eq & (eq_rank < (keep - n_ge))
    mask = ge | take_eq                                  # exactly keep ones
    bitmap = bitops.pack_bits(mask)
    # stable compaction: kept values first, each side in position order
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    gathered = torch.gather(v, -1, order)
    return {"bitmap": bitmap, "kept": gathered[..., :keep],
            "pruned": gathered[..., keep:]}


def desparsify(bitmap: torch.Tensor, kept: torch.Tensor, block: int,
               pruned: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter kept (and optionally pruned) values back to (..., NB*block)."""
    if pruned is not None and pruned.shape[-1] == 0:
        pruned = None
    mask = bitops.unpack_bits(bitmap, block)              # (..., NB, block)
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32) - 1
    keep = kept.shape[-1]
    kidx = rank.clamp(0, keep - 1).to(torch.int64)
    dense = torch.gather(kept, -1, kidx)
    if pruned is None:
        dense = torch.where(mask, dense, torch.zeros_like(dense))
    else:
        prank = torch.cumsum(~mask, dim=-1, dtype=torch.int32) - 1
        pidx = prank.clamp(0, pruned.shape[-1] - 1).to(torch.int64)
        dense = torch.where(mask, dense, torch.gather(pruned, -1, pidx))
    return dense.reshape(*dense.shape[:-2], -1)
