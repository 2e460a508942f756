"""Design-space exploration of the Cassandra format (paper §VII-B.2, Eq. 2;
port of ``core/dse.py``).

The objective trades acceptance rate against compression::

    J = alpha / (S_w (1-w_p)(B-w_t) + S_kv (1-kv_p)(B-kv_t))

Higher J = more generated tokens per byte of draft traffic. The paper's
grid: pruning 30..60% step 10, truncation 0..5 bits step 1; the dominant
term (weights vs KV bytes) is optimized first. Everything here is Python
floats, so the ranked points equal the reference's field for field and in
order (ties keep the order of a stable sort).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable

BF16_BITS = 16


@dataclasses.dataclass(frozen=True)
class DSEPoint:
    weight_prune: float
    weight_trunc: int
    kv_prune: float
    kv_trunc: int
    alpha: float
    objective: float
    draft_ratio: float


def objective(alpha: float, s_w: float, s_kv: float, w_p: float, w_t: int,
              kv_p: float, kv_t: int, bits: int = BF16_BITS) -> float:
    """Eq. 2 of the paper."""
    denom = s_w * (1 - w_p) * (bits - w_t) + s_kv * (1 - kv_p) * (bits - kv_t)
    return alpha / max(denom, 1e-12)


def grid_search(
    acceptance_fn: Callable[[float, int, float, int], float],
    s_w: float, s_kv: float,
    prune_grid: Iterable[float] = (0.3, 0.4, 0.5, 0.6),
    trunc_grid: Iterable[int] = (0, 1, 2, 3, 4, 5),
    optimize_dominant_first: bool = True,
) -> list[DSEPoint]:
    """The paper's practical DSE: grid-search the dominant term first.

    ``acceptance_fn(w_p, w_t, kv_p, kv_t) -> alpha`` is measured on a small
    development set (8 samples in the paper). When ``s_w != s_kv`` the
    dominant term is swept with the other at the paper's default (0.4, 4),
    then the minor term with the dominant one at its best; otherwise the
    full product. Returns the points sorted by J, highest first.
    """
    prune_grid = tuple(prune_grid)
    trunc_grid = tuple(trunc_grid)
    points: list[DSEPoint] = []

    def evaluate(w_p, w_t, kv_p, kv_t):
        alpha = float(acceptance_fn(w_p, w_t, kv_p, kv_t))
        j = objective(alpha, s_w, s_kv, w_p, w_t, kv_p, kv_t)
        total = s_w + s_kv
        draft_ratio = (s_w * (1 - w_p) * (BF16_BITS - w_t)
                       + s_kv * (1 - kv_p) * (BF16_BITS - kv_t)) / (
                           total * BF16_BITS)
        points.append(DSEPoint(w_p, w_t, kv_p, kv_t, alpha, j, draft_ratio))
        return j

    if optimize_dominant_first and s_w != s_kv:
        dom_is_w = s_w >= s_kv
        best, best_j = (0.4, 4), -1.0
        for p, t in itertools.product(prune_grid, trunc_grid):
            args = (p, t, 0.4, 4) if dom_is_w else (0.4, 4, p, t)
            j = evaluate(*args)
            if j > best_j:
                best, best_j = (p, t), j
        for p, t in itertools.product(prune_grid, trunc_grid):
            args = (*best, p, t) if dom_is_w else (p, t, *best)
            evaluate(*args)
    else:
        for w_p, w_t, kv_p, kv_t in itertools.product(
                prune_grid, trunc_grid, prune_grid, trunc_grid):
            evaluate(w_p, w_t, kv_p, kv_t)

    points.sort(key=lambda pt: -pt.objective)
    return points
