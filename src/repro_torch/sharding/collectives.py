"""int8 gradient compression (port of ``sharding/collectives.py``'s
``compress_grads``).

Every gradient leaf goes through an int8 round trip, blockwise over its
last axis (256 values a block, one f32 scale each, rounded half to even)
before the data-parallel reduction would run; the moments see the
dequantized value, so error feedback happens through the optimizer state.
A leaf of two or more axes is walked in slices of its leading axis, as
the optimizer walks it (the blocks lie on the last axis, so the codes are
the same). ``int8_psum`` waits for the sharding item (ROADMAP Queue 1
item 4, with ``sharding/rules.py`` and ``launch/mesh.py``): one card has
no reduction to run.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.training import optim as O


def _quantize(g: torch.Tensor) -> torch.Tensor:
    """The f32 dequantized int8 round trip of ``g`` (ndim >= 1)."""
    return O._dq8(O._q8(g.to(torch.float32)), g.shape)


def compress_grads(grads):
    """int8 round trip on every gradient leaf; returns (grads, max_err),
    max_err the largest |dequantized - g| over every leaf (f32)."""
    errs = []

    def one(g):
        if g.ndim == 0:
            return g
        out = torch.empty_like(g)
        for sl in O.leading_slices(g.shape, O.SLICE_ELEMS):
            dq = _quantize(g[sl])
            errs.append(torch.max(torch.abs(dq - g[sl].to(torch.float32))))
            out[sl] = dq.to(g.dtype)
        return out

    with torch.no_grad():
        out = tree_map(one, grads)
        err = (torch.max(torch.stack(errs)) if errs else
               torch.zeros((), dtype=torch.float32))
    return out, err
