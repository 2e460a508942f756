"""Carry a parameter (or cache) tree from numpy into the port.

The JAX package's PRNG cannot be reproduced in PyTorch, so the parity
tests convert the reference's tree to numpy (``jax.device_get``) and hand
it over here; both packages then compute on the same bits. Packed and
plain trees cross alike:

* bfloat16 (an ml_dtypes array, told by ``dtype.name``) goes through a
  16-bit integer view and ``.view(torch.bfloat16)``;
* uint32 words become int32 bit-views, uint16 payloads int16 bit-views;
* every other dtype is taken as it is.
"""
from __future__ import annotations

import numpy as np
import torch

_VIEWS = {"uint32": np.int32, "uint16": np.int16}


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))   # 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if a.dtype.name in _VIEWS:
        a = a.view(_VIEWS[a.dtype.name])
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree, device="cuda"):
    """Numpy tree (dicts/lists/tuples of arrays) -> the port's tensor tree."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return _leaf(np.asarray(tree), device)
    return tree
