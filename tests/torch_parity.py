"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages;
results are compared as raw bits (integer and bf16 leaves) or as f32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import bridge

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def rand_bf16_np(rng: np.random.Generator, shape, scale=1.0) -> np.ndarray:
    """Random bf16 values as an ml_dtypes array (via jnp)."""
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return np.array(jnp.asarray(x, jnp.bfloat16))


def outlier_bf16_np(rng: np.random.Generator, shape) -> np.ndarray:
    """bf16 (in, out) weight whose first columns span ~2^±6 more per value,
    so their superblocks overflow the unary region (mode 1), kept and
    pruned side alike, while staying inside the 4-bit correction's exact
    range."""
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, :4] *= np.exp2(rng.integers(-6, 7, size=(shape[0], 4)))
    return np.array(jnp.asarray(w, jnp.bfloat16))


def to_port(tree, device="cpu"):
    """A JAX (or numpy) tree as the port's tensor tree."""
    return bridge.params_from_numpy(jax.device_get(tree), device)


def clone_tree(tree):
    """A copy of a tensor tree (the port's caches are written in place)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def bits(a) -> np.ndarray:
    """Raw bit pattern of a leaf from either package, as unsigned numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.asarray(jax.device_get(a))
    if a.dtype.name == "bfloat16" or a.dtype == np.int16:
        return a.view(np.uint16)
    if a.dtype == np.int32 and a.dtype.name != "bfloat16":
        return a.view(np.uint32)
    return a


def assert_bitwise(port, ref, path="") -> None:
    """Same keys, shapes and bits, leaf by leaf."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            assert_bitwise(port[k], ref[k], f"{path}.{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_bitwise(p, r, f"{path}[{i}]")
        return
    pb, rb = bits(port), bits(ref)
    assert pb.shape == rb.shape, (path, pb.shape, rb.shape)
    if rb.dtype == np.uint32:
        pb = pb.astype(np.uint32)
    np.testing.assert_array_equal(pb, rb.astype(pb.dtype), err_msg=path)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float32).numpy()
    return np.asarray(jax.device_get(a)).astype(np.float32)

