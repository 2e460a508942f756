"""AdamW with fp32 or block-quantized int8 moments (port of
``training/optim.py``).

Int8 moments store m and v as int8 with one f32 scale per 256-value block
of the last axis; each step dequantizes, updates and requantizes, so the
quantization error feeds back through the stored state. The state tree is
the reference's: ``{"step", "m", "v"}``, an int8 moment ``{"q", "scale"}``.

The update runs under ``torch.no_grad()`` and writes the parameters (in
their storage dtype) and the moments in place. It walks each leaf of two
or more axes in slices of its leading axis (``SLICE_ELEMS`` elements at
most): the update is elementwise and the int8 blocks lie on the last
axis, so a slice computes what the whole leaf would, bit for bit, while
the f32 temporaries stay one slice wide (Llama-3-8B's stacked ``w_gate``
is 7.5 GB in f32). The global norm sums in chunks of its own
(``NORM_ELEMS``), so the slicing never changes a bit of the result.

Every f32 scalar (the learning rate, the bias corrections, the clip) is
an f32 tensor computed as ``jnp`` computes it. No division has a Python
float on either side: torch takes ``float / tensor`` as a reciprocal
times the float, and CUDA divides by a host scalar as a multiply by its
reciprocal; both round differently from a division.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import flat_up_to, tree_leaves, tree_map

PyTree = Any
QBLOCK = 256
SLICE_ELEMS = 1 << 26              # a slice's f32 temporary: 256 MB
NORM_ELEMS = 1 << 26               # the global norm's fixed reduction chunk


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"       # fp32 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor) -> dict:
    """Blockwise int8 quantization along the LAST axis, shape-preserving:
    ``q`` has the input's shape with the last axis padded to a multiple of
    256, ``scale`` one f32 per block; each value is divided by its block's
    max-abs / 127 and rounded half to even."""
    n = x.shape[-1]
    pad = (-n) % QBLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, QBLOCK)
    # a divisor on x's device: CUDA divides by a host scalar as a multiply
    # by its reciprocal, which rounds differently
    scale = blocks.abs().amax(-1, keepdim=True) / torch.tensor(
        127.0, device=x.device)
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale[..., 0]}


def _dq8(s: dict, shape) -> torch.Tensor:
    q = s["q"].reshape(*s["q"].shape[:-1], -1, QBLOCK)
    x = (q.to(torch.float32) * s["scale"][..., None]).reshape(s["q"].shape)
    return x[..., :shape[-1]].reshape(shape)


def _moment_init(p: torch.Tensor, dtype: str):
    """Zero moments; an int8 one is ``_q8`` of zeros (zero codes and
    scales), made without an f32 copy of the leaf."""
    if dtype != "int8":
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    n = p.shape[-1]
    padded = n + (-n) % QBLOCK
    lead = tuple(p.shape[:-1])
    return {"q": torch.zeros(lead + (padded,), dtype=torch.int8,
                             device=p.device),
            "scale": torch.zeros(lead + (padded // QBLOCK,),
                                 dtype=torch.float32, device=p.device)}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def init_opt_state(params: PyTree, cfg: OptConfig) -> dict:
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(lambda p: _moment_init(p, cfg.state_dtype), params),
        "v": tree_map(lambda p: _moment_init(p, cfg.state_dtype), params),
    }


def _f32(x, device=None) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up, then a cosine from lr to lr / 10, as an f32 tensor
    (``step`` an int or an int32 tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    dev, f32 = step.device, torch.float32
    warm = torch.clamp(step.to(f32) / _f32(max(cfg.warmup_steps, 1), dev),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(f32)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf, a leaf summed in
    fixed chunks of its leading axis (``NORM_ELEMS`` at most), the leaves
    in tree order."""
    total = 0
    for x in tree_leaves(tree):
        s = 0
        for sl in leading_slices(x.shape, NORM_ELEMS):
            s = s + torch.sum(torch.square(x[sl].to(torch.float32)))
        total = total + s
    return torch.sqrt(total)


def leading_slices(shape, slice_elems: int) -> list:
    """Index slices of a leaf's leading axis, each at most ``slice_elems``
    elements (at least one row); a leaf of fewer than two axes, or one that
    fits, is one slice."""
    n = 1
    for d in shape:
        n *= d
    if len(shape) < 2 or n <= slice_elems:
        return [slice(None)]
    row = n // shape[0]
    step = max(1, slice_elems // row)
    return [slice(i, min(i + step, shape[0]))
            for i in range(0, shape[0], step)]


def _read(s, sl, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        part = {"q": s["q"][sl], "scale": s["scale"][sl]}
        return _dq8(part, shape)
    return s[sl]


def _write(s, sl, x: torch.Tensor, dtype: str) -> None:
    if dtype == "int8":
        qs = _q8(x)
        s["q"][sl].copy_(qs["q"])
        s["scale"][sl].copy_(qs["scale"])
    else:
        s[sl].copy_(x)


def apply_updates(params: PyTree, grads: PyTree, opt_state: dict,
                  cfg: OptConfig) -> tuple[PyTree, dict, dict]:
    """One AdamW step, in place: the parameters stay in their storage dtype
    and the moments in their format. Returns (params, opt_state, {grad_norm,
    lr}) as the reference does; ``params`` and the moments are the trees
    passed in, written, and ``step`` a new tensor."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        dev = step.device
        gn = global_norm(grads)
        clip = torch.clamp(_f32(cfg.grad_clip, dev)
                           / torch.clamp(gn, min=1e-9), max=1.0)
        lr = lr_schedule(cfg, step)
        bc1 = 1 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1 - cfg.b2 ** step.to(torch.float32)
        flat_p = tree_leaves(params)
        flat_g = flat_up_to(params, grads)
        flat_m = flat_up_to(params, opt_state["m"])
        flat_v = flat_up_to(params, opt_state["v"])
        st = cfg.state_dtype
        for p, g_all, m_s, v_s in zip(flat_p, flat_g, flat_m, flat_v):
            for sl in leading_slices(p.shape, SLICE_ELEMS):
                pp = p[sl]
                g = g_all[sl].to(torch.float32) * clip
                m = _read(m_s, sl, pp.shape, st)
                v = _read(v_s, sl, pp.shape, st)
                m = cfg.b1 * m + (1 - cfg.b1) * g
                v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                if p.ndim >= 2:                # decoupled decay on matrices
                    upd = upd + cfg.weight_decay * pp.to(torch.float32)
                pp.copy_((pp.to(torch.float32) - lr * upd).to(p.dtype))
                _write(m_s, sl, m, st)
                _write(v_s, sl, v, st)
    return (params, {"step": step, "m": opt_state["m"], "v": opt_state["v"]},
            {"grad_norm": gn, "lr": lr})
