"""The online KV encoder's top-k selection (paper Fig. 8b): the plain
version and the wrapper around the hand-written CUDA kernel.

The kernel (``csrc/kv_topk.cu``) replaces the TPU kernel ``kv_topk``
(``src/repro/kernels/kv_topk.py``). Per (token, head) vector of ``d``
bf16 values it ranks by magnitude — ``rank_i = #{j : |v_j| > |v_i|} +
#{j < i : |v_j| == |v_i|}``, |v| in f32 — keeps ``rank < keep``, and
returns the bitmap of kept positions (``(…, d/32)`` int32 words), the kept
values in position order and, beside them, the pruned values in position
order (the verification side's raw payload). On finite values this is
``pruning.select_topk_blocked(v, |v|, keep, d)`` bit for bit, which is how
``core/format.py::format_tensor`` selects when one block spans the vector
(every KV encode: prefill chunks and verify commits).

The values are moved, never recomputed: a kept -0.0 stays -0.0 (the TPU
kernel's one-hot product would return +0.0; the reference's serving path,
``select_topk_blocked``, keeps the bits, as here). With NaNs more than
``keep`` lanes can rank below ``keep``; the kept slots then hold the first
``keep`` of them and the pruned slots past the unkept count are zero.

* ``kv_topk_plain`` — the same math in PyTorch: the CPU path and the
  kernel's oracle.
* ``kv_topk`` — the wrapper: a CPU tensor takes the plain version; a CUDA
  tensor launches the kernel (counted in ``kv_topk.launches``) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128, 256, 512)  # one lane holds d/32 of a vector
_PAIRS_PER_CHUNK = 1 << 26           # pairwise compares per row chunk


def _select(v: torch.Tensor, keep: int) -> tuple:
    """(R, d) -> (mask (R, d) bool, kept (R, keep), pruned (R, d-keep))."""
    r, d = v.shape
    av = v.to(torch.float32).abs()
    gt = av[:, None, :] > av[:, :, None]                     # [r, i, j]
    eq = av[:, None, :] == av[:, :, None]
    ar = torch.arange(d, device=v.device)
    earlier = ar[None, :] < ar[:, None]                     # j < i
    rank = (gt | (eq & earlier)).sum(-1, dtype=torch.int32)
    mask = rank < keep
    kdst = torch.cumsum(mask, -1, dtype=torch.int32) - 1
    pdst = torch.cumsum(~mask, -1, dtype=torch.int32) - 1
    kdst = torch.where(mask & (kdst < keep), kdst, keep).to(torch.int64)
    pdst = torch.where(~mask & (pdst < d - keep), pdst, d - keep).to(
        torch.int64)
    # moved as 16-bit patterns: a bf16 scatter on the CPU rewrites NaN bits
    vb = v.view(torch.int16)
    kept = vb.new_zeros((r, keep + 1)).scatter_(1, kdst, vb)[:, :keep]
    pruned = vb.new_zeros((r, d - keep + 1)).scatter_(1, pdst, vb)
    return mask, kept.view(v.dtype), pruned[:, :d - keep].view(v.dtype)


def kv_topk_plain(v: torch.Tensor, keep: int) -> dict:
    """(..., d) vectors -> ``bitmap`` (..., d/32) int32, ``kept``
    (..., keep) and ``pruned`` (..., d-keep) in position order."""
    lead, d = v.shape[:-1], v.shape[-1]
    v2 = v.reshape(-1, d)
    chunk = max(1, _PAIRS_PER_CHUNK // (d * d))     # 4096 rows at d = 128
    parts = [_select(v2[lo:lo + chunk], keep)
             for lo in range(0, v2.shape[0], chunk)] or [_select(v2, keep)]
    mask, kept, pruned = (torch.cat(p) for p in zip(*parts))
    return {"bitmap": bitops.pack_bits(mask).reshape(*lead, d // 32),
            "kept": kept.reshape(*lead, keep),
            "pruned": pruned.reshape(*lead, d - keep)}


def kv_topk(v: torch.Tensor, keep: int) -> dict:
    """(..., d) bf16 vectors -> ``bitmap`` (..., d/32) int32, ``kept``
    (..., keep) bf16 and ``pruned`` (..., d-keep) bf16, both in position
    order. CPU tensors take :func:`kv_topk_plain`; CUDA tensors launch the
    kernel or raise."""
    if v.device.type == "cpu":
        return kv_topk_plain(v, keep)
    if v.device.type != "cuda":
        raise ValueError(f"kv_topk: unsupported device {v.device}")
    lead, d = tuple(v.shape[:-1]), v.shape[-1]
    if d not in HEAD_DIMS or not 0 < keep <= d:
        raise ValueError(f"kv_topk: d={d}, keep={keep}; the kernel takes d "
                         f"in {HEAD_DIMS} and 0 < keep <= d")
    build.check(v, "v", torch.bfloat16, (*lead, d))
    dev = v.device
    out = {"bitmap": torch.empty((*lead, d // 32), dtype=torch.int32,
                                 device=dev),
           "kept": torch.empty((*lead, keep), dtype=torch.bfloat16,
                               device=dev),
           "pruned": torch.empty((*lead, d - keep), dtype=torch.bfloat16,
                                 device=dev)}
    rows = v.numel() // d
    if rows == 0:
        return out
    fn = build.entry("kv_topk", "kv_topk_launch", 4, 3)
    err = fn(v.data_ptr(), out["bitmap"].data_ptr(), out["kept"].data_ptr(),
             out["pruned"].data_ptr(), rows, d, keep,
             torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(err, "kv_topk")
    kv_topk.launches += 1
    return out


kv_topk.launches = 0
