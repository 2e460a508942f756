"""The online KV encoder (paper Fig. 8b): the top-k selection's plain
version and the wrappers around the hand-written CUDA kernels, the
selection alone and the whole Cassandra-1 vector encode.

The kernel (``csrc/kv_topk.cu``) replaces the TPU kernel ``kv_topk``
(``src/repro/kernels/kv_topk.py``). Per (token, head) vector of ``d``
bf16 values it ranks by magnitude — ``rank_i = #{j : |v_j| > |v_i|} +
#{j < i : |v_j| == |v_i|}``, |v| in f32 — keeps ``rank < keep``, and
returns the bitmap of kept positions (``(…, d/32)`` int32 words), the kept
values in position order and, beside them, the pruned values in position
order (the verification side's raw payload). On finite values this is
``pruning.select_topk_blocked(v, |v|, keep, d)`` bit for bit, which is how
``core/format.py::format_tensor`` selects when one block spans the vector
(the Cassandra-2 KV encode, and the plain chain of the Cassandra-1 one).

The values are moved, never recomputed: a kept -0.0 stays -0.0 (the TPU
kernel's one-hot product would return +0.0; the reference's serving path,
``select_topk_blocked``, keeps the bits, as here). With NaNs more than
``keep`` lanes can rank below ``keep``; the kept slots then hold the first
``keep`` of them and the pruned slots past the unkept count are zero.

The kernel selects by a radix select over the 15-bit magnitude keys
``bits & 0x7FFF`` (``tests/test_torch_kv_codec.py`` holds that rule, in
numpy, to ``kv_topk_plain``).

* ``kv_topk_plain`` — the same math in PyTorch: the CPU path and the
  kernel's oracle.
* ``kv_topk`` — the wrapper: a CPU tensor takes the plain version; a CUDA
  tensor launches the kernel (counted in ``kv_topk.launches``) or raises.
* ``kv_encode`` — a Cassandra-1 KV store's leaves from (…, d) bf16
  vectors in one launch (``kv_encode.launches``): the selection above,
  then the format's split, codes and exponent region
  (``serving/kvcache.py::encode_store`` on the card). It takes CUDA
  tensors only: its plain version is the chain
  ``kvcache.encode_store_plain``, which CPU tensors run.
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


# ---------------------------------------------------------------------------
# kv_encode: a Cassandra-1 KV store's leaves in one launch
# ---------------------------------------------------------------------------

def _words(k: int, width: int) -> int:
    return (k * width + 31) // 32


def kv_encode(x: torch.Tensor, rank_of_exp: torch.Tensor, *, keep: int,
              trunc: int, exp_bits: int) -> tuple[dict, dict]:
    """(..., d) bf16 vectors -> the (spec, verif) leaves of a Cassandra-1
    KV store as ``kvcache.encode_store_plain`` writes them (one block per
    vector, 8-bit corrections, raw pruned values): ``spec`` bitmap,
    signmant, exp_words, exp_mode, exp_emax; ``verif`` mant_lo, exp_corr,
    pruned_raw (absent when ``keep == d``), each (..., 1, ·).

    CUDA tensors launch the kernel (counted in ``kv_encode.launches``) or
    raise; other devices raise."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"kv_encode: unsupported device {dev} (the plain "
                         f"chain is kvcache.encode_store_plain)")
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    if (d not in HEAD_DIMS or not 0 < keep <= d or keep % 16
            or not 0 <= trunc <= 7 or not 1 <= exp_bits <= 8):
        raise ValueError(f"kv_encode: d={d}, keep={keep}, trunc={trunc}, "
                         f"exp_bits={exp_bits}; the kernel takes d in "
                         f"{HEAD_DIMS}, keep <= d a multiple of 16, trunc in "
                         f"[0, 7] and exp_bits in [1, 8]")
    build.check(x, "x", torch.bfloat16, (*lead, d))
    if rank_of_exp.dtype != torch.uint8 or rank_of_exp.shape != (256,) \
            or not rank_of_exp.is_cuda or not rank_of_exp.is_contiguous():
        raise ValueError("rank_of_exp must be a contiguous (256,) uint8 "
                         "tensor on the card")
    i32, u8 = torch.int32, torch.uint8

    def leaf(width: int, dtype=i32):
        return torch.empty((*lead, 1, width), dtype=dtype, device=dev)

    spec = {"signmant": leaf(_words(keep, 8 - trunc)),
            "bitmap": leaf(d // 32),
            "exp_words": leaf(_words(keep, exp_bits)),
            "exp_mode": torch.empty((*lead, 1), dtype=u8, device=dev),
            "exp_emax": torch.empty((*lead, 1), dtype=u8, device=dev)}
    verif = {"mant_lo": leaf(_words(keep, trunc)),
             "exp_corr": leaf(keep, u8)}
    if keep < d:
        verif["pruned_raw"] = leaf(d - keep, torch.int16)
    rows = x.numel() // d
    if rows == 0:
        return spec, verif
    if rows >= 2 ** 31:
        raise ValueError(f"kv_encode: {rows} vectors in one launch")
    ptr = (lambda t: 0 if t is None or t.numel() == 0 else t.data_ptr())
    fn = build.entry("kv_topk", "kv_encode_launch", 10, 5)
    err = fn(x.data_ptr(), rank_of_exp.data_ptr(), ptr(spec["bitmap"]),
             ptr(spec["signmant"]), ptr(spec["exp_words"]),
             ptr(spec["exp_mode"]), ptr(spec["exp_emax"]),
             ptr(verif["mant_lo"]), ptr(verif["exp_corr"]),
             ptr(verif.get("pruned_raw")), rows, d, keep, trunc, exp_bits,
             build.stream(x))
    build.raise_on(err, "kv_encode")
    kv_encode.launches += 1
    return spec, verif


kv_encode.launches = 0
