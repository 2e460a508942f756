"""Cassandra-1 unary exponent decode (the paper's Alg. 1 parallel zero
counter): the plain version and the wrapper around the hand-written CUDA
kernel.

The kernel (``csrc/unary_decode.cu``) replaces the TPU kernel
``unary_decode`` (``src/repro/kernels/unary_decode.py``): a packed unary
region (W uint32 words, little-endian bits) holds codes of ``rank`` zeros
ended by a one; code j's rank is ``pos_j - pos_{j-1} - 1``, where
``pos_j`` is the position of the (j+1)-th set bit (``W * 32`` when the
region holds fewer) and ``pos_{-1} = -1``, clipped to [0, 31]. On a
region the encoder wrote in unary mode (exactly K set bits) this is the
reference's ``coding.unary_decode_block`` bit for bit; delta-mode regions
give ranks the caller discards (``core/coding.py::decode_exponents``).

* ``ranks_from_bits`` / ``unary_decode_plain`` — the same math in
  PyTorch: the CPU path and the kernel's oracle (also the unary step of
  the packed paged-attention kernel's plain decode).
* ``unary_decode`` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel (counted in ``unary_decode.launches``)
  or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.kernels import build

MAX_RANK = 32


def ranks_from_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """(R, n) 0/1 stream -> (R, k) int32 ranks in [0, 31]. ``pos[j]``
    counts the positions whose running count of ones is below j+1 (the
    strict compare: the position of the (j+1)-th set bit, n when there
    are fewer); the running count is non-decreasing, so the count is a
    left-sided search."""
    idx = torch.cumsum(bits, dim=-1, dtype=torch.int32)
    ks = torch.arange(1, k + 1, dtype=torch.int32, device=bits.device)
    pos = torch.searchsorted(idx, ks.expand(bits.shape[0], k).contiguous(),
                             side="left").to(torch.int32)
    prev = torch.cat([torch.full_like(pos[:, :1], -1), pos[:, :-1]], dim=-1)
    return (pos - prev - 1).clamp(0, MAX_RANK - 1)


def unary_decode_plain(words: torch.Tensor, k: int) -> torch.Tensor:
    """(..., W) int32 regions -> (..., k) int32 ranks in [0, 31]."""
    lead, w = words.shape[:-1], words.shape[-1]
    bits = bitops.unpack_bits(words.reshape(-1, w), w * 32)
    return ranks_from_bits(bits, k).reshape(*lead, k)


def unary_decode(words: torch.Tensor, k: int) -> torch.Tensor:
    """(..., W) int32 (uint32 bit-view) regions -> (..., k) int32 ranks.

    CPU tensors take :func:`unary_decode_plain`; CUDA tensors launch the
    kernel or raise."""
    if words.device.type == "cpu":
        return unary_decode_plain(words, k)
    if words.device.type != "cuda":
        raise ValueError(f"unary_decode: unsupported device {words.device}")
    lead, w = tuple(words.shape[:-1]), words.shape[-1]
    if k < 1 or w < 1:
        raise ValueError(f"unary_decode: k={k}, W={w} (both must be >= 1)")
    build.check(words, "words", torch.int32, (*lead, w))
    out = torch.empty((*lead, k), dtype=torch.int32, device=words.device)
    rows = words.numel() // w
    if rows == 0:
        return out
    fn = build.entry("unary_decode", "unary_decode_launch", 2, 3)
    err = fn(words.data_ptr(), out.data_ptr(), rows, w, k,
             torch.cuda.current_stream(words.device).cuda_stream)
    build.raise_on(err, "unary_decode")
    unary_decode.launches += 1
    return out


unary_decode.launches = 0
