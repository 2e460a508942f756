"""Bit-level manipulation of bfloat16 tensors (port of ``core/bitops.py``).

bfloat16 layout (MSB..LSB): 1 sign | 8 exponent | 7 mantissa.

Packed words keep the reference's uint32 bit layout but live in int32
tensors (bit-views): PyTorch's CPU kernels refuse shifts on ``uint32``.
Expansions work on bytes — a word is viewed as its four little-endian
bytes and shifted in ``uint8`` — so no int32 right shift ever
sign-extends, and intermediates stay one byte per bit.
"""
from __future__ import annotations

import torch

SIGN_BITS = 1
EXP_BITS = 8
MANT_BITS = 7
EXP_BIAS = 127


def _shifts(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.uint8, device=like.device)


def bf16_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Bitcast bf16 -> int32 holding the 16-bit pattern (0..65535)."""
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def bits_to_bf16(bits: torch.Tensor) -> torch.Tensor:
    """Bitcast a 16-bit pattern (any integer dtype) -> bf16."""
    if bits.dtype == torch.int16:
        return bits.view(torch.bfloat16)
    b = bits.to(torch.int32) & 0xFFFF
    b = b - ((b & 0x8000) << 1)                 # two's-complement int16 range
    return b.to(torch.int16).view(torch.bfloat16)


def split_fields(x: torch.Tensor):
    """Split bf16 into (sign, exponent, mantissa) uint8 fields."""
    bits = bf16_to_bits(x)
    sign = (bits >> 15) & 0x1
    exp = (bits >> 7) & 0xFF
    mant = bits & 0x7F
    return sign.to(torch.uint8), exp.to(torch.uint8), mant.to(torch.uint8)


def join_fields(sign: torch.Tensor, exp: torch.Tensor,
                mant: torch.Tensor) -> torch.Tensor:
    """Reassemble bf16 from (sign, exponent, mantissa) fields."""
    bits = ((sign.to(torch.int32) << 15) | (exp.to(torch.int32) << 7)
            | (mant.to(torch.int32) & 0x7F))
    return bits_to_bf16(bits)


def truncate_mantissa(x: torch.Tensor, keep_bits: int):
    """Split bf16 into (truncated_value, dropped_low_bits uint8)."""
    if not 0 <= keep_bits <= MANT_BITS:
        raise ValueError(f"keep_bits must be in [0, {MANT_BITS}], got {keep_bits}")
    drop = MANT_BITS - keep_bits
    bits = bf16_to_bits(x)
    low_mask = (1 << drop) - 1
    dropped = (bits & low_mask).to(torch.uint8)
    kept = bits & (0xFFFF ^ low_mask)
    return bits_to_bf16(kept), dropped


def merge_mantissa(truncated: torch.Tensor, dropped_low_bits: torch.Tensor,
                   keep_bits: int) -> torch.Tensor:
    """Inverse of :func:`truncate_mantissa` — bit-exact reconstruction."""
    low_mask = (1 << (MANT_BITS - keep_bits)) - 1
    bits = bf16_to_bits(truncated)
    bits = bits | (dropped_low_bits.to(torch.int32) & low_mask)
    return bits_to_bf16(bits)


def pack_nibbles(vals: torch.Tensor) -> torch.Tensor:
    """Pack pairs of 4-bit values (uint8, last dim even) into uint8 bytes."""
    lo = vals[..., 0::2].to(torch.uint8) & 0xF
    hi = vals[..., 1::2].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(torch.uint8)


def pack_bits(bools: torch.Tensor) -> torch.Tensor:
    """Pack a boolean array (last dim multiple of 32) into int32 words.

    Bit i of word w is element w*32+i (little-endian bit order), the
    reference's uint32 layout.
    """
    *lead, n = bools.shape
    if n % 32 != 0:
        raise ValueError(f"last dim must be a multiple of 32, got {n}")
    b = bools.to(torch.uint8).reshape(*lead, n // 8, 8)
    byts = (b << _shifts(8, b)).sum(-1, dtype=torch.uint8)
    return byts.reshape(*lead, n // 32, 4).view(torch.int32).reshape(
        *lead, n // 32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns bool with last dim ``n``."""
    w = words.contiguous().view(torch.uint8)          # (..., W*4)
    bits = (w[..., None] >> _shifts(8, w)) & 1
    out = bits.reshape(*words.shape[:-1], words.shape[-1] * 32)
    return out[..., :n].to(torch.bool)


def pack_codes(codes: torch.Tensor, width: int,
               n_bits: int | None = None) -> torch.Tensor:
    """Pack (..., K) integer codes of ``width`` bits into int32 words.

    ``n_bits`` (default: K*width rounded up to 32) fixes the region size.
    Little-endian bit order within the region.
    """
    k = codes.shape[-1]
    if width == 0 or k == 0:
        return torch.zeros((*codes.shape[:-1], 0), dtype=torch.int32,
                           device=codes.device)
    if n_bits is None:
        n_bits = ((k * width + 31) // 32) * 32
    if width <= 8:
        c = codes.to(torch.uint8)
        bits = (c[..., None] >> _shifts(width, c)) & 1
    else:
        c = codes.to(torch.int64)
        sh = torch.arange(width, dtype=torch.int64, device=c.device)
        bits = (c[..., None] >> sh) & 1
    flat = bits.reshape(*codes.shape[:-1], k * width).to(torch.bool)
    pad = n_bits - k * width
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return pack_bits(flat)


def unpack_codes(words: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns (..., K) int32 codes."""
    if width == 0 or k == 0:
        return torch.zeros((*words.shape[:-1], k), dtype=torch.int32,
                           device=words.device)
    bits = unpack_bits(words, words.shape[-1] * 32)
    sel = bits[..., : k * width].reshape(*bits.shape[:-1], k, width)
    if width <= 8:
        s = sel.to(torch.uint8)
        return (s << _shifts(width, s)).sum(-1, dtype=torch.uint8).to(
            torch.int32)
    s = sel.to(torch.int64)
    sh = torch.arange(width, dtype=torch.int64, device=s.device)
    return (s << sh).sum(-1).to(torch.int32)
