"""MX (microscaling) shared-exponent format for Cassandra-2 (port of
``core/mx.py``).

Groups of ``G`` values share one 8-bit exponent (the group max). Each value
becomes a fixed-point mantissa inside a 16-bit container::

    m16 = (1.mmmmmmm << 8) >> (E_shared - e)     # explicit leading 1

which is bit-exact whenever the exponent gap is <= 8. The draft model reads
only the top ``draft_bits`` of ``m16`` plus the sign; the verification
payload is the remaining low bits.

``m16`` is stored as an int16 bit-view of the reference's uint16 (the
bridge's convention for uint16 payloads); every function masks it back to
0..65535 before shifting, so no shift ever sign-extends. Shift amounts are
clamped before use: PyTorch leaves shifts by negative or oversized amounts
to the platform, where the reference discards those lanes by select.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops

CONTAINER_BITS = 16


def _u16(m16: torch.Tensor) -> torch.Tensor:
    """A 16-bit container (any integer dtype) as int32 in 0..65535."""
    return m16.to(torch.int32) & 0xFFFF


def mx_encode(x: torch.Tensor, group: int = 32) -> dict:
    """Encode bf16 (..., K) (K divisible by ``group``) into MX form.

    Returns ``{"sign": (...,K) uint8, "m16": (...,K) int16 bit-view,
    "shared_exp": (..., K//group) uint8}``.
    """
    k = x.shape[-1]
    if k % group != 0:
        raise ValueError(f"K={k} not divisible by group={group}")
    sign, exp, mant = bitops.split_fields(x)
    g = (*x.shape[:-1], k // group, group)
    exp_g = exp.reshape(g).to(torch.int32)
    shared = exp_g.amax(-1)                                   # (..., K//group)
    gap = shared[..., None] - exp_g
    # explicit leading 1 (none when exp == 0: bf16 zero/subnormals)
    m9 = torch.where(exp_g == 0, 0, mant.reshape(g).to(torch.int32) | 0x80)
    m16 = (m9 << 8) >> gap.clamp(0, 31)
    return {"sign": sign,
            "m16": bitops.as_int16(m16.reshape(x.shape)),
            "shared_exp": shared.to(torch.uint8)}


def _clz16(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of 16-bit values in int32 (16 for x == 0)."""
    n = torch.where(x == 0, 16, 0).to(torch.int32)
    y = x
    for sh, mask in ((8, 0x00FF), (4, 0x0FFF), (2, 0x3FFF), (1, 0x7FFF)):
        cond = y <= mask
        n = n + torch.where((x != 0) & cond, sh, 0).to(torch.int32)
        y = torch.where(cond, y << sh, y)
    return n


def mx_decode(enc: dict, group: int = 32,
              keep_bits: int = CONTAINER_BITS) -> torch.Tensor:
    """Decode MX form back to bf16 (draft view when keep_bits < 16).

    ``keep_bits`` keeps only the top bits of the container (mantissa
    truncation inside MX).
    """
    m16 = _u16(enc["m16"])
    if keep_bits < CONTAINER_BITS:
        drop = CONTAINER_BITS - keep_bits
        m16 = (m16 >> drop) << drop
    k = m16.shape[-1]
    g = (*m16.shape[:-1], k // group, group)
    m16g = m16.reshape(g)
    shared = enc["shared_exp"][..., None].to(torch.int32)
    lead = 15 - _clz16(m16g)                                  # -1 if m16 == 0
    e = shared - (15 - lead)
    is_zero = (m16g == 0) | (e <= 0)
    # mantissa: the 7 bits below the leading one
    shift = (lead - 7).clamp(-7, 8)
    mant = torch.where(shift >= 0, m16g >> shift.clamp(min=0),
                       m16g << (-shift).clamp(min=0)) & 0x7F
    exp_f = torch.where(is_zero, 0, e.clamp(0, 255))
    mant_f = torch.where(is_zero, 0, mant)
    sign = enc["sign"].reshape(g)
    return bitops.join_fields(sign, exp_f, mant_f).reshape(m16.shape)


def pack_draft(enc: dict, draft_bits: int = 4) -> dict:
    """Extract the draft payload: sign + top ``draft_bits`` of m16."""
    top = _u16(enc["m16"]) >> (CONTAINER_BITS - draft_bits)
    code = (enc["sign"].to(torch.int32) << draft_bits) | top
    if draft_bits == 3:
        return {"code": bitops.pack_nibbles(code.to(torch.uint8)),
                "shared_exp": enc["shared_exp"]}
    return {"code": code.to(torch.uint8), "shared_exp": enc["shared_exp"]}


def unpack_draft(packed: dict, draft_bits: int = 4,
                 k: int | None = None) -> dict:
    """Inverse of :func:`pack_draft`; returns an MX dict (draft view)."""
    code = packed["code"]
    if draft_bits == 3:
        code = bitops.unpack_nibbles(code)
        if k is not None:
            code = code[..., :k]
    code = code.to(torch.int32)
    sign = (code >> draft_bits) & 1
    m16 = (code & ((1 << draft_bits) - 1)) << (CONTAINER_BITS - draft_bits)
    return {"sign": sign.to(torch.uint8), "m16": bitops.as_int16(m16),
            "shared_exp": packed["shared_exp"]}
