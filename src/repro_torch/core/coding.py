"""Exponent codecs of the Cassandra format (port of ``core/coding.py``).

Each superblock has a fixed exponent region of ``exp_bits`` bits per kept
value. A per-block 1-bit mode selects the representation:

* ``mode 0`` — the paper's unary stream over frequency ranks (bit-exact);
* ``mode 1`` — ``exp_bits``-wide delta from the block's max exponent
  (draft-approximate; a correction on the verification side restores it).

The unary ranks decode through ``kernels/unary_decode.py`` (the CUDA
kernel on the card; its plain version, a prefix sum and a search, on the
CPU): the ranks of the reference's ``unary_decode_block`` on every
unary-mode region. The two differ only on regions with fewer than K set
bits — delta-mode regions, whose ranks ``decode_exponents`` discards.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.kernels import unary_decode as UD

MAX_RANK = 32
CORR_BITS = 4


def region_words(k: int, exp_bits: int) -> int:
    """int32 words of the per-block exponent region (static)."""
    return (k * exp_bits + 31) // 32


# ---------------------------------------------------------------------------
# Codebook (frequency-ranked exponent symbols)
# ---------------------------------------------------------------------------

def build_codebook(exps: torch.Tensor):
    """Frequency-ranked codebook: ``(exp_of_rank[256], rank_of_exp[256])``.

    Rank 0 is the most frequent exponent; ties keep the smaller exponent
    first (stable order). Exponents that never occur rank 255.
    """
    counts = torch.bincount(exps.reshape(-1).to(torch.int64), minlength=256)
    order = torch.argsort(-counts, stable=True)
    exp_of_rank = order.to(torch.uint8)
    rank_of_exp = torch.zeros(256, dtype=torch.int64, device=exps.device)
    rank_of_exp[order] = torch.arange(256, device=exps.device)
    rank_of_exp = torch.where(counts > 0, rank_of_exp, 255)
    return exp_of_rank, rank_of_exp.to(torch.uint8)


# ---------------------------------------------------------------------------
# Mode 0: unary coding
# ---------------------------------------------------------------------------

def unary_encode_block(ranks: torch.Tensor, n_bits: int):
    """Encode ranks (..., K) into a unary bitstream (..., n_bits) of bools.

    Returns ``(bits, ok)``; ``ok`` marks blocks whose stream fits the
    region and whose ranks are all < MAX_RANK.
    """
    lens = ranks.to(torch.int32) + 1
    ends = torch.cumsum(lens, dim=-1, dtype=torch.int32) - 1
    total = ends[..., -1] + 1
    ok = (total <= n_bits) & (ranks < MAX_RANK).all(-1)
    pos = ends.clamp(0, n_bits - 1).to(torch.int64)
    bits = torch.zeros((*ranks.shape[:-1], n_bits), dtype=torch.bool,
                       device=ranks.device)
    bits.scatter_(-1, pos, True)
    return bits, ok


def unary_decode_block(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Decode a unary bitstream (..., n_bits) of bools into uint8 ranks
    (..., K): the reference's oracle. A stable argsort of ``~bits`` puts
    the positions of the ones first, in order (then those of the zeros,
    which a region with fewer than K ones reads as its later codes), and
    ``rank_j = pos_j - pos_{j-1} - 1`` clipped to [0, MAX_RANK - 1]. The
    serving paths decode through ``kernels/unary_decode.py`` instead; the
    two agree on every region with at least K ones."""
    notbits = (~bits.to(torch.bool)).to(torch.uint8)
    positions = torch.argsort(notbits, dim=-1, stable=True)[..., :k].to(
        torch.int32)
    prev = torch.cat([torch.full_like(positions[..., :1], -1),
                      positions[..., :-1]], dim=-1)
    return (positions - prev - 1).clamp(0, MAX_RANK - 1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Mode 1: delta-from-block-max
# ---------------------------------------------------------------------------

def delta_encode_block(exps: torch.Tensor, emax: torch.Tensor,
                       exp_bits: int, corr_bits: int = CORR_BITS):
    """Delta-code exps (..., K) against emax (...,). Returns (codes, corr)."""
    esc = (1 << exp_bits) - 1
    cmax = (1 << corr_bits) - 1
    delta = emax[..., None].to(torch.int32) - exps.to(torch.int32)
    code = delta.clamp(0, esc - 1)
    code = torch.where(exps == 0, esc, code)
    corr = (delta - code).clamp(0, cmax - 1)
    corr = torch.where(exps == 0, cmax, corr)
    return code.to(torch.uint8), corr.to(torch.uint8)


def delta_decode_block(codes: torch.Tensor, emax: torch.Tensor,
                       exp_bits: int, corr: torch.Tensor | None = None,
                       corr_bits: int = CORR_BITS) -> torch.Tensor:
    """Inverse of :func:`delta_encode_block` (draft view if corr is None)."""
    esc = (1 << exp_bits) - 1
    cmax = (1 << corr_bits) - 1
    delta = codes.to(torch.int32)
    if corr is not None:
        delta = delta + torch.where(corr == cmax, 0, corr.to(torch.int32))
    e = (emax[..., None].to(torch.int32) - delta).clamp(0, 255)
    zero = (codes == esc) if corr is None else ((codes == esc)
                                                & (corr == cmax))
    return torch.where(zero, 0, e).to(torch.uint8)


# ---------------------------------------------------------------------------
# Packed region codec (mode dispatch)
# ---------------------------------------------------------------------------

def _pack_fixed(codes: torch.Tensor, exp_bits: int,
                n_bits: int) -> torch.Tensor:
    """(..., K) codes of exp_bits each -> (..., n_bits) bool stream."""
    k = codes.shape[-1]
    c = codes.to(torch.uint8)
    sh = torch.arange(exp_bits, dtype=torch.uint8, device=c.device)
    flat = ((c[..., None] >> sh) & 1).reshape(*codes.shape[:-1],
                                                k * exp_bits).to(torch.bool)
    pad = n_bits - k * exp_bits
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat


def _unpack_fixed(bits: torch.Tensor, exp_bits: int, k: int) -> torch.Tensor:
    sel = bits[..., : k * exp_bits].reshape(*bits.shape[:-1], k, exp_bits)
    s = sel.to(torch.uint8)
    sh = torch.arange(exp_bits, dtype=torch.uint8, device=s.device)
    return (s << sh).sum(-1, dtype=torch.uint8)


def trim_codebook(exp_of_rank: torch.Tensor) -> torch.Tensor:
    """Keep only the MAX_RANK entries the unary decoder can address."""
    return exp_of_rank[:MAX_RANK]


def encode_exponents(exps: torch.Tensor, rank_of_exp: torch.Tensor,
                     exp_bits: int = 3, corr_bits: int = CORR_BITS) -> dict:
    """Encode blocked exponents (..., NB, K) into the packed spec region.

    Returns ``words`` (..., NB, region_words) int32, ``mode`` and ``emax``
    (..., NB) uint8, ``corr`` (..., NB, K//2 or K) uint8.
    """
    k = exps.shape[-1]
    n_bits = region_words(k, exp_bits) * 32
    ranks = rank_of_exp[exps.to(torch.int64)]
    ubits, ok = unary_encode_block(ranks, n_bits)
    emax = exps.amax(-1)
    dcodes, dcorr = delta_encode_block(exps, emax, exp_bits, corr_bits)
    dbits = _pack_fixed(dcodes, exp_bits, n_bits)
    mode = torch.where(ok, 0, 1).to(torch.uint8)
    bits = torch.where(ok[..., None], ubits, dbits)
    corr = torch.where(ok[..., None], 0, dcorr).to(torch.uint8)
    return {
        "words": bitops.pack_bits(bits),
        "mode": mode,
        "emax": emax.to(torch.uint8),
        "corr": bitops.pack_nibbles(corr) if corr_bits == 4 else corr,
    }


def decode_exponents(region: dict, exp_of_rank: torch.Tensor, k: int,
                     exp_bits: int = 3, exact: bool = False,
                     corr_bits: int = CORR_BITS) -> torch.Tensor:
    """Decode the packed spec region back to uint8 exponents (..., NB, K).

    ``exact=False`` is the draft view; ``exact=True`` applies the
    verification corrections when present.
    """
    n_bits = region_words(k, exp_bits) * 32
    bits = bitops.unpack_bits(region["words"], n_bits)
    uranks = UD.unary_decode(region["words"].contiguous(), k)
    uexps = exp_of_rank[uranks.to(torch.int64)]
    dcodes = _unpack_fixed(bits, exp_bits, k)
    corr = None
    if exact and region.get("corr") is not None:
        if corr_bits == 4:
            corr = bitops.unpack_nibbles(region["corr"])[..., :k]
        else:
            corr = region["corr"][..., :k]
    dexps = delta_decode_block(dcodes, region["emax"], exp_bits, corr=corr,
                               corr_bits=corr_bits)
    is_unary = (region["mode"] == 0)[..., None]
    return torch.where(is_unary, uexps, dexps).to(torch.uint8)


# ---------------------------------------------------------------------------
# Exponent statistics (paper Fig. 6)
# ---------------------------------------------------------------------------

def avg_code_bits(exps: torch.Tensor, rank_of_exp: torch.Tensor
                  ) -> torch.Tensor:
    """Average unary code length in bits a value (Fig. 6(b)), f32."""
    ranks = rank_of_exp[exps.reshape(-1).to(torch.int64)]
    return (ranks.to(torch.float32).clamp(max=MAX_RANK - 1) + 1.0).mean()


def shannon_entropy(exps: torch.Tensor) -> torch.Tensor:
    """Shannon entropy in bits of the exponent distribution (Fig. 6(a)),
    f32."""
    counts = torch.bincount(exps.reshape(-1).to(torch.int64), minlength=256)
    p = counts.to(torch.float32) / counts.sum().clamp(min=1).to(torch.float32)
    logp = torch.log2(torch.where(p > 0, p, torch.ones_like(p)))
    return -torch.where(p > 0, p * logp, torch.zeros_like(p)).sum()
