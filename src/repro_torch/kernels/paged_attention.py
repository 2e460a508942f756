"""Paged decode attention over a block pool: plain versions and the
wrappers around the hand-written CUDA kernels.

The kernels (``csrc/paged_gqa.cu``, ``csrc/paged_mla.cu``) replace the TPU
kernels ``paged_gqa``, ``paged_gqa_packed`` and ``paged_mla``
(``src/repro/kernels/paged_attention.py``). Each walks each row's
``(B, MB)`` block table and folds every pool block into an online-softmax
(flash) state under the row's ``length`` mask, so the per-request prefix
is never gathered:

* ``paged_gqa`` — plain bf16 pool blocks ``(NB, BS, Hkv, D)``: the verify
  pass, prefill chunks and autoregressive steps;
* ``paged_gqa_packed`` — the pool blocks are the Cassandra-1 speculation
  leaves (bitmap / sign|mantissa codes / exponent words / mode / emax,
  ``(NB, BS, Hkv, 1, W)``); each block is decoded on chip before its
  flash step, so the draft pass's KV never exists densely in device
  memory (the paper's DRAM→L2 decoder module);
* ``paged_mla`` — MLA in latent space (absorbed math) over bf16 pools of
  the latent ``c`` ``(NB, BS, L)`` and the rope key ``kr`` ``(NB, BS, R)``:
  ``c`` is both the key and the value operand, its products on the tensor
  cores at f32 grade and its table cut by ``mla_split_plan`` while the
  grid leaves SMs idle. A packed MLA cache is decoded to its view before
  the walk (``models/model.py``).

Each returns the unnormalised flash state — ``(acc (B,Hkv,G,T,D) f32,
m (B,Hkv,G,T) f32, l (B,Hkv,G,T) f32)`` for GQA, ``(acc (B,H,T,L), m, l
(B,H,T))`` for MLA; ``merge_gqa_suffix`` / ``merge_mla_suffix`` fold in
the scratch/new-token suffix (which lives outside the pool) and normalise.

Each wrapper follows its tensors' device: CPU tensors take the plain
version (the reference's ``impl="jnp"`` math), CUDA tensors launch the
kernel (counted in ``<wrapper>.launches``) or raise. ``decode_spec_pool``
exposes the packed kernel's decode alone, for checking it bit for bit.
Packed words are int32 bit-views; every right shift is masked.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import bitops
from repro_torch.kernels import build
from repro_torch.kernels.unary_decode import ranks_from_bits

NEG_INF = -1e30
# unused table slots point at block 0, the trash block (the allocator's
# TRASH_BLOCK; kept local so kernels/ does not import serving/)
TRASH_BLOCK = 0
MAX_BLOCK_SIZE = 32             # the kernels stage one block of ≤ 32 tokens
HEAD_DIMS = (32, 64, 128)       # one lane holds D/32 of a query's dims
MLA_LATENT_DIMS = (32, 64, 128, 256, 512)   # 8 warps x tiles of 16 dims
MLA_MAX_ROPE = 128              # rope dims: a multiple of 8 (the k-steps)


def sanitize_table(table: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """Route out-of-range table entries through the trash block (int32)."""
    ok = (table >= 0) & (table < num_blocks)
    return torch.where(ok, table, TRASH_BLOCK).to(torch.int32)


# ---------------------------------------------------------------------------
# Cassandra C-1 speculation decode (the reference's draft view, bit for bit)
# ---------------------------------------------------------------------------

def _unpack_bits32(words: torch.Tensor, n: int) -> torch.Tensor:
    """(R, W) int32 words -> (R, n) int32 bits, little-endian."""
    r, w = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(r, w * 32)[:, :n]


def _unpack_codes32(words: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """(R, W) int32 words -> (R, k) int32 codes of ``width`` bits."""
    bits = _unpack_bits32(words, k * width).reshape(words.shape[0], k, width)
    shifts = torch.arange(width, dtype=torch.int32, device=words.device)
    return (bits << shifts).sum(-1, dtype=torch.int32)


def _decode_kv_rows(bitmap, signmant, exp_words, mode, emax, book32, *,
                    d: int, keep: int, trunc: int,
                    exp_bits: int) -> torch.Tensor:
    """Decode (R,) speculation rows -> (R, d) bf16: unary ranks through the
    32-entry book (mode 0) or 3-bit deltas below ``emax`` with the escape
    code read as 0 (mode 1), truncated mantissas, desparsified against the
    bitmap. The unary stream may run into the region's word padding, so
    ranks decode over the full region width."""
    r = bitmap.shape[0]
    t_keep = 7 - trunc
    width = 1 + t_keep
    esc = (1 << exp_bits) - 1
    code = _unpack_codes32(signmant, width, keep)
    sign = (code >> t_keep) & 1
    mant = (code & ((1 << t_keep) - 1)) << trunc
    ebits = _unpack_bits32(exp_words, exp_words.shape[1] * 32)
    uexp = book32[ranks_from_bits(ebits, keep).to(torch.int64)]
    dshift = torch.arange(exp_bits, dtype=torch.int32, device=bitmap.device)
    dcodes = (ebits[:, :keep * exp_bits].reshape(r, keep, exp_bits)
              << dshift).sum(-1, dtype=torch.int32)
    dexp = (emax.to(torch.int32)[:, None] - dcodes).clamp(0, 255)
    dexp = torch.where(dcodes == esc, 0, dexp)
    exp = torch.where((mode == 0)[:, None], uexp, dexp)
    kept16 = (sign << 15) | (exp << 7) | mant
    bbits = _unpack_bits32(bitmap, d)
    gidx = (torch.cumsum(bbits, dim=-1) - 1).clamp(0, keep - 1)
    dense16 = torch.gather(kept16, 1, gidx.to(torch.int64))
    dense16 = torch.where(bbits == 1, dense16, 0)
    return bitops.bits_to_bf16(dense16)


def _rows(leaf: torch.Tensor, rows: int) -> torch.Tensor:
    return leaf.reshape(rows, -1) if leaf.ndim > 4 else leaf.reshape(rows)


def decode_spec_pool_plain(spec: dict, book, *, d: int, keep: int,
                           trunc: int, exp_bits: int) -> torch.Tensor:
    """Spec leaves (NB, BS, Hkv, 1, W) -> bf16 pool (NB, BS, Hkv, d)."""
    nb, bs, hkv = spec["bitmap"].shape[:3]
    rows = nb * bs * hkv
    out = _decode_kv_rows(
        _rows(spec["bitmap"], rows), _rows(spec["signmant"], rows),
        _rows(spec["exp_words"], rows), _rows(spec["exp_mode"], rows),
        _rows(spec["exp_emax"], rows), book[:32].to(torch.int32), d=d,
        keep=keep, trunc=trunc, exp_bits=exp_bits)
    return out.reshape(nb, bs, hkv, d)


# ---------------------------------------------------------------------------
# Flash step and the gather-then-scan plain versions
# ---------------------------------------------------------------------------

def _gqa_block(q, kb, vb, valid, m, l, acc, *, scale: float):
    """One flash step over a (B, S, Hkv, D) block, rows batched.

    q (B,T,Hkv,G,D) f32 · kb/vb (B,S,Hkv,D) · valid (B,S) bool ·
    m/l (B,Hkv,G,T) f32 · acc (B,Hkv,G,T,D) f32. Invalid value rows are
    zeroed by select: a masked packed lane can decode to NaN."""
    vb = torch.where(valid[:, :, None, None], vb, 0)
    s = torch.einsum("bthgd,bshd->bhgts", q, kb.to(torch.float32)) * scale
    vm = valid[:, None, None, None, :]
    s = torch.where(vm, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgts,bshd->bhgtd", p, vb.to(torch.float32))
    return m_new, l_new, acc_new


def paged_gqa_plain(q, k_pool, v_pool, table, length, *, scale: float):
    """The table walk over plain pools, one flash step per table column."""
    b, t, hkv, g, _ = q.shape
    nb, bs = k_pool.shape[:2]
    dv = v_pool.shape[-1]
    table = sanitize_table(table, nb).to(torch.int64)
    length = length.to(torch.int32).reshape(-1).expand(b)
    qf = q.to(torch.float32)
    dev = q.device
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, t, dv), dtype=torch.float32, device=dev)
    ar = torch.arange(bs, device=dev)
    for j in range(table.shape[1]):
        blk = table[:, j]
        valid = j * bs + ar[None, :] < length[:, None]
        m, l, acc = _gqa_block(qf, k_pool[blk], v_pool[blk], valid, m, l,
                               acc, scale=scale)
    return acc, m, l


def _mla_block(q_eff, q_rope, cb, krb, valid, m, l, acc, *, scale: float):
    """One latent flash step over a (B, S, L)+(B, S, R) block, rows
    batched.

    q_eff (B,T,H,L) f32 · q_rope (B,T,H,R) f32 · cb/krb (B,S,·) · valid
    (B,S) bool · m/l (B,H,T) f32 · acc (B,H,T,L) f32. ``cb`` is both the
    score and the value operand, so one zeroed copy keeps a masked lane's
    NaN out of both."""
    vz = valid[:, :, None]
    cz = torch.where(vz, cb, 0).to(torch.float32)
    krz = torch.where(vz, krb, 0).to(torch.float32)
    s = (torch.einsum("bthl,bsl->bhts", q_eff, cz)
         + torch.einsum("bthr,bsr->bhts", q_rope, krz)) * scale
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhts,bsl->bhtl", p, cz)
    return m_new, l_new, acc_new


def paged_mla_plain(q_eff, q_rope, c_pool, kr_pool, table, length, *,
                    scale: float):
    """The latent table walk over plain pools, one flash step per table
    column (the reference's ``impl="jnp"`` branch)."""
    b, t, h, latent = q_eff.shape
    nb, bs = c_pool.shape[:2]
    table = sanitize_table(table, nb).to(torch.int64)
    length = length.to(torch.int32).reshape(-1).expand(b)
    qe, qr = q_eff.to(torch.float32), q_rope.to(torch.float32)
    dev = q_eff.device
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, latent), dtype=torch.float32, device=dev)
    ar = torch.arange(bs, device=dev)
    for j in range(table.shape[1]):
        blk = table[:, j]
        valid = j * bs + ar[None, :] < length[:, None]
        m, l, acc = _mla_block(qe, qr, c_pool[blk], kr_pool[blk], valid, m,
                               l, acc, scale=scale)
    return acc, m, l


def paged_gqa_packed_plain(q, k_spec, v_spec, table, length, book, *,
                           d: int, keep: int, trunc: int, exp_bits: int,
                           scale: float):
    """The packed walk: the same flash steps over the decoded pools (the
    decode is per row, so decoding the pool first gives the same bits as
    decoding each block in the walk)."""
    kw = dict(d=d, keep=keep, trunc=trunc, exp_bits=exp_bits)
    return paged_gqa_plain(q, decode_spec_pool_plain(k_spec, book, **kw),
                           decode_spec_pool_plain(v_spec, book, **kw),
                           table, length, scale=scale)


# ---------------------------------------------------------------------------
# The GQA kernels' table split (flash decoding) and its plain version
# ---------------------------------------------------------------------------

Q_TILE = 16                     # query rows (of G*T) per CTA
TARGET_CTAS = 4 * build.SM_COUNT


def gqa_split_plan(b: int, hkv: int, g: int, t: int, mb: int
                   ) -> tuple[int, int]:
    """(table blocks per CTA, splits) of both GQA kernels' grid
    (B·Hkv, splits, ⌈G·T/16⌉): splits reach ``TARGET_CTAS`` where the
    table allows."""
    ctas = b * hkv * -(-(g * t) // Q_TILE)
    want = max(1, min(max(mb, 1), -(-TARGET_CTAS // max(ctas, 1))))
    bps = -(-max(mb, 1) // want)
    return bps, -(-max(mb, 1) // bps)


def plain_split_plan(b: int, hkv: int, g: int, t: int, mb: int
                     ) -> tuple[int, int]:
    """``paged_gqa``'s plan: :func:`gqa_split_plan` while the (row, kv head,
    query tile) grid leaves SMs idle (the verify and draft-width passes);
    one walk of the whole table per CTA, in order, once the query tiles
    alone fill the card (a prefill chunk), so no merge reorders its sums."""
    if b * hkv * -(-(g * t) // Q_TILE) >= build.SM_COUNT:
        return max(mb, 1), 1
    return gqa_split_plan(b, hkv, g, t, mb)


_split_plan = functools.lru_cache(maxsize=1024)(gqa_split_plan)
_plain_plan = functools.lru_cache(maxsize=1024)(plain_split_plan)


def merge_flash_plain(parts):
    """Merge the flash states ``(acc, m, l)`` of consecutive table chunks,
    in chunk order: m = max m_s, l = Σ l_s·exp(m_s − m), acc = Σ
    acc_s·exp(m_s − m). Chunks that read nothing (m = −1e30, l = 0,
    acc = 0) add nothing; all empty gives the initial state."""
    m = parts[0][1]
    for _, ms, _ in parts[1:]:
        m = torch.maximum(m, ms)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for a_s, m_s, l_s in parts:
        c = torch.exp(m_s - m)
        acc = acc + a_s * c[..., None]
        l = l + l_s * c
    return acc, m, l


def paged_gqa_split_plain(q, k_pool, v_pool, table, length, *,
                          scale: float, blocks_per_split: int):
    """The kernels' split walk in plain torch: each chunk of
    ``blocks_per_split`` table columns walked into its own flash state
    (the row's length shifted to the chunk), then merged in chunk order."""
    bs = k_pool.shape[1]
    length = length.to(torch.int32).reshape(-1).expand(q.shape[0])
    parts = [paged_gqa_plain(q, k_pool, v_pool,
                             table[:, j0:j0 + blocks_per_split],
                             (length - j0 * bs).clamp_min(0), scale=scale)
             for j0 in range(0, max(table.shape[1], 1), blocks_per_split)]
    return merge_flash_plain(parts)


def paged_gqa_packed_split_plain(q, k_spec, v_spec, table, length, book, *,
                                 d: int, keep: int, trunc: int,
                                 exp_bits: int, scale: float,
                                 blocks_per_split: int):
    """The packed kernel's split walk in plain torch, over the decoded
    pools."""
    kw = dict(d=d, keep=keep, trunc=trunc, exp_bits=exp_bits)
    return paged_gqa_split_plain(
        q, decode_spec_pool_plain(k_spec, book, **kw),
        decode_spec_pool_plain(v_spec, book, **kw), table, length,
        scale=scale, blocks_per_split=blocks_per_split)


# ---------------------------------------------------------------------------
# paged_mla's table split and its plain version
# ---------------------------------------------------------------------------

MLA_Q_TILE = 32                 # (head, query) pairs per CTA
MLA_TARGET_CTAS = build.SM_COUNT    # one CTA an SM (its shared memory)


def mla_split_plan(b: int, h: int, t: int, mb: int) -> tuple[int, int]:
    """(table blocks per CTA, splits) of ``paged_mla``'s grid (B x
    ⌈H·T/32⌉ pair tiles, splits): while the tiles leave SMs idle (the draft
    and verify passes), each row's table is cut so that the CTAs fill one
    wave of ``MLA_TARGET_CTAS``; once the tiles alone fill the card (a prefill
    chunk) every CTA walks its whole table, in order, with no merge. A
    function of the shapes alone, so a result never depends on the data."""
    tiles = b * -(-(h * t) // MLA_Q_TILE)
    mb1 = max(mb, 1)
    if tiles >= build.SM_COUNT:
        return mb1, 1
    want = max(1, min(mb1, MLA_TARGET_CTAS // max(tiles, 1)))
    bps = -(-mb1 // want)
    return bps, -(-mb1 // bps)


_mla_plan = functools.lru_cache(maxsize=1024)(mla_split_plan)


def paged_mla_split_plain(q_eff, q_rope, c_pool, kr_pool, table, length, *,
                          scale: float, blocks_per_split: int):
    """``paged_mla``'s split walk in plain torch: each chunk of
    ``blocks_per_split`` table columns walked into its own latent flash
    state (the row's length shifted to the chunk), then merged in chunk
    order."""
    bs = c_pool.shape[1]
    length = length.to(torch.int32).reshape(-1).expand(q_eff.shape[0])
    parts = [paged_mla_plain(q_eff, q_rope, c_pool, kr_pool,
                             table[:, j0:j0 + blocks_per_split],
                             (length - j0 * bs).clamp_min(0), scale=scale)
             for j0 in range(0, max(table.shape[1], 1), blocks_per_split)]
    return merge_flash_plain(parts)


def merge_gqa_suffix(acc, m, l, q, suf_k, suf_v, suf_valid, *,
                     scale: float) -> torch.Tensor:
    """Fold a (B, S, Hkv, D) suffix into paged flash state and normalise.

    ``suf_valid`` is (B, T, S) bool (per query token, so the causal
    triangle over the new tokens rides in). Returns (B, T, Hkv, G, Dv)
    f32. Value rows valid for no query are zeroed."""
    qf = q.to(torch.float32)
    vz = torch.where(suf_valid.any(1)[:, :, None, None], suf_v, 0)
    s = torch.einsum("bthgd,bshd->bhgts", qf, suf_k.to(torch.float32)) * scale
    vm = suf_valid[:, None, None]                          # (B,1,1,T,S)
    s = torch.where(vm, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgts,bshd->bhgtd", p, vz.to(torch.float32))
    out = acc_new / l_new[..., None].clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4)


def merge_mla_suffix(acc, m, l, q_eff, q_rope, suf_c, suf_kr, suf_valid, *,
                     scale: float) -> torch.Tensor:
    """Fold a (B, S, L)+(B, S, R) latent suffix into paged flash state and
    normalise. ``suf_valid`` is (B, T, S) bool. Returns the latent context
    (B, T, H, L) f32 (the caller applies w_uv). Suffix rows valid for no
    query are zeroed."""
    anyv = suf_valid.any(1)[:, :, None]
    czf = torch.where(anyv, suf_c, 0).to(torch.float32)
    krf = torch.where(anyv, suf_kr, 0).to(torch.float32)
    s = (torch.einsum("bthl,bsl->bhts", q_eff.to(torch.float32), czf)
         + torch.einsum("bthr,bsr->bhts", q_rope.to(torch.float32), krf)
         ) * scale
    vm = suf_valid[:, None]                                # (B,1,T,S)
    s = torch.where(vm, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhts,bsl->bhtl", p, czf)
    out = acc_new / l_new[..., None].clamp_min(1e-30)      # (B,H,T,L)
    return out.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_LEAVES = ("bitmap", "signmant", "exp_words", "exp_mode", "exp_emax")


def _check_walk(q, table, length, nb: int, bs: int):
    b, t, hkv, g, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels take {HEAD_DIMS}")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bs} outside [1, {MAX_BLOCK_SIZE}]")
    build.check(q, "q", torch.bfloat16, (b, t, hkv, g, d))
    build.check(table, "table", torch.int32, (b, table.shape[1]))
    build.check(length, "length", torch.int32, (b,))
    out = (torch.empty((b, hkv, g, t, d), dtype=torch.float32,
                       device=q.device),
           torch.empty((b, hkv, g, t), dtype=torch.float32, device=q.device),
           torch.empty((b, hkv, g, t), dtype=torch.float32, device=q.device))
    return (b, t, hkv, g, d, nb, bs, table.shape[1]), out


def _spec_words(spec: dict, nb: int, bs: int, hkv: int, *, d: int,
                keep: int, trunc: int, exp_bits: int) -> tuple:
    """Check one store's speculation leaves; returns (pointers, words)."""
    wsm = (keep * (8 - trunc) + 31) // 32
    we = (keep * exp_bits + 31) // 32
    shapes = {"bitmap": (nb, bs, hkv, 1, d // 32),
              "signmant": (nb, bs, hkv, 1, wsm),
              "exp_words": (nb, bs, hkv, 1, we),
              "exp_mode": (nb, bs, hkv, 1), "exp_emax": (nb, bs, hkv, 1)}
    for k in _LEAVES:
        dtype = torch.uint8 if k in ("exp_mode", "exp_emax") else torch.int32
        build.check(spec[k], k, dtype, shapes[k])
    return [spec[k].data_ptr() for k in _LEAVES], wsm, we


def _check_packed_args(d, keep, trunc, exp_bits, book):
    if not 0 <= trunc <= 7 or not 1 <= exp_bits <= 8 or not 0 < keep <= d:
        raise ValueError(f"keep={keep}, trunc={trunc}, exp_bits={exp_bits} "
                         f"outside what the kernel decodes")
    if book.device.type != "cuda" or book.dtype != torch.uint8 \
            or book.numel() < 32 or not book.is_contiguous():
        raise ValueError("book must be a contiguous uint8 tensor of >= 32 "
                         "entries on the card")


def paged_gqa(q, k_pool, v_pool, table, length, *, scale: float):
    """Paged GQA attention over plain bf16 pools ``(NB, BS, Hkv, D)``.

    q (B,T,Hkv,G,D) · table (B,MB) int32 · length (B,) int32. Returns
    unnormalised (acc, m, l). CPU tensors take :func:`paged_gqa_plain`;
    CUDA tensors launch the kernel (``paged_gqa.launches``, one per call
    with its split merge: the table split of :func:`plain_split_plan`) or
    raise."""
    if q.device.type == "cpu":
        return paged_gqa_plain(q, k_pool, v_pool, table, length, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa: unsupported device {q.device}")
    nb, bs = k_pool.shape[:2]
    dims, (acc, m, l) = _check_walk(q, table, length, nb, bs)
    build.check(k_pool, "k_pool", torch.bfloat16, (nb, bs, dims[2], dims[4]))
    build.check(v_pool, "v_pool", torch.bfloat16, (nb, bs, dims[2], dims[4]))
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary (the "
                         "kernel copies their rows 16 bytes at a time)")
    b, t, hkv, g = dims[:4]
    bps, splits = _plain_plan(b, hkv, g, t, dims[7])
    ws = None
    if splits > 1:              # partial (acc, m, l) of every split
        ws = torch.empty(splits * m.numel() * (dims[4] + 2),
                         dtype=torch.float32, device=q.device)
    fn = build.entry("paged_gqa", "paged_gqa_launch", 9, 9, 1)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), length.data_ptr(), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), 0 if ws is None else ws.data_ptr(),
             *dims, bps, float(scale), build.stream(q))
    build.raise_on(err, "paged_gqa")
    paged_gqa.launches += 1
    return acc, m, l


def paged_gqa_packed(q, k_spec: dict, v_spec: dict, table, length, book, *,
                     d: int, keep: int, trunc: int, exp_bits: int,
                     scale: float):
    """Paged GQA attention over packed speculation pools, decoded on chip.

    ``k_spec``/``v_spec`` are a packed store's spec leaf dicts; ``book``
    the cache's exp_of_rank (uint8, ≥ 32 entries). Returns unnormalised
    (acc, m, l). CPU tensors take :func:`paged_gqa_packed_plain`; CUDA
    tensors launch the kernel (``paged_gqa_packed.launches``, one per call
    with its split merge) or raise."""
    kw = dict(d=d, keep=keep, trunc=trunc, exp_bits=exp_bits)
    if q.device.type == "cpu":
        return paged_gqa_packed_plain(q, k_spec, v_spec, table, length, book,
                                      scale=scale, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_packed: unsupported device {q.device}")
    _check_packed_args(d, keep, trunc, exp_bits, book)
    nb, bs = k_spec["bitmap"].shape[:2]
    dims, (acc, m, l) = _check_walk(q, table, length, nb, bs)
    if dims[4] != d:
        raise ValueError(f"q has head dim {dims[4]}, the pool {d}")
    kp, wsm, we = _spec_words(k_spec, nb, bs, dims[2], **kw)
    vp, _, _ = _spec_words(v_spec, nb, bs, dims[2], **kw)
    b, t, hkv, g = dims[:4]
    bps, splits = _split_plan(b, hkv, g, t, dims[7])
    ws = None
    if splits > 1:              # partial (acc, m, l) of every split
        ws = torch.empty(splits * m.numel() * (d + 2), dtype=torch.float32,
                         device=q.device)
    fn = build.entry("paged_gqa", "paged_gqa_packed_launch", 18, 14, 1)
    err = fn(q.data_ptr(), *kp, *vp, book.data_ptr(), table.data_ptr(),
             length.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             0 if ws is None else ws.data_ptr(), *dims, keep, trunc,
             exp_bits, wsm, we, bps, float(scale), build.stream(q))
    build.raise_on(err, "paged_gqa_packed")
    paged_gqa_packed.launches += 1
    return acc, m, l


def decode_spec_pool(spec: dict, book, *, d: int, keep: int, trunc: int,
                     exp_bits: int) -> torch.Tensor:
    """Decode a whole packed pool -> bf16 (NB, BS, Hkv, d). CUDA tensors
    run the packed kernel's own decode device function alone (counted in
    ``decode_spec_pool.launches``, not in the attention kernels'); CPU
    tensors take :func:`decode_spec_pool_plain`."""
    kw = dict(d=d, keep=keep, trunc=trunc, exp_bits=exp_bits)
    leaf = spec["bitmap"]
    if leaf.device.type == "cpu":
        return decode_spec_pool_plain(spec, book, **kw)
    if leaf.device.type != "cuda":
        raise ValueError(f"decode_spec_pool: unsupported device {leaf.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels take {HEAD_DIMS}")
    _check_packed_args(d, keep, trunc, exp_bits, book)
    nb, bs, hkv = leaf.shape[:3]
    ptrs, wsm, we = _spec_words(spec, nb, bs, hkv, **kw)
    out = torch.empty((nb, bs, hkv, d), dtype=torch.bfloat16,
                      device=leaf.device)
    fn = build.entry("paged_gqa", "decode_spec_rows_launch", 7, 7)
    err = fn(*ptrs, book.data_ptr(), out.data_ptr(), nb * bs * hkv, d, keep,
             trunc, exp_bits, wsm, we,
             torch.cuda.current_stream(leaf.device).cuda_stream)
    build.raise_on(err, "decode_spec_pool")
    decode_spec_pool.launches += 1
    return out


def paged_mla(q_eff, q_rope, c_pool, kr_pool, table, length, *,
              scale: float):
    """Paged MLA attention in latent space over bf16 pools.

    q_eff (B,T,H,L) f32 (q_nope absorbed through w_uk) · q_rope (B,T,H,R)
    f32 · c_pool (NB,BS,L) · kr_pool (NB,BS,R) · table (B,MB) int32 ·
    length (B,) int32. Returns unnormalised (acc (B,H,T,L), m (B,H,T),
    l (B,H,T)) f32. CPU tensors take :func:`paged_mla_plain`; CUDA tensors
    launch the kernel (``paged_mla.launches``, one per call with its split
    merge: the table split of :func:`mla_split_plan`) or raise."""
    if q_eff.device.type == "cpu":
        return paged_mla_plain(q_eff, q_rope, c_pool, kr_pool, table, length,
                               scale=scale)
    if q_eff.device.type != "cuda":
        raise ValueError(f"paged_mla: unsupported device {q_eff.device}")
    b, t, h, latent = q_eff.shape
    r_dim = q_rope.shape[-1]
    nb, bs = c_pool.shape[:2]
    if latent not in MLA_LATENT_DIMS or not 8 <= r_dim <= MLA_MAX_ROPE \
            or r_dim % 8:
        raise ValueError(f"paged_mla: latent {latent}, rope {r_dim}; the "
                         f"kernel takes latent in {MLA_LATENT_DIMS} and "
                         f"rope a multiple of 8 in [8, {MLA_MAX_ROPE}]")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bs} outside [1, {MAX_BLOCK_SIZE}]")
    build.check(q_eff, "q_eff", torch.float32, (b, t, h, latent))
    build.check(q_rope, "q_rope", torch.float32, (b, t, h, r_dim))
    build.check(c_pool, "c_pool", torch.bfloat16, (nb, bs, latent))
    build.check(kr_pool, "kr_pool", torch.bfloat16, (nb, bs, r_dim))
    build.check(table, "table", torch.int32, (b, table.shape[1]))
    build.check(length, "length", torch.int32, (b,))
    if any(x.data_ptr() % 16 for x in (q_eff, q_rope, c_pool, kr_pool)):
        raise ValueError("q_eff, q_rope and the pools must start on a "
                         "16-byte boundary (the kernel copies 16 bytes at "
                         "a time)")
    dev = q_eff.device
    acc = torch.empty((b, h, t, latent), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    mb = table.shape[1]
    bps, splits = _mla_plan(b, h, t, mb)
    ws = None
    if splits > 1:              # partial (acc, m, l) of every split
        ws = torch.empty(splits * m.numel() * (latent + 2),
                         dtype=torch.float32, device=dev)
    fn = build.entry("paged_mla", "paged_mla_launch", 10, 9, 1)
    err = fn(q_eff.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
             kr_pool.data_ptr(), table.data_ptr(), length.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             0 if ws is None else ws.data_ptr(), b, t, h, latent, r_dim, nb,
             bs, mb, bps, float(scale), build.stream(q_eff))
    build.raise_on(err, "paged_mla")
    paged_mla.launches += 1
    return acc, m, l


paged_gqa.launches = 0
paged_gqa_packed.launches = 0
decode_spec_pool.launches = 0
paged_mla.launches = 0
