"""Paged GQA decode attention over a block pool: plain versions and the
wrappers around the hand-written CUDA kernels.

The kernels (``csrc/paged_gqa.cu``) replace the TPU kernels ``paged_gqa``
and ``paged_gqa_packed`` (``src/repro/kernels/paged_attention.py``). Both
walk each row's ``(B, MB)`` block table and fold every pool block into an
online-softmax (flash) state under the row's ``length`` mask, so the
per-request prefix is never gathered:

* ``paged_gqa`` — plain bf16 pool blocks ``(NB, BS, Hkv, D)``: the verify
  pass, prefill chunks and autoregressive steps;
* ``paged_gqa_packed`` — the pool blocks are the Cassandra-1 speculation
  leaves (bitmap / sign|mantissa codes / exponent words / mode / emax,
  ``(NB, BS, Hkv, 1, W)``); each block is decoded on chip before its
  flash step, so the draft pass's KV never exists densely in device
  memory (the paper's DRAM→L2 decoder module).

Both return the unnormalised flash state ``(acc (B,Hkv,G,T,D) f32,
m (B,Hkv,G,T) f32, l (B,Hkv,G,T) f32)``; ``merge_gqa_suffix`` folds in the
scratch/new-token suffix (which lives outside the pool) and normalises.

Each wrapper follows its tensors' device: CPU tensors take the plain
version (the reference's ``impl="jnp"`` math), CUDA tensors launch the
kernel (counted in ``<wrapper>.launches``) or raise. ``decode_spec_pool``
exposes the packed kernel's decode alone, for checking it bit for bit.
Packed words are int32 bit-views; every right shift is masked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops

NEG_INF = -1e30
# unused table slots point at block 0, the trash block (the allocator's
# TRASH_BLOCK; kept local so kernels/ does not import serving/)
TRASH_BLOCK = 0
MAX_BLOCK_SIZE = 32             # the kernels stage one block of ≤ 32 tokens
HEAD_DIMS = (32, 64, 128)       # one lane holds D/32 of a query's dims


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


def _unary_ranks(bits: torch.Tensor, keep: int) -> torch.Tensor:
    """Unary rank decode of the (R, n) 0/1 stream -> (R, keep) ranks in
    [0, 31]. ``pos[j]`` counts the positions whose running count of ones
    is below j+1 (the strict compare: the 0-indexed position of the
    (j+1)-th set bit, n when there are fewer); the running count is
    non-decreasing, so the count is a left-sided search."""
    idx = torch.cumsum(bits, dim=-1, dtype=torch.int32)
    ks = torch.arange(1, keep + 1, dtype=torch.int32, device=bits.device)
    pos = torch.searchsorted(idx, ks.expand(bits.shape[0], keep).contiguous(),
                             side="left").to(torch.int32)
    prev = torch.cat([torch.full_like(pos[:, :1], -1), pos[:, :-1]], dim=-1)
    return (pos - prev - 1).clamp(0, 31)


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
    uexp = book32[_unary_ranks(ebits, keep).to(torch.int64)]
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


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_LEAVES = ("bitmap", "signmant", "exp_words", "exp_mode", "exp_emax")


def _check(t: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, q is on the card")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_walk(q, table, length, nb: int, bs: int):
    b, t, hkv, g, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels take {HEAD_DIMS}")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bs} outside [1, {MAX_BLOCK_SIZE}]")
    _check(q, "q", torch.bfloat16, (b, t, hkv, g, d))
    _check(table, "table", torch.int32, (b, table.shape[1]))
    _check(length, "length", torch.int32, (b,))
    out = (torch.empty((b, hkv, g, t, d), dtype=torch.float32,
                       device=q.device),
           torch.empty((b, hkv, g, t), dtype=torch.float32, device=q.device),
           torch.empty((b, hkv, g, t), dtype=torch.float32, device=q.device))
    return (b, t, hkv, g, d, nb, bs, table.shape[1]), out


def _fn(name: str, n_ptr: int, n_int: int, floats: int = 0):
    from repro_torch.kernels import build    # nvcc only when launching
    fn = getattr(build.load("paged_gqa"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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
        _check(spec[k], k, dtype, shapes[k])
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
    CUDA tensors launch the kernel (``paged_gqa.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_gqa_plain(q, k_pool, v_pool, table, length, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa: unsupported device {q.device}")
    nb, bs = k_pool.shape[:2]
    dims, (acc, m, l) = _check_walk(q, table, length, nb, bs)
    _check(k_pool, "k_pool", torch.bfloat16, (nb, bs, dims[2], dims[4]))
    _check(v_pool, "v_pool", torch.bfloat16, (nb, bs, dims[2], dims[4]))
    fn = _fn("paged_gqa_launch", 8, 8, floats=1)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), length.data_ptr(), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), *dims, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_gqa")
    paged_gqa.launches += 1
    return acc, m, l


def paged_gqa_packed(q, k_spec: dict, v_spec: dict, table, length, book, *,
                     d: int, keep: int, trunc: int, exp_bits: int,
                     scale: float):
    """Paged GQA attention over packed speculation pools, decoded on chip.

    ``k_spec``/``v_spec`` are a packed store's spec leaf dicts; ``book``
    the cache's exp_of_rank (uint8, ≥ 32 entries). Returns unnormalised
    (acc, m, l). CPU tensors take :func:`paged_gqa_packed_plain`; CUDA
    tensors launch the kernel (``paged_gqa_packed.launches``) or raise."""
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
    fn = _fn("paged_gqa_packed_launch", 17, 13, floats=1)
    err = fn(q.data_ptr(), *kp, *vp, book.data_ptr(), table.data_ptr(),
             length.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             *dims, keep, trunc, exp_bits, wsm, we, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_gqa_packed")
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
    fn = _fn("decode_spec_rows_launch", 7, 7)
    err = fn(*ptrs, book.data_ptr(), out.data_ptr(), nb * bs * hkv, d, keep,
             trunc, exp_bits, wsm, we,
             torch.cuda.current_stream(leaf.device).cuda_stream)
    _raise_on(err, "decode_spec_pool")
    decode_spec_pool.launches += 1
    return out


paged_gqa.launches = 0
paged_gqa_packed.launches = 0
decode_spec_pool.launches = 0
