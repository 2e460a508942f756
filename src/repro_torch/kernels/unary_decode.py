"""Cassandra-1 unary exponent decode (the paper's Alg. 1 parallel zero
counter) and the one-launch target-weight decode built on it: the plain
versions and the wrappers around the hand-written CUDA kernels.

The kernels (``csrc/unary_decode.cu``) replace the TPU kernel
``unary_decode`` (``src/repro/kernels/unary_decode.py``) and, for a whole
packed weight, the reference's ``format.target_tensor`` chain around it.
A packed unary region (W uint32 words, little-endian bits) holds codes of
``rank`` zeros ended by a one; code j's rank is ``pos_j - pos_{j-1} - 1``,
where ``pos_j`` is the position of the (j+1)-th set bit (``W * 32`` when
the region holds fewer) and ``pos_{-1} = -1``, clipped to [0, 31]. On a
region the encoder wrote in unary mode (exactly K set bits) this is the
reference's ``coding.unary_decode_block`` bit for bit; delta-mode regions
give ranks the caller discards (``core/coding.py::decode_exponents``).

* ``ranks_from_bits`` / ``unary_decode_plain`` — the same math in
  PyTorch: the CPU path and the kernel's oracle (also the unary step of
  the packed paged-attention kernel's plain decode).
* ``unary_decode`` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel (counted in ``unary_decode.launches``)
  or raises. The C-1 draft-view weight decode (MLA's kv_b on the card)
  and the plain chains of the C-1 views call it through
  ``decode_exponents``.
* ``target_decode`` — a packed Cassandra-1 weight's exact (target) view,
  ``(n_out, n_in)`` bf16, in one launch (``target_decode.launches``): the
  unary ranks through the codebook, the mode-1 deltas with their
  corrections, sign and mantissas, the pruned values (coded or raw) and
  the bitmap scatter. It takes CUDA tensors only: its plain version is
  the chain ``format.target_weight_plain``, which ``format.target_weight``
  runs for CPU tensors. ``target_plan`` is the launch's cut of the
  weight's superblocks.
* ``kv_view`` — a Cassandra-1 KV store's draft or target view, ``(...,
  d)`` bf16, in one launch (``kv_view.launches``): what
  ``serving/kvcache.py::read_store`` runs for such a store on the card,
  with the cache-global book, 8-bit corrections and raw pruned values. It
  takes CUDA tensors only: its plain version is the chain
  ``kvcache.read_store_plain``. ``kv_view_plan`` is the launch's cut of
  the vectors.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.kernels import build

MAX_RANK = 32
MAX_K = 512                     # ranks per region: a superblock at most
MAX_WORDS = 1023                # word counts are int16


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
    if not 1 <= k <= MAX_K or not 1 <= w <= MAX_WORDS:
        raise ValueError(f"unary_decode: k={k}, W={w} (the kernel takes "
                         f"1 <= k <= {MAX_K}, 1 <= W <= {MAX_WORDS})")
    build.check(words, "words", torch.int32, (*lead, w))
    out = torch.empty((*lead, k), dtype=torch.int32, device=words.device)
    rows = words.numel() // w
    if rows == 0:
        return out
    fn = build.entry("unary_decode", "unary_decode_launch", 2, 3)
    err = fn(words.data_ptr(), out.data_ptr(), rows, w, k,
             build.stream(words))
    build.raise_on(err, "unary_decode")
    unary_decode.launches += 1
    return out


unary_decode.launches = 0


# ---------------------------------------------------------------------------
# target_decode: a packed C-1 weight's exact view in one launch
# ---------------------------------------------------------------------------

TD_WARPS = 8                    # warps per CTA, one superblock each at a time
TARGET_CTAS = 4 * build.SM_COUNT    # one wave: 4 CTAs an SM holds


def target_plan(superblocks: int) -> tuple[int, int]:
    """(superblocks per CTA, CTAs) for a weight of ``superblocks`` (n_out x
    superblocks per column): runs of at least one superblock per warp,
    ``TARGET_CTAS`` of them where the weight allows."""
    chunk = max(TD_WARPS, -(-superblocks // TARGET_CTAS))
    return chunk, -(-superblocks // chunk)


def _leaf(tree: dict, name: str, dtype, shape: tuple):
    """A checked leaf, copied when its address is not 4-byte aligned (the
    kernel copies every region in 4-byte pieces at least)."""
    t = tree[name]
    build.check(t, name, dtype, shape)
    return t if t.data_ptr() % 4 == 0 else t.clone()


def _book(tree: dict, name: str):
    t = tree.get(name)
    if t is None or t.dtype != torch.uint8 or t.numel() < MAX_RANK \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name} must be a contiguous uint8 tensor of >= "
                         f"{MAX_RANK} entries on the card")
    return t


def target_decode(spec: dict, verif: dict, cass,
                  shape: tuple[int, int]) -> torch.Tensor:
    """The exact (target) view of a packed Cassandra-1 weight of ``shape``
    ``(n_in, n_out)``, as ``(n_out, n_in)`` bf16.

    CUDA tensors launch the kernel (counted in ``target_decode.launches``)
    or raise; other devices raise (``format.target_weight`` runs the plain
    chain for CPU tensors)."""
    if cass.variant != 1:
        raise ValueError("target_decode decodes Cassandra-1 weights; a "
                         "Cassandra-2 weight decodes through mx_decode")
    dev = spec["bitmap"].device
    if dev.type != "cuda":
        raise ValueError(f"target_decode: unsupported device {dev} (the "
                         f"plain chain is format.target_weight_plain)")
    n_in, n_out = shape
    block = cass.weight_block(n_in)
    keep = cass.weight_keep(block)
    trunc, eb, p = cass.weight_trunc, cass.exp_bits, block - keep
    nb = n_in // block
    if not 0 <= trunc <= 7 or not 1 <= eb <= 8 or keep % 8 or p % 8:
        raise ValueError(f"target_decode: keep={keep}, block={block}, "
                         f"trunc={trunc}, exp_bits={eb} outside what the "
                         f"kernel decodes")
    i32, u8 = torch.int32, torch.uint8

    def words(k: int, width: int) -> tuple:
        return n_out, nb, (k * width + 31) // 32

    ptrs = [_leaf(spec, "bitmap", i32, (n_out, nb, block // 32)),
            _leaf(spec, "signmant", i32, words(keep, 8 - trunc)),
            _leaf(spec, "exp_words", i32, words(keep, eb)),
            _leaf(spec, "exp_mode", u8, (n_out, nb)),
            _leaf(spec, "exp_emax", u8, (n_out, nb)),
            _book(spec, "codebook"),
            _leaf(verif, "mant_lo", i32, words(keep, trunc)),
            (_leaf(verif, "exp_corr", u8, (n_out, nb, keep // 2))
             if "exp_corr" in verif else None)]
    pruned = 0 if p == 0 else 2 if "pruned_raw" in verif else 1
    if pruned == 2:
        ptrs += [_leaf(verif, "pruned_raw", torch.int16, (n_out, nb, p)),
                 None, None, None, None, None]
    elif pruned == 1:
        ptrs += [_leaf(verif, "pruned_signmant", u8, (n_out, nb, p)),
                 _leaf(verif, "pruned_exp_words", i32, words(p, eb)),
                 _leaf(verif, "pruned_exp_mode", u8, (n_out, nb)),
                 _leaf(verif, "pruned_exp_emax", u8, (n_out, nb)),
                 _book(verif, "pruned_codebook"),
                 (_leaf(verif, "pruned_exp_corr", u8, (n_out, nb, p // 2))
                  if "pruned_exp_corr" in verif else None)]
    else:
        ptrs += [None] * 6
    out = torch.empty((n_out, n_in), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    chunk, _ = target_plan(n_out * nb)
    fn = build.entry("unary_decode", "target_decode_launch", 15, 8)
    err = fn(*[0 if t is None else t.data_ptr() for t in ptrs],
             out.data_ptr(), n_out, nb, block, keep, trunc, eb, pruned,
             chunk, build.stream(out))
    build.raise_on(err, "target_decode")
    target_decode.launches += 1
    return out


target_decode.launches = 0


# ---------------------------------------------------------------------------
# kv_view: a C-1 KV store's draft or target view in one launch
# ---------------------------------------------------------------------------

KV_HEAD_DIMS = (32, 64, 128, 256, 512)


KV_VIEW_CTAS = 4 * build.SM_COUNT      # one wave: 4 CTAs an SM holds


def kv_view_plan(rows: int, d: int) -> tuple[int, int]:
    """(vectors per run, CTAs) for a store of ``rows`` vectors of ``d``
    values. A run is a multiple of 16 vectors (so every leaf's run starts
    on a 16-byte boundary), at most 8192 values (two vectors for each of
    a CTA's lane groups of d/16 lanes), and small enough that the runs
    fill ``KV_VIEW_CTAS`` CTAs where the store allows. The CTAs are
    persistent: CTA c decodes runs c, c + CTAs, ...; run q holds vectors
    [q * chunk, (q + 1) * chunk)."""
    fill = -(-rows // KV_VIEW_CTAS)
    chunk = min(max(16, 8192 // d), max(16, -(-fill // 16) * 16))
    runs = -(-rows // chunk)
    return chunk, min(runs, KV_VIEW_CTAS)


def _kv_leaf(tree: dict, name: str, dtype, shape: tuple):
    """A checked leaf on the card, copied when it is not contiguous (a
    leaf at any byte address is read as it lies: the kernel copies in
    pieces its alignment allows, never past the leaf)."""
    t = tree[name]
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, not on the card")
    t = t.contiguous()
    build.check(t, name, dtype, shape)
    return t


def kv_view(spec: dict, verif: dict | None, exp_of_rank: torch.Tensor, *,
            d: int, keep: int, trunc: int, exp_bits: int) -> torch.Tensor:
    """The draft (``verif`` None) or target view of a Cassandra-1 KV store
    whose leaves are (..., 1, ·) as ``kvcache.encode_store`` writes them,
    as (..., d) bf16; ``exp_of_rank`` is the cache-global book (at least
    32 uint8 entries).

    CUDA tensors launch the kernel (counted in ``kv_view.launches``) or
    raise; other devices raise (``kvcache.read_store`` runs the plain
    chain for CPU tensors)."""
    bm = spec["bitmap"]
    if bm.device.type != "cuda":
        raise ValueError(f"kv_view: unsupported device {bm.device} (the "
                         f"plain chain is kvcache.read_store_plain)")
    if (d not in KV_HEAD_DIMS or not 0 < keep <= d or keep % 16
            or not 0 <= trunc <= 7 or not 1 <= exp_bits <= 8):
        raise ValueError(f"kv_view: d={d}, keep={keep}, trunc={trunc}, "
                         f"exp_bits={exp_bits}; the kernel takes d in "
                         f"{KV_HEAD_DIMS}, keep <= d a multiple of 16, "
                         f"trunc in [0, 7] and exp_bits in [1, 8]")
    lead = tuple(bm.shape[:-2])
    i32, u8 = torch.int32, torch.uint8

    def words(width: int) -> tuple:
        return (*lead, 1, (keep * width + 31) // 32)

    ptrs = [_kv_leaf(spec, "bitmap", i32, (*lead, 1, d // 32)),
            _kv_leaf(spec, "signmant", i32, words(8 - trunc)),
            _kv_leaf(spec, "exp_words", i32, words(exp_bits)),
            _kv_leaf(spec, "exp_mode", u8, (*lead, 1)),
            _kv_leaf(spec, "exp_emax", u8, (*lead, 1)),
            _book({"exp_of_rank": exp_of_rank}, "exp_of_rank"),
            None, None, None]
    if verif is not None:
        if trunc:
            ptrs[6] = _kv_leaf(verif, "mant_lo", i32, words(trunc))
        if "exp_corr" in verif:
            ptrs[7] = _kv_leaf(verif, "exp_corr", u8, (*lead, 1, keep))
        if keep < d:
            ptrs[8] = _kv_leaf(verif, "pruned_raw", torch.int16,
                               (*lead, 1, d - keep))
    out = torch.empty((*lead, d), dtype=torch.bfloat16, device=bm.device)
    rows = bm.numel() // (d // 32)
    if rows == 0:
        return out
    if rows >= 2 ** 31:
        raise ValueError(f"kv_view: {rows} vectors in one launch")
    chunk, ctas = kv_view_plan(rows, d)
    fn = build.entry("unary_decode", "kv_view_launch", 10, 8)
    err = fn(*[0 if t is None else t.data_ptr() for t in ptrs],
             out.data_ptr(), rows, d, keep, trunc, exp_bits,
             int(verif is not None), chunk, ctas, build.stream(out))
    build.raise_on(err, "kv_view")
    kv_view.launches += 1
    return out


kv_view.launches = 0
