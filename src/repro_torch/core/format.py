"""The Cassandra format, variant 1 (port of ``core/format.py``).

A bf16 tensor becomes two packed dicts:

* **speculation data** — what the draft pass reads: bitmap (pruning mask),
  packed ``sign|mant_hi`` codes and the coded exponent region;
* **verification data** — the pruned values (with their own coded
  exponents, or raw for the online KV encoder), the dropped mantissa low
  bits and the exponent corrections.

``draft_*`` rebuilds the zero-padded draft view from speculation data
alone; ``target_*`` rebuilds the tensor bit-exactly from both. Weights are
blocked along their input (reduction) dimension per output column; KV
vectors per (token, head). Keys, shapes and word layouts are the
reference's; uint32 words are int32 bit-views and ``pruned_raw`` is an
int16 bit-view of its uint16 payload.

Cassandra-2 (``variant=2``) keeps the kept values as MX lanes
(``core/mx.py``): the speculation side holds the sign and the top
``mx_draft_bits`` of each 16-bit container plus the shared exponents, the
verification side the container's low bits and the raw pruned values; the
target view is exact within an MX group's 2^8 exponent range. On the card
each C-2 view of a weight (``draft_weight``, ``target_weight``) or of a KV
store (``serving/kvcache.py``) is one launch of ``kernels/mx_decode.py``'s
``mx_view``; ``draft_tensor`` / ``target_tensor`` over the leaves (through
``mx_decode``, the plain MX decode on the CPU) are the chain it is held
to, and what CPU tensors run.

Selections that span the whole vector with magnitude scores (the KV
encode) run through ``kernels/kv_topk.py``, and the unary exponent decode
through ``kernels/unary_decode.py`` (``core/coding.py``). On the card a
Cassandra-1 KV store's encode and each of its views are one launch of
``kv_topk.kv_encode`` / ``unary_decode.kv_view``
(``serving/kvcache.py``); ``format_tensor`` / ``draft_tensor`` /
``target_tensor`` are the chains they are held to. A Cassandra-1
weight's target view on the card is one launch of that module's
``target_decode``, which rebuilds the whole weight from its packed leaves;
``target_weight_plain`` is the chain of plain steps it is held to, and
what CPU tensors run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bitops, coding, mx, pruning
from repro_torch.kernels import kv_topk as KT
from repro_torch.kernels import mx_decode as MXD
from repro_torch.kernels import unary_decode as UD


@dataclasses.dataclass(frozen=True)
class CassandraConfig:
    """Hyper-parameters of the format (paper defaults: 40% prune, 4-bit trunc)."""
    variant: int = 1              # 1 = unary/lossless, 2 = MX
    weight_prune: float = 0.4
    kv_prune: float = 0.4
    weight_trunc: int = 4
    kv_trunc: int = 4
    exp_bits: int = 3
    mx_group: int = 32
    mx_draft_bits: int = 4
    gamma: int = 5
    max_block: int = 512

    def weight_keep(self, block: int) -> int:
        return pruning.keep_count(block, self.weight_prune,
                                  pruning.WEIGHT_KEEP_MULTIPLE)

    def kv_keep(self, block: int) -> int:
        return pruning.keep_count(block, self.kv_prune,
                                  pruning.KV_KEEP_MULTIPLE)

    def weight_block(self, n_in: int) -> int:
        for b in (self.max_block, 256, 128, 64, 32):
            if n_in % b == 0:
                return b
        raise ValueError(f"input dim {n_in} not divisible by any block size")


PAPER_DEFAULT = CassandraConfig()


# ---------------------------------------------------------------------------
# Shared partition machinery
# ---------------------------------------------------------------------------

def _split_kept(kept: torch.Tensor, trunc: int, variant: int, group: int,
                draft_bits: int):
    """Split kept bf16 values (..., K) into draft/verification payloads."""
    if variant == 1:
        t_keep = bitops.MANT_BITS - trunc
        sign, exp, mant = bitops.split_fields(kept)
        mant_hi = mant >> trunc
        mant_lo = mant & ((1 << trunc) - 1)
        code = (sign << t_keep) | mant_hi
        spec = {"signmant": bitops.pack_codes(code, 1 + t_keep), "exp": exp}
        verif = {"mant_lo": bitops.pack_codes(mant_lo, trunc)}
        return spec, verif
    # Cassandra-2: MX
    enc = mx.mx_encode(kept, group=group)
    m16 = enc["m16"].to(torch.int32) & 0xFFFF
    lo_bits = mx.CONTAINER_BITS - draft_bits
    code = (enc["sign"].to(torch.int32) << draft_bits) | (m16 >> lo_bits)
    spec = {"signmant": bitops.pack_codes(code, 1 + draft_bits),
            "shared_exp": enc["shared_exp"]}
    verif = {"mant_lo": bitops.pack_codes(m16 & ((1 << lo_bits) - 1),
                                          lo_bits)}
    return spec, verif


def _mx_lanes(spec: dict, k: int, draft_bits: int, group: int,
              m_lo=None) -> torch.Tensor:
    """Decode C-2 kept values: the draft view from the speculation codes
    alone, the target view with the container's low bits ``m_lo``."""
    code = bitops.unpack_codes(spec["signmant"], 1 + draft_bits, k)
    lo_bits = mx.CONTAINER_BITS - draft_bits
    m16 = (code & ((1 << draft_bits) - 1)) << lo_bits
    if m_lo is not None:
        m16 = m16 | m_lo
    sign = ((code >> draft_bits) & 1).to(torch.uint8)
    return MXD.mx_decode(sign, bitops.as_int16(m16), spec["shared_exp"],
                         group)


def _join_kept_draft(spec: dict, k: int, trunc: int, variant: int, group: int,
                     draft_bits: int, exp_of_rank, exp_bits: int,
                     corr_bits: int = coding.CORR_BITS) -> torch.Tensor:
    """Reconstruct the draft view of kept values (low mantissa zeroed)."""
    if variant != 1:
        return _mx_lanes(spec, k, draft_bits, group)
    t_keep = bitops.MANT_BITS - trunc
    code = bitops.unpack_codes(spec["signmant"], 1 + t_keep, k)
    sign = (code >> t_keep) & 1
    mant = (code & ((1 << t_keep) - 1)) << trunc
    exp = coding.decode_exponents(
        {"words": spec["exp_words"], "mode": spec["exp_mode"],
         "emax": spec["exp_emax"], "corr": spec.get("exp_corr")},
        exp_of_rank, k, exp_bits, exact=False, corr_bits=corr_bits)
    return bitops.join_fields(sign, exp, mant)


def _join_kept_target(spec: dict, verif: dict, k: int, trunc: int,
                      variant: int, group: int, draft_bits: int, exp_of_rank,
                      exp_bits: int,
                      corr_bits: int = coding.CORR_BITS) -> torch.Tensor:
    """Reconstruct kept values exactly (C-1) / MX-container-exactly (C-2)."""
    if variant != 1:
        m_lo = bitops.unpack_codes(verif["mant_lo"],
                                   mx.CONTAINER_BITS - draft_bits, k)
        return _mx_lanes(spec, k, draft_bits, group, m_lo)
    t_keep = bitops.MANT_BITS - trunc
    code = bitops.unpack_codes(spec["signmant"], 1 + t_keep, k)
    sign = (code >> t_keep) & 1
    mant_hi = (code & ((1 << t_keep) - 1)) << trunc
    mant_lo = bitops.unpack_codes(verif["mant_lo"], trunc, k)
    exp = coding.decode_exponents(
        {"words": spec["exp_words"], "mode": spec["exp_mode"],
         "emax": spec["exp_emax"], "corr": verif.get("exp_corr")},
        exp_of_rank, k, exp_bits, exact=True, corr_bits=corr_bits)
    return bitops.join_fields(sign, exp, mant_hi | mant_lo)


# ---------------------------------------------------------------------------
# Tensor-level format
# ---------------------------------------------------------------------------

def _select(x: torch.Tensor, scores, keep: int, block: int) -> dict:
    """The top-k partition of ``format_tensor``. ``scores`` None ranks by
    magnitude (|x| in f32); a magnitude selection with one block per vector
    (the KV encode) runs through ``kernels.kv_topk``."""
    if scores is None and block == x.shape[-1]:
        sel = KT.kv_topk(x.contiguous(), keep)
        return {"bitmap": sel["bitmap"][..., None, :],
                "kept": sel["kept"][..., None, :],
                "pruned": sel["pruned"][..., None, :]}
    if scores is None:
        scores = x.to(torch.float32).abs()
    return pruning.select_topk_blocked(x, scores, keep, block)


def format_tensor(x: torch.Tensor, scores, cfg: CassandraConfig,
                  block: int, keep: int, group: int, trunc: int,
                  codebook=None, corr_bits: int = coding.CORR_BITS,
                  pruned_raw: bool = False):
    """Partition (..., N) bf16 into (speculation, verification) dicts.

    ``scores`` — (..., N) selection scores, or None for the magnitude
    |x| (see ``_select``). ``codebook`` — optional external (exp_of_rank,
    rank_of_exp) pair (the online KV encoder's cache-global book);
    per-tensor books are built when None. ``pruned_raw`` stores pruned
    values as raw 16-bit patterns (always so for Cassandra-2).
    """
    x = x.to(torch.bfloat16)
    sel = _select(x, scores, keep, block)
    spec, verif = _split_kept(sel["kept"], trunc, cfg.variant, group,
                              cfg.mx_draft_bits)
    spec["bitmap"] = sel["bitmap"]
    if cfg.variant != 1:
        verif["pruned_raw"] = sel["pruned"].contiguous().view(torch.int16)
        return spec, verif
    kept_exp = spec.pop("exp")
    if codebook is None:
        exp_of_rank, rank_of_exp = coding.build_codebook(kept_exp)
        spec["codebook"] = coding.trim_codebook(exp_of_rank)
    else:
        exp_of_rank, rank_of_exp = codebook
    region = coding.encode_exponents(kept_exp, rank_of_exp, cfg.exp_bits,
                                     corr_bits)
    spec["exp_words"] = region["words"]
    spec["exp_mode"] = region["mode"]
    spec["exp_emax"] = region["emax"]
    verif["exp_corr"] = region["corr"]
    if keep == block:
        pass                                   # nothing pruned — no payload
    elif pruned_raw:
        verif["pruned_raw"] = sel["pruned"].contiguous().view(torch.int16)
    else:
        psign, pexp, pmant = bitops.split_fields(sel["pruned"])
        verif["pruned_signmant"] = (psign << 7) | pmant
        if codebook is None:
            p_of_rank, p_rank = coding.build_codebook(pexp)
            verif["pruned_codebook"] = coding.trim_codebook(p_of_rank)
        else:
            p_rank = codebook[1]
        pregion = coding.encode_exponents(pexp, p_rank, cfg.exp_bits,
                                          corr_bits)
        verif["pruned_exp_words"] = pregion["words"]
        verif["pruned_exp_mode"] = pregion["mode"]
        verif["pruned_exp_emax"] = pregion["emax"]
        verif["pruned_exp_corr"] = pregion["corr"]
    return spec, verif


def draft_tensor(spec: dict, cfg: CassandraConfig, block: int, keep: int,
                 group: int, trunc: int, n: int, codebook=None,
                 corr_bits: int = coding.CORR_BITS) -> torch.Tensor:
    """Draft view: kept values (truncated), zeros at pruned positions."""
    book = spec.get("codebook")
    if book is None and codebook is not None:
        book = codebook[0]
    kept = _join_kept_draft(spec, keep, trunc, cfg.variant, group,
                            cfg.mx_draft_bits, book, cfg.exp_bits, corr_bits)
    return pruning.desparsify(spec["bitmap"], kept, block)


def target_tensor(spec: dict, verif: dict, cfg: CassandraConfig, block: int,
                  keep: int, group: int, trunc: int, n: int, codebook=None,
                  corr_bits: int = coding.CORR_BITS) -> torch.Tensor:
    """Full reconstruction from speculation + verification data."""
    book = spec.get("codebook")
    if book is None and codebook is not None:
        book = codebook[0]
    kept = _join_kept_target(spec, verif, keep, trunc, cfg.variant, group,
                             cfg.mx_draft_bits, book, cfg.exp_bits, corr_bits)
    if keep == block:
        return pruning.desparsify(spec["bitmap"], kept, block)
    if cfg.variant == 1 and "pruned_raw" not in verif:
        pbook = verif.get("pruned_codebook")
        if pbook is None and codebook is not None:
            pbook = codebook[0]
        pcode = verif["pruned_signmant"]
        pexp = coding.decode_exponents(
            {"words": verif["pruned_exp_words"],
             "mode": verif["pruned_exp_mode"],
             "emax": verif["pruned_exp_emax"],
             "corr": verif.get("pruned_exp_corr")},
            pbook, block - keep, cfg.exp_bits, exact=True,
            corr_bits=corr_bits)
        pruned = bitops.join_fields((pcode >> 7) & 1, pexp, pcode & 0x7F)
    else:
        pruned = bitops.bits_to_bf16(verif["pruned_raw"])
    return pruning.desparsify(spec["bitmap"], kept, block, pruned=pruned)


# ---------------------------------------------------------------------------
# Weight / KV entry points
# ---------------------------------------------------------------------------

def _trim_lossless(spec: dict, verif: dict, variant: int):
    """Drop correction nibbles when every superblock is mode-0 (unary).

    Offline only: reads the mode flags on the host.
    """
    if variant != 1:
        return spec, verif
    if not bool(spec["exp_mode"].any()):
        verif = {k: v for k, v in verif.items() if k != "exp_corr"}
    if "pruned_exp_mode" in verif and not bool(verif["pruned_exp_mode"].any()):
        verif = {k: v for k, v in verif.items() if k != "pruned_exp_corr"}
    return spec, verif


# Row chunk for the plain whole-weight decodes (every decode on the CPU and
# the C-1 draft view, MLA's kv_b, on the card; on the card the C-1 target
# view is one ``target_decode`` launch and each C-2 view one ``mx_view``
# launch, with no transients): a chunk of output columns of a packed weight
# decodes with transients of a few hundred MB (C-1) to about a GB (C-2's
# 12-bit low containers) at the paper defaults; lm_head (128256 columns) is
# decoded in 8 such pieces.
ROW_CHUNK = 16384
_SHARED_LEAVES = ("codebook", "pruned_codebook")


def slice_rows(tree: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of a packed weight's per-column leaves (books shared)."""
    return {k: (v if k in _SHARED_LEAVES else v[lo:hi])
            for k, v in tree.items()}


def format_weight(w: torch.Tensor, act_norm, cfg: CassandraConfig):
    """Format a (in, out) weight. Blocks along `in` per output column."""
    if act_norm is not None:
        raise NotImplementedError(
            "Wanda calibration is not ported yet: ROADMAP Queue 1 "
            "(Calibrator / --calibrate)")
    block = cfg.weight_block(w.shape[0])
    keep = cfg.weight_keep(block)
    wt = w.T.contiguous()
    scores = wt.to(torch.float32).abs()
    spec, verif = format_tensor(wt, scores, cfg, block, keep, cfg.mx_group,
                                cfg.weight_trunc)
    return _trim_lossless(spec, verif, cfg.variant)


def _by_rows(decode, trees: tuple, shape: tuple[int, int]) -> torch.Tensor:
    """An (in, out) weight decoded ``ROW_CHUNK`` output columns at a time,
    so the unpacking transients stay bounded."""
    n_in, n_out = shape
    wt = torch.empty((n_out, n_in), dtype=torch.bfloat16,
                     device=trees[0]["bitmap"].device)
    for lo in range(0, n_out, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, n_out)
        wt[lo:hi] = decode(*(slice_rows(t, lo, hi) for t in trees))
    return wt.T


def _mx_weight_view(spec: dict, verif, cfg: CassandraConfig,
                    shape: tuple[int, int], dtype) -> torch.Tensor:
    """A C-2 weight's draft (``verif`` None) or target view as (out, in)
    ``dtype``: one ``mx_view`` launch on CUDA tensors."""
    block = cfg.weight_block(shape[0])
    return MXD.mx_view(spec, verif, block=block, keep=cfg.weight_keep(block),
                       group=cfg.mx_group, draft_bits=cfg.mx_draft_bits,
                       dtype=dtype)


def draft_weight(spec: dict, cfg: CassandraConfig,
                 shape: tuple[int, int]) -> torch.Tensor:
    """The (in, out) draft view. Cassandra-2 on CUDA tensors is one
    ``mx_view`` launch; Cassandra-1, and every weight on the CPU, the
    plain chain :func:`draft_weight_plain`."""
    if cfg.variant != 1 and spec["bitmap"].is_cuda:
        return _mx_weight_view(spec, None, cfg, shape, torch.bfloat16).T
    return draft_weight_plain(spec, cfg, shape)


def draft_weight_plain(spec: dict, cfg: CassandraConfig,
                       shape: tuple[int, int]) -> torch.Tensor:
    """``draft_tensor`` over the weight, ``ROW_CHUNK`` columns at a time."""
    block = cfg.weight_block(shape[0])
    keep = cfg.weight_keep(block)
    return _by_rows(lambda s: draft_tensor(s, cfg, block, keep, cfg.mx_group,
                                           cfg.weight_trunc, shape[0]),
                    (spec,), shape)


def draft_weight_f32(spec: dict, cfg: CassandraConfig,
                     shape: tuple[int, int]) -> torch.Tensor:
    """A C-2 draft view widened to f32, (in, out), the operand of the draft
    product: on CUDA tensors ``mx_view`` writes it in one launch (bit for
    bit the bf16 view widened)."""
    if spec["bitmap"].is_cuda:
        return _mx_weight_view(spec, None, cfg, shape, torch.float32).T
    return draft_weight_plain(spec, cfg, shape).to(torch.float32)


def target_weight(spec: dict, verif: dict, cfg: CassandraConfig,
                  shape: tuple[int, int]) -> torch.Tensor:
    """The exact (in, out) weight. On CUDA tensors Cassandra-1 is one
    ``target_decode`` launch and Cassandra-2 one ``mx_view`` launch; every
    weight on the CPU runs the plain chain :func:`target_weight_plain`."""
    if spec["bitmap"].is_cuda:
        if cfg.variant == 1:
            return UD.target_decode(spec, verif, cfg, shape).T
        return _mx_weight_view(spec, verif, cfg, shape, torch.bfloat16).T
    return target_weight_plain(spec, verif, cfg, shape)


def target_weight_plain(spec: dict, verif: dict, cfg: CassandraConfig,
                        shape: tuple[int, int]) -> torch.Tensor:
    """``target_tensor`` over the weight, ``ROW_CHUNK`` columns at a time:
    the reference's chain, step by step."""
    block = cfg.weight_block(shape[0])
    keep = cfg.weight_keep(block)
    return _by_rows(lambda s, v: target_tensor(s, v, cfg, block, keep,
                                               cfg.mx_group, cfg.weight_trunc,
                                               shape[0]),
                    (spec, verif), shape)


def kv_group(cfg: CassandraConfig, head_dim: int) -> int:
    g = min(16, cfg.mx_group)
    while head_dim % g != 0:
        g //= 2
    return g


def format_kv(kv: torch.Tensor, cfg: CassandraConfig):
    """Format a (..., head_dim) KV tensor with per-token magnitude pruning."""
    d = kv.shape[-1]
    spec, verif = format_tensor(kv, None, cfg, d, cfg.kv_keep(d),
                                kv_group(cfg, d), cfg.kv_trunc)
    return _trim_lossless(spec, verif, cfg.variant)


def draft_kv(spec: dict, cfg: CassandraConfig, head_dim: int) -> torch.Tensor:
    keep = cfg.kv_keep(head_dim)
    return draft_tensor(spec, cfg, head_dim, keep, kv_group(cfg, head_dim),
                        cfg.kv_trunc, head_dim)


def target_kv(spec: dict, verif: dict, cfg: CassandraConfig,
              head_dim: int) -> torch.Tensor:
    keep = cfg.kv_keep(head_dim)
    return target_tensor(spec, verif, cfg, head_dim, keep,
                         kv_group(cfg, head_dim), cfg.kv_trunc, head_dim)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def tree_nbytes(tree) -> int:
    """Total bytes of all tensor leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0

