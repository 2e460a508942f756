"""Fused Cassandra-1 draft decode + matmul: operand prep, plain version
and the wrapper around the hand-written CUDA kernel.

The kernel (``csrc/draft_matmul.cu``) replaces the TPU kernel
``draft_matmul`` (``src/repro/kernels/draft_matmul.py``; operand prep
``ops.prepare_draft_operands``). It computes ``y = x @ W_draft`` where the
draft weight is rebuilt on chip from the packed speculation stream: a
bitmap, sign|mantissa codes, a fixed 3-bit exponent-*rank* code per kept
value (rank 7 escapes to the block's max exponent — the "Cassandra-1T"
variant, which differs from the exact C-1 draft on under 2% of values) and
an 8-entry book. Its floor is the packed bytes streamed, its limit the
decode's instructions; the source note says how the design meets both.

* ``prepare_draft_operands`` / ``prepare_params`` — the rank codes are
  prepared once, at load time, and kept beside each spec.
* ``draft_matmul_plain`` — the same math in PyTorch (the reference's
  ``draft_matmul_rank3_oracle``): the CPU path and the kernel's oracle.
* ``plan`` / ``plan_ranges`` — how a launch cuts the product: 32 output
  columns per CTA (8 or 32 rows of x) and a range of superblocks (split-K),
  so that every shape puts a few hundred CTAs on the card.
* ``draft_matmul`` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. ``draft_matmul.launches``
  counts wrapper calls (one kernel each; with a K split, the last CTA of a
  column tile sums the split partials).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import bitops, coding, pruning
from repro_torch.core.format import (ROW_CHUNK, CassandraConfig,
                                     draft_weight_f32, slice_rows)
from repro_torch.kernels import build

ESC = 7


# ---------------------------------------------------------------------------
# Operand prep (once, at weight-load time)
# ---------------------------------------------------------------------------

def _prepare_rows(spec: dict, cass: CassandraConfig, keep: int) -> dict:
    book32 = spec["codebook"]
    exps = coding.decode_exponents(
        {"words": spec["exp_words"], "mode": spec["exp_mode"],
         "emax": spec["exp_emax"], "corr": None},
        book32, keep, cass.exp_bits, exact=False)           # (N, NB, K) u8
    code3 = torch.full(exps.shape, ESC, dtype=torch.uint8,
                       device=exps.device)
    for r in range(ESC):
        code3 = torch.where(exps == book32[r], r, code3).to(torch.uint8)
    return {"exp3": bitops.pack_codes(code3, cass.exp_bits),
            "emax": spec["exp_emax"].to(torch.int32)}


def prepare_draft_operands(spec: dict, cass: CassandraConfig,
                           shape: tuple[int, int]) -> dict:
    """Repack one C-1 weight spec into the kernel's operands.

    Returns the reference's operand dict (``bitmap``, ``signmant``,
    ``exp3``, ``emax``, ``book``); the exponent decode runs ``ROW_CHUNK``
    output columns at a time.
    """
    if cass.variant != 1:
        raise ValueError("the draft kernel reads Cassandra-1 operands; a "
                         "Cassandra-2 weight decodes through "
                         "format.draft_weight_f32 (packed_matmul)")
    n_in, n_out = shape
    keep = cass.weight_keep(cass.weight_block(n_in))
    parts = [_prepare_rows(slice_rows(spec, lo, min(lo + ROW_CHUNK, n_out)),
                           cass, keep)
             for lo in range(0, n_out, ROW_CHUNK)]
    book = torch.zeros(8, dtype=torch.int32, device=spec["codebook"].device)
    book[:ESC] = spec["codebook"][:ESC].to(torch.int32)
    return {"bitmap": spec["bitmap"], "signmant": spec["signmant"],
            "exp3": torch.cat([p["exp3"] for p in parts]),
            "emax": torch.cat([p["emax"] for p in parts]), "book": book}


def packed_shape(w: dict) -> tuple[int, int]:
    """(in, out) shape of a packed weight from its bitmap."""
    out, nb, bw = w["spec"]["bitmap"].shape[-3:]
    return nb * bw * 32, out


def prepare_params(params, cass: CassandraConfig):
    """Add a ``"kernel"`` dict (``exp3``/``emax``/``book``) beside every
    packed weight's spec that lacks one; stacked (R, …) specs are prepared
    layer by layer. Cassandra-2 weights have no draft-kernel operands and
    are returned as they are."""
    if cass.variant != 1:
        return params

    def prep(w):
        spec = w["spec"]
        shape = packed_shape(w)
        if spec["bitmap"].ndim == 3:
            ops = prepare_draft_operands(spec, cass, shape)
        else:
            layers = [prepare_draft_operands({k: v[r] for k, v in spec.items()},
                                             cass, shape)
                      for r in range(spec["bitmap"].shape[0])]
            ops = {k: torch.stack([o[k] for o in layers]) for k in layers[0]}
        return {**w, "kernel": {k: ops[k] for k in ("exp3", "emax", "book")}}

    def walk(node):
        if isinstance(node, dict):
            if "spec" in node and "verif" in node:
                return node if "kernel" in node else prep(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# Plain version (CPU path and oracle)
# ---------------------------------------------------------------------------

def draft_weight_plain(bitmap, signmant, exp3, emax, book, *, block: int,
                       keep: int, trunc: int,
                       exp_bits: int = 3) -> torch.Tensor:
    """The kernel's decoded draft weight, (K, N) bf16."""
    n, nb = bitmap.shape[0], bitmap.shape[1]
    code3 = bitops.unpack_codes(exp3, exp_bits, keep)
    exps = torch.where(code3 == ESC, emax[..., None],
                       book[code3.clamp(max=ESC - 1).to(torch.int64)])
    t_keep = bitops.MANT_BITS - trunc
    code = bitops.unpack_codes(signmant, 1 + t_keep, keep)
    sign = (code >> t_keep) & 1
    mant = (code & ((1 << t_keep) - 1)) << trunc
    kept = bitops.join_fields(sign, exps & 0xFF, mant)
    wt = pruning.desparsify(bitmap, kept, block)            # (N, K)
    return wt.reshape(n, nb * block).T


def draft_matmul_plain(x, bitmap, signmant, exp3, emax, book, *, block: int,
                       keep: int, trunc: int,
                       exp_bits: int = 3) -> torch.Tensor:
    """x (M, K) @ decoded draft weight -> (M, N) f32 (rank3-oracle math)."""
    w = draft_weight_plain(bitmap, signmant, exp3, emax, book, block=block,
                           keep=keep, trunc=trunc, exp_bits=exp_bits)
    return x.to(torch.float32) @ w.to(torch.float32)


# ---------------------------------------------------------------------------
# Launch plan (mirrors the kernel's grid)
# ---------------------------------------------------------------------------

TILE_COLS = 32                  # output columns per CTA
TARGET_CTAS = 4 * build.SM_COUNT    # enough CTAs to hide a stage's latency


def tile_rows(m: int) -> int:
    """Rows of x per CTA: one n = 8 mma tile at decode sizes, four above."""
    return 8 if m <= 8 else 32


def plan(m: int, n: int, nb: int) -> tuple[int, int]:
    """(superblocks per CTA, K splits) for x (m, nb·block) @ W (·, n).

    Column tiles x row tiles x splits reach ``TARGET_CTAS`` where the
    superblocks allow. Every split holds at least one superblock."""
    tiles = -(-n // TILE_COLS) * -(-m // tile_rows(m))
    want = max(1, min(nb, -(-TARGET_CTAS // tiles)))
    chunk = -(-nb // want)
    return chunk, -(-nb // chunk)


def plan_ranges(m: int, n: int, nb: int) -> list:
    """Each CTA's (columns, superblocks, rows) as ``range``s, in the order
    of the kernel's grid (x: column tile, y: split, z: row tile)."""
    chunk, splits = plan(m, n, nb)
    rows = tile_rows(m)
    return [(range(c, min(n, c + TILE_COLS)),
             range(s * chunk, min(nb, (s + 1) * chunk)),
             range(r, min(m, r + rows)))
            for r in range(0, m, rows) for s in range(splits)
            for c in range(0, n, TILE_COLS)]


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _launch_shape(m: int, n: int, nb: int, block: int, keep: int, trunc: int,
                  exp_bits: int) -> tuple:
    """(wsm, we, chunk, splits) of one launch: the host work shared by every
    call of a shape, done once."""
    if exp_bits != 3:
        raise ValueError(f"the kernel reads 3-bit rank codes (exp_bits={exp_bits})")
    if not 0 <= trunc <= 7:
        raise ValueError(f"trunc={trunc} outside [0, 7]")
    wsm = coding.region_words(keep, 1 + bitops.MANT_BITS - trunc)
    we = coding.region_words(keep, exp_bits)
    return (wsm, we, *plan(m, n, nb))


def _launch(x, bitmap, signmant, exp3, emax, book, *, block, keep, trunc,
            exp_bits) -> torch.Tensor:
    m, k = x.shape
    n, nb = bitmap.shape[0], bitmap.shape[1]
    if nb * block != k:
        raise ValueError(f"x has K={k} but the weight {nb}x{block}")
    wsm, we, chunk, splits = _launch_shape(m, n, nb, block, keep, trunc,
                                           exp_bits)
    build.check(x, "x", torch.bfloat16, (m, k))
    build.check(bitmap, "bitmap", torch.int32, (n, nb, block // 32))
    build.check(signmant, "signmant", torch.int32, (n, nb, wsm))
    build.check(exp3, "exp3", torch.int32, (n, nb, we))
    build.check(emax, "emax", torch.int32, (n, nb))
    build.check(book, "book", torch.int32, (8,))
    if x.data_ptr() % 16:
        x = x.clone()                   # the kernel reads x 16 B at a time
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        tickets = build.tickets(x.device, -(-n // TILE_COLS)
                                * -(-m // tile_rows(m)))
    fn = build.entry("draft_matmul", "cassandra_draft_matmul", 9, 9)
    err = fn(x.data_ptr(), bitmap.data_ptr(), signmant.data_ptr(),
             exp3.data_ptr(), emax.data_ptr(), book.data_ptr(), y.data_ptr(),
             0 if ws is None else ws.data_ptr(),
             0 if tickets is None else tickets.data_ptr(), m, k, n, block,
             keep, trunc, wsm, we, chunk, build.stream(x))
    build.raise_on(err, "draft_matmul")
    draft_matmul.launches += 1
    return y


def draft_matmul(x, bitmap, signmant, exp3, emax, book, *, block: int,
                 keep: int, trunc: int, exp_bits: int = 3) -> torch.Tensor:
    """x (M, K) @ packed draft weight (K, N) -> (M, N) f32.

    CPU tensors take :func:`draft_matmul_plain`; CUDA tensors launch the
    kernel (counted in ``draft_matmul.launches``) or raise.
    """
    kw = dict(block=block, keep=keep, trunc=trunc, exp_bits=exp_bits)
    if x.device.type == "cpu":
        return draft_matmul_plain(x, bitmap, signmant, exp3, emax, book, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"draft_matmul: unsupported device {x.device}")
    return _launch(x, bitmap, signmant, exp3, emax, book, **kw)


draft_matmul.launches = 0


def packed_matmul(x: torch.Tensor, w: dict,
                  cass: CassandraConfig) -> torch.Tensor:
    """x (..., K) @ draft weight of a packed weight ``w``, cast to
    ``x.dtype`` (the reference's ``ops.draft_matmul``).

    Cassandra-1 runs the draft kernel on the prepared operands.
    Cassandra-2, as in the reference, decodes the draft weight and
    multiplies in f32 outside any kernel: on CUDA tensors the f32 view is
    one ``mx_view`` launch (``format.draft_weight_f32``), with no bf16 view
    and no cast pass."""
    if cass.variant != 1:
        wd = draft_weight_f32(w["spec"], cass, packed_shape(w))
        y = torch.matmul(x.to(torch.float32), wd)
        return y.to(x.dtype)
    if "kernel" not in w:
        raise ValueError("packed weight has no prepared kernel operands: "
                         "run kernels.draft_matmul.prepare_params first")
    n_in, n_out = packed_shape(w)
    block = cass.weight_block(n_in)
    kops = w["kernel"]
    x2 = x.reshape(-1, n_in).contiguous()
    y = draft_matmul(x2, w["spec"]["bitmap"], w["spec"]["signmant"],
                     kops["exp3"], kops["emax"], kops["book"], block=block,
                     keep=cass.weight_keep(block), trunc=cass.weight_trunc,
                     exp_bits=cass.exp_bits)
    return y.reshape(*x.shape[:-1], n_out).to(x.dtype)
