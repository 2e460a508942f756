"""Fused Cassandra-1 draft decode + matmul: operand prep, plain version
and the wrapper around the hand-written CUDA kernel.

The kernel (``csrc/draft_matmul.cu``) replaces the TPU kernel
``draft_matmul`` (``src/repro/kernels/draft_matmul.py``; operand prep
``ops.prepare_draft_operands``). It computes ``y = x @ W_draft`` where the
draft weight is rebuilt on chip from the packed speculation stream: a
bitmap, sign|mantissa codes, a fixed 3-bit exponent-*rank* code per kept
value (rank 7 escapes to the block's max exponent — the "Cassandra-1T"
variant, which differs from the exact C-1 draft on under 2% of values) and
an 8-entry book. Its bound is the packed bytes streamed; the source note
says how the design meets it.

* ``prepare_draft_operands`` / ``prepare_params`` — the rank codes are
  prepared once, at load time, and kept beside each spec.
* ``draft_matmul_plain`` — the same math in PyTorch (the reference's
  ``draft_matmul_rank3_oracle``): the CPU path and the kernel's oracle.
* ``draft_matmul`` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. ``draft_matmul.launches``
  counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops, coding, pruning
from repro_torch.core.format import ROW_CHUNK, CassandraConfig, slice_rows

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
        raise NotImplementedError(
            "the draft kernel is Cassandra-1 only; Cassandra-2 is ROADMAP "
            "Queue 1 step 9")
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
    layer by layer."""
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
# Wrapper
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, x is on the card")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(x, bitmap, signmant, exp3, emax, book, *, block, keep, trunc,
            exp_bits) -> torch.Tensor:
    from repro_torch.kernels import build    # nvcc only when launching
    if exp_bits != 3:
        raise ValueError(f"the kernel reads 3-bit rank codes (exp_bits={exp_bits})")
    if not 0 <= trunc <= 7:
        raise ValueError(f"trunc={trunc} outside [0, 7]")
    m, k = x.shape
    n, nb = bitmap.shape[0], bitmap.shape[1]
    if nb * block != k:
        raise ValueError(f"x has K={k} but the weight {nb}x{block}")
    wsm = coding.region_words(keep, 1 + bitops.MANT_BITS - trunc)
    we = coding.region_words(keep, exp_bits)
    _check(x, "x", torch.bfloat16, (m, k))
    _check(bitmap, "bitmap", torch.int32, (n, nb, block // 32))
    _check(signmant, "signmant", torch.int32, (n, nb, wsm))
    _check(exp3, "exp3", torch.int32, (n, nb, we))
    _check(emax, "emax", torch.int32, (n, nb))
    _check(book, "book", torch.int32, (8,))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = build.load("draft_matmul").cassandra_draft_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), bitmap.data_ptr(), signmant.data_ptr(),
             exp3.data_ptr(), emax.data_ptr(), book.data_ptr(), y.data_ptr(),
             m, k, n, block, keep, trunc, wsm, we, stream)
    if err != 0:
        raise RuntimeError(f"draft_matmul kernel launch failed: CUDA error {err}")
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
    """x (..., K) @ draft weight of a prepared packed weight ``w``, cast to
    ``x.dtype`` (the reference's ``ops.draft_matmul``)."""
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
