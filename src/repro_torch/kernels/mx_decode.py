"""Cassandra-2 MX decode, alone and as one-launch tensor views: the plain
versions and the wrappers around the hand-written CUDA kernels.

The kernels (``csrc/mx_decode.cu``) replace the TPU kernel ``mx_decode``
(``src/repro/kernels/mx_decode.py``) and, for a whole packed C-2 tensor,
the reference's ``format.draft_tensor`` / ``target_tensor`` chain around
it: MX lanes — a sign, a 16-bit fixed-point container and one shared
exponent per ``group`` lanes — become bf16 through a leading-zero count, a
normalising shift and an exponent subtract; a zero container or an
exponent <= 0 flushes to zero. Both kernels run that decode through one
device function.

* ``mx_decode_plain`` — the same math in PyTorch (``core.mx.mx_decode``
  at the full container width): the CPU path and the kernel's oracle.
* ``mx_decode`` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel (counted in ``mx_decode.launches``) or
  raises.
* ``mx_view`` — a packed C-2 tensor's draft or target view (the weights'
  views in ``core/format.py``, the KV stores' in ``serving/kvcache.py``),
  bf16 or, for the draft product, f32, in one launch
  (``mx_view.launches``). Its plain version ``mx_view_plain`` is the chain
  of plain steps (``format.draft_tensor`` / ``target_tensor``), which CPU
  tensors run. ``view_plan`` is the launch's cut of the blocks.
"""
from __future__ import annotations

import torch

from repro_torch.core import mx
from repro_torch.kernels import build


def mx_decode_plain(sign: torch.Tensor, m16: torch.Tensor,
                    shared_exp: torch.Tensor, group: int = 32) -> torch.Tensor:
    """(..., K) lanes -> (..., K) bf16; ``shared_exp`` is (..., K//group)."""
    return mx.mx_decode({"sign": sign, "m16": m16, "shared_exp": shared_exp},
                        group=group)


def mx_decode(sign: torch.Tensor, m16: torch.Tensor, shared_exp: torch.Tensor,
              group: int = 32) -> torch.Tensor:
    """(..., K) MX lanes -> (..., K) bf16.

    ``sign`` uint8, ``m16`` int16 (bit-view of the uint16 container),
    ``shared_exp`` (..., K//group) uint8. CPU tensors take
    :func:`mx_decode_plain`; CUDA tensors launch the kernel or raise."""
    if m16.device.type == "cpu":
        return mx_decode_plain(sign, m16, shared_exp, group)
    if m16.device.type != "cuda":
        raise ValueError(f"mx_decode: unsupported device {m16.device}")
    k = m16.shape[-1]
    if group < 1 or k % group != 0:
        raise ValueError(f"K={k} not divisible by group={group}")
    lead = tuple(m16.shape[:-1])
    build.check(sign, "sign", torch.uint8, (*lead, k))
    build.check(m16, "m16", torch.int16, (*lead, k))
    build.check(shared_exp, "shared_exp", torch.uint8, (*lead, k // group))
    out = torch.empty(m16.shape, dtype=torch.bfloat16, device=m16.device)
    rows = m16.numel() // k
    if rows == 0:
        return out
    fn = build.entry("mx_decode", "mx_decode_launch", 4, 3)
    err = fn(sign.data_ptr(), m16.data_ptr(), shared_exp.data_ptr(),
             out.data_ptr(), rows, k, group, build.stream(m16))
    build.raise_on(err, "mx_decode")
    mx_decode.launches += 1
    return out


mx_decode.launches = 0


# ---------------------------------------------------------------------------
# mx_view: a packed C-2 tensor's draft or target view in one launch
# ---------------------------------------------------------------------------

VIEW_WARPS = 8                  # warps per CTA, one block each at a time
VIEW_CTAS = 4 * build.SM_COUNT  # one wave: 4 CTAs an SM holds
MAX_BLOCK = 512


def view_plan(blocks: int) -> tuple[int, int]:
    """(blocks per CTA, CTAs) for a tensor of ``blocks`` packed blocks:
    runs of at least one block per warp, ``VIEW_CTAS`` of them where the
    tensor allows. CTA c owns blocks [c * chunk, (c + 1) * chunk)."""
    chunk = max(VIEW_WARPS, -(-blocks // VIEW_CTAS))
    return chunk, -(-blocks // chunk)


def mx_view_plain(spec: dict, verif: dict | None, *, block: int, keep: int,
                  group: int, draft_bits: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The chain ``mx_view`` is held to: ``format.draft_tensor`` (``verif``
    None) or ``format.target_tensor`` over the packed leaves, (..., NB,
    ·) -> (..., NB * block), cast to ``dtype``."""
    from repro_torch.core import format as fmt    # format imports this module
    cass = fmt.CassandraConfig(variant=2, mx_draft_bits=draft_bits)
    if verif is None:
        out = fmt.draft_tensor(spec, cass, block, keep, group, 0, block)
    else:
        out = fmt.target_tensor(spec, verif, cass, block, keep, group, 0,
                                block)
    return out.to(dtype)


def _leaf(tree: dict, name: str, dtype, shape: tuple):
    """A checked leaf, copied when its address is not 4-byte aligned (the
    kernel copies the word regions 4 bytes at a time at least)."""
    t = tree[name]
    build.check(t, name, dtype, shape)
    return t if t.data_ptr() % 4 == 0 else t.clone()


def mx_view(spec: dict, verif: dict | None, *, block: int, keep: int,
            group: int, draft_bits: int,
            dtype=torch.bfloat16) -> torch.Tensor:
    """The draft (``verif`` None) or target view of a packed Cassandra-2
    tensor whose leaves are (..., NB, ·) as ``format.format_tensor`` lays
    them out, as (..., NB * block) ``dtype`` (bf16, or f32 for the draft
    product: the bf16 view widened).

    CPU tensors take :func:`mx_view_plain`; CUDA tensors launch the kernel
    (counted in ``mx_view.launches``) or raise."""
    bm = spec["bitmap"]
    if bm.device.type == "cpu":
        return mx_view_plain(spec, verif, block=block, keep=keep, group=group,
                             draft_bits=draft_bits, dtype=dtype)
    if bm.device.type != "cuda":
        raise ValueError(f"mx_view: unsupported device {bm.device}")
    p = block - keep
    if (block % 32 or not 32 <= block <= MAX_BLOCK or not 0 < keep <= block
            or group < 1 or group & (group - 1) or keep % group
            or keep // group > 32 or not 1 <= draft_bits <= 15 or p % 2):
        raise ValueError(f"mx_view: block={block}, keep={keep}, "
                         f"group={group}, draft_bits={draft_bits} outside "
                         f"what the kernel decodes")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mx_view writes bf16 or f32, not {dtype}")
    lead = tuple(bm.shape[:-2])
    nb = bm.shape[-2] if bm.ndim >= 2 else 0

    def words(width: int) -> tuple:
        return (*lead, nb, (keep * width + 31) // 32)

    i32 = torch.int32
    ptrs = [_leaf(spec, "bitmap", i32, (*lead, nb, block // 32)),
            _leaf(spec, "signmant", i32, words(1 + draft_bits)),
            _leaf(spec, "shared_exp", torch.uint8, (*lead, nb, keep // group)),
            None, None]
    if verif is not None:
        ptrs[3] = _leaf(verif, "mant_lo", i32, words(16 - draft_bits))
        if p:
            ptrs[4] = _leaf(verif, "pruned_raw", torch.int16, (*lead, nb, p))
    out = torch.empty((*lead, nb * block), dtype=dtype, device=bm.device)
    units = bm.numel() // (block // 32)
    if units == 0:
        return out
    if units >= 2 ** 31:
        raise ValueError(f"mx_view: {units} blocks in one launch")
    chunk, _ = view_plan(units)
    fn = build.entry("mx_decode", "mx_view_launch", 6, 7)
    err = fn(*[0 if t is None else t.data_ptr() for t in ptrs],
             out.data_ptr(), units, block, keep, group, draft_bits,
             int(dtype == torch.float32), chunk, build.stream(bm))
    build.raise_on(err, "mx_view")
    mx_view.launches += 1
    return out


mx_view.launches = 0
