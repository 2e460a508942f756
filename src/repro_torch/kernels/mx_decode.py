"""Cassandra-2 MX decode: the plain version and the wrapper around the
hand-written CUDA kernel.

The kernel (``csrc/mx_decode.cu``) replaces the TPU kernel ``mx_decode``
(``src/repro/kernels/mx_decode.py``): MX lanes — a sign byte, a 16-bit
fixed-point container and one shared exponent per ``group`` lanes — become
bf16 through a leading-zero count, a normalising shift and an exponent
subtract; a zero container or an exponent <= 0 flushes to zero. Every
Cassandra-2 draft and target view (weights and KV) decodes through it
(``core/format.py``).

* ``mx_decode_plain`` — the same math in PyTorch (``core.mx.mx_decode``
  at the full container width): the CPU path and the kernel's oracle.
* ``mx_decode`` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel (counted in ``mx_decode.launches``) or
  raises.
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
             out.data_ptr(), rows, k, group,
             torch.cuda.current_stream(m16.device).cuda_stream)
    build.raise_on(err, "mx_decode")
    mx_decode.launches += 1
    return out


mx_decode.launches = 0
