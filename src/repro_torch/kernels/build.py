"""Build and load the port's CUDA kernels (plain-C shared libraries).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the repository root (a directory
``.gitignore`` lists) and loads with ``ctypes``. The file name carries a
hash of the source and flags, so an edited source never loads a stale
library. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine need not have ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SM_COUNT = 132                  # H100 SXM: the launch plans size grids by it


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float          # 0.0 when an existing build was reused
    log: str                # nvcc/ptxas output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> list[Built]:
    """Compile every named source (default: all) in parallel."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = [], []
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            out.append(Built(name, target, 0.0, "reused"))
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, target)
        out.append(Built(name, target, time.perf_counter() - t0, log))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    (built,) = build_all([name])
    return ctypes.CDLL(str(built.path))


def entry(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    """``symbol`` of ``csrc/<name>.cu`` as a ctypes function taking
    ``n_ptr`` pointers, ``n_int`` ints, ``n_float`` floats and the stream,
    returning the CUDA error code of its launch."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if t.is_cuda and t.dtype == dtype and t.shape == shape \
            and t.is_contiguous():
        return                  # the common case, in one cheap expression
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, not on the card")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


_tickets: dict = {}


def tickets(device, n: int):
    """int32 ticket counters on ``device`` for kernels whose last CTA of a
    group finishes the group's work: zeros, each re-armed to 0 by the CTA
    that takes it last, so one buffer serves every launch on the stream.
    Grown to ``n`` entries, never inside a CUDA graph capture."""
    import torch
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("run the shape once before capturing it in a "
                               "CUDA graph (its ticket counters are "
                               "allocated on first use)")
        t = torch.zeros(max(4096, 1 << (n - 1).bit_length()),
                        dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def stream(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:         # skips building a Stream object per launch
        return raw(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
