"""Checkpointing for fault tolerance and elastic restarts (port of
``checkpoint/manager.py``), in the reference's on-disk format, so either
package restores what the other wrote:

* one ``shard-<host>.npz`` per host holding that host's slice of every
  leaf, plus ``manifest.json`` describing the global tree (paths, shapes,
  dtypes, shard layout, sha256 content hashes);
* leaf paths in ``jax.tree_util.keystr`` form over sorted dict keys
  (``[0]['dec'][0]['e0']['attn']['wq']['w']``), npz keys the first 24 hex
  digits of the path's sha256;
* a bf16 leaf stored as a uint8 view of its bytes under the dtype name
  ``bfloat16``.

Writes go to a ``.tmp-<step>-<host>`` directory, are fsynced, then renamed
to ``step-N``: a crashed writer never corrupts the latest checkpoint, and
partial writes are skipped at restore. The manifest, not the file layout,
is the source of truth, so N hosts' shards restore on M.

bf16 crosses as 16-bit integer views (``.view(torch.bfloat16)``): the
port never imports ``ml_dtypes``. ``CheckpointManager(async_save=True)``
copies every leaf to host memory before it returns (the next step writes
the parameters in place) and writes in a background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, tree_map, tree_unflatten

_NATIVE = set("float64 float32 float16 complex64 complex128 int64 int32 "
              "int16 int8 uint64 uint32 uint16 uint8 bool".split())


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the leaf's values as numpy, its dtype name): a bf16 tensor as its
    16-bit patterns (int16) under ``bfloat16``."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _leaf_hash(arr: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(arr).view(np.uint8)).hexdigest()[:16]


def _from_native(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The stored array as a flat tensor of ``dtype_name``."""
    if dtype_name == "bfloat16":
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    if dtype_name not in _NATIVE:
        raise TypeError(f"checkpoint dtype {dtype_name} has no torch view")
    return torch.from_numpy(np.array(arr, dtype=dtype_name).reshape(-1))


def save_checkpoint(directory: str, step: int, tree, host_id: int = 0,
                    n_hosts: int = 1) -> str:
    """Write this host's shard and (host 0) the manifest; atomic rename.
    Leaves are tensors on any device."""
    tmp = os.path.join(directory, f".tmp-{step}-{host_id}")
    final = os.path.join(directory, f"step-{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    shard_data = {}
    manifest = {"step": step, "n_hosts": n_hosts, "leaves": {}}
    for path, leaf in leaves_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        # host-shard along axis 0 when divisible (data-parallel state)
        if n_hosts > 1 and arr.ndim and arr.shape[0] % n_hosts == 0:
            per = arr.shape[0] // n_hosts
            piece = arr[host_id * per:(host_id + 1) * per]
            sharded = True
        else:
            piece = arr if host_id == 0 else np.zeros((0,), arr.dtype)
            sharded = False
        if dtype == "bfloat16":     # its bytes: the last axis doubled
            piece = np.ascontiguousarray(piece).view(np.uint8)
        key = hashlib.sha256(path.encode()).hexdigest()[:24]
        shard_data[key] = piece
        manifest["leaves"][path] = {
            "key": key, "shape": list(arr.shape), "dtype": dtype,
            "sharded": sharded, "hash": _leaf_hash(piece)}
    np.savez(os.path.join(tmp, f"shard-{host_id}.npz"), **shard_data)
    if host_id == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    # fsync then atomic publish
    for name in os.listdir(tmp):
        with open(os.path.join(tmp, name), "rb") as f:
            os.fsync(f.fileno())
    if n_hosts == 1:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    else:
        _merge_rename(tmp, final)     # other hosts' shards already there
    return final


def _merge_rename(tmp: str, final: str):
    os.makedirs(final, exist_ok=True)
    for name in os.listdir(tmp):
        os.replace(os.path.join(tmp, name), os.path.join(final, name))
    shutil.rmtree(tmp, ignore_errors=True)


def _is_complete(path: str) -> bool:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        for h in range(manifest["n_hosts"]):
            if not os.path.exists(os.path.join(path, f"shard-{h}.npz")):
                return False
        return True
    except (json.JSONDecodeError, KeyError):
        return False


def latest_step(directory: str) -> int | None:
    """Last *complete* checkpoint step (partial writes skipped)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("step-") and _is_complete(
                os.path.join(directory, name)):
            steps.append(int(name.split("-")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like_tree,
                       verify_hash: bool = True):
    """Assemble the global tree from all shards (reshard-agnostic): every
    leaf a tensor of the manifest's dtype and shape, on the device of
    ``like_tree``'s leaf at its path (the CPU for a non-tensor leaf)."""
    path = os.path.join(directory, f"step-{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards = [np.load(os.path.join(path, f"shard-{h}.npz"))
              for h in range(manifest["n_hosts"])]
    values = {}
    for leaf_path, meta in manifest["leaves"].items():
        key = meta["key"]
        if meta["sharded"]:
            arr = np.concatenate([s[key] for s in shards], axis=0)
        else:
            arr = shards[0][key]
        flat = _from_native(arr, meta["dtype"])
        if verify_hash and manifest["n_hosts"] == 1:
            raw = flat.view(torch.int16) if meta["dtype"] == "bfloat16" \
                else flat
            if _leaf_hash(raw.numpy()) != meta["hash"]:
                raise IOError(f"checkpoint corruption at {leaf_path}")
        values[leaf_path] = flat.reshape(meta["shape"])
    return tree_unflatten(like_tree, [
        values[p].to(leaf.device) if isinstance(leaf, torch.Tensor)
        else values[p] for p, leaf in leaves_with_paths(like_tree)])


def _host_copy(tree):
    """Every tensor leaf copied to host memory (a new tensor even for a
    CPU leaf: the next step writes the parameters in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


class CheckpointManager:
    """save-every-k manager with optional async writes and auto-resume."""

    def __init__(self, directory: str, save_every: int = 100,
                 keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every:
            return False
        host_tree = _host_copy(tree)                 # device->host snapshot
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree)
        return True

    def _save_and_gc(self, step: int, tree):
        save_checkpoint(self.directory, step, tree)
        steps = sorted(
            int(n.split("-")[1]) for n in os.listdir(self.directory)
            if n.startswith("step-"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def resume(self, like_tree):
        """(step, tree) from the last complete checkpoint, or (0, like)."""
        step = latest_step(self.directory)
        if step is None:
            return 0, like_tree
        return step, restore_checkpoint(self.directory, step, like_tree)
