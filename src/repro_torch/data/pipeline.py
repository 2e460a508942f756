"""Token pipeline (port of ``data/pipeline.py``): a deterministic synthetic
corpus, host-sharded loading and background prefetch.

The synthetic text is an order-1 Markov stream drawn with numpy from
``default_rng([seed, host_id, step])``, so a resumed run replays exactly
the batches it would have seen. The draws are the reference's, in its
order; only the last step differs: the batch becomes torch tensors on the
requested device (tokens and labels int32, a frontend's embeddings bf16,
rounded from f32 to nearest-even as ``jnp.asarray(..., bfloat16)`` rounds).
A file-backed stream memory-maps a flat int32 token file and strides the
hosts' shards across it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    token_file: str | None = None
    frontend: str = ""              # mirror model frontend stubs
    frontend_tokens: int = 0
    d_model: int = 0


def _markov_tokens(rng: np.random.Generator, n_seqs: int, s: int,
                   vocab: int) -> np.ndarray:
    """Learnable order-1 chain: next = (3·prev + e) % V, e ∈ {0,1,2}.

    The optimal next-token entropy is log(3) ≈ 1.1 nats against log(V)
    for an untrained model: a large gap, learnt quickly."""
    toks = np.zeros((n_seqs, s), np.int64)
    toks[:, 0] = rng.integers(0, vocab, n_seqs)
    noise = rng.integers(0, 3, (n_seqs, s))
    for t in range(1, s):
        toks[:, t] = (toks[:, t - 1] * 3 + noise[:, t]) % vocab
    return toks


def _one_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Host ``cfg.host_id``'s slice of the global batch at ``step``:
    ``tokens`` and ``labels`` (the tokens one position on), after a vision
    frontend's ``frontend_tokens`` positions are taken from the text, and a
    frontend's ``patch_embeds`` / ``frame_embeds``."""
    per_host = cfg.global_batch // cfg.n_hosts
    rng = np.random.default_rng([cfg.seed, cfg.host_id, step])
    if cfg.token_file:
        data = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
        need = per_host * (cfg.seq_len + 1)
        start = (step * cfg.global_batch * (cfg.seq_len + 1)
                 + cfg.host_id * need) % max(len(data) - need, 1)
        toks = np.asarray(data[start:start + need], dtype=np.int32)
        toks = toks.reshape(per_host, cfg.seq_len + 1)
    else:
        toks = _markov_tokens(rng, per_host, cfg.seq_len + 1,
                              cfg.vocab_size).astype(np.int32)
    s_text = cfg.seq_len - (cfg.frontend_tokens
                            if cfg.frontend == "vision" else 0)
    batch = {"tokens": torch.from_numpy(toks[:, :s_text].copy()).to(device),
             "labels": torch.from_numpy(
                 toks[:, 1:s_text + 1].copy()).to(device)}
    name = {"vision": "patch_embeds", "audio": "frame_embeds"}.get(
        cfg.frontend)
    if name is not None:
        x = rng.standard_normal(
            (per_host, cfg.frontend_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
        batch[name] = torch.from_numpy(x).to(torch.bfloat16).to(device)
    return batch


def synthetic_batches(cfg: DataConfig, start_step: int = 0, device="cuda"):
    """Infinite deterministic (step, batch) iterator, resumable at any
    step."""
    step = start_step
    while True:
        yield step, _one_batch(cfg, step, device)
        step += 1


def host_shard_iterator(cfg: DataConfig, start_step: int = 0, device="cuda"):
    """Alias making the host-sharding contract explicit (per-host slices)."""
    return synthetic_batches(cfg, start_step, device)


class Prefetcher:
    """Background-thread prefetch of the next ``depth`` batches."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
