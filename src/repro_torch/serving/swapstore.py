"""Host-side spill store for preempted requests' KV block chains (port of
``serving/swapstore.py``).

When the queue head cannot reserve its blocks, the scheduler's victim
policy may swap a resident row out: its blocks' contents are gathered on
the device (``kvcache.spill_pool_blocks``), copied here, and its physical
blocks return to the pool, so the head admits at once. The victim
re-admits later as an ordinary prefix match plus a batched restore
(``kvcache.restore_pool_blocks``) of whatever the radix cache no longer
holds.

The store is a dict of per-request *chains*, each a bit-copy of the row's
resident logical blocks (plain bf16 or Cassandra-packed leaves alike:
spill never decodes), keyed by a per-preemption token the scheduler mints.
A chain covers the row's entire resident prefix, shared blocks included:
the shared head normally re-matches in the radix cache at swap-in, but a
cached chain is evictable once its pins drop, so the spill copy is what
makes preempt-then-resume bitwise whatever survived in the cache.

``max_blocks`` caps host residency (``--swap-store-blocks``): the victim
policy checks ``can_hold`` before preempting, so a full store stops
preemption and never drops a chain.

Host copies live in **pinned** CPU tensors, filled by ``non_blocking``
device-to-host copies on the current stream; one ``torch.cuda.Event`` is
recorded after a chain's copies. ``put`` waits on that event at once.
``put_async`` (the pipelined scheduler) keeps the chain *staged* with its
event, and ``finalize`` (the next harvest) waits on the event, never on
the whole device. The pinned buffers stay referenced by the chain; the
device tensors the copies read need no reference, since any later writer
of their memory runs after the copies in stream order. ``get`` / ``pop`` finalize on demand, and every accounting view
(``blocks``, ``nbytes``, ``keys``, ``can_hold``) counts staged chains as
landed ones: the byte count comes from tensor metadata. On the CPU the
copies are plain clones and there is no event.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _to_host(tree):
    """Enqueue copies of a device tree into pinned host tensors and record
    one event after them. Returns (host tree, event or None); a CPU tree is
    cloned."""
    leaves = tree_leaves(tree)
    if not leaves or not leaves[0].is_cuda:
        return tree_map(torch.clone, tree), None

    def pinned(t):
        # one dense device-to-host copy: a trimmed leaf is a strided view
        t = t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    host = tree_map(pinned, tree)
    done = torch.cuda.Event()
    done.record()
    return host, done


@dataclasses.dataclass
class SpilledChain:
    """One preempted row's host-resident state.

    ``data`` mirrors ``cache["dec"]`` with attention leaves
    (R, n_blocks, BS, …): entry ``i`` along the block axis is logical
    block ``i`` of the row. ``length``/``pos``/``cur`` are the host values
    a resume needs to re-seed the slot bit-exactly. A staged chain
    (``put_async``) also holds its copies' ``done`` event until
    ``finalize``."""
    data: list
    n_blocks: int
    length: int
    pos: int
    cur: int
    nbytes: int
    done: object = None

    def slice_blocks(self, start: int, stop: int, pad_to: int):
        """Leaves (R, pad_to, BS, …) holding logical blocks [start, stop),
        zero-padded past the real ones (the restore operand's one shape);
        pinned when the chain is."""
        if not (0 <= start <= stop <= self.n_blocks):
            raise ValueError(
                f"restore range [{start}, {stop}) outside the spilled "
                f"chain's {self.n_blocks} blocks")
        if stop - start > pad_to:
            raise ValueError(
                f"restore of {stop - start} blocks exceeds the "
                f"{pad_to}-block operand")

        def pad(leaf):
            shape = (leaf.shape[0], pad_to) + tuple(leaf.shape[2:])
            out = torch.zeros(shape, dtype=leaf.dtype,
                              pin_memory=leaf.is_pinned())
            out[:, :stop - start] = leaf[:, start:stop]
            return out
        return tree_map(pad, self.data)


class SpillStore:
    """Keyed store of spilled chains with byte/block accounting."""

    def __init__(self, max_blocks: int | None = None):
        if max_blocks is not None and max_blocks < 1:
            raise ValueError("swap store cap must be >= 1 block")
        self.max_blocks = max_blocks
        self._chains: dict[object, SpilledChain] = {}
        # chains staged by put_async whose device-to-host copies have not
        # been waited on yet
        self._staged: dict[object, SpilledChain] = {}
        self.peak_blocks = 0
        self.peak_bytes = 0
        self.total_spilled_blocks = 0
        self.total_restored_blocks = 0

    def __len__(self) -> int:
        return len(self._chains) + len(self._staged)

    def __contains__(self, key) -> bool:
        return key in self._chains or key in self._staged

    def keys(self):
        """Keys of every held chain, staged ones included."""
        return list(self._chains.keys()) + list(self._staged.keys())

    @property
    def blocks(self) -> int:
        return (sum(c.n_blocks for c in self._chains.values())
                + sum(c.n_blocks for c in self._staged.values()))

    @property
    def nbytes(self) -> int:
        return (sum(c.nbytes for c in self._chains.values())
                + sum(c.nbytes for c in self._staged.values()))

    def snapshot(self) -> dict:
        """Gauge view for the metrics registry (``spill_*``)."""
        return {"spill_peak_blocks": self.peak_blocks,
                "spill_peak_bytes": self.peak_bytes,
                "spill_held_blocks": self.blocks,
                "spill_held_bytes": self.nbytes,
                "spill_total_spilled_blocks": self.total_spilled_blocks,
                "spill_total_restored_blocks": self.total_restored_blocks}

    def can_hold(self, n_blocks: int) -> bool:
        """Victim-policy gate: would a chain of ``n_blocks`` fit?"""
        if self.max_blocks is None:
            return True
        return self.blocks + n_blocks <= self.max_blocks

    def _stage(self, key, data, n_blocks: int, length: int, pos: int,
               cur: int) -> SpilledChain:
        if key in self:
            raise ValueError(f"spill key {key!r} already stored")
        if not self.can_hold(n_blocks):
            raise ValueError(
                f"spilling {n_blocks} blocks would exceed the swap "
                f"store cap ({self.blocks}/{self.max_blocks} held)")
        dev = tree_map(lambda leaf: leaf[:, :n_blocks], data)
        host, done = _to_host(dev)
        self.total_spilled_blocks += n_blocks
        return SpilledChain(data=host, n_blocks=n_blocks, length=length,
                            pos=pos, cur=cur, nbytes=_tree_nbytes(host),
                            done=done)

    def _account(self) -> None:
        self.peak_blocks = max(self.peak_blocks, self.blocks)
        self.peak_bytes = max(self.peak_bytes, self.nbytes)

    def put(self, key, data, n_blocks: int, *, length: int, pos: int,
            cur: int) -> SpilledChain:
        """Store one spilled chain. ``data`` is the tree from
        ``spill_pool_blocks``; its block axis is trimmed to the ``n_blocks``
        real entries, copied to the host, and the copies waited on."""
        chain = self._stage(key, data, n_blocks, length, pos, cur)
        self._chains[key] = chain
        self._land(chain)
        self._account()
        return chain

    def put_async(self, key, data, n_blocks: int, *, length: int, pos: int,
                  cur: int) -> SpilledChain:
        """Stage one spilled chain without waiting for its device-to-host
        copies; ``finalize`` (or a ``get``/``pop`` that needs the bytes
        sooner) waits on their event."""
        chain = self._stage(key, data, n_blocks, length, pos, cur)
        self._staged[key] = chain
        self._account()
        return chain

    @staticmethod
    def _land(chain: SpilledChain) -> None:
        if chain.done is not None:
            chain.done.synchronize()
        chain.done = None

    def finalize(self, key=None) -> int:
        """Land staged chains (one, or all when ``key`` is None). Returns
        the number landed; an already-landed or absent key is a no-op."""
        keys = ([key] if key is not None and key in self._staged
                else list(self._staged) if key is None else [])
        for k in keys:
            chain = self._staged.pop(k)
            self._land(chain)
            self._chains[k] = chain
        return len(keys)

    def get(self, key) -> SpilledChain:
        self.finalize(key)
        return self._chains[key]

    def pop(self, key) -> SpilledChain:
        """Remove a chain after a successful restore (or abandonment)."""
        self.finalize(key)
        chain = self._chains.pop(key)
        self.total_restored_blocks += chain.n_blocks
        return chain

    def clear(self) -> None:
        for chain in self._staged.values():
            self._land(chain)
        self._chains.clear()
        self._staged.clear()
