"""Radix prefix cache: shared prompt prefixes -> ref-counted pool blocks
(port of ``serving/prefixcache.py``: pure Python over ``BlockAllocator``,
so a close copy).

Hot prompt headers (system prompts, few-shot preambles, chain-of-thought
templates) are identical across requests; without an index the paged
scheduler re-prefills and re-stores them per request, wasting prefill
cycles and KV pool blocks. This module is the host-side index that turns
the block tables' indirection into *sharing*:

* The trie is keyed on **block-aligned token-id runs**: each node is one
  full block (``block_size`` committed prompt tokens) mapping to one
  physical block in the pool — plain bf16 or Cassandra-packed, the index
  never looks at the stored bytes. Matching walks whole blocks, so a
  matched block is *fully* shared and read-only by construction (a new
  request's first write lands at its seeded length, which is past every
  matched block).
* ``match`` returns the longest cached chain for a prompt, capped at
  ``len(prompt) - 1``: the final prompt token is never matched because its
  logits (the first generated token) must still be computed. It also
  reports the best **partial** child — a cached block whose first tokens
  extend the match but diverge mid-block. The scheduler copies that block
  device-side into a fresh block from the request's own reservation
  (copy-on-write) and overwrites from the divergence point; the shared
  source is never written.
* Lifetimes are reference counts in ``BlockAllocator``: admission pins the
  matched chain (``share``), retirement unpins, and a chain nobody holds
  is *parked* — resident but evictable. Eviction is **LRU over parked
  leaves**: pins always cover whole root-to-node chains, so refcounts are
  monotone non-increasing with depth and the parked set is a union of
  subtrees — evicting leaves first never strands a reachable node.
* Every pinned chain is charged to nobody once its inserting request
  retires, so the admission gate (``BlockAllocator.can_reserve``) charges
  a new request only for its **unshared** blocks plus the parked blocks
  it re-pins.

``SchedulerPrefixStats`` live in ``scheduler.Scheduler.stats``:
``prefix_queries/hits/matched_tokens``, ``prefix_blocks_aliased`` (pool
blocks a request mapped without allocating) and ``cow_copies``.

Interplay with preemption (``scheduler`` ``swap=True``): a swapped-out
victim's indexed blocks park through the ordinary ``release`` path — they
stay matchable, so the victim's *resume* re-aliases its shared prefix
instead of restoring it from the host spill copy. Blocks pinned by OTHER
live rows are never spill victims: ``swap_out`` only drops the victim's
own pins, and a block frees (or parks) strictly on refcount zero — the
same monotone-refcount discipline eviction relies on. The index also
**persists across** ``Scheduler.reset()``: parked chains (and their
device bytes, which the free list never saw) survive into the next run's
matches.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.blockpool import BlockAllocator


@dataclasses.dataclass
class PrefixNode:
    """One cached block: ``key`` is its block's token run (length ==
    block_size), ``block`` the physical pool block holding those tokens'
    KV. Children are keyed by their own token runs."""
    key: tuple[int, ...]
    block: int
    parent: "PrefixNode | None"
    children: dict[tuple[int, ...], "PrefixNode"] = \
        dataclasses.field(default_factory=dict)
    last_use: int = 0
    detached: bool = False      # evicted from the trie (stale resume hint)

    @property
    def depth(self) -> int:
        d, n = 0, self
        while n.parent is not None:
            d, n = d + 1, n.parent
        return d


@dataclasses.dataclass
class PrefixMatch:
    """Longest cached prefix for one prompt."""
    nodes: list[PrefixNode]            # fully-matched chain, root-first
    partial: PrefixNode | None         # best mid-block divergence, if any
    partial_len: int                   # matched tokens inside ``partial``

    @property
    def full_tokens(self) -> int:
        return sum(len(n.key) for n in self.nodes)

    @property
    def tokens(self) -> int:
        return self.full_tokens + self.partial_len


class PrefixCache:
    """Host-side radix index over the block pool.

    Wires itself into the allocator: ``evictor`` surrenders the LRU parked
    leaf when an allocation finds the free list empty, and ``on_park``
    enforces ``max_blocks`` (the ``--prefix-cache-blocks`` knob) the
    moment a retiring request parks more blocks than the cache may hold.
    """

    def __init__(self, alloc: BlockAllocator, block_size: int,
                 max_blocks: int | None = None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if max_blocks is not None and not (
                0 <= max_blocks <= alloc.capacity):
            raise ValueError(
                f"prefix cache cap {max_blocks} outside the pool's "
                f"{alloc.capacity} allocatable blocks")
        self.alloc = alloc
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.root = PrefixNode(key=(), block=-1, parent=None)
        self.by_block: dict[int, PrefixNode] = {}
        # parked *leaves* only — the eviction candidate set, maintained
        # incrementally so evict_lru scans candidates, not the whole
        # index (insert never hangs children under parked nodes, so a
        # parked node can only stop being a leaf by being evicted)
        self._parked_leaves: dict[int, PrefixNode] = {}
        self._tick = 0
        alloc.evictor = self.evict_lru
        alloc.on_park = self._on_park
        alloc.on_unpark = lambda blk: self._parked_leaves.pop(blk, None)

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.by_block)

    def snapshot(self) -> dict:
        """Gauge view for the metrics registry: indexed blocks and how
        many of them are parked (resident but evictable) right now."""
        return {"prefix_cached_blocks": len(self),
                "prefix_parked_blocks": self.alloc.parked_total}

    def _touch(self, node: PrefixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def match(self, tokens) -> PrefixMatch:
        """Longest block-aligned cached chain for ``tokens[:-1]`` plus the
        best partial (copy-on-write) extension. Never matches the final
        prompt token — its logits must be computed by prefill."""
        bs = self.block_size
        limit = len(tokens) - 1
        node, chain, i = self.root, [], 0
        while i + bs <= limit:
            child = node.children.get(tuple(int(t) for t in
                                            tokens[i:i + bs]))
            if child is None:
                break
            chain.append(child)
            node, i = child, i + bs
        partial, plen = None, 0
        nxt = tuple(int(t) for t in tokens[i:min(i + bs, limit)])
        if nxt:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(key, nxt):
                    if a != b:
                        break
                    n += 1
                if n > plen:
                    partial, plen = child, n
        for n in chain:
            self._touch(n)
        if partial is not None:
            self._touch(partial)
        return PrefixMatch(nodes=chain, partial=partial, partial_len=plen)

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens, blocks: list[int], upto: int,
               node: PrefixNode | None = None, start: int = 0
               ) -> tuple[PrefixNode, int]:
        """Index the first ``upto`` committed prompt tokens of a request.

        ``blocks`` is the request's logical->physical block list; every
        full block of ``tokens[:upto]`` becomes a trie node. Newly
        indexed blocks are marked cacheable so retirement parks them
        instead of freeing. If the walk meets a node holding the same
        run under a DIFFERENT physical block (another request prefilled
        the identical run concurrently), insertion stops there: the
        caller's copies stay private, never indexed. Hanging our live
        nodes under a chain this request does not pin would let an
        ancestor park (its owner retiring) while our descendant is
        live — breaking the monotone-refcount property leaf-first
        eviction relies on. Stopping keeps the invariant structural:
        every indexed node's root chain is pinned by its inserter
        (created or admission-matched blocks only).

        ``node``/``start`` resume the walk from a previous insert's
        return (the scheduler indexes incrementally as prefill chunks
        commit; without the watermark every chunk would re-walk the
        whole committed prefix — quadratic in prompt length). A stale
        hint (the node was evicted since — possible only for deduped
        chains owned by another, since-retired request; leaf-only
        eviction makes the flag sufficient) restarts from the root.
        Returns (deepest node walked, nodes inserted)."""
        bs = self.block_size
        if node is None or node.detached:
            node, start = self.root, 0
        added = 0
        for j in range(start, upto // bs):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                blk = blocks[j]
                child = PrefixNode(key=key, block=blk, parent=node)
                node.children[key] = child
                self.by_block[blk] = child
                self.alloc.mark_cacheable(blk)
                added += 1
            elif child.block != blocks[j]:
                break           # someone else's identical run: stop (see
                                # docstring) — our copies stay private
            self._touch(child)
            node = child
        return node, added

    # -- eviction ----------------------------------------------------------

    def _drop(self, node: PrefixNode) -> None:
        assert not node.children, "evicting a non-leaf prefix node"
        del node.parent.children[node.key]
        del self.by_block[node.block]
        self._parked_leaves.pop(node.block, None)
        node.detached = True
        parent = node.parent
        if parent is not self.root and not parent.children \
                and self.alloc.is_parked(parent.block):
            self._parked_leaves[parent.block] = parent
        self.alloc.drop_cached(node.block)

    def evict_lru(self) -> int:
        """Surrender the least-recently-used parked leaf to the free list
        (the allocator's ``evictor`` hook). Pins cover whole chains, so
        parked nodes always include their subtree's leaves — eviction can
        always make progress while anything is parked."""
        if not self._parked_leaves:
            raise ValueError("no evictable cached block (all pinned)")
        victim = min(self._parked_leaves.values(),
                     key=lambda n: n.last_use)
        self._drop(victim)
        return victim.block

    def _on_park(self, blk: int) -> None:
        node = self.by_block[blk]
        if not node.children:
            self._parked_leaves[blk] = node
        if self.max_blocks is None:
            return
        while self.alloc.parked_total > self.max_blocks:
            self.evict_lru()

    def check_invariants(self) -> None:
        """Structural sanity, asserted by the property tests."""
        seen: set[int] = set()
        stack = [self.root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                assert child.key == key and child.parent is node
                assert len(child.key) == self.block_size
                assert self.by_block.get(child.block) is child
                assert (self.alloc.refcount(child.block) >= 1
                        or self.alloc.is_parked(child.block)), \
                    "indexed block neither live nor parked"
                # pins cover root-first chains: a live child implies a
                # live parent (monotone refcounts; eviction relies on it)
                if node is not self.root and \
                        self.alloc.refcount(child.block) >= 1:
                    assert self.alloc.refcount(node.block) >= 1
                seen.add(child.block)
                stack.append(child)
        assert seen == set(self.by_block)
        want_leaves = {blk for blk, n in self.by_block.items()
                       if not n.children and self.alloc.is_parked(blk)}
        assert want_leaves == set(self._parked_leaves), \
            "parked-leaf registry out of sync"
        if self.max_blocks is not None:
            assert self.alloc.parked_total <= self.max_blocks
