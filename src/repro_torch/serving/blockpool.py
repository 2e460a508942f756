"""Host-side block allocator for the paged KV cache.

The device pool is a fixed array of ``num_blocks`` token blocks (block 0 is
reserved as the *trash* block — every unmapped block-table entry points at
it, so masked rows and padded chunk slots scatter their garbage there
instead of into another request's memory). The allocator hands out the
remaining blocks and enforces a **reservation discipline**: a request is
admitted only when its worst-case block need (prompt + max_new + γ + 1,
rounded up to blocks) fits in the unreserved pool, but physical blocks are
allocated lazily as the sequence actually grows into them. Reservations
guarantee an admitted request can always run to completion (no mid-flight
OOM / deadlock); lazy allocation keeps the measured high-water mark honest.

Prefix sharing (``serving.prefixcache``) adds three block states on top of
the free/live split:

* **shared** — a live block pinned by more than one owner, or by an owner
  other than the one whose reservation produced it. ``share`` pins a block
  for an owner without charging its reservation (the block already exists;
  aliasing it into another block table consumes no new pool capacity).
  Every block carries a reference count; a block is returned to the pool
  only when its count reaches zero.
* **parked** — refcount-0 blocks whose contents the prefix cache wants to
  keep (``mark_cacheable``). They hold no reservation and are *evictable*:
  when an allocation finds the free list empty, the cache's ``evictor``
  callback surrenders one (LRU leaf order is the cache's policy, not the
  allocator's).
* **copy-on-write** — ``cow(owner, src)`` hands ``owner`` a fresh block
  from its own reservation to receive a device-side copy of ``src``; the
  shared source is never written.

The admission gate becomes ``reserved_total + uncharged + pins + n <=
capacity``: *uncharged* counts live blocks no reservation covers (their
charging owner released while sharers remain). Parked blocks never appear
in the gate — they are reclaimable on demand — which is exactly what lets
the reservation discipline charge only a request's **unshared** blocks.

Preemption (``serving.swapstore`` + the scheduler's victim policy) adds a
fourth lifecycle verb pair on top of reserve/alloc/share/release:

* **swap_out(owner, key, logical)** — the owner's physical blocks leave
  the pool exactly as ``release`` would surrender them (shared blocks
  drop a pin and stay live for their other holders or park for the
  prefix cache; private cacheable blocks park; the rest free) and its
  reservation is dropped, but the *logical* chain is recorded under
  ``key`` as SWAPPED: the row still exists, its KV bytes live host-side
  in a ``SpillStore``, and it holds **zero** gate capacity — that is the
  oversubscription: more admitted rows than the pool can hold resident.
* **swap_in(key, owner, n)** — the swapped row returns: its key leaves
  the SWAPPED set and a fresh reservation is taken for ``owner`` (the
  slot it resumes in), gated like any admission. The caller then
  re-aliases whatever prefix blocks the radix cache still holds and
  restores the spilled private tail into newly allocated blocks.

``key`` is a per-preemption token, NOT the slot: slots are recycled by
other requests while a victim is swapped out, so the SWAPPED identity
must outlive slot reuse. Invariant: a swapped key holds no reservation,
no charged blocks and no pins — its entire footprint is host-side.
"""
from __future__ import annotations

TRASH_BLOCK = 0


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size blocks.

    Invariants (property-tested in ``tests/test_kvcache.py``):
      * a block is never handed out twice while live
      * ``len(free) + parked + live == num_blocks - 1`` (trash excluded)
      * every live block has refcount >= 1; no block is ever freed (or
        parked) while its refcount is > 0
      * ``charged(owner) <= reserved(owner)`` for every owner
      * ``reserved_total + uncharged <= capacity`` (every admitted owner
        can always grow to its reservation without deadlock)
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is the trash block)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._refs: dict[int, int] = {}          # live block -> refcount
        self._charged: dict[int, object] = {}    # live block -> owner
        self._reserved: dict[object, int] = {}   # owner -> blocks reserved
        self._owned: dict[object, list[int]] = {}   # charged blocks
        self._shared: dict[object, list[int]] = {}  # pinned, not charged
        self._parked: dict[int, None] = {}       # refcount-0 cached blocks
        self._cacheable: set[int] = set()        # park (not free) on ref->0
        self._swapped: dict[object, int] = {}    # swap key -> logical blocks
        # set by the prefix cache: () -> None, must move >=1 parked block
        # to the free list (drop_cached) or raise
        self.evictor = None
        self.on_park = None                      # blk -> None (cache hook)
        self.on_unpark = None                    # blk -> None (re-pinned)
        self.high_water = 0

    # -- capacity ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (pool minus the trash block)."""
        return self.num_blocks - 1

    @property
    def reserved_total(self) -> int:
        return sum(self._reserved.values())

    @property
    def allocated_total(self) -> int:
        """Live (refcount >= 1) blocks."""
        return len(self._refs)

    @property
    def parked_total(self) -> int:
        """Refcount-0 blocks held by the prefix cache (evictable)."""
        return len(self._parked)

    @property
    def uncharged_total(self) -> int:
        """Live blocks not covered by any reservation (shared survivors)."""
        return len(self._refs) - len(self._charged)

    def can_reserve(self, n: int, extra_pins: int = 0) -> bool:
        """Admission gate. ``extra_pins`` counts currently-parked blocks the
        admission will pin (``share``): pinning removes them from the
        evictable set, so they consume gate capacity exactly like the new
        reservation does."""
        return (self.reserved_total + self.uncharged_total + extra_pins + n
                <= self.capacity)

    @property
    def swapped_total(self) -> int:
        """Swapped-out rows (keys) whose chains live host-side."""
        return len(self._swapped)

    @property
    def swapped_blocks_total(self) -> int:
        """Logical blocks of all swapped rows — the oversubscription depth
        (these tokens are admitted but hold zero pool capacity)."""
        return sum(self._swapped.values())

    def occupancy(self) -> dict:
        """Point-in-time occupancy gauges (host ints, one dict scan) —
        the telemetry counter-track sample: how the pool's capacity is
        split across live, parked, reserved and swapped-out state."""
        return {"capacity": self.capacity,
                "allocated": self.allocated_total,
                "reserved": self.reserved_total,
                "parked": self.parked_total,
                "uncharged": self.uncharged_total,
                "swapped_blocks": self.swapped_blocks_total,
                "high_water": self.high_water}

    def refcount(self, blk: int) -> int:
        return self._refs.get(blk, 0)

    def is_parked(self, blk: int) -> bool:
        return blk in self._parked

    # -- lifecycle ---------------------------------------------------------

    def reserve(self, owner, n: int) -> None:
        """Claim worst-case capacity for ``owner`` (admission gate)."""
        if owner in self._reserved:
            raise ValueError(f"{owner!r} already holds a reservation")
        if not self.can_reserve(n):
            raise ValueError(
                f"reservation of {n} blocks exceeds capacity "
                f"({self.reserved_total}/{self.capacity} reserved, "
                f"{self.uncharged_total} uncharged shared)")
        self._reserved[owner] = n
        self._owned[owner] = []
        self._shared[owner] = []

    def alloc(self, owner) -> int:
        """Hand ``owner`` one physical block from its reservation."""
        owned = self._owned[owner]
        if len(owned) >= self._reserved[owner]:
            raise ValueError(f"{owner!r} exceeded its reservation of "
                             f"{self._reserved[owner]} blocks")
        if not self._free:
            # reservations guarantee free + parked covers every in-bound
            # alloc; ask the prefix cache to surrender a parked block
            if self._parked and self.evictor is not None:
                self.evictor()
            if not self._free:
                raise ValueError("pool exhausted (no free or evictable "
                                 "blocks) — reservation discipline broken")
        blk = self._free.pop()
        self._refs[blk] = 1
        self._charged[blk] = owner
        owned.append(blk)
        self.high_water = max(self.high_water,
                              len(self._refs) + len(self._parked))
        return blk

    def share(self, owner, blk: int) -> None:
        """Pin ``blk`` for ``owner`` without charging its reservation.

        The block must be live (another owner's) or parked (a cached
        prefix block). Unparking consumes gate capacity — guarded here so
        a caller that skipped ``can_reserve(..., extra_pins=...)`` fails
        loudly instead of silently overcommitting the pool."""
        if blk in self._parked:
            if (self.reserved_total + self.uncharged_total + 1
                    > self.capacity):
                raise ValueError("pinning a cached block would overcommit "
                                 "the pool (admission gate skipped?)")
            del self._parked[blk]
            self._refs[blk] = 1
            if self.on_unpark is not None:
                self.on_unpark(blk)
        elif blk in self._refs:
            self._refs[blk] += 1
        else:
            raise ValueError(f"block {blk} is neither live nor cached")
        self._shared[owner].append(blk)

    def cow(self, owner, src: int) -> int:
        """Copy-on-write: a fresh block from ``owner``'s reservation, to
        receive a device-side copy of ``src``. ``src`` (live or parked) is
        never written — the caller copies then diverges in the new block."""
        if src not in self._refs and src not in self._parked:
            raise ValueError(f"CoW source {src} is neither live nor cached")
        return self.alloc(owner)

    def blocks_of(self, owner) -> list[int]:
        return self._owned[owner]

    def release(self, owner) -> list[int]:
        """Unpin every block of ``owner`` and drop its reservation.

        Charged blocks lose their reservation backing (sharers keep them
        live as *uncharged* blocks); any block whose refcount reaches zero
        is parked (if the prefix cache marked it cacheable) or freed.
        Returns the blocks whose refcount actually reached zero.

        Order matters for the prefix cache: blocks are unpinned deepest
        first (charged tail blocks, newest first, then the shared prefix
        chain, deepest first), so trie refcounts stay monotone
        non-increasing with depth at every intermediate state and the
        ``on_park`` cap hook always finds an evictable *leaf*."""
        dropped = []
        for blk in reversed(self._owned.pop(owner)):
            del self._charged[blk]
            if self._decref(blk):
                dropped.append(blk)
        for blk in reversed(self._shared.pop(owner)):
            if self._decref(blk):
                dropped.append(blk)
        del self._reserved[owner]
        return dropped

    def swap_out(self, owner, key, logical_blocks: int) -> list[int]:
        """Preempt ``owner``: surrender its physical blocks and
        reservation exactly like ``release``, but record ``key`` as
        SWAPPED holding ``logical_blocks`` logical blocks host-side.

        The caller must have spilled the owner's private block contents
        BEFORE this call — freed blocks are immediately reallocatable.
        Returns the blocks whose refcount reached zero (the ones whose
        device bytes are now unreachable except via the spill copy)."""
        if key in self._swapped:
            raise ValueError(f"swap key {key!r} is already swapped out")
        if logical_blocks < 0:
            raise ValueError("logical_blocks must be >= 0")
        dropped = self.release(owner)
        self._swapped[key] = logical_blocks
        return dropped

    def swap_in(self, key, owner, n: int) -> None:
        """Re-admit a swapped row: drop ``key`` from the SWAPPED set and
        take a fresh reservation of ``n`` blocks for ``owner`` (the slot
        the row resumes in), through the ordinary admission gate."""
        if key not in self._swapped:
            raise ValueError(f"swap key {key!r} is not swapped out")
        self.reserve(owner, n)
        del self._swapped[key]

    def is_swapped(self, key) -> bool:
        return key in self._swapped

    def swapped_keys(self) -> list:
        return list(self._swapped)

    def drop_swapped(self, key) -> None:
        """A swapped row retired without resuming (e.g. scheduler reset):
        forget its key."""
        if key not in self._swapped:
            raise ValueError(f"swap key {key!r} is not swapped out")
        del self._swapped[key]

    def _decref(self, blk: int) -> bool:
        self._refs[blk] -= 1
        if self._refs[blk] > 0:
            return False
        del self._refs[blk]
        if blk in self._cacheable:
            self._parked[blk] = None
            if self.on_park is not None:
                self.on_park(blk)
        else:
            self._free.append(blk)
        return True

    # -- prefix-cache hooks ------------------------------------------------

    def mark_cacheable(self, blk: int) -> None:
        """On refcount->0, park ``blk`` (contents stay valid, evictable)
        instead of freeing it."""
        if blk not in self._refs and blk not in self._parked:
            raise ValueError(f"block {blk} is not live")
        self._cacheable.add(blk)

    def drop_cached(self, blk: int) -> None:
        """The cache no longer indexes ``blk``: free it if parked, else
        just clear the flag (sharers still hold it; it frees on ref->0)."""
        self._cacheable.discard(blk)
        if blk in self._parked:
            del self._parked[blk]
            self._free.append(blk)

    # -- introspection -----------------------------------------------------

    def check_invariants(self) -> None:
        free = set(self._free)
        live = set(self._refs)
        parked = set(self._parked)
        assert len(free) == len(self._free), "duplicate block in free list"
        assert not (free & live), "block both free and live"
        assert not (free & parked), "block both free and parked"
        assert not (live & parked), "block both live and parked"
        assert len(free) + len(live) + len(parked) == self.capacity, \
            "free-list conservation violated"
        assert all(c >= 1 for c in self._refs.values())
        assert parked <= self._cacheable, "parked block not cacheable"
        owned_all: list[int] = []
        for owner, owned in self._owned.items():
            assert len(owned) <= self._reserved[owner]
            assert all(self._charged[b] is owner for b in owned)
            owned_all.extend(owned)
        assert len(owned_all) == len(set(owned_all)) == len(self._charged)
        for owner, shared in self._shared.items():
            for b in shared:
                assert self._refs[b] >= 1, "shared block not live"
        assert self.reserved_total + self.uncharged_total <= self.capacity, \
            "reservation guarantee violated (pool can deadlock)"
        assert TRASH_BLOCK not in live and TRASH_BLOCK not in free \
            and TRASH_BLOCK not in parked
        # SWAPPED rows hold zero pool capacity: their keys are disjoint
        # from every owner that reserves/charges/pins
        for key in self._swapped:
            assert key not in self._reserved, \
                "swapped key holds a reservation"
            assert key not in self._owned and key not in self._shared, \
                "swapped key still holds blocks"
        assert all(n >= 0 for n in self._swapped.values())


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)
