"""Port vs reference: the prefix cache (radix index with copy-on-write),
preemption with host swap, and the paged pool's block moves under them,
at SMOKE width on the CPU (the kernels' plain versions).

Host-side state is held exactly: the radix index, the allocator and the
spill store leave the same snapshots as the reference's after every step
of the same seeded traces. The pool's block copy, spill and restore are
held bit for bit against the reference's on pools that come from the
reference through the bridge (bf16, Cassandra-1 and -2 packed, MLA's c /
kr), with one deliberate difference: the port never writes a new value
into the trash block (block 0), where the reference's restore scatters
its padding. Inside the port the scheduler gives the same tokens bit for
bit with the prefix cache on and off, with swap on a tight pool and on a
pool that never preempts, and with the overlap pipeline on and off.
Against the reference's scheduler the tokens are held under the near-tie
rule (``torch_ar.tau_prefix``) and the prefix hits and matched tokens
exactly.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ar as AR
import torch_parity as TP
from repro.configs import get_config as jax_get_config
from repro.core import packing as jpack
from repro.core.format import CassandraConfig as JCass
from repro.models import model as JM
from repro.serving import engine as JE, kvcache as JKC, scheduler as JS
from repro.serving.blockpool import BlockAllocator as JAlloc
from repro.serving.prefixcache import PrefixCache as JPrefix
from repro.serving.swapstore import SpillStore as JSpill
from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.launch import serve
from repro_torch.serving import engine as E, kvcache as KC, scheduler as S
from repro_torch.serving.blockpool import BlockAllocator, TRASH_BLOCK
from repro_torch.serving.prefixcache import PrefixCache
from repro_torch.serving.swapstore import SpillStore

GAMMA, MAX_NEW, PROMPT, HEADER = 3, 6, 12, 6
KW = dict(num_slots=3, s_max=PROMPT + MAX_NEW + GAMMA + 1, block_size=4,
          chunk_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The allocator with disjoint swap keys: a seeded property test
# ---------------------------------------------------------------------------

def _alloc_state(pool) -> tuple:
    return (pool.occupancy(), pool.reserved_total, pool.uncharged_total,
            pool.allocated_total, pool.parked_total, pool.high_water,
            pool.swapped_total, pool.swapped_blocks_total,
            sorted(pool.swapped_keys()))


@pytest.mark.parametrize("seed", range(8))
def test_swap_trace_with_disjoint_keys(seed):
    """Admit / grow / share / cache / retire / swap traffic on the port's
    and the reference's allocators, swap keys minted as ``("swap", n)``
    as the schedulers mint them (never equal to an owner): every call
    returns the same, the invariants hold and the states are equal after
    each step; a swapped key holds no gate capacity, double swap-out and
    unknown swap-in raise in both."""
    rng = np.random.default_rng(seed + 300)
    num_blocks = int(rng.integers(3, 25))
    pools = (BlockAllocator(num_blocks), JAlloc(num_blocks))
    for p in pools:
        p.evictor = (lambda p=p: p.drop_cached(next(iter(p._parked))))
    live, reserved, swapped = [], {}, {}
    next_owner = next_key = 0
    kinds = ["admit", "grow", "share", "cache", "retire", "swap_out",
             "swap_in"]
    for _ in range(80):
        kind = kinds[rng.integers(len(kinds))]
        v, w = int(rng.integers(8)), int(rng.integers(8))
        if kind == "admit":
            need = v % 4 + 1
            fits = {p.can_reserve(need) for p in pools}
            assert len(fits) == 1
            if fits.pop():
                for p in pools:
                    p.reserve(next_owner, need)
                reserved[next_owner] = need
                live.append(next_owner)
                next_owner += 1
        elif kind == "grow" and live:
            owner = live[v % len(live)]
            if len(pools[0].blocks_of(owner)) < reserved[owner]:
                got = {p.alloc(owner) for p in pools}
                assert len(got) == 1 and TRASH_BLOCK not in got
        elif kind == "share" and live:
            owner = live[v % len(live)]
            cands = sorted(pools[0]._refs)
            assert cands == sorted(pools[1]._refs)
            if cands:
                for p in pools:
                    p.share(owner, cands[w % len(cands)])
        elif kind == "cache" and pools[0]._refs:
            cands = sorted(pools[0]._refs)
            for p in pools:
                p.mark_cacheable(cands[v % len(cands)])
        elif kind == "retire" and live:
            owner = live.pop(v % len(live))
            assert pools[0].release(owner) == pools[1].release(owner)
            del reserved[owner]
        elif kind == "swap_out" and live:
            owner = live.pop(v % len(live))
            key = ("swap", next_key)
            held = len(pools[0].blocks_of(owner)) + len(
                pools[0]._shared[owner])
            gate = [p.reserved_total + p.uncharged_total for p in pools]
            dropped = [p.swap_out(owner, key, held) for p in pools]
            assert dropped[0] == dropped[1]
            for p, g in zip(pools, gate):
                assert p.is_swapped(key)
                assert p.reserved_total + p.uncharged_total <= g
                with pytest.raises(ValueError):
                    p.swap_out(owner, key, 0)       # double swap / gone
            swapped[key] = held
            del reserved[owner]
            next_key += 1
        elif kind == "swap_in" and swapped:
            keys = sorted(swapped)
            key = keys[v % len(keys)]
            need = w % 4 + 1
            if pools[0].can_reserve(need):
                for p in pools:
                    p.swap_in(key, next_owner, need)
                    assert not p.is_swapped(key)
                del swapped[key]
                reserved[next_owner] = need
                live.append(next_owner)
                next_owner += 1
        for p in pools:
            p.check_invariants()
            assert p.swapped_total == len(swapped)
            assert p.swapped_blocks_total == sum(swapped.values())
        assert _alloc_state(pools[0]) == _alloc_state(pools[1])
    for p in pools:
        with pytest.raises(ValueError):
            p.swap_in(("swap", -1), "nobody", 1)    # unknown key
        for key in list(swapped):
            p.drop_swapped(key)
        for owner in live:
            p.release(owner)
        p.check_invariants()
        assert p.swapped_total == p.allocated_total == p.reserved_total == 0


# ---------------------------------------------------------------------------
# The radix prefix index against the reference's
# ---------------------------------------------------------------------------

def _trie(cache) -> list:
    out, stack = [], [(cache.root, ())]
    while stack:
        node, path = stack.pop()
        for key in sorted(node.children):
            child = node.children[key]
            out.append((path + (key,), child.block, child.last_use))
            stack.append((child, path + (key,)))
    return sorted(out)


def _prefix_state(pool, cache) -> tuple:
    return (_trie(cache), sorted(cache.by_block),
            sorted(cache._parked_leaves), cache.snapshot(),
            _alloc_state(pool), sorted(pool._refs.items()))


def _match_view(m) -> tuple:
    return ([n.block for n in m.nodes],
            None if m.partial is None else m.partial.block, m.partial_len)


@pytest.mark.parametrize("seed", range(6))
def test_prefix_cache_traces_match_reference(seed):
    """Seeded traces of the scheduler's uses of the index, the same on
    both packages: admission (``match``, then share / copy-on-write /
    alloc), incremental ``insert`` as prefill chunks commit, retirement
    (``release`` parks indexed blocks), explicit ``evict_lru`` and
    allocation pressure that evicts, with a cap on parked blocks in half
    the seeds. Every returned value and the whole state (trie, parked
    leaves, LRU ticks, allocator) are equal after every step."""
    rng = np.random.default_rng(seed + 400)
    bs, nb = 2, int(rng.integers(8, 24))
    cap = int(rng.integers(1, 5)) if seed % 2 else None
    pools = (BlockAllocator(nb), JAlloc(nb))
    caches = (PrefixCache(pools[0], bs, cap), JPrefix(pools[1], bs, cap))
    heads = [rng.integers(0, 5, 8) for _ in range(3)]
    rows: dict[int, dict] = {}
    next_owner = 0
    for _ in range(60):
        kind = ["admit", "admit", "grow", "retire", "evict"][
            rng.integers(5)]
        if kind == "admit":
            n = int(rng.integers(3, 12))
            cut = int(rng.integers(0, n + 1))
            toks = np.concatenate([heads[rng.integers(3)][:cut],
                                   rng.integers(0, 5, n)])[:n]
            ms = [c.match(toks) for c in caches]
            assert _match_view(ms[0]) == _match_view(ms[1])
            m = ms[0]
            pinned = list(m.nodes) + ([m.partial] if m.partial_len else [])
            pins = sum(pools[0].is_parked(x.block) for x in pinned)
            need = -(-n // bs) - len(m.nodes)
            fits = {p.can_reserve(need, pins) for p in pools}
            assert len(fits) == 1
            if not fits.pop():
                continue
            owner, blocks = next_owner, [[], []]
            next_owner += 1
            for i, (p, mm) in enumerate(zip(pools, ms)):
                p.reserve(owner, need)
                for node in mm.nodes:
                    p.share(owner, node.block)
                    blocks[i].append(node.block)
                if mm.partial is not None and mm.partial_len:
                    p.share(owner, mm.partial.block)
                    blocks[i].append(p.cow(owner, mm.partial.block))
            assert blocks[0] == blocks[1]
            rows[owner] = {"toks": toks, "blocks": blocks,
                           "upto": m.tokens, "hint": [
                               (mm.nodes[-1] if mm.nodes else None,
                                len(mm.nodes)) for mm in ms]}
        elif kind == "grow" and rows:
            owner = sorted(rows)[rng.integers(len(rows))]
            row = rows[owner]
            upto = min(len(row["toks"]), row["upto"] + int(rng.integers(
                1, 5)))
            for i, p in enumerate(pools):
                while len(row["blocks"][i]) * bs < upto:
                    row["blocks"][i].append(p.alloc(owner))
            assert row["blocks"][0] == row["blocks"][1]
            got = []
            for i, c in enumerate(caches):
                node, start = row["hint"][i]
                node, added = c.insert(row["toks"], row["blocks"][i], upto,
                                       node=node, start=start)
                row["hint"][i] = (node, node.depth)
                got.append((node.block, node.depth, added))
            assert got[0] == got[1]
            row["upto"] = upto
        elif kind == "retire" and rows:
            owner = sorted(rows)[rng.integers(len(rows))]
            del rows[owner]
            assert pools[0].release(owner) == pools[1].release(owner)
        elif kind == "evict" and caches[0]._parked_leaves:
            assert caches[0].evict_lru() == caches[1].evict_lru()
        for p, c in zip(pools, caches):
            p.check_invariants()
            c.check_invariants()
        assert _prefix_state(pools[0], caches[0]) == \
            _prefix_state(pools[1], caches[1])


# ---------------------------------------------------------------------------
# The host spill store against the reference's
# ---------------------------------------------------------------------------

def _spill_tree(rng, n_blocks: int) -> list:
    """A spilled-chain-shaped tree: a bf16 store and a packed one."""
    bf = TP.rand_bf16_np(rng, (2, n_blocks, 4, 2, 8))
    words = rng.integers(-2**31, 2**31, (2, n_blocks, 4, 2, 1, 3),
                         dtype=np.int64).astype(np.int32)
    return [{"e0": {"k": bf, "v": {"spec": {"w": words},
                                   "verif": {"w": words[..., :1]}}}}]


def test_spill_store_matches_reference():
    """The same puts (synchronous and staged), gets, pops and refused
    puts on both stores: the same accounting (blocks, bytes, peaks,
    totals, ``can_hold``), the same refusals (over the cap, a duplicate
    key) and chains equal bit for bit, sliced and padded as the restore
    operand."""
    rng = np.random.default_rng(7)
    stores = (SpillStore(max_blocks=7), JSpill(max_blocks=7))
    trees = {k: _spill_tree(rng, n) for k, n in
             (("a", 5), ("b", 4), ("c", 6), ("d", 2))}

    def put(key, n, staged, **kw):
        jt = jax.tree.map(jnp.asarray, trees[key])
        raised = []
        for st, tree in zip(stores, (TP.to_port(trees[key]), jt)):
            fn = st.put_async if staged else st.put
            try:
                fn(("swap", key), tree, n, length=4 * n - 1, pos=3 * n,
                   cur=n, **kw)
                raised.append(None)
            except ValueError:
                raised.append(ValueError)
        assert raised[0] == raised[1]
        return raised[0]

    def state():
        return [(st.blocks, st.nbytes, st.snapshot(), sorted(st.keys()),
                 len(st), [st.can_hold(k) for k in range(9)])
                for st in stores]

    assert put("a", 3, staged=False) is None
    assert put("b", 2, staged=True) is None
    assert state()[0] == state()[1]
    assert put("c", 3, staged=False) is ValueError      # over the cap
    assert put("a", 1, staged=True) is ValueError       # duplicate key
    for key in ("a", "b"):
        chains = [st.get(("swap", key)) for st in stores]
        assert len({(c.n_blocks, c.length, c.pos, c.cur, c.nbytes)
                    for c in chains}) == 1
        TP.assert_bitwise(chains[0].data, chains[1].data)
        TP.assert_bitwise(chains[0].slice_blocks(1, chains[0].n_blocks, 4),
                          chains[1].slice_blocks(1, chains[1].n_blocks, 4))
        for c in chains:
            with pytest.raises(ValueError):
                c.slice_blocks(0, c.n_blocks + 1, 8)    # past the chain
            with pytest.raises(ValueError):
                c.slice_blocks(0, c.n_blocks, 1)        # operand too small
    assert state()[0] == state()[1]
    for st in stores:
        st.pop(("swap", "a"))
    assert put("d", 2, staged=True) is None
    assert stores[0].finalize() == stores[1].finalize() == 1
    for st in stores:
        st.pop(("swap", "b"))
        st.pop(("swap", "d"))
    assert state()[0] == state()[1]
    assert stores[0].snapshot()["spill_total_restored_blocks"] == 7
    with pytest.raises(ValueError):
        SpillStore(max_blocks=0)


# ---------------------------------------------------------------------------
# The pool's block moves against the reference's, bit for bit
# ---------------------------------------------------------------------------

NB_POOL, BS_POOL = 9, 4


def _pool_cfgs(kind: str):
    """(reference config, port config, reference cass, port cass, packed)
    for each store layout the port serves."""
    if kind == "mla":
        arch, widen = "deepseek-v3-671b", dict(n_layers=2,
                                               first_dense_layers=2,
                                               qk_rope_dim=32)
    else:
        arch, widen = "llama3-8b", {}
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **widen)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **widen)
    variant = {"bf16": 0, "c1": 1, "c2": 2, "mla": 1}[kind]
    if not variant:
        return jcfg, cfg, None, None, False
    return (jcfg, cfg, JCass(variant=variant, gamma=GAMMA),
            CassandraConfig(variant=variant, gamma=GAMMA), True)


def _random_like(rng, a: np.ndarray) -> np.ndarray:
    if a.dtype.name == "bfloat16":
        return TP.rand_bf16_np(rng, a.shape)
    info = np.iinfo(a.dtype)
    return rng.integers(info.min, info.max, a.shape, dtype=np.int64,
                        endpoint=True).astype(a.dtype)


def _random_pool(kind: str, seed: int):
    """A reference paged cache with random bits in every store leaf, and
    the same cache in the port through the bridge."""
    jcfg, cfg, jcass, cass, packed = _pool_cfgs(kind)
    rng = np.random.default_rng(seed)
    jc = jax.device_get(JKC.init_paged_cache(jcfg, jcass, 2, NB_POOL,
                                             BS_POOL, 4, packed=packed))
    jc["dec"] = jax.tree.map(lambda a: _random_like(rng, np.asarray(a)),
                             jc["dec"])
    return jc, TP.to_port(jc), rng


def _sorted_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sorted_leaves(t)]
    return [tree]


def _blocks(port_dec, i):
    return [t[:, i].clone() for t in _sorted_leaves(port_dec)]


def _held_to_reference(cache, ref_dec) -> None:
    """Every block but the trash block equal to the reference's."""
    refs = jax.tree.leaves(ref_dec)
    for j in range(1, NB_POOL):
        TP.assert_bitwise([t[:, j] for t in _sorted_leaves(cache["dec"])],
                          [np.asarray(t)[:, j] for t in refs])


def _same(a: list, b: list) -> bool:
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["bf16", "c1", "c2", "mla"])
def test_pool_block_moves_match_reference(kind):
    """``copy_pool_blocks``, ``spill_pool_blocks`` and
    ``restore_pool_blocks`` on the same pool in both packages (every
    leaf: bf16 K/V, Cassandra-1 and -2 spec and verif leaves, MLA's c and
    kr): the port's results equal the reference's bit for bit. A CoW pair
    into the trash block and a restore's padded entries leave block 0 as
    it was in the port (the reference writes into it, so block 0 is held
    to its own old bits instead); other blocks stay untouched."""
    jc, cache, rng = _random_pool(kind, {"bf16": 1, "c1": 2, "c2": 3,
                                         "mla": 4}[kind])
    trash = _blocks(cache["dec"], TRASH_BLOCK)
    # copy-on-write: two real pairs (one overlapping: 5 -> 2 while 2 is a
    # source), a pair into the trash block and the trash -> trash padding
    src = np.array([2, 5, 6, 0], np.int32)
    dst = np.array([7, 2, 0, 0], np.int32)
    jref = JKC.copy_pool_blocks(jax.tree.map(jnp.asarray, jc),
                                jnp.asarray(src), jnp.asarray(dst))
    out = KC.copy_pool_blocks(cache, torch.from_numpy(src),
                              torch.from_numpy(dst))
    assert out is cache
    _held_to_reference(cache, jax.device_get(jref["dec"]))
    assert _same(_blocks(cache["dec"], TRASH_BLOCK), trash)
    # spill: three blocks padded to five with the trash block
    vec = np.array([4, 7, 1, 0, 0], np.int32)
    jspill = JKC.spill_pool_blocks(jref, jnp.asarray(vec))
    spilled = KC.spill_pool_blocks(cache, torch.from_numpy(vec))
    TP.assert_bitwise(spilled, jax.device_get(jspill))
    # restore fresh data into three blocks, padded to five
    data = jax.tree.map(lambda a: _random_like(rng, np.asarray(a)),
                        jax.device_get(jspill))
    vec = np.array([3, 8, 6, 0, 0], np.int32)
    before = {j: _blocks(cache["dec"], j) for j in range(NB_POOL)}
    jres = JKC.restore_pool_blocks(jref, jnp.asarray(vec),
                                   jax.tree.map(jnp.asarray, data))
    out, marker = KC.restore_pool_blocks_marked(cache, torch.from_numpy(vec),
                                                TP.to_port(data))
    assert out is cache and marker is None          # the CPU: no event
    _held_to_reference(cache, jax.device_get(jres["dec"]))
    for j in set(range(NB_POOL)) - set(vec.tolist()):
        assert _same(_blocks(cache["dec"], j), before[j]), j
    # the restored blocks hold the data, bit for bit
    for t, d in zip(_sorted_leaves(cache["dec"]), jax.tree.leaves(data)):
        TP.assert_bitwise(t[:, [3, 8, 6]], np.asarray(d)[:, :3])


# ---------------------------------------------------------------------------
# The scheduler with the prefix cache and with swap
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jcass = JCass(variant=1, gamma=GAMMA)
    jplain = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpacked = jpack.format_params(jplain, jcass)
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    packed = prepare_params(TP.to_port(jpacked), cass)
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (6, PROMPT)).astype(np.int32)
    shared = prompts.copy()
    shared[:, :HEADER] = prompts[0, :HEADER]
    return {"jcfg": jcfg, "jcass": jcass, "jpacked": jpacked, "cfg": cfg,
            "cass": cass, "packed": packed, "prompts": prompts,
            "shared": shared}


def _sched(setup, **kw):
    args = {**KW, "paged": True, "attn_kernel": "on", **kw}
    return S.Scheduler(setup["cfg"], setup["packed"], cass=setup["cass"],
                       ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                       debug_invariants=1, **args)


def _two_waves(sched, prompts):
    """Half the prompts, run to idle, then the other half: the second wave
    finds the first one's blocks indexed (parked)."""
    half = len(prompts) // 2
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in prompts[:half]]
    sched.run()
    reqs += [sched.submit(p, max_new=MAX_NEW, arrival=sched.clock)
             for p in prompts[half:]]
    sched.run()
    sched.check_invariants()
    return [r.output for r in reqs]


def _staggered(sched, prompts):
    """Arrivals a quarter cycle apart, priorities 0 and 1 alternating: a
    later priority-1 request preempts an earlier priority-0 row when the
    pool is tight."""
    reqs = [sched.submit(p, max_new=MAX_NEW, arrival=i / 4.0,
                         priority=i % 2) for i, p in enumerate(prompts)]
    sched.run()
    sched.check_invariants()
    return [r.output for r in reqs]


def _capture_first(sched) -> dict:
    """Record each request's first-token logits (rid -> f32 array)."""
    got, finish = {}, sched._finish_prefill

    def capture(req, last, cycle=None):
        got[req.rid] = np.asarray(last, np.float32)
        finish(req, last, cycle=cycle)
    sched._finish_prefill = capture
    return got


@pytest.fixture(scope="module")
def prefix_runs(setup):
    on = _sched(setup, prefix_cache=True)
    first = _capture_first(on)
    runs = {name: (s, _two_waves(s, setup["shared"])) for name, s in (
        ("on", on), ("off", _sched(setup)),
        ("on, overlap off", _sched(setup, prefix_cache=True,
                                   overlap=False)))}
    runs["first"] = first
    return runs


@pytest.mark.parametrize("other", ["off", "on, overlap off"])
def test_prefix_cache_on_equals_off(prefix_runs, other):
    """Two waves of prompts sharing a 6-token header (1.5 blocks of 4):
    the second wave matches one full block and copies the half-filled
    second by copy-on-write, so it prefills fewer tokens, yet every
    request's tokens equal the cache-off run's (and the pipelined run's
    equal the synchronous one's) bit for bit."""
    sched, outs = prefix_runs["on"]
    assert outs == prefix_runs[other][1]
    assert all(len(o) == MAX_NEW for o in outs)
    s = sched.summary()
    off = prefix_runs["off"][0].summary()
    assert s["prefix_hits"] == 3 and s["prefix_queries"] == 6
    assert s["prefix_matched_tokens"] == 3 * HEADER
    assert s["cow_copies"] == 3 and s["prefix_blocks_aliased"] == 3
    assert s["prefill_tokens"] == off["prefill_tokens"] - 3 * HEADER
    assert s["prefix_hit_rate"] == 0.5 and s["prefix_parked_blocks"] > 0
    assert s["subsystems"]["prefix_cache"] and not off["subsystems"][
        "prefix_cache"]
    assert sched.trace_counts == {"chunk": 1, "cow": 1, "unified": 1}
    assert sched.pool.allocated_total == sched.pool.reserved_total == 0


@pytest.fixture(scope="module")
def swap_runs(setup):
    tight = dict(num_blocks=13, swap=True)
    return {name: (s, _staggered(s, setup["shared"][:4])) for name, s in (
        ("swap", _sched(setup, **tight)),
        ("swap, overlap off", _sched(setup, overlap=False, **tight)),
        ("swap + prefix", _sched(setup, prefix_cache=True, **tight)),
        ("ample", _sched(setup)))}


@pytest.mark.parametrize("run", ["swap", "swap, overlap off",
                                 "swap + prefix"])
def test_swap_equals_ample_pool(swap_runs, run):
    """A pool of 13 blocks (12 usable) against rows that need 6 each: a
    priority-1 arrival preempts a priority-0 row, whose blocks are
    spilled to the host and restored later (with the prefix cache on, a
    resumed row re-aliases what the index still holds). Every request
    gets its tokens, bit for bit those of a pool that never preempts."""
    sched, outs = swap_runs[run]
    assert outs == swap_runs["ample"][1]
    assert all(len(o) == MAX_NEW for o in outs)
    s = sched.summary()
    assert s["preemptions"] >= 1 and s["swap_resumes"] == s["preemptions"]
    assert s["swap_out_blocks"] >= 1
    assert s["swap_in_blocks"] + s["swap_matched_blocks"] == \
        s["swap_out_blocks"]
    assert s["spill_total_spilled_blocks"] == s["swap_out_blocks"]
    assert s["spill_held_blocks"] == 0 and s["spill_peak_bytes"] > 0
    assert s["peak_swapped_tokens"] > 0 and s["subsystems"]["swap"]
    assert sched.trace_counts["spill"] == 1
    assert sched.trace_counts.get("restore", 1) == 1
    for name in ("spill", "restore"):
        if s[f"swap_{'out' if name == 'spill' else 'in'}_blocks"]:
            assert s["bucket_wall_ms"][name]["calls"] >= 1
    assert swap_runs["ample"][0].summary()["preemptions"] == 0
    assert sched.pool.swapped_total == 0 and not sched.spill.keys()


def test_reset_keeps_prefix_index(setup, prefix_runs):
    """``reset()`` starts a fresh run with the radix index (and its parked
    blocks) kept: a run of the second wave alone hits the header at once,
    and its tokens equal the cache-off run's."""
    sched = _sched(setup, prefix_cache=True)
    _two_waves(sched, setup["shared"][:2])
    parked = sched.pool.parked_total
    assert parked > 0
    sched.reset()
    assert sched.pool.parked_total == parked and len(sched.prefix) > 0
    assert sched.summary()["prefix_hits"] == 0
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in setup["shared"][3:]]
    sched.run()
    s = sched.summary()
    assert s["prefix_hits"] == 3 and s["cow_copies"] == 3
    assert [r.output for r in reqs] == prefix_runs["off"][1][3:]
    sched.check_invariants()


def test_port_scheduler_matches_reference_prefix(setup, prefix_runs):
    """The reference's scheduler (paged, packed, ``attn_kernel="jnp"``,
    prefix cache on) on the same two waves: the same prefix hits, matched
    tokens, copy-on-write copies and prefill tokens (they depend on the
    prompts and the arrival order only), and the same tokens under the
    near-tie rule. tau is twice the largest first-token logit difference
    between the packages over the six requests; the margins are the
    port's own autoregressive run's."""
    js = JS.Scheduler(setup["jcfg"], setup["jpacked"], cass=setup["jcass"],
                      ecfg=JE.EngineConfig(gamma=GAMMA),
                      rt_extra={"ssm_chunk": 8}, paged=True,
                      attn_kernel="jnp", prefix_cache=True, **KW)
    firsts = {"ref": _capture_first(js), "port": prefix_runs["first"]}
    ref_out = _two_waves(js, setup["shared"])
    port, port_out = prefix_runs["on"]
    rs, ps = js.summary(), port.summary()
    for k in ("prefix_queries", "prefix_hits", "prefix_matched_tokens",
              "prefix_blocks_aliased", "cow_copies", "prefill_tokens",
              "admitted", "finished"):
        assert rs[k] == ps[k], k
    gap = max(float(np.abs(firsts["ref"][i] - firsts["port"][i]).max())
              for i in range(6))
    assert gap < 0.02, gap
    eng = E.Engine(setup["cfg"], setup["packed"], cass=setup["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu")
    ar, st = eng.generate({"tokens": torch.from_numpy(setup["shared"])},
                          MAX_NEW, speculative=False)
    np.testing.assert_array_equal(np.array(port_out),
                                  ar.numpy()[:, :MAX_NEW])
    compared, _ = AR.tau_prefix(np.array(ref_out), np.array(port_out),
                                st["margins"], 2 * gap, MAX_NEW)
    assert compared >= 6, compared


def _cli(*extra) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.run(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                   "--scheduler", "--paged", "--attn-kernel", "on",
                   "--slots", "2", "--requests", "4", "--prompt-len", "8",
                   "--max-new", "6", "--block-size", "4", "--chunk-size",
                   "8", *extra])
    return out.getvalue()


def _cli_tokens(text: str) -> list:
    return re.findall(r"req \d+: 6 tokens, first (\[.*\])", text)


def test_serve_cli_prefix_and_swap():
    """``--prefix-cache --shared-header`` prints the same tokens as
    ``--shared-header`` alone, with a ``[prefix]`` line; ``--swap`` on a
    tight pool with priorities reports at least one preemption and one
    spilled block on its ``[swap]`` line."""
    on = _cli("--prefix-cache", "--shared-header")
    off = _cli("--shared-header")
    assert len(_cli_tokens(on)) == 4 and _cli_tokens(on) == _cli_tokens(off)
    assert "[prefix] hit rate=" in on and "[prefix]" not in off
    sw = _cli("--swap", "--num-blocks", "6", "--chunk-size", "4",
              "--priority", "0", "--priority", "1")
    m = re.search(r"\[swap\] preemptions=(\d+) \(resumes=(\d+)\), "
                  r"spilled=(\d+) blocks out / (\d+) restored", sw)
    assert m, sw
    pre, res, out, back = map(int, m.groups())
    assert pre >= 1 and res == pre and out >= 1 and back >= 1
    assert len(_cli_tokens(sw)) == 4
    for bad in (["--prefix-cache"], ["--swap"]):
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                serve.run(["--arch", "llama3-8b", "--smoke", "--device",
                           "cpu", "--scheduler", *bad])


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_prefill_attention_independent_of_chunk_start(arch):
    """The paged attention layer gives a prompt token the same bits
    whether its chunk started on the grid or mid-grid (after a prefix hit
    or a resume): the serving steps' window start
    (``engine.window_start``) keeps the pool walk and the suffix of every
    query where a grid-aligned run puts them. GQA (``paged_gqa``'s plain
    version) and MLA (``paged_mla``'s)."""
    cfg = get_config(arch, smoke=True)
    if cfg.mla:
        cfg = dataclasses.replace(cfg, n_layers=2, first_dense_layers=2)
    a, b = AR.chunk_start_outputs(cfg, "cpu", seed=3)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
