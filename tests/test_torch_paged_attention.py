"""Port vs reference: paged attention (plain versions), the block
allocator and the paged KV cache, at SMOKE widths on the CPU.

Integer and bit-level results (the speculation decode, allocator state,
pool leaves) are held bit for bit. Flash state ``(acc, m, l)`` is held
within rtol 1e-4 / atol 1e-5 (the tolerance the card's kernels are held
to): both packages compute the same f32 steps, but their einsums sum in
different orders, and the delta-mode rows reach 2^20, so the value sums
cancel (measured: relative error up to 2.4e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.core.format import CassandraConfig as JCass
from repro.kernels import paged_attention as JPA
from repro.serving import kvcache as JKC
from repro.serving.blockpool import BlockAllocator as JAlloc
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels import paged_attention as PA
from repro_torch.serving import kvcache as KC
from repro_torch.serving.blockpool import BlockAllocator, TRASH_BLOCK

B, HKV, G, NB, BS, MB = 4, 2, 2, 12, 4, 5
LENGTHS = np.array([13, 0, 20, 6], np.int32)
RTOL, ATOL = 1e-4, 1e-5


def _table(rng):
    """Rows map into [1, NB); a few entries out of range (negative, past
    NB) must read the trash block."""
    tbl = rng.integers(1, NB, (B, MB)).astype(np.int32)
    tbl[0, 4] = -3
    tbl[2, 1] = NB + 7
    tbl[3, 2] = 0
    return tbl


def _store(rng, shape, d, wide=False):
    """A packed pool from both packages' encoders (bitwise equal). Values
    of scale 1/4 sit at the default book's center (unary mode 0); ``wide``
    spreads the magnitudes of half the rows over 2^±20, so those fall back
    to the delta mode (mode 1), escape codes included."""
    x = rng.standard_normal(shape).astype(np.float32) * 0.25
    if wide:
        spread = np.exp2(rng.integers(-20, 20, shape)).astype(np.float32)
        rows = rng.random(shape[:-1] + (1,)) < 0.5
        x = np.where(rows, x * spread, x)
    xb = np.array(jnp.asarray(x, jnp.bfloat16))
    jcass, cass = JCass(), CassandraConfig()
    jbook = JKC.default_kv_codebook()
    eor = jnp.zeros(256, jnp.uint8).at[:jbook[0].shape[0]].set(jbook[0])
    jstore = JKC.encode_store(jcass, jnp.asarray(xb), d, (eor, jbook[1]))
    book = KC.default_kv_codebook()
    store = KC.encode_store(cass, TP.to_port(xb), d, book)
    TP.assert_bitwise(store, jstore)
    return jstore, store, eor


def _random_spec(rng, d):
    """Arbitrary speculation words: popcounts above keep, random modes,
    emax and 3-bit codes (the escape code 7 among them)."""
    keep = CassandraConfig().kv_keep(d)
    wsm, we = (keep * 4 + 31) // 32, (keep * 3 + 31) // 32
    lead = (NB, BS, HKV, 1)
    words = lambda w: rng.integers(0, 2 ** 32, (*lead, w), dtype=np.uint64
                                   ).astype(np.uint32)
    return {"bitmap": words(d // 32), "signmant": words(wsm),
            "exp_words": words(we),
            "exp_mode": rng.integers(0, 2, lead).astype(np.uint8),
            "exp_emax": rng.integers(0, 256, lead).astype(np.uint8)}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["encoded", "wide", "random"])
def test_decode_spec_pool_bitwise(d, kind):
    rng = np.random.default_rng(d + len(kind))
    cass = CassandraConfig()
    if kind == "random":
        jspec = _random_spec(rng, d)
        spec = TP.to_port(jspec)
        book = rng.integers(0, 256, 256).astype(np.uint8)
        jbook, pbook = jnp.asarray(book), torch.from_numpy(book)
    else:
        jstore, store, eor = _store(rng, (NB, BS, HKV, d), d,
                                    wide=kind == "wide")
        jspec, spec = jstore["spec"], store["spec"]
        jbook, pbook = eor, TP.to_port(np.asarray(eor))
        if kind == "wide":
            modes = np.asarray(jspec["exp_mode"])
            assert 0.2 < modes.mean() < 1.0, modes.mean()
    kw = dict(d=d, keep=cass.kv_keep(d), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits)
    ref = JPA.decode_spec_pool(
        {k: jnp.asarray(v) for k, v in jspec.items()}, jbook, **kw)
    out = PA.decode_spec_pool(spec, pbook, **kw)
    TP.assert_bitwise(out, ref)
    if kind != "random":
        # and the cache's own draft view of the same store
        TP.assert_bitwise(out, KC.read_store(cass, store, d, "draft",
                                             KC.default_kv_codebook()))


def test_sanitize_table_matches_reference():
    tbl = np.array([[0, 3, -1, 97, NB - 1]], np.int32)
    TP.assert_bitwise(PA.sanitize_table(torch.from_numpy(tbl), NB),
                      JPA.sanitize_table(jnp.asarray(tbl), NB))


def _close(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(TP.f32(p), TP.f32(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("t", [1, 4, 8])
def test_paged_gqa_plain_matches_reference(t):
    rng = np.random.default_rng(t)
    d = 64
    q = TP.rand_bf16_np(rng, (B, t, HKV, G, d))
    k = TP.rand_bf16_np(rng, (NB, BS, HKV, d))
    v = TP.rand_bf16_np(rng, (NB, BS, HKV, d))
    tbl = _table(rng)
    scale = d ** -0.5
    ref = JPA.paged_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(tbl), jnp.asarray(LENGTHS), scale=scale,
                        impl="jnp")
    before = PA.paged_gqa.launches
    out = PA.paged_gqa(TP.to_port(q), TP.to_port(k), TP.to_port(v),
                       torch.from_numpy(tbl), torch.from_numpy(LENGTHS),
                       scale=scale)
    assert PA.paged_gqa.launches == before       # CPU: the plain version
    _close(out, ref)
    # the empty row keeps the initial state exactly
    assert (out[0][1] == 0).all() and (out[1][1] == PA.NEG_INF).all()


@pytest.mark.parametrize("t", [1, 4, 8])
def test_paged_gqa_packed_plain_matches_reference(t):
    rng = np.random.default_rng(10 + t)
    d = 64
    cass = CassandraConfig()
    jk, k, eor = _store(rng, (NB, BS, HKV, d), d)
    jv, v, _ = _store(rng, (NB, BS, HKV, d), d, wide=True)
    q = TP.rand_bf16_np(rng, (B, t, HKV, G, d))
    tbl = _table(rng)
    kw = dict(d=d, keep=cass.kv_keep(d), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits, scale=d ** -0.5)
    ref = JPA.paged_gqa_packed(jnp.asarray(q), jk["spec"], jv["spec"],
                               jnp.asarray(tbl), jnp.asarray(LENGTHS), eor,
                               impl="jnp", **kw)
    out = PA.paged_gqa_packed(TP.to_port(q), k["spec"], v["spec"],
                              torch.from_numpy(tbl),
                              torch.from_numpy(LENGTHS),
                              TP.to_port(np.asarray(eor)), **kw)
    _close(out, ref)


@pytest.mark.parametrize("g_scratch", [0, 3])
def test_merge_gqa_suffix_matches_reference(g_scratch):
    rng = np.random.default_rng(20 + g_scratch)
    t, d, scale = 4, 64, 64 ** -0.5
    s = g_scratch + t
    acc = rng.standard_normal((B, HKV, G, t, d)).astype(np.float32)
    m = rng.standard_normal((B, HKV, G, t)).astype(np.float32)
    m[1] = PA.NEG_INF                       # an empty pool row
    l = rng.uniform(0.5, 3, (B, HKV, G, t)).astype(np.float32)
    l[1] = 0.0
    acc[1] = 0.0
    q = TP.rand_bf16_np(rng, (B, t, HKV, G, d))
    k = TP.rand_bf16_np(rng, (B, s, HKV, d))
    v = TP.rand_bf16_np(rng, (B, s, HKV, d))
    from repro.models.attention import _suffix_valid as jsv
    from repro_torch.models.attention import _suffix_valid
    valid = np.array(jsv(B, t, g_scratch, 2))
    assert np.array_equal(_suffix_valid(B, t, g_scratch, 2).numpy(), valid)
    ref = JPA.merge_gqa_suffix(*(jnp.asarray(a) for a in (acc, m, l, q, k,
                                                          v, valid)),
                               scale=scale)
    out = PA.merge_gqa_suffix(*(TP.to_port(a) for a in (acc, m, l, q, k, v)),
                              torch.from_numpy(valid), scale=scale)
    np.testing.assert_allclose(TP.f32(out), TP.f32(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Block allocator: the same traces leave the same state
# ---------------------------------------------------------------------------

def _alloc_state(pool, owners) -> tuple:
    return (pool.occupancy(), pool.reserved_total, pool.allocated_total,
            pool.high_water, [tuple(pool.blocks_of(o)) for o in owners])


@pytest.mark.parametrize("seed", range(6))
def test_allocator_traces_match_reference(seed):
    """Admit/grow/retire traffic (``test_kvcache.py``'s trace shape) on
    both allocators: every call returns the same and the state after each
    step is identical."""
    rng = np.random.default_rng(seed)
    num_blocks = int(rng.integers(2, 25))
    pools = (BlockAllocator(num_blocks), JAlloc(num_blocks))
    live, reserved, next_owner = [], {}, 0
    for _ in range(60):
        kind, v = ["admit", "grow", "retire"][rng.integers(3)], \
            int(rng.integers(8))
        if kind == "admit":
            need = v % 4 + 1
            fits = [p.can_reserve(need) for p in pools]
            assert fits[0] == fits[1]
            if fits[0]:
                for p in pools:
                    p.reserve(next_owner, need)
                reserved[next_owner] = need
                live.append(next_owner)
                next_owner += 1
        elif kind == "grow" and live:
            owner = live[v % len(live)]
            if len(pools[1].blocks_of(owner)) < reserved[owner]:
                got = [p.alloc(owner) for p in pools]
                assert got[0] == got[1] != TRASH_BLOCK
        elif kind == "retire" and live:
            owner = live.pop(v % len(live))
            assert pools[0].release(owner) == pools[1].release(owner)
            del reserved[owner]
        for p in pools:
            p.check_invariants()
        assert _alloc_state(pools[0], live) == _alloc_state(pools[1], live)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("trash_writes", [False, True])
def test_append_paged_and_gather_match_reference(packed, trash_writes):
    """Runs scattered through a block table, then gathered back per row:
    pool leaves bitwise equal to the reference's. With ``trash_writes``
    some runs reach past their table or onto unmapped entries; the
    reference writes garbage into the trash block there (by contract it
    is never read unmasked) while the port leaves it untouched, so block
    0 is compared only when nothing is routed to it."""
    rng = np.random.default_rng(30 + packed + 2 * trash_writes)
    d, q = 64, 5
    cass, jcass = CassandraConfig(), JCass()
    old = TP.rand_bf16_np(rng, (NB, BS, HKV, d))
    new = TP.rand_bf16_np(rng, (B, q, HKV, d))
    # rows own disjoint blocks
    tbl = np.zeros((B, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))[:B * 2].reshape(B, 2)
    tbl[:, :2] = perm
    at = np.array([0, 3, 1, 2], np.int32)
    if trash_writes:
        tbl[1, 1] = 0                     # unmapped second block
        at = np.array([0, 6, 1, 18], np.int32)   # row 3 runs past MB*BS
    if packed:
        jbook, book = JKC.default_kv_codebook(), KC.default_kv_codebook()
        jold = JKC.encode_store(jcass, jnp.asarray(old), d, jbook)
        jnew = JKC.encode_store(jcass, jnp.asarray(new), d, jbook)
        pold = KC.encode_store(cass, TP.to_port(old), d, book)
        pnew = KC.encode_store(cass, TP.to_port(new), d, book)
    else:
        jold, jnew = jnp.asarray(old), jnp.asarray(new)
        pold, pnew = TP.to_port(old), TP.to_port(new)
    ref = JKC.append_batched(jold, jnew, jnp.asarray(at), jnp.asarray(tbl))
    out = KC.append_batched(pold, pnew, torch.from_numpy(at),
                            torch.from_numpy(tbl))
    keep = slice(1, None) if trash_writes else slice(None)
    TP.assert_bitwise(_cut_port(out, keep),
                      jax.tree.map(lambda x: x[keep], ref))
    if trash_writes:                          # the trash block is unchanged
        TP.assert_bitwise(_cut_port(out, slice(0, 1)),
                          jax.tree.map(lambda x: x[:1], jold))
    ref_g = JKC.gather_store(ref, jnp.asarray(tbl))
    out_g = KC.gather_store(out, torch.from_numpy(tbl))
    for b in range(B):
        for j in range(MB):
            if trash_writes and tbl[b, j] == 0:
                continue
            sl = (slice(b, b + 1), slice(j * BS, (j + 1) * BS))
            TP.assert_bitwise(_cut_port(out_g, sl),
                              jax.tree.map(lambda x: x[sl], ref_g))


def _cut_port(store, sl):
    if isinstance(store, dict):
        return {k: _cut_port(v, sl) for k, v in store.items()}
    return store[sl]


def _shapes(tree, path=""):
    """{path: shape} of a reference (ShapeDtypeStruct) or port ((shape,
    dtype)) spec table."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}.{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}[{i}]"))
        return out
    return {path: tuple(tree.shape if hasattr(tree, "shape") else tree[0])}


@pytest.mark.parametrize("packed", [False, True])
def test_paged_cache_specs_match_reference(packed):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    cfg, jcfg = get_config("llama3-8b", smoke=True), jget("llama3-8b",
                                                          smoke=True)
    ref = JKC.paged_cache_specs(jcfg, JCass(), 3, 9, 4, 5, packed)
    out = KC.paged_cache_specs(cfg, CassandraConfig(), 3, 9, 4, 5, packed)
    assert _shapes(out) == _shapes(ref)
    cache = KC.init_paged_cache(cfg, CassandraConfig(), 3, 9, 4, 5, packed,
                                device="cpu")
    assert KC.is_paged(cache) and (cache["block_table"] == 0).all()
    assert cache["block_table"].dtype == torch.int32
