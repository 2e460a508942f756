"""Port vs reference: DeepSeek-V3's MLA attention at SMOKE width on the CPU.

The SMOKE config has one dense layer and two routed-expert layers; MoE is
not ported, so the tests cut it to its dense layers (two of them). Both
packages run on the same weights (the reference's init, carried across
with ``bridge.params_from_numpy``) and the same tokens (numpy from a seed).
Cassandra-1 packs a store only when its width is a multiple of 32 (the
32-lane bitmap), so the packed configuration widens the rope key from 16
to 32; the reference packs the same way (at DeepSeek-V3's own widths, 512
and 64, both stores pack).

Tolerances, as in the GQA tests: logits to ``LOGIT_ATOL`` (bf16 rounds at
other places in the two frameworks), the latents to one bf16 ulp,
everything the cache stores bit for bit, flash state ``(acc, m, l)``
within rtol 1e-4 / atol 1e-5 (the same f32 steps summed in another order).
"""
import contextlib
import dataclasses
import io

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
from repro.kernels import paged_attention as JPA, ref as jref
from repro.models import attention as JA, layers as JL, model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import engine as JE, kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels import kv_topk as KT, paged_attention as PA
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.launch import serve
from repro_torch.models import attention as A, model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC
from repro_torch.serving import scheduler as S

ARCH = "deepseek-v3-671b"
LOGIT_ATOL = 2e-2
RTOL, ATOL = 1e-4, 1e-5
B, S_PROMPT, S_MAX, GAMMA, MAX_NEW = 2, 12, 28, 3, 8


def _cut(cfg, **kw):
    """SMOKE cut to its dense layers (and widened where ``kw`` says)."""
    return dataclasses.replace(cfg, n_layers=2, first_dense_layers=2, **kw)


def _no_mtp(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "mtp"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """bf16 at SMOKE's rope 16, Cassandra-1 at rope 32: both packages."""
    out = {}
    for name, kw in (("plain", {}), ("c1", {"qk_rope_dim": 32})):
        jcfg = _cut(jax_get_config(ARCH, smoke=True), **kw)
        cfg = _cut(get_config(ARCH, smoke=True), **kw)
        jplain = _no_mtp(jax.jit(JM.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0)))
        out[name] = {"jcfg": jcfg, "cfg": cfg, "jplain": jplain,
                     "plain": TP.to_port(jplain)}
    jcass = JCass(variant=1, gamma=GAMMA)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    jpacked = jpack.format_params(out["c1"]["jplain"], jcass)
    out["c1"].update(jcass=jcass, cass=cass, jpacked=jpacked,
                     packed=prepare_params(TP.to_port(jpacked), cass))
    rng = np.random.default_rng(0)
    out["prompt"] = rng.integers(0, 512, (B, S_PROMPT)).astype(np.int32)
    out["step"] = rng.integers(0, 512, (B, GAMMA + 1)).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# Config, init, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))


def test_init_params_tree_and_distributions(models):
    """The reference's tree (its training-only ``mtp`` head aside), shapes
    and dtypes; every weight's spread within 5% of the reference's (the
    draws differ: torch vs JAX)."""
    ref = jax.device_get(models["plain"]["jplain"])
    out = M.init_params(models["plain"]["cfg"],
                        torch.Generator().manual_seed(1), device="cpu")

    def walk(p, r, path=""):
        if isinstance(r, dict):
            assert sorted(p) == sorted(r), path
            for k in r:
                walk(p[k], r[k], f"{path}.{k}")
        elif isinstance(r, list):
            for i, (pi, ri) in enumerate(zip(p, r)):
                walk(pi, ri, f"{path}[{i}]")
        else:
            assert tuple(p.shape) == r.shape, path
            assert str(p.dtype).split(".")[-1] == r.dtype.name, path
            rs = float(np.asarray(r, np.float32).std())
            ps = float(p.to(torch.float32).std())
            assert ps == pytest.approx(rs, rel=0.05, abs=1e-6), path

    walk(out, ref)
    assert sorted(out["dec"][0]["e0"]["attn"]) == [
        "kv_a", "kv_a_norm", "kv_b", "q_a", "q_a_norm", "q_b", "wo"]


@pytest.mark.parametrize("smoke", [False, True])
def test_routed_layers_raise(smoke):
    """The full depth (58 routed layers) and SMOKE (2 routed) raise, naming
    MoE, through the model and through the serve CLI; the dense cut runs."""
    cfg = get_config(ARCH, smoke=smoke)
    with pytest.raises(NotImplementedError, match="MoE"):
        M.init_params(cfg, torch.Generator(), device="cpu")
    if smoke:
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(NotImplementedError, match="MoE"):
            serve.run(["--arch", ARCH, "--smoke", "--device", "cpu"])
    M._check_dense(dataclasses.replace(cfg, n_layers=cfg.first_dense_layers))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer(m, view="plain"):
    """Layer 0's attention params and runtimes of both packages."""
    c1 = view != "plain"
    jtree = m["jpacked"] if c1 else m["jplain"]
    tree = m["packed"] if c1 else m["plain"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m.get("jcass") if c1 else None,
                   view=view)
    rt = Runtime(cfg=m["cfg"], cass=m.get("cass") if c1 else None, view=view)
    return (jrt, rt), (jax.tree.map(lambda a: a[0],
                                    jtree["dec"][0]["e0"]["attn"]),
                       M._index(tree["dec"][0]["e0"]["attn"], 0))


def _ulp_close(port, ref):
    """Within one bf16 ulp (2^-8 relative, and 2^-8 near zero)."""
    np.testing.assert_allclose(TP.f32(port), TP.f32(ref), rtol=2 ** -8,
                               atol=2 ** -8)


@pytest.mark.parametrize("view", ["plain", "target"])
def test_mla_latent_and_q_match_reference(models, view):
    m = models["c1" if view != "plain" else "plain"]
    (jrt, rt), (jp, p) = _layer(m, view)
    rng = np.random.default_rng(3)
    x = TP.rand_bf16_np(rng, (B, 7, m["cfg"].d_model))
    pos = np.arange(7, dtype=np.int32) + 5
    jc, jkr = JA.mla_latent(jrt, jp, jnp.asarray(x), jnp.asarray(pos))
    c, kr = A.mla_latent(rt, p, TP.to_port(x), torch.from_numpy(pos))
    _ulp_close(c, jc)
    _ulp_close(kr, jkr)
    jqn, jqr = JA._mla_q(jrt, jp, jnp.asarray(x), jnp.asarray(pos))
    qn, qr = A._mla_q(rt, p, TP.to_port(x), torch.from_numpy(pos))
    _ulp_close(qn, jqn)
    _ulp_close(qr, jqr)
    for a, b_ in zip(A._kv_b_split(rt, p), JA._kv_b_split(jrt, jp)):
        TP.assert_bitwise(a, b_)


@pytest.mark.parametrize("cached", [False, True])
def test_mla_layer_output_matches_reference(models, cached):
    """The layer's output and new latents, over the full sequence and as a
    cached decode against a prefix (the port keys the new latents by
    absolute position, the reference appends them: the same key set)."""
    m = models["plain"]
    (jrt, rt), (jp, p) = _layer(m)
    cfg = m["cfg"]
    rng = np.random.default_rng(4)
    sq = 3 if cached else 9
    x = TP.rand_bf16_np(rng, (B, sq, cfg.d_model))
    if not cached:
        pos = np.arange(sq, dtype=np.int32)
        jout, jlat = JA.mla_attention(jrt, jp, jnp.asarray(x),
                                      jnp.asarray(pos))
        out, lat = A.mla_attention(rt, p, TP.to_port(x),
                                   torch.from_numpy(pos))
    else:
        s = 10
        length = np.array([4, 6], np.int32)
        pos = length[:, None] + np.arange(sq, dtype=np.int32)
        pc = TP.rand_bf16_np(rng, (B, s, cfg.kv_lora_rank))
        pkr = TP.rand_bf16_np(rng, (B, s, cfg.qk_rope_dim))
        valid = np.arange(s)[None] < length[:, None]
        jout, jlat = JA.mla_attention(
            jrt, jp, jnp.asarray(x), jnp.asarray(pos),
            prefix_latent=(jnp.asarray(pc), jnp.asarray(pkr)),
            prefix_valid=jnp.asarray(valid))
        out, lat = A.mla_attention(
            rt, p, TP.to_port(x), torch.from_numpy(pos),
            prefix_latent=(TP.to_port(pc), TP.to_port(pkr)),
            prefix_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(TP.f32(out), TP.f32(jout), atol=LOGIT_ATOL)
    for a, b_ in zip(lat, jlat):
        _ulp_close(a, b_)


def test_mla_prefill_decode_drift_regression():
    """Port of ``tests/test_models.py::test_mla_prefill_decode_drift_
    regression``: the reference's 3-layer dense MLA config; the latents the
    prefill commits equal ``mla_latent`` on the same inputs exactly, and
    four incremental decode steps give the logits a prefill of the same
    tokens gives, to the reference's 3e-4 (the full pass and the decode
    share the absorbed association order)."""
    from repro_torch.configs import ModelConfig
    cfg = ModelConfig(
        name="mla-dense-drift", family="dense", n_layers=3, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512, norm_eps=1e-6,
        block_pattern=("am",), mla=True, q_lora_rank=64, kv_lora_rank=64,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rt = Runtime(cfg=cfg)
    s = 16
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (B, s)).astype(np.int32))
    split = s - 4
    with torch.inference_mode():
        cache = KC.init_cache(cfg, None, B, s + 8, packed=False, device="cpu")
        _, cache = M.forward_prefill(rt, params,
                                     {"tokens": tokens[:, :split]}, cache)
        e0 = cache["dec"][0]["e0"]
        emb = M._index(params["dec"][0]["e0"], 0)
        from repro_torch.models import layers as L
        h = L.norm(rt, emb["norm1"], L.embed(params["embed"],
                                             tokens[:, :split]))
        c_ref, kr_ref = A.mla_latent(rt, emb["attn"], h, torch.arange(split))
        assert torch.equal(e0["c"][0][:, :split], c_ref)
        assert torch.equal(e0["kr"][0][:, :split], kr_ref)
        for i in range(4):
            logits, upd = M.forward_decode(
                rt, params, tokens[:, split + i:split + i + 1], cache)
            full, _ = M.forward_prefill(
                rt, params, {"tokens": tokens[:, :split + i + 1]},
                KC.init_cache(cfg, None, B, s + 8, packed=False,
                              device="cpu"))
            np.testing.assert_allclose(TP.f32(logits[:, -1]),
                                       TP.f32(full[:, -1]), rtol=3e-4,
                                       atol=3e-4)
            cache = E.commit(rt, cache, upd, torch.zeros(B, dtype=torch.int32))


def test_mla_latent_flash_matches_absorbed():
    """Port of ``tests/test_models.py::test_mla_latent_flash_matches_
    absorbed``: the >2048-token path against one absorbed softmax, at any
    chunking, to the reference's atol 2e-5 / rtol 1e-4; and against the
    reference's latent flash on the same inputs."""
    b, s, h, lat, r = 2, 64, 4, 32, 16
    rng = np.random.default_rng(0)
    q_eff = rng.standard_normal((b, s, h, lat)).astype(np.float32)
    q_rope = rng.standard_normal((b, s, h, r)).astype(np.float32)
    c = TP.rand_bf16_np(rng, (b, s, lat))
    kr = TP.rand_bf16_np(rng, (b, s, r))
    scale = 1.0 / (32 + r) ** 0.5
    tq, tr, tc, tk = (TP.to_port(a) for a in (q_eff, q_rope, c, kr))
    sc = (torch.einsum("bqhl,bkl->bhqk", tq, tc.float())
          + torch.einsum("bqhr,bkr->bhqk", tr, tk.float())) * scale
    mask = (torch.arange(s)[:, None] >= torch.arange(s)[None, :])[None, None]
    p = torch.softmax(torch.where(mask, sc, -1e30), dim=-1)
    ref = torch.einsum("bhqk,bkl->bqhl", p, tc.float())
    for chunk in (16, 64):
        out = A._attend_flash_latent(tq, tr, tc, tk, causal=True, scale=scale,
                                     chunk_q=chunk, chunk_k=chunk)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=1e-4)
        jout = JA._attend_flash_latent(
            *(jnp.asarray(a) for a in (q_eff, q_rope, c, kr)), causal=True,
            scale=scale, chunk_q=chunk, chunk_k=chunk)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# paged_mla and the suffix merge
# ---------------------------------------------------------------------------

NB, BS, MB = 10, 4, 5                      # tests/test_kernels.py's walk
LENGTHS = np.array([0, 7, 20], np.int32)
LAT, ROPE, HEADS = 64, 16, 4


def _mla_walk(rng, t):
    """Inputs of one walk: ragged tables with out-of-range entries in
    masked slots, NaN in every pool row no valid position reads (the trash
    block, unused blocks, the tail of a partial last block)."""
    b = len(LENGTHS)
    perm = rng.permutation(np.arange(1, NB))
    tbl = np.zeros((b, MB), np.int32)
    i, used = 0, {}
    for row in range(b):
        for j in range(-(-int(LENGTHS[row]) // BS)):
            tbl[row, j] = perm[i]
            used[int(perm[i])] = int(LENGTHS[row]) - j * BS
            i += 1
    tbl[0, 3], tbl[1, 4] = -1, 97
    c = TP.rand_bf16_np(rng, (NB, BS, LAT))
    kr = TP.rand_bf16_np(rng, (NB, BS, ROPE))
    for blk in range(NB):
        n_ok = min(BS, used.get(blk, 0))
        c[blk, n_ok:] = np.nan
        kr[blk, n_ok:] = np.nan
    q_eff = rng.standard_normal((b, t, HEADS, LAT)).astype(np.float32)
    q_rope = rng.standard_normal((b, t, HEADS, ROPE)).astype(np.float32)
    return q_eff, q_rope, c, kr, tbl


@pytest.mark.parametrize("t", [1, 4])
def test_paged_mla_plain_matches_reference(t):
    """Against the reference's gather-then-scan (``impl="jnp"``) and its
    Pallas kernel in interpret mode; the empty row keeps the initial
    state exactly, and no masked NaN reaches the state."""
    q_eff, q_rope, c, kr, tbl = _mla_walk(np.random.default_rng(t), t)
    scale = 1.0 / (32 + ROPE) ** 0.5
    args = (q_eff, q_rope, c, kr, tbl, LENGTHS)
    before = PA.paged_mla.launches
    out = PA.paged_mla(*(TP.to_port(a) for a in args), scale=scale)
    assert PA.paged_mla.launches == before       # CPU: the plain version
    for impl in ("jnp", "interpret"):
        ref = JPA.paged_mla(*(jnp.asarray(a) for a in args), scale=scale,
                            impl=impl)
        for p, r in zip(out, ref):
            np.testing.assert_allclose(TP.f32(p), TP.f32(r), rtol=RTOL,
                                       atol=ATOL)
    acc, m, l = out
    assert all(bool(torch.isfinite(a).all()) for a in out)
    assert (acc[0] == 0).all() and (m[0] == PA.NEG_INF).all() \
        and (l[0] == 0).all()
    assert acc.shape == (3, HEADS, t, LAT) and m.shape == (3, HEADS, t)


@pytest.mark.parametrize("g_scratch", [0, 2])
def test_merge_mla_suffix_matches_reference(g_scratch):
    rng = np.random.default_rng(30 + g_scratch)
    b, t = 3, 4
    s = g_scratch + t
    scale = 1.0 / (32 + ROPE) ** 0.5
    acc = rng.standard_normal((b, HEADS, t, LAT)).astype(np.float32)
    m = rng.standard_normal((b, HEADS, t)).astype(np.float32)
    l = rng.uniform(0.5, 3, (b, HEADS, t)).astype(np.float32)
    m[1], l[1], acc[1] = PA.NEG_INF, 0.0, 0.0     # an empty pool row
    q_eff = rng.standard_normal((b, t, HEADS, LAT)).astype(np.float32)
    q_rope = rng.standard_normal((b, t, HEADS, ROPE)).astype(np.float32)
    suf_c = TP.rand_bf16_np(rng, (b, s, LAT))
    suf_kr = TP.rand_bf16_np(rng, (b, s, ROPE))
    from repro.models.attention import _suffix_valid as jsv
    valid = np.array(jsv(b, t, g_scratch, 1))
    if g_scratch:
        suf_c[:, 1:g_scratch] = np.nan              # invalid scratch slots
    args = (acc, m, l, q_eff, q_rope, suf_c, suf_kr)
    ref = JPA.merge_mla_suffix(*(jnp.asarray(a) for a in args),
                               jnp.asarray(valid), scale=scale)
    out = PA.merge_mla_suffix(*(TP.to_port(a) for a in args),
                              torch.from_numpy(valid), scale=scale)
    assert out.shape == (b, t, HEADS, LAT)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(TP.f32(out), TP.f32(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Cache: codecs, specs, commits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [32, 64, 512])
def test_mla_store_codec_bitwise(d):
    """encode_store / read_store of a (B, S, d) latent or rope store, both
    views, bit for bit against the reference (d = 512 is DeepSeek-V3's
    latent, 64 its rope key, 32 the packed SMOKE rope key)."""
    rng = np.random.default_rng(d)
    x = TP.rand_bf16_np(rng, (B, 5, d), scale=0.5)
    x[0, 1, :d // 2] = 0.0                           # zeros and ties kept
    x[1, 2] = np.abs(x[1, 2]).round()
    jbook = JKC.default_kv_codebook()
    eor = jnp.zeros(256, jnp.uint8).at[:jbook[0].shape[0]].set(jbook[0])
    jcass, cass = JCass(variant=1), CassandraConfig(variant=1)
    jstore = JKC.encode_store(jcass, jnp.asarray(x), d, (eor, jbook[1]))
    book = (TP.to_port(np.asarray(eor)), KC.default_kv_codebook()[1])
    store = KC.encode_store(cass, TP.to_port(x), d, book)
    TP.assert_bitwise(store, jstore)
    for view in ("draft", "target"):
        TP.assert_bitwise(KC.read_store(cass, store, d, view, book),
                          JKC.read_store(jcass, jstore, d, view,
                                         (eor, jbook[1])))
    TP.assert_bitwise(KC.read_store(cass, store, d, "target", book), x)


@pytest.mark.parametrize("d,keep", [(64, 32), (512, 304)])
def test_kv_topk_plain_at_mla_widths(d, keep):
    """``kv_topk_plain`` at the widths MLA's commits select over (keep at
    the paper's 40% prune) against the reference's oracle, bit for bit."""
    assert CassandraConfig().kv_keep(d) == keep
    rng = np.random.default_rng(d)
    v = TP.rand_bf16_np(rng, (12, d))
    v[1, ::2] = -0.0
    v[2, : d // 2] = -v[2, d // 2:]                 # |v| ties
    v[3] = 1.0                                      # all equal
    out = KT.kv_topk_plain(TP.to_port(v), keep)
    ref = jref.kv_topk_ref(jnp.asarray(v), keep)
    TP.assert_bitwise({k: out[k] for k in ("bitmap", "kept")}, ref)


@pytest.mark.parametrize("packed", [False, True])
def test_mla_cache_specs_match_reference(models, packed):
    m = models["c1" if packed else "plain"]
    jcass, cass = (m["jcass"], m["cass"]) if packed else (None, None)

    def walk(p, r):
        if isinstance(r, dict):
            assert sorted(p) == sorted(r)
            for k in r:
                walk(p[k], r[k])
        elif isinstance(r, list):
            for pi, ri in zip(p, r):
                walk(pi, ri)
        else:
            assert tuple(p[0]) == r.shape
            assert torch.empty(0, dtype=p[1]).element_size() == \
                r.dtype.itemsize

    walk(KC.cache_specs(m["cfg"], cass, B, S_MAX, packed),
         JKC.cache_specs(m["jcfg"], jcass, B, S_MAX, packed))
    walk(KC.paged_cache_specs(m["cfg"], cass, B, 9, 4, 5, packed),
         JKC.paged_cache_specs(m["jcfg"], jcass, B, 9, 4, 5, packed))
    spec = KC.cache_specs(m["cfg"], cass, B, S_MAX, packed)["dec"][0]["e0"]
    assert sorted(spec) == ["c", "kr"]


@pytest.mark.parametrize("view", ["plain", "target"])
def test_prefill_and_decode_logits(models, view):
    """Logits of a prefill and of a verify-width decode (from the
    reference's cache, carried across) against the reference; under
    Cassandra-1 the packed commits of the same latents (prefill, then a
    verify commit with per-row accepted counts) bit for bit, and both
    views decoded from them."""
    m = models["c1" if view != "plain" else "plain"]
    packed = view != "plain"
    jtree = m["jpacked"] if packed else m["jplain"]
    tree = m["packed"] if packed else m["plain"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m.get("jcass"), view=view)
    rt = Runtime(cfg=m["cfg"], cass=m.get("cass"), view=view)
    jcache0 = JKC.init_cache(m["jcfg"], m.get("jcass"), B, S_MAX,
                             packed=packed)
    cache0 = KC.init_cache(m["cfg"], m.get("cass"), B, S_MAX, packed=packed,
                           device="cpu")
    prompt, step = models["prompt"], models["step"]
    # the reference's forward_prefill, step by step (its latents are
    # committed by both packages below)

    @jax.jit
    def jprefill(tree_, tokens):
        x, _, upd = JM._scan_groups(
            jrt, tree_["dec"], JM._entries(m["jcfg"]),
            JL.embed(tree_["embed"], tokens), jnp.arange(S_PROMPT),
            mode="prefill")
        return JL.unembed(jrt, tree_, JL.norm(jrt, tree_["final_norm"],
                                              x[:, -1:])), upd

    jl, jpre = jprefill(jtree, jnp.asarray(prompt))
    jcache = JM._commit_prefill(jrt, jcache0, jpre, S_PROMPT,
                                JKC.cache_codebook(jcache0))
    lg, _ = M.forward_prefill(rt, tree, {"tokens": torch.from_numpy(prompt)},
                              TP.clone_tree(cache0))
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
    jd, jupd = JM.forward_decode(jrt, jtree, jnp.asarray(step), jcache)
    ld, upd = M.forward_decode(rt, tree, torch.from_numpy(step),
                               TP.to_port(jcache))
    np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)
    assert upd[0]["e0"]["c"].shape == (2, B, GAMMA + 1, 64)
    if not packed:
        return
    cache = M._commit_prefill(rt, cache0, TP.to_port(jpre), S_PROMPT,
                              KC.cache_codebook(cache0))
    TP.assert_bitwise(cache, jcache)
    n = np.array([0, 2], np.int32)
    jcache2 = JE.commit(jrt, jcache, jupd, jnp.asarray(n))
    cache2 = E.commit(rt, cache, TP.to_port(jupd), torch.from_numpy(n))
    TP.assert_bitwise(cache2, jcache2)
    for v in ("draft", "target"):
        TP.assert_bitwise(
            M.materialize_cache_view(dataclasses.replace(rt, view=v),
                                     cache2),
            JM.materialize_cache_view(dataclasses.replace(jrt, view=v),
                                      jcache2))


# ---------------------------------------------------------------------------
# The slice as a whole: Engine and paged Scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(models):
    m = models["c1"]
    eng = E.Engine(m["cfg"], m["packed"], cass=m["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu")
    spec, st = eng.generate({"tokens": torch.from_numpy(models["prompt"])},
                            MAX_NEW)
    return eng, spec.numpy(), st


def test_spec_tokens_equal_verify_width_ar_tokens(models, engine):
    """Cassandra-1 ``Engine.generate`` on the MLA model: the speculative
    tokens equal the port's autoregressive steps at the verify width on
    every position, whose logits equal the verify pass's bit for bit."""
    eng, spec, st = engine
    prompt = torch.from_numpy(models["prompt"])
    assert AR.verify_gap(eng, prompt, GAMMA, GAMMA + 1) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, MAX_NEW, GAMMA + 1)
    np.testing.assert_array_equal(spec[:, :MAX_NEW], toks.numpy())
    assert st["draft_passes"] == st["cycles"] * GAMMA


def _serve(cfg, params, cass, prompts, speculative=True, **kw):
    sched = S.Scheduler(cfg, params, cass=cass,
                        ecfg=E.EngineConfig(gamma=GAMMA), num_slots=2,
                        s_max=S_PROMPT + MAX_NEW + GAMMA + 1, paged=True,
                        block_size=4, chunk_size=4, speculative=speculative,
                        device="cpu", **kw)
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in prompts]
    sched.run()
    assert all(len(r.output) == MAX_NEW for r in reqs)
    return sched, [r.output for r in reqs]


@pytest.mark.parametrize("variant", [0, 1])
def test_paged_scheduler_kernel_on_equals_off(models, engine, variant):
    """The paged scheduler with ``paged_mla`` on (its plain version on the
    CPU) gives the tokens of the gather path, as the reference's
    ``test_attn_kernel_mla_paged`` pins: bf16 autoregressive (variant 0,
    SMOKE's rope 16) and Cassandra-1 speculative (three requests over two
    slots, so one is admitted late); the speculative run also equals the
    Engine's tokens, and with the overlap pipeline off."""
    m = models["c1" if variant else "plain"]
    params = m["packed"] if variant else m["plain"]
    cass = m.get("cass") if variant else None
    prompts = list(models["prompt"]) + [models["prompt"][0][:7]]
    before = PA.paged_mla.launches
    outs = {}
    for name, kw in (("on", {"attn_kernel": "on"}), ("off", {})):
        _, outs[name] = _serve(m["cfg"], params, cass, prompts,
                               speculative=bool(variant), **kw)
    assert PA.paged_mla.launches == before       # CPU: the plain version
    assert outs["on"] == outs["off"]
    if variant:
        _, spec, _ = engine
        assert [o for o in outs["on"][:B]] == spec[:, :MAX_NEW].tolist()
        _, got = _serve(m["cfg"], params, cass, prompts, attn_kernel="on",
                        overlap=False)
        assert got == outs["on"]


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("bps", [1, 2, 3, MB])
def test_paged_mla_split_walk_matches_unsplit_and_reference(t, bps):
    """``paged_mla``'s table split in plain torch (each chunk of ``bps``
    table columns walked into its own latent flash state, merged in chunk
    order) against the unsplit walk and the reference's ``paged_mla``
    (``impl="jnp"``): within rtol 1e-4 / atol 1e-5; the empty row keeps
    the initial state through the merge and no masked NaN reaches it."""
    q_eff, q_rope, c, kr, tbl = _mla_walk(np.random.default_rng(40 + t), t)
    scale = 1.0 / (32 + ROPE) ** 0.5
    args = (q_eff, q_rope, c, kr, tbl, LENGTHS)
    port = [TP.to_port(a) for a in args]
    split = PA.paged_mla_split_plain(*port, scale=scale,
                                     blocks_per_split=bps)
    unsplit = PA.paged_mla_plain(*port, scale=scale)
    ref = JPA.paged_mla(*(jnp.asarray(a) for a in args), scale=scale,
                        impl="jnp")
    for s, u, r in zip(split, unsplit, ref):
        assert bool(torch.isfinite(s).all())
        np.testing.assert_allclose(TP.f32(s), TP.f32(u), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(TP.f32(s), TP.f32(r), rtol=RTOL,
                                   atol=ATOL)
    acc, m, l = split
    assert (acc[0] == 0).all() and (m[0] == PA.NEG_INF).all() \
        and (l[0] == 0).all()
