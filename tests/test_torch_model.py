"""Port vs reference, the model at SMOKE width.

Both packages run on the same weights (the reference's init, carried
across with ``bridge.params_from_numpy``) and the same tokens (numpy from
a seed). Logits are bf16 values cast to f32 in both packages; bf16 rounds
at other places in the two frameworks, so they agree to ``LOGIT_ATOL``, a
few bf16 ulps at the smoke model's logit scale (|logit| < 1, one ulp
2^-8). Everything the cache stores is compared bit for bit, from the same
K/V inputs: packed leaves after the prefill commit and after a verify
commit, and the draft/target views decoded from them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.configs import get_config as jax_get_config
from repro.core import packing as jpack
from repro.core.format import CassandraConfig as JCass
from repro.models import attention as JA, layers as JL, model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import engine as JE, kvcache as JKC
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.models import attention as A, layers as L, model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC

LOGIT_ATOL = 2e-2
B, S_PROMPT, S_MAX, GAMMA = 2, 16, 28, 3


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jcass, cass = JCass(variant=1, gamma=GAMMA), CassandraConfig(
        variant=1, gamma=GAMMA)
    jplain = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpacked = jpack.format_params(jplain, jcass)
    rng = np.random.default_rng(0)
    return {
        "jcfg": jcfg, "cfg": get_config("llama3-8b", smoke=True),
        "jcass": jcass, "cass": cass,
        "jplain": jplain, "plain": TP.to_port(jplain),
        "jpacked": jpacked,
        "packed": prepare_params(TP.to_port(jpacked), cass),
        "prompt": rng.integers(0, jcfg.vocab_size,
                               (B, S_PROMPT)).astype(np.int32),
        "step": rng.integers(0, jcfg.vocab_size,
                             (B, GAMMA + 1)).astype(np.int32),
    }


def _pair(m, view):
    packed = view != "plain"
    jrt = JRuntime(cfg=m["jcfg"], cass=m["jcass"] if packed else None,
                   view=view)
    rt = Runtime(cfg=m["cfg"], cass=m["cass"] if packed else None, view=view)
    trees = (m["jpacked"], m["packed"]) if packed else (m["jplain"],
                                                        m["plain"])
    caches = (JKC.init_cache(m["jcfg"], m["jcass"], B, S_MAX, packed=packed),
              KC.init_cache(m["cfg"], m["cass"], B, S_MAX, packed=packed,
                            device="cpu"))
    return (jrt, rt), trees, caches


def test_init_params_tree_and_distributions():
    """Same tree, shapes and dtypes as the reference's init; every weight's
    spread within 5% of the reference's (the draws differ: torch vs JAX)."""
    jcfg = jax_get_config("llama3-8b", smoke=True)
    ref = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(1)))
    out = M.init_params(get_config("llama3-8b", smoke=True),
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


@pytest.mark.parametrize("view", ["plain", "target"])
def test_prefill_and_decode_logits(models, view):
    (jrt, rt), (jtree, tree), (jcache, cache) = _pair(models, view)
    prompt, step = models["prompt"], models["step"]
    jl, jcache = JM.forward_prefill(jrt, jtree, {"tokens": jnp.asarray(prompt)},
                                    jcache)
    lg, cache = M.forward_prefill(rt, tree, {"tokens": torch.from_numpy(prompt)},
                                  cache)
    assert lg.shape == (B, 1, models["cfg"].vocab_size)
    assert lg.dtype == torch.float32
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    jd, _ = JM.forward_decode(jrt, jtree, jnp.asarray(step), jcache)
    ld, upd = M.forward_decode(rt, tree, torch.from_numpy(step), cache)
    np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)
    assert upd[0]["e0"]["k"].shape == (2, B, GAMMA + 1, 2, 64)


def test_packed_kv_commits_bitwise(models):
    """The prefill commit and a verify commit (per-row accepted counts) write
    the reference's packed leaves, bit for bit, from the same K/V."""
    (jrt, rt), (jtree, _), (jcache0, cache0) = _pair(models, "target")
    toks = jnp.asarray(models["prompt"])
    x = JL.embed(jtree["embed"], toks)
    _, _, jupd = JM._scan_groups(jrt, jtree["dec"], JM._entries(models["jcfg"]),
                                 x, jnp.arange(S_PROMPT), mode="prefill")
    jcache = JM._commit_prefill(jrt, jcache0, jupd, S_PROMPT,
                                JKC.cache_codebook(jcache0))
    cache = M._commit_prefill(rt, cache0, TP.to_port(jupd), S_PROMPT,
                              KC.cache_codebook(cache0))
    TP.assert_bitwise(cache, jcache)
    _, jupd2 = JM.forward_decode(jrt, jtree, jnp.asarray(models["step"]),
                                 jcache)
    n = np.array([0, 2], np.int32)
    jcache2 = JE.commit(jrt, jcache, jupd2, jnp.asarray(n))
    cache2 = E.commit(rt, cache, TP.to_port(jupd2), torch.from_numpy(n))
    TP.assert_bitwise(cache2, jcache2)
    np.testing.assert_array_equal(cache2["length"].numpy(), S_PROMPT + n + 1)
    for view in ("draft", "target"):
        TP.assert_bitwise(
            M.materialize_cache_view(dataclasses.replace(rt, view=view),
                                     cache2),
            JM.materialize_cache_view(dataclasses.replace(jrt, view=view),
                                      jcache2))


def test_cache_specs_match_reference_shapes(models):
    jspecs = JKC.cache_specs(models["jcfg"], models["jcass"], B, S_MAX, True)
    specs = KC.cache_specs(models["cfg"], models["cass"], B, S_MAX, True)

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
    walk(specs, jspecs)
    assert models["cfg"].hd == 64


def test_attention_primitives_match_reference():
    rng = np.random.default_rng(2)
    for sq, sk, off in ((4, 9, 5), (3, 3, 0)):
        TP.assert_bitwise(A.causal_mask(sq, sk, off),
                          JA.causal_mask(sq, sk, off))
    pv = rng.random((3, 7)) < 0.6
    TP.assert_bitwise(A.full_mask(torch.from_numpy(pv), 4),
                      JA.full_mask(jnp.asarray(pv), 4))
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    flash = A._attend_flash(tq, tk, tv, causal=True, q_offset=0, chunk_q=4,
                            chunk_k=2)
    np.testing.assert_allclose(
        flash.numpy(), np.asarray(JA._attend_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            q_offset=0, chunk_q=4, chunk_k=2)), rtol=1e-5, atol=1e-5)
    dense = A._attend_dense(tq, tk, tv, A.causal_mask(8, 8, 0), 16 ** -0.5)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_absolute_position_keys_equal_appended_keys():
    """Keys at absolute positions (the port) and keys appended after the
    prefix (the reference) attend the same key set: same outputs."""
    rng = np.random.default_rng(3)
    b, s, sq, h, hkv, d = 3, 10, 3, 4, 2, 8
    length = torch.tensor([2, 5, 7])
    pk, pv = (torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(
        np.float32)) for _ in range(2))
    nk, nv = (torch.from_numpy(rng.standard_normal((b, sq, hkv, d)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32))
    positions = length[:, None] + torch.arange(sq)
    valid = torch.arange(s)[None] < length[:, None]
    ref = A._attend_dense(q, torch.cat([pk, nk], 1), torch.cat([pv, nv], 1),
                          A.full_mask(valid, sq), d ** -0.5)
    k, v = A.place_at_positions((pk, pv), (nk, nv), positions)
    out = A._attend_dense(q, k, v, A.position_mask(valid, positions, sq),
                          d ** -0.5)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(k[1, 5:8], nk[1]) and torch.equal(k[1, :5], pk[1, :5])


def test_layers_match_reference():
    rng = np.random.default_rng(4)
    x = TP.rand_bf16_np(rng, (2, 5, 3, 16), scale=3.0)
    pos = np.arange(5, dtype=np.int32) + 11
    TP.assert_bitwise(L.rope_freqs(16, 5e5), JL.rope_freqs(16, 5e5))
    for p in (pos, np.stack([pos, pos + 3])):
        np.testing.assert_allclose(
            TP.f32(L.apply_rope(TP.to_port(x), torch.from_numpy(p), 5e5)),
            TP.f32(JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 5e5)),
            atol=2 ** -5)       # one bf16 ulp at |x| < 8
    scale = rng.random(16).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        TP.f32(L.rmsnorm({"scale": torch.from_numpy(scale)}, TP.to_port(x),
                         1e-5)),
        TP.f32(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                          1e-5)), atol=2 ** -6)
    table = TP.rand_bf16_np(rng, (9, 4))
    idx = np.array([[1, 8], [0, 3]], np.int32)
    TP.assert_bitwise(L.embed({"table": TP.to_port(table)},
                              torch.from_numpy(idx)),
                      JL.embed({"table": jnp.asarray(table)}, jnp.asarray(idx)))


@pytest.mark.parametrize("change", [dict(n_encoder_layers=2,
                                         cross_attention=True),
                                    dict(frontend="vision",
                                         frontend_tokens=16),
                                    dict(family="audio"),
                                    dict(frontend="audio",
                                         frontend_tokens=16)])
def test_other_families_raise(change):
    """What raised until the encoder-decoder slice now builds: an encoder
    with cross-attention, a vision or audio frontend and the audio family
    give the reference's tree (an encoder and ``xattn``; layer norms and
    biased projections for the audio family; the frontends add no
    parameters). Parity: ``tests/test_torch_encdec.py``."""
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), **change)
    assert isinstance(cfg, ModelConfig)
    params = M.init_params(cfg, torch.Generator(), device="cpu")
    e0 = params["dec"][0]["e0"]
    assert ("enc" in params) == ("xattn" in e0) == cfg.is_encdec
    assert ("bias" in e0["norm1"]) == ("pos_embed" in params) == (
        cfg.family == "audio")


@pytest.mark.slow
def test_draft_view_logits_match_reference_interpret_kernel(models):
    """The draft pass through the port's kernel wrapper (plain version on
    the CPU) against the reference's draft pass through its Pallas kernel
    in interpret mode, from the same packed cache (the reference's prefill,
    carried across): the same decoded weights, rank3 escape included."""
    jrt = JRuntime(cfg=models["jcfg"], cass=models["jcass"], view="draft",
                   kernels="interpret")
    rt = Runtime(cfg=models["cfg"], cass=models["cass"], view="draft")
    jcache = JKC.init_cache(models["jcfg"], models["jcass"], B, S_MAX, True)
    _, jcache = JM.forward_prefill(dataclasses.replace(jrt, view="target"),
                                   models["jpacked"],
                                   {"tokens": jnp.asarray(models["prompt"])},
                                   jcache)
    step = models["step"][:, :1]
    jd, _ = JM.forward_decode(jrt, models["jpacked"], jnp.asarray(step), jcache)
    ld, _ = M.forward_decode(rt, models["packed"], torch.from_numpy(step),
                             TP.to_port(jcache))
    np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)
