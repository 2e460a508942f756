"""Port vs reference: every bit of Cassandra-2 (MX).

The MX codec (``core/mx.py``), the variant-2 tensor format (weights and
KV, spec and verif leaf for leaf, draft and target views) and the C-2 KV
stores are bitwise equal to the reference on numpy inputs from a seed. The
inputs mix scales so that groups hold exponent gaps above 8 (the container
shifts lanes out: MX's loss), zeros of both signs and bf16 subnormals.
The model and the serving paths run C-2 at SMOKE width: logits against the
reference within ``test_torch_model.LOGIT_ATOL``, tokens bit for bit
inside the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ar as AR
import torch_parity as TP
from repro.configs import get_config as jax_get_config
from repro.core import format as jfmt, mx as jmx, packing as jpack
from repro.models import model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core import format as fmt, mx, packing
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC
from repro_torch.serving import scheduler as S

CASS = fmt.CassandraConfig(variant=2)
JCASS = jfmt.CassandraConfig(variant=2)
LOGIT_ATOL = 2e-2          # as tests/test_torch_model.py: a few bf16 ulps
GAMMA, MAX_NEW, PROMPT = 3, 8, 12


def _mx_input(rng, shape, group):
    """bf16 values with per-lane scales 2^-12..2^12 (gaps above 8 inside a
    group), a group of zeros, signed zeros and subnormals."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp2(rng.integers(-12, 13, size=shape)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16))
    flat = x.reshape(-1, shape[-1])
    flat[0, :group] = 0.0
    flat[1, :4] = np.asarray(jnp.asarray([-0.0, 0.0, 1e-39, -3e-40],
                                         jnp.bfloat16))
    return flat.reshape(shape)


def test_clz16_every_value():
    v = np.arange(1 << 16, dtype=np.int32)
    np.testing.assert_array_equal(
        mx._clz16(torch.from_numpy(v)).numpy(),
        np.asarray(jmx._clz16(jnp.asarray(v))))


@pytest.mark.parametrize("shape,group", [((8, 64), 32), ((16, 128), 16),
                                         ((3, 4, 256), 32)])
def test_mx_encode_decode_bitwise(shape, group):
    rng = np.random.default_rng(shape[-1] + group)
    x = _mx_input(rng, shape, group)
    ref = jmx.mx_encode(jnp.asarray(x), group=group)
    enc = mx.mx_encode(TP.to_port(x), group=group)
    TP.assert_bitwise(enc, ref)
    assert enc["m16"].dtype == torch.int16
    for keep_bits in (16, 4, 1):
        TP.assert_bitwise(
            mx.mx_decode(enc, group=group, keep_bits=keep_bits),
            jmx.mx_decode(ref, group=group, keep_bits=keep_bits))
    # exact within a group's 2^8 range: lanes whose gap is at most 8
    back = TP.bits(mx.mx_decode(enc, group=group))
    exp = (TP.bits(x).astype(np.int32) >> 7) & 0xFF
    gap = (exp.reshape(-1, group).max(-1, keepdims=True)
           - exp.reshape(-1, group)).reshape(exp.shape)
    near = (gap <= 8) & (exp > 0)
    np.testing.assert_array_equal(back[near], TP.bits(x)[near])
    assert (back[~near & (exp > 0)] != TP.bits(x)[~near & (exp > 0)]).any()


@pytest.mark.parametrize("width", [5, 12, 16])
def test_wide_code_packing_bitwise(width):
    """C-2's sign|draft codes (5 bits) and low containers (12 bits) pack
    and unpack a byte of code bits at a time, as the reference's words."""
    from repro.core import bitops as jbit
    from repro_torch.core import bitops
    rng = np.random.default_rng(width)
    codes = rng.integers(0, 1 << width, size=(3, 5, 37)).astype(np.int32)
    pw = bitops.pack_codes(torch.from_numpy(codes), width)
    TP.assert_bitwise(pw, jbit.pack_codes(jnp.asarray(codes.astype(
        np.uint32)), width))
    np.testing.assert_array_equal(bitops.unpack_codes(pw, width, 37).numpy(),
                                  codes)


@pytest.mark.parametrize("draft_bits", [3, 4])
def test_pack_unpack_draft_bitwise(draft_bits):
    rng = np.random.default_rng(draft_bits)
    x = _mx_input(rng, (6, 64), 32)
    ref = jmx.mx_encode(jnp.asarray(x), group=32)
    enc = mx.mx_encode(TP.to_port(x), group=32)
    jp = jmx.pack_draft(ref, draft_bits)
    pp = mx.pack_draft(enc, draft_bits)
    TP.assert_bitwise(pp, jp)
    TP.assert_bitwise(mx.unpack_draft(pp, draft_bits, k=64),
                      jmx.unpack_draft(jp, draft_bits, k=64))


@pytest.mark.parametrize("shape", [(512, 64), (256, 96), (1024, 40)])
def test_format_weight_c2_leaves_and_views(shape):
    rng = np.random.default_rng(shape[1])
    w = _mx_input(rng, shape, 32)
    jspec, jverif = jfmt.format_weight(jnp.asarray(w), None, JCASS)
    spec, verif = fmt.format_weight(TP.to_port(w), None, CASS)
    TP.assert_bitwise(spec, jspec)
    TP.assert_bitwise(verif, jverif)
    assert sorted(spec) == ["bitmap", "shared_exp", "signmant"]
    assert sorted(verif) == ["mant_lo", "pruned_raw"]
    TP.assert_bitwise(fmt.draft_weight(spec, CASS, shape),
                      jfmt.draft_weight(jspec, JCASS, shape))
    TP.assert_bitwise(fmt.target_weight(spec, verif, CASS, shape),
                      jfmt.target_weight(jspec, jverif, JCASS, shape))


def test_c2_weight_row_chunks(monkeypatch):
    rng = np.random.default_rng(9)
    shape = (256, 80)
    w = _mx_input(rng, shape, 32)
    spec, verif = fmt.format_weight(TP.to_port(w), None, CASS)
    whole = (fmt.draft_weight(spec, CASS, shape),
             fmt.target_weight(spec, verif, CASS, shape))
    monkeypatch.setattr(fmt, "ROW_CHUNK", 24)          # ragged last chunk
    TP.assert_bitwise(fmt.draft_weight(spec, CASS, shape), whole[0])
    TP.assert_bitwise(fmt.target_weight(spec, verif, CASS, shape), whole[1])


@pytest.mark.parametrize("d", [64, 128])
def test_format_kv_c2_and_store(d):
    rng = np.random.default_rng(d)
    kv = _mx_input(rng, (2, 5, 2, d), 16)
    jsp, jvf = jfmt.format_kv(jnp.asarray(kv), JCASS)
    sp, vf = fmt.format_kv(TP.to_port(kv), CASS)
    TP.assert_bitwise((sp, vf), (jsp, jvf))
    assert fmt.kv_group(CASS, d) == 16
    TP.assert_bitwise(fmt.draft_kv(sp, CASS, d), jfmt.draft_kv(jsp, JCASS, d))
    TP.assert_bitwise(fmt.target_kv(sp, vf, CASS, d),
                      jfmt.target_kv(jsp, jvf, JCASS, d))
    book = JKC.default_kv_codebook()
    ref = JKC.encode_store(JCASS, jnp.asarray(kv), d, book)
    out = KC.encode_store(CASS, TP.to_port(kv), d, KC.default_kv_codebook())
    TP.assert_bitwise(out, ref)
    for view in ("draft", "target"):
        TP.assert_bitwise(
            KC.read_store(CASS, out, d, view, KC.default_kv_codebook()),
            JKC.read_store(JCASS, ref, d, view, book))


@pytest.mark.parametrize("paged", [False, True])
def test_c2_cache_specs_match_reference(paged):
    cfg = get_config("llama3-8b", smoke=True)
    jcfg = jax_get_config("llama3-8b", smoke=True)
    if paged:
        spec = KC.paged_cache_specs(cfg, CASS, 2, 9, 4, 5, packed=True)
        jspec = JKC.paged_cache_specs(jcfg, JCASS, 2, 9, 4, 5, packed=True)
    else:
        spec = KC.cache_specs(cfg, CASS, 2, 24, packed=True)
        jspec = JKC.cache_specs(jcfg, JCASS, 2, 24, packed=True)
    store = spec["dec"][0]["e0"]["k"]
    jstore = jspec["dec"][0]["e0"]["k"]
    for z in ("spec", "verif"):
        assert sorted(store[z]) == sorted(jstore[z])
        for k, (shape, _) in store[z].items():
            assert shape == tuple(jstore[z][k].shape), (z, k)
    cache = (KC.init_paged_cache(cfg, CASS, 2, 9, 4, 5, packed=True,
                                 device="cpu") if paged else
             KC.init_cache(cfg, CASS, 2, 24, packed=True, device="cpu"))
    assert cache["dec"][0]["e0"]["v"]["verif"]["pruned_raw"].dtype == \
        torch.int16


# ---------------------------------------------------------------------------
# SMOKE model and serving paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def c2():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jcass = jfmt.CassandraConfig(variant=2, gamma=GAMMA)
    cass = fmt.CassandraConfig(variant=2, gamma=GAMMA)
    jplain = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpacked = jpack.format_params(jplain, jcass)
    cfg = get_config("llama3-8b", smoke=True)
    rng = np.random.default_rng(2)
    yield {"jcfg": jcfg, "jcass": jcass, "jpacked": jpacked, "cfg": cfg,
           "cass": cass, "packed": packing.format_params(TP.to_port(jplain),
                                                         cass),
           "prompts": rng.integers(0, jcfg.vocab_size,
                                   (3, PROMPT)).astype(np.int32),
           "step": rng.integers(0, jcfg.vocab_size,
                                (3, GAMMA + 1)).astype(np.int32)}
    torch.set_num_threads(n)


def test_c2_format_params_tree(c2):
    TP.assert_bitwise(c2["packed"], TP.to_port(c2["jpacked"]))
    nb, jnb = packing.params_nbytes(c2["packed"]), \
        jpack.params_nbytes(c2["jpacked"])
    assert {k: nb[k] for k in jnb} == jnb and nb["kernel"] == 0


def test_c2_logits_match_reference(c2):
    """Prefill (target view), then one draft-view and one target-view
    decode step from the same packed cache, in both packages."""
    b, s_max = 3, PROMPT + GAMMA + 2
    jrt = JRuntime(cfg=c2["jcfg"], cass=c2["jcass"], view="target")
    rt = Runtime(cfg=c2["cfg"], cass=c2["cass"], view="target")
    jlg, jcache = JM.forward_prefill(
        jrt, c2["jpacked"], {"tokens": jnp.asarray(c2["prompts"])},
        JKC.init_cache(c2["jcfg"], c2["jcass"], b, s_max, packed=True))
    with torch.inference_mode():
        lg, _ = M.forward_prefill(
            rt, c2["packed"], {"tokens": torch.from_numpy(c2["prompts"])},
            KC.init_cache(c2["cfg"], c2["cass"], b, s_max, packed=True,
                          device="cpu"))
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jlg), atol=LOGIT_ATOL)
    # the same packed cache on both sides: the reference's, carried across
    for view, step in (("draft", c2["step"][:, :1]), ("target", c2["step"])):
        jl, _ = JM.forward_decode(dataclasses.replace(jrt, view=view),
                                  c2["jpacked"], jnp.asarray(step), jcache)
        with torch.inference_mode():
            pl, _ = M.forward_decode(dataclasses.replace(rt, view=view),
                                     c2["packed"], torch.from_numpy(step),
                                     TP.to_port(jcache))
        np.testing.assert_allclose(TP.f32(pl), TP.f32(jl), atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def c2_engine(c2):
    eng = E.Engine(c2["cfg"], c2["packed"], cass=c2["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu")
    spec, st = eng.generate({"tokens": torch.from_numpy(c2["prompts"])},
                            MAX_NEW)
    return eng, spec.numpy()[:, :MAX_NEW], st


def test_c2_engine_spec_equals_ar_at_verify_width(c2, c2_engine):
    """Losslessness inside the port: speculative tokens == greedy decode of
    the C-2 target view (AR steps at the verify width), bit for bit."""
    eng, spec, st = c2_engine
    ar, _ = AR.ar_steps(eng, torch.from_numpy(c2["prompts"]), MAX_NEW,
                        GAMMA + 1)
    np.testing.assert_array_equal(spec, ar.numpy())
    assert st["draft_passes"] > 0


def _serve(c2, **kw):
    args = dict(num_slots=3, s_max=PROMPT + MAX_NEW + GAMMA + 1,
                block_size=4, chunk_size=8)
    args.update(kw)
    sched = S.Scheduler(c2["cfg"], c2["packed"], cass=c2["cass"],
                        ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                        **args)
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in c2["prompts"]]
    sched.run()
    return np.array([r.output for r in reqs])


def test_c2_scheduler_paths_bitwise(c2, c2_engine):
    """paged == slot == Engine.generate, overlap on == off, fused ==
    alternating, bit for bit; the packed attention kernel refuses C-2."""
    base = _serve(c2, paged=True)
    np.testing.assert_array_equal(base, c2_engine[1])
    for kw in (dict(paged=False), dict(paged=True, overlap=False),
               dict(paged=True, fused=False)):
        np.testing.assert_array_equal(_serve(c2, **kw), base, err_msg=str(kw))
    with pytest.raises(ValueError, match="exp_words"):
        _serve(c2, paged=True, attn_kernel="on")


def _nan_pruned(verif: dict, rng) -> dict:
    """Raw NaN (two payloads), inf, -0, the smallest subnormals among the
    pruned values, which every view moves as 16-bit patterns."""
    pr = np.array(verif["pruned_raw"]).view(np.uint16).copy()
    if pr.size:
        special = np.array([0x7FC1, 0xFF81, 0x7F80, 0x8000, 0x0001, 0x8001],
                           np.uint16)
        hit = rng.random(pr.shape) < 0.15
        pr[hit] = special[rng.integers(0, 6, pr.shape)][hit]
    dtype = np.asarray(verif["pruned_raw"]).dtype
    return {**verif, "pruned_raw": jnp.asarray(pr.view(dtype))}


@pytest.mark.parametrize("draft_bits", [3, 4])
@pytest.mark.parametrize("prune", [0.4, 0.0])
@pytest.mark.parametrize("kind", ["weight", "kv"])
def test_mx_view_chain_matches_reference(kind, prune, draft_bits):
    """The C-2 views that ``mx_view`` is held to (on CPU tensors, the chain
    ``mx_view_plain``) bit for bit against the reference's draft_tensor /
    target_tensor on the same packed leaves: weights and KV stores, values
    with exponent gaps above 8, +-0 and subnormals, NaN payloads among the
    pruned values, keep == block (prune 0), 4- and 5-bit sign|draft codes;
    the f32 draft view is the reference's bf16 view widened."""
    from repro_torch.kernels import mx_decode as MXD
    jc = jfmt.CassandraConfig(variant=2, mx_draft_bits=draft_bits,
                              weight_prune=prune, kv_prune=prune)
    rng = np.random.default_rng(int(prune * 10) + 3 * draft_bits
                                + len(kind))
    if kind == "weight":
        shape = (1024, 40)
        jspec, jverif = jfmt.format_weight(
            jnp.asarray(_mx_input(rng, shape, 32)), None, jc)
        block = jc.weight_block(shape[0])
        keep, group, trunc, n = (jc.weight_keep(block), jc.mx_group,
                                 jc.weight_trunc, shape[0])
    else:
        d = 128
        jspec, jverif = jfmt.format_kv(
            jnp.asarray(_mx_input(rng, (2, 5, 2, d), 16)), jc)
        block, keep, group, trunc, n = (d, jc.kv_keep(d),
                                        jfmt.kv_group(jc, d), jc.kv_trunc, d)
    assert (keep == block) == (prune == 0.0)
    jverif = _nan_pruned(jverif, rng)
    spec, verif = TP.to_port(jspec), TP.to_port(jverif)
    kw = dict(block=block, keep=keep, group=group, draft_bits=draft_bits)
    jdraft = jfmt.draft_tensor(jspec, jc, block, keep, group, trunc, n)
    before = MXD.mx_view.launches
    TP.assert_bitwise(MXD.mx_view(spec, None, **kw), jdraft)
    # the reference's select rewrites a NaN's payload (0x7FC0 / 0xFFC0);
    # the port moves every pruned value as its raw 16-bit pattern
    got = TP.bits(MXD.mx_view(spec, verif, **kw))
    ref = TP.bits(jfmt.target_tensor(jspec, jverif, jc, block, keep, group,
                                     trunc, n))
    nan = (ref & 0x7F80) == 0x7F80
    nan &= (ref & 0x7F) != 0
    np.testing.assert_array_equal(got[~nan], ref[~nan])
    assert (nan.any() if prune else True)
    raw = {int(v) for v in TP.bits(verif["pruned_raw"]).ravel()}
    assert all(int(v) in raw and (v & 0x7F80) == 0x7F80 and v & 0x7F
               for v in got[nan])
    f32 = MXD.mx_view(spec, None, **kw, dtype=torch.float32)
    np.testing.assert_array_equal(
        f32.numpy().view(np.uint32),
        np.asarray(jdraft).astype(np.float32).view(np.uint32))
    assert MXD.mx_view.launches == before          # CPU: the plain chain
