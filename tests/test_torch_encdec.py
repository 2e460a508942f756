"""Port vs reference: the encoder-decoder audio family (whisper-medium) and
the vision-frontend backbone (phi-3-vision-4.2b) at SMOKE width on the CPU.

Both packages run on the same weights (the reference's init, carried
across with ``bridge.params_from_numpy``; the reference initialises
biases to 0 and norm scales to 1, which would make whisper's layer norms
and biased projections the identity, so every bias, norm scale and norm
bias is drawn at random first) and the same inputs (tokens and the
frontends' frame / patch embeddings, numpy from a seed).

Tolerances: ``layernorm`` and ``sinusoidal_positions`` to 1e-6 relative
to their scale (the same f32 formulas; XLA's and torch's ``exp`` / ``sin``
/ ``cos`` may round an ulp apart); the encoder output, a bf16 activation,
to a few bf16 ulps at its scale; logits to ``LOGIT_ATOL`` 2e-2, as
``test_torch_model.py`` (bf16 rounds at other places in the two
frameworks); packed weights and KV stores bit for bit. Inside the port the
speculative tokens equal the autoregressive steps at the verify width on
every position (on the CPU the two give the same logits bit for bit).
"""
import contextlib
import dataclasses
import functools
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC
from repro_torch.serving import scheduler as S

ARCHS = ["whisper-medium", "phi-3-vision-4.2b"]
LOGIT_ATOL = 2e-2
B, S_PROMPT, GAMMA, MAX_NEW = 2, 12, 3, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(tree, rng, path=""):
    """The reference's numpy tree with every bias (projections' ``b``,
    layer norms' ``bias``) and every norm scale drawn at random."""
    if isinstance(tree, dict):
        return {k: _randomise(v, rng, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, rng, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    if path.endswith(".b"):
        return TP.rand_bf16_np(rng, tree.shape, scale=0.5)
    if path.endswith(".bias"):
        return (0.3 * rng.standard_normal(tree.shape)).astype(np.float32)
    if path.endswith(".scale"):
        return (1.0 + 0.3 * rng.standard_normal(tree.shape)).astype(
            np.float32)
    return tree


def _s_total(cfg, s: int) -> int:
    """Positions a prompt of ``s`` tokens takes in the cache: a vision
    frontend's patches come first."""
    return s + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)


def _embeds_np(cfg, rng, b: int = B) -> dict:
    """The frontend stub's input: frame or patch embeddings, bf16 N(0, 1)."""
    key = "frame_embeds" if cfg.frontend == "audio" else "patch_embeds"
    return {key: TP.rand_bf16_np(rng, (b, cfg.frontend_tokens, cfg.d_model))}


@functools.lru_cache(maxsize=None)
def _model(arch: str) -> dict:
    jcfg = jax_get_config(arch, smoke=True)
    jcass = JCass(variant=1, gamma=GAMMA)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    jinit = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jplain = _randomise(jinit, np.random.default_rng(5))
    jpacked = jpack.format_params(jplain, jcass)
    rng = np.random.default_rng(0)
    extra = _embeds_np(jcfg, rng)
    return {"jcfg": jcfg, "cfg": get_config(arch, smoke=True),
            "jcass": jcass, "cass": cass, "jinit": jinit, "jplain": jplain,
            "plain": TP.to_port(jplain), "jpacked": jpacked,
            "packed": prepare_params(TP.to_port(jpacked), cass),
            "prompt": rng.integers(0, jcfg.vocab_size,
                                   (B, S_PROMPT)).astype(np.int32),
            "step": rng.integers(0, jcfg.vocab_size,
                                 (B, GAMMA + 1)).astype(np.int32),
            "extra": extra}


def _batches(m) -> tuple:
    """(the reference's batch, the port's): tokens and the embeddings."""
    jb = {"tokens": jnp.asarray(m["prompt"]),
          **{k: jnp.asarray(v) for k, v in m["extra"].items()}}
    pb = {"tokens": torch.from_numpy(m["prompt"]),
          **{k: TP.to_port(v) for k, v in m["extra"].items()}}
    return jb, pb


@functools.lru_cache(maxsize=None)
def _engine(arch: str):
    m = _model(arch)
    _, batch = _batches(m)
    eng = E.Engine(m["cfg"], m["packed"], cass=m["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu")
    spec, st = eng.generate(batch, MAX_NEW)
    return eng, spec.numpy(), st


def _close(got, want, ulps: int = 6) -> None:
    """Within a few bf16 ulps (2^-8 relative each) at the result's scale."""
    scale = float(np.abs(TP.f32(want)).max())
    np.testing.assert_allclose(TP.f32(got), TP.f32(want),
                               atol=ulps * 2 ** -8 * max(scale, 1.0))


# ---------------------------------------------------------------------------
# Configs, layers and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))


def test_layernorm_matches_reference():
    """``layernorm`` (and ``norm`` on a tree with a bias) against the
    reference's on f32 and bf16 rows with an offset, random scale and
    bias: the population variance, within 1e-6 relative (f32) and
    bit for bit after the bf16 cast but for an ulp."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 96)) * 3 + 5).astype(np.float32)
    p = {"scale": (1 + 0.3 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.5 * rng.standard_normal(96)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(JL.layernorm(jp, jnp.asarray(x), 1e-5))
    got = L.layernorm(tp, torch.from_numpy(x), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the unbiased variance would be off by (n / (n - 1)) ** 0.5
    unbiased = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, ddof=1, keepdims=True) + 1e-5) * p["scale"] + p["bias"]
    assert np.abs(unbiased - want).max() > 1e-3
    xb = TP.rand_bf16_np(rng, (4, 5, 96), scale=2.0)
    cfg = get_config("whisper-medium", smoke=True)
    jcfg = jax_get_config("whisper-medium", smoke=True)
    got = L.norm(Runtime(cfg=cfg), tp, TP.to_port(xb))
    want = JL.norm(JRuntime(cfg=jcfg), jp, jnp.asarray(xb))
    _close(got, want, ulps=1)


@pytest.mark.parametrize("n,d", [(32, 128), (1500, 1024)])
def test_sinusoidal_positions_match_reference(n, d):
    """Whisper's encoder positions at SMOKE and full width, within 1e-6
    of their scale (1) where the angle's own rounding allows: at position
    p an ulp of the inverse frequency moves the angle by ~p * 2^-24, so
    the tolerance grows with p (XLA's and torch's ``exp`` may round the
    frequencies an ulp apart)."""
    got = L.sinusoidal_positions(n, d).numpy()
    want = np.asarray(JL.sinusoidal_positions(n, d))
    assert got.shape == want.shape == (n, d) and got.dtype == np.float32
    tol = 1e-6 + np.arange(n, dtype=np.float64)[:, None] * 2.0 ** -23
    assert (np.abs(got - want) <= tol).all()
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_distributions(arch):
    """The reference's tree, shapes and dtypes: for whisper the encoder
    groups and ``enc_norm``, layer norms (a ``bias`` beside every norm
    scale), biased projections, ``xattn`` / ``norm_x`` in the decoder and
    the ``pos_embed`` table; for phi-3-vision a plain decoder. Every
    leaf's spread within 5% of the reference's (the draws differ: torch
    vs JAX). ``bridge.params_from_numpy`` carries the reference's whole
    tree (encoder, ``xattn``, norm biases, ``pos_embed``) bit for bit."""
    m = _model(arch)
    ref = m["jinit"]
    cfg = get_config(arch, smoke=True)
    out = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    TP.assert_init_like(out, ref)
    TP.assert_bitwise(m["plain"], m["jplain"])
    audio = cfg.family == "audio"
    assert ("enc" in out) == ("enc_norm" in out) == audio
    assert ("pos_embed" in out) == audio
    e0 = out["dec"][0]["e0"]
    assert ("xattn" in e0) == ("norm_x" in e0) == audio
    assert ("bias" in e0["norm1"]) == ("b" in e0["attn"]["wo"]) == audio
    if audio:
        assert out["pos_embed"]["table"].shape == (
            cfg.max_wavelength_pos + 128, cfg.d_model)
        assert "xattn" not in out["enc"][0]["e0"]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_format_params_packs_as_the_reference(arch, variant):
    """The port's ``format_params`` on the reference's weights gives the
    reference's packed tree bit for bit, Cassandra-1 and -2: the encoder's
    and the cross-attention's matrices and whisper's odd-width lm_head
    pack; biases, norms and every table (``pos_embed`` too) stay plain."""
    m = _model(arch)
    jcass = JCass(variant=variant, gamma=GAMMA)
    cass = CassandraConfig(variant=variant, gamma=GAMMA)
    want = (m["jpacked"] if variant == 1
            else jpack.format_params(m["jplain"], jcass))
    got = packing.format_params(m["plain"], cass)
    TP.assert_bitwise(TP.without_kernel_operands(got), want)
    paths = packing.packed_paths(got)
    assert "lm_head" in paths and all("table" not in p for p in paths)
    if m["cfg"].family == "audio":
        assert {"enc[0].e0.attn.wq", "dec[0].e0.xattn.wk",
                "dec[0].e0.ffn.w_up"} <= set(paths)
        assert not any("norm" in p or "pos_embed" in p for p in paths)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_scopes_get_norms(arch):
    """A calibration forward (``forward_train`` with the embeddings) gives
    every packed weight's path a norm, one row per layer: the encoder's
    blocks observe under ``enc[..]``, cross-attention under ``xattn.*``
    (its ``wk`` / ``wv`` read the encoder output: 32 frames a row). Fed
    the same norms, the reference's ``format_params`` gives the port's
    calibrated tree bit for bit."""
    m = _model(arch)
    _, batch = _batches(m)
    calib = packing.Calibrator()
    with torch.inference_mode():
        M.forward_train(Runtime(cfg=m["cfg"], collector=calib), m["plain"],
                        batch)
    packed = packing.format_params(m["plain"], m["cass"], calib=calib)
    paths = packing.packed_paths(packed)
    jcal = jpack.Calibrator()
    for path in paths:
        norm = calib.act_norm(path)
        assert norm is not None, path
        assert norm.shape[-1] == m["cfg"].d_model or "w_down" in path \
            or path.endswith("wo"), path
        jcal.sq_sums[path] = jnp.asarray(TP.f32(norm) ** 2)
    if m["cfg"].family == "audio":
        nf = m["cfg"].frontend_tokens * B
        assert calib.counts["enc[0].e0.attn.wq"] == m["cfg"].n_layers * nf
        assert calib.counts["dec[0].e0.xattn.wk"] == m["cfg"].n_layers * nf
        assert calib.counts["dec[0].e0.xattn.wq"] == \
            m["cfg"].n_layers * B * S_PROMPT
    jpacked = jpack.format_params(m["jplain"], m["jcass"], calib=jcal)
    pcal = packing.Calibrator()
    pcal.sq_sums = {p: torch.from_numpy(np.array(jcal.sq_sums[p]))
                    for p in paths}
    got = packing.format_params(m["plain"], m["cass"], calib=pcal)
    TP.assert_bitwise(TP.without_kernel_operands(got), jpacked)


# ---------------------------------------------------------------------------
# The model: the encoder, train, prefill and decode logits
# ---------------------------------------------------------------------------

def test_encoder_output_matches_reference():
    """whisper's encoder (frames + sinusoidal positions, non-causal
    blocks, ``enc_norm``) against the reference's within a few bf16 ulps
    at its scale, in the plain and the target view."""
    m = _model("whisper-medium")
    frames = m["extra"]["frame_embeds"]
    for view, jtree, tree in (("plain", m["jplain"], m["plain"]),
                              ("target", m["jpacked"], m["packed"])):
        cass, jcass = (m["cass"], m["jcass"]) if view != "plain" else (
            None, None)
        want = JM._run_encoder(JRuntime(cfg=m["jcfg"], cass=jcass,
                                        view=view), jtree,
                               jnp.asarray(frames))
        got = M._run_encoder(Runtime(cfg=m["cfg"], cass=cass, view=view),
                             tree, TP.to_port(frames))
        assert got.shape == (B, m["cfg"].frontend_tokens, m["cfg"].d_model)
        _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_reference(arch):
    """All positions' logits of the full-sequence pass (frames through
    the encoder, or patches prepended) within ``LOGIT_ATOL``."""
    m = _model(arch)
    jb, pb = _batches(m)
    want, _ = JM.forward_train(JRuntime(cfg=m["jcfg"]), m["jplain"], jb)
    got, aux = M.forward_train(Runtime(cfg=m["cfg"]), m["plain"], pb)
    assert got.shape == (B, _s_total(m["cfg"], S_PROMPT),
                         m["cfg"].vocab_size)
    np.testing.assert_allclose(TP.f32(got), TP.f32(want), atol=LOGIT_ATOL)
    assert int(aux["dropped"]) == 0


@pytest.mark.parametrize("view", ["plain", "draft", "target"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, view):
    """Logits of a prefill and of a verify-width decode (from the
    reference's cache, carried across) against the reference within
    ``LOGIT_ATOL``: the packed prefill's stores and whisper's plain bf16
    cross K/V against the reference's (K/V to a few bf16 ulps: the
    projections round apart), and the decode's logits."""
    m = _model(arch)
    cfg, jcfg = m["cfg"], m["jcfg"]
    packed = view != "plain"
    jtree = m["jpacked"] if packed else m["jplain"]
    tree = m["packed"] if packed else m["plain"]
    jrt = JRuntime(cfg=jcfg, cass=m["jcass"] if packed else None, view=view)
    rt = Runtime(cfg=cfg, cass=m["cass"] if packed else None, view=view)
    s_max = _s_total(cfg, S_PROMPT) + GAMMA + 5
    jb, pb = _batches(m)
    jcache = JKC.init_cache(jcfg, m["jcass"] if packed else None, B, s_max,
                            packed=packed)
    cache = KC.init_cache(cfg, m["cass"] if packed else None, B, s_max,
                          packed=packed, device="cpu")
    jl, jcache = JM.forward_prefill(jrt, jtree, jb, jcache)
    lg, cache = M.forward_prefill(rt, tree, pb, cache)
    assert lg.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
    assert int(cache["length"][0]) == int(jcache["length"][0]) == \
        _s_total(cfg, S_PROMPT)
    if cfg.cross_attention:
        for name in ("ck", "cv"):
            got = cache["cross"][0]["e0"][name]
            assert got.dtype == torch.bfloat16
            _close(got, jcache["cross"][0]["e0"][name])
    else:
        assert "cross" not in cache
    jd, _ = JM.forward_decode(jrt, jtree, jnp.asarray(m["step"]), jcache)
    ld, upd = M.forward_decode(rt, tree, torch.from_numpy(m["step"]),
                               TP.to_port(jcache))
    np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)
    assert sorted(upd[0]["e0"]) == ["k", "v"]
    assert upd[0]["e0"]["k"].shape == (cfg.n_layers, B, GAMMA + 1,
                                       cfg.n_kv_heads, cfg.hd)


def test_audio_decode_keys_by_absolute_position():
    """whisper has no rope, yet its decode places each new key at its
    absolute position: the learned position of a token at position p
    enters its embedding, and a verify pass over γ+1 tokens equals γ+1
    single steps from the same cache on every logit (CPU: bit for bit),
    which only holds when step i's key sits where the pass puts it."""
    eng, _, _ = _engine("whisper-medium")
    m = _model("whisper-medium")
    _, batch = _batches(m)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    assert AR.verify_gap(eng, batch["tokens"], GAMMA, 1, extra) == 0.0


# ---------------------------------------------------------------------------
# The KV codec at head_dim 96 (phi-3-vision's width)
# ---------------------------------------------------------------------------

def test_kv_chain_at_head_dim_96_matches_reference():
    """phi-3-vision SMOKE widened to head_dim 96 (kv_keep(96) = 64): the
    K and V the reference's prefill caches (a plain cache: the raw bf16
    vectors), encoded by the port's plain chain at d = 96 and by the
    reference's (``format_tensor``), give the same stores bit for bit, and
    the port reads both views as the reference does."""
    arch = "phi-3-vision-4.2b"
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), head_dim=96)
    jcass, cass = JCass(variant=1, gamma=GAMMA), CassandraConfig(
        variant=1, gamma=GAMMA)
    assert cass.kv_keep(96) == jcass.kv_keep(96) == 64
    jplain = JM.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    jb = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size,
                                             (B, S_PROMPT))),
          **{k: jnp.asarray(v) for k, v in _embeds_np(jcfg, rng).items()}}
    s_total = _s_total(jcfg, S_PROMPT)
    jcache = JKC.init_cache(jcfg, None, B, s_total, packed=False)
    _, jcache = JM.forward_prefill(JRuntime(cfg=jcfg), jplain, jb, jcache)
    jbook, book = JKC.default_kv_codebook(), KC.default_kv_codebook()
    for name in ("k", "v"):
        x = np.asarray(jax.device_get(jcache["dec"][0]["e0"][name]))
        assert x.shape == (jcfg.n_layers, B, s_total, jcfg.n_kv_heads, 96)
        jstore = JKC.encode_store(jcass, jnp.asarray(x), 96, jbook)
        store = KC.encode_store(cass, TP.to_port(x), 96, book)
        TP.assert_bitwise(store, jstore)
        assert store["spec"]["bitmap"].shape[-1] == 3     # 96 / 32 words
        for view in ("draft", "target"):
            TP.assert_bitwise(KC.read_store(cass, store, 96, view, book),
                              JKC.read_store(jcass, jstore, 96, view, jbook))
        target = KC.read_store(cass, store, 96, "target", book)
        TP.assert_bitwise(target, x)


# ---------------------------------------------------------------------------
# The slice as a whole: the Engine, the refusals, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tokens_equal_verify_width_ar_tokens(arch):
    """Cassandra-1 ``Engine.generate`` with the frontend's embeddings: the
    speculative tokens equal the port's autoregressive steps at the verify
    width on every position, whose logits equal the verify pass's bit for
    bit; every row its tokens."""
    eng, spec, st = _engine(arch)
    m = _model(arch)
    _, batch = _batches(m)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    assert AR.verify_gap(eng, batch["tokens"], GAMMA, GAMMA + 1,
                         extra) == 0.0
    toks, _ = AR.ar_steps(eng, batch["tokens"], MAX_NEW, GAMMA + 1, extra)
    np.testing.assert_array_equal(spec[:, :MAX_NEW], toks.numpy())
    assert st["draft_passes"] == st["cycles"] * GAMMA
    assert (spec[:, :MAX_NEW] >= 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_carries_the_embeddings(arch):
    """``Engine.generate`` feeds the embeddings to the prefill: its first
    token is the argmax of ``forward_prefill``'s logits with them, and
    other embeddings give other first-token logits (they are not dropped).
    whisper's cross K/V are written once, at the prefill: the decode
    passes and commits leave their bits unchanged."""
    eng, spec, _ = _engine(arch)
    m = _model(arch)
    _, batch = _batches(m)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    lg, cache = AR.prefill(eng, batch["tokens"], S_PROMPT + 8, extra)
    np.testing.assert_array_equal(spec[:, 0], torch.argmax(lg, -1).numpy())
    other = {k: TP.to_port(v) for k, v in _embeds_np(
        m["cfg"], np.random.default_rng(99)).items()}
    lg2, _ = AR.prefill(eng, batch["tokens"], S_PROMPT + 8, other)
    assert (lg - lg2).abs().max() > 1e-3
    if m["cfg"].cross_attention:
        before = TP.clone_tree(cache["cross"])
        rt = dataclasses.replace(eng.rt, view="target")
        with torch.inference_mode():
            res, cache = E.spec_decode_step(
                eng.rt, eng.params, cache,
                torch.argmax(lg, -1).to(torch.int32)[:, None], eng.ecfg,
                None)
            lo, upd = M.forward_decode(rt, eng.params,
                                       res.next_token[:, None], cache)
            cache = E.commit(rt, cache, upd, torch.zeros(B, dtype=torch.int32))
        TP.assert_bitwise(cache["cross"], before)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_and_paged_cache_refuse(arch):
    """The reference's refusals: the Scheduler admits token prompts only
    (any frontend), and a paged cache holds no cross-attention stores."""
    m = _model(arch)
    with pytest.raises(NotImplementedError,
                       match="scheduler admission is token-prompt only"):
        S.Scheduler(m["cfg"], m["packed"], cass=m["cass"], device="cpu")
    if m["cfg"].cross_attention:
        with pytest.raises(NotImplementedError, match="paged caches do not "
                           "support cross-attention stores yet"):
            KC.init_paged_cache(m["cfg"], m["cass"], 2, 9, 4, 4, True,
                                device="cpu")
    else:
        cache = KC.init_paged_cache(m["cfg"], m["cass"], 2, 9, 4, 4, True,
                                    device="cpu")
        assert "cross" not in cache


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch):
    """``--arch`` serves both models on the CPU with zero embeddings, as
    the reference's CLI does; ``--scheduler`` raises the reference's
    refusal."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.run(["--arch", arch, "--smoke", "--device", "cpu",
                   "--requests", "2", "--prompt-len", "8", "--max-new",
                   "4"])
    text = out.getvalue()
    assert "[serve] 2 reqs" in text and "first request tokens" in text
    with pytest.raises(NotImplementedError, match="token-prompt only"):
        with contextlib.redirect_stdout(io.StringIO()):
            serve.run(["--arch", arch, "--smoke", "--device", "cpu",
                       "--scheduler", "--requests", "2", "--prompt-len",
                       "8", "--max-new", "4"])
