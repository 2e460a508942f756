"""Port vs reference: the dense GQA family at SMOKE width on the CPU.

qwen3-4b (the paper's second model: ``qk_norm``, tied embeddings),
qwen3-1.7b, qwen2.5-3b (``qkv_bias``, two KV heads, tied), nemotron-4-15b
(the single-branch squared-ReLU FFN) and mistral-large-123b. Both packages
run on the same weights (the reference's init, carried across with
``bridge.params_from_numpy``; the reference initialises biases to 0 and
norm scales to 1, so the tests draw them at random first, or those
features would be the identity) and the same tokens (numpy from a seed).

Tolerances: logits to ``LOGIT_ATOL`` 2e-2, as ``test_torch_model.py``
(bf16 rounds at other places in the two frameworks); activations to 1e-6
relative (the same f32 formula); a layer's K/V and output to a few bf16
ulps at their scale; packed weights bit for bit. Inside the port the
speculative tokens equal the autoregressive steps at the verify width on
every position (on the CPU the two give the same logits bit for bit).
"""
import dataclasses
import functools

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
from repro.models import attention as JA, ffn as JF, layers as JL
from repro.models import model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.models import attention as A, ffn as F, layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC
from repro_torch.serving import scheduler as S

ARCHS = ["qwen3-4b", "qwen3-1.7b", "qwen2.5-3b", "nemotron-4-15b",
         "mistral-large-123b"]
LOGIT_ATOL = 2e-2
B, S_PROMPT, S_MAX, GAMMA, MAX_NEW = 2, 12, 28, 3, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(tree, rng, path=""):
    """The reference's numpy tree with every bias and every attention norm
    scale (q_norm / k_norm) drawn at random."""
    if isinstance(tree, dict):
        return {k: _randomise(v, rng, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, rng, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    if path.endswith(".b"):
        return TP.rand_bf16_np(rng, tree.shape, scale=0.5)
    if path.endswith("_norm.scale"):
        return (1.0 + 0.5 * rng.standard_normal(tree.shape)).astype(
            np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _model(arch: str) -> dict:
    jcfg = jax_get_config(arch, smoke=True)
    jcass = JCass(variant=1, gamma=GAMMA)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    jplain = _randomise(jax.device_get(JM.init_params(
        jcfg, jax.random.PRNGKey(0))), np.random.default_rng(5))
    jpacked = jpack.format_params(jplain, jcass)
    rng = np.random.default_rng(0)
    return {"jcfg": jcfg, "cfg": get_config(arch, smoke=True),
            "jcass": jcass, "cass": cass, "jplain": jplain,
            "plain": TP.to_port(jplain), "jpacked": jpacked,
            "packed": prepare_params(TP.to_port(jpacked), cass),
            "prompt": rng.integers(0, jcfg.vocab_size,
                                   (B, S_PROMPT)).astype(np.int32),
            "step": rng.integers(0, jcfg.vocab_size,
                                 (B, GAMMA + 1)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _engine(arch: str):
    m = _model(arch)
    eng = E.Engine(m["cfg"], m["packed"], cass=m["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu")
    spec, st = eng.generate({"tokens": torch.from_numpy(m["prompt"])},
                            MAX_NEW)
    return eng, spec.numpy(), st


# ---------------------------------------------------------------------------
# Configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_distributions(arch):
    """The reference's tree, shapes and dtypes (a gate only for SwiGLU,
    biases with ``qkv_bias``, q/k norms with ``qk_norm``, no ``lm_head``
    when tied); every weight's spread within 5% of the reference's (the
    draws differ: torch vs JAX)."""
    jcfg = jax_get_config(arch, smoke=True)
    ref = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(1)))
    out = M.init_params(get_config(arch, smoke=True),
                        torch.Generator().manual_seed(1), device="cpu")

    TP.assert_init_like(out, ref)
    cfg = get_config(arch, smoke=True)
    assert ("lm_head" in out) == (not cfg.tie_embeddings)
    assert ("w_gate" in out["dec"][0]["e0"]["ffn"]) == (
        cfg.ffn_act == "swiglu")


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-3b",
                                  "nemotron-4-15b"])
def test_format_params_packs_as_the_reference(arch):
    """The port's ``format_params`` on the reference's weights gives the
    reference's packed tree bit for bit: the tied table, biases and norms
    stay plain, every projection (no gate for relu2) is packed."""
    m = _model(arch)
    got = packing.format_params(m["plain"], m["cass"])

    TP.assert_bitwise(TP.without_kernel_operands(got), m["jpacked"])
    paths = packing.packed_paths(got)
    assert all("table" not in p for p in paths)
    assert ("lm_head" in paths) == (not m["cfg"].tie_embeddings)


# ---------------------------------------------------------------------------
# Layers: activations, qk_norm, qkv_bias, the tied unembed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["swiglu", "relu2", "gelu"])
def test_act_fn_matches_reference(name):
    """``act_fn`` against the reference's on the same f32 inputs: GELU is
    jax.nn.gelu's default, the tanh approximation."""
    x = np.random.default_rng(6).standard_normal((64, 33)).astype(
        np.float32) * 4
    got = L.act_fn(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(JL.act_fn(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        L.act_fn("tanh")


@pytest.mark.parametrize("arch", ["nemotron-4-15b"])
def test_single_branch_mlp_matches_reference(arch):
    """nemotron's relu2 FFN (no gate) on layer 0's weights, plain and
    target views, against the reference within a few bf16 ulps."""
    m = _model(arch)
    x = TP.rand_bf16_np(np.random.default_rng(7), (2, 5, m["cfg"].d_model))
    for view, jtree, tree in (("plain", m["jplain"], m["plain"]),
                              ("target", m["jpacked"], m["packed"])):
        cass, jcass = (m["cass"], m["jcass"]) if view != "plain" else (
            None, None)
        jp = jax.tree.map(lambda a: a[0], jtree["dec"][0]["e0"]["ffn"])
        p = M._index(tree["dec"][0]["e0"]["ffn"], 0)
        assert "w_gate" not in p
        got = F.mlp(Runtime(cfg=m["cfg"], cass=cass, view=view), p,
                      TP.to_port(x))
        want = JF.mlp(JRuntime(cfg=m["jcfg"], cass=jcass, view=view), jp,
                      jnp.asarray(x))
        scale = float(np.abs(TP.f32(want)).max())
        np.testing.assert_allclose(TP.f32(got), TP.f32(want),
                                   atol=2 ** -6 * max(scale, 1.0))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-3b"])
def test_attention_features_match_reference(arch):
    """Layer 0's GQA attention over a prompt, on the randomised weights:
    qwen3-4b's ``qk_norm`` (random q/k norm scales, applied per head
    before rope) and qwen2.5-3b's ``qkv_bias`` (random biases): the new
    K and V and the layer output against the reference's within a few
    bf16 ulps at their scale."""
    m = _model(arch)
    cfg = m["cfg"]
    assert cfg.qk_norm == (arch == "qwen3-4b")
    assert cfg.qkv_bias == (arch == "qwen2.5-3b")
    x = TP.rand_bf16_np(np.random.default_rng(8), (2, 7, cfg.d_model))
    pos = np.arange(7, dtype=np.int32)
    jp = jax.tree.map(lambda a: a[0], m["jplain"]["dec"][0]["e0"]["attn"])
    p = M._index(m["plain"]["dec"][0]["e0"]["attn"], 0)
    jout, jkv = JA.gqa_attention(JRuntime(cfg=m["jcfg"]), jp, jnp.asarray(x),
                                 jnp.asarray(pos))
    out, kv = A.gqa_attention(Runtime(cfg=cfg), p, TP.to_port(x),
                              torch.from_numpy(pos))
    for got, want in ((out, jout), (kv[0], jkv[0]), (kv[1], jkv[1])):
        scale = float(np.abs(TP.f32(want)).max())
        np.testing.assert_allclose(TP.f32(got), TP.f32(want),
                                   atol=2 ** -6 * max(scale, 1.0))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-3b"])
def test_tied_unembed_matches_reference(arch):
    """A tied model has no ``lm_head``: its logits are x @ the embedding
    table^T (bf16, never packed), as the reference's ``unembed``; the
    calibrator observes the input under ``lm_head``."""
    m = _model(arch)
    assert m["cfg"].tie_embeddings and "lm_head" not in m["packed"]
    x = TP.rand_bf16_np(np.random.default_rng(9), (2, 3, m["cfg"].d_model))
    calib = packing.Calibrator()
    got = L.unembed(Runtime(cfg=m["cfg"], collector=calib), m["packed"],
                    TP.to_port(x))
    want = JL.unembed(JRuntime(cfg=m["jcfg"]), m["jpacked"], jnp.asarray(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(TP.f32(got), TP.f32(want), atol=LOGIT_ATOL)
    assert calib.act_norm("lm_head").shape == (m["cfg"].d_model,)


# ---------------------------------------------------------------------------
# The model: prefill and decode logits in the three views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("view", ["plain", "draft", "target"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, view):
    """Logits of a prefill and of a verify-width decode (from the
    reference's cache, carried across) against the reference, within
    ``LOGIT_ATOL``; the packed prefill commit bit for bit."""
    m = _model(arch)
    packed = view != "plain"
    jtree = m["jpacked"] if packed else m["jplain"]
    tree = m["packed"] if packed else m["plain"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m["jcass"] if packed else None,
                   view=view)
    rt = Runtime(cfg=m["cfg"], cass=m["cass"] if packed else None, view=view)
    jcache = JKC.init_cache(m["jcfg"], m["jcass"] if packed else None, B,
                            S_MAX, packed=packed)
    cache = KC.init_cache(m["cfg"], m["cass"] if packed else None, B, S_MAX,
                          packed=packed, device="cpu")
    jl, jcache = JM.forward_prefill(jrt, jtree,
                                    {"tokens": jnp.asarray(m["prompt"])},
                                    jcache)
    lg, cache = M.forward_prefill(rt, tree,
                                  {"tokens": torch.from_numpy(m["prompt"])},
                                  cache)
    assert lg.shape == (B, 1, m["cfg"].vocab_size)
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
    jd, _ = JM.forward_decode(jrt, jtree, jnp.asarray(m["step"]), jcache)
    ld, upd = M.forward_decode(rt, tree, torch.from_numpy(m["step"]),
                               TP.to_port(jcache))
    np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)
    assert upd[0]["e0"]["k"].shape == (2, B, GAMMA + 1,
                                       m["cfg"].n_kv_heads, m["cfg"].hd)


# ---------------------------------------------------------------------------
# The slice as a whole: Engine and paged Scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tokens_equal_verify_width_ar_tokens(arch):
    """Cassandra-1 ``Engine.generate``: the speculative tokens equal the
    port's autoregressive steps at the verify width on every position,
    whose logits equal the verify pass's bit for bit."""
    eng, spec, st = _engine(arch)
    prompt = torch.from_numpy(_model(arch)["prompt"])
    assert AR.verify_gap(eng, prompt, GAMMA, GAMMA + 1) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, MAX_NEW, GAMMA + 1)
    np.testing.assert_array_equal(spec[:, :MAX_NEW], toks.numpy())
    assert st["draft_passes"] == st["cycles"] * GAMMA


def _serve(m, **kw):
    sched = S.Scheduler(m["cfg"], m["packed"], cass=m["cass"],
                        ecfg=E.EngineConfig(gamma=GAMMA), num_slots=2,
                        s_max=S_PROMPT + MAX_NEW + GAMMA + 1, paged=True,
                        block_size=4, chunk_size=4, device="cpu", **kw)
    prompts = list(m["prompt"]) + [m["prompt"][0][:7]]
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in prompts]
    sched.run()
    assert all(len(r.output) == MAX_NEW for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-3b"])
def test_paged_scheduler_equals_engine(arch):
    """The paged ``Scheduler`` with the attention kernels on (their plain
    versions on the CPU): three requests over two slots give the Engine's
    tokens for the first two, and the same tokens with the overlap
    pipeline off and with the kernels off."""
    _, spec, _ = _engine(arch)
    m = _model(arch)
    on = _serve(m, attn_kernel="on")
    assert on[:B] == spec[:, :MAX_NEW].tolist()
    assert _serve(m, attn_kernel="on", overlap=False) == on
    assert _serve(m) == on
