"""Port vs reference: top-k MoE (DBRX, DeepSeek-V3's routed layers) at
SMOKE width on the CPU.

Both packages run on the same weights (the reference's init, carried
across with ``bridge.params_from_numpy``) and the same inputs (numpy from
a seed). What is integer is compared exactly: the capacity, each token's
experts (``top_e``), which token fills each (expert, slot) of the dispatch
buffer (the gathered buffers bit for bit), the drop count and the per-
expert load. What is float is compared within a tolerance: the expert
products and the combine (bf16 products summed in another order by the
two frameworks: a few bf16 ulps at the output's scale), the balance loss
(rtol 1e-5, f32 means) and the model's logits (``LOGIT_ATOL`` 2e-2, as
``test_torch_model.py``).

Capacity couples rows: past an expert's C slots, what else rides in the
batch decides whose tokens are dropped (reference
``serving/engine.py:432-439``). The losslessness and serving gates run at
``moe_capacity_factor = n_experts / n_experts_per_tok``, where C exceeds
the tokens of any batch and nothing is dropped; the drop counts at the
default 1.25 are held to the reference's on identical inputs.
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
from repro.models import ffn as JF, model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.models import ffn as F, model as M
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC
from repro_torch.serving import scheduler as S

ARCHS = ["dbrx-132b", "deepseek-v3-671b"]
LOGIT_ATOL = 2e-2
B, S_PROMPT, S_MAX, GAMMA, MAX_NEW = 2, 12, 28, 3, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch):
    """SMOKE with its routed layers; DeepSeek-V3's rope widened to 32 so
    its latent caches pack under Cassandra-1 (as ``test_torch_mla.py``)."""
    cfg = get(arch, smoke=True)
    return dataclasses.replace(cfg, qk_rope_dim=32) if cfg.mla else cfg


def _no_overflow(cfg) -> dict:
    """Runtime fields at which no expert's capacity can overflow."""
    return {"moe_capacity_factor": cfg.n_experts / cfg.n_experts_per_tok}


@functools.lru_cache(maxsize=None)
def _model(arch: str) -> dict:
    jcfg = _cfg(jax_get_config, arch)
    jcass = JCass(variant=1, gamma=GAMMA)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    jfull = jax.device_get(jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    jplain = {k: v for k, v in jfull.items() if k != "mtp"}
    jpacked = jpack.format_params(jplain, jcass)
    rng = np.random.default_rng(0)
    return {"jcfg": jcfg, "cfg": _cfg(get_config, arch), "jcass": jcass,
            "cass": cass, "jfull": jfull, "jplain": jplain,
            "plain": TP.to_port(jplain), "jpacked": jpacked,
            "packed": prepare_params(TP.to_port(jpacked), cass),
            "prompt": rng.integers(0, jcfg.vocab_size,
                                   (B, S_PROMPT)).astype(np.int32)}


def _moe_layer(m, tree="plain"):
    """The first routed layer's ``moe`` params of both packages."""
    gi = len(m["plain"]["dec"]) - 1
    jt = m["j" + tree]["dec"][gi]["e0"]["moe"]
    return (jax.tree.map(lambda a: a[0], jt),
            M._index(m[tree]["dec"][gi]["e0"]["moe"], 0))


def _ref_route(cfg, jp, x):
    """The reference ``moe``'s routing, op for op: (probs, top_p, top_e)."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    rprobs = jax.nn.softmax(jnp.dot(xt.astype(jnp.float32),
                                    jp["router"]["w"].astype(jnp.float32)),
                            axis=-1)
    top_p, top_e = jax.lax.top_k(rprobs, cfg.n_experts_per_tok)
    return np.asarray(rprobs), np.asarray(top_p), np.asarray(top_e)


def _capture(module, monkeypatch):
    """Record every dispatch buffer and expert output of ``module``'s
    ``moe`` (its ``_batched_expert_mlp``)."""
    seen = []
    inner = module._batched_expert_mlp

    def spy(rt, p, xs):
        out = inner(rt, p, xs)
        seen.append((xs, out))
        return out

    monkeypatch.setattr(module, "_batched_expert_mlp", spy)
    return seen


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def test_moe_capacity_matches_reference():
    for t in (1, 7, 8, 16, 24, 100, 4096):
        for e, k in ((4, 2), (16, 4), (256, 8)):
            for factor in (1.0, 1.25, 2.0, e / k):
                assert F.moe_capacity(t, e, k, factor) == \
                    JF.moe_capacity(t, e, k, factor)
    assert F.moe_capacity(16, 16, 4, 4.0) >= 16


@pytest.mark.parametrize("factor", ["default", "no_overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, factor, monkeypatch):
    """One routed layer on the same bf16 input (4 x 6 tokens sharing one
    direction, so the router is skewed): ``top_e``
    exactly (the smallest top-k margin printed), the dispatch buffer bit
    for bit (which token fills each expert slot, the padded zero rows
    included), ``dropped`` and ``load`` exactly, the expert outputs and
    the combined output within a few bf16 ulps, ``balance_loss`` within
    rtol 1e-5. At the default factor 1.25 tokens are dropped; at
    ``n_experts / n_experts_per_tok`` none are."""
    m = _model(arch)
    cfg, jcfg = m["cfg"], m["jcfg"]
    extra = {} if factor == "default" else _no_overflow(cfg)
    jp, p = _moe_layer(m)
    # a direction every token shares skews the router, so the default
    # capacity overflows
    rng = np.random.default_rng(11)
    x = TP.rand_bf16_np(rng, (4, 6, cfg.d_model)) + np.asarray(
        TP.rand_bf16_np(rng, (cfg.d_model,), scale=2.0))
    rprobs, jtop_p, jtop_e = _ref_route(jcfg, jp, x)
    _, top_p, top_e = F._route(cfg, p, TP.to_port(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(top_e.numpy(), jtop_e)
    srt = -np.sort(-rprobs, axis=-1)
    k = cfg.n_experts_per_tok
    print(f"{arch}: smallest top-{k} margin "
          f"{float((srt[:, k - 1] - srt[:, k]).min()):.3g}")

    jseen, seen = _capture(JF, monkeypatch), _capture(F, monkeypatch)
    jout, jaux = JF.moe(JRuntime(cfg=jcfg, **extra), jp, jnp.asarray(x))
    out, aux = F.moe(Runtime(cfg=cfg, **extra), p, TP.to_port(x))
    (jin, jexp), (pin, pexp) = jseen[0], seen[0]
    TP.assert_bitwise(pin, jin)
    assert int(aux["dropped"]) == int(jaux["dropped"])
    np.testing.assert_array_equal(aux["load"].numpy(),
                                  np.asarray(jaux["load"]))
    assert (int(aux["dropped"]) > 0) == (factor == "default")
    for got, want in ((pexp, jexp), (out, jout)):
        scale = float(np.abs(TP.f32(want)).max())
        np.testing.assert_allclose(TP.f32(got), TP.f32(want),
                                   atol=2 ** -7 * max(scale, 1.0))
    np.testing.assert_allclose(float(aux["balance_loss"]),
                               float(jaux["balance_loss"]), rtol=1e-5)
    assert aux["dropped"].dtype == torch.int64 and aux["dropped"].ndim == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_moe_reference(arch):
    """The sort-based dispatch against the dense loop over experts, in the
    port and in the reference, when nothing is dropped: the same output
    within a few bf16 ulps (the combine sums the k experts in another
    order); the port's oracle against the reference's oracle likewise."""
    m = _model(arch)
    cfg = m["cfg"]
    jp, p = _moe_layer(m)
    x = TP.rand_bf16_np(np.random.default_rng(12), (2, 5, cfg.d_model))
    rt = Runtime(cfg=cfg, **_no_overflow(cfg))
    out, aux = F.moe(rt, p, TP.to_port(x))
    oracle = F.moe_reference(rt, p, TP.to_port(x))
    joracle = JF.moe_reference(JRuntime(cfg=m["jcfg"]), jp, jnp.asarray(x))
    assert int(aux["dropped"]) == 0
    for got, want in ((out, oracle), (oracle, joracle)):
        scale = float(np.abs(TP.f32(want)).max())
        np.testing.assert_allclose(TP.f32(got), TP.f32(want),
                                   atol=2 ** -7 * max(scale, 1.0))


@pytest.mark.parametrize("view", ["draft", "target"])
def test_moe_packed_shared_expert_matches_reference(view):
    """DeepSeek-V3's routed layer with its packed shared expert (the
    experts and router plain) in the draft and target views, against the
    reference's on the same input: the shared expert runs through the
    draft kernel's plain version or the target view, the experts plain."""
    m = _model("deepseek-v3-671b")
    cfg = m["cfg"]
    jp, p = _moe_layer(m, "packed")
    assert "spec" in p["shared"]["w_up"]["w"]
    assert isinstance(p["experts"]["w_up"]["w"], torch.Tensor)
    x = TP.rand_bf16_np(np.random.default_rng(13), (2, 5, cfg.d_model))
    out, _ = F.moe(Runtime(cfg=cfg, cass=m["cass"], view=view,
                           **_no_overflow(cfg)), p, TP.to_port(x))
    jout, _ = JF.moe(JRuntime(cfg=m["jcfg"], cass=m["jcass"], view=view,
                              **_no_overflow(cfg)), jp, jnp.asarray(x))
    scale = float(np.abs(TP.f32(jout)).max())
    np.testing.assert_allclose(TP.f32(out), TP.f32(jout),
                               atol=2 ** -7 * max(scale, 1.0))


def test_moe_relu2_experts_match_reference():
    """Single-branch experts (DBRX's SMOKE with ``ffn_act="relu2"``: no
    gate in the experts) through both packages' ``moe``."""
    jcfg = dataclasses.replace(jax_get_config("dbrx-132b", smoke=True),
                               ffn_act="relu2")
    cfg = dataclasses.replace(get_config("dbrx-132b", smoke=True),
                              ffn_act="relu2")
    jparams = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(3)))
    jp = jax.tree.map(lambda a: a[0], jparams["dec"][0]["e0"]["moe"])
    assert "w_gate" not in jp["experts"]
    x = TP.rand_bf16_np(np.random.default_rng(14), (2, 4, cfg.d_model))
    out, aux = F.moe(Runtime(cfg=cfg), TP.to_port(jp), TP.to_port(x))
    jout, jaux = JF.moe(JRuntime(cfg=jcfg), jp, jnp.asarray(x))
    assert int(aux["dropped"]) == int(jaux["dropped"])
    scale = float(np.abs(TP.f32(jout)).max())
    np.testing.assert_allclose(TP.f32(out), TP.f32(jout),
                               atol=2 ** -7 * max(scale, 1.0))


# ---------------------------------------------------------------------------
# Params: init and format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_distributions(arch):
    """The reference's tree (its training-only ``mtp`` head aside), shapes
    and dtypes: an f32 router (R, d, E), experts (R, E, in, out), the
    shared expert where the config has one; every weight's spread within
    5% of the reference's (the draws differ: torch vs JAX)."""
    m = _model(arch)
    ref = m["jplain"]
    out = M.init_params(m["cfg"], torch.Generator().manual_seed(1),
                        device="cpu")

    TP.assert_init_like(out, ref)
    moe = out["dec"][-1]["e0"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["experts"]["w_up"]["w"].ndim == 4
    assert ("shared" in moe) == bool(m["cfg"].n_shared_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_format_params_packs_what_the_reference_packs(arch):
    """The port's ``format_params`` on the reference's weights gives the
    reference's packed tree bit for bit: every ``moe.experts.*`` and
    ``moe.router.w`` leaf stays plain, ``moe.shared.*``, the attention and
    ``lm_head`` are packed."""
    m = _model(arch)
    got = packing.format_params(m["plain"], m["cass"])

    TP.assert_bitwise(TP.without_kernel_operands(got), m["jpacked"])
    paths = packing.packed_paths(got)
    assert not [p for p in paths if "experts" in p or "router" in p]
    assert "lm_head" in paths
    moe = got["dec"][-1]["e0"]["moe"]
    assert isinstance(moe["router"]["w"], torch.Tensor)
    assert all(isinstance(v["w"], torch.Tensor)
               for v in moe["experts"].values())
    assert ("dec[1].e0.moe.shared.w_down" in paths) == bool(
        m["cfg"].n_shared_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_observes_the_walks_keys(arch):
    """A calibration forward over the MoE model: every packed weight's path
    (the shared expert's included) has a norm of its input width, one row
    per layer; nothing is observed for the never-packed experts; the
    calibrated format differs from the magnitude one."""
    m = _model(arch)
    calib = packing.Calibrator()
    with torch.inference_mode():
        _, aux = M.forward_train(Runtime(cfg=m["cfg"], collector=calib),
                                 m["plain"],
                                 {"tokens": torch.from_numpy(m["prompt"])})
    packed = packing.format_params(m["plain"], m["cass"], calib=calib)
    paths = packing.packed_paths(packed)
    for path in paths:
        node = packed
        for part in path.replace("[", ".").replace("]", "").split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        bm = node["w"]["spec"]["bitmap"]
        norm = calib.act_norm(path)
        assert norm is not None, path
        assert norm.shape == (*bm.shape[:-3], bm.shape[-2] * bm.shape[-1]
                              * 32), path
    assert not [k for k in calib.sq_sums if "experts" in k]
    if m["cfg"].n_shared_experts:
        mag = packing.format_params(m["plain"], m["cass"])
        key = ("dec", 1, "e0", "moe", "shared", "w_up", "w", "spec",
               "bitmap")
        a, b = packed, mag
        for part in key:
            a, b = a[part], b[part]
        assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_aux_matches_reference(arch):
    """``forward_train`` at the default capacity: the logits within
    ``LOGIT_ATOL`` and the aux summed over the routed layers, drops
    exactly and the balance loss within rtol 1e-3 (its router inputs carry
    the two frameworks' bf16 rounding from the layers before it; on one
    layer's identical input it agrees to 1e-5, above)."""
    m = _model(arch)
    tokens = m["prompt"]
    jl, jaux = JM.forward_train(JRuntime(cfg=m["jcfg"]), m["jfull"],
                                {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        lg, aux = M.forward_train(Runtime(cfg=m["cfg"]), m["plain"],
                                  {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
    assert int(aux["dropped"]) == int(jaux["dropped"]) > 0
    assert aux["dropped"].dtype == torch.int32
    np.testing.assert_allclose(float(aux["balance_loss"]),
                               float(jaux["balance_loss"]), rtol=1e-3)


@pytest.mark.parametrize("view", ["plain", "target"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, view):
    """Logits of a prefill and of a verify-width decode (from the
    reference's cache, carried across) against the reference within
    ``LOGIT_ATOL``, at a capacity that never overflows."""
    m = _model(arch)
    packed = view != "plain"
    extra = _no_overflow(m["cfg"])
    jtree = m["jpacked"] if packed else m["jplain"]
    tree = m["packed"] if packed else m["plain"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m["jcass"] if packed else None,
                   view=view, **extra)
    rt = Runtime(cfg=m["cfg"], cass=m["cass"] if packed else None,
                 view=view, **extra)
    jcache = JKC.init_cache(m["jcfg"], m["jcass"] if packed else None, B,
                            S_MAX, packed=packed)
    cache = KC.init_cache(m["cfg"], m["cass"] if packed else None, B, S_MAX,
                          packed=packed, device="cpu")
    jl, jcache = JM.forward_prefill(jrt, jtree,
                                    {"tokens": jnp.asarray(m["prompt"])},
                                    jcache)
    lg, _ = M.forward_prefill(rt, tree,
                              {"tokens": torch.from_numpy(m["prompt"])},
                              cache)
    np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
    step = np.random.default_rng(2).integers(
        0, m["cfg"].vocab_size, (B, GAMMA + 1)).astype(np.int32)
    jd, _ = JM.forward_decode(jrt, jtree, jnp.asarray(step), jcache)
    ld, _ = M.forward_decode(rt, tree, torch.from_numpy(step),
                             TP.to_port(jcache))
    np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# The slice as a whole: Engine and paged Scheduler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _engine(arch: str):
    m = _model(arch)
    eng = E.Engine(m["cfg"], m["packed"], cass=m["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                   rt_extra=_no_overflow(m["cfg"]))
    spec, st = eng.generate({"tokens": torch.from_numpy(m["prompt"])},
                            MAX_NEW)
    return eng, spec.numpy(), st


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tokens_equal_verify_width_ar_tokens(arch):
    """Cassandra-1 ``Engine.generate`` with the routed layers, at a
    capacity that never overflows: the speculative tokens equal the port's
    autoregressive steps at the verify width on every position, whose
    logits equal the verify pass's bit for bit."""
    eng, spec, st = _engine(arch)
    m = _model(arch)
    assert eng.rt.moe_capacity_factor == _no_overflow(m["cfg"])[
        "moe_capacity_factor"]
    prompt = torch.from_numpy(m["prompt"])
    assert AR.verify_gap(eng, prompt, GAMMA, GAMMA + 1) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, MAX_NEW, GAMMA + 1)
    np.testing.assert_array_equal(spec[:, :MAX_NEW], toks.numpy())
    assert st["draft_passes"] == st["cycles"] * GAMMA


def _serve(m, **kw):
    sched = S.Scheduler(m["cfg"], m["packed"], cass=m["cass"],
                        ecfg=E.EngineConfig(gamma=GAMMA), num_slots=2,
                        s_max=S_PROMPT + MAX_NEW + GAMMA + 1, paged=True,
                        block_size=4, chunk_size=4, device="cpu",
                        rt_extra=_no_overflow(m["cfg"]), **kw)
    prompts = list(m["prompt"]) + [m["prompt"][0][:7]]
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in prompts]
    sched.run()
    assert all(len(r.output) == MAX_NEW for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_scheduler_serving_paths_equal(arch):
    """The paged ``Scheduler`` with the attention kernels on (their plain
    versions on the CPU: ``paged_gqa`` / ``paged_mla``), three requests
    over two slots, at a capacity that never overflows: the first two get
    the Engine's tokens, and overlap on == off, fused == alternating and
    kernels on == off, token for token."""
    _, spec, _ = _engine(arch)
    m = _model(arch)
    on = _serve(m, attn_kernel="on")
    assert on[:B] == spec[:, :MAX_NEW].tolist()
    assert _serve(m, attn_kernel="on", overlap=False) == on
    assert _serve(m, attn_kernel="on", fused=False) == on
    assert _serve(m) == on
