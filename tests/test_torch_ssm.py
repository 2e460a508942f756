"""Port vs reference: the Mamba-1 mixer (falcon-mamba-7b) and the Jamba
hybrid (Mamba, GQA and MoE layers) at SMOKE width on the CPU.

Both packages run on the same weights (the reference's init, carried
across with ``bridge.params_from_numpy``; the reference initialises
``conv_b`` to 0 and ``D`` to 1, so the tests draw them, and ``dt_bias``,
at random first, or those terms would be trivial) and the same tokens
(numpy from a seed).

Tolerances: the causal conv bit for bit (both sum the taps in one order,
rounding each step to bf16); the scan within 1e-5 relative (f32: the
reference combines positions in a tree, the port step by step);
``mamba``'s bf16 output to a few bf16 ulps at its scale and its f32
state to 1e-3 relative (the bf16 projections before it round apart);
logits to ``LOGIT_ATOL`` 2e-2, as ``test_torch_model.py``. What is not
float arithmetic is compared bit for bit: the packed leaves, and the
engine's rollback of the state to each row's accepted position. Inside
the port the speculative tokens equal the autoregressive steps at the
verify width on every position, and the plain model's shape-stable draft
is accepted on every position.

Jamba's MoE layers run at ``moe_capacity_factor = n_experts /
n_experts_per_tok`` wherever tokens are compared: capacity overflow
couples rows (``test_torch_moe.py``).
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
from repro.models import layers as JL, model as JM, ssm as JS
from repro.models.layers import Runtime as JRuntime
from repro.serving import engine as JE, kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.models import model as M, ssm as SS
from repro_torch.models.layers import Runtime
from repro_torch.serving import engine as E, kvcache as KC
from repro_torch.serving import scheduler as S

ARCHS = ["falcon-mamba-7b", "jamba-v0.1-52b"]
LOGIT_ATOL = 2e-2
CHUNK = 8                         # the reference serve's ssm_chunk at --smoke
B, S_PROMPT, S_MAX, GAMMA, MAX_NEW = 2, 12, 28, 3, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extra(cfg) -> dict:
    """The port's Runtime fields of every comparison: for an MoE model a
    capacity that never overflows."""
    if cfg.n_experts:
        return {"moe_capacity_factor": cfg.n_experts / cfg.n_experts_per_tok}
    return {}


def _jextra(cfg) -> dict:
    """The reference's: ``_extra`` and its scan chunk (the port's
    step-by-step recurrence has none)."""
    return {"ssm_chunk": CHUNK, **_extra(cfg)}


def _randomise(tree, rng, path=""):
    """The reference's numpy tree with every ``conv_b``, ``D`` and
    ``dt_bias`` drawn at random."""
    if isinstance(tree, dict):
        return {k: _randomise(v, rng, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, rng, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    if path.endswith(".conv_b"):
        return TP.rand_bf16_np(rng, tree.shape, scale=0.5)
    if path.endswith(".D"):
        return (1.0 + 0.5 * rng.standard_normal(tree.shape)).astype(
            np.float32)
    if path.endswith(".dt_bias"):
        return (tree + 0.5 * rng.standard_normal(tree.shape)).astype(
            np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _model(arch: str) -> dict:
    jcfg = jax_get_config(arch, smoke=True)
    jcass = JCass(variant=1, gamma=GAMMA)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    jplain = _randomise(jax.device_get(jax.jit(
        JM.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(5))
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


def _ssm_layer(m, tree="plain"):
    """Layer 0's ``ssm`` params of both packages."""
    jp = jax.tree.map(lambda a: a[0], m["j" + tree]["dec"][0]["e0"]["ssm"])
    return jp, M._index(m[tree]["dec"][0]["e0"]["ssm"], 0)


def _close_bf16(got, want, ulps=4):
    """Within ``ulps`` bf16 ulps at the reference's scale."""
    scale = float(np.abs(TP.f32(want)).max())
    np.testing.assert_allclose(TP.f32(got), TP.f32(want),
                               atol=ulps * 2 ** -8 * max(scale, 1e-3))


# ---------------------------------------------------------------------------
# Configs, init, packing, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))


def _assert_init_like(port, ref, path="") -> None:
    """``torch_parity.assert_init_like`` with the spread's tolerance set by
    the leaf's size: 5% from 4096 draws on, else 5 standard errors of a
    normal sample's spread, 5 / sqrt(2N) (Jamba's SMOKE leaves hold 256 to
    512 draws, whose spread moves by 3-4% from seed to seed)."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _assert_init_like(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_init_like(p, r, f"{path}[{i}]")
    else:
        assert tuple(port.shape) == ref.shape, path
        assert str(port.dtype).split(".")[-1] == ref.dtype.name, path
        rs = float(np.asarray(ref, np.float32).std())
        ps = float(port.to(torch.float32).std())
        tol = max(0.05, 5 / np.sqrt(2 * ref.size))
        assert abs(ps - rs) <= max(tol * abs(rs), 1e-6), (path, ps, rs)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_distributions(arch):
    """The reference's tree, shapes and dtypes (an ``ssm`` subtree for each
    ``'s'`` entry, no FFN for ``'-'``); every leaf's spread near the
    reference's (``_assert_init_like``; the draws differ: torch vs JAX);
    ``A_log``, ``D`` and ``conv_b`` equal; ``dt_bias`` the inverse softplus
    of a dt log-uniform in [1e-3, 1e-1]: each layer's dt inside the range
    and the mean of its log within 0.25 of the range's midpoint (a layer's
    256 draws put it within ~0.08 of it)."""
    jcfg = jax_get_config(arch, smoke=True)
    ref = jax.device_get(jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1)))
    out = M.init_params(get_config(arch, smoke=True),
                        torch.Generator().manual_seed(1), device="cpu")
    _assert_init_like(out, ref)
    e0, je0 = out["dec"][0]["e0"], ref["dec"][0]["e0"]
    assert "attn" not in e0 and ("ffn" in e0) == ("ffn" in je0)
    for leaf in ("A_log", "D", "conv_b"):
        TP.assert_bitwise(e0["ssm"][leaf], je0["ssm"][leaf])
    mid = (np.log(1e-3) + np.log(1e-1)) / 2
    for g in out["dec"]:
        for e in g.values():
            if "ssm" not in e:
                continue
            assert e["ssm"]["dt_bias"].dtype == torch.float32
            dt = torch.nn.functional.softplus(e["ssm"]["dt_bias"])
            assert 1e-3 * (1 - 1e-5) <= float(dt.min()) \
                <= float(dt.max()) <= 1e-1 * (1 + 1e-5)
            assert (torch.log(dt).mean(-1) - mid).abs().max() < 0.25


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_format_params_packs_as_the_reference(arch, variant):
    """The port's ``format_params`` on the reference's weights gives the
    reference's packed tree bit for bit, in Cassandra-1 and -2: only the
    ``w`` leaves of ``in_proj``, ``x_proj``, ``out_proj`` (``dt_proj``'s
    8 inputs are too few at SMOKE), the attention and dense FFN
    projections and ``lm_head`` are packed; ``conv_w``, ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``, the experts and the router stay as they
    were."""
    m = _model(arch)
    cass, jcass = CassandraConfig(variant=variant), JCass(variant=variant)
    got = packing.format_params(m["plain"], cass)
    TP.assert_bitwise(TP.without_kernel_operands(got),
                      jpack.format_params(m["jplain"], jcass))
    ssm_paths = {p.split(".ssm.")[1] for p in packing.packed_paths(got)
                 if ".ssm." in p}
    assert ssm_paths == {"in_proj", "x_proj", "out_proj"}
    for leaf in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert isinstance(got["dec"][0]["e0"]["ssm"][leaf], torch.Tensor)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_trees_load_from_reference_numpy(arch):
    """The reference's numpy tree crosses the bridge leaf for leaf: the bf16
    projections and conv weights as bf16, ``A_log``, ``D`` and ``dt_bias``
    as f32, every bit kept."""
    m = _model(arch)
    TP.assert_bitwise(m["plain"], m["jplain"])
    p = m["plain"]["dec"][0]["e0"]["ssm"]
    for leaf in ("A_log", "D", "dt_bias"):
        assert p[leaf].dtype == torch.float32
    for leaf in ("conv_w", "conv_b"):
        assert p[leaf].dtype == torch.bfloat16
    assert p["in_proj"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_norms_every_packed_ssm_weight(arch):
    """A calibration forward through the Mamba blocks (``forward_train``
    with a ``Calibrator``): every packed weight's path, the SSM
    projections' included, has a norm of its input width, one row per
    layer; ``dt_proj`` (not packed at SMOKE) is observed all the same."""
    m = _model(arch)
    calib = packing.Calibrator()
    with torch.inference_mode():
        M.forward_train(Runtime(cfg=m["cfg"], collector=calib),
                        m["plain"], {"tokens": torch.from_numpy(m["prompt"])})
    packed = packing.format_params(m["plain"], m["cass"], calib=calib)
    paths = packing.packed_paths(packed)
    assert "dec[0].e0.ssm.in_proj" in paths
    for path in paths:
        node = packed
        for part in path.replace("[", ".").replace("]", "").split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        bm = node["w"]["spec"]["bitmap"]
        norm = calib.act_norm(path)
        assert norm is not None, path
        assert norm.shape == (*bm.shape[:-3],
                              bm.shape[-2] * bm.shape[-1] * 32), path
    assert calib.act_norm("dec[0].e0.ssm.dt_proj").shape == (
        1 if arch.startswith("jamba") else m["cfg"].n_layers,
        m["cfg"].dt_r)


# ---------------------------------------------------------------------------
# The mixer: conv, scan, mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prepend", [False, True])
def test_causal_conv_matches_reference(prepend):
    """The depthwise causal conv, with and without a carried state: its
    output and the new state (a slice of its inputs) bit for bit (both sum
    the taps in the same order, rounding each step to bf16)."""
    rng = np.random.default_rng(11)
    x = TP.rand_bf16_np(rng, (2, 9, 48))
    w = TP.rand_bf16_np(rng, (4, 48), scale=0.5)
    bias = TP.rand_bf16_np(rng, (48,), scale=0.5)
    pre = TP.rand_bf16_np(rng, (2, 3, 48)) if prepend else None
    jy, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias),
                              None if pre is None else jnp.asarray(pre))
    y, st = SS._causal_conv(TP.to_port(x), TP.to_port(w), TP.to_port(bias),
                            None if pre is None else TP.to_port(pre))
    TP.assert_bitwise(y, jy)
    TP.assert_bitwise(st, jst)


@pytest.mark.parametrize("s", [1, 4, 8, 13, 24])
def test_selective_scan_matches_reference(s):
    """The step-by-step recurrence against the reference's chunked
    associative scan at chunk 8, lengths on and off the chunk: y, the final
    h and every position's h within 1e-5 relative; without ``with_states``
    the same y and h, bit for bit."""
    rng = np.random.default_rng(12 + s)
    a = np.exp(-rng.uniform(0.0, 0.5, (2, s, 16, 4))).astype(np.float32)
    b = (0.3 * rng.standard_normal((2, s, 16, 4))).astype(np.float32)
    c = rng.standard_normal((2, s, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 16, 4)).astype(np.float32)
    want = JS._selective_scan(*(jnp.asarray(t) for t in (a, b, c, h0)),
                              CHUNK, with_states=True)
    got = SS._selective_scan(*(torch.from_numpy(t) for t in (a, b, c, h0)),
                             with_states=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(TP.f32(g), TP.f32(w), rtol=1e-5,
                                   atol=1e-6)
    assert torch.equal(got[2][:, -1], got[1])
    y, h, none = SS._selective_scan(
        *(torch.from_numpy(t) for t in (a, b, c, h0)))
    assert none is None and torch.equal(y, got[0]) and torch.equal(h, got[1])


def test_mamba_matches_reference():
    """``mamba`` on layer 0's randomised weights: a 10-token prefill and its
    decode continuation (3 tokens from the prefill's state, ``with_states``
    for ``h_all`` and ``conv_win``). Outputs within a few bf16 ulps at
    their scale, ``h`` and ``h_all`` within 1e-3 relative, the conv state
    and window bit for bit where their inputs agree."""
    m = _model("falcon-mamba-7b")
    jp, p = _ssm_layer(m)
    jrt = JRuntime(cfg=m["jcfg"], ssm_chunk=CHUNK)
    rt = Runtime(cfg=m["cfg"])
    rng = np.random.default_rng(13)
    u = TP.rand_bf16_np(rng, (2, 10, m["cfg"].d_model))
    v = TP.rand_bf16_np(rng, (2, 3, m["cfg"].d_model))
    jout, jst, _ = JS.mamba(jrt, jp, jnp.asarray(u))
    out, st, none = SS.mamba(rt, p, TP.to_port(u))
    assert none is None
    _close_bf16(out, jout)
    _close_bf16(st[0], jst[0])
    np.testing.assert_allclose(TP.f32(st[1]), TP.f32(jst[1]), rtol=1e-3,
                               atol=1e-3 * float(np.abs(TP.f32(jst[1])).max()))
    # the decode continuation from the reference's state
    jd, jdst, jex = JS.mamba(jrt, jp, jnp.asarray(v), state=jst,
                             with_states=True)
    d, dst, ex = SS.mamba(rt, p, TP.to_port(v), state=TP.to_port(jst),
                          with_states=True)
    _close_bf16(d, jd)
    hs = float(np.abs(TP.f32(jex["h_all"])).max())
    np.testing.assert_allclose(TP.f32(ex["h_all"]), TP.f32(jex["h_all"]),
                               rtol=1e-3, atol=1e-3 * hs)
    assert ex["h_all"].shape == (2, 3, m["cfg"].d_inner, m["cfg"].ssm_state)
    assert torch.equal(ex["h_all"][:, -1], dst[1])
    TP.assert_bitwise(ex["conv_win"][:, :3], jst[0])
    _close_bf16(ex["conv_win"], jex["conv_win"])
    assert torch.equal(ex["conv_win"][:, -3:], dst[0])


# ---------------------------------------------------------------------------
# The model: prefill and decode logits in the three views
# ---------------------------------------------------------------------------

def _ref_chain(m, jrt, jtree, tokens, mode, jcache=None):
    """The reference's forward, its blocks applied one by one in Python
    (``model._block`` eagerly, then its final norm and unembed): the
    reference's own arithmetic, without the ``lax.scan`` over the layer
    groups that its ``forward_prefill`` / ``forward_decode`` compile."""
    cfg = m["jcfg"]
    x = JL.embed(jtree["embed"], jnp.asarray(tokens))
    kw = {}
    if mode == "decode":
        length = jcache["length"]
        pos = length[:, None] + jnp.arange(tokens.shape[1])[None]
        kw = dict(length=length, scratch_len=jnp.int32(0),
                  book=JKC.cache_codebook(jcache),
                  s_max=JM._cache_s_max(cfg, jcache))
    else:
        pos = jnp.arange(tokens.shape[1])
    for gi, g in enumerate(JM.layer_groups(cfg)):
        for r in range(g.repeats):
            for j, entry in enumerate(g.entries):
                pick = lambda t: jax.tree.map(lambda a: a[r],
                                              t["dec"][gi][f"e{j}"])
                centry = pick(jcache) if mode == "decode" else None
                x, _, _ = JM._block(jrt, pick(jtree), entry, x, pos,
                                    mode=mode, centry=centry, **kw)
    if mode == "prefill":
        x = x[:, -1:]
    return JL.unembed(jrt, jtree, JL.norm(jrt, jtree["final_norm"], x))


@pytest.mark.parametrize("view", ["plain", "draft", "target"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, view):
    """Logits of a prefill and of a verify-width decode (from the
    reference's cache, carried across) within ``LOGIT_ATOL`` of the
    reference's blocks applied one by one (``_ref_chain``), and for
    falcon-mamba of the reference's ``forward_prefill`` /
    ``forward_decode`` too. Jamba is held to the chain only: on these
    inputs the reference's compiled ``lax.scan`` over its 8-layer period
    differs from its own blocks by up to 0.22 in the decode logits, at a
    routing near-tie (``test_jamba_compiled_reference_gap_is_a_routing_
    tie``; the port's decode equals the chain bit for bit). The prefill's SSM state
    written to the cache: conv within two bf16 ulps at its scale, h
    within 1e-2 relative; the decode's SSM updates {"conv", "h", "h_all",
    "conv_win"} at their shapes."""
    m = _model(arch)
    cfg = m["cfg"]
    packed = view != "plain"
    extra = _extra(cfg)
    jtree = m["jpacked"] if packed else m["jplain"]
    tree = m["packed"] if packed else m["plain"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m["jcass"] if packed else None,
                   view=view, **_jextra(cfg))
    rt = Runtime(cfg=cfg, cass=m["cass"] if packed else None, view=view,
                 **extra)
    jcache = JKC.init_cache(m["jcfg"], m["jcass"] if packed else None, B,
                            S_MAX, packed=packed)
    cache = KC.init_cache(cfg, m["cass"] if packed else None, B, S_MAX,
                          packed=packed, device="cpu")
    jl, jcache = JM.forward_prefill(jrt, jtree,
                                    {"tokens": jnp.asarray(m["prompt"])},
                                    jcache)
    lg, cache = M.forward_prefill(rt, tree,
                                  {"tokens": torch.from_numpy(m["prompt"])},
                                  cache)
    np.testing.assert_allclose(
        TP.f32(lg), TP.f32(_ref_chain(m, jrt, jtree, m["prompt"],
                                      "prefill")), atol=LOGIT_ATOL)
    e, je = cache["dec"][0]["e0"], jcache["dec"][0]["e0"]
    assert e["conv"].dtype == torch.bfloat16 and e["h"].dtype == \
        torch.float32
    _close_bf16(e["conv"], je["conv"], ulps=2)
    hs = float(np.abs(TP.f32(je["h"])).max())
    np.testing.assert_allclose(TP.f32(e["h"]), TP.f32(je["h"]), rtol=1e-2,
                               atol=1e-2 * hs)
    ld, upd = M.forward_decode(rt, tree, torch.from_numpy(m["step"]),
                               TP.to_port(jcache))
    np.testing.assert_allclose(
        TP.f32(ld), TP.f32(_ref_chain(m, jrt, jtree, m["step"], "decode",
                                      jcache)), atol=LOGIT_ATOL)
    if arch == "falcon-mamba-7b":
        np.testing.assert_allclose(TP.f32(lg), TP.f32(jl), atol=LOGIT_ATOL)
        jd, _ = JM.forward_decode(jrt, jtree, jnp.asarray(m["step"]),
                                  jcache)
        np.testing.assert_allclose(TP.f32(ld), TP.f32(jd), atol=LOGIT_ATOL)
    r = cfg.n_layers if cfg.block_pattern == ("s-",) else 1
    u = upd[0]["e0"]
    assert sorted(u) == ["conv", "conv_win", "h", "h_all"]
    assert u["h_all"].shape == (r, B, GAMMA + 1, cfg.d_inner, cfg.ssm_state)
    assert u["conv_win"].shape == (r, B, cfg.ssm_conv + GAMMA, cfg.d_inner)


def test_jamba_compiled_reference_gap_is_a_routing_tie(monkeypatch):
    """Why Jamba's logits are held to ``_ref_chain`` and not to the
    reference's compiled ``forward_decode``: the router's probabilities of
    every MoE call, captured in both (``jax.debug.callback``), differ by
    XLA's fusion, and in the compiled program exactly one token goes to
    another expert pair, one whose 2nd and 3rd experts are within 1e-3.
    The largest logit gap between the two lies in that token's row; the
    port's decode equals the chain bit for bit."""
    from repro.models import ffn as JF
    m = _model("jamba-v0.1-52b")
    cfg = m["cfg"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m["jcass"], view="target",
                   **_jextra(cfg))
    rt = Runtime(cfg=cfg, cass=m["cass"], view="target", **_extra(cfg))
    probs = {"compiled": [], "chain": []}
    where = ["prefill"]
    moe = JF.moe

    def captured(rt_, p, x):
        pr = jax.nn.softmax(jnp.dot(
            x.reshape(-1, x.shape[-1]).astype(jnp.float32),
            p["router"]["w"].astype(jnp.float32)), axis=-1)
        jax.debug.callback(
            lambda a, k=where[0]: probs.setdefault(k, []).append(
                np.asarray(a)), pr)
        return moe(rt_, p, x)

    monkeypatch.setattr(JF, "moe", captured)
    jcache = JKC.init_cache(m["jcfg"], m["jcass"], B, S_MAX, packed=True)
    _, jcache = JM.forward_prefill(jrt, m["jpacked"],
                                   {"tokens": jnp.asarray(m["prompt"])},
                                   jcache)
    where[0] = "compiled"
    jd, _ = JM.forward_decode(jrt, m["jpacked"], jnp.asarray(m["step"]),
                              jcache)
    jax.effects_barrier()
    where[0] = "chain"
    chain = _ref_chain(m, jrt, m["jpacked"], m["step"], "decode", jcache)
    jax.effects_barrier()
    assert len(probs["compiled"]) == len(probs["chain"]) == 4
    flips = []
    for call, (a, b) in enumerate(zip(probs["chain"], probs["compiled"])):
        top = lambda q: np.sort(np.argsort(-q, -1, kind="stable")[:, :2], -1)
        desc = -np.sort(-a, -1)
        for t in np.flatnonzero((top(a) != top(b)).any(-1)):
            flips.append((call, int(t), float(desc[t, 1] - desc[t, 2])))
    assert len(flips) == 1 and flips[0][2] < 1e-3, flips
    gap = np.abs(TP.f32(jd) - TP.f32(chain)).max(-1)          # (B, q)
    assert np.unravel_index(gap.argmax(), gap.shape)[0] == \
        flips[0][1] // (GAMMA + 1)
    ld, _ = M.forward_decode(rt, m["packed"], torch.from_numpy(m["step"]),
                             TP.to_port(jcache))
    TP.assert_bitwise(ld, chain)


@pytest.mark.parametrize("arch", ARCHS)
def test_commit_rolls_back_as_the_reference(arch):
    """``engine.commit`` on the reference's cache and verify-pass updates
    (carried across) with per-row accepted counts: every SSM entry's
    ``h`` and ``conv`` equal the reference's ``commit`` bit for bit (the
    state after n+1 tokens), Jamba's attention stores too, and the
    lengths advance by n+1."""
    m = _model(arch)
    cfg = m["cfg"]
    jrt = JRuntime(cfg=m["jcfg"], cass=m["jcass"], view="target",
                   **_jextra(cfg))
    rt = Runtime(cfg=cfg, cass=m["cass"], view="target", **_extra(cfg))
    jcache = JKC.init_cache(m["jcfg"], m["jcass"], B, S_MAX, packed=True)
    _, jcache = JM.forward_prefill(jrt, m["jpacked"],
                                   {"tokens": jnp.asarray(m["prompt"])},
                                   jcache)
    _, jupd = JM.forward_decode(jrt, m["jpacked"], jnp.asarray(m["step"]),
                                jcache)
    for n in ([2, 0], [3, 1]):
        want = JE.commit(jrt, jcache, jupd, jnp.asarray(n, jnp.int32))
        got = E.commit(rt, TP.to_port(jcache), TP.to_port(jupd),
                       torch.tensor(n, dtype=torch.int32))
        TP.assert_bitwise(got["dec"], want["dec"])
        np.testing.assert_array_equal(got["length"].numpy(),
                                      np.asarray(want["length"]))


# ---------------------------------------------------------------------------
# The slice as a whole: Engine and paged Scheduler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _engine(arch: str):
    m = _model(arch)
    eng = E.Engine(m["cfg"], m["packed"], cass=m["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                   rt_extra=_extra(m["cfg"]))
    spec, st = eng.generate({"tokens": torch.from_numpy(m["prompt"])},
                            MAX_NEW)
    return eng, spec.numpy(), st


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tokens_equal_verify_width_ar_tokens(arch):
    """Cassandra-1 ``Engine.generate`` through the Mamba blocks: the
    speculative tokens equal the port's autoregressive steps at the verify
    width on every position, whose logits equal the verify pass's bit for
    bit (the step-by-step recurrence reaches each position's state as an
    autoregressive step does)."""
    eng, spec, st = _engine(arch)
    prompt = torch.from_numpy(_model(arch)["prompt"])
    assert AR.verify_gap(eng, prompt, GAMMA, GAMMA + 1) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, MAX_NEW, GAMMA + 1)
    np.testing.assert_array_equal(spec[:, :MAX_NEW], toks.numpy())
    assert st["draft_passes"] == st["cycles"] * GAMMA


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_stable_draft_acceptance_is_exact(arch):
    """The plain model (no Cassandra) with the shape-stable draft: each
    draft pass re-feeds the prefix from the committed state at the verify
    width, so it is the verify computation restricted to earlier
    positions and the strict greedy rule accepts every draft (reference
    ``tests/test_serving.py``'s ``test_plain_stable_draft_bitwise_
    acceptance``, which covers the SSM hybrid)."""
    m = _model(arch)
    eng = E.Engine(m["cfg"], m["plain"], cass=None,
                   ecfg=E.EngineConfig(gamma=GAMMA, stable_draft=True),
                   device="cpu", rt_extra=_extra(m["cfg"]))
    _, st = eng.generate({"tokens": torch.from_numpy(m["prompt"])}, 16)
    assert st["acceptance"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_draft_chain_equals_width1_ar(arch):
    """The plain model (no Cassandra) with the scratch draft
    (``stable_draft=False``): one cycle's γ draft tokens and logits equal
    γ autoregressive steps at width 1 from the same prefilled cache, bit
    for bit. Both run the same ops at the same M, so this holds only if
    draft step i reads the ``conv`` and ``h`` that step i-1 left in the
    scratch (``make_scratch``, ``_scratch_write``), as an autoregressive
    step reads the state its commit left."""
    m = _model(arch)
    eng = E.Engine(m["cfg"], m["plain"], cass=None,
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                   rt_extra=_extra(m["cfg"]))
    prompt = torch.from_numpy(m["prompt"])
    toks, logits = AR.ar_steps(eng, prompt, GAMMA + 1, 1)
    with torch.inference_mode():
        _, cache = AR.prefill(eng, prompt, S_PROMPT + GAMMA + 1)
        drafts, dlogits = E._run_drafts(eng.rt, eng.params, cache,
                                        toks[:, :1], eng.ecfg)
    np.testing.assert_array_equal(drafts.numpy(), toks[:, 1:].numpy())
    for i, lg in enumerate(dlogits):
        assert torch.equal(lg.to(torch.float32), logits[:, i + 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_one_pass_on_cpu(arch):
    """The Scheduler's prefill, 4-token chunks through ``chunk_prefill_step``
    into a packed paged cache (attention kernels on: their plain versions
    here), against one ``forward_prefill`` pass: the last logits and every
    SSM entry's ``conv`` and ``h`` bit for bit. The CPU's products round
    each row alike whatever M is, so the chunk boundaries, the carried
    state and the chunk's commit change no bit; on the card the products
    at another M round apart (``chip_smoke.py`` phase 17 holds the chunked
    prefill there to the one-pass one in f32)."""
    m = _model(arch)
    cfg, cass = m["cfg"], m["cass"]
    rt = Runtime(cfg=cfg, cass=cass, view="target", attn_kernel="on",
                 **_extra(cfg))
    prompt = torch.from_numpy(m["prompt"])
    one = KC.init_cache(cfg, cass, B, S_MAX, packed=True, device="cpu")
    paged = KC.init_paged_cache(cfg, cass, B, 2 * 7 + 1, 4, 7, packed=True,
                                device="cpu")
    paged["block_table"] = (1 + torch.arange(2 * 7)).reshape(B, 7).to(
        torch.int32)
    valid = torch.full((B,), 4, dtype=torch.int32)
    with torch.inference_mode():
        lg, one = M.forward_prefill(rt, m["packed"], {"tokens": prompt}, one)
        for c0 in range(0, S_PROMPT, 4):
            last, paged = E.chunk_prefill_step(
                rt, m["packed"], paged, prompt[:, c0:c0 + 4].contiguous(),
                valid)
    assert torch.equal(last, lg[:, -1])
    n_ssm = 0
    for g, gp in zip(one["dec"], paged["dec"]):
        for e, ep in zip(g.values(), gp.values()):
            if KC.is_ssm(e):
                n_ssm += 1
                assert torch.equal(e["conv"], ep["conv"])
                assert torch.equal(e["h"], ep["h"])
    assert n_ssm == (1 if arch == "falcon-mamba-7b" else 7)


def _serve(m, prompts, num_slots=2, **kw):
    """``prompts`` through a paged Scheduler (a slot recycled whenever there
    are more prompts than slots). Returns (each request's tokens, its
    first-token logits)."""
    sched = S.Scheduler(m["cfg"], m["packed"], cass=m["cass"],
                        ecfg=E.EngineConfig(gamma=GAMMA),
                        num_slots=num_slots,
                        s_max=S_PROMPT + MAX_NEW + GAMMA + 1, paged=True,
                        block_size=4, chunk_size=4, device="cpu",
                        rt_extra=_extra(m["cfg"]), **kw)
    first = {}
    finish = sched._finish_prefill

    def capture(req, last_logits, cycle=None):
        first[req.rid] = np.array(last_logits, dtype=np.float32)
        finish(req, last_logits, cycle=cycle)

    sched._finish_prefill = capture
    reqs = [sched.submit(p, max_new=MAX_NEW) for p in prompts]
    sched.run()
    assert all(len(r.output) == MAX_NEW for r in reqs)
    return [r.output for r in reqs], [first[r.rid] for r in reqs]


def test_paged_scheduler_equals_engine_jamba():
    """The paged ``Scheduler`` on Jamba (attention kernels on: their plain
    versions on the CPU), three requests over two slots: the first two get
    the Engine's tokens, the third (a recycled slot) its own Engine run's,
    and overlap on == off and fused == alternating, token for token."""
    _, spec, _ = _engine("jamba-v0.1-52b")
    m = _model("jamba-v0.1-52b")
    prompts = list(m["prompt"]) + [m["prompt"][1][:7]]
    on, _ = _serve(m, prompts, attn_kernel="on")
    assert on[:B] == spec[:, :MAX_NEW].tolist()
    eng, _, _ = _engine("jamba-v0.1-52b")
    alone, _ = eng.generate({"tokens": torch.from_numpy(prompts[2][None])},
                            MAX_NEW)
    assert on[2] == alone[0, :MAX_NEW].tolist()
    assert _serve(m, prompts, attn_kernel="on", overlap=False)[0] == on
    assert _serve(m, prompts, attn_kernel="on", fused=False)[0] == on


@pytest.mark.parametrize("fused", [True, False])
def test_recycled_slot_starts_from_zero_state(fused):
    """falcon-mamba through one slot: each request after the first is
    admitted into the slot its predecessor left, and its first-token
    logits equal, bit for bit, those of the same request served alone by
    a fresh scheduler (its state starts from zero, as a prefill's does),
    and so do its tokens; in the fused and the alternating scheduler."""
    m = _model("falcon-mamba-7b")
    prompts = [m["prompt"][0], m["prompt"][1][:9], m["prompt"][0][:5]]
    toks, first = _serve(m, prompts, num_slots=1, fused=fused)
    for i, p in enumerate(prompts):
        alone, alone_first = _serve(m, [p], num_slots=1, fused=fused)
        assert toks[i] == alone[0]
        np.testing.assert_array_equal(first[i], alone_first[0])


def test_freeze_rows_keeps_idle_ssm_state():
    """A fused step where row 0 decodes and row 1 is idle: row 1's ``conv``
    and ``h`` stay as they were, bit for bit (row 0's change), and its
    ``length`` too. Without the freeze the step's commit would set row 1
    to the state after its garbage token."""
    m = _model("falcon-mamba-7b")
    cfg = m["cfg"]
    rt = Runtime(cfg=cfg, cass=m["cass"], view="target", **_extra(cfg))
    cache = KC.init_cache(cfg, m["cass"], B, S_MAX, packed=True,
                          device="cpu")
    with torch.inference_mode():
        _, cache = M.forward_prefill(
            rt, m["packed"], {"tokens": torch.from_numpy(m["prompt"])},
            cache)
        before = TP.clone_tree(cache)
        cur = torch.from_numpy(m["step"][:, :1].copy())
        chunk = torch.zeros((B, GAMMA + 1), dtype=torch.int32)
        valid = torch.zeros(B, dtype=torch.int32)
        dmask = torch.tensor([True, False])
        _, _, cache = S._masked_unified(
            rt, m["packed"], cache, cur, chunk, valid, dmask,
            E.EngineConfig(gamma=GAMMA), torch.Generator())
        raw = TP.clone_tree(before)
        E.unified_step(rt, m["packed"], raw, cur, chunk, valid, dmask,
                       E.EngineConfig(gamma=GAMMA), torch.Generator())
    for g, g0, gr in zip(cache["dec"], before["dec"], raw["dec"]):
        for e, e0, er in zip(g.values(), g0.values(), gr.values()):
            for nm in ("conv", "h"):
                assert torch.equal(e[nm][:, 1], e0[nm][:, 1])
                assert not torch.equal(e[nm][:, 0], e0[nm][:, 0])
                assert not torch.equal(er[nm][:, 1], e0[nm][:, 1])
    assert int(cache["length"][1]) == int(before["length"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_and_swap_refused(arch):
    """The reference's validation (``tests/test_scheduler.py``): the prefix
    cache and preemption with swap are refused for an SSM model, naming
    the recurrent state."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(ValueError, match="SSM"):
        S.Scheduler(cfg, None, ecfg=E.EngineConfig(gamma=GAMMA),
                    num_slots=2, s_max=S_MAX, paged=True, prefix_cache=True,
                    block_size=GAMMA + 1, chunk_size=GAMMA + 1,
                    device="cpu")
    with pytest.raises(ValueError, match="SSM|recurrent"):
        S.Scheduler(cfg, None, ecfg=E.EngineConfig(gamma=GAMMA),
                    num_slots=2, s_max=S_MAX, paged=True, swap=True,
                    block_size=4, device="cpu")


def test_paged_cache_keeps_ssm_state_per_row():
    """Jamba's paged cache: the attention entry's stores are pools
    (R,NB,BS,…), every Mamba entry's state is per row, (R,B,dc-1,di) bf16
    and (R,B,di,n) f32, never packed; the block moves of the prefix cache
    and swap leave the SSM entries alone."""
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    cache = KC.init_paged_cache(cfg, cass, B, 9, 4, 3, packed=True,
                                device="cpu")
    g = cache["dec"][0]
    assert KC.is_packed(g["e4"]["k"])
    assert g["e4"]["k"]["spec"]["bitmap"].shape[:3] == (1, 9, 4)
    for j in (0, 1, 2, 3, 5, 6, 7):
        e = g[f"e{j}"]
        assert e["conv"].shape == (1, B, cfg.ssm_conv - 1, cfg.d_inner)
        assert e["h"].shape == (1, B, cfg.d_inner, cfg.ssm_state)
        assert (e["conv"].dtype, e["h"].dtype) == (torch.bfloat16,
                                                   torch.float32)
    g["e0"]["h"].fill_(1.5)
    KC.copy_pool_blocks(cache, [1], [2])
    spilled = KC.spill_pool_blocks(cache, [1, 0])
    assert sorted(spilled[0]) == ["e4"]
    KC.restore_pool_blocks(cache, [2, 0], spilled)
    assert bool((g["e0"]["h"] == 1.5).all())


def test_serve_cli_runs_the_ssm_archs(capsys):
    """``--arch falcon-mamba-7b`` and ``--arch jamba-v0.1-52b`` at
    ``--smoke`` on the CPU: the Engine and the paged Scheduler deliver
    every request's tokens."""
    from repro_torch.launch import serve
    for argv in (["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
                  "--requests", "2", "--prompt-len", "8", "--max-new", "6"],
                 ["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                  "--scheduler", "--paged", "--attn-kernel", "on",
                  "--requests", "3", "--prompt-len", "8", "--max-new", "6",
                  "--block-size", "4", "--chunk-size", "4"]):
        serve.run(argv)
        out = capsys.readouterr().out
        assert "acceptance" in out
    assert out.count(": 6 tokens") == 3
