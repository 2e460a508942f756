"""Port vs reference, the fixed-batch speculative engine at SMOKE width.

Losslessness is held under the near-tie rule (``torch_ar.tau_prefix``):
tokens must be equal up to the first position whose autoregressive
top-1/top-2 logit margin is below tau, where tau is twice the largest
logit difference measured between the two computations being compared
(no argmax can flip by less than that). Inside the port on the CPU the
width-1 autoregressive steps and the width-(γ+1) verify pass agree bit
for bit, so tau is 0 and every position is compared.
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
from repro.models import model as JM
from repro.models.layers import Runtime as JRuntime
from repro.serving import engine as JE, kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.launch import serve
from repro_torch.models import attention as A, model as M
from repro_torch.serving import engine as E, kvcache as KC

GAMMA, MAX_NEW = 3, 12


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jcass, cass = JCass(variant=1, gamma=GAMMA), CassandraConfig(
        variant=1, gamma=GAMMA)
    jplain = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpacked = jpack.format_params(jplain, jcass)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    cfg = get_config("llama3-8b", smoke=True)
    packed = prepare_params(TP.to_port(jpacked), cass)
    eng = E.Engine(cfg, packed, cass=cass, ecfg=E.EngineConfig(gamma=GAMMA),
                   device="cpu")
    ar, st_ar = eng.generate({"tokens": torch.from_numpy(prompt)}, MAX_NEW,
                             speculative=False)
    spec, st = eng.generate({"tokens": torch.from_numpy(prompt)}, MAX_NEW)
    return {"jcfg": jcfg, "jcass": jcass, "jplain": jplain,
            "jpacked": jpacked, "cfg": cfg, "cass": cass, "packed": packed,
            "prompt": prompt, "eng": eng, "ar": ar.numpy(), "st_ar": st_ar,
            "spec": spec.numpy(), "st": st}


def test_spec_tokens_equal_ar_tokens(setup):
    """Engine spec tokens against the engine's width-1 autoregressive
    tokens, tau from the width-1 against width-(γ+1) logit difference."""
    d = AR.verify_gap(setup["eng"], torch.from_numpy(setup["prompt"]),
                      GAMMA, 1)
    assert d == 0.0          # the CPU's products do not depend on the width
    compared, cut = AR.tau_prefix(setup["spec"], setup["ar"],
                                  setup["st_ar"]["margins"], 2 * d, MAX_NEW)
    assert (compared, cut) == (2 * MAX_NEW, 0)
    st = setup["st"]
    assert st["draft_passes"] == st["cycles"] * GAMMA
    assert 0.0 <= st["acceptance"] <= 1.0


def test_spec_tokens_equal_verify_width_ar_tokens(setup):
    """The harness ``chip_smoke.py`` holds the card to: autoregressive
    steps run at the verify width give the verify pass's logits bit for
    bit, and the speculative tokens equal theirs at every position."""
    prompt = torch.from_numpy(setup["prompt"])
    assert AR.verify_gap(setup["eng"], prompt, GAMMA, GAMMA + 1) == 0.0
    toks, logits = AR.ar_steps(setup["eng"], prompt, MAX_NEW, GAMMA + 1)
    np.testing.assert_array_equal(setup["spec"][:, :MAX_NEW], toks.numpy())
    np.testing.assert_array_equal(AR.top2_margins(logits),
                                  setup["st_ar"]["margins"])


def _reference_decode_gap(setup, tokens: np.ndarray) -> tuple:
    """Teacher-forced width-1 decode along ``tokens`` (B,n) in both
    packages from the same prompt. Returns (largest |logit| difference,
    port logits (B,n,V), reference logits (B,n,V))."""
    jcfg, jcass, jpacked = setup["jcfg"], setup["jcass"], setup["jpacked"]
    jrt = JRuntime(cfg=jcfg, cass=jcass, view="target")
    jprefill = jax.jit(lambda p, b, c: JM.forward_prefill(jrt, p, b, c))
    jdecode = jax.jit(lambda p, t, c: JM.forward_decode(jrt, p, t, c))
    jcommit = jax.jit(lambda c, u, n: JE.commit(jrt, c, u, n))
    b, n = tokens.shape
    s_max = setup["prompt"].shape[1] + n + 1
    jlg, jcache = jprefill(jpacked, {"tokens": jnp.asarray(setup["prompt"])},
                           JKC.init_cache(jcfg, jcass, b, s_max, packed=True))
    jl = [TP.f32(jlg[:, -1])]
    eng = setup["eng"]
    rt = dataclasses.replace(eng.rt, view="target")
    with torch.inference_mode():
        lg, cache = AR.prefill(eng, torch.from_numpy(setup["prompt"]), s_max)
        pl = [TP.f32(lg)]
        zeros = torch.zeros(b, dtype=torch.int32)
        for i in range(n - 1):
            lo, upd = M.forward_decode(rt, eng.params,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       cache)
            cache = E.commit(rt, cache, upd, zeros)
            jlo, jupd = jdecode(jpacked, jnp.asarray(tokens[:, i:i + 1]),
                                jcache)
            jcache = jcommit(jcache, jupd, jnp.zeros(b, jnp.int32))
            pl.append(TP.f32(lo[:, -1]))
            jl.append(TP.f32(jlo[:, -1]))
    pl, jl = np.stack(pl, 1), np.stack(jl, 1)
    return float(np.abs(pl - jl).max()), pl, jl


def test_port_tokens_equal_reference_engine(setup):
    """Port autoregressive tokens against the reference's speculative and
    autoregressive ``Engine.generate`` on the same weights and prompt.

    tau is twice the largest logit difference between the packages over
    teacher-forced width-1 decode steps along the port's tokens (measured
    0.0098: the packages round bf16 at different places). The prefix rule
    then compares 7 of the 24 positions (29%), all equal: SMOKE logits are
    bf16 values of magnitude below 1, so their top-1/top-2 margins are a
    few bf16 ulps (0.004-0.24 here), 5 of 24 lie below tau = 0.0195, and
    the first one in a row cuts the rest of it. Held besides: at every
    teacher-forced position whose margin is at least tau (19 of 24, 79%)
    both packages pick the same token.
    """
    ar, margins = setup["ar"][:, :MAX_NEW], setup["st_ar"]["margins"]
    jeng = JE.Engine(setup["jcfg"], setup["jpacked"], cass=setup["jcass"],
                     ecfg=JE.EngineConfig(gamma=GAMMA))
    prompt = {"tokens": jnp.asarray(setup["prompt"])}
    gap, pl, jl = _reference_decode_gap(setup, ar)
    tau = 2 * gap
    assert gap < 0.02, gap
    for speculative in (True, False):
        jtok, jst = jeng.generate(prompt, MAX_NEW, speculative=speculative)
        jtok = np.asarray(jtok)
        assert jtok.shape == setup["ar"].shape
        compared, cut = AR.tau_prefix(jtok, setup["ar"], margins, tau,
                                      MAX_NEW)
        assert compared >= 7, (compared, cut, tau)
    np.testing.assert_array_equal(pl.argmax(-1), ar)
    sure = AR.top2_margins(torch.from_numpy(pl)) >= tau
    assert sure.mean() >= 0.75, sure.mean()
    np.testing.assert_array_equal(jl.argmax(-1)[sure], ar[sure])


def test_scatter_tokens_matches_reference():
    rng = np.random.default_rng(5)
    b, q, cap = 4, 4, 9
    buf = np.full((b, cap), -1, np.int32)
    count = np.array([0, 3, 7, 9], np.int32)
    tokens = rng.integers(0, 50, (b, q)).astype(np.int32)
    n = np.array([3, 0, 2, 1], np.int32)
    valid = np.arange(q)[None] <= n[:, None]
    ref = JE.scatter_tokens(jnp.asarray(buf), jnp.asarray(count),
                            jnp.asarray(tokens), jnp.asarray(valid),
                            jnp.asarray(n + 1))
    out = E.scatter_tokens(torch.from_numpy(buf), torch.from_numpy(count),
                           torch.from_numpy(tokens), torch.from_numpy(valid),
                           torch.from_numpy(n + 1))
    for p, r in zip(out, ref):
        TP.assert_bitwise(p, r)


@pytest.mark.parametrize("packed", [False, True])
def test_writes_past_the_slot_region_are_dropped(setup, packed):
    """Rows whose run reaches past S: the port drops those writes as the
    reference's scatter does, leaf for leaf."""
    cfg, cass = setup["cfg"], setup["cass"]
    rng = np.random.default_rng(7)
    b, s, q, d = 4, 6, 4, cfg.hd
    old = TP.rand_bf16_np(rng, (b, s, 2, d))
    new = TP.rand_bf16_np(rng, (b, q, 2, d))
    at = np.array([1, 3, 5, 6], np.int32)       # in, last slot, past, all past
    if packed:
        jbook = JKC.default_kv_codebook()
        book = KC.default_kv_codebook()
        jold = JKC.encode_store(setup["jcass"], jnp.asarray(old), d, jbook)
        jnew = JKC.encode_store(setup["jcass"], jnp.asarray(new), d, jbook)
        pold = KC.encode_store(cass, TP.to_port(old), d, book)
        pnew = KC.encode_store(cass, TP.to_port(new), d, book)
        TP.assert_bitwise(pold, jold)
    else:
        jold, jnew = jnp.asarray(old), jnp.asarray(new)
        pold, pnew = TP.to_port(old), TP.to_port(new)
    ref = JKC.append_store_batched(jold, jnew, jnp.asarray(at))
    out = KC.append_store_batched(pold, pnew, torch.from_numpy(at))
    TP.assert_bitwise(out, ref)


def test_place_at_positions_drops_positions_past_the_end():
    rng = np.random.default_rng(8)
    prefix = [torch.from_numpy(rng.standard_normal((3, 5, 2)))
              for _ in range(2)]
    new = [torch.from_numpy(rng.standard_normal((3, 3, 2))) for _ in range(2)]
    positions = torch.tensor([[0, 1, 2], [3, 4, 5], [5, 6, 7]])
    out = A.place_at_positions(tuple(prefix), tuple(new), positions)
    for p, n, o in zip(prefix, new, out):
        want = p.clone()
        for r in range(3):
            for j in range(3):
                if positions[r, j] < 5:
                    want[r, positions[r, j]] = n[r, j]
        assert torch.equal(o, want)
        assert not torch.equal(o, p)


def test_spec_step_advances_per_row_lengths(setup):
    eng = setup["eng"]
    b, s = setup["prompt"].shape
    cache = KC.init_cache(eng.cfg, eng.cass, b, s + 16, packed=True,
                          device="cpu")
    lg, cache = M.forward_prefill(eng.rt, eng.params,
                                  {"tokens": torch.from_numpy(setup["prompt"])},
                                  cache)
    assert cache["length"].tolist() == [s, s]
    cur = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    res, cache = E.spec_decode_step(eng.rt, eng.params, cache, cur, eng.ecfg)
    assert cache["length"].tolist() == (s + res.n_accepted + 1).tolist()
    assert res.tokens.shape == (b, GAMMA + 1) and res.valid[:, 0].all()
    scratch = E.make_scratch(eng.cfg, cache, GAMMA)
    assert scratch[0]["e0"]["k"].shape == (2, b, GAMMA, 2, 64)


def test_generate_full_output_every_row(setup):
    eng = setup["eng"]
    prompt = np.random.default_rng(6).integers(0, 512, (4, 12))
    toks, st = eng.generate({"tokens": torch.from_numpy(prompt)}, MAX_NEW)
    counts = (toks >= 0).sum(1)
    assert (counts >= MAX_NEW).all(), counts
    assert st["tokens_per_cycle"] * st["cycles"] >= MAX_NEW - 1
    ar = setup["ar"]
    assert ((ar >= 0).sum(1) == MAX_NEW).all()
    assert setup["st_ar"]["margins"].shape == (2, MAX_NEW)
    assert setup["st_ar"]["acceptance"] is None


def test_stable_draft_on_a_plain_cache_accepts_everything(setup):
    """Plain weights and cache, shape-stable draft: each draft pass is the
    verify computation restricted to earlier positions, so with keys at
    absolute positions every draft is accepted under the strict rule."""
    plain = TP.to_port(setup["jplain"])
    eng = E.Engine(setup["cfg"], plain, cass=None,
                   ecfg=E.EngineConfig(gamma=GAMMA, stable_draft=True),
                   device="cpu")
    toks, st = eng.generate({"tokens": torch.from_numpy(setup["prompt"])}, 8)
    assert st["acceptance"] == 1.0
    ar, _ = eng.generate({"tokens": torch.from_numpy(setup["prompt"])}, 8,
                         speculative=False)
    np.testing.assert_array_equal(toks.numpy()[:, :8], ar.numpy()[:, :8])


def test_engine_refusals(setup):
    """Sampling is no longer refused: under ``greedy=False`` the
    autoregressive ``generate`` stays greedy, as the reference's does (its
    AR step never receives ``ecfg.greedy``). CUDA without a card is."""
    eng = E.Engine(setup["cfg"], setup["packed"], cass=setup["cass"],
                   ecfg=E.EngineConfig(gamma=GAMMA, greedy=False),
                   device="cpu")
    ar, _ = eng.generate({"tokens": torch.from_numpy(setup["prompt"])},
                         MAX_NEW, generator=torch.Generator().manual_seed(3),
                         speculative=False)
    np.testing.assert_array_equal(ar.numpy(), setup["ar"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            E.Engine(setup["cfg"], setup["packed"], cass=setup["cass"])


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.run(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                   "--requests", "2", "--prompt-len", "8", "--max-new", "6"])
    text = out.getvalue()
    assert "[format] spec=" in text and "kernel operands" in text
    assert "[serve] 2 reqs" in text and "on cpu" in text
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            serve.run(["--arch", "llama3-8b", "--smoke", "--variant", "2"])
