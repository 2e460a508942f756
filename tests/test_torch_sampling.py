"""Port vs reference, rejection sampling (paper Eq. 1) and the sampled
serving paths at SMOKE width.

The port draws from a ``torch.Generator`` and the reference from a JAX key,
so their random streams differ: ``rejection_sample`` is held to the
reference with the uniforms ``r`` given and one-hot residuals (the one draw
left then has one possible outcome), and the distribution itself by
seeded frequency checks whose bounds are stated in each test. Engine
telemetry is held to the reference's on runs whose tokens do not depend on
rounding (every draft accepted, or autoregressive steps).
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
from repro.core import speculative as jspec
from repro.models import init_params as jax_init_params
from repro.serving import engine as JE
from repro.serving.telemetry import Telemetry as JTelemetry
from repro_torch.configs import get_config
from repro_torch.core import speculative as SP
from repro_torch.core.format import CassandraConfig
from repro_torch.core.packing import format_params
from repro_torch.models import model as M
from repro_torch.models.model import init_params
from repro_torch.serving import engine as E
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.telemetry import CYCLE, Telemetry

GAMMA, MAX_NEW = 3, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _one_hot_case(rng, b: int, gamma: int, v: int):
    """Draft tokens and probabilities whose Eq. 1 residual is one-hot at
    every stopping position: p_i = (1-e)·onehot(t_i) + e·q_i for i < γ
    (so max(p_i - q_i, 0) is positive at t_i alone) and p_γ = onehot(t_γ).
    Half the drafted tokens are the target's t_i, so rows stop anywhere
    in 0..γ."""
    logits = rng.standard_normal((b, gamma, v)).astype(np.float32)
    q = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = rng.integers(0, v, (b, gamma + 1))
    eps = rng.uniform(0.05, 0.9, (b, gamma, 1)).astype(np.float32)
    onehot = np.zeros((b, gamma + 1, v), np.float32)
    np.put_along_axis(onehot, t[..., None], 1.0, axis=-1)
    p = np.concatenate([(1 - eps) * onehot[:, :gamma] + eps * q,
                        onehot[:, gamma:]], axis=1).astype(np.float32)
    other = rng.integers(0, v, (b, gamma))
    draft = np.where(rng.random((b, gamma)) < 0.5, t[:, :gamma], other)
    r = rng.random((b, gamma)).astype(np.float32)
    return draft.astype(np.int32), q, p, r


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_rejection_sample_matches_reference_with_r(gamma):
    """Same ``r``, one-hot residuals: the whole ``AcceptResult`` equals the
    reference's, bit for bit (the ratio test is the same f32 division)."""
    draft, q, p, r = _one_hot_case(np.random.default_rng(gamma), 64, gamma,
                                   48)
    ref = jspec.rejection_sample(jnp.asarray(draft), jnp.asarray(q),
                                 jnp.asarray(p), jax.random.PRNGKey(0),
                                 r=jnp.asarray(r))
    out = SP.rejection_sample(torch.from_numpy(draft), torch.from_numpy(q),
                              torch.from_numpy(p), _gen(0),
                              r=torch.from_numpy(r))
    for got, want in zip(out, ref):
        TP.assert_bitwise(got, want)
    n = out.n_accepted.numpy()
    assert n.min() == 0 and n.max() == gamma      # every branch exercised


def test_rejection_sample_toy_distribution():
    """The reference's toy check (``tests/test_serving.py``): 4000 draws
    from q, first-token frequencies within 0.03 of p (4.1 standard errors
    at p = 0.3). Seeded, so decided once."""
    v, n, gamma = 3, 4000, 1
    p = torch.tensor([0.6, 0.3, 0.1])
    q = torch.tensor([0.2, 0.5, 0.3])
    gen = _gen(42)
    draft = SP.categorical(torch.log(q).expand(n, gamma, v), gen)
    res = SP.rejection_sample(draft, q.expand(n, gamma, v),
                              p.expand(n, gamma + 1, v), gen)
    freq = np.bincount(res.tokens[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(freq, p.numpy(), atol=0.03)


def test_rejection_sample_gamma3_every_position():
    """γ = 3, other p and q at each position: token k of a row that
    reaches position k is distributed as p_k. 20000 rows; each position's
    frequencies are held to p_k within 5 standard errors of the rows that
    reach it (seeded, so decided once)."""
    v, n, gamma = 5, 20000, 3
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(v), gamma + 1).astype(np.float32)
    q = rng.dirichlet(np.ones(v), gamma).astype(np.float32)
    gen = _gen(7)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    draft = SP.categorical(torch.log(qt).expand(n, gamma, v), gen)
    res = SP.rejection_sample(draft, qt.expand(n, gamma, v),
                              pt.expand(n, gamma + 1, v), gen)
    tokens, valid = res.tokens.numpy(), res.valid.numpy()
    for k in range(gamma + 1):
        # a row reaches position k iff its first k drafts were accepted
        rows = res.n_accepted.numpy() >= k
        m = int(rows.sum())
        assert m > 1000, (k, m)
        assert valid[rows, k].all()
        freq = np.bincount(tokens[rows, k], minlength=v) / m
        bound = 5 * np.sqrt(p[k] * (1 - p[k]) / m)
        assert (np.abs(freq - p[k]) <= bound).all(), (k, freq, p[k], bound)


def test_rejection_sample_same_seed_same_result():
    draft, q, p, _ = _one_hot_case(np.random.default_rng(9), 32, GAMMA, 40)
    args = (torch.from_numpy(draft), torch.from_numpy(q), torch.from_numpy(p))
    a = SP.rejection_sample(*args, _gen(11))
    b = SP.rejection_sample(*args, _gen(11))
    c = SP.rejection_sample(*args, _gen(12))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.n_accepted, c.n_accepted)


def test_categorical_frequencies():
    """The Gumbel-max draw against softmax(logits): 50000 draws over 6
    classes, each frequency within 5 standard errors."""
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    p = torch.softmax(logits, -1).numpy()
    n = 50000
    draws = SP.categorical(logits.expand(n, 6), _gen(5)).numpy()
    freq = np.bincount(draws, minlength=6) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n)).all()


# ---------------------------------------------------------------------------
# The sampling glue: what ``_accept`` hands Eq. 1, what ``_draw`` draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.3, 1.0, 1.7])
def test_accept_probabilities_match_reference(monkeypatch, temperature):
    """``_accept`` under sampling against the reference's on the same
    logits: the draft tokens, the draft softmax over the stacked draft
    logits / T and the target softmax over ``t_logits[:, :γ+1]`` / T that
    each hands to ``rejection_sample``. The target logits carry one
    position past the verify width, so a shifted slice shows. f32
    softmaxes of two libraries: within 1e-6 relative, 1e-9 absolute."""
    rng = np.random.default_rng(int(temperature * 10))
    b, v = 4, 96
    draft_logits = [3 * rng.standard_normal((b, v)).astype(np.float32)
                    for _ in range(GAMMA)]
    t_logits = 3 * rng.standard_normal((b, GAMMA + 2, v)).astype(np.float32)
    draft = rng.integers(0, v, (b, GAMMA)).astype(np.int32)
    seen = {}

    def spy(tag):
        def capture(draft_tokens, draft_probs, target_probs, *_, **__):
            seen[tag] = [np.asarray(x) for x in (draft_tokens, draft_probs,
                                                 target_probs)]
        return capture

    monkeypatch.setattr(SP, "rejection_sample", spy("port"))
    monkeypatch.setattr(jspec, "rejection_sample", spy("ref"))
    E._accept(torch.from_numpy(draft),
              [torch.from_numpy(x) for x in draft_logits],
              torch.from_numpy(t_logits),
              E.EngineConfig(gamma=GAMMA, greedy=False,
                             temperature=temperature), _gen(0))
    JE._accept(jnp.asarray(draft), [jnp.asarray(x) for x in draft_logits],
               jnp.asarray(t_logits), jax.random.PRNGKey(0),
               JE.EngineConfig(gamma=GAMMA, greedy=False,
                               temperature=temperature))
    (pt, pq, pp), (rt, rq, rp) = seen["port"], seen["ref"]
    np.testing.assert_array_equal(pt, rt)
    assert pq.shape == rq.shape == (b, GAMMA, v)
    assert pp.shape == rp.shape == (b, GAMMA + 1, v)
    np.testing.assert_allclose(pq, rq, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pp, rp, rtol=1e-6, atol=1e-9)


def test_draw_frequencies_match_reference_softmax():
    """``_draw`` under sampling: 40000 rows of one logit row at T = 0.5,
    each class's frequency within 5 standard errors of the reference's
    ``softmax(logits / T)`` (at T = 1 a class moves by 0.27, 142 SE).
    Seeded, so decided once; greedy is the argmax."""
    logits = np.array([1.0, 0.0, -1.0, 2.0, 0.5, -3.0], np.float32)
    n, t = 40000, 0.5
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits) / t), np.float64)
    lg = torch.from_numpy(logits).expand(n, -1)
    draws = E._draw(lg, False, t, _gen(13)).numpy()
    freq = np.bincount(draws, minlength=len(logits)) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n)).all(), freq
    assert (E._draw(lg[:2], True, t, None).numpy() == 3).all()


# ---------------------------------------------------------------------------
# The sampled Engine and Scheduler (SMOKE width, port only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    packed = format_params(init_params(cfg, _gen(0), device="cpu"), cass)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    return {"cfg": cfg, "cass": cass, "packed": packed, "prompts": prompts}


def _engine(smoke, greedy: bool, **kw):
    return E.Engine(smoke["cfg"], smoke["packed"], cass=smoke["cass"],
                    ecfg=E.EngineConfig(gamma=GAMMA, greedy=greedy,
                                        temperature=0.8, **kw),
                    device="cpu")


def test_sampled_engine_rows_and_seeds(smoke):
    eng = _engine(smoke, greedy=False)
    batch = {"tokens": torch.from_numpy(smoke["prompts"])}
    a, st = eng.generate(batch, MAX_NEW, generator=_gen(1))
    b, _ = eng.generate(batch, MAX_NEW, generator=_gen(1))
    c, _ = eng.generate(batch, MAX_NEW, generator=_gen(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert ((a >= 0).sum(1) >= MAX_NEW).all()
    assert st["draft_passes"] == st["cycles"] * GAMMA
    assert 0.0 <= st["acceptance"] <= 1.0
    # the default generator is seeded with 0
    d, _ = eng.generate(batch, MAX_NEW)
    e, _ = eng.generate(batch, MAX_NEW, generator=_gen(0))
    assert torch.equal(d, e)


def test_non_greedy_steps_need_a_generator(smoke):
    eng = _engine(smoke, greedy=False)
    cur = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="torch.Generator"):
        E._run_drafts(eng.rt, eng.params, {"length": None}, cur, eng.ecfg)
    with pytest.raises(ValueError, match="torch.Generator"):
        E.autoregressive_step(eng.rt, eng.params, {}, cur, greedy=False)


def test_autoregressive_speculative_false_stays_greedy(smoke):
    """The reference's ``Engine.generate(speculative=False)`` runs its AR
    step with the default ``greedy=True`` whatever ``ecfg.greedy`` says."""
    batch = {"tokens": torch.from_numpy(smoke["prompts"])}
    sampled, _ = _engine(smoke, greedy=False).generate(
        batch, MAX_NEW, generator=_gen(3), speculative=False)
    greedy, _ = _engine(smoke, greedy=True).generate(batch, MAX_NEW,
                                                     speculative=False)
    assert torch.equal(sampled, greedy)


def test_autoregressive_step_samples_when_asked(smoke):
    eng = _engine(smoke, greedy=False)
    batch = {"tokens": torch.from_numpy(smoke["prompts"])}
    with torch.inference_mode():
        lg, cache = AR.prefill(eng, batch["tokens"], 16)
        cur = torch.argmax(lg, -1).to(torch.int32)[:, None]
        outs = []
        for seed in (1, 1, 2):
            nxt, _, _ = E.autoregressive_step(
                eng.rt, eng.params, TP.clone_tree(cache), cur,
                generator=_gen(seed), greedy=False, temperature=5.0)
            outs.append(nxt)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


DIST_ROWS, DIST_TOP, DIST_SE = 1024, 8, 5.0
DIST_TEMPS = (1.0, 0.8, 0.6, 0.5, 0.4, 0.3, 0.25, 0.2, 0.15, 0.1, 0.07,
              0.05, 0.03, 0.02, 0.01)


def test_sampled_cycle_first_position_distribution(smoke, monkeypatch):
    """Eq. 1 end to end through ``spec_decode_step`` (the drafts' draws
    and ``_accept``'s softmaxes over logits / T and its verify slice), as
    the card's gate runs it: 1024 copies of one prompt, one cycle;
    ``tokens[:, 0]`` against the target's p at that position (T the
    largest whose 8 likeliest tokens hold half the mass), each of the 8
    bins and the rest within 5 standard errors. The same comparison must
    reject two planted faults on the same drafts, each drawing from a
    generator of its own: a residual of p in place of max(p - q, 0)
    (expected statistic 9.7 here) and every draft accepted (23.2).
    Seeded, so decided once."""
    eng = _engine(smoke, greedy=True)
    rt = eng.rt
    tokens = torch.from_numpy(smoke["prompts"][:1]).expand(DIST_ROWS, -1)
    real = SP.rejection_sample
    fault_gen = _gen(22)
    firsts = {}

    def planted(draft_tokens, draft_probs, target_probs, generator, r=None):
        res = real(draft_tokens, draft_probs, target_probs, generator, r)
        n = real(draft_tokens, draft_probs, target_probs,
                 fault_gen).n_accepted
        redraw = SP.categorical(torch.log(target_probs[:, 0]), fault_gen)
        firsts["residual p"] = torch.where(n > 0, draft_tokens[:, 0], redraw)
        firsts["accept all"] = draft_tokens[:, 0]
        return res

    with torch.inference_mode():
        # p from a one-row prefill: position 0 of the verify pass sees the
        # committed token alone, whatever the drafts
        lg1, one = AR.prefill(eng, tokens[:1], 12 + GAMMA + 2)
        cur = torch.argmax(lg1, -1).to(torch.int32)[:, None]
        l0, _ = M.forward_decode(dataclasses.replace(rt, view="target"),
                                 eng.params, cur.expand(-1, GAMMA + 1), one)
        l0 = l0[0, 0].to(torch.float32)
        temp = next(t for t in DIST_TEMPS if torch.softmax(l0 / t, -1).topk(
            DIST_TOP).values.sum() >= 0.5)
        p = torch.softmax(l0 / temp, -1)
        monkeypatch.setattr(SP, "rejection_sample", planted)
        _, cache = AR.prefill(eng, tokens.contiguous(), 12 + GAMMA + 2)
        res, _ = E.spec_decode_step(
            rt, eng.params, cache, cur.expand(DIST_ROWS, -1),
            E.EngineConfig(gamma=GAMMA, greedy=False, temperature=temp),
            _gen(21))
    firsts["Eq. 1"] = res.tokens[:, 0]
    top = p.topk(DIST_TOP)
    ids = top.indices.numpy()
    p_bins = np.append(top.values.double().numpy(),
                       1.0 - top.values.double().sum().item())
    se = np.sqrt(p_bins * (1 - p_bins) / DIST_ROWS)
    stats = {}
    for name, first in firsts.items():
        first = first.numpy()
        freq = np.array([(first == i).mean() for i in ids]
                        + [(~np.isin(first, ids)).mean()])
        stats[name] = float((np.abs(freq - p_bins) / se).max())
    assert stats["Eq. 1"] <= DIST_SE, stats
    assert stats["residual p"] > DIST_SE, stats
    assert stats["accept all"] > DIST_SE, stats


def _serve(smoke, greedy: bool, overlap: bool, fused: bool = True,
           generator=None, runs: int = 1):
    sched = Scheduler(smoke["cfg"], smoke["packed"], cass=smoke["cass"],
                      ecfg=E.EngineConfig(gamma=GAMMA, greedy=greedy,
                                          temperature=0.8),
                      num_slots=2, s_max=24, paged=True, block_size=4,
                      chunk_size=8, attn_kernel="on", overlap=overlap,
                      fused=fused, generator=generator, device="cpu")
    free_runs = []
    inner = sched._free_run_ok

    def spy():
        ok = inner()
        free_runs.append(ok)
        return ok

    sched._free_run_ok = spy
    outs = []
    for _ in range(runs):
        sched.reset()
        for i, p in enumerate(smoke["prompts"]):
            sched.submit(p[:8], max_new=4 + 2 * i)
        done = sched.run()
        outs.append([r.output for r in sorted(done, key=lambda r: r.rid)])
    return outs, free_runs, sched


def test_sampled_scheduler_overlap_on_equals_off(smoke):
    """Overlap on == off (and the alternating loop runs) under sampling;
    ``reset()`` restarts the generator, so a second run repeats the
    first; a non-greedy run never free-runs, a greedy one does here."""
    on, free_on, _ = _serve(smoke, greedy=False, overlap=True, runs=2)
    off, _, _ = _serve(smoke, greedy=False, overlap=False)
    assert on[0] == off[0] == on[1]
    for i, out in enumerate(on[0]):
        assert len(out) == 4 + 2 * i
    assert free_on and not any(free_on)
    _, free_greedy, _ = _serve(smoke, greedy=True, overlap=True)
    assert any(free_greedy)
    alt, _, _ = _serve(smoke, greedy=False, overlap=False, fused=False)
    assert [len(o) for o in alt[0]] == [len(o) for o in on[0]]


def test_sampled_scheduler_seeds(smoke):
    a, _, sched = _serve(smoke, greedy=False, overlap=True,
                         generator=_gen(8))
    b, _, _ = _serve(smoke, greedy=False, overlap=True, generator=_gen(8))
    c, _, _ = _serve(smoke, greedy=False, overlap=True, generator=_gen(9))
    assert a == b and a != c
    assert sched.generator.initial_seed() == 8
    default = Scheduler(smoke["cfg"], smoke["packed"], cass=smoke["cass"],
                        ecfg=E.EngineConfig(gamma=GAMMA, greedy=False),
                        num_slots=1, s_max=24, device="cpu")
    assert torch.equal(default.generator.get_state(), _gen(0).get_state())


# ---------------------------------------------------------------------------
# Engine telemetry against the reference's
# ---------------------------------------------------------------------------

def _telemetry_view(telem) -> tuple:
    """Counters, the acceptance-length histogram and the CYCLE tuples
    (cycle, kind, rid, slot, args), without wall stamps."""
    snap = telem.metrics.snapshot()
    counters = {k: snap[k] for k in ("cycles", "accepted", "drafted",
                                     "committed")}
    hist = snap["histograms"].get("acceptance_len")
    events = [ev[1:] for ev in telem.tracer.events()]
    return counters, hist, events


@pytest.mark.parametrize("speculative", [True, False])
def test_engine_telemetry_matches_reference(speculative):
    """Greedy SMOKE runs whose tokens no rounding can change: the plain
    model with the shape-stable draft accepts every draft in both
    packages, and the autoregressive run emits one CYCLE per row and
    step. Counters, histogram and CYCLE tuples equal the reference's."""
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jplain = jax_init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ecfg = dict(gamma=GAMMA, stable_draft=True)
    jeng = JE.Engine(jcfg, jplain, cass=None, ecfg=JE.EngineConfig(**ecfg))
    jtel = JTelemetry(trace=True)
    _, jst = jeng.generate({"tokens": jnp.asarray(prompt)}, MAX_NEW,
                           speculative=speculative, telemetry=jtel)
    eng = E.Engine(get_config("llama3-8b", smoke=True), TP.to_port(jplain),
                   cass=None, ecfg=E.EngineConfig(**ecfg), device="cpu")
    tel = Telemetry(trace=True)
    toks, st = eng.generate({"tokens": torch.from_numpy(prompt)}, MAX_NEW,
                            speculative=speculative, telemetry=tel)
    assert _telemetry_view(tel) == _telemetry_view(jtel)
    assert st["cycles"] == jst["cycles"]
    assert st["acceptance"] == jst["acceptance"]
    counters, _, events = _telemetry_view(tel)
    assert all(ev[1] == CYCLE for ev in events)
    if speculative:
        assert st["acceptance"] == 1.0
    # the same tokens with telemetry off
    off, _ = eng.generate({"tokens": torch.from_numpy(prompt)}, MAX_NEW,
                          speculative=speculative)
    assert torch.equal(toks, off)


def test_engine_telemetry_counts_c1(smoke):
    """C-1, sampled: the counters equal the stats, one CYCLE event per
    active row and cycle, and the tokens equal a telemetry-off run's."""
    eng = _engine(smoke, greedy=False)
    batch = {"tokens": torch.from_numpy(smoke["prompts"])}
    tel = Telemetry(trace=True)
    toks, st = eng.generate(batch, MAX_NEW, generator=_gen(6), telemetry=tel)
    off, _ = eng.generate(batch, MAX_NEW, generator=_gen(6))
    assert torch.equal(toks, off)
    counters, hist, events = _telemetry_view(tel)
    assert counters["cycles"] == st["cycles"]
    assert counters["drafted"] == GAMMA * len(events) > 0
    assert counters["accepted"] == round(st["acceptance"]
                                         * counters["drafted"])
    delivered = (toks >= 0).sum(1)
    assert counters["committed"] == int(delivered.sum()) - len(delivered)
    assert hist["n"] == len(events)
    assert sum(ev[4][1] for ev in events) == counters["accepted"]
    # rows leave the event stream once they owe nothing
    per_row = np.bincount([ev[2] for ev in events])
    assert per_row.max() == st["cycles"]
