"""Port vs reference: the paged continuous-batching scheduler at SMOKE
width on the CPU (the kernels' plain versions).

Losslessness is held under the near-tie rule (``torch_ar.tau_prefix``):
per row, tokens must be equal up to the first position whose top-1/top-2
logit margin is below tau, where tau is twice the largest logit
difference measured between the two computations compared. Inside the
port on the CPU every serving path gives the same tokens bit for bit, as
the reference's own tests pin them (``tests/test_scheduler.py``: paged ==
slot, fused == alternating, kernel on == off).
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
from repro.serving import engine as JE, kvcache as JKC, scheduler as JS
from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels.draft_matmul import prepare_params
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import engine as E, scheduler as S

GAMMA, MAX_NEW, PROMPT = 3, 8, 12
KW = dict(num_slots=3, s_max=PROMPT + MAX_NEW + GAMMA + 1, block_size=4,
          chunk_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jcass = JCass(variant=1, gamma=GAMMA)
    jplain = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpacked = jpack.format_params(jplain, jcass)
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=GAMMA)
    packed = prepare_params(TP.to_port(jpacked), cass)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (3, PROMPT)).astype(np.int32)
    eng = E.Engine(cfg, packed, cass=cass,
                   ecfg=E.EngineConfig(gamma=GAMMA), device="cpu")
    ar, st_ar = eng.generate({"tokens": torch.from_numpy(prompts)}, MAX_NEW,
                             speculative=False)
    spec, _ = eng.generate({"tokens": torch.from_numpy(prompts)}, MAX_NEW)
    return {"jcfg": jcfg, "jcass": jcass, "jplain": jplain,
            "jpacked": jpacked, "cfg": cfg, "cass": cass, "packed": packed,
            "prompts": prompts, "eng": eng, "ar": ar.numpy()[:, :MAX_NEW],
            "margins": st_ar["margins"],
            "spec": spec.numpy()[:, :MAX_NEW]}


def _serve(setup, params=None, cass="same", max_new=MAX_NEW, prompts=None,
           stops=None, **kw):
    """Run the port's scheduler over the prompts; returns (sched, outputs)."""
    args = {**KW, "paged": True, **kw}
    sched = S.Scheduler(setup["cfg"],
                        setup["packed"] if params is None else params,
                        cass=setup["cass"] if cass == "same" else cass,
                        ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                        **args)
    ps = setup["prompts"] if prompts is None else prompts
    reqs = [sched.submit(p, max_new=max_new,
                         stop_tokens=(stops or {}).get(i))
            for i, p in enumerate(ps)]
    sched.run()
    return sched, [r.output for r in reqs]


@pytest.fixture(scope="module")
def kernel_run(setup):
    """Paged, packed, the paged-attention kernels on, fused, overlap on."""
    return _serve(setup, attn_kernel="on")


def _teacher_gap(setup, tokens: np.ndarray):
    """Width-1 decode along ``tokens`` (B,n), teacher-forced, in both
    packages from the same prompts. Returns (largest |logit| difference,
    port logits (B,n,V), reference logits (B,n,V))."""
    jcfg, jcass, jpacked = setup["jcfg"], setup["jcass"], setup["jpacked"]
    jrt = JRuntime(cfg=jcfg, cass=jcass, view="target")
    jprefill = jax.jit(lambda p, b, c: JM.forward_prefill(jrt, p, b, c))
    jdecode = jax.jit(lambda p, t, c: JM.forward_decode(jrt, p, t, c))
    jcommit = jax.jit(lambda c, u, n: JE.commit(jrt, c, u, n))
    b, n = tokens.shape
    s_max = PROMPT + n + 1
    jlg, jcache = jprefill(jpacked, {"tokens": jnp.asarray(setup["prompts"])},
                           JKC.init_cache(jcfg, jcass, b, s_max, packed=True))
    jl = [TP.f32(jlg[:, -1])]
    eng = setup["eng"]
    rt = dataclasses.replace(eng.rt, view="target")
    with torch.inference_mode():
        lg, cache = AR.prefill(eng, torch.from_numpy(setup["prompts"]), s_max)
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


def test_port_scheduler_matches_reference_scheduler(setup, kernel_run):
    """The port's scheduler (paged, packed, kernels on, fused, overlap)
    against the reference's (paged, packed, ``attn_kernel="jnp"``) on the
    same weights and prompts.

    Inside the port the scheduler's tokens equal the port's own
    autoregressive ``Engine.generate`` bit for bit. Against the reference,
    tau is twice the largest logit difference between the packages over
    teacher-forced width-1 decode steps along those tokens (measured
    0.0088, tau 0.0176: the packages round bf16 at different places).
    SMOKE margins are a few bf16 ulps (0.004-0.14 here) and the first one
    below tau cuts the rest of its row, so the prefix rule compares 3 of
    24 positions (13%), all equal; the reference's tokens in fact differ
    from the port's at one position of 24, where the margin is 0.0039.
    Held besides: at every teacher-forced position whose margin is at
    least tau (16 of 24, 67%) both packages pick the same token."""
    _, outs = kernel_run
    port = np.array(outs)
    np.testing.assert_array_equal(port, setup["ar"])
    js = JS.Scheduler(setup["jcfg"], setup["jpacked"], cass=setup["jcass"],
                      ecfg=JE.EngineConfig(gamma=GAMMA),
                      rt_extra={"ssm_chunk": 8}, paged=True,
                      attn_kernel="jnp", **KW)
    jreqs = [js.submit(p, max_new=MAX_NEW) for p in setup["prompts"]]
    js.run()
    ref = np.array([r.output for r in jreqs])
    assert ref.shape == port.shape
    gap, pl, jl = _teacher_gap(setup, port)
    tau = 2 * gap
    assert gap < 0.02, gap
    compared, _ = AR.tau_prefix(ref, port, setup["margins"], tau, MAX_NEW)
    assert compared >= 3, (compared, tau)
    np.testing.assert_array_equal(pl.argmax(-1), port)
    sure = AR.top2_margins(torch.from_numpy(pl)) >= tau
    assert sure.mean() >= 0.6, sure.mean()
    np.testing.assert_array_equal(jl.argmax(-1)[sure], port[sure])
    assert all(c == 1 for c in js.trace_counts.values())


@pytest.mark.parametrize("variant", [
    {"attn_kernel": "off"},                    # gather path
    {"paged": False},                          # slot layout
    {"attn_kernel": "on", "fused": False},     # alternating
    {"attn_kernel": "on", "overlap": False},   # synchronous fused
])
def test_serving_paths_bitwise_equal(setup, kernel_run, variant):
    """Kernel on == off, paged == slot, fused == alternating, overlap on ==
    off: the same tokens bit for bit (the CPU's sums do not depend on the
    batch composition or the pass width), and == ``Engine.generate``."""
    sched, outs = _serve(setup, **variant)
    assert outs == kernel_run[1]
    np.testing.assert_array_equal(np.array(outs), setup["spec"])
    assert all(len(o) == MAX_NEW for o in outs)
    assert all(c == 1 for c in sched.trace_counts.values())


def test_autoregressive_kernel_on_equals_off(setup):
    """Plain bf16 pools, autoregressive (the kernel serves the variant-0
    baseline at T=1): tokens equal the gather path's."""
    plain = TP.to_port(setup["jplain"])
    outs = {k: _serve(setup, params=plain, cass=None, speculative=False,
                      attn_kernel=k)[1] for k in ("off", "on")}
    assert outs["on"] == outs["off"]
    assert all(len(o) == MAX_NEW for o in outs["on"])


def test_one_operand_shape_per_step(setup):
    """A trace with staggered arrivals, prompts of several lengths, stop
    tokens and a prefill budget: every step is dispatched at one operand
    shape (one CUDA graph bucket each), and the allocator invariants hold
    throughout (``REPRO_DEBUG_INVARIANTS``). ``reset()`` starts a fresh
    run on the same cache, in the same buckets."""
    rng = np.random.default_rng(3)
    sched = S.Scheduler(setup["cfg"], setup["packed"], cass=setup["cass"],
                        ecfg=E.EngineConfig(gamma=GAMMA), device="cpu",
                        paged=True, attn_kernel="on",
                        max_prefill_tokens_per_step=5, **KW)
    reqs = []
    for i in range(5):
        n = int(rng.integers(3, PROMPT + 1))
        reqs.append(sched.submit(rng.integers(0, 512, n), max_new=6,
                                 arrival=float(i), stop_tokens=[7, 11]))
    sched.run()
    assert all(r.done for r in reqs)
    assert sched.trace_counts == {"chunk": 1, "unified": 1}
    assert sched.summary()["peak_prefill_tokens_per_cycle"] <= 5
    sched.check_invariants()
    assert sched.pool.allocated_total == 0
    # a second run after reset() on the same cache: the same buckets
    sched.reset()
    again = [sched.submit(p, max_new=MAX_NEW) for p in setup["prompts"]]
    sched.run()
    assert [r.output for r in again] == setup["spec"].tolist()
    assert sched.trace_counts == {"chunk": 1, "unified": 1}


def test_late_retire_zombies_are_discarded(setup):
    """A stop token landing on a free-running pure-decode stretch retires
    its row one cycle late: the extra cycle's results are discarded
    (``zombie_rows``) and the outputs equal the synchronous run's."""
    kw = dict(attn_kernel="on", max_new=14, s_max=PROMPT + 14 + GAMMA + 1)
    _, base = _serve(setup, overlap=False, **kw)
    row = 1
    stop = base[row][8]
    assert stop not in base[row][:8]
    runs = {ov: _serve(setup, overlap=ov, stops={row: [stop]}, **kw)
            for ov in (False, True)}
    assert runs[True][1] == runs[False][1]
    assert runs[True][1][row] == base[row][:9]
    assert runs[True][0].summary()["zombie_rows"] >= 1


def test_retirement_and_latency(setup, kernel_run):
    sched, outs = kernel_run
    s = sched.summary()
    assert s["finished"] == 3 and sched.idle
    assert s["ttft_cycles_p50"] is not None and s["itl_cycles_p50"] >= 0
    assert s["tokens_per_cycle"] > 0 and 0.0 <= s["acceptance"] <= 1.0
    assert s["subsystems"]["attn_kernel"] == "on"
    # an eos that appears in an output ends that request there, inclusive
    eos = outs[2][3]
    cut = outs[2].index(eos) + 1
    _, got = _serve(setup, attn_kernel="on", stops={2: [eos]})
    assert got[2] == outs[2][:cut]
    assert got[:2] == outs[:2]


def test_refusals(setup):
    with pytest.raises(NotImplementedError, match="item 7"):
        _serve(setup, prefix_cache=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        _serve(setup, swap=True)
    with pytest.raises(ValueError, match="attn_kernel"):
        _serve(setup, attn_kernel="jnp")
    with pytest.raises(ValueError, match="paged"):
        _serve(setup, paged=False, attn_kernel="on")
    with pytest.raises(ValueError, match="chunk_size"):
        _serve(setup, chunk_size=GAMMA)
    with pytest.raises(ValueError, match="capacity"):
        _serve(setup, max_new=KW["s_max"])
    rt = dataclasses.replace(setup["eng"].rt, attn_kernel="on")
    cache = E.KC.init_cache(setup["cfg"], setup["cass"], 1, 16, packed=True,
                            device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        M.forward_decode(rt, setup["packed"], torch.zeros((1, 1),
                                                          dtype=torch.int32),
                         cache)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            S.Scheduler(setup["cfg"], setup["packed"], cass=setup["cass"])


def test_serve_cli_scheduler_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.run(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                   "--scheduler", "--paged", "--attn-kernel", "on",
                   "--requests", "3", "--prompt-len", "8", "--max-new", "6",
                   "--block-size", "4", "--chunk-size", "8"])
    text = out.getvalue()
    assert "[sched:fused] 3 reqs through 2 slots" in text
    assert "[kernel] attn=on" in text and "[paged] pool=" in text
    assert "{'chunk': 1, 'unified': 1} on cpu" in text
    assert text.count(": 6 tokens") == 3
    for bad in (["--paged"], ["--scheduler", "--attn-kernel", "on"]):
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                serve.run(["--arch", "llama3-8b", "--smoke", "--device",
                           "cpu", *bad])
