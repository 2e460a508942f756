"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

Run on a machine with an NVIDIA card and the CUDA toolkit:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only the port, so it runs where JAX is not installed;
the plain versions it holds the kernels to are checked against the JAX
package by the other ``tests/test_torch_*.py`` files.
"""
import numpy as np
import pytest
import torch

import torch_ar as AR
from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig, format_weight
from repro_torch.core.packing import format_params
from repro_torch.kernels import draft_matmul as DM
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Engine, EngineConfig

# (in, out): superblocks of 512/256/128 values, ragged N edges
SHAPES = [(1024, 96), (512, 40), (256, 64), (128, 33), (512, 300)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc: run `python -m pytest "
                    "-m cuda tests/test_torch_cuda.py` there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _operands(shape, card, trunc=4):
    cass = CassandraConfig(variant=1, weight_trunc=trunc)
    gen = torch.Generator().manual_seed(shape[0] * 7 + shape[1] + trunc)
    w = torch.randn(shape, generator=gen).to(torch.bfloat16)
    spec, _ = format_weight(w, None, cass)
    ops = DM.prepare_draft_operands(spec, cass, shape)
    args = [ops[k].to(card) for k in ("bitmap", "signmant", "exp3", "emax",
                                      "book")]
    block = cass.weight_block(shape[0])
    kw = dict(block=block, keep=cass.weight_keep(block), trunc=trunc,
              exp_bits=cass.exp_bits)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 16, 37])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_card(card, shape, m):
    """y within rtol 2e-2 / atol 1e-3 of the plain version (exact bf16
    products in f32, another sum order); the decoded weight, read back
    through identity rows, bit for bit."""
    args, kw = _operands(shape, card)
    gen = torch.Generator(device=card).manual_seed(m)
    x = torch.randn((m, shape[0]), generator=gen, device=card).to(
        torch.bfloat16)
    before = DM.draft_matmul.launches
    y = DM.draft_matmul(x, *args, **kw)
    torch.cuda.synchronize()
    assert DM.draft_matmul.launches == before + 1
    torch.testing.assert_close(y, DM.draft_matmul_plain(x, *args, **kw),
                               rtol=2e-2, atol=1e-3)
    eye = torch.eye(shape[0], dtype=torch.bfloat16, device=card)
    w = DM.draft_matmul(eye, *args, **kw).to(torch.bfloat16)
    assert torch.equal(w.view(torch.int16), DM.draft_weight_plain(
        *args, **kw).contiguous().view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [0, 2, 7])
def test_kernel_other_mantissa_widths(card, trunc):
    args, kw = _operands((512, 64), card, trunc)
    eye = torch.eye(512, dtype=torch.bfloat16, device=card)
    w = DM.draft_matmul(eye, *args, **kw).to(torch.bfloat16)
    assert torch.equal(w.view(torch.int16), DM.draft_weight_plain(
        *args, **kw).contiguous().view(torch.int16))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    args, kw = _operands((512, 40), card)
    x = torch.zeros((4, 512), dtype=torch.bfloat16, device=card)
    with pytest.raises(TypeError, match="dtype"):
        DM.draft_matmul(x.float(), *args, **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        DM.draft_matmul(torch.zeros((4, 1024), dtype=torch.bfloat16,
                                    device=card)[:, ::2], *args, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        DM.draft_matmul(x, args[0].cpu(), *args[1:], **kw)
    with pytest.raises(ValueError, match="K=256"):
        DM.draft_matmul(x[:, :256].contiguous(), *args, **kw)


@pytest.mark.cuda
def test_engine_on_card_spec_equals_ar_and_counts_launches(card):
    """Spec tokens equal the tokens of autoregressive steps run at the
    verify width (bit for bit: same widths, same sums), and the engine's
    width-1 autoregressive tokens under the near-tie rule."""
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(0)
    params = format_params(init_params(cfg, gen, device=card), cass)
    eng = Engine(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (3, 16),
                                      generator=gen, device=card)}
    ar, st_ar = eng.generate(prompt, 12, speculative=False)
    DM.draft_matmul.launches = 0
    spec, st = eng.generate(prompt, 12)
    assert DM.draft_matmul.launches == st["draft_passes"] * (
        7 * cfg.n_layers + 1)
    assert AR.verify_gap(eng, prompt["tokens"], 3, 4) == 0.0
    wide, _ = AR.ar_steps(eng, prompt["tokens"], 12, 4)
    np.testing.assert_array_equal(spec[:, :12].cpu().numpy(),
                                  wide.cpu().numpy())
    tau = 2 * AR.verify_gap(eng, prompt["tokens"], 3, 1)
    AR.tau_prefix(spec.cpu().numpy(), ar.cpu().numpy(), st_ar["margins"],
                  tau, 12)


# ---------------------------------------------------------------------------
# Paged attention kernels (paged_gqa, paged_gqa_packed)
# ---------------------------------------------------------------------------

def _paged_inputs(card, *, d, t, bs, seed, nb=24, b=4, hkv=2, g=4, mb=6):
    """Pools, a table with out-of-range entries and ragged lengths (one 0)
    on the card; the packed pools come from the port's encoder, half
    their rows spread over 2^±20 (delta mode, escape codes)."""
    from repro_torch.serving import kvcache as KC
    cass = CassandraConfig()
    gen = torch.Generator().manual_seed(seed)

    def vals():
        x = torch.randn((nb, bs, hkv, d), generator=gen) * 0.25
        spread = torch.exp2(torch.randint(-20, 20, x.shape, generator=gen)
                            .float())
        rows = torch.rand((nb, bs, hkv, 1), generator=gen) < 0.5
        return torch.where(rows, x * spread, x).to(torch.bfloat16)

    book = KC.default_kv_codebook()
    k, v = vals(), vals()
    ks = KC.encode_store(cass, k, d, book)["spec"]
    vs = KC.encode_store(cass, v, d, book)["spec"]
    eor = torch.zeros(256, dtype=torch.uint8)
    eor[:book[0].shape[0]] = book[0]
    table = torch.randint(1, nb, (b, mb), generator=gen, dtype=torch.int32)
    table[0, -1], table[1, 0], table[2, 2] = -5, nb + 3, 0
    length = torch.tensor([mb * bs - 3, 0, bs * 2 + 1, 1][:b],
                          dtype=torch.int32)
    q = torch.randn((b, t, hkv, g, d), generator=gen).to(torch.bfloat16)
    to = lambda tree: {n: x.to(card) for n, x in tree.items()}
    kw = dict(d=d, keep=cass.kv_keep(d), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits)
    return (q.to(card), k.to(card), v.to(card), to(ks), to(vs),
            table.to(card), length.to(card), eor.to(card), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d,bs", [(64, 4), (128, 16), (128, 32)])
def test_decode_spec_pool_bitwise_on_card(card, d, bs):
    from repro_torch.kernels import paged_attention as PA
    _, k, _, ks, _, _, _, eor, kw = _paged_inputs(card, d=d, t=1, bs=bs,
                                                  seed=d + bs)
    assert (ks["exp_mode"] == 1).any() and (ks["exp_mode"] == 0).any()
    out = PA.decode_spec_pool(ks, eor, **kw)
    ref = PA.decode_spec_pool_plain(ks, eor, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    # arbitrary words too: popcounts above keep, any mode, emax and code
    gen = torch.Generator().manual_seed(d)
    rnd = {n: torch.randint(-2 ** 31, 2 ** 31 - 1, x.shape, generator=gen,
                            dtype=torch.int32).to(card)
           if x.dtype == torch.int32 else
           torch.randint(0, 256 if n == "exp_emax" else 2, x.shape,
                         generator=gen, dtype=torch.uint8).to(card)
           for n, x in ks.items()}
    book = torch.randint(0, 256, (256,), generator=gen,
                         dtype=torch.uint8).to(card)
    out = PA.decode_spec_pool(rnd, book, **kw)
    ref = PA.decode_spec_pool_plain(rnd, book, **kw)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("d,bs", [(64, 4), (128, 16)])
def test_paged_kernels_match_plain_on_card(card, t, d, bs):
    """(acc, m, l) within rtol 1e-4 / atol 1e-5 of the plain versions
    (same f32 steps, other sum orders), the empty row exactly initial."""
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ks, vs, table, length, eor, kw = _paged_inputs(
        card, d=d, t=t, bs=bs, seed=t * 7 + d)
    scale = d ** -0.5
    before = (PA.paged_gqa.launches, PA.paged_gqa_packed.launches)
    got = PA.paged_gqa(q, k, v, table, length, scale=scale)
    want = PA.paged_gqa_plain(q, k, v, table, length, scale=scale)
    got_p = PA.paged_gqa_packed(q, ks, vs, table, length, eor, scale=scale,
                                **kw)
    want_p = PA.paged_gqa_packed_plain(q, ks, vs, table, length, eor,
                                       scale=scale, **kw)
    torch.cuda.synchronize()
    assert (PA.paged_gqa.launches, PA.paged_gqa_packed.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in list(zip(got, want)) + list(zip(got_p, want_p)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert (got[0][1] == 0).all() and (got[1][1] == PA.NEG_INF).all()


@pytest.mark.cuda
def test_paged_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ks, vs, table, length, eor, kw = _paged_inputs(
        card, d=64, t=1, bs=4, seed=3)
    with pytest.raises(TypeError, match="dtype"):
        PA.paged_gqa(q.float(), k, v, table, length, scale=1.0)
    with pytest.raises(ValueError, match="is on cpu"):
        PA.paged_gqa(q, k.cpu(), v, table, length, scale=1.0)
    with pytest.raises(TypeError, match="dtype"):
        PA.paged_gqa(q, k, v, table.long(), length, scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        PA.paged_gqa(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     v[..., :48].contiguous(), table, length, scale=1.0)
    with pytest.raises(ValueError, match="book"):
        PA.paged_gqa_packed(q, ks, vs, table, length, eor.int(), scale=1.0,
                            **kw)


@pytest.mark.cuda
def test_paged_scheduler_on_card_counts_launches(card):
    """The paged scheduler at SMOKE width with the kernels on: every draft
    pass runs ``paged_gqa_packed`` once per layer, every target pass
    (verify, prefill chunk) ``paged_gqa`` once per layer; fused ==
    alternating and overlap on == off, bit for bit."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving.scheduler import Scheduler
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(0)
    params = format_params(init_params(cfg, gen, device=card), cass)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                            device=card).cpu().numpy()
    outs = {}
    for name, kw in (("fused", {}), ("alt", {"fused": False}),
                     ("sync", {"overlap": False})):
        sched = Scheduler(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3),
                          num_slots=3, s_max=48, paged=True, block_size=4,
                          chunk_size=8, attn_kernel="on", **kw)
        reqs = [sched.submit(p, max_new=10) for p in prompts]
        before = (PA.paged_gqa.launches, PA.paged_gqa_packed.launches)
        sched.run()
        s = sched.summary()
        targets = s["cycles"]
        drafts = 3 * (s["cycles"] - s["prefill_cycles"] + s["mixed_cycles"])
        assert PA.paged_gqa.launches - before[0] == targets * cfg.n_layers
        assert PA.paged_gqa_packed.launches - before[1] == \
            drafts * cfg.n_layers
        assert all(len(r.output) == 10 for r in reqs)
        assert all(c == 1 for c in s["trace_counts"].values())
        outs[name] = [r.output for r in reqs]
    assert outs["fused"] == outs["alt"] == outs["sync"]
