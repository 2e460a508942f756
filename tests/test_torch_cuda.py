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


@pytest.fixture
def fresh_plans():
    """Clears the wrappers' cached launch plans around a test that forces
    other plans by patching the CTA targets."""
    from repro_torch.kernels import paged_attention as PA
    DM._launch_shape.cache_clear()
    PA._split_plan.cache_clear()
    PA._plain_plan.cache_clear()
    yield
    DM._launch_shape.cache_clear()
    PA._split_plan.cache_clear()
    PA._plain_plan.cache_clear()


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


def _card_operands(shape, card, trunc):
    """A C-1 weight of ``shape`` formatted on the card (full-size shapes)."""
    cass = CassandraConfig(variant=1, weight_trunc=trunc)
    gen = torch.Generator(device=card).manual_seed(shape[0] + shape[1])
    w = torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
    spec, _ = format_weight(w, None, cass)
    ops = DM.prepare_draft_operands(spec, cass, shape)
    block = cass.weight_block(shape[0])
    kw = dict(block=block, keep=cass.weight_keep(block), trunc=trunc,
              exp_bits=cass.exp_bits)
    return [ops[k] for k in ("bitmap", "signmant", "exp3", "emax",
                             "book")], kw


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out,trunc", [
    (512, 1024, 4),        # NB 1
    (1536, 1000, 4),       # NB 3, ragged N
    (7168, 576, 4),        # NB 14, the MLA kv_a projection
    (14336, 1024, 4),      # NB 28 (w_down's depth)
    (1536, 576, 0),        # 8-bit sign|mantissa codes
    (7168, 1000, 7)])      # 1-bit codes
def test_kernel_plans_match_plain_on_card(card, n_in, n_out, trunc,
                                          monkeypatch, fresh_plans):
    """Every M of a decode batch and beyond, the main path's plan and
    plans forced unsplit and to one superblock a split by the CTA target:
    y within rtol 2e-2 / atol 1e-3 of the plain version, one launch counted
    per call; the decoded weight bit for bit through identity rows under
    every plan; two launches equal bit for bit."""
    args, kw = _card_operands((n_in, n_out), card, trunc)
    nb = n_in // kw["block"]
    gen = torch.Generator(device=card).manual_seed(n_in + trunc)
    eye = torch.eye(n_in, dtype=torch.bfloat16, device=card)
    w_plain = DM.draft_weight_plain(*args, **kw).contiguous()
    for target, splits in ((DM.TARGET_CTAS, None), (1, 1), (10 ** 9, nb)):
        monkeypatch.setattr(DM, "TARGET_CTAS", target)
        DM._launch_shape.cache_clear()
        assert splits in (None, DM.plan(4, n_out, nb)[1])
        for m in (1, 3, 4, 5, 8, 9, 17):
            x = torch.randn((m, n_in), generator=gen, device=card).to(
                torch.bfloat16)
            before = DM.draft_matmul.launches
            y = DM.draft_matmul(x, *args, **kw)
            y2 = DM.draft_matmul(x, *args, **kw)
            torch.cuda.synchronize()
            assert DM.draft_matmul.launches == before + 2
            torch.testing.assert_close(
                y, DM.draft_matmul_plain(x, *args, **kw), rtol=2e-2,
                atol=1e-3)
            assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
        w = DM.draft_matmul(eye, *args, **kw).to(torch.bfloat16)
        assert torch.equal(w.view(torch.int16), w_plain.view(torch.int16))


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
@pytest.mark.parametrize("fmt", [None, ((0.3, 0), (0.6, 5)),
                                 ((0.6, 5), (0.3, 0))])
def test_engine_on_card_spec_equals_ar_and_counts_launches(card, fmt):
    """Spec tokens equal the tokens of autoregressive steps run at the
    verify width (bit for bit: same widths, same sums), and the engine's
    width-1 autoregressive tokens under the near-tie rule; at the paper's
    default format and at two corners of its grid ((weight prune, trunc),
    (KV prune, trunc))."""
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    if fmt is not None:
        cass = CassandraConfig(variant=1, gamma=3, weight_prune=fmt[0][0],
                               weight_trunc=fmt[0][1], kv_prune=fmt[1][0],
                               kv_trunc=fmt[1][1])
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

def _paged_inputs(card, *, d, t, bs, seed, nb=24, b=4, hkv=2, g=4, mb=6,
                  cass=None, book=None):
    """Pools, a table with out-of-range entries and ragged lengths (one 0)
    on the card; the packed pools come from the port's encoder, half
    their rows spread over 2^±20 (delta mode, escape codes). ``cass``
    sets the KV format (the paper's default when None) and ``book`` the
    codebook (``default_kv_codebook`` when None)."""
    from repro_torch.serving import kvcache as KC
    cass = cass or CassandraConfig()
    gen = torch.Generator().manual_seed(seed)

    def vals():
        x = torch.randn((nb, bs, hkv, d), generator=gen) * 0.25
        spread = torch.exp2(torch.randint(-20, 20, x.shape, generator=gen)
                            .float())
        rows = torch.rand((nb, bs, hkv, 1), generator=gen) < 0.5
        return torch.where(rows, x * spread, x).to(torch.bfloat16)

    book = book or KC.default_kv_codebook()
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


def _nan_unread(spec, table, length, bs):
    """The speculation words of every pool row that no valid position of
    the walk reads set to decode as NaN (delta mode, exponent 255, a
    nonzero mantissa)."""
    nb = spec["bitmap"].shape[0]
    live = torch.zeros((nb, bs), dtype=torch.bool)
    for row, n in enumerate(length.tolist()):
        for j, blk in enumerate(table[row].tolist()):
            k = min(bs, n - j * bs)
            if k > 0:
                live[blk if 0 <= blk < nb else 0, :k] = True
    dead = ~live.to(spec["bitmap"].device)
    out = {}
    for name, x in spec.items():
        fill = {"bitmap": -1, "signmant": -1, "exp_words": 0,
                "exp_mode": 1, "exp_emax": 255}[name]
        d = dead.reshape(nb, bs, *([1] * (x.ndim - 2)))
        out[name] = torch.where(d, torch.full_like(x, fill), x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("split", [None, 1, 2, 6])
def test_paged_gqa_packed_splits_on_card(card, t, split, monkeypatch,
                                         fresh_plans):
    """The flash-decoding split of the packed kernel: rows shorter than one
    split (33 and 1 tokens at 3 blocks a split), a row that ends mid-block,
    an empty row, out-of-range table entries, NaN in every unread pool row;
    (acc, m, l) within rtol 1e-4 / atol 1e-5 of the plain version, one
    launch counted per call, two launches equal bit for bit. A split
    count other than the main path's (None) is forced by the CTA target."""
    from repro_torch.kernels import paged_attention as PA
    q, _, _, ks, vs, table, length, eor, kw = _paged_inputs(
        card, d=128, t=t, bs=16, seed=40 + t)
    b, _, hkv, g = q.shape[:4]
    if split is not None:
        monkeypatch.setattr(PA, "TARGET_CTAS",
                            split * b * hkv * -(-(g * t) // PA.Q_TILE))
        assert PA._split_plan(b, hkv, g, t, table.shape[1])[1] == split
    ks, vs = (_nan_unread(sp, table.cpu(), length.cpu(), 16)
              for sp in (ks, vs))
    dead = PA.decode_spec_pool_plain(vs, eor, **kw)
    assert dead.isnan().any()
    scale = 128 ** -0.5
    before = PA.paged_gqa_packed.launches
    got = PA.paged_gqa_packed(q, ks, vs, table, length, eor, scale=scale,
                              **kw)
    again = PA.paged_gqa_packed(q, ks, vs, table, length, eor, scale=scale,
                                **kw)
    want = PA.paged_gqa_packed_plain(q, ks, vs, table, length, eor,
                                     scale=scale, **kw)
    torch.cuda.synchronize()
    assert PA.paged_gqa_packed.launches == before + 2
    for a, b, c in zip(got, again, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
    assert (got[0][1] == 0).all() and (got[1][1] == PA.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("split", [None, 1, 2, 6])
@pytest.mark.parametrize("d,bs", [(64, 4), (128, 16)])
def test_paged_gqa_splits_on_card(card, t, split, d, bs, monkeypatch,
                                  fresh_plans):
    """The flash-decoding split of the plain-pool kernel, as the packed
    kernel's test holds it: rows shorter than one split, a row that ends
    mid-block, an empty row, out-of-range table entries, NaN in every pool
    row no valid position reads; (acc, m, l) within rtol 1e-4 / atol 1e-5
    of the plain walk and of the split walk in plain torch, one launch
    counted per call, two launches equal bit for bit."""
    from repro_torch.kernels import paged_attention as PA
    q, k, v, _, _, table, length, _, _ = _paged_inputs(
        card, d=d, t=t, bs=bs, seed=60 + t + d)
    b, _, hkv, g = q.shape[:4]
    if split is not None:
        monkeypatch.setattr(PA, "TARGET_CTAS",
                            split * b * hkv * -(-(g * t) // PA.Q_TILE))
    bps, splits = PA._plain_plan(b, hkv, g, t, table.shape[1])
    assert split is None or splits == split
    live = torch.zeros(k.shape[:2], dtype=torch.bool)
    for row, n in enumerate(length.tolist()):
        for j, blk in enumerate(table[row].tolist()):
            c = min(bs, n - j * bs)
            if c > 0:
                live[blk if 0 <= blk < k.shape[0] else 0, :c] = True
    dead = ~live.to(card)[:, :, None, None]
    k, v = (torch.where(dead, float("nan"), x).to(torch.bfloat16)
            for x in (k, v))
    scale = d ** -0.5
    before = PA.paged_gqa.launches
    got = PA.paged_gqa(q, k, v, table, length, scale=scale)
    again = PA.paged_gqa(q, k, v, table, length, scale=scale)
    want = PA.paged_gqa_plain(q, k, v, table, length, scale=scale)
    want_s = PA.paged_gqa_split_plain(q, k, v, table, length, scale=scale,
                                      blocks_per_split=bps)
    torch.cuda.synchronize()
    assert PA.paged_gqa.launches == before + 2
    for a, a2, c, cs in zip(got, again, want, want_s):
        assert torch.isfinite(a).all()
        assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a, cs, rtol=1e-4, atol=1e-5)
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
    off = torch.empty(k.numel() + 4, dtype=k.dtype, device=card)
    off = off[4:].view(k.shape)                     # 8 bytes off 16
    off.copy_(k)
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_gqa(q, off, v, table, length, scale=1.0)
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


# ---------------------------------------------------------------------------
# MLA: paged_mla, the Engine and the paged scheduler
# ---------------------------------------------------------------------------

def _mla_inputs(card, *, lat, rope, t, bs, seed, nb=32, b=4, h=8, mb=6):
    """Latent pools with NaN in every row no valid position reads (trash
    block, unused blocks, tails of partial blocks), a table with
    out-of-range entries in masked slots and ragged lengths (one 0)."""
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(nb - 1, generator=gen) + 1
    table = perm[:b * mb].reshape(b, mb).to(torch.int32)
    length = torch.tensor([mb * bs - 3, 0, bs * 2 + 1, 1][:b],
                          dtype=torch.int32)
    c = torch.randn((nb, bs, lat), generator=gen).to(torch.bfloat16)
    kr = torch.randn((nb, bs, rope), generator=gen).to(torch.bfloat16)
    live = torch.zeros((nb, bs), dtype=torch.bool)
    for row in range(b):
        for j in range(mb):
            n = min(bs, int(length[row]) - j * bs)
            if n > 0:
                live[table[row, j], :n] = True
            else:
                table[row, j] = (-5, nb + 3, 0)[(row + j) % 3]
    c[~live], kr[~live] = float("nan"), float("nan")
    q_eff = torch.randn((b, t, h, lat), generator=gen)
    q_rope = torch.randn((b, t, h, rope), generator=gen)
    return tuple(x.to(card) for x in (q_eff, q_rope, c, kr, table, length))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("lat,rope,bs", [(64, 16, 4), (512, 64, 16),
                                         (128, 32, 32)])
def test_paged_mla_matches_plain_on_card(card, t, lat, rope, bs):
    """(acc, m, l) within rtol 1e-4 / atol 1e-5 of the plain version (same
    f32 steps, other sum orders), no masked NaN in the state, the empty
    row exactly initial."""
    from repro_torch.kernels import paged_attention as PA
    args = _mla_inputs(card, lat=lat, rope=rope, t=t, bs=bs,
                       seed=t * 7 + lat)
    scale = (128 + rope) ** -0.5
    before = PA.paged_mla.launches
    got = PA.paged_mla(*args, scale=scale)
    want = PA.paged_mla_plain(*args, scale=scale)
    torch.cuda.synchronize()
    assert PA.paged_mla.launches == before + 1
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    acc, m, l = got
    assert (acc[1] == 0).all() and (m[1] == PA.NEG_INF).all() \
        and (l[1] == 0).all()


@pytest.mark.cuda
def test_paged_mla_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import paged_attention as PA
    q_eff, q_rope, c, kr, table, length = _mla_inputs(
        card, lat=64, rope=16, t=1, bs=4, seed=3)
    with pytest.raises(TypeError, match="dtype"):
        PA.paged_mla(q_eff.bfloat16(), q_rope, c, kr, table, length,
                     scale=1.0)
    with pytest.raises(ValueError, match="is on cpu"):
        PA.paged_mla(q_eff, q_rope, c.cpu(), kr, table, length, scale=1.0)
    with pytest.raises(ValueError, match="latent 48"):
        PA.paged_mla(q_eff[..., :48].contiguous(), q_rope,
                     c[..., :48].contiguous(), kr, table, length, scale=1.0)
    with pytest.raises(ValueError, match="shape"):
        PA.paged_mla(q_eff, q_rope, c, kr[..., :8].contiguous(), table,
                     length, scale=1.0)


def _mla_smoke(card):
    """deepseek-v3 SMOKE cut to its dense layers, rope 32 (packable), C-1,
    random weights on the card."""
    import dataclasses
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              n_layers=2, first_dense_layers=2,
                              qk_rope_dim=32)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(0)
    plain = init_params(cfg, gen, device=card)
    return cfg, cass, plain, format_params(plain, cass), gen


@pytest.mark.cuda
def test_mla_engine_on_card_spec_equals_verify_width_ar(card):
    """C-1 speculative tokens equal autoregressive steps run at the verify
    width on every position; every KV commit encodes c and kr through
    kv_encode (no standalone kv_topk)."""
    from repro_torch.kernels import kv_topk as KT
    cfg, cass, _, packed, gen = _mla_smoke(card)
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                           device=card).to(torch.int32)
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=3))
    before = (KT.kv_encode.launches, KT.kv_topk.launches)
    spec, st = eng.generate({"tokens": prompt}, max_new=12)
    assert KT.kv_encode.launches - before[0] == 2 * (1 + st["cycles"])
    assert KT.kv_topk.launches == before[1]
    assert AR.verify_gap(eng, prompt, 3, 4) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, 12, 4)
    assert torch.equal(spec[:, :12].cpu(), toks.cpu())


@pytest.mark.cuda
def test_mla_scheduler_on_card_counts_launches(card):
    """The paged scheduler on the MLA model with the kernel on: every pass
    (draft, verify, prefill chunk) runs ``paged_mla`` once per layer;
    fused == alternating and overlap on == off, bit for bit; the bf16
    autoregressive baseline runs it once per layer per step."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving.scheduler import Scheduler
    cfg, cass, plain, packed, gen = _mla_smoke(card)
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                            device=card).cpu().numpy()
    outs = {}
    for name, params, c, kw in (("fused", packed, cass, {}),
                                ("alt", packed, cass, {"fused": False}),
                                ("sync", packed, cass, {"overlap": False}),
                                ("ar", plain, None, {})):
        sched = Scheduler(cfg, params, cass=c, ecfg=EngineConfig(gamma=3),
                          num_slots=3, s_max=48, paged=True, block_size=4,
                          chunk_size=8, attn_kernel="on",
                          speculative=c is not None, **kw)
        reqs = [sched.submit(p, max_new=10) for p in prompts]
        before = PA.paged_mla.launches
        sched.run()
        s = sched.summary()
        drafts = 3 * (s["cycles"] - s["prefill_cycles"] + s["mixed_cycles"])
        passes = s["cycles"] + (drafts if c is not None else 0)
        assert PA.paged_mla.launches - before == passes * cfg.n_layers, name
        assert all(len(r.output) == 10 for r in reqs)
        outs[name] = [r.output for r in reqs]
    assert outs["fused"] == outs["alt"] == outs["sync"]


# ---------------------------------------------------------------------------
# Codec kernels (mx_decode, kv_topk, unary_decode)
# ---------------------------------------------------------------------------

def _bits16(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,group", [(320, 32), (80, 16), (64, 32)])
def test_mx_decode_matches_plain_on_card(card, k, group):
    """Bit for bit on every 16-bit container, any sign byte and shared
    exponent, and on containers the encoder made from bf16 values."""
    from repro_torch.core import mx
    from repro_torch.core.bitops import as_int16
    from repro_torch.kernels import mx_decode as MXD
    gen = torch.Generator().manual_seed(k)
    rows = 4096
    m16 = torch.randint(0, 1 << 16, (rows * k,), generator=gen,
                        dtype=torch.int32)
    m16[:1 << 16] = torch.arange(1 << 16, dtype=torch.int32)
    sign = torch.randint(0, 256, (rows, k), generator=gen, dtype=torch.uint8)
    se = torch.randint(0, 256, (rows, k // group), generator=gen,
                       dtype=torch.uint8)
    x = (torch.randn((rows, k), generator=gen) * torch.exp2(torch.randint(
        -12, 13, (rows, k), generator=gen).float())).to(torch.bfloat16)
    enc = mx.mx_encode(x, group)
    for s, m, e in ((sign, as_int16(m16.reshape(rows, k)), se),
                    (enc["sign"], enc["m16"], enc["shared_exp"])):
        s, m, e = s.to(card), m.to(card), e.to(card)
        before = MXD.mx_decode.launches
        got = MXD.mx_decode(s, m, e, group)
        want = MXD.mx_decode_plain(s, m, e, group)
        torch.cuda.synchronize()
        assert MXD.mx_decode.launches == before + 1
        assert torch.equal(_bits16(got), _bits16(want))


def _topk_rows(gen, rows, d):
    v = torch.randn((rows, d), generator=gen).to(torch.bfloat16)
    v[0] = 1.5                                             # all equal
    v[1] = torch.randint(-2, 3, (d,), generator=gen).to(torch.bfloat16)
    v[2, ::2], v[2, 1::2] = -0.0, 0.0                      # +-0 only
    v[3, : d // 2] = -v[3, d // 2:]                        # |v| ties
    v[4, torch.rand(d, generator=gen) < 0.7] = 0.0
    v[5, [1, 7, d - 1]] = float("nan")
    v[6, [0, 5]] = float("inf")
    v[7, :] = -0.0
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("d,keep", [(128, 80), (64, 32), (32, 16),
                                    (256, 160), (128, 128), (512, 304),
                                    (96, 64), (96, 96)])
def test_kv_topk_matches_plain_on_card(card, d, keep):
    """bitmap, kept and pruned bit for bit (NaN payloads included) on
    random rows and forced ties, +-0, all-equal, NaN and inf rows."""
    from repro_torch.kernels import kv_topk as KT
    v = _topk_rows(torch.Generator().manual_seed(d + keep), 3000, d).to(card)
    before = KT.kv_topk.launches
    got = KT.kv_topk(v, keep)
    want = KT.kv_topk_plain(v, keep)
    torch.cuda.synchronize()
    assert KT.kv_topk.launches == before + 1
    assert torch.equal(got["bitmap"], want["bitmap"])
    for name in ("kept", "pruned"):
        assert torch.equal(_bits16(got[name]), _bits16(want[name])), name


@pytest.mark.cuda
@pytest.mark.parametrize("k,density", [(320, None), (80, None), (192, None),
                                       (400, None), (80, 0.05), (320, 0.5),
                                       (400, 0.95)])
def test_unary_decode_matches_plain_on_card(card, k, density):
    """Encoder regions (unary mode; W = 38 crosses one 32-word chunk) and
    arbitrary words of a given density of ones, plus empty and full
    regions."""
    from repro_torch.core import bitops, coding
    from repro_torch.kernels import unary_decode as UD
    gen = torch.Generator().manual_seed(k)
    rows = 2000
    n_bits = coding.region_words(k, 3) * 32
    if density is None:
        ranks = (torch.rand((rows, k), generator=gen) ** 4 * 8).to(
            torch.uint8)
        bits, ok = coding.unary_encode_block(ranks, n_bits)
        bits = bits[ok]
    else:
        bits = torch.rand((rows, n_bits), generator=gen) < density
    bits[0], bits[1] = False, True
    words = bitops.pack_bits(bits).to(card)
    before = UD.unary_decode.launches
    got = UD.unary_decode(words, k)
    want = UD.unary_decode_plain(words, k)
    torch.cuda.synchronize()
    assert UD.unary_decode.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_codec_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import kv_topk as KT, mx_decode as MXD
    from repro_torch.kernels import unary_decode as UD
    sign = torch.zeros((4, 64), dtype=torch.uint8, device=card)
    m16 = torch.zeros((4, 64), dtype=torch.int16, device=card)
    se = torch.zeros((4, 2), dtype=torch.uint8, device=card)
    with pytest.raises(TypeError, match="dtype"):
        MXD.mx_decode(sign, m16.int(), se, 32)
    with pytest.raises(ValueError, match="shape"):
        MXD.mx_decode(sign, m16, se, 16)
    with pytest.raises(ValueError, match="is on cpu"):
        MXD.mx_decode(sign.cpu(), m16, se, 32)
    v = torch.zeros((4, 160), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="d=160"):
        KT.kv_topk(v, 48)
    with pytest.raises(ValueError, match="not contiguous"):
        KT.kv_topk(torch.zeros((4, 256), dtype=torch.bfloat16,
                               device=card)[:, ::2], 32)
    with pytest.raises(TypeError, match="dtype"):
        UD.unary_decode(torch.zeros((4, 8), dtype=torch.int64, device=card),
                        80)


@pytest.mark.cuda
def test_c2_engine_and_scheduler_on_card(card):
    """Cassandra-2 at SMOKE width: spec tokens == AR steps at the verify
    width, bit for bit; every draft and verify pass decodes through
    mx_view (no standalone mx_decode) and every KV encode runs kv_topk; the
    paged scheduler (attention kernel off) == the Engine, overlap on ==
    off."""
    from repro_torch.kernels import kv_topk as KT, mx_decode as MXD
    from repro_torch.serving.scheduler import Scheduler
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=2, gamma=3)
    gen = torch.Generator(device=card).manual_seed(0)
    params = format_params(init_params(cfg, gen, device=card), cass)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (3, 16),
                                      generator=gen, device=card)}
    eng = Engine(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3))
    MXD.mx_decode.launches = MXD.mx_view.launches = KT.kv_topk.launches = 0
    spec, st = eng.generate(prompt, 12)
    assert MXD.mx_view.launches > 0 and KT.kv_topk.launches > 0
    assert MXD.mx_decode.launches == 0
    wide, _ = AR.ar_steps(eng, prompt["tokens"], 12, 4)
    np.testing.assert_array_equal(spec[:, :12].cpu().numpy(),
                                  wide.cpu().numpy())
    outs = []
    for kw in ({}, {"overlap": False}):
        sched = Scheduler(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3),
                          num_slots=3, s_max=36, paged=True, block_size=4,
                          chunk_size=8, **kw)
        reqs = [sched.submit(p, max_new=12)
                for p in prompt["tokens"].cpu().numpy()]
        sched.run()
        outs.append(np.array([r.output for r in reqs]))
    np.testing.assert_array_equal(outs[0], spec[:, :12].cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="exp_words"):
        Scheduler(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3),
                  num_slots=3, s_max=36, paged=True, attn_kernel="on")


# ---------------------------------------------------------------------------
# kv_encode / kv_view: a C-1 KV store's encode and views in one launch each
# ---------------------------------------------------------------------------

KV_WIDTHS = [32, 64, 96, 128, 256, 512]     # 96: phi-3-vision's head_dim
# ((kv_trunc, exp_bits), kv_prune): the paper's default, other widths,
# nothing pruned, and the paper's grid away from its default (truncations
# 1, 3 and 5: 7-, 5- and 3-bit sign|mantissa codes that straddle 32-bit
# words; prunes 0.3 and 0.5: 96 and 64 of 128 kept)
KV_FORMATS = [((4, 3), 0.4), ((0, 3), 0.4), ((7, 5), 0.6), ((4, 3), 0.0),
              ((1, 3), 0.3), ((3, 3), 0.3), ((5, 3), 0.3), ((1, 3), 0.5),
              ((3, 3), 0.5), ((5, 3), 0.5)]


def _kv_rows(gen, rows, d):
    """The kv_topk edge rows (all-equal, small integers, +-0, |v| ties,
    mostly zeros, NaN, inf, -0), then rows at scale 1/4 (unary under the
    default book), rows spread over 2^+-12 (mode 1), subnormal rows and
    NaN payloads of every kind."""
    v = _topk_rows(gen, rows, d)
    n = rows - 8
    x = torch.randn((n, d), generator=gen)
    spread = torch.exp2(torch.randint(-12, 13, (n, d), generator=gen).float())
    pick = torch.randint(0, 4, (n, 1), generator=gen)
    x = torch.where(pick == 0, x * spread, x * 0.25)
    x = torch.where(pick == 1, x * 2.0 ** -128, x)          # subnormals
    v[8:] = x.to(torch.bfloat16)
    b = v.view(torch.int16)
    b[9, ::3] = 0x7FC1                                      # NaN payloads
    b[10, 1::5] = -0x7F                                     # 0xFF81, signed
    b[11, :] = 0x7F81                                       # all NaN
    return v


def _kv_cass(d, fmt=(4, 3), prune=0.4):
    return CassandraConfig(variant=1, kv_trunc=fmt[0], exp_bits=fmt[1],
                           kv_prune=prune)


def _built_book(v, card):
    """The book ``calibrate_kv_codebook`` makes from the rows past the
    kv_topk edge rows (exponents it never saw rank 255)."""
    from repro_torch.serving import kvcache as KC
    return tuple(t.to(card) for t in KC.calibrate_kv_codebook(v[12:]))


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for z in a:
        assert a[z].keys() == b[z].keys(), z
        for k in a[z]:
            x, y = a[z][k], b[z][k]
            assert x.shape == y.shape and x.dtype == y.dtype, (z, k)
            w = torch.int16 if x.dtype == torch.bfloat16 else x.dtype
            assert torch.equal(x.view(w), y.view(w)), (z, k)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,prune", KV_FORMATS)
@pytest.mark.parametrize("d", KV_WIDTHS)
def test_kv_encode_matches_chain_on_card(card, d, fmt, prune):
    """Every leaf of the store bit for bit against the chain
    (``encode_store_plain``), NaN payloads included, under the default
    book and a book built from data (unseen exponents rank 255); other
    mantissa and exponent widths, and keep == d (no pruned values)."""
    from repro_torch.kernels import kv_topk as KT
    from repro_torch.serving import kvcache as KC
    cass = _kv_cass(d, fmt, prune)
    v = _kv_rows(torch.Generator().manual_seed(d + fmt[0]), 3000, d).to(card)
    x = v.reshape(2, 3, 500, d)
    for book in (KC.default_kv_codebook(card), _built_book(v, card)):
        want = KC.encode_store_plain(cass, x, d, book)
        before = KT.kv_encode.launches
        spec, verif = KT.kv_encode(x, book[1], keep=cass.kv_keep(d),
                                   trunc=cass.kv_trunc,
                                   exp_bits=cass.exp_bits)
        torch.cuda.synchronize()
        assert KT.kv_encode.launches == before + 1
        _same_tree({"spec": spec, "verif": verif}, want)
        mode = spec["exp_mode"]
        assert (mode == 0).any() and (mode == 1).any()


def _random_store(store, gen):
    """The store's leaves overwritten with arbitrary bits (any words,
    bitmaps with any count of set bits, any mode byte and corrections)."""
    out = {}
    for z, t in store.items():
        out[z] = {}
        for k, leaf in t.items():
            r = torch.randint(0, 256, (leaf.numel() * leaf.element_size(),),
                              generator=gen, device=leaf.device,
                              dtype=torch.uint8)
            if k == "exp_mode":
                r = r % 2
            out[z][k] = r.view(leaf.dtype).reshape(leaf.shape)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arbitrary", [False, True])
@pytest.mark.parametrize("fmt,prune", KV_FORMATS)
@pytest.mark.parametrize("d", KV_WIDTHS)
def test_kv_view_matches_chain_on_card(card, d, fmt, prune, arbitrary):
    """Draft and target views bit for bit against the chain
    (``read_store_plain``) on stores of the edge rows (NaN payloads
    included) and on arbitrary leaves; a store without corrections."""
    from repro_torch.kernels import unary_decode as UD
    from repro_torch.serving import kvcache as KC
    cass = _kv_cass(d, fmt, prune)
    gen = torch.Generator(device=card).manual_seed(d + fmt[0])
    v = _kv_rows(torch.Generator().manual_seed(d), 2000, d).to(card)
    book = _built_book(v, card)
    store = KC.encode_store_plain(cass, v.reshape(4, 500, d), d, book)
    if arbitrary:
        store = _random_store(store, gen)
    kw = dict(d=d, keep=cass.kv_keep(d), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits)
    nocorr = {"spec": store["spec"], "verif": {
        k: t for k, t in store["verif"].items() if k != "exp_corr"}}
    for st, view in ((store, "draft"), (store, "target"), (nocorr, "target")):
        want = KC.read_store_plain(cass, st, d, view, book)
        before = UD.kv_view.launches
        got = UD.kv_view(st["spec"], st["verif"] if view == "target"
                         else None, book[0], **kw)
        torch.cuda.synchronize()
        assert UD.kv_view.launches == before + 1
        assert got.shape == want.shape == (4, 500, d)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_kv_store_through_encode_and_read_store_on_card(card):
    """encode_store / read_store on a C-1 store on the card: one kv_encode
    per encode and one kv_view per view, no kv_topk or unary_decode; equal
    to the chain; the target view returns the vectors bit for bit where
    no row holds NaN."""
    from repro_torch.kernels import kv_topk as KT, unary_decode as UD
    from repro_torch.serving import kvcache as KC
    cass = CassandraConfig(variant=1)
    gen = torch.Generator().manual_seed(3)
    book = KC.default_kv_codebook(card)
    for d in KV_WIDTHS:
        x = (torch.randn((2, 3, 7, 2, d), generator=gen) * 0.3).to(
            torch.bfloat16).to(card)
        KT.kv_encode.launches = KT.kv_topk.launches = 0
        UD.kv_view.launches = UD.unary_decode.launches = 0
        store = KC.encode_store(cass, x, d, book)
        views = [KC.read_store(cass, store, d, view, book)
                 for view in ("draft", "target")]
        torch.cuda.synchronize()
        assert (KT.kv_encode.launches, UD.kv_view.launches) == (1, 2)
        assert KT.kv_topk.launches == UD.unary_decode.launches == 0
        _same_tree(store, KC.encode_store_plain(cass, x, d, book))
        for got, view in zip(views, ("draft", "target")):
            want = KC.read_store_plain(cass, store, d, view, book)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(views[1].view(torch.int16), x.view(torch.int16))


def _offset_copy(t, shift):
    """``t`` copied into a buffer at ``shift`` bytes past a 16-byte
    boundary (same dtype, contiguous)."""
    nb = t.numel() * t.element_size()
    buf = torch.zeros(nb + 32, dtype=torch.uint8, device=t.device)
    raw = buf[shift:shift + nb]
    raw.copy_(t.contiguous().view(torch.uint8).reshape(-1))
    return raw.view(t.dtype).reshape(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 128, 512])
def test_kv_view_on_misaligned_and_strided_leaves_on_card(card, d):
    """Leaves at 4-byte and odd offsets (the kernel copies in the pieces
    each allows, never past a leaf), non-contiguous leaves (copied), and
    the leaves of one layer of a stacked pool (``_index``) and of
    ``gather_store``: all equal the chain on the original store."""
    from repro_torch.serving import kvcache as KC
    cass = CassandraConfig(variant=1)
    book = KC.default_kv_codebook(card)
    v = _kv_rows(torch.Generator().manual_seed(7), 1200, d).to(card)
    store = KC.encode_store(cass, v.reshape(2, 6, 100, d), d, book)
    want = {view: KC.read_store_plain(cass, store, d, view, book)
            for view in ("draft", "target")}

    def moved(shift_of):
        return {z: {k: _offset_copy(t, shift_of(t)) for k, t in
                    store[z].items()} for z in store}

    cases = {
        "4-byte": moved(lambda t: 4 if t.element_size() == 4 else 0),
        "odd": moved(lambda t: 1 if t.element_size() == 1 else
                     2 if t.element_size() == 2 else 4),
        "strided": {z: {k: torch.cat([t, t], -1)[..., :t.shape[-1]] if
                        t.ndim > 3 else t for k, t in store[z].items()}
                    for z in store}}
    assert not cases["strided"]["spec"]["bitmap"].is_contiguous()
    for name, st in cases.items():
        for view in ("draft", "target"):
            got = KC.read_store(cass, st, d, view, book)
            assert torch.equal(got.view(torch.int16),
                               want[view].view(torch.int16)), (name, view)
    # one layer of the stacked store, and a gathered per-request store
    layer = {z: {k: t[1] for k, t in store[z].items()} for z in store}
    table = torch.tensor([[3, 0, 5], [1, 1, 2]], dtype=torch.int32,
                         device=card)
    gathered = KC.gather_store(layer, table)
    for view in ("draft", "target"):
        assert torch.equal(KC.read_store(cass, layer, d, view, book).view(
            torch.int16), want[view][1].view(torch.int16))
        g = KC.read_store(cass, gathered, d, view, book)
        assert torch.equal(g.view(torch.int16), KC.read_store_plain(
            cass, gathered, d, view, book).view(torch.int16))


@pytest.mark.cuda
def test_kv_codec_kernels_reject_what_they_do_not_take(card):
    from repro_torch.kernels import kv_topk as KT, unary_decode as UD
    from repro_torch.serving import kvcache as KC
    book = KC.default_kv_codebook(card)
    kw = dict(keep=48, trunc=4, exp_bits=3)
    with pytest.raises(ValueError, match="d=160"):
        KT.kv_encode(torch.zeros((4, 160), dtype=torch.bfloat16,
                                 device=card), book[1], **kw)
    x = torch.zeros((4, 128), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        KT.kv_encode(x.cpu(), book[1], **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        KT.kv_encode(torch.zeros((4, 256), dtype=torch.bfloat16,
                                 device=card)[:, ::2], book[1], **kw)
    with pytest.raises(TypeError, match="dtype"):
        KT.kv_encode(x.float(), book[1], **kw)
    with pytest.raises(ValueError, match="rank_of_exp"):
        KT.kv_encode(x, book[1].cpu(), **kw)
    with pytest.raises(ValueError, match="keep=200"):
        KT.kv_encode(x, book[1], keep=200, trunc=4, exp_bits=3)
    with pytest.raises(ValueError, match="keep=40"):          # not 16k
        KT.kv_encode(x, book[1], keep=40, trunc=4, exp_bits=3)
    cass = CassandraConfig(variant=1)
    store = KC.encode_store(cass, x, 128, book)
    vkw = dict(d=128, keep=80, trunc=4, exp_bits=3)
    with pytest.raises(ValueError, match="d=160"):
        UD.kv_view(store["spec"], None, book[0], **{**vkw, "d": 160})
    with pytest.raises(ValueError, match="keep=40"):
        UD.kv_view(store["spec"], None, book[0], **{**vkw, "keep": 40})
    with pytest.raises(ValueError, match="shape"):
        UD.kv_view(store["spec"], None, book[0], **{**vkw, "keep": 64})
    with pytest.raises(ValueError, match="unsupported device cpu"):
        UD.kv_view({k: t.cpu() for k, t in store["spec"].items()}, None,
                   book[0], **vkw)
    with pytest.raises(TypeError, match="dtype"):
        UD.kv_view({**store["spec"], "exp_mode": store["spec"][
            "exp_mode"].int()}, None, book[0], **vkw)
    with pytest.raises(ValueError, match="32 entries"):
        UD.kv_view(store["spec"], None, book[0][:16], **vkw)
    with pytest.raises(ValueError, match="book"):
        KC.encode_store(cass, x, 128, None)


# ---------------------------------------------------------------------------
# target_decode: a packed C-1 weight's exact view in one launch
# ---------------------------------------------------------------------------

def _target_weight(shape, card, *, trunc=4, outliers=True, raw=False,
                   prune=0.4):
    """A C-1 weight of ``shape`` packed on the card: with ``outliers`` the
    first columns span 2^±6 more per value, so their superblocks (kept and
    pruned) take mode 1 and keep their corrections; ``raw`` stores the
    pruned values as raw 16-bit patterns."""
    from repro_torch.core import format as fmt
    cass = CassandraConfig(variant=1, weight_trunc=trunc, weight_prune=prune)
    gen = torch.Generator(device=card).manual_seed(shape[0] + shape[1] + trunc)
    w = torch.randn(shape, generator=gen, device=card)
    if outliers:
        w[:, :4] *= torch.exp2(torch.randint(-6, 7, (shape[0], 4),
                                             generator=gen, device=card)
                               .float())
    w = w.to(torch.bfloat16)
    block = cass.weight_block(shape[0])
    wt = w.T.contiguous()
    spec, verif = fmt.format_tensor(wt, wt.float().abs(), cass, block,
                                    cass.weight_keep(block), cass.mx_group,
                                    trunc, pruned_raw=raw)
    spec, verif = fmt._trim_lossless(spec, verif, 1)
    return w, spec, verif, cass


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out", [
    (1536, 1000), (4096, 1024), (7168, 576), (14336, 520), (18432, 256),
    (4096, 128256)])       # lm_head's width
def test_target_decode_bitwise_on_card(card, n_in, n_out):
    """Bit for bit the plain chain (and the weight itself: the format is
    lossless), mode-1 superblocks on both sides with their corrections;
    one launch counted per call, two launches equal bit for bit."""
    from repro_torch.core import format as fmt
    from repro_torch.kernels import unary_decode as UD
    w, spec, verif, cass = _target_weight((n_in, n_out), card)
    assert spec["exp_mode"].any() and "exp_corr" in verif
    assert verif["pruned_exp_mode"].any() and "pruned_exp_corr" in verif
    before = UD.target_decode.launches
    got = UD.target_decode(spec, verif, cass, (n_in, n_out))
    again = UD.target_decode(spec, verif, cass, (n_in, n_out))
    want = fmt.target_weight_plain(spec, verif, cass, (n_in, n_out)).T
    torch.cuda.synchronize()
    assert UD.target_decode.launches == before + 2
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert torch.equal(got.T.view(torch.int16), w.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,trunc,outliers,raw,prune", [
    (512, 0, True, False, 0.4), (512, 2, True, False, 0.4),
    (512, 7, True, False, 0.4),          # 8-, 6-, 1-bit sign|mantissa codes
    (512, 4, False, False, 0.4),         # every region unary, corr trimmed
    (1024, 4, True, True, 0.4),          # raw pruned values
    (512, 4, True, False, 0.0),          # nothing pruned (keep == block)
    (256, 4, True, False, 0.4), (128, 4, True, False, 0.4),
    (64, 4, True, False, 0.4), (32, 4, True, False, 0.5),   # small blocks
    # the paper's grid away from (0.4, 4): keeps 352 and 256 of 512
    *[(n, t, True, False, p) for n in (512, 4096) for p in (0.3, 0.5)
      for t in (1, 3, 5)]])
def test_target_decode_formats_on_card(card, n_in, trunc, outliers, raw,
                                       prune):
    from repro_torch.core import format as fmt
    from repro_torch.kernels import unary_decode as UD
    shape = (n_in, 200)
    w, spec, verif, cass = _target_weight(shape, card, trunc=trunc,
                                          outliers=outliers, raw=raw,
                                          prune=prune)
    assert ("exp_corr" in verif) == outliers
    assert ("pruned_raw" in verif) == raw
    got = UD.target_decode(spec, verif, cass, shape)
    want = fmt.target_weight_plain(spec, verif, cass, shape).T
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if prune > 0:
        assert torch.equal(got.T.view(torch.int16), w.view(torch.int16))
    # format.target_weight dispatches the kernel for C-1 on the card
    before = UD.target_decode.launches
    tw = fmt.target_weight(spec, verif, cass, shape)
    assert UD.target_decode.launches == before + 1
    assert torch.equal(tw.view(torch.int16), want.T.view(torch.int16))


@pytest.mark.cuda
def test_target_decode_on_arbitrary_words_on_card(card):
    """Arbitrary leaves (regions with fewer and more than K ones, random
    bitmaps, escape codes without corrections) and misaligned leaf
    slices: bit for bit the plain chain."""
    from repro_torch.core import format as fmt
    from repro_torch.kernels import unary_decode as UD
    _, spec, verif, cass = _target_weight((1024, 300), card)
    gen = torch.Generator(device=card).manual_seed(5)

    def scramble(tree):
        out = {}
        for k, v in tree.items():
            if k.endswith("codebook"):
                out[k] = v
            elif v.dtype == torch.int32:
                out[k] = torch.randint(-2 ** 31, 2 ** 31 - 1, v.shape,
                                       generator=gen, device=card,
                                       dtype=torch.int32)
            else:
                out[k] = torch.randint(0, 256, v.shape, generator=gen,
                                       device=card).to(v.dtype)
        return out

    spec, verif = scramble(spec), scramble(verif)
    for tree in (spec, verif):
        for k in [k for k in tree if k.endswith("mode")]:
            tree[k] = tree[k] & 1
    for drop in ((), ("exp_corr", "pruned_exp_corr")):
        v = {k: x for k, x in verif.items() if k not in drop}
        got = UD.target_decode(spec, v, cass, (1024, 300))
        want = fmt.target_weight_plain(spec, v, cass, (1024, 300)).T
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # a leaf one byte off a 4-byte boundary is copied first
    book = torch.zeros(33, dtype=torch.uint8, device=card)
    book[1:] = spec["codebook"]
    mode = torch.zeros(spec["exp_mode"].numel() + 1, dtype=torch.uint8,
                       device=card)
    mode[1:] = spec["exp_mode"].reshape(-1)
    off = dict(spec, codebook=book[1:],
               exp_mode=mode[1:].reshape(spec["exp_mode"].shape))
    got = UD.target_decode(off, verif, cass, (1024, 300))
    want = fmt.target_weight_plain(spec, verif, cass, (1024, 300)).T
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_target_decode_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import unary_decode as UD
    _, spec, verif, cass = _target_weight((512, 40), card)
    with pytest.raises(TypeError, match="dtype"):
        UD.target_decode(dict(spec, signmant=spec["signmant"].long()), verif,
                         cass, (512, 40))
    with pytest.raises(ValueError, match="is on cpu"):
        UD.target_decode(spec, dict(verif, mant_lo=verif["mant_lo"].cpu()),
                         cass, (512, 40))
    with pytest.raises(ValueError, match="shape"):
        UD.target_decode(spec, verif, cass, (512, 48))
    with pytest.raises(ValueError, match="codebook"):
        UD.target_decode(dict(spec, codebook=spec["codebook"][:16]), verif,
                         cass, (512, 40))
    with pytest.raises(ValueError, match="Cassandra-1"):
        UD.target_decode(spec, verif, CassandraConfig(variant=2),
                         (512, 40))


# ---------------------------------------------------------------------------
# mx_view: a packed C-2 tensor's draft or target view in one launch
# ---------------------------------------------------------------------------

def _c2_leaves(shape, block, keep, group, db, seed, arbitrary=False):
    """Packed C-2 leaves on the CPU for values (..., N) with per-lane
    scales 2^-12..2^12 (exponent gaps above 8 in a group), zeros of both
    signs and subnormals, and raw NaN / inf / -0 payloads among the pruned
    values; ``arbitrary`` replaces every leaf by random words (bitmaps with
    any count of ones, codes straddling words anywhere)."""
    from repro_torch.core import format as fmt
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * torch.exp2(
        torch.randint(-12, 13, shape, generator=gen).float())
    x = x.to(torch.bfloat16)
    flat = x.reshape(-1, shape[-1])
    flat[0, :group] = 0.0
    flat[1, :4] = torch.tensor([-0.0, 0.0, 1e-39, -3e-40]).to(torch.bfloat16)
    cass = CassandraConfig(variant=2, mx_draft_bits=db)
    spec, verif = fmt.format_tensor(x, None if block == shape[-1] else
                                    x.float().abs(), cass, block, keep, group,
                                    4)
    if arbitrary:
        for tree in (spec, verif):
            for k, v in tree.items():
                if v.dtype == torch.int32:
                    tree[k] = torch.randint(-2 ** 31, 2 ** 31 - 1, v.shape,
                                            generator=gen, dtype=torch.int32)
                elif v.dtype == torch.uint8:
                    tree[k] = torch.randint(0, 256, v.shape, generator=gen,
                                            dtype=torch.uint8)
        spec["bitmap"].view(-1, spec["bitmap"].shape[-1])[:2] = \
            torch.tensor([0, -1], dtype=torch.int32)[:, None]
    pr = verif["pruned_raw"]
    if pr.numel():
        special = torch.tensor([0x7FC1, -0x7F, 0x7F80, -0x8000, 0x0001,
                                -0x0001], dtype=torch.int32)
        pick = torch.randint(0, 6, pr.shape, generator=gen)
        mask = torch.rand(pr.shape, generator=gen) < 0.1
        verif["pruned_raw"] = torch.where(
            mask, special[pick].to(torch.int16), pr)
    return spec, verif


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["weight draft", "weight draft f32",
                                  "weight target", "kv draft", "kv target"])
@pytest.mark.parametrize("block,keep,group,db", [
    (512, 320, 32, 4), (512, 320, 32, 3), (256, 160, 32, 4),
    (128, 64, 16, 4), (64, 32, 32, 3), (32, 32, 16, 4), (96, 48, 16, 4),
    (512, 512, 32, 4)])
@pytest.mark.parametrize("arbitrary", [False, True])
def test_mx_view_matches_chain_on_card(card, path, block, keep, group, db,
                                       arbitrary):
    """Bit for bit against the plain chain (``mx_view_plain``: the
    reference's draft_tensor / target_tensor over the same leaves, on the
    CPU) on weights of several blocks a row and on KV stores (B, S, Hkv,
    one block a vector): 5- and 12-bit codes (4- and 13-bit with 3 draft
    bits) at every bit offset, blocks of 32-512 values, keep == block, NaN
    payloads among the pruned values, and random words throughout."""
    from repro_torch.kernels import mx_decode as MXD
    if path.startswith("kv"):
        shape, view_block = (2, 9, 3, block), block
    else:
        shape, view_block = (37, 3 * block), block
    spec, verif = _c2_leaves(shape, view_block, keep, group, db,
                             seed=block + keep + db + 7 * arbitrary,
                             arbitrary=arbitrary)
    target = path.endswith("target")
    dtype = torch.float32 if path.endswith("f32") else torch.bfloat16
    kw = dict(block=view_block, keep=keep, group=group, draft_bits=db,
              dtype=dtype)
    want = MXD.mx_view_plain(spec, verif if target else None, **kw)
    on = {z: {k: v.to(card) for k, v in t.items()}
          for z, t in (("spec", spec), ("verif", verif))}
    before = MXD.mx_view.launches
    got = MXD.mx_view(on["spec"], on["verif"] if target else None, **kw)
    torch.cuda.synchronize()
    assert MXD.mx_view.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    wide = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.cpu().view(wide), want.view(wide))


@pytest.mark.cuda
def test_mx_view_weights_and_stores_through_their_callers_on_card(card):
    """format.draft_weight / target_weight / draft_weight_f32 and
    kvcache.read_store on CUDA tensors are one mx_view launch each and
    equal their plain chains bit for bit; none runs mx_decode."""
    from repro_torch.core import format as fmt
    from repro_torch.kernels import mx_decode as MXD
    from repro_torch.serving import kvcache as KC
    cass = CassandraConfig(variant=2)
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((1024, 200), generator=gen).to(torch.bfloat16)
    spec, verif = fmt.format_weight(w, None, cass)
    shape = (1024, 200)
    cs = {k: v.to(card) for k, v in spec.items()}
    cv = {k: v.to(card) for k, v in verif.items()}
    MXD.mx_view.launches = MXD.mx_decode.launches = 0
    got = (fmt.draft_weight(cs, cass, shape),
           fmt.target_weight(cs, cv, cass, shape),
           fmt.draft_weight_f32(cs, cass, shape))
    want = (fmt.draft_weight_plain(spec, cass, shape),
            fmt.target_weight_plain(spec, verif, cass, shape),
            fmt.draft_weight_plain(spec, cass, shape).float())
    for a, b in zip(got, want):
        assert a.shape == b.shape == shape
        wide = torch.int32 if a.dtype == torch.float32 else torch.int16
        assert torch.equal(a.cpu().contiguous().view(wide),
                           b.contiguous().view(wide))
    kv = (torch.randn((2, 5, 2, 128), generator=gen) * 3).to(torch.bfloat16)
    store = KC.encode_store(cass, kv, 128, KC.default_kv_codebook())
    on = {z: {k: v.to(card) for k, v in t.items()} for z, t in store.items()}
    for view in ("draft", "target"):
        a = KC.read_store(cass, on, 128, view, None)
        b = KC.read_store(cass, store, 128, view, None)
        assert torch.equal(a.cpu().view(torch.int16), b.view(torch.int16))
    assert MXD.mx_view.launches == 5 and MXD.mx_decode.launches == 0


@pytest.mark.cuda
def test_mx_view_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import mx_decode as MXD
    spec, verif = _c2_leaves((4, 512), 512, 320, 32, 4, seed=1)
    on = {k: v.to(card) for k, v in spec.items()}
    kw = dict(block=512, keep=320, group=32, draft_bits=4)
    with pytest.raises(ValueError, match="outside"):
        MXD.mx_view(on, None, **{**kw, "group": 40})
    with pytest.raises(TypeError, match="bf16 or f32"):
        MXD.mx_view(on, None, **kw, dtype=torch.float16)
    with pytest.raises(ValueError, match="shape"):
        MXD.mx_view(on, None, **{**kw, "keep": 288})
    with pytest.raises(ValueError, match="is on cpu"):
        MXD.mx_view({**on, "signmant": spec["signmant"]}, None, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k,group", [(24, 8), (36, 12), (100, 4), (8, 8),
                                     (1000, 40), (320, 32)])
def test_mx_decode_lane_counts_on_card(card, k, group):
    """The 8-lane vector path and its scalar twin (lane counts that are not
    multiples of 8, groups that do not cover 8 lanes) bit for bit against
    the plain version on every container value."""
    from repro_torch.core.bitops import as_int16
    from repro_torch.kernels import mx_decode as MXD
    gen = torch.Generator().manual_seed(k + group)
    rows = -(-(1 << 16) // k) + 5
    m16 = torch.randint(0, 1 << 16, (rows * k,), generator=gen,
                        dtype=torch.int32)
    m16[:1 << 16] = torch.arange(1 << 16, dtype=torch.int32)
    sign = torch.randint(0, 256, (rows, k), generator=gen, dtype=torch.uint8)
    se = torch.randint(0, 256, (rows, k // group), generator=gen,
                       dtype=torch.uint8)
    s, m, e = sign.to(card), as_int16(m16.reshape(rows, k)).to(card), \
        se.to(card)
    before = MXD.mx_decode.launches
    got = MXD.mx_decode(s, m, e, group)
    torch.cuda.synchronize()
    assert MXD.mx_decode.launches == before + 1
    want = MXD.mx_decode_plain(sign, as_int16(m16.reshape(rows, k)), se,
                               group)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# paged_mla: the tensor-core walk and its table split
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("split", [None, 1, 2, 6])
@pytest.mark.parametrize("lat,rope,bs", [(64, 16, 4), (512, 64, 16),
                                         (256, 32, 32)])
def test_paged_mla_splits_on_card(card, t, split, lat, rope, bs, monkeypatch,
                                  fresh_plans):
    """The split walk (the main path's plan, and plans forced to 1, 2 and 6
    splits by the CTA target): (acc, m, l) within rtol 1e-4 / atol 1e-5 of
    the plain walk and of the split walk in plain torch; two launches equal
    bit for bit; NaN in every pool row no valid position reads never
    reaches the state; the empty row stays initial."""
    from repro_torch.kernels import paged_attention as PA
    PA._mla_plan.cache_clear()
    args = _mla_inputs(card, lat=lat, rope=rope, t=t, bs=bs, h=16,
                       seed=t * 11 + lat + bs)
    b, _, h, _ = args[0].shape
    mb = args[4].shape[1]
    if split is not None:
        monkeypatch.setattr(PA.build, "SM_COUNT", 10 ** 6)
        monkeypatch.setattr(PA, "MLA_TARGET_CTAS",
                            split * b * -(-(h * t) // PA.MLA_Q_TILE))
    bps, splits = PA._mla_plan(b, h, t, mb)
    assert split is None or splits == split
    assert args[2].isnan().any()
    scale = (lat + rope) ** -0.5
    before = PA.paged_mla.launches
    got = PA.paged_mla(*args, scale=scale)
    again = PA.paged_mla(*args, scale=scale)
    want = PA.paged_mla_plain(*args, scale=scale)
    want_s = PA.paged_mla_split_plain(*args, scale=scale,
                                      blocks_per_split=bps)
    torch.cuda.synchronize()
    PA._mla_plan.cache_clear()
    assert PA.paged_mla.launches == before + 2
    for a, a2, c, cs in zip(got, again, want, want_s):
        assert torch.isfinite(a).all()
        assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a, cs, rtol=1e-4, atol=1e-5)
    acc, m, l = got
    assert (acc[1] == 0).all() and (m[1] == PA.NEG_INF).all() \
        and (l[1] == 0).all()


# ---------------------------------------------------------------------------
# The prefix cache and preemption with host swap: block moves and runs
# ---------------------------------------------------------------------------

def _random_pool(card, variant, seed):
    """A SMOKE paged cache on the card with arbitrary bits in every store
    leaf (bf16 leaves finite)."""
    from repro_torch.serving import kvcache as KC
    from repro_torch.core.tree import tree_map
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=variant, gamma=3) if variant else None
    cache = KC.init_paged_cache(cfg, cass, 2, 12, 4, 5, packed=bool(variant),
                                device=card)
    gen = torch.Generator(device=card).manual_seed(seed)

    def fill(leaf):
        if leaf.dtype == torch.bfloat16:
            return torch.randn(leaf.shape, generator=gen, device=card).to(
                torch.bfloat16)
        r = torch.randint(0, 256, (leaf.numel() * leaf.element_size(),),
                          generator=gen, device=card, dtype=torch.uint8)
        return r.view(leaf.dtype).reshape(leaf.shape)
    cache["dec"] = tree_map(fill, cache["dec"])
    return cache


def _pool_leaves(cache) -> list:
    from repro_torch.core.tree import tree_leaves
    return tree_leaves(cache["dec"])


def _bits_equal(a, b) -> bool:
    w = torch.int16 if a.dtype == torch.bfloat16 else a.dtype
    return a.shape == b.shape and torch.equal(a.view(w), b.view(w))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [0, 1, 2])
def test_pool_block_moves_on_card(card, variant):
    """Copy-on-write, spill and restore on a bf16 and on packed C-1 / C-2
    pools on the card, leaf by leaf: copies bit for bit, sources and every
    other block untouched, block 0 unchanged (a CoW pair into it and a
    restore's padding store its own value back). The spill lands in pinned
    host buffers; ``put_async`` then ``finalize`` gives the bytes ``put``
    gives; the restore from a pinned chain puts them back bit for bit."""
    from repro_torch.serving import kvcache as KC
    from repro_torch.core.tree import tree_leaves
    from repro_torch.serving.swapstore import SpillStore
    cache = _random_pool(card, variant, seed=variant + 5)
    before = [t.clone() for t in _pool_leaves(cache)]
    src = torch.tensor([2, 5, 7, 0], dtype=torch.int32, device=card)
    dst = torch.tensor([9, 2, 0, 0], dtype=torch.int32, device=card)
    KC.copy_pool_blocks(cache, src, dst)
    torch.cuda.synchronize()
    for t, b in zip(_pool_leaves(cache), before):
        assert _bits_equal(t[:, [9, 2]], b[:, [2, 5]])
        rest = [j for j in range(12) if j not in (9, 2)]
        assert _bits_equal(t[:, rest], b[:, rest])
    # spill three blocks (padded to five with the trash block) two ways
    vec = torch.tensor([4, 9, 1, 0, 0], dtype=torch.int32, device=card)
    stores = (SpillStore(), SpillStore())
    chains = []
    for st, fn in zip(stores, ("put", "put_async")):
        data = KC.spill_pool_blocks(cache, vec)
        chains.append(getattr(st, fn)(("swap", 0), data, 3, length=11,
                                      pos=11, cur=7))
    assert chains[1].done is not None and stores[1].finalize() == 1
    assert chains[1].done is None
    spilled = [t[:, [4, 9, 1]].clone() for t in _pool_leaves(cache)]
    for c in chains:
        for h, s in zip(tree_leaves(c.data), spilled):
            assert h.is_pinned() and not h.is_cuda
            assert _bits_equal(h, s.cpu())
    assert chains[0].nbytes == chains[1].nbytes == stores[0].nbytes > 0
    # overwrite the source blocks, then restore into other blocks
    for t in _pool_leaves(cache):
        t[:, [4, 9, 1]] = t[:, [3, 3, 3]]
    mid = [t.clone() for t in _pool_leaves(cache)]
    host = chains[1].slice_blocks(0, 3, 5)
    assert all(h.is_pinned() for h in tree_leaves(host))
    back = torch.tensor([6, 10, 11, 0, 0], dtype=torch.int32, device=card)
    _, marker = KC.restore_pool_blocks_marked(cache, back, host)
    marker.synchronize()
    for t, m, s in zip(_pool_leaves(cache), mid, spilled):
        assert _bits_equal(t[:, [6, 10, 11]], s)
        rest = [j for j in range(12) if j not in (6, 10, 11)]
        assert _bits_equal(t[:, rest], m[:, rest])
    for t, b in zip(_pool_leaves(cache), before):
        assert _bits_equal(t[:, 0], b[:, 0])            # the trash block
    stores[1].pop(("swap", 0))
    assert stores[1].blocks == 0 and stores[1].total_restored_blocks == 3


@pytest.mark.cuda
def test_prefix_and_swap_scheduler_on_card(card):
    """The paged scheduler at SMOKE width (2 layers) on the card with the
    kernels on: prefix cache on == off for two waves sharing a 6-token
    header (a copy-on-write per hit), and swap on a pool of 13 blocks ==
    a pool that never preempts, with the overlap pipeline on and off,
    bit for bit; launches as the passes imply."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving.scheduler import Scheduler
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(1)
    params = format_params(init_params(cfg, gen, device=card), cass)
    prompts = torch.randint(0, cfg.vocab_size, (6, 12), generator=gen,
                            device=card).cpu().numpy()
    prompts[:, :6] = prompts[0, :6]

    def serve(waves, **kw):
        sched = Scheduler(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3),
                          num_slots=3, s_max=24, paged=True, block_size=4,
                          chunk_size=8, attn_kernel="on",
                          debug_invariants=1, **kw)
        before = (PA.paged_gqa.launches, PA.paged_gqa_packed.launches)
        if waves:
            reqs = [sched.submit(p, max_new=8) for p in prompts[:3]]
            sched.run()
            reqs += [sched.submit(p, max_new=8, arrival=sched.clock)
                     for p in prompts[3:]]
        else:
            reqs = [sched.submit(p, max_new=8, arrival=i / 4.0,
                                 priority=i % 2)
                    for i, p in enumerate(prompts[:4])]
        sched.run()
        s = sched.summary()
        drafts = 3 * (s["cycles"] - s["prefill_cycles"] + s["mixed_cycles"])
        assert PA.paged_gqa.launches - before[0] == s["cycles"] * cfg.n_layers
        assert PA.paged_gqa_packed.launches - before[1] == \
            drafts * cfg.n_layers
        assert all(len(r.output) == 8 for r in reqs)
        sched.check_invariants()
        return s, [r.output for r in reqs]

    on, toks_on = serve(True, prefix_cache=True)
    _, toks_off = serve(True)
    assert toks_on == toks_off
    assert on["prefix_hits"] == 3 and on["cow_copies"] == 3
    ample = serve(False)[1]
    for kw in ({}, {"overlap": False}, {"prefix_cache": True}):
        s, toks = serve(False, swap=True, num_blocks=13, **kw)
        assert toks == ample, kw
        assert s["preemptions"] >= 1 and s["swap_out_blocks"] >= 1
        assert s["swap_in_blocks"] + s["swap_matched_blocks"] == \
            s["swap_out_blocks"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_prefill_attention_independent_of_chunk_start_on_card(card, arch):
    """``paged_gqa`` / ``paged_mla`` and the suffix merge give a prompt
    token the same bits whether its chunk started on the grid or mid-grid
    (a prefix hit, a resume), with the serving steps' window start; the
    layer's products run at one shape either way."""
    import dataclasses
    cfg = get_config(arch, smoke=True)
    if cfg.mla:
        cfg = dataclasses.replace(cfg, n_layers=2, first_dense_layers=2)
    a, b = AR.chunk_start_outputs(cfg, card, seed=3)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _one_hot_eq1(rng, b: int, gamma: int, v: int):
    """Eq. 1 inputs whose residual is one-hot at every stopping position
    (p_i = (1-e)·onehot(t_i) + e·q_i for i < γ, p_γ = onehot(t_γ)), so the
    one draw left has one outcome on any generator; half the drafts are
    the target's t_i, so rows stop anywhere in 0..γ."""
    logits = rng.standard_normal((b, gamma, v)).astype(np.float32)
    q = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = rng.integers(0, v, (b, gamma + 1))
    eps = rng.uniform(0.05, 0.9, (b, gamma, 1)).astype(np.float32)
    onehot = np.zeros((b, gamma + 1, v), np.float32)
    np.put_along_axis(onehot, t[..., None], 1.0, axis=-1)
    p = np.concatenate([(1 - eps) * onehot[:, :gamma] + eps * q,
                        onehot[:, gamma:]], axis=1).astype(np.float32)
    draft = np.where(rng.random((b, gamma)) < 0.5, t[:, :gamma],
                     rng.integers(0, v, (b, gamma)))
    r = rng.random((b, gamma)).astype(np.float32)
    return [torch.from_numpy(a) for a in (draft.astype(np.int32), q, p, r)]


@pytest.mark.cuda
@pytest.mark.parametrize("gamma,v", [(1, 48), (3, 1000), (5, 128256)])
def test_rejection_sample_on_card_matches_cpu(card, gamma, v):
    """``rejection_sample`` on the card against its CPU run with the same
    ``r`` and one-hot residuals: the whole result bit for bit."""
    from repro_torch.core import speculative as SP
    draft, q, p, r = _one_hot_eq1(np.random.default_rng(v), 16, gamma, v)
    cpu = SP.rejection_sample(draft, q, p, torch.Generator().manual_seed(0),
                              r=r)
    gpu = SP.rejection_sample(draft.to(card), q.to(card), p.to(card),
                              torch.Generator(device=card).manual_seed(0),
                              r=r.to(card))
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())
    assert cpu.n_accepted.min() == 0 and cpu.n_accepted.max() == gamma


@pytest.mark.cuda
def test_sampled_engine_and_scheduler_seeds_on_card(card):
    """The sampled Engine and paged Scheduler (kernels on) at SMOKE width
    on the card: one seed gives the same tokens twice, another seed other
    tokens, every row its tokens; the Scheduler's overlap on == off."""
    from repro_torch.serving.scheduler import Scheduler
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(2)
    params = format_params(init_params(cfg, gen, device=card), cass)
    prompts = torch.randint(0, cfg.vocab_size, (3, 12), generator=gen,
                            device=card).to(torch.int32)
    ecfg = EngineConfig(gamma=3, greedy=False, temperature=0.8)
    eng = Engine(cfg, params, cass=cass, ecfg=ecfg, device=card)
    runs = [eng.generate({"tokens": prompts}, 10,
                         generator=torch.Generator(device=card).manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])
    assert ((runs[0][0] >= 0).sum(1) >= 10).all()

    def serve(seed, overlap):
        sched = Scheduler(cfg, params, cass=cass, ecfg=ecfg, num_slots=2,
                          s_max=32, paged=True, block_size=4, chunk_size=8,
                          attn_kernel="on", overlap=overlap, device=card,
                          generator=torch.Generator(
                              device=card).manual_seed(seed))
        reqs = [sched.submit(p, max_new=10) for p in prompts.cpu().numpy()]
        sched.run()
        assert all(len(r.output) == 10 for r in reqs)
        return [r.output for r in reqs]

    a = serve(7, True)
    assert a == serve(7, True) == serve(7, False)
    assert a != serve(8, True)


# ---------------------------------------------------------------------------
# The dense GQA family and top-k MoE: the kernels at their shapes and
# groups, MoE on the card, the Engine and the paged Scheduler
# ---------------------------------------------------------------------------

# (in, out) of draft products no other card test covers: qwen3-4b's five
# (wq 2560 -> 4096, wo 4096 -> 2560), DBRX's attention and lm_head,
# DeepSeek-V3's shared expert, qwen2.5-3b's wk (2 KV heads) and
# mistral-large-123b's up projection
FAMILY_SHAPES = [(2560, 4096), (2560, 1024), (2560, 9728), (9728, 2560),
                 (4096, 2560), (6144, 6144), (6144, 1024), (6144, 100352),
                 (7168, 2048), (2048, 7168), (2048, 256), (12288, 28672)]
# the Mamba mixers' products: x_proj at full width (N 288, a multiple of
# 32 but not of 64) and at SMOKE (N 16: one half-filled column tile),
# dt_proj (K 256: a single weight block), in_proj, out_proj, and the
# vocabularies of falcon-mamba-7b and Jamba
SSM_SHAPES = [(8192, 288), (256, 16), (256, 8192), (4096, 16384),
              (8192, 4096), (4096, 65024), (4096, 65536)]
# whisper-medium's products (every attention and cross-attention
# projection 1024 -> 1024, up 1024 -> 4096, and lm_head 1024 -> 51865: an
# odd N, so y's rows are not 16-byte aligned), phi-3-vision-4.2b's, and
# small odd widths (a half-filled last column tile)
ENCDEC_SHAPES = [(1024, 1024), (1024, 4096), (1024, 51865), (3072, 3072),
                 (3072, 8192), (8192, 3072), (3072, 32064), (512, 77),
                 (256, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out", FAMILY_SHAPES + SSM_SHAPES
                         + ENCDEC_SHAPES)
def test_draft_matmul_at_the_families_shapes_on_card(card, n_in, n_out):
    """The main path's plan at M = 4 (a decode batch) and 16 (a verify
    pass), at the families' and the Mamba mixers' shapes: y within rtol
    2e-2 / atol 1e-3 of the plain version, the decoded weight bit for bit
    through identity rows."""
    args, kw = _card_operands((n_in, n_out), card, 4)
    gen = torch.Generator(device=card).manual_seed(n_in + n_out)
    for m in (4, 16):
        x = torch.randn((m, n_in), generator=gen, device=card).to(
            torch.bfloat16)
        y = DM.draft_matmul(x, *args, **kw)
        torch.testing.assert_close(y, DM.draft_matmul_plain(x, *args, **kw),
                                   rtol=2e-2, atol=1e-3)
    eye = torch.eye(n_in, dtype=torch.bfloat16, device=card)
    w = DM.draft_matmul(eye, *args, **kw).to(torch.bfloat16)
    del eye
    assert torch.equal(w.view(torch.int16), DM.draft_weight_plain(
        *args, **kw).contiguous().view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out", FAMILY_SHAPES + SSM_SHAPES
                         + ENCDEC_SHAPES)
def test_target_decode_at_the_families_shapes_on_card(card, n_in, n_out):
    """Bit for bit the plain chain, mode-1 superblocks included, and the
    weight itself wherever the format is exact: a mode-1 region holds an
    exponent exactly only within 20 binades below its max (3-bit code +
    4-bit correction, as the reference's; ``tests/test_torch_core.py::
    test_c1_delta_regions_are_exact_within_20_binades``), and the
    outlier columns' 2^±6 spread can put a value past it."""
    from repro_torch.core import format as fmt
    from repro_torch.kernels import unary_decode as UD
    w, spec, verif, cass = _target_weight((n_in, n_out), card)
    got = UD.target_decode(spec, verif, cass, (n_in, n_out))
    want = fmt.target_weight_plain(spec, verif, cass, (n_in, n_out)).T
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    wt = w.T.contiguous().view(torch.int16)
    lost = got.view(torch.int16) != wt
    exps = (wt.to(torch.int32) >> 7) & 0xFF
    block = cass.weight_block(n_in)
    emax = exps.reshape(n_out, -1, block).amax(-1).repeat_interleave(
        block, -1)
    assert bool(((emax - exps)[lost] > 20).all())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("hkv,g", [(8, 6), (2, 8), (8, 12), (8, 2)])
def test_paged_kernels_at_the_families_groups_on_card(card, t, hkv, g):
    """``paged_gqa`` and ``paged_gqa_packed`` at the query groups of DBRX
    and nemotron (6), qwen2.5-3b (8 over 2 KV heads), mistral (12) and
    qwen3-1.7b (2), head dim 128: (acc, m, l) within rtol 1e-4 / atol 1e-5
    of the plain versions, the empty row exactly initial."""
    from repro_torch.kernels import paged_attention as PA
    q, k, v, ks, vs, table, length, eor, kw = _paged_inputs(
        card, d=128, t=t, bs=16, seed=t * 13 + g, hkv=hkv, g=g)
    scale = 128 ** -0.5
    got = PA.paged_gqa(q, k, v, table, length, scale=scale)
    want = PA.paged_gqa_plain(q, k, v, table, length, scale=scale)
    got_p = PA.paged_gqa_packed(q, ks, vs, table, length, eor, scale=scale,
                                **kw)
    want_p = PA.paged_gqa_packed_plain(q, ks, vs, table, length, eor,
                                       scale=scale, **kw)
    torch.cuda.synchronize()
    for a, b in list(zip(got, want)) + list(zip(got_p, want_p)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert (got[0][1] == 0).all() and (got[1][1] == PA.NEG_INF).all()
    assert got[0].shape == (4, hkv, g, t, 128)


def _moe_smoke(card, arch):
    """SMOKE with its routed layers (DeepSeek-V3's rope widened to 32 so
    its caches pack), C-1, random weights on the card."""
    import dataclasses
    cfg = get_config(arch, smoke=True)
    if cfg.mla:
        cfg = dataclasses.replace(cfg, qk_rope_dim=32)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(4)
    plain = init_params(cfg, gen, device=card)
    return cfg, cass, plain, format_params(plain, cass), gen


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.25, None])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_on_card_matches_cpu(card, arch, factor):
    """One routed layer on the card against the same layer on the CPU, on
    tokens sharing one direction (a skewed router): ``dropped`` and
    ``load`` exactly (drops at 1.25, none at n_experts / k), the output
    within a few bf16 ulps (cuBLAS sums in another order); on the card
    ``moe`` against ``moe_reference`` at the no-drop capacity likewise."""
    from repro_torch.models import ffn as F
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import _index
    cfg, _, plain, _, gen = _moe_smoke(card, arch)
    if factor is None:
        factor = cfg.n_experts / cfg.n_experts_per_tok
    rt = Runtime(cfg=cfg, moe_capacity_factor=factor)
    p = _index(plain["dec"][-1]["e0"]["moe"], 0)
    x = (torch.randn((4, 6, cfg.d_model), generator=gen, device=card)
         + 2 * torch.randn((cfg.d_model,), generator=gen, device=card)).to(
        torch.bfloat16)
    out, aux = F.moe(rt, p, x)
    out_c, aux_c = F.moe(rt, _tree_to(p, "cpu"), x.cpu())
    assert int(aux["dropped"]) == int(aux_c["dropped"])
    assert (int(aux["dropped"]) > 0) == (factor == 1.25)
    assert torch.equal(aux["load"].cpu(), aux_c["load"])
    scale = float(out_c.float().abs().max())
    torch.testing.assert_close(out.float().cpu(), out_c.float(), rtol=0,
                               atol=2 ** -7 * max(scale, 1.0))
    if factor != 1.25:
        ref = F.moe_reference(rt, p, x)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=2 ** -7 * max(scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "dbrx-132b",
                                  "deepseek-v3-671b"])
def test_family_engine_and_scheduler_on_card(card, arch):
    """qwen3-4b (tied lm_head, qk_norm), DBRX and DeepSeek-V3 with their
    routed layers at SMOKE width, C-1, MoE at a capacity that never
    overflows: the Engine's speculative tokens equal autoregressive steps
    at the verify width on every position, ``draft_matmul`` launched once
    per packed matrix per draft pass (MLA's kv_b aside: its draft view is
    decoded by ``unary_decode``); the paged Scheduler with the attention
    kernels on gives the same tokens with fused == alternating and overlap
    on == off."""
    from repro_torch.core.packing import packed_paths
    from repro_torch.serving.scheduler import Scheduler
    cfg, cass, _, packed, gen = _moe_smoke(card, arch)
    extra = ({"moe_capacity_factor": cfg.n_experts / cfg.n_experts_per_tok}
             if cfg.n_experts else {})
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                           device=card).to(torch.int32)
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=3),
                 device=card, rt_extra=extra)
    per_pass = 0                      # packed matrices, a layer each
    for path in packed_paths(packed):
        node = packed
        for part in path.replace("[", ".").replace("]", "").split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        bm = node["w"]["spec"]["bitmap"]
        if not path.endswith("kv_b"):
            per_pass += bm.shape[0] if bm.ndim == 4 else 1
    DM.draft_matmul.launches = 0
    spec, st = eng.generate({"tokens": prompt}, max_new=12)
    assert DM.draft_matmul.launches == st["draft_passes"] * per_pass
    assert AR.verify_gap(eng, prompt, 3, 4) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, 12, 4)
    assert torch.equal(spec[:, :12].cpu(), toks.cpu())
    outs = {}
    for name, kw in (("fused", {}), ("alt", {"fused": False}),
                     ("sync", {"overlap": False})):
        sched = Scheduler(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=3),
                          num_slots=3, s_max=48, paged=True, block_size=4,
                          chunk_size=8, attn_kernel="on", rt_extra=extra,
                          device=card, **kw)
        reqs = [sched.submit(p, max_new=10) for p in prompt.cpu().numpy()]
        sched.run()
        assert all(len(r.output) == 10 for r in reqs)
        outs[name] = [r.output for r in reqs]
    assert outs["fused"] == outs["alt"] == outs["sync"]


# ---------------------------------------------------------------------------
# The Mamba-1 family: the mixer on the card, the Engine and the Scheduler
# ---------------------------------------------------------------------------

def _ssm_smoke(card, arch):
    """SMOKE falcon-mamba-7b or Jamba, C-1, random weights on the card, at
    (Jamba) a capacity that never overflows."""
    cfg = get_config(arch, smoke=True)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(5)
    plain = init_params(cfg, gen, device=card)
    extra = {}
    if cfg.n_experts:
        extra["moe_capacity_factor"] = cfg.n_experts / cfg.n_experts_per_tok
    return cfg, cass, plain, format_params(plain, cass), gen, extra


@pytest.mark.cuda
def test_mamba_on_card_matches_cpu(card):
    """falcon-mamba's layer-0 mixer on the card against the same layer on
    the CPU: a 20-token prefill and a 4-token decode from its state
    (``with_states``). The bf16 outputs and conv state within a few bf16
    ulps at their scale, h and h_all within 1e-2 relative (cuBLAS sums
    the projections in another order); the rollback window's carried rows
    bit for bit."""
    from repro_torch.models import ssm as SS
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import _index
    cfg, _, plain, _, gen, extra = _ssm_smoke(card, "falcon-mamba-7b")
    rt = Runtime(cfg=cfg, **extra)
    p = _index(plain["dec"][0]["e0"]["ssm"], 0)
    pc = _tree_to(p, "cpu")
    u = torch.randn((3, 20, cfg.d_model), generator=gen, device=card).to(
        torch.bfloat16)
    v = torch.randn((3, 4, cfg.d_model), generator=gen, device=card).to(
        torch.bfloat16)

    def close(a, b, rel):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float().cpu(), b.float(), rtol=0,
                                   atol=rel * max(scale, 1e-3))

    out, st, _ = SS.mamba(rt, p, u)
    out_c, st_c, _ = SS.mamba(rt, pc, u.cpu())
    close(out, out_c, 2 ** -6)
    close(st[0], st_c[0], 2 ** -6)
    close(st[1], st_c[1], 1e-2)
    d, dst, ex = SS.mamba(rt, p, v, state=st, with_states=True)
    d_c, _, ex_c = SS.mamba(rt, pc, v.cpu(),
                            state=tuple(t.cpu() for t in st),
                            with_states=True)
    close(d, d_c, 2 ** -6)
    close(ex["h_all"], ex_c["h_all"], 1e-2)
    assert torch.equal(ex["conv_win"][:, :3], st[0])
    assert torch.equal(ex["h_all"][:, -1], dst[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_ssm_engine_and_scheduler_on_card(card, arch):
    """falcon-mamba-7b and Jamba at SMOKE width, C-1: the Engine's
    speculative tokens equal autoregressive steps at the verify width on
    every position (the verify pass's logits bit for bit), ``draft_matmul``
    launched once per packed matrix per draft pass (x_proj 256 -> 16
    among them); the plain model's shape-stable draft accepted on every
    position; the paged Scheduler (attention kernels on) gives the same
    tokens with fused == alternating and overlap on == off, and a
    recycled slot the tokens its request gets alone."""
    from repro_torch.core.packing import packed_paths
    from repro_torch.serving.scheduler import Scheduler
    cfg, cass, plain, packed, gen, extra = _ssm_smoke(card, arch)
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                           device=card).to(torch.int32)
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=3),
                 device=card, rt_extra=extra)
    per_pass = 0
    for path in packed_paths(packed):
        node = packed
        for part in path.replace("[", ".").replace("]", "").split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        bm = node["w"]["spec"]["bitmap"]
        per_pass += bm.shape[0] if bm.ndim == 4 else 1
    DM.draft_matmul.launches = 0
    spec, st = eng.generate({"tokens": prompt}, max_new=12)
    assert DM.draft_matmul.launches == st["draft_passes"] * per_pass
    assert AR.verify_gap(eng, prompt, 3, 4) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, 12, 4)
    assert torch.equal(spec[:, :12].cpu(), toks.cpu())
    stable = Engine(cfg, plain, cass=None,
                    ecfg=EngineConfig(gamma=3, stable_draft=True),
                    device=card, rt_extra=extra)
    assert stable.generate({"tokens": prompt}, max_new=16)[1][
        "acceptance"] == 1.0
    def serve(prompts, **kw):
        kw = {"num_slots": 3, **kw}
        sched = Scheduler(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=3),
                          s_max=48, paged=True, block_size=4, chunk_size=8,
                          attn_kernel="on", rt_extra=extra, device=card, **kw)
        reqs = [sched.submit(p, max_new=10) for p in prompts]
        sched.run()
        assert all(len(r.output) == 10 for r in reqs)
        return [r.output for r in reqs]

    prompts = list(prompt.cpu().numpy())
    fused = serve(prompts)
    assert serve(prompts, fused=False) == fused
    assert serve(prompts, overlap=False) == fused
    recycled = serve(prompts, num_slots=1)
    assert recycled == [serve([p], num_slots=1)[0] for p in prompts]


# ---------------------------------------------------------------------------
# The encoder-decoder audio family and the vision frontend's backbone
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [("whisper-medium", None),
                                           ("phi-3-vision-4.2b", None),
                                           ("phi-3-vision-4.2b", 96)])
def test_encdec_engine_on_card(card, arch, head_dim):
    """whisper-medium (encoder, cross-attention, layer norms, learned
    positions) and phi-3-vision-4.2b (prepended patches; also widened to
    head_dim 96, its full-width head, so the KV stores encode and view at
    d = 96) at SMOKE width, C-1, with random frontend embeddings: the
    Engine's speculative tokens equal autoregressive steps at the verify
    width on every position (the verify pass's logits bit for bit);
    ``draft_matmul`` launched once per decoder matrix per draft pass
    (whisper's encoder and cross-attention K/V never draft); the cross
    K/V unchanged by the cycles; the Scheduler refused."""
    import dataclasses
    from repro_torch.kernels import kv_topk as KT, unary_decode as UD
    from repro_torch.serving.scheduler import Scheduler
    cfg = get_config(arch, smoke=True)
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    cass = CassandraConfig(variant=1, gamma=3)
    gen = torch.Generator(device=card).manual_seed(7)
    packed = format_params(init_params(cfg, gen, device=card), cass)
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen,
                           device=card).to(torch.int32)
    key = "frame_embeds" if cfg.frontend == "audio" else "patch_embeds"
    extra = {key: torch.randn((3, cfg.frontend_tokens, cfg.d_model),
                              generator=gen, device=card).to(torch.bfloat16)}
    eng = Engine(cfg, packed, cass=cass, ecfg=EngineConfig(gamma=3),
                 device=card)
    n_dec = cfg.n_layers * (8 if cfg.cross_attention else 7) + 1
    DM.draft_matmul.launches = KT.kv_encode.launches = 0
    UD.kv_view.launches = 0
    spec, st = eng.generate({"tokens": prompt, **extra}, max_new=12)
    assert DM.draft_matmul.launches == st["draft_passes"] * n_dec
    assert KT.kv_encode.launches == 2 * (1 + st["cycles"])
    assert UD.kv_view.launches > 0
    assert AR.verify_gap(eng, prompt, 3, 4, extra) == 0.0
    toks, _ = AR.ar_steps(eng, prompt, 12, 4, extra)
    assert torch.equal(spec[:, :12].cpu(), toks.cpu())
    if cfg.cross_attention:
        from repro_torch.serving.engine import spec_decode_step
        lg, cache = AR.prefill(eng, prompt, 40, extra)
        before = [{k: t.clone() for k, t in g["e0"].items()}
                  for g in cache["cross"]]
        cur = torch.argmax(lg, -1).to(torch.int32)[:, None]
        with torch.inference_mode():
            for _ in range(3):
                res, cache = spec_decode_step(eng.rt, packed, cache, cur,
                                              eng.ecfg)
                cur = res.next_token[:, None]
        for g, b in zip(cache["cross"], before):
            for k in b:
                assert torch.equal(g["e0"][k].view(torch.int16),
                                   b[k].view(torch.int16))
    with pytest.raises(NotImplementedError, match="token-prompt only"):
        Scheduler(cfg, packed, cass=cass, device=card)


# ---------------------------------------------------------------------------
# Training: train_step card vs CPU, remat, checkpoint byte views
# ---------------------------------------------------------------------------

def _tree_on(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_on(v, device) for v in tree]
    return tree.to(device)


def _train_setup(device, arch="llama3-8b", dtype=torch.bfloat16):
    """SMOKE params of ``dtype`` (from a CPU generator) and a batch on
    ``device``."""
    from repro_torch.data.pipeline import DataConfig, _one_batch
    from repro_torch.models.model import init_mtp
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(29)
    params = init_params(cfg, gen, dtype=dtype, device="cpu")
    if cfg.mtp_depth:
        params["mtp"] = init_mtp(cfg, gen, dtype=dtype, device="cpu")
    params = _tree_on(params, device)
    batch = _one_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4), 0, device)
    return cfg, params, batch


def _route_log(monkeypatch):
    """Records every MoE layer's routing (``ffn._route``): a list of
    (top-k experts, router probabilities) on the host, one per call. While
    ``log["replay"]`` holds a list of top-k sets, each call takes the next
    one instead of its own (the weights renormalised from its own
    probabilities) and logs its own set."""
    from repro_torch.models import ffn as F
    log = {"calls": [], "replay": []}
    route = F._route

    def logged(cfg, p, xt):
        rprobs, top_p, top_e = route(cfg, p, xt)
        log["calls"].append((top_e.cpu(), rprobs.cpu()))
        if log["replay"]:
            top_e = log["replay"].pop(0).to(xt.device)
            top_p = torch.gather(rprobs, 1, top_e)
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                        min=1e-9)
        return rprobs, top_p, top_e
    monkeypatch.setattr(F, "_route", logged)
    return log


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of |x| in ``dtype`` (bf16 or f32), at
    least the smallest normal's."""
    mant = 7 if dtype == torch.bfloat16 else 23
    _, e = torch.frexp(torch.clamp(x.abs(), min=torch.finfo(dtype).tiny))
    return torch.ldexp(torch.ones_like(x), e - 1 - mant)


def _moments_host(p, opt) -> dict:
    """Per moment, per leaf: (its f32 value, one quantum of it) on the
    host; an int8 moment dequantized, its quantum its block's scale, an
    fp32 moment's quantum 0."""
    from repro_torch.training import optim as O
    out = {}
    for k in "mv":
        rows = []
        for s, x in zip(O.flat_up_to(p, opt[k]), O.tree_leaves(p)):
            if isinstance(s, dict):
                q = s["scale"].repeat_interleave(O.QBLOCK, -1)
                rows.append((O._dq8(s, x.shape).float().cpu(),
                             q[..., :x.shape[-1]].float().cpu()))
            else:
                rows.append((s.float().cpu(), torch.zeros(())))
        out[k] = rows
    return out


def _train_step_both(card, arch, dtype, state_dtype, log=None):
    """One ``train_step``'s pieces (lr 1e-3) on the CPU, then the card:
    per device the loss, drops, gradients, old and new parameters and the
    moments, all f32 on the host. With ``log`` the card replays the CPU's
    routing. ``ref`` is the CPU's optimizer applied to the card's own
    gradients from the same parameters."""
    from repro_torch.core.tree import tree_unflatten
    from repro_torch.models.layers import Runtime
    from repro_torch.training import optim as O
    from repro_torch.training import trainer as T
    tcfg = T.TrainConfig(opt=O.OptConfig(lr=1e-3, warmup_steps=1,
                                         state_dtype=state_dtype))
    out = {}
    for dev in ("cpu", card):
        cfg, p, batch = _train_setup(dev, arch, dtype)
        if log is not None and dev != "cpu":
            log["cpu"] = log["calls"]
            log["calls"], log["replay"] = [], [e for e, _ in log["cpu"]]
        rt = Runtime(cfg=cfg, moe_capacity_factor=max(
            1.0, cfg.n_experts / max(cfg.n_experts_per_tok, 1)))
        g, m = T.grads_fn(rt, p, batch, tcfg)
        for a, b in zip(O.tree_leaves(g), O.tree_leaves(p)):
            assert a.dtype == b.dtype and a.device == b.device
        graw = [x.cpu() for x in O.tree_leaves(g)]
        # (a copy: the update writes the parameters in place)
        old = [x.float().cpu().clone() for x in O.tree_leaves(p)]
        p, opt, _ = O.apply_updates(p, g, O.init_opt_state(p, tcfg.opt),
                                    tcfg.opt)
        out[str(dev)] = {
            "loss": m["loss"].item(),
            "dropped": int(m["dropped"]) if "dropped" in m else 0,
            "g": [x.float() for x in graw], "graw": graw,
            "old": old, "new": [x.float().cpu() for x in O.tree_leaves(p)],
            "dtypes": [x.dtype for x in O.tree_leaves(p)],
            **_moments_host(p, opt)}
    d = out[str(card)]
    _, p, _ = _train_setup("cpu", arch, dtype)
    p, opt, _ = O.apply_updates(p, tree_unflatten(p, d["graw"]),
                                O.init_opt_state(p, tcfg.opt), tcfg.opt)
    d["ref"] = {"new": [x.float() for x in O.tree_leaves(p)],
                **_moments_host(p, opt)}
    return out["cpu"], d


def _assert_step_close(c, d, tol):
    """The card's step (``d``) against the CPU's (``c``): the loss within
    ``tol`` / 50 relative; each gradient leaf and each first moment within
    a relative error of ``tol`` and a cosine of sqrt(1 - tol²), each second
    moment within 2 tol (it is the gradient squared). Then the card's
    optimizer against the CPU's on the card's own gradients (``d["ref"]``),
    element by element: the new parameters within one ulp of max(|p_old|,
    |p_new|) in the leaf's dtype plus 2^-20 of the step (the global norm
    sums in another order, and the step's f32 roundings then fall
    elsewhere: a few ulps of the step), each moment within 2^-20 of itself
    plus one quantum (an int8 code on a rounding tie); a missing or
    sign-flipped update is lr off. At least 90% of the elements whose
    gradient exceeds a tenth of their leaf's rms moved on the card.
    Returns the worst gradient error."""
    assert abs(d["loss"] - c["loss"]) <= tol / 50 * abs(c["loss"])
    worst = 0.0
    for a, b in zip(d["g"], c["g"]):
        a, b = a.double(), b.double()     # a cosine near 1 needs f64 sums
        if b.norm() == 0:
            assert a.norm() == 0
            continue
        rel = ((a - b).norm() / b.norm()).item()
        worst = max(worst, rel)
        assert rel <= tol
        assert (a * b).sum() >= (1 - tol ** 2) ** 0.5 * a.norm() * b.norm()
    ref = d["ref"]
    for key, t in (("m", tol), ("v", 2 * tol)):
        for (a, _), (b, _) in zip(d[key], c[key]):
            assert (a - b).norm() <= t * b.norm(), key
        for (a, _), (b, q) in zip(d[key], ref[key]):
            assert ((a - b).abs() <= 2 ** -20 * b.abs()
                    + q * (1 + 2 ** -10)).all(), key
    kept = moved = 0
    for g, old, new, want, dt in zip(d["g"], d["old"], d["new"],
                                     ref["new"], d["dtypes"]):
        big = torch.maximum(old.abs(), torch.maximum(new.abs(), want.abs()))
        assert ((new - want).abs() <= _ulp(big, dt)
                + 2 ** -20 * (want - old).abs()).all()
        keep = g.abs() > 0.1 * g.square().mean().sqrt()
        kept += int(keep.sum())
        moved += int((new != old)[keep].sum())
    assert moved >= 0.9 * kept
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_train_step_on_card_matches_cpu(card, arch, state_dtype,
                                        monkeypatch):
    """One ``train_step`` on the card against the CPU, bf16 weights, as
    ``_assert_step_close`` holds it at tol 0.05 (bf16 activations round at
    other places: cuBLAS sums in another order). DeepSeek-V3 runs whole
    (MLA, its routed layers, the MTP head) at ``moe_capacity_factor =
    n_experts / k``, so nothing is dropped. bf16 rounding moves router
    probabilities by about 1e-3 between the devices, and a token whose
    k-th and (k+1)-th probabilities lie closer than that may take another
    expert set: two of 256 tokens did on an H100, and the router gradient
    then read 0.10-0.12 relative, while with the CPU's sets replayed it
    read 0.006. So the card replays the CPU's routing, and the test checks
    that its own sets differ only on such near ties."""
    log = _route_log(monkeypatch)
    c, d = _train_step_both(card, arch, torch.bfloat16, state_dtype, log)
    assert c["dropped"] == d["dropped"] == 0
    flips, near, gap = 0, [], 0.0
    for (ec, pc), (ed, pd) in zip(log["cpu"], log["calls"]):
        k = ec.shape[1]
        top = torch.sort(pc, -1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        differ = (torch.sort(ec, -1).values
                  != torch.sort(ed, -1).values).any(-1)
        flips += int(differ.sum())
        near += [f"{x:.2g}" for x in margin[differ].tolist()]
        gap = max(gap, (pd - pc).abs().max().item())
        assert (margin[differ] <= (pd - pc).abs().max()).all()
    worst = _assert_step_close(c, d, 0.05)
    print(f"{arch} {state_dtype}: worst gradient leaf {worst:.4f}; "
          f"{flips} tokens' own expert sets differed (near ties, margins "
          f"{near}, the devices' largest probability gap {gap:.3g})")
    if flips:
        # the witness: the card's gradients with its own routing
        from repro_torch.core.tree import leaves_with_paths
        from repro_torch.models.layers import Runtime
        from repro_torch.training import trainer as T
        cfg, p, batch = _train_setup(card, arch)
        rt = Runtime(cfg=cfg, moe_capacity_factor=max(
            1.0, cfg.n_experts / max(cfg.n_experts_per_tok, 1)))
        g, _ = T.grads_fn(rt, p, batch, T.TrainConfig())
        rel = max((((a.float().cpu() - b).norm() / b.norm()).item(), path)
                  for (path, a), b in zip(leaves_with_paths(g), c["g"]))
        print(f"  with the card's own routing: worst gradient leaf "
              f"{rel[1]} {rel[0]:.4f}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_train_step_on_card_matches_cpu_in_f32(card, arch, monkeypatch):
    """The same step with f32 weights (activations f32, no TF32): the card
    and the CPU differ only in the order of f32 sums, so the routing is
    the same on both with nothing replayed, and the loss, gradients (the
    MoE backward and the router's included) and moments agree within
    ``_assert_step_close``'s tol 1e-4 (an H100 read below 1e-5)."""
    log = _route_log(monkeypatch)
    c, d = _train_step_both(card, arch, torch.float32, "fp32")
    n_cpu = len(log["calls"]) // 2
    for (ec, _), (ed, _) in zip(log["calls"][:n_cpu], log["calls"][n_cpu:]):
        assert torch.equal(ec, ed)
    assert c["dropped"] == d["dropped"] == 0
    worst = _assert_step_close(c, d, 1e-4)
    print(f"{arch} f32: worst gradient leaf {worst:.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-v0.1-52b"])
def test_remat_on_card_equals_off(card, arch):
    """``remat`` "full" and "dots" give no remat's gradients bit for bit on
    the card (the recompute runs the same kernels on the same inputs)."""
    from repro_torch.models.layers import Runtime
    from repro_torch.training import optim as O
    from repro_torch.training import trainer as T
    cfg, p, batch = _train_setup(card, arch)
    want, _ = T.grads_fn(Runtime(cfg=cfg), p, batch, T.TrainConfig())
    for pol in ("full", "dots"):
        got, _ = T.grads_fn(Runtime(cfg=cfg, remat=True, remat_policy=pol),
                            p, batch, T.TrainConfig())
        for a, b in zip(O.tree_leaves(got), O.tree_leaves(want)):
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), pol


@pytest.mark.cuda
def test_checkpoint_bf16_byte_views_on_card(card, tmp_path):
    """A checkpoint of card tensors stores each bf16 leaf as the uint8
    view of its bytes (the reference's format: last axis doubled, dtype
    name ``bfloat16``) and restores onto the card bit for bit, NaN
    payloads, infinities and subnormals included."""
    import json
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    bits = torch.from_numpy(np.array(
        [0x7FC1, 0xFFA3, 0x7F80, 0xFF80, 0x0001, 0x8001, 0x3F80, 0x0000],
        np.uint16).view(np.int16))
    w = bits.repeat(3, 2).view(torch.bfloat16).to(card)
    tree = {"w": w, "s": torch.tensor(5, dtype=torch.int32, device=card),
            "q": torch.arange(-4, 4, dtype=torch.int8, device=card)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    meta = json.load(open(f"{path}/manifest.json"))["leaves"]["['w']"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [3, 16]
    raw = np.load(f"{path}/shard-0.npz")[meta["key"]]
    assert raw.dtype == np.uint8 and raw.shape == (3, 32)
    assert np.array_equal(raw.view(np.int16),
                          w.view(torch.int16).cpu().numpy())
    back = restore_checkpoint(str(tmp_path), 1, tree)
    assert back["w"].device == w.device and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(back["s"], tree["s"])
    assert torch.equal(back["q"], tree["q"])


# ---------------------------------------------------------------------------
# Format selection: the paper's grid (prune 0.3-0.6, truncation 0-5)
# ---------------------------------------------------------------------------

# truncations 1, 3 and 5 give 7-, 5- and 3-bit sign|mantissa codes that
# straddle 32-bit words; prunes 0.3 and 0.5 keep 352 and 256 of a 512-value
# block (the KV kernels take these points through KV_FORMATS)
GRID_POINTS = [(p, t) for p in (0.3, 0.5) for t in (1, 3, 5)]


def _grid_cass(prune, trunc):
    return CassandraConfig(variant=1, weight_prune=prune, weight_trunc=trunc,
                           kv_prune=prune, kv_trunc=trunc)


@pytest.mark.cuda
@pytest.mark.parametrize("prune,trunc", GRID_POINTS)
@pytest.mark.parametrize("n_in,n_out", [(1536, 1000), (4096, 520)])
def test_draft_matmul_at_grid_points_on_card(card, n_in, n_out, prune,
                                             trunc):
    """The decoded weight, read back through identity rows, bit for bit
    the plain draft view, and y within rtol 2e-2 / atol 1e-3 of the plain
    version at several M, away from the paper's (0.4, 4)."""
    cass = _grid_cass(prune, trunc)
    gen = torch.Generator(device=card).manual_seed(n_in + trunc)
    w = torch.randn((n_in, n_out), generator=gen, device=card).to(
        torch.bfloat16)
    spec, _ = format_weight(w, None, cass)
    ops = DM.prepare_draft_operands(spec, cass, (n_in, n_out))
    args = [ops[k] for k in ("bitmap", "signmant", "exp3", "emax", "book")]
    block = cass.weight_block(n_in)
    kw = dict(block=block, keep=cass.weight_keep(block), trunc=trunc,
              exp_bits=cass.exp_bits)
    assert kw["keep"] == {0.3: 352, 0.5: 256}[prune]
    eye = torch.eye(n_in, dtype=torch.bfloat16, device=card)
    got = DM.draft_matmul(eye, *args, **kw).to(torch.bfloat16)
    want = DM.draft_weight_plain(*args, **kw).contiguous()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    for m in (1, 4, 17):
        x = torch.randn((m, n_in), generator=gen, device=card).to(
            torch.bfloat16)
        torch.testing.assert_close(DM.draft_matmul(x, *args, **kw),
                                   DM.draft_matmul_plain(x, *args, **kw),
                                   rtol=2e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("prune,trunc", [(0.3, 0), (0.6, 5), (0.5, 1),
                                         (0.3, 3)])
def test_paged_gqa_packed_at_grid_points_on_card(card, prune, trunc, t):
    """The packed attention away from the paper's (keep 80, trunc 4): its
    decode of the pools bit for bit, and (acc, m, l) within rtol 1e-4 /
    atol 1e-5 of its plain version, under the default book and a book
    calibrated on other vectors (values at exponents it never saw take
    mode 1)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving import kvcache as KC
    cass = _grid_cass(prune, trunc)
    for calibrated in (False, True):
        book = None
        if calibrated:
            gen = torch.Generator().manual_seed(5)
            book = KC.calibrate_kv_codebook(
                torch.randn((64, 128), generator=gen) * 0.25)
        q, _, _, ks, vs, table, length, eor, kw = _paged_inputs(
            card, d=128, t=t, bs=16, seed=trunc + t, cass=cass, book=book)
        assert kw["keep"] == cass.kv_keep(128) != 80
        for sp in (ks, vs):
            assert torch.equal(
                PA.decode_spec_pool(sp, eor, **kw).view(torch.int16),
                PA.decode_spec_pool_plain(sp, eor, **kw).view(torch.int16))
        got = PA.paged_gqa_packed(q, ks, vs, table, length, eor,
                                  scale=128 ** -0.5, **kw)
        want = PA.paged_gqa_packed_plain(q, ks, vs, table, length, eor,
                                         scale=128 ** -0.5, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_calibrated_book_on_card_equals_cpu_and_reaches_the_cache(card):
    """``calibrate_kv_codebook`` on the card equals the CPU's bit for bit;
    through ``init_cache(codebook=)`` the book is the cache's, and a store
    encoded on the card with it (exponents it never saw included: mode 1)
    reads back its vectors bit for bit."""
    from repro_torch.serving import kvcache as KC
    gen = torch.Generator().manual_seed(11)
    samples = (torch.randn((256, 128), generator=gen) * 0.25).to(
        torch.bfloat16)
    cpu = KC.calibrate_kv_codebook(samples)
    dev = KC.calibrate_kv_codebook(samples.to(card))
    for a, b in zip(cpu, dev):
        assert torch.equal(a, b.cpu())
    cfg = get_config("llama3-8b", smoke=True)
    cass = CassandraConfig(variant=1)
    cache = KC.init_cache(cfg, cass, 2, 8, packed=True, codebook=dev,
                          device=card)
    book = KC.cache_codebook(cache)
    assert torch.equal(book[1], dev[1]) and book[0].shape == (256,)
    x = (torch.randn((2, 8, 128), generator=gen) * 0.25)
    x[0, 0] *= 2.0 ** 40                       # exponents never sampled
    x = x.to(torch.bfloat16).to(card)
    store = KC.encode_store(cass, x, 128, book)
    assert (store["spec"]["exp_mode"] == 1).any()
    assert (store["spec"]["exp_mode"] == 0).any()
    _same_tree(store, KC.encode_store_plain(cass, x, 128, book))
    back = KC.read_store(cass, store, 128, "target", book)
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
