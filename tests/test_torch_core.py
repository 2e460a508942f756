"""Port vs reference, core: every bit of the Cassandra-1 format.

Integer and bit-level work must match bit for bit: the bit ops, top-k
selection (ties to the earlier index), codebooks (stable tie order), the
unary/delta exponent codecs, every spec and verif leaf of the weight and
KV formats, and every draft and target decode. Inputs are numpy arrays
from a seed; blocks are forced into mode 1 by exponent outliers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.configs import get_config as jax_get_config
from repro.core import bitops as jbit, coding as jcod, format as jfmt
from repro.core import packing as jpack, pruning as jprune
from repro.core import speculative as jspec
from repro.models import init_params as jax_init_params
from repro.serving import kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core import bitops, coding, format as fmt, packing
from repro_torch.core import pruning, speculative
from repro_torch.serving import kvcache as KC

import jax

CASS = fmt.CassandraConfig(variant=1)
JCASS = jfmt.CassandraConfig(variant=1)


def _t(a):
    return TP.to_port(a)


def test_config_fields_match():
    for smoke in (False, True):
        ref = dataclasses.asdict(jax_get_config("llama3-8b", smoke=smoke))
        assert dataclasses.asdict(get_config("llama3-8b", smoke=smoke)) == ref


@pytest.mark.parametrize("width", [1, 3, 4, 8])
def test_bitops_pack_unpack(width):
    rng = np.random.default_rng(width)
    codes = rng.integers(0, 1 << width, size=(3, 5, 37)).astype(np.uint8)
    jw = jbit.pack_codes(jnp.asarray(codes), width)
    pw = bitops.pack_codes(torch.from_numpy(codes), width)
    TP.assert_bitwise(pw, jw)
    back = bitops.unpack_codes(pw, width, 37)
    np.testing.assert_array_equal(back.numpy(), codes)
    b = rng.random((4, 96)) < 0.3
    TP.assert_bitwise(bitops.pack_bits(torch.from_numpy(b)),
                      jbit.pack_bits(jnp.asarray(b)))
    np.testing.assert_array_equal(
        bitops.unpack_bits(bitops.pack_bits(torch.from_numpy(b)), 96).numpy(), b)
    nib = rng.integers(0, 16, size=(6, 8)).astype(np.uint8)
    TP.assert_bitwise(bitops.pack_nibbles(torch.from_numpy(nib)),
                      jbit.pack_nibbles(jnp.asarray(nib)))


def test_bitops_fields_roundtrip():
    rng = np.random.default_rng(0)
    x = TP.rand_bf16_np(rng, (64, 33), scale=7.0)
    xt = _t(x)
    for p, r in zip(bitops.split_fields(xt), jbit.split_fields(jnp.asarray(x))):
        TP.assert_bitwise(p, r)
    TP.assert_bitwise(bitops.join_fields(*bitops.split_fields(xt)), x)
    for keep in (0, 3, 7):
        tr, lo = bitops.truncate_mantissa(xt, keep)
        jtr, jlo = jbit.truncate_mantissa(jnp.asarray(x), keep)
        TP.assert_bitwise(tr, jtr)
        TP.assert_bitwise(lo, jlo)
        TP.assert_bitwise(bitops.merge_mantissa(tr, lo, keep), x)


@pytest.mark.parametrize("block,keep", [(128, 64), (64, 48)])
def test_select_topk_ties_and_desparsify(block, keep):
    rng = np.random.default_rng(block)
    v = TP.rand_bf16_np(rng, (5, 2 * block))
    s = rng.integers(0, 4, size=(5, 2 * block)).astype(np.float32)  # ties
    ref = jprune.select_topk_blocked(jnp.asarray(v), jnp.asarray(s), keep,
                                     block)
    out = pruning.select_topk_blocked(_t(v), torch.from_numpy(s), keep, block)
    TP.assert_bitwise(out, ref)
    TP.assert_bitwise(
        pruning.desparsify(out["bitmap"], out["kept"], block, out["pruned"]),
        jprune.desparsify(ref["bitmap"], ref["kept"], block, ref["pruned"]))
    TP.assert_bitwise(pruning.desparsify(out["bitmap"], out["kept"], block),
                      jprune.desparsify(ref["bitmap"], ref["kept"], block))


def test_build_codebook_tie_order():
    rng = np.random.default_rng(1)
    exps = rng.choice([120, 121, 125, 126, 127], size=400).astype(np.uint8)
    exps[:80] = 124          # a few exact count ties among the rest
    for p, r in zip(coding.build_codebook(torch.from_numpy(exps)),
                    jcod.build_codebook(jnp.asarray(exps))):
        TP.assert_bitwise(p, r)


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
def test_unary_decode_bitwise_on_any_stream(density):
    """The port's unary decode (``kernels.unary_decode``, which
    ``decode_exponents`` calls) equals the reference's ``unary_decode_block``
    on the encoder's regions and the reference's Pallas kernel (interpret
    mode) on arbitrary bit patterns."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import unary_decode as UD
    rng = np.random.default_rng(int(density * 100))
    k = 80
    n_bits = jcod.region_words(k, 3) * 32
    b = rng.random((6, 3, n_bits)) < density
    ranks = np.minimum(rng.geometric(0.55, (6, 3, k)) - 1, 12).astype(np.uint8)
    ub, ok = jcod.unary_encode_block(jnp.asarray(ranks), n_bits)
    pub, pok = coding.unary_encode_block(torch.from_numpy(ranks), n_bits)
    TP.assert_bitwise(pub, ub)
    TP.assert_bitwise(pok, ok)
    words = np.array(jbit.pack_bits(jnp.asarray(ub)))
    np.testing.assert_array_equal(
        UD.unary_decode(_t(words), k).numpy(),
        np.asarray(jcod.unary_decode_block(ub, k), np.int32))
    words = np.array(jbit.pack_bits(jnp.asarray(b))).reshape(18, -1)
    np.testing.assert_array_equal(
        UD.unary_decode(_t(words), k).numpy(),
        np.asarray(jops.unary_decode(jnp.asarray(words), k, interpret=True)))


@pytest.mark.parametrize("corr_bits", [4, 8])
def test_exponent_region_codec(corr_bits):
    rng = np.random.default_rng(corr_bits)
    exps = (118 + rng.geometric(0.4, (4, 6, 64)) % 12).astype(np.uint8)
    exps[0, :2] = rng.integers(0, 255, size=(2, 64))      # mode-1 blocks
    exps[1, 0, :5] = 0                                      # escape (zero)
    _, rank = jcod.build_codebook(jnp.asarray(exps))
    ref = jcod.encode_exponents(jnp.asarray(exps), rank, 3, corr_bits)
    out = coding.encode_exponents(torch.from_numpy(exps), _t(rank), 3,
                                  corr_bits)
    TP.assert_bitwise(out, ref)
    assert np.asarray(ref["mode"]).any() and not np.asarray(ref["mode"]).all()
    book = jcod.build_codebook(jnp.asarray(exps))[0]
    for exact in (False, True):
        TP.assert_bitwise(
            coding.decode_exponents(out, _t(book), 64, 3, exact, corr_bits),
            jcod.decode_exponents(ref, book, 64, 3, exact, corr_bits))


@pytest.mark.parametrize("shape,outliers", [((512, 64), True),
                                            ((256, 96), False),
                                            ((1024, 40), True)])
def test_format_weight_leaves_and_decodes(shape, outliers):
    rng = np.random.default_rng(shape[1])
    w = (TP.outlier_bf16_np(rng, shape) if outliers
         else TP.rand_bf16_np(rng, shape))
    jspec_, jverif = jfmt.format_weight(jnp.asarray(w), None, JCASS)
    spec, verif = fmt.format_weight(_t(w), None, CASS)
    TP.assert_bitwise(spec, jspec_)
    TP.assert_bitwise(verif, jverif)
    assert bool(np.asarray(jspec_["exp_mode"]).any()) == outliers
    # mode-1 blocks keep their corrections; all-unary tensors trim them
    assert ("exp_corr" in verif) == bool(np.asarray(jspec_["exp_mode"]).any())
    TP.assert_bitwise(fmt.draft_weight(spec, CASS, shape),
                      jfmt.draft_weight(jspec_, JCASS, shape))
    target = fmt.target_weight(spec, verif, CASS, shape)
    TP.assert_bitwise(target, jfmt.target_weight(jspec_, jverif, JCASS, shape))
    TP.assert_bitwise(target, w)                            # lossless


def test_c1_delta_regions_are_exact_within_20_binades():
    """A reference behaviour the port reproduces: a mode-1 (delta) exponent
    region stores each exponent as a 3-bit code below the region's max
    plus a 4-bit correction, so it is exact only within 20 binades below
    that max; an exponent further below decodes as max − 20. Two mode-1
    columns each get one kept-or-pruned value 2^24 and 2^34 times below
    its region's largest: both packages' target views lose exactly those
    two values, bit for bit alike, and keep every other value."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((512, 8)).astype(np.float32)
    w[:, :2] *= np.exp2(rng.integers(-6, 7, (512, 2)))   # forces mode 1
    w[7, 0], w[9, 1] = 2.0 ** -30, 2.0 ** -40
    w = np.array(jnp.asarray(w, jnp.bfloat16))
    jspec_, jverif = jfmt.format_weight(jnp.asarray(w), None, JCASS)
    spec, verif = fmt.format_weight(_t(w), None, CASS)
    assert np.asarray(jspec_["exp_mode"])[:2].all()
    target = fmt.target_weight(spec, verif, CASS, w.shape)
    TP.assert_bitwise(target, jfmt.target_weight(jspec_, jverif, JCASS,
                                                  w.shape))
    lost = np.argwhere(TP.bits(target) != TP.bits(w))
    assert lost.tolist() == [[7, 0], [9, 1]]
    np.testing.assert_array_equal(TP.f32(target)[7, 0], 2.0 ** -23)


def test_target_weight_row_chunks(monkeypatch):
    rng = np.random.default_rng(7)
    w = TP.outlier_bf16_np(rng, (256, 80))
    spec, verif = fmt.format_weight(_t(w), None, CASS)
    monkeypatch.setattr(fmt, "ROW_CHUNK", 24)      # ragged last chunk
    TP.assert_bitwise(fmt.target_weight(spec, verif, CASS, (256, 80)), w)


def test_kv_store_encode_and_views():
    rng = np.random.default_rng(3)
    kv = TP.rand_bf16_np(rng, (2, 5, 2, 64), scale=2.0)
    kv[0, 0, 0, :3] = np.asarray(jnp.asarray([1e30, 1e-30, 0.0], jnp.bfloat16))
    book = JKC.default_kv_codebook()
    ref = JKC.encode_store(JCASS, jnp.asarray(kv), 64, book)
    out = KC.encode_store(CASS, _t(kv), 64, KC.default_kv_codebook())
    TP.assert_bitwise(out, ref)
    pbook = KC.default_kv_codebook()
    for view in ("draft", "target"):
        TP.assert_bitwise(KC.read_store(CASS, out, 64, view, pbook),
                          JKC.read_store(JCASS, ref, 64, view, book))
    TP.assert_bitwise(KC.read_store(CASS, out, 64, "target", pbook), kv)


def test_format_kv_and_trim():
    rng = np.random.default_rng(4)
    kv = TP.rand_bf16_np(rng, (3, 4, 128))
    jsp, jvf = jfmt.format_kv(jnp.asarray(kv), JCASS)
    sp, vf = fmt.format_kv(_t(kv), CASS)
    TP.assert_bitwise((sp, vf), (jsp, jvf))
    TP.assert_bitwise(fmt.draft_kv(sp, CASS, 128), jfmt.draft_kv(jsp, JCASS, 128))
    TP.assert_bitwise(fmt.target_kv(sp, vf, CASS, 128), kv)


def test_format_params_smoke_tree():
    """format_params over the smoke model: stacked per-layer packing,
    trimming and byte accounting match the reference leaf for leaf."""
    cfg = jax_get_config("llama3-8b", smoke=True)
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    jpacked = jpack.format_params(jp, JCASS)
    packed = packing.format_params(_t(jp), CASS)

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k != "kernel"}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    TP.assert_bitwise(strip(packed), jpacked)
    nb, jnb = packing.params_nbytes(packed), jpack.params_nbytes(jpacked)
    assert {k: nb[k] for k in jnb} == jnb
    assert nb["kernel"] > 0
    # the bf16 bytes the packed weights replace
    assert nb["bf16"] == jpack.params_nbytes(jp)["plain"] - jnb["plain"]


@pytest.mark.parametrize("tie_margin", [0.0, 0.5])
def test_greedy_accept_parity(tie_margin):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 4, 32)).astype(np.float32)
    target = logits.argmax(-1)
    draft = target[:, :3].copy()
    draft[1, 0] = (draft[1, 0] + 1) % 32
    draft[2, 2] = (draft[2, 2] + 3) % 32
    ref = jspec.greedy_accept(jnp.asarray(draft, jnp.int32),
                              jnp.asarray(logits), tie_margin)
    out = speculative.greedy_accept(torch.from_numpy(draft).to(torch.int32),
                                    torch.from_numpy(logits), tie_margin)
    for p, r in zip(out, ref):
        TP.assert_bitwise(p, r)
    assert speculative.expected_tokens_per_cycle(0.5, 3) == \
        jspec.expected_tokens_per_cycle(0.5, 3)
    assert speculative.speedup_model(0.5, 3, 0.33) == \
        jspec.speedup_model(0.5, 3, 0.33)
