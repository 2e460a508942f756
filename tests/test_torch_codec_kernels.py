"""Port vs reference: the plain versions of the three codec kernels.

``mx_decode_plain``, ``unary_decode_plain`` and ``kv_topk_plain`` are the
oracles ``tests/test_torch_cuda.py`` holds the CUDA kernels to on the
card. Here they are held, bit for bit, to the oracles the JAX package
holds its Pallas kernels to (``repro.kernels.ref``), at the shapes of
``tests/test_kernels.py``, and at one small shape to the Pallas kernels
themselves in interpret mode (the slow-tier kernels there). Two places
where the Pallas kernel and its oracle part ways are pinned, and the port
takes the side its callers need:

* ``unary_decode`` on a region with fewer than K set bits (a delta-mode
  region, whose ranks ``decode_exponents`` discards): the port follows the
  Pallas kernel (position W*32 past the last one), the oracle reads clear
  bits as positions;
* ``kv_topk`` on a kept -0.0: the Pallas kernel's one-hot product returns
  +0.0; the port keeps the bits, as the oracle and the serving selection
  (``select_topk_blocked``) do.

``target_decode``'s plain version, the chain ``format.target_weight_plain``
that ``format.target_weight`` runs for CPU tensors, is held bit for bit to the reference's
``target_weight`` on weights with mode-1 superblocks (corrections kept or
trimmed) and with raw pruned values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.core import bitops as jbit, coding as jcod, mx as jmx
from repro.core import format as jfmt, pruning as jprune
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import coding, format as fmt
from repro_torch.kernels import kv_topk as KT, mx_decode as MXD
from repro_torch.kernels import unary_decode as UD


def _words(a) -> torch.Tensor:
    return TP.to_port(np.asarray(a))


# ---------------------------------------------------------------------------
# mx_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,group", [((8, 64), 32), ((16, 128), 16),
                                         ((4, 256), 32), ((6, 320), 32),
                                         ((10, 80), 16)])
def test_mx_decode_plain_equals_ref(shape, group):
    rng = np.random.default_rng(shape[1])
    x = TP.rand_bf16_np(rng, shape, scale=3.0)
    enc = jmx.mx_encode(jnp.asarray(x), group=group)
    # arbitrary containers and signs too: every 16-bit pattern reachable
    m16 = rng.integers(0, 1 << 16, size=shape).astype(np.uint16)
    sign = rng.integers(0, 2, size=shape).astype(np.uint8)
    se = rng.integers(0, 256, size=(shape[0], shape[1] // group)).astype(
        np.uint8)
    for s, m, e in ((enc["sign"], enc["m16"], enc["shared_exp"]),
                    (sign, m16, se)):
        out = MXD.mx_decode(TP.to_port(s), TP.to_port(m), TP.to_port(e),
                            group)
        assert out.dtype == torch.bfloat16
        TP.assert_bitwise(out, jref.mx_decode_ref(
            jnp.asarray(s), jnp.asarray(m), jnp.asarray(e), group=group))


def test_mx_decode_plain_equals_interpret_kernel():
    rng = np.random.default_rng(1)
    m16 = rng.integers(0, 1 << 16, size=(8, 64)).astype(np.uint16)
    m16[0, :8] = [0, 1, 2, 0x7F, 0x80, 0x8000, 0xFFFF, 0x0100]
    sign = rng.integers(0, 2, size=(8, 64)).astype(np.uint8)
    se = rng.integers(0, 256, size=(8, 2)).astype(np.uint8)
    se[0] = [0, 16]                 # exponents <= 0 flush to zero
    out = jops.mx_decode(jnp.asarray(sign), jnp.asarray(m16),
                         jnp.asarray(se), group=32, interpret=True)
    TP.assert_bitwise(MXD.mx_decode_plain(TP.to_port(sign), TP.to_port(m16),
                                          TP.to_port(se), 32), out)


# ---------------------------------------------------------------------------
# unary_decode
# ---------------------------------------------------------------------------

def _unary_words(rng, nb, k):
    ranks = np.minimum(rng.geometric(0.55, (nb, k)) - 1, 12).astype(np.uint8)
    n_bits = jcod.region_words(k, 3) * 32
    bits, ok = jcod.unary_encode_block(jnp.asarray(ranks), n_bits)
    assert bool(jnp.all(ok))
    return np.array(jbit.pack_bits(bits))


@pytest.mark.parametrize("k,nb", [(64, 8), (320, 4), (96, 16), (80, 12),
                                  (192, 3)])
def test_unary_decode_plain_equals_ref(k, nb):
    words = _unary_words(np.random.default_rng(k), nb, k)
    out = UD.unary_decode(_words(words), k)
    assert out.dtype == torch.int32 and out.shape == (nb, k)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jref.unary_decode_ref(jnp.asarray(words), k),
                                np.int32))


def test_unary_decode_plain_equals_interpret_kernel_on_any_words():
    """Encoder regions, a region whose stream runs into the word padding,
    and arbitrary words (fewer or more than K ones)."""
    rng = np.random.default_rng(2)
    k = 64
    words = _unary_words(rng, 8, k)
    w = words.shape[1]
    words[1] = 0
    words[1, -1] = np.uint32(1 << 31)                    # one, at the end
    words[2] = rng.integers(0, 1 << 32, size=w, dtype=np.uint64).astype(
        np.uint32)
    words[3] = 0                                         # no ones at all
    words[4, :] = np.uint32(0xFFFFFFFF)                  # more than K ones
    words[5, 0] = np.uint32(0x80000001)                  # sparse start
    out = jops.unary_decode(jnp.asarray(words), k, interpret=True)
    np.testing.assert_array_equal(
        UD.unary_decode_plain(_words(words), k).numpy(), np.asarray(out))
    # the encoder's regions: also the reference oracle's ranks
    ok = [0, 6, 7]
    np.testing.assert_array_equal(
        UD.unary_decode_plain(_words(words[ok]), k).numpy(),
        np.asarray(jref.unary_decode_ref(jnp.asarray(words[ok]), k),
                   np.int32))


def test_decode_exponents_unchanged_on_mixed_modes():
    """decode_exponents through the unary_decode wrapper == the
    reference's argsort decode, delta-mode blocks included."""
    rng = np.random.default_rng(3)
    exps = (118 + rng.geometric(0.4, (5, 64)) % 12).astype(np.uint8)
    exps[:2] = rng.integers(0, 255, size=(2, 64))          # mode 1
    book, rank = jcod.build_codebook(jnp.asarray(exps))
    region = jcod.encode_exponents(jnp.asarray(exps), rank, 3, 4)
    assert np.asarray(region["mode"]).any()
    for exact in (False, True):
        TP.assert_bitwise(
            coding.decode_exponents(TP.to_port(region), TP.to_port(book), 64,
                                    3, exact),
            jcod.decode_exponents(region, book, 64, 3, exact))


# ---------------------------------------------------------------------------
# kv_topk
# ---------------------------------------------------------------------------

def _adversarial(rng, r, d):
    """Random rows, then forced ties, +-0, all-equal and mostly-zero rows."""
    v = TP.rand_bf16_np(rng, (r, d))
    v[0] = np.asarray(jnp.full((d,), 1.5, jnp.bfloat16))           # all equal
    v[1] = np.asarray(jnp.asarray(rng.integers(-2, 3, d), jnp.bfloat16))
    v[2, ::2] = -0.0
    v[2, 1::2] = 0.0                                               # +-0 only
    v[3, : d // 2] = -v[3, d // 2:]                                # |v| ties
    v[4, rng.random(d) < 0.7] = 0.0
    return v


@pytest.mark.parametrize("r,d,keep", [(32, 128, 80), (16, 64, 32),
                                      (64, 128, 48), (8, 32, 16),
                                      (8, 256, 160)])
def test_kv_topk_plain_equals_ref(r, d, keep):
    v = _adversarial(np.random.default_rng(r + d + keep), r, d)
    out = KT.kv_topk(TP.to_port(v), keep)
    ref = jref.kv_topk_ref(jnp.asarray(v), keep)
    TP.assert_bitwise({k: out[k] for k in ("bitmap", "kept")}, ref)
    sel = jprune.select_topk_blocked(jnp.asarray(v),
                                     jnp.abs(jnp.asarray(v, jnp.float32)),
                                     keep, d)
    TP.assert_bitwise(out["pruned"], sel["pruned"][:, 0])
    assert (np.unpackbits(TP.bits(out["bitmap"]).view(np.uint8)).reshape(
        r, d).sum(-1) == keep).all()


def test_kv_topk_plain_equals_interpret_kernel():
    """Bitmap bit for bit; kept values as f32 (the Pallas kernel's one-hot
    product turns a kept -0.0 into +0.0, see the module doc)."""
    v = _adversarial(np.random.default_rng(4), 8, 64)
    out = KT.kv_topk_plain(TP.to_port(v), 32)
    got = jops.kv_topk(jnp.asarray(v), 32, interpret=True)
    TP.assert_bitwise(out["bitmap"], got["bitmap"])
    np.testing.assert_array_equal(TP.f32(out["kept"]), TP.f32(got["kept"]))
    negzero = TP.bits(out["kept"]) == 0x8000
    assert negzero.any() and not (TP.bits(got["kept"])[negzero] == 0x8000).any()


def test_kv_topk_nan_rows_fill_with_zeros():
    """NaNs rank 0 (every compare is false): more than keep lanes rank
    below keep; the kept slots take the first keep of them, the pruned
    slots past the unkept count are zero."""
    v = TP.rand_bf16_np(np.random.default_rng(5), (2, 32))
    v[0, [3, 9, 20]] = np.nan
    out = KT.kv_topk_plain(TP.to_port(v), 16)
    mask = np.unpackbits(TP.bits(out["bitmap"]).view(np.uint8),
                         bitorder="little").reshape(2, 32).astype(bool)
    assert mask[0].sum() == 19 and mask[1].sum() == 16
    assert mask[0, [3, 9, 20]].all()
    vb = TP.bits(v)
    np.testing.assert_array_equal(TP.bits(out["kept"][0]),
                                  vb[0, np.flatnonzero(mask[0])[:16]])
    np.testing.assert_array_equal(TP.bits(out["pruned"][0, :13]),
                                  vb[0, ~mask[0]])
    np.testing.assert_array_equal(TP.bits(out["pruned"][0, 13:]), 0)


# ---------------------------------------------------------------------------
# target_decode's plain version: the reference's target_weight chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,outliers,raw,trunc", [
    ((512, 48), True, False, 4),    # mode 1 on both sides, corrections kept
    ((256, 40), False, False, 4),   # every region unary: corrections trimmed
    ((512, 32), True, True, 4),     # raw pruned values
    ((1024, 24), True, False, 2),   # 6-bit sign|mantissa codes
    ((128, 40), True, False, 7)])   # 1-bit codes, 128-value superblocks
def test_target_decode_plain_equals_reference(shape, outliers, raw, trunc):
    rng = np.random.default_rng(sum(shape) + trunc)
    w = (TP.outlier_bf16_np(rng, shape) if outliers
         else TP.rand_bf16_np(rng, shape))
    jc = jfmt.CassandraConfig(variant=1, weight_trunc=trunc)
    pc = fmt.CassandraConfig(variant=1, weight_trunc=trunc)
    block = pc.weight_block(shape[0])
    keep = pc.weight_keep(block)
    wt = np.ascontiguousarray(w.T)
    jspec, jverif = jfmt._trim_lossless(*jfmt.format_tensor(
        jnp.asarray(wt), jnp.abs(jnp.asarray(wt, jnp.float32)), jc, block,
        keep, jc.mx_group, trunc, pruned_raw=raw), 1)
    pt = TP.to_port(wt)
    spec, verif = fmt._trim_lossless(*fmt.format_tensor(
        pt, pt.float().abs(), pc, block, keep, pc.mx_group, trunc,
        pruned_raw=raw), 1)
    TP.assert_bitwise(spec, jspec)
    TP.assert_bitwise(verif, jverif)
    assert bool(spec["exp_mode"].any()) == outliers
    assert ("exp_corr" in verif) == outliers
    assert ("pruned_raw" in verif) == raw
    if outliers and not raw:
        assert verif["pruned_exp_mode"].any() and "pruned_exp_corr" in verif
    ref = jfmt.target_weight(jspec, jverif, jc, shape)
    before = UD.target_decode.launches
    out = fmt.target_weight(spec, verif, pc, shape)
    assert UD.target_decode.launches == before     # CPU: the plain chain
    assert out.shape == shape
    TP.assert_bitwise(out, ref)
    TP.assert_bitwise(fmt.target_weight_plain(spec, verif, pc, shape), ref)
    TP.assert_bitwise(out, w)                                # lossless


def test_target_decode_refuses_cassandra_2():
    from repro_torch.kernels import unary_decode as UDK
    rng = np.random.default_rng(2)
    w = TP.to_port(TP.rand_bf16_np(rng, (256, 16)))
    c2 = fmt.CassandraConfig(variant=2)
    spec, verif = fmt.format_weight(w, None, c2)
    with pytest.raises(ValueError, match="Cassandra-1"):
        UDK.target_decode(spec, verif, c2, (256, 16))
    c1 = fmt.CassandraConfig(variant=1)
    spec1, verif1 = fmt.format_weight(w, None, c1)
    with pytest.raises(ValueError, match="unsupported device"):
        UDK.target_decode({k: v.to("meta") for k, v in spec1.items()},
                          verif1, c1, (256, 16))
    with pytest.raises(ValueError, match="unsupported device cpu"):
        UDK.target_decode(spec1, verif1, c1, (256, 16))
