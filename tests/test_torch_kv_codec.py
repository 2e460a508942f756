"""Port vs reference: the Cassandra-1 KV store codec that ``kv_encode`` and
``kv_view`` run on the card.

On the CPU ``kvcache.encode_store`` / ``read_store`` run the format's
chain (``encode_store_plain`` / ``read_store_plain``): the plain versions
``tests/test_torch_cuda.py`` holds the two kernels to on the card. Here the
chain is held, bit for bit, to the JAX package's ``encode_store`` /
``read_store`` at d = 64, 128 and 512 on rows with ties, +-0, inf,
subnormals, exponents the cache's book never saw (rank 255) and vectors
whose unary stream overflows (mode 1), under the default book and a book
built from data. NaN rows are held to the port's own selection only (the
reference's sort-based selection keeps other lanes, see
``test_torch_codec_kernels.py``). ``select_radix_np`` — the kernels'
radix-select rule in numpy — is held to ``kv_topk_plain``, so the
selection's design is checked before the card, and the launch plan of
``kv_view`` covers every vector once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.core import coding as jcod
from repro.core.format import CassandraConfig as JCass
from repro.serving import kvcache as JKC
from repro_torch.core import coding
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels import kv_topk as KT, unary_decode as UD
from repro_torch.serving import kvcache as KC

CASS, JCASS = CassandraConfig(variant=1), JCass(variant=1)


def select_radix_np(bits, keep: int):
    """The kernels' selection (``csrc/kv_topk.cu::select_lanes``) in numpy,
    step for step: (R, d) uint16 bf16 patterns -> (R, d) bool mask. A
    lane's key is ``bits & 0x7FFF``, a NaN's 0x8000 (above every T, and no
    radix count matches it); with kk = min(keep, lanes that are not NaN),
    T is the kk-th largest key, found bit by bit from the top (0x7FFF when
    kk == 0); a lane is kept if its key is above T, or equal to T with
    fewer than kk - #{key > T, not NaN} equal lanes before it."""
    k15 = (np.asarray(bits, np.uint16) & 0x7FFF).astype(np.int32)
    nan = k15 > 0x7F80
    key = np.where(nan, 0x8000, k15)
    kk = np.minimum(keep, key.shape[-1] - nan.sum(-1))
    prefix = np.zeros(key.shape[0], np.int32)
    need = kk.copy()
    for b in range(14, -1, -1):
        cand = prefix | (1 << b)
        hi = 0xFFFF & ~((1 << b) - 1)
        c = ((key & hi) == cand[:, None]).sum(-1)
        up = c >= need
        prefix = np.where(up, cand, prefix)
        need = np.where(up, need, need - c)
    t = np.where(kk > 0, prefix, 0x7FFF)[:, None]
    ties = kk[:, None] - ((key > t).sum(-1, keepdims=True)
                          - nan.sum(-1, keepdims=True))
    eq = key == t
    before = np.cumsum(eq, -1) - eq
    return (key > t) | (eq & (before < ties))


def _bf16(x) -> np.ndarray:
    return np.array(jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16))


def _edge_rows(rng, r: int, d: int) -> np.ndarray:
    """(r, d) bf16: random rows at scale 1/4 (unary under the default
    book), then all-equal, small integers, +-0 only, |v| ties, mostly
    zeros, inf, small normals with subnormals, a 2^+-12 spread (the
    stream overflows: mode 1) and -0 only."""
    v = TP.rand_bf16_np(rng, (r, d), scale=0.25)
    v[0] = _bf16(np.full(d, 1.5))
    v[1] = _bf16(rng.integers(-2, 3, d))
    v[2, ::2], v[2, 1::2] = _bf16(-0.0), _bf16(0.0)
    v[3, : d // 2] = -v[3, d // 2:]
    v[4, rng.random(d) < 0.7] = _bf16(0.0)
    v[5, [0, 3, d - 1]] = _bf16([np.inf, -np.inf, np.inf])
    # small normals, and subnormals at every 8th lane: the reference's
    # jitted compares on the CPU flush subnormals to zero (XLA's FTZ), so
    # they stay below the keep count here, where both orders prune them;
    # the port's exact order among subnormals is held to the radix rule
    # below and, on the card, to the kernels
    sgn = np.where(rng.random(d) < 0.5, -1.0, 1.0)
    v[6] = _bf16(sgn * (1 + np.abs(rng.standard_normal(d))) * 2.0 ** -120)
    v[6, ::8] = _bf16(sgn[::8] * (1 + np.abs(rng.standard_normal(d // 8)))
                      * 2.0 ** -132)
    v[7] = _bf16(rng.standard_normal(d) * np.exp2(rng.integers(-12, 13, d)))
    v[8] = _bf16(np.full(d, -0.0))
    return v


def _books(v: np.ndarray):
    """(name, port book, reference book): the default generic ranking and
    one built from the random rows only, under which inf, the subnormals'
    exponent 0 and the spread row's outer exponents were never seen."""
    jdef, pdef = JKC.default_kv_codebook(), KC.default_kv_codebook()
    exps = (TP.bits(v[9:]) >> 7) & 0xFF
    eor, roe = jcod.build_codebook(jnp.asarray(exps.astype(np.uint8)))
    built = (TP.to_port(np.asarray(eor)), TP.to_port(np.asarray(roe)))
    return (("default", pdef, jdef), ("built", built, (eor, roe)))


@pytest.mark.parametrize("d", [64, 128, 512])
def test_kv_store_codec_matches_reference(d):
    rng = np.random.default_rng(d)
    v = _edge_rows(rng, 24, d)
    x = v.reshape(2, 6, 2, d)
    for name, pbook, jbook in _books(v):
        ref = JKC.encode_store(JCASS, jnp.asarray(x), d, jbook)
        out = KC.encode_store(CASS, TP.to_port(x), d, pbook)
        TP.assert_bitwise(out, ref)
        mode = out["spec"]["exp_mode"].reshape(-1)
        assert (mode == 0).any() and (mode == 1).any(), name
        # the kept exponents the book ranks 255 take mode 1
        assert (mode[5] == 1) and (mode[7] == 1), name
        if name == "built":
            assert int(pbook[1][0]) == 255 and (mode[6] == 1)
        for view in ("draft", "target"):
            TP.assert_bitwise(KC.read_store(CASS, out, d, view, pbook),
                              JKC.read_store(JCASS, ref, d, view, jbook))
        TP.assert_bitwise(KC.read_store(CASS, out, d, "target", pbook), x)


def test_kv_store_codec_nan_rows_follow_the_ports_selection():
    """NaN lanes are always kept and count against no other lane, so a
    row keeps keep + #NaN lanes: the kept slots hold the first keep of
    them, the exponent region codes those (inf and NaN exponents: mode 1),
    and the target view reads each further kept position as the last kept
    slot, as ``desparsify`` clamps it."""
    d = 128
    keep = CASS.kv_keep(d)
    v = TP.rand_bf16_np(np.random.default_rng(9), (4, d), scale=0.25)
    vb = TP.bits(v)
    vb[0, [2, 40, 127]] = [0x7FC1, 0xFF80 | 0x25, 0x7F81]   # NaN payloads
    vb[1, ::4] = 0x7FC0                                      # 32 NaNs
    vb[2, 5] = 0x7F80                                        # inf, no NaN
    x = torch.from_numpy(vb.view(np.int16)).view(torch.bfloat16)
    book = KC.default_kv_codebook()
    store = KC.encode_store(CASS, x, d, book)
    mask = np.unpackbits(TP.bits(store["spec"]["bitmap"][:, 0]).view(
        np.uint8), bitorder="little").reshape(4, d).astype(bool)
    nan = (vb & 0x7FFF) > 0x7F80
    assert (mask.sum(-1) == keep + nan.sum(-1)).all() and mask[nan].all()
    np.testing.assert_array_equal(
        mask, select_radix_np(vb, keep))
    assert list(TP.bits(store["spec"]["exp_mode"][:, 0])) == [1, 1, 1, 0]
    view = TP.bits(KC.read_store(CASS, store, d, "target", book))
    for r in range(4):
        kept = np.flatnonzero(mask[r])
        want = vb[r].copy()
        want[kept[keep:]] = vb[r, kept[keep - 1]]
        np.testing.assert_array_equal(view[r], want)
    # the draft view: 0 where pruned; a NaN or inf in a kept slot keeps its
    # sign, exponent (emax, delta 0) and high mantissa bits
    draft = TP.bits(KC.read_store(CASS, store, d, "draft", book))
    assert (draft[~mask] == 0).all()
    for r in range(3):
        slots = np.flatnonzero(mask[r])[:keep]
        slots = slots[(vb[r, slots] & 0x7FFF) >= 0x7F80]       # NaN, inf
        assert len(slots) > 0
        np.testing.assert_array_equal(draft[r, slots] & 0xFFF0,
                                      vb[r, slots] & 0xFFF0)


@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
def test_radix_select_model_equals_kv_topk_plain(d):
    """The kernels' rule (threshold T by radix select over the 15-bit
    keys, ties by position, NaN always set) equals the rank rule of
    ``kv_topk_plain`` on edge rows, NaN rows and every keep at d = 32."""
    rng = np.random.default_rng(d + 1)
    v = TP.bits(_edge_rows(rng, 16, d))
    v[9, [1, 7, d - 1]] = 0x7FC0
    v[10, ::2] = 0xFFC1                                  # half the row NaN
    v[11, :] = 0x7F81                                    # all NaN
    v[12, : d // 2] = 0x0001                             # smallest subnormal
    x = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    for keep in sorted({16, d // 2, CASS.kv_keep(d), d} | (
            set(range(1, 33)) if d == 32 else set())):
        want = KT.kv_topk_plain(x, keep)["bitmap"]
        got = np.unpackbits(TP.bits(want).view(np.uint8),
                            bitorder="little").reshape(16, d).astype(bool)
        np.testing.assert_array_equal(select_radix_np(v, keep), got,
                                      err_msg=f"keep {keep}")


@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 512, 4096, 131072, 131075])
def test_kv_view_plan_covers_each_vector_once(d, rows):
    chunk, ctas = UD.kv_view_plan(rows, d)
    assert chunk % 16 == 0 and 16 <= chunk <= max(16, 8192 // d)
    assert 1 <= ctas <= UD.KV_VIEW_CTAS
    runs = -(-rows // chunk)
    owned = np.zeros(rows, np.int64)
    for c in range(ctas):                    # persistent: runs c, c + ctas
        for q in range(c, runs, ctas):
            owned[q * chunk:min(rows, (q + 1) * chunk)] += 1
    assert (owned == 1).all()
    assert ctas == min(runs, UD.KV_VIEW_CTAS)       # no CTA without a run


def test_kv_kernels_refuse_cpu_tensors():
    x = torch.zeros((4, 128), dtype=torch.bfloat16)
    book = KC.default_kv_codebook()
    with pytest.raises(ValueError, match="unsupported device cpu"):
        KT.kv_encode(x, book[1], keep=80, trunc=4, exp_bits=3)
    store = KC.encode_store(CASS, x, 128, book)
    assert coding.region_words(80, 3) == store["spec"]["exp_words"].shape[-1]
    with pytest.raises(ValueError, match="unsupported device cpu"):
        UD.kv_view(store["spec"], None, book[0], d=128, keep=80, trunc=4,
                   exp_bits=3)
