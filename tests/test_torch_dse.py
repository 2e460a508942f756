"""Port vs reference, format selection: the paper's Eq. 2 grid search
(``core/dse.py``), Fig. 6's exponent statistics, the unary oracle,
``compression_summary`` across the grid, the calibrated KV codebook and
the registry's tuples; then the Engine at two corners of the grid.

Inputs come from numpy seeds. The grid search and the objective are pure
Python, so their points must be equal field for field and in order; the
statistics are f32 and held within 1e-6. No test here reads a clock, a
hypothesis database or a file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ar as AR
import torch_parity as TP
from repro import configs as jconfigs
from repro.core import bitops as jbit, coding as jcod, dse as jdse
from repro.core import format as jfmt
from repro.serving import kvcache as JKC
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.core import bitops, coding, dse, format as fmt
from repro_torch.core.packing import format_params
from repro_torch.models.model import init_params
from repro_torch.serving import kvcache as KC
from repro_torch.serving.engine import Engine, EngineConfig

PRUNES = (0.3, 0.4, 0.5, 0.6)
TRUNCS = (0, 1, 2, 3, 4, 5)


def _table(seed: int, levels: int):
    """A seeded acceptance table over the whole grid (both terms); alpha
    takes ``levels`` values, so equal-J points (ties of the sort) occur."""
    rng = np.random.default_rng(seed)
    keys = [(wp, wt, kp, kt) for wp in PRUNES for wt in TRUNCS
            for kp in PRUNES for kt in TRUNCS]
    vals = rng.integers(1, levels + 1, len(keys)) / levels
    return dict(zip(keys, (float(v) for v in vals)))


@pytest.mark.parametrize("s_w,s_kv", [(10.0, 1.0), (1.0, 4.0), (2.0, 2.0)])
@pytest.mark.parametrize("levels", [3, 1000])
def test_grid_search_equals_reference(s_w, s_kv, levels):
    """The same points, field for field and in the same order (the ties of
    a stable sort included), and the same probes in the same order, with
    the dominant term first (s_w > s_kv, s_w < s_kv) or the full product
    (s_w == s_kv)."""
    table = _table(int(s_w * 7 + s_kv + levels), levels)
    calls = {"ref": [], "port": []}

    def probe(which):
        def fn(w_p, w_t, kv_p, kv_t):
            calls[which].append((w_p, w_t, kv_p, kv_t))
            return table[(w_p, w_t, kv_p, kv_t)]
        return fn

    ref = jdse.grid_search(probe("ref"), s_w, s_kv)
    got = dse.grid_search(probe("port"), s_w, s_kv)
    assert calls["port"] == calls["ref"]
    assert len(got) == (48 if s_w != s_kv else 576)
    assert [tuple(vars(p).values()) for p in got] == [
        tuple(vars(p).values()) for p in ref]
    assert [p.objective for p in got] == sorted(
        (p.objective for p in got), reverse=True)
    if levels == 3:             # equal J among the points: the sort's ties
        js = [p.objective for p in got]
        assert len(set(js)) < len(js)
    # optimize_dominant_first=False and a custom grid take the full product
    kw = dict(prune_grid=(0.3, 0.5), trunc_grid=(0, 4),
              optimize_dominant_first=False)
    assert [vars(p) for p in dse.grid_search(probe("port"), s_w, s_kv,
                                             **kw)] == [
        vars(p) for p in jdse.grid_search(probe("ref"), s_w, s_kv, **kw)]


def test_objective_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        alpha = float(rng.random())
        s_w, s_kv = (float(x) for x in rng.random(2) * 20)
        wp, kp = (float(x) for x in rng.choice(PRUNES, 2))
        wt, kt = (int(x) for x in rng.choice(TRUNCS, 2))
        bits = int(rng.choice([8, 16]))
        assert dse.objective(alpha, s_w, s_kv, wp, wt, kp, kt, bits) == \
            jdse.objective(alpha, s_w, s_kv, wp, wt, kp, kt, bits)
    # a zero denominator takes the 1e-12 floor in both
    assert dse.objective(0.5, 0.0, 0.0, 0.3, 0, 0.3, 0) == \
        jdse.objective(0.5, 0.0, 0.0, 0.3, 0, 0.3, 0)
    assert dse.BF16_BITS == jdse.BF16_BITS


@pytest.mark.parametrize("density", [0.02, 0.1, 0.4, 0.9])
@pytest.mark.parametrize("k", [16, 80, 320])
def test_unary_decode_block_equals_reference(density, k):
    """Bit for bit the reference's oracle on arbitrary streams: regions
    with fewer than K ones (the zeros' positions read as later codes),
    runs of zeros longer than 31 (ranks clipped to 31), all-zero and
    all-one regions."""
    rng = np.random.default_rng(int(density * 100) + k)
    n_bits = jcod.region_words(k, 3) * 32
    b = rng.random((5, 7, n_bits)) < density
    b[0, 0] = False
    b[0, 1] = True
    b[0, 2, :] = False
    b[0, 2, 40::45] = True                      # runs of 44 zeros: clipped
    got = coding.unary_decode_block(torch.from_numpy(b), k)
    want = jcod.unary_decode_block(jnp.asarray(b), k)
    assert got.dtype == torch.uint8
    TP.assert_bitwise(got, want)
    # the encoder's own regions decode to the ranks it was given
    ranks = np.minimum(rng.geometric(0.55, (4, k)) - 1, 12).astype(np.uint8)
    ub, ok = coding.unary_encode_block(torch.from_numpy(ranks), n_bits)
    dec = coding.unary_decode_block(ub, k).numpy()
    np.testing.assert_array_equal(dec[ok.numpy()], ranks[ok.numpy()])


def _exps_samples():
    rng = np.random.default_rng(5)
    w = TP.rand_bf16_np(rng, (4096,), scale=0.02)
    kv = TP.outlier_bf16_np(rng, (256, 16)).reshape(-1)
    geo = (118 + rng.geometric(0.35, 5000) % 14).astype(np.uint8)
    few = np.full(9, 127, np.uint8)
    return {"weights": w, "kv": kv, "geometric": geo, "one symbol": few}


@pytest.mark.parametrize("name", ["weights", "kv", "geometric",
                                  "one symbol"])
def test_exponent_statistics_equal_reference(name):
    """Fig. 6's entropy and average unary code length within 1e-6, under
    each package's own codebook of the same exponents (equal bit for
    bit), and under the default KV book (ranks past 31 clipped)."""
    data = _exps_samples()[name]
    if data.dtype == np.uint8:
        jexps, exps = jnp.asarray(data), torch.from_numpy(data)
    else:
        nz = data[np.asarray(data, np.float32) != 0]
        _, jexps, _ = jbit.split_fields(jnp.asarray(nz))
        _, exps, _ = bitops.split_fields(TP.to_port(nz))
        TP.assert_bitwise(exps, jexps)
    ent = coding.shannon_entropy(exps)
    assert ent.dtype == torch.float32
    assert abs(float(ent) - float(jcod.shannon_entropy(jexps))) <= 1e-6
    jbook = jcod.build_codebook(jexps)
    book = coding.build_codebook(exps)
    TP.assert_bitwise(book, jbook)
    for rank, jrank in ((book[1], jbook[1]),
                        (KC.default_kv_codebook()[1],
                         JKC.default_kv_codebook()[1])):
        got = coding.avg_code_bits(exps, rank)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(jcod.avg_code_bits(jexps, jrank))) \
            <= 1e-6


# one point per truncation 0-5, every prune 0.3-0.6 at least once
SUMMARY_POINTS = [(0.3, 0), (0.4, 1), (0.5, 2), (0.6, 3), (0.3, 4),
                  (0.5, 5)]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("prune,trunc", SUMMARY_POINTS)
def test_compression_summary_across_the_grid(prune, trunc, variant):
    """Every packed leaf bit for bit the reference's at the grid point,
    and ``compression_summary`` over them exactly the reference's."""
    rng = np.random.default_rng(int(prune * 10) + trunc)
    w = TP.outlier_bf16_np(rng, (1024, 48))
    jc = jfmt.CassandraConfig(variant=variant, weight_prune=prune,
                              weight_trunc=trunc)
    pc = fmt.CassandraConfig(variant=variant, weight_prune=prune,
                             weight_trunc=trunc)
    jspec, jverif = jfmt.format_weight(jnp.asarray(w), None, jc)
    spec, verif = fmt.format_weight(TP.to_port(w), None, pc)
    TP.assert_bitwise(spec, jspec)
    TP.assert_bitwise(verif, jverif)
    got = fmt.compression_summary(spec, verif, w.size * 2)
    want = jfmt.compression_summary(jspec, jverif, w.size * 2)
    assert got == {k: (int(v) if isinstance(v, (int, np.integer)) else
                       float(v)) for k, v in want.items()}
    assert got["spec_bytes"] < w.size * 2


def test_compression_summary_falls_along_the_grid():
    """The draft stream shrinks as the prune or the truncation rises (the
    premise of Eq. 2's byte term), in both packages alike."""
    rng = np.random.default_rng(3)
    w = TP.to_port(TP.rand_bf16_np(rng, (512, 32)))
    spec_bytes = {}
    for p in PRUNES:
        for t in TRUNCS:
            cass = fmt.CassandraConfig(variant=1, weight_prune=p,
                                       weight_trunc=t)
            spec, verif = fmt.format_weight(w, None, cass)
            spec_bytes[p, t] = fmt.compression_summary(
                spec, verif, w.numel() * 2)["spec_bytes"]
    for p in PRUNES:
        row = [spec_bytes[p, t] for t in TRUNCS]
        assert row == sorted(row, reverse=True) and len(set(row)) == len(row)
    for t in TRUNCS:
        col = [spec_bytes[p, t] for p in PRUNES]
        assert col == sorted(col, reverse=True) and len(set(col)) == len(col)


def test_calibrated_kv_codebook_equals_reference_and_reaches_the_cache():
    """``calibrate_kv_codebook`` bit for bit the reference's (unseen
    exponents rank 255); through ``init_cache(codebook=)`` the book is the
    cache's in both packages, and a store encoded with it (a value whose
    exponent the calibration never saw included: mode 1) is the
    reference's leaf for leaf, its views too, the target view exact."""
    from repro.configs import get_config as jget
    rng = np.random.default_rng(8)
    samples = TP.rand_bf16_np(rng, (96, 64), scale=0.25)
    samples[0, :4] = 0.0
    jbook = JKC.calibrate_kv_codebook(jnp.asarray(samples))
    book = KC.calibrate_kv_codebook(TP.to_port(samples))
    TP.assert_bitwise(book, jbook)
    assert (book[1] == 255).sum() > 200
    # the f32 samples round to bf16 first, as the reference's astype does
    f32 = rng.standard_normal((40, 64)).astype(np.float32)
    TP.assert_bitwise(KC.calibrate_kv_codebook(torch.from_numpy(f32)),
                      JKC.calibrate_kv_codebook(jnp.asarray(f32)))

    jcfg, cfg = jget("llama3-8b", smoke=True), get_config("llama3-8b",
                                                          smoke=True)
    jc = jfmt.CassandraConfig(variant=1, kv_prune=0.3, kv_trunc=1)
    pc = fmt.CassandraConfig(variant=1, kv_prune=0.3, kv_trunc=1)
    jcache = JKC.init_cache(jcfg, jc, 2, 8, packed=True, codebook=jbook)
    cache = KC.init_cache(cfg, pc, 2, 8, packed=True, codebook=book,
                          device="cpu")
    TP.assert_bitwise(KC.cache_codebook(cache), JKC.cache_codebook(jcache))
    x = TP.rand_bf16_np(rng, (2, 3, 2, 64), scale=0.25)
    x[1, 2, 0, 5] = np.float32(3.0e4)           # an exponent never sampled
    jstore = JKC.encode_store(jc, jnp.asarray(x), 64,
                              JKC.cache_codebook(jcache))
    store = KC.encode_store(pc, TP.to_port(x), 64, KC.cache_codebook(cache))
    TP.assert_bitwise(store, jstore)
    assert int(store["spec"]["exp_mode"][1, 2, 0].sum()) == 1
    for view in ("draft", "target"):
        TP.assert_bitwise(
            KC.read_store(pc, store, 64, view, KC.cache_codebook(cache)),
            JKC.read_store(jc, jstore, 64, view, JKC.cache_codebook(jcache)))
    TP.assert_bitwise(KC.read_store(pc, store, 64, "target",
                                    KC.cache_codebook(cache)), x)


def test_registry_tuples_equal_reference():
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert configs.PAPER_MODELS == jconfigs.PAPER_MODELS
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert sorted(configs.ALL_ARCHS) == sorted(configs._MODULES)


def test_core_exports_equal_reference():
    import repro.core as jcore
    import repro_torch.core as core
    names = [n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))]
    assert names and all(hasattr(core, n) for n in names)
    assert core.compression_summary is fmt.compression_summary


@pytest.mark.parametrize("w_fmt,kv_fmt", [((0.3, 0), (0.6, 5)),
                                          ((0.6, 5), (0.3, 0))])
def test_engine_at_grid_corners_spec_equals_verify_width_ar(w_fmt, kv_fmt):
    """SMOKE Llama at two corners of the grid: spec tokens equal the
    port's autoregressive steps at the verify width on every position."""
    cfg = get_config("llama3-8b", smoke=True)
    cass = fmt.CassandraConfig(variant=1, gamma=3, weight_prune=w_fmt[0],
                               weight_trunc=w_fmt[1], kv_prune=kv_fmt[0],
                               kv_trunc=kv_fmt[1])
    gen = torch.Generator().manual_seed(4)
    params = format_params(init_params(cfg, gen, device="cpu"), cass)
    eng = Engine(cfg, params, cass=cass, ecfg=EngineConfig(gamma=3),
                 device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    spec, st = eng.generate({"tokens": prompt}, 10)
    assert st["draft_passes"] > 0
    assert AR.verify_gap(eng, prompt, 3, 4) == 0.0
    wide, _ = AR.ar_steps(eng, prompt, 10, 4)
    np.testing.assert_array_equal(spec[:, :10].numpy(), wide.numpy())
