"""The launch plans of the port's redesigned kernels, on the CPU.

* ``draft_matmul``: the planner's CTAs (32 output columns x a range of
  superblocks x a tile of rows) cover every (row, column, superblock) of a
  product exactly once, for every draft-product shape of the registered
  models at full width (Llama-3-8B, the dense GQA family, DBRX,
  DeepSeek-V3) and for ragged ones, and a plan split along K sums to the
  unsplit product within the kernel's tolerance.
* ``paged_gqa_packed``: the table split of the flash-decoding kernel, in
  plain torch (each chunk's flash state merged in chunk order), equals the
  unsplit plain walk within rtol 1e-4 / atol 1e-5, and the JAX reference's
  ``paged_gqa_packed`` run as its own tests run it on the CPU (``jnp`` and
  Pallas ``interpret``), on inputs made from a numpy seed.
* ``mx_view``: its plan covers every block of a C-2 tensor exactly once.
* ``kv_view``: its plan covers every vector exactly once at every head dim
  the kernels take, 96 (phi-3-vision) included, with runs on 16-vector
  boundaries.
* ``paged_mla``: its table split covers the table and cuts it only while
  the (row, pair tile) grid leaves SMs idle (its plain split walk is
  held to the reference in ``test_torch_mla.py``).
The CUDA kernels themselves run on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.core.format import CassandraConfig as JCass
from repro.kernels import paged_attention as JPA
from repro.serving import kvcache as JKC
from repro_torch.configs import get_config
from repro_torch.core.format import CassandraConfig, format_weight
from repro_torch.kernels import draft_matmul as DM
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import unary_decode as UD
from repro_torch.serving import kvcache as KC


def _gqa_shapes(cfg):
    """(in, out) of a GQA model's packed draft products: attention, the
    dense FFN (a gate only for SwiGLU, same shape as up), a shared
    expert's, and lm_head unless the embedding is tied (then the unembed
    is the bf16 table, never packed). Routed experts are never packed."""
    d, hd = cfg.d_model, cfg.hd
    shapes = {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
              (cfg.n_heads * hd, d)}
    if "m" in "".join(e[1] for e in cfg.block_pattern) or \
            cfg.first_dense_layers:
        shapes |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    if cfg.n_shared_experts:
        ff = cfg.expert_ff * cfg.n_shared_experts
        shapes |= {(d, ff), (ff, d)}
    if not cfg.tie_embeddings:
        shapes.add((d, cfg.vocab_size))
    return shapes


def _ssm_shapes(cfg):
    """(in, out) of a Mamba mixer's packed projections: in_proj, x_proj
    (dt_r + 2 x ssm_state wide: 288 at full width, a multiple of 32 but
    not of 64), dt_proj (dt_r = 256 inputs: one weight block) and
    out_proj."""
    d, di = cfg.d_model, cfg.d_inner
    return {(d, 2 * di), (di, cfg.dt_r + 2 * cfg.ssm_state),
            (cfg.dt_r, di), (di, d)}


def _main_path_shapes():
    """(in, out) of every draft product of the registered models at full
    width: Llama-3-8B, the dense GQA family, DBRX (attention and lm_head;
    its experts stay plain), DeepSeek-V3 (MLA, its dense FFN and the
    routed layers' shared expert), falcon-mamba-7b and Jamba (its Mamba
    mixers, attention, dense FFN and lm_head), whisper-medium (encoder and
    decoder attention, cross-attention, the GELU FFN and the odd-width
    lm_head) and phi-3-vision-4.2b."""
    shapes = set()
    for arch in ("llama3-8b", "qwen3-4b", "qwen3-1.7b", "qwen2.5-3b",
                 "nemotron-4-15b", "mistral-large-123b", "dbrx-132b",
                 "whisper-medium", "phi-3-vision-4.2b"):
        shapes |= _gqa_shapes(get_config(arch))
    ds = get_config("deepseek-v3-671b")
    d = ds.d_model
    shapes |= {(d, ds.q_lora_rank),
               (ds.q_lora_rank, ds.n_heads * (ds.qk_nope_dim + ds.qk_rope_dim)),
               (d, ds.kv_lora_rank + ds.qk_rope_dim),
               (ds.n_heads * ds.v_head_dim, d), (d, ds.d_ff), (ds.d_ff, d),
               (d, ds.expert_ff), (ds.expert_ff, d), (d, ds.vocab_size)}
    fm = get_config("falcon-mamba-7b")
    shapes |= _ssm_shapes(fm) | {(fm.d_model, fm.vocab_size)}
    jb = get_config("jamba-v0.1-52b")
    shapes |= _ssm_shapes(jb) | _gqa_shapes(jb)
    return sorted(shapes)


MAIN_SHAPES = _main_path_shapes()
RAGGED = [(512, 33), (1536, 1000), (7168, 576), (32, 5), (14336, 1024)]


def _tiles(m, n):
    return -(-n // DM.TILE_COLS) * -(-m // DM.tile_rows(m))


def _coverage(m, n, nb):
    seen = np.zeros((m, n, nb), np.int32)
    for cols, sbs, rows in DM.plan_ranges(m, n, nb):
        assert len(cols) and len(sbs) and len(rows)
        seen[rows.start:rows.stop, cols.start:cols.stop,
             sbs.start:sbs.stop] += 1
    return seen


def test_main_path_shapes_are_the_models():
    # 5 Llama shapes (wq and wo are both 4096 x 4096), 9 DeepSeek-V3 ones
    # (MLA kv_a is 512 + 64 = 576 wide; the shared expert 7168 <-> 2048),
    # qwen3-4b's 5 (n_heads x hd = 4096 != d_model 2560; tied: no
    # lm_head), qwen3-1.7b's 4, qwen2.5-3b's 3 new (wk/wv 2048 -> 256),
    # nemotron-4-15b's 5 (relu2: up and down), mistral-large-123b's 5,
    # DBRX's lm_head (its attention shapes are nemotron's), falcon-mamba-
    # 7b's 5 (in_proj 4096 -> 16384, x_proj 8192 -> 288, dt_proj 256 ->
    # 8192, out_proj 8192 -> 4096, lm_head 4096 -> 65024) and Jamba's
    # lm_head 4096 -> 65536 (its mixers are falcon-mamba's, its attention
    # and FFN Llama's), whisper-medium's 3 new (1024 -> 1024 for every
    # attention and cross-attention projection, up 1024 -> 4096, lm_head
    # 1024 -> 51865, an odd width; its down 4096 -> 1024 is Llama's wk)
    # and phi-3-vision-4.2b's 4 (3072 -> 3072, 3072 <-> 8192, lm_head
    # 3072 -> 32064)
    assert len(MAIN_SHAPES) == 50
    assert {(1024, 1024), (1024, 4096), (4096, 1024), (1024, 51865),
            (3072, 3072), (3072, 8192), (8192, 3072),
            (3072, 32064)} <= set(MAIN_SHAPES)
    assert {(4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
            (4096, 65024), (4096, 65536)} <= set(MAIN_SHAPES)
    assert (7168, 576) in MAIN_SHAPES and (4096, 1024) in MAIN_SHAPES
    assert {(2560, 4096), (2560, 1024), (2560, 9728), (9728, 2560),
            (4096, 2560)} <= set(MAIN_SHAPES)
    assert {(6144, 6144), (6144, 1024), (6144, 100352), (7168, 2048),
            (2048, 7168)} <= set(MAIN_SHAPES)
    assert (2560, 151936) not in MAIN_SHAPES


@pytest.mark.parametrize("shape", MAIN_SHAPES + RAGGED)
@pytest.mark.parametrize("m", [1, 4, 17])
def test_draft_plan_covers_each_column_superblock_once(shape, m,
                                                      monkeypatch):
    """The main path's plan, and plans forced to 1, 3 and nb splits by the
    CTA target."""
    n_in, n_out = shape
    nb = n_in // CassandraConfig().weight_block(n_in)
    assert (_coverage(m, n_out, nb) == 1).all()
    for split in (1, 3, nb):
        monkeypatch.setattr(DM, "TARGET_CTAS", split * _tiles(m, n_out))
        splits = DM.plan(m, n_out, nb)[1]
        assert splits == split if split != 3 else 1 <= splits <= 3
        assert (_coverage(m, n_out, nb) == 1).all()


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_draft_plan_fills_the_card(shape, monkeypatch):
    """At M = 4 every product gets the CTAs its superblocks allow, up to
    the target, and an unsplit plan wherever the columns alone reach it."""
    n_in, n_out = shape
    nb = n_in // CassandraConfig().weight_block(n_in)
    chunk, splits = DM.plan(4, n_out, nb)
    tiles = -(-n_out // DM.TILE_COLS)
    assert splits == -(-nb // chunk) and (splits - 1) * chunk < nb
    assert tiles * splits >= min(DM.TARGET_CTAS, tiles * nb) // 2
    if tiles >= DM.TARGET_CTAS:
        assert splits == 1
    monkeypatch.setattr(DM, "TARGET_CTAS", 1)
    assert DM.plan(4, n_out, nb) == (nb, 1)


@pytest.mark.parametrize("split", [1, 2, 3])
def test_draft_split_sums_match_unsplit(split, monkeypatch):
    """The kernel's split partials, summed in split order, give the plain
    product within the kernel's tolerance (rtol 2e-2 / atol 1e-3)."""
    shape = (1536, 40)
    cass = CassandraConfig(variant=1)
    gen = torch.Generator().manual_seed(split)
    w = torch.randn(shape, generator=gen).to(torch.bfloat16)
    spec, _ = format_weight(w, None, cass)
    ops = DM.prepare_draft_operands(spec, cass, shape)
    args = [ops[k] for k in ("bitmap", "signmant", "exp3", "emax", "book")]
    block = cass.weight_block(shape[0])
    kw = dict(block=block, keep=cass.weight_keep(block),
              trunc=cass.weight_trunc, exp_bits=cass.exp_bits)
    x = torch.randn((5, shape[0]), generator=gen).to(torch.bfloat16)
    monkeypatch.setattr(DM, "TARGET_CTAS", split * _tiles(5, shape[1]))
    chunk, splits = DM.plan(5, shape[1], 3)
    assert splits == split
    y = torch.zeros((5, shape[1]))
    for s in range(splits):
        lo, hi = s * chunk * block, min(3, (s + 1) * chunk) * block
        part = [a[:, s * chunk:min(3, (s + 1) * chunk)] for a in args[:4]]
        y = y + DM.draft_matmul_plain(x[:, lo:hi].contiguous(), *part,
                                      args[4], **kw)
    torch.testing.assert_close(y, DM.draft_matmul_plain(x, *args, **kw),
                               rtol=2e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# paged_gqa_packed: the table split and its merge
# ---------------------------------------------------------------------------

B, HKV, G, NB, BS, MB, D = 4, 2, 2, 12, 4, 5, 64
LENGTHS = np.array([13, 0, 20, 6], np.int32)
RTOL, ATOL = 1e-4, 1e-5


def _packed_case(seed, t):
    """Packed pools from both packages' encoders (bitwise equal), half the
    V rows spread over 2^±20 (delta mode), a table with out-of-range
    entries and a row that ends mid-block, and an empty row."""
    rng = np.random.default_rng(seed)
    jcass, cass = JCass(), CassandraConfig()
    jbook = JKC.default_kv_codebook()
    eor = jnp.zeros(256, jnp.uint8).at[:jbook[0].shape[0]].set(jbook[0])
    book = KC.default_kv_codebook()
    stores = []
    for wide in (False, True):
        x = rng.standard_normal((NB, BS, HKV, D)).astype(np.float32) * 0.25
        if wide:
            spread = np.exp2(rng.integers(-20, 20, x.shape)).astype(np.float32)
            x = np.where(rng.random(x.shape[:-1] + (1,)) < 0.5, x * spread, x)
        xb = np.array(jnp.asarray(x, jnp.bfloat16))
        js = JKC.encode_store(jcass, jnp.asarray(xb), D, (eor, jbook[1]))
        ps = KC.encode_store(cass, TP.to_port(xb), D, book)
        TP.assert_bitwise(ps, js)
        stores.append((js, ps))
    tbl = rng.integers(1, NB, (B, MB)).astype(np.int32)
    tbl[0, 4], tbl[2, 1], tbl[3, 2] = -3, NB + 7, 0
    q = TP.rand_bf16_np(rng, (B, t, HKV, G, D))
    kw = dict(d=D, keep=cass.kv_keep(D), trunc=cass.kv_trunc,
              exp_bits=cass.exp_bits, scale=D ** -0.5)
    return stores, eor, tbl, q, kw


def _close(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(TP.f32(p), TP.f32(r), rtol=RTOL,
                                   atol=ATOL)


# T as in test_torch_paged_attention's reference test: at T = 32 the
# 2^±20 delta-mode values cancel in acc (up to 4.9e5) past atol 1e-5 even
# for the unsplit walk against the reference (1 element of 16384)
@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("bps", [1, 2, 3, MB])
def test_split_walk_matches_unsplit_and_reference(t, bps):
    ((jk, k), (jv, v)), eor, tbl, q, kw = _packed_case(20 + t, t)
    args = (TP.to_port(q), k["spec"], v["spec"], torch.from_numpy(tbl),
            torch.from_numpy(LENGTHS), TP.to_port(np.asarray(eor)))
    split = PA.paged_gqa_packed_split_plain(*args, blocks_per_split=bps,
                                            **kw)
    unsplit = PA.paged_gqa_packed_plain(*args, **kw)
    _close(split, unsplit)
    ref = JPA.paged_gqa_packed(jnp.asarray(q), jk["spec"], jv["spec"],
                               jnp.asarray(tbl), jnp.asarray(LENGTHS), eor,
                               impl="jnp", **kw)
    _close(split, ref)
    # the empty row keeps the initial state exactly through the merge
    assert (split[0][1] == 0).all() and (split[2][1] == 0).all()
    assert (split[1][1] == PA.NEG_INF).all()


def test_split_walk_matches_interpret_kernel():
    """Against the reference's Pallas kernel in interpret mode, as the JAX
    package's own tests run it."""
    ((jk, k), (jv, v)), eor, tbl, q, kw = _packed_case(7, 1)
    ref = JPA.paged_gqa_packed(jnp.asarray(q), jk["spec"], jv["spec"],
                               jnp.asarray(tbl), jnp.asarray(LENGTHS), eor,
                               impl="interpret", **kw)
    split = PA.paged_gqa_packed_split_plain(
        TP.to_port(q), k["spec"], v["spec"], torch.from_numpy(tbl),
        torch.from_numpy(LENGTHS), TP.to_port(np.asarray(eor)),
        blocks_per_split=2, **kw)
    _close(split, ref)


def test_merge_of_one_part_is_that_part():
    acc = torch.randn((2, 3, 4))
    m, l = torch.randn((2, 3)), torch.rand((2, 3))
    out = PA.merge_flash_plain([(acc, m, l)])
    assert all(torch.equal(a, b) for a, b in zip(out, (acc, m, l)))


@pytest.mark.parametrize("b,hkv,g,t,mb", [
    (4, 8, 4, 1, 11),       # the Llama (and qwen3-4b) draft pass
    (4, 8, 4, 4, 11),
    (4, 8, 4, 1, 257),      # 4 x 4096 tokens
    (4, 8, 4, 32, 257),
    (4, 8, 6, 1, 11),       # DBRX, nemotron-4-15b: 48 heads over 8
    (4, 8, 6, 4, 11),
    (4, 8, 6, 32, 257),
    (4, 2, 8, 1, 11),       # qwen2.5-3b: 16 heads over 2
    (4, 2, 8, 4, 11),
    (4, 2, 8, 1, 257),
    (4, 8, 12, 1, 11),      # mistral-large-123b: 96 heads over 8
    (4, 8, 12, 4, 257),
    (4, 8, 2, 1, 11),       # qwen3-1.7b: 16 heads over 8
    (1, 1, 1, 1, 1), (3, 2, 2, 1, 0)])
def test_gqa_split_plan_covers_the_table(b, hkv, g, t, mb, monkeypatch):
    bps, splits = PA.gqa_split_plan(b, hkv, g, t, mb)
    cols = np.zeros(max(mb, 1), np.int32)
    for s in range(splits):
        cols[s * bps:(s + 1) * bps] += 1
    assert (cols == 1).all() and splits * bps >= mb > (splits - 1) * bps - 1
    ctas = b * hkv * -(-(g * t) // PA.Q_TILE) * splits
    assert ctas >= min(PA.TARGET_CTAS, b * hkv * -(-(g * t) // PA.Q_TILE)
                       * max(mb, 1)) // 2
    monkeypatch.setattr(PA, "TARGET_CTAS", 1)
    assert PA.gqa_split_plan(b, hkv, g, t, mb)[1] == 1


# ---------------------------------------------------------------------------
# paged_gqa: the same table split over plain bf16 pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("split", [None, 2, MB])
def test_paged_gqa_split_walk_matches_unsplit_and_reference(t, d, split,
                                                            monkeypatch):
    """The plain-pool kernel's split (the main path's plan for these
    shapes, and plans forced to 2 and MB splits by the CTA target), in
    plain torch, against the unsplit walk and the JAX reference's
    ``paged_gqa``: within rtol 1e-4 / atol 1e-5; the empty row stays
    initial."""
    rng = np.random.default_rng(30 + t + d)
    q = TP.rand_bf16_np(rng, (B, t, HKV, G, d))
    k = TP.rand_bf16_np(rng, (NB, BS, HKV, d))
    v = TP.rand_bf16_np(rng, (NB, BS, HKV, d))
    tbl = rng.integers(1, NB, (B, MB)).astype(np.int32)
    tbl[0, 4], tbl[2, 1], tbl[3, 2] = -3, NB + 7, 0
    if split is not None:
        monkeypatch.setattr(PA, "TARGET_CTAS",
                            split * B * HKV * -(-(G * t) // PA.Q_TILE))
    bps, splits = PA.plain_split_plan(B, HKV, G, t, MB)
    assert split is None or splits == split
    args = (TP.to_port(q), TP.to_port(k), TP.to_port(v),
            torch.from_numpy(tbl), torch.from_numpy(LENGTHS))
    scale = d ** -0.5
    out = PA.paged_gqa_split_plain(*args, scale=scale, blocks_per_split=bps)
    _close(out, PA.paged_gqa_plain(*args, scale=scale))
    ref = JPA.paged_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(tbl), jnp.asarray(LENGTHS), scale=scale,
                        impl="jnp")
    _close(out, ref)
    assert (out[0][1] == 0).all() and (out[1][1] == PA.NEG_INF).all()


@pytest.mark.parametrize("hkv,g", [(2, 6), (2, 8), (1, 12), (2, 4)])
@pytest.mark.parametrize("t", [1, 4])
def test_paged_gqa_walk_at_the_families_groups(hkv, g, t):
    """The plain-pool walk at the query groups of the dense GQA family and
    DBRX (G = 4 qwen3-4b, 6 DBRX / nemotron, 8 qwen2.5-3b, 12 mistral;
    G·T rows that leave the last 16-row query tile part empty), split by
    the main path's plan and unsplit, against the JAX reference's
    ``paged_gqa`` within rtol 1e-4 / atol 1e-5."""
    rng = np.random.default_rng(50 + g + t)
    d = 128
    q = TP.rand_bf16_np(rng, (B, t, hkv, g, d))
    k = TP.rand_bf16_np(rng, (NB, BS, hkv, d))
    v = TP.rand_bf16_np(rng, (NB, BS, hkv, d))
    tbl = rng.integers(1, NB, (B, MB)).astype(np.int32)
    tbl[0, 4], tbl[2, 1] = -3, NB + 7
    args = (TP.to_port(q), TP.to_port(k), TP.to_port(v),
            torch.from_numpy(tbl), torch.from_numpy(LENGTHS))
    scale = d ** -0.5
    bps, _ = PA.plain_split_plan(B, hkv, g, t, MB)
    out = PA.paged_gqa_split_plain(*args, scale=scale, blocks_per_split=bps)
    _close(out, PA.paged_gqa_plain(*args, scale=scale))
    ref = JPA.paged_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(tbl), jnp.asarray(LENGTHS), scale=scale,
                        impl="jnp")
    _close(out, ref)
    assert out[0].shape == (B, hkv, g, t, d)


# ---------------------------------------------------------------------------
# target_decode: the launch plan over a weight's superblocks
# ---------------------------------------------------------------------------

def _superblocks(shape):
    n_in, n_out = shape
    return n_out * (n_in // CassandraConfig().weight_block(n_in))


@pytest.mark.parametrize("shape", MAIN_SHAPES + RAGGED + [(512, 512)])
@pytest.mark.parametrize("target", [None, 1, 7, 10 ** 9])
def test_target_plan_covers_each_superblock_once(shape, target,
                                                 monkeypatch):
    """Every superblock of the weight decoded by exactly one warp, under
    the main path's plan (one wave of ``TARGET_CTAS``, each warp a
    superblock at least) and plans forced by the CTA target: CTA c owns
    superblocks [c * chunk, (c + 1) * chunk), so the runs tile the weight
    when the last one ends at or past it and the one before inside it."""
    from repro_torch.kernels import unary_decode as UD
    if target is not None:
        monkeypatch.setattr(UD, "TARGET_CTAS", target)
    s = _superblocks(shape)
    chunk, ctas = UD.target_plan(s)
    assert chunk >= UD.TD_WARPS and (ctas - 1) * chunk < s <= ctas * chunk
    assert ctas <= max(UD.TARGET_CTAS, 1) or chunk == UD.TD_WARPS
    if target is None and s >= UD.TARGET_CTAS * UD.TD_WARPS:
        assert ctas == -(-s // -(-s // UD.TARGET_CTAS))   # one wave


@pytest.mark.parametrize("b,hkv,g,t,mb,split", [
    (4, 8, 4, 4, 11, True),     # the Llama verify pass: 32 CTAs unsplit
    (4, 8, 4, 1, 257, True),    # one row a warp at 4 x 4096 tokens
    (4, 8, 4, 32, 11, False),   # a 32-token prefill chunk: 256 tiles
    (4, 8, 4, 32, 257, False), (1, 2, 2, 32, 6, True),
    (4, 8, 6, 4, 11, True),     # DBRX's verify pass: 64 tiles
    (4, 8, 6, 32, 11, False),   # its prefill chunk: 384 tiles
    (4, 2, 8, 4, 11, True),     # qwen2.5-3b's verify pass: 16 tiles
    (4, 2, 8, 32, 11, True),    # its prefill chunk: 128 tiles < 132 SMs
    (4, 8, 12, 4, 11, True),    # mistral's verify pass: 96 tiles
    (4, 8, 12, 32, 11, False)])
def test_plain_split_plan_splits_only_an_idle_grid(b, hkv, g, t, mb, split):
    """``paged_gqa`` splits the table only while the query tiles leave SMs
    idle; once they fill the card every CTA walks its whole table."""
    bps, splits = PA.plain_split_plan(b, hkv, g, t, mb)
    tiles = b * hkv * -(-(g * t) // PA.Q_TILE)
    assert (splits > 1) == split
    if tiles >= PA.build.SM_COUNT:
        assert (bps, splits) == (mb, 1)
    else:
        assert (bps, splits) == PA.gqa_split_plan(b, hkv, g, t, mb)


# ---------------------------------------------------------------------------
# mx_view: the launch plan over a C-2 tensor's blocks
# ---------------------------------------------------------------------------

def _c2_blocks():
    """Block counts of every C-2 view on the main path: each weight shape
    of Llama-3-8B (512-value blocks), a layer's KV store after a 128-token
    prefill and the whole stacked store (one block a (token, head))."""
    llama = get_config("llama3-8b")
    cass = CassandraConfig(variant=2)
    out = [s[1] * (s[0] // cass.weight_block(s[0])) for s in MAIN_SHAPES
           if s[0] % 32 == 0]
    s = 128 + 32 + 4
    out += [4 * s * llama.n_kv_heads, llama.n_layers * 4 * s
            * llama.n_kv_heads]
    return out + [1, 7, 8, 9, 527 * 8 + 1]


@pytest.mark.parametrize("blocks", _c2_blocks())
@pytest.mark.parametrize("target", [None, 1, 5, 10 ** 9])
def test_view_plan_covers_each_block_once(blocks, target, monkeypatch):
    """Every block of the tensor decoded by exactly one warp of one CTA,
    under the main path's plan (one wave of ``VIEW_CTAS``) and plans forced
    by the CTA target: CTA c owns blocks [c * chunk, (c + 1) * chunk),
    warp w of it blocks c * chunk + w, + 8, ..."""
    from repro_torch.kernels import mx_decode as MXD
    if target is not None:
        monkeypatch.setattr(MXD, "VIEW_CTAS", target)
    chunk, ctas = MXD.view_plan(blocks)
    seen = np.zeros(blocks, np.int32)
    for c in range(ctas):
        end = min(blocks, (c + 1) * chunk)
        for w in range(MXD.VIEW_WARPS):
            seen[c * chunk + w:end:MXD.VIEW_WARPS] += 1
    assert (seen == 1).all()
    assert chunk >= MXD.VIEW_WARPS
    assert ctas <= max(MXD.VIEW_CTAS, 1) or chunk == MXD.VIEW_WARPS


# ---------------------------------------------------------------------------
# paged_mla: the table split of the tensor-core walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,t,mb,split", [
    (4, 128, 1, 11, True),      # DeepSeek-V3's draft pass at the model's pools
    (4, 128, 4, 11, True),      # its verify pass
    (4, 128, 32, 11, False),    # a 32-token prefill chunk: 512 tiles
    (4, 128, 1, 257, True),     # 4 x 4096 tokens
    (4, 128, 4, 257, True),
    (4, 128, 32, 257, False),
    (1, 4, 1, 1, False), (3, 4, 1, 0, False), (2, 16, 3, 6, True)])
def test_mla_split_plan_covers_the_table_and_splits_an_idle_grid(
        b, h, t, mb, split):
    """Every table column in exactly one split; the table is cut only while
    the (row, pair tile) grid leaves SMs idle, up to about one CTA an SM;
    a grid whose tiles fill the card walks each table whole, in order."""
    bps, splits = PA.mla_split_plan(b, h, t, mb)
    cols = np.zeros(max(mb, 1), np.int32)
    for s in range(splits):
        cols[s * bps:(s + 1) * bps] += 1
    assert (cols == 1).all()
    tiles = b * -(-(h * t) // PA.MLA_Q_TILE)
    assert (splits > 1) == split
    if tiles >= PA.build.SM_COUNT:
        assert (bps, splits) == (max(mb, 1), 1)
    else:
        assert tiles * splits <= max(PA.MLA_TARGET_CTAS, tiles)
        assert splits == -(-max(mb, 1) // bps)
    assert PA.mla_split_plan(b, h, t, mb) == (bps, splits)


@pytest.mark.parametrize("d", UD.KV_HEAD_DIMS)
@pytest.mark.parametrize("rows", [1, 17, 96, 4096, 131075])
def test_kv_view_plan_at_every_head_dim(d, rows):
    """``kv_view``'s runs are multiples of 16 vectors of at most 8192
    values at every head dim, 96 too (8192 // 96 = 85 is not a multiple
    of 16: the run takes 80), and the persistent CTAs cover every vector
    exactly once."""
    chunk, ctas = UD.kv_view_plan(rows, d)
    assert chunk % 16 == 0 and 16 <= chunk and chunk * d <= 8192
    if d == 96 and rows >= 80 * UD.KV_VIEW_CTAS:
        assert chunk == 80
    runs = -(-rows // chunk)
    assert ctas == min(runs, UD.KV_VIEW_CTAS)
    owned = np.zeros(rows, np.int64)
    for c in range(ctas):
        for q in range(c, runs, ctas):
            owned[q * chunk:min(rows, (q + 1) * chunk)] += 1
    assert (owned == 1).all()
