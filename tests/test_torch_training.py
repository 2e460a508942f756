"""Port vs reference: the training path at SMOKE width on the CPU.

The data pipeline, the int8 codes (moments and gradient compression) and
every update whose IEEE operations are the same in both packages are held
bit for bit. Elsewhere the tolerances are stated where they are used:

* the learning rate: XLA's f32 ``cos`` is not torch's (neither is
  correctly rounded), so after the warm-up a cosine may sit an ulp (2^-24
  near ±1) apart, and lr = lr0 · warm · (0.1 + 0.9 cos') then moves by
  that and the roundings it tips over, at most 2^-22 · lr0 in all: a few
  ulps of lr where it is small (the steps that differ are printed);
* the global norm: the two frameworks sum ~4e4 f32 squares in other
  orders, so the norms agree to 1e-5 relative (~sqrt(N) · 2^-24); a
  clipped update inherits that through the clip factor, so its f32
  moments and parameters are held to 128 f32 ulps (1.5e-5 relative), its
  int8 codes to 1 code and its bf16 parameters to 1 bf16 ulp (the count of
  elements that differ is printed);
* the loss and its gradients: the two packages round bf16 activations at
  other places, so their logits agree to ``LOGIT_ATOL`` 2e-2
  (``test_torch_model.py``). Each CE term is an lse minus a gold logit,
  so a CE moves by at most 2 × LOGIT_ATOL and z = lse² by 4 × |lse| ×
  LOGIT_ATOL; the gradients are held per leaf to a relative error of
  LOGIT_ATOL / the reference logits' rms (the logits' own relative gap
  bound, ≈ 0.09 at SMOKE) and a cosine of sqrt(1 - that²).

Inside the port, ``remat`` on and off give the same gradients bit for bit,
and so do a leaf walked in slices and whole.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as JD
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.models.layers import Runtime as JRuntime
from repro.sharding import collectives as JC
from repro.training import optim as JO
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.core.format import CassandraConfig
from repro_torch.data import pipeline as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime
from repro_torch.sharding import collectives as C
from repro_torch.training import optim as O
from repro_torch.training import trainer as T

jax.config.update("jax_platform_name", "cpu")

LOGIT_ATOL = 2e-2
LOSS_ARCHS = ["llama3-8b", "qwen3-4b", "deepseek-v3-671b", "jamba-v0.1-52b",
              "whisper-medium", "phi-3-vision-4.2b"]
SEQ, BATCH = 32, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dcfg(cfg, **kw):
    seq = SEQ + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    base = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=BATCH,
                frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
                d_model=cfg.d_model)
    base.update(kw)
    return base


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of the last place of a's f32 values."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a.astype(np.float64) - b) / ulp


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_one_batch_matches_reference(arch, n_hosts, host_id):
    """Tokens, labels and a frontend's bf16 embeddings bit for bit, several
    steps, per host."""
    cfg = get_config(arch, smoke=True)
    kw = _dcfg(cfg, n_hosts=n_hosts, host_id=host_id, global_batch=4,
               seed=3)
    for step in (0, 1, 7):
        ref = JD._one_batch(JD.DataConfig(**kw), step)
        got = D._one_batch(D.DataConfig(**kw), step, device="cpu")
        assert sorted(got) == sorted(ref)
        assert got["tokens"].dtype == torch.int32
        TP.assert_bitwise(got, ref)


def test_synthetic_batches_resume_and_file_stream(tmp_path):
    """``start_step`` resumes the stream where it was; the file-backed
    stream strides the same windows as the reference's."""
    cfg = get_config("llama3-8b", smoke=True)
    kw = _dcfg(cfg)
    full = D.synthetic_batches(D.DataConfig(**kw), device="cpu")
    seq = [next(full) for _ in range(6)]
    resumed = D.host_shard_iterator(D.DataConfig(**kw), start_step=4,
                                    device="cpu")
    for want in seq[4:]:
        step, got = next(resumed)
        assert step == want[0]
        TP.assert_bitwise(got, {k: v.numpy() for k, v in want[1].items()})
    data = (np.arange(5000, dtype=np.int64) * 7 % cfg.vocab_size).astype(
        np.int32)
    path = tmp_path / "tokens.bin"
    data.tofile(path)
    kw = _dcfg(cfg, token_file=str(path), n_hosts=2, host_id=1,
               global_batch=4)
    for step in (0, 3, 40):
        TP.assert_bitwise(D._one_batch(D.DataConfig(**kw), step, "cpu"),
                          JD._one_batch(JD.DataConfig(**kw), step))


def test_prefetcher_keeps_order():
    cfg = get_config("llama3-8b", smoke=True)
    it = D.Prefetcher(D.synthetic_batches(D.DataConfig(**_dcfg(cfg)),
                                          device="cpu"), depth=2)
    assert [next(it)[0] for _ in range(5)] == [0, 1, 2, 3, 4]
    assert list(D.Prefetcher(iter([(0, 1), (1, 2)]))) == [(0, 1), (1, 2)]


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

Q8_SHAPES = [(3, 1000), (2, 512), (4, 256), (300,), (2, 3, 300), (5, 17)]


@pytest.mark.parametrize("shape", Q8_SHAPES)
def test_q8_dq8_bit_for_bit(shape):
    """Codes and scales of ``_q8`` and the values of ``_dq8``, a last axis
    not a multiple of 256 included, on values, ties and zeros."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    x.reshape(-1)[: x.size // 4] = 0.0            # a zero block or two
    x.reshape(-1)[-3:] = 0.5 * x.reshape(-1)[-4]  # ties at a block's max
    for arr in (x, np.zeros(shape, np.float32)):
        ref = JO._q8(jnp.asarray(arr))
        got = O._q8(torch.from_numpy(arr))
        TP.assert_bitwise(got, ref)
        TP.assert_bitwise(O._dq8(got, shape), JO._dq8(ref, shape))


def _opt_tree(seed: int, grad_scale: float):
    """bf16 matrices (2-D, 3-D, a last axis not a multiple of 256) and f32
    vectors, with grads of the same structure (bf16 and f32)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (3, 40, 300)}, "b": {"w": (64, 96)},
              "norm": {"scale": (300,)}, "router": {"w": (24, 8)}}

    def leaf(path, shape, scale):
        bf = path[0] != "norm" and path[0] != "router"
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return np.array(jnp.asarray(x, jnp.bfloat16)) if bf else x

    params = {k: {n: leaf((k, n), s, 0.5) for n, s in v.items()}
              for k, v in shapes.items()}
    grads = {k: {n: leaf((k, n), s, grad_scale) for n, s in v.items()}
             for k, v in shapes.items()}
    return params, grads


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_apply_updates_bit_for_bit_unclipped(state_dtype):
    """Three warm-up steps with grads inside the clip (the clip is exactly
    1, so the global norm's summation order reaches no value): parameters,
    moments (codes and scales for int8), the step and lr bit for bit."""
    params, grads = _opt_tree(0, 1e-3)
    cfg = JO.OptConfig(state_dtype=state_dtype)
    jp, js = params, JO.init_opt_state(params, cfg)
    tp = TP.to_port(params)
    ts = O.init_opt_state(tp, O.OptConfig(state_dtype=state_dtype))
    TP.assert_bitwise(ts, js)
    tg = TP.to_port(grads)
    for _ in range(3):
        jp, js, jm = JO.apply_updates(jp, grads, js, cfg)
        tp, ts, tm = O.apply_updates(tp, tg, ts,
                                     O.OptConfig(state_dtype=state_dtype))
        assert float(jm["grad_norm"]) < cfg.grad_clip
        TP.assert_bitwise(tp, jp)
        TP.assert_bitwise(ts, js)
        TP.assert_bitwise(tm["lr"], jm["lr"])
        np.testing.assert_allclose(TP.f32(tm["grad_norm"]),
                                   TP.f32(jm["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_apply_updates_clipped_after_warmup(state_dtype):
    """Clipped grads past the warm-up (step 150 of 300): the clip factor
    carries the global norm's summation gap into every value, so f32
    values are held to 128 ulps, bf16 parameters to 1 bf16 ulp, int8 codes
    to 1 code; the differing counts and the largest gap are printed."""
    params, grads = _opt_tree(1, 3.0)
    cfg = JO.OptConfig(state_dtype=state_dtype, warmup_steps=20,
                       total_steps=300)
    js = dict(JO.init_opt_state(params, cfg))
    js["step"] = jnp.int32(150)
    tp = TP.to_port(params)
    ts = TP.to_port(js)
    jp, js, jm = JO.apply_updates(params, grads, js, cfg)
    tp, ts, tm = O.apply_updates(
        tp, TP.to_port(grads), ts, O.OptConfig(
            state_dtype=state_dtype, warmup_steps=20, total_steps=300))
    assert float(jm["grad_norm"]) > cfg.grad_clip
    np.testing.assert_allclose(TP.f32(tm["grad_norm"]),
                               TP.f32(jm["grad_norm"]), rtol=1e-5)
    assert _ulps(TP.f32(tm["lr"]), TP.f32(jm["lr"])) <= 1
    differ = 0
    for a, b in zip(O.tree_leaves(tp), jax.tree.leaves(jp)):
        bf16 = a.dtype == torch.bfloat16
        a, b = TP.f32(a), TP.f32(b)
        differ += int((a != b).sum())
        # one bf16 ulp is 2^16 f32 ulps
        assert _ulps(a, b).max() <= (2 ** 16 if bf16 else 128)
    worst = 0.0
    for name in ("m", "v"):
        for a, b in zip(O.tree_leaves(ts[name]), jax.tree.leaves(js[name])):
            if a.dtype == torch.int8:
                assert np.abs(TP.f32(a) - TP.f32(b)).max() <= 1
            else:
                worst = max(worst, _ulps(TP.f32(a), TP.f32(b)).max())
    assert worst <= 128
    print(f"clipped {state_dtype}: {differ} parameter values differ "
          f"(of {sum(np.size(x) for x in jax.tree.leaves(jp))}); moments "
          f"at most {worst:.0f} f32 ulps apart")


def test_lr_schedule_over_all_steps():
    """lr at every step 0..total_steps within 2^-22 · lr0 (XLA's cos); the
    warm-up, where the cosine reads cos(0) = 1, bit for bit."""
    cfg = JO.OptConfig(lr=1e-3, warmup_steps=20, total_steps=300)
    ref = np.array([np.float32(JO.lr_schedule(cfg, jnp.int32(s)))
                    for s in range(cfg.total_steps + 1)])
    got = np.array([O.lr_schedule(O.OptConfig(
        lr=1e-3, warmup_steps=20, total_steps=300), s).item()
        for s in range(cfg.total_steps + 1)], np.float32)
    gap = np.abs(got.astype(np.float64) - ref)
    assert gap.max() <= 2.0 ** -22 * cfg.lr
    assert (gap[:cfg.warmup_steps + 1] == 0).all()
    ulps = _ulps(got, ref)
    print(f"lr: {int((ulps > 0).sum())} of {ulps.size} steps differ, at "
          f"most {ulps.max():.0f} ulps of lr")


def test_sliced_update_equals_whole_leaf(monkeypatch):
    """A leaf walked in slices of its leading axis (1 row, 15 rows) gives
    the whole leaf's update bit for bit, fp32 and int8 moments, the
    global norm included (it sums in chunks of its own)."""
    params, grads = _opt_tree(2, 3.0)
    whole = O.SLICE_ELEMS
    for st in ("fp32", "int8"):
        cfg = O.OptConfig(state_dtype=st)
        outs = []
        for slice_elems in (whole, 1, 5 * 300):
            monkeypatch.setattr(O, "SLICE_ELEMS", slice_elems)
            tp = TP.to_port(params)
            ts = O.init_opt_state(tp, cfg)
            for _ in range(2):
                tp, ts, tm = O.apply_updates(tp, TP.to_port(grads), ts, cfg)
            outs.append((tp, ts, tm))
        assert len(O.leading_slices((3, 40, 300), 1)) == 3
        assert len(O.leading_slices((64, 96), 5 * 300)) == 5   # 15 rows each
        for tp, ts, tm in outs[1:]:
            TP.assert_bitwise(tp, outs[0][0])
            TP.assert_bitwise(ts, outs[0][1])
            TP.assert_bitwise(tm, outs[0][2])


def test_compress_grads_bit_for_bit(monkeypatch):
    """The int8 round trip of every leaf and the max error, bit for bit;
    a 0-d leaf passes through; the sliced walk changes nothing."""
    _, grads = _opt_tree(3, 2.0)
    ref, rerr = JC.compress_grads({**grads, "g": jnp.float32(1.5)})
    for slice_elems in (O.SLICE_ELEMS, 1):
        monkeypatch.setattr(O, "SLICE_ELEMS", slice_elems)
        tg = {**TP.to_port(grads), "g": torch.tensor(1.5)}
        got, gerr = C.compress_grads(tg)
        TP.assert_bitwise(got, ref)
        TP.assert_bitwise(gerr, rerr)


# ---------------------------------------------------------------------------
# Loss and gradients against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch: str, with_grads: bool):
    """The reference's SMOKE params, batch and jitted loss (and grads)."""
    cfg = jax_get_config(arch, smoke=True)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    batch = JD._one_batch(JD.DataConfig(**_dcfg(cfg)), 0)
    rt = JRuntime(cfg=cfg)
    loss = lambda p, b: JM.loss_fn(rt, p, b)
    if with_grads:
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params, batch)
    else:
        _, metrics = jax.jit(loss)(params, batch)
        grads = None
    logits, _ = jax.jit(lambda p, b: JM.forward_train(rt, p, b))(
        params, batch)
    return params, batch, metrics, grads, logits


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_metrics_match_reference(arch):
    """Every metric of ``loss_fn`` from the bridged parameters: ce and
    mtp_ce within 2 × LOGIT_ATOL, z within 4 × |lse| × LOGIT_ATOL, the
    balance term within 1% (f32 router probabilities of bf16 hidden
    states), drops equal."""
    params, batch, ref, _, _ = _reference(arch, False)
    cfg = get_config(arch, smoke=True)
    with torch.no_grad():
        _, got = M.loss_fn(Runtime(cfg=cfg), TP.to_port(params),
                           TP.to_port(batch))
    assert sorted(got) == sorted(ref)
    r = {k: float(v) for k, v in ref.items()}
    g = {k: float(v) for k, v in got.items()}
    for k in ("ce", "mtp_ce"):
        if k in r:
            assert abs(g[k] - r[k]) <= 2 * LOGIT_ATOL, (k, g[k], r[k])
    assert abs(g["z"] - r["z"]) <= 4 * np.sqrt(r["z"]) * LOGIT_ATOL
    if "balance" in r:
        assert abs(g["balance"] - r["balance"]) <= 1e-2 * r["balance"]
        assert g["dropped"] == r["dropped"]
    want = g["ce"] + 1e-4 * g["z"] + 1e-2 * g.get("balance", 0.0) \
        + 0.3 * g.get("mtp_ce", 0.0)
    assert abs(g["loss"] - want) <= 1e-5 * abs(want)
    assert abs(g["loss"] - r["loss"]) <= 3 * LOGIT_ATOL


def test_chunked_ce_against_full_logits_and_reference():
    """S = 1023 (512 does not divide it: chunks of 341): the fused CE and
    z equal the f32 CE of the full logits within 1e-5, and the reference's
    ``_chunked_ce`` on the same bf16 hidden states within 1e-5 relative
    (f32 sums in another order)."""
    params = _reference("llama3-8b", False)[0]
    cfg = get_config("llama3-8b", smoke=True)
    rng = np.random.default_rng(5)
    h = TP.rand_bf16_np(rng, (2, 1023, cfg.d_model))
    lab = rng.integers(0, cfg.vocab_size, (2, 1023)).astype(np.int32)
    tp = TP.to_port(params)
    rt = Runtime(cfg=cfg)
    th, tl = TP.to_port(h), torch.from_numpy(lab)
    with torch.no_grad():
        ce, z = M._chunked_ce(rt, tp, th, tl)
        logits = L.unembed(rt, tp, th)
        lse = torch.logsumexp(logits, -1)
        full_ce = (lse - torch.gather(logits, -1, tl[..., None].long())[
            ..., 0]).mean()
        full_z = lse.square().mean()
    np.testing.assert_allclose(ce.item(), full_ce.item(), rtol=1e-5)
    np.testing.assert_allclose(z.item(), full_z.item(), rtol=1e-5)
    rce, rz = JM._chunked_ce(JRuntime(cfg=jax_get_config("llama3-8b",
                                                         smoke=True)),
                             params, jnp.asarray(h), jnp.asarray(lab))
    np.testing.assert_allclose(ce.item(), float(rce), rtol=1e-5)
    np.testing.assert_allclose(z.item(), float(rz), rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_grads_match_reference(arch):
    """Per-leaf relative error and cosine against ``jax.value_and_grad``
    of the reference's loss; each gradient in its parameter's dtype."""
    params, batch, _, ref, logits = _reference(arch, True)
    tol = LOGIT_ATOL / float(np.sqrt(np.mean(TP.f32(logits) ** 2)))
    cfg = get_config(arch, smoke=True)
    tp = TP.to_port(params)
    got, _ = T.grads_fn(Runtime(cfg=cfg), tp, TP.to_port(batch),
                        T.TrainConfig())
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_flat = O.tree_leaves(got)
    assert len(got_flat) == len(ref_flat)
    worst = (0.0, 1.0, "")
    for (kp, r), g, p in zip(ref_flat, got_flat, O.tree_leaves(tp)):
        assert g.dtype == p.dtype, jax.tree_util.keystr(kp)
        a, b = TP.f32(r).ravel(), TP.f32(g).ravel()
        na = np.linalg.norm(a)
        rel = np.linalg.norm(a - b) / na
        cos = float(a @ b) / (na * np.linalg.norm(b))
        worst = max(worst, (rel, cos, jax.tree_util.keystr(kp)))
        assert rel <= tol and cos >= np.sqrt(1 - tol ** 2), (
            jax.tree_util.keystr(kp), rel, cos, tol)
    print(f"{arch}: worst leaf {worst[2]} rel {worst[0]:.4f} cos "
          f"{worst[1]:.5f} (tol {tol:.4f})")


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

def _port_setup(arch: str, seed: int = 0, **dkw):
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, gen, device="cpu")
    if cfg.mtp_depth:
        params["mtp"] = M.init_mtp(cfg, gen, device="cpu")
    batch = D._one_batch(D.DataConfig(**_dcfg(cfg, **dkw)), 0, "cpu")
    return cfg, params, batch


def _bits(tree) -> list:
    return [x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            for x in O.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "whisper-medium"])
def test_remat_grads_bit_for_bit(arch, monkeypatch):
    """``remat`` "full" and "dots" give no remat's gradients bit for bit;
    "dots" keeps some products' outputs (its policy says MUST_SAVE)."""
    from torch.utils.checkpoint import CheckpointPolicy
    cfg, params, batch = _port_setup(arch)
    saved = []
    policy = L._save_dots

    def counting(ctx, op, *a, **k):
        out = policy(ctx, op, *a, **k)
        saved.append(out == CheckpointPolicy.MUST_SAVE)
        return out

    monkeypatch.setattr(L, "_save_dots", counting)
    want, wm = T.grads_fn(Runtime(cfg=cfg), params, batch, T.TrainConfig())
    for pol in ("full", "dots"):
        got, gm = T.grads_fn(Runtime(cfg=cfg, remat=True, remat_policy=pol),
                             params, batch, T.TrainConfig())
        assert all(torch.equal(a, b) for a, b in zip(_bits(got),
                                                     _bits(want))), pol
        assert torch.equal(gm["loss"], wm["loss"])
    assert any(saved) and not all(saved)


def test_grad_accumulation_same_microbatch_twice():
    """The reference's rule (``tests/test_training.py``): accumulating the
    same microbatch twice equals one pass. The port sums in f32 and halves
    2g exactly, so it holds bit for bit here (the reference's own test
    allows rtol 2e-2)."""
    cfg, params, batch = _port_setup("llama3-8b", global_batch=4)
    half = {k: v[:2] for k, v in batch.items()}
    twice = {k: torch.cat([v, v]) for k, v in half.items()}
    g2, m2 = T.grads_fn(Runtime(cfg=cfg), params, twice,
                        T.TrainConfig(accum_steps=2))
    g1, m1 = T.grads_fn(Runtime(cfg=cfg), params, half, T.TrainConfig())
    for a, b in zip(O.tree_leaves(g2), O.tree_leaves(g1)):
        assert a.dtype == torch.float32
        assert torch.equal(a, b.to(torch.float32))
    assert torch.equal(m2["loss"], m1["loss"])
    # microbatches of different tokens: finite, of the same norm's order
    g4, _ = T.grads_fn(Runtime(cfg=cfg), params, batch,
                       T.TrainConfig(accum_steps=2))
    n4, n1 = O.global_norm(g4).item(), O.global_norm(g1).item()
    assert np.isfinite(n4) and 0.5 < n4 / n1 < 2.0


def test_grad_accumulation_refuses_a_ragged_batch():
    """A batch that does not split into ``accum_steps`` microbatches is
    refused, as the reference's ``reshape(n, B // n, ...)`` refuses it,
    instead of training on part of it."""
    cfg, params, batch = _port_setup("llama3-8b", global_batch=3)
    with pytest.raises(ValueError, match="3 rows does not split into 2"):
        T.grads_fn(Runtime(cfg=cfg), params, batch,
                   T.TrainConfig(accum_steps=2))


def test_loss_decreases():
    """The reference's ``test_loss_decreases``, eagerly: 100 train_steps
    lower the SMOKE loss by more than 0.3."""
    cfg, params, _ = _port_setup("llama3-8b")
    tcfg = T.TrainConfig(opt=O.OptConfig(lr=3e-3, total_steps=200,
                                         warmup_steps=5))
    opt = O.init_opt_state(params, tcfg.opt)
    dcfg = D.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=4)
    rt = Runtime(cfg=cfg)
    losses = []
    for step, batch in D.synthetic_batches(dcfg, device="cpu"):
        if step >= 100:
            break
        params, opt, m = T.train_step(rt, params, opt, batch, tcfg)
        losses.append(float(m["loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first - 0.3, (first, last)
    assert opt["step"].item() == 100


def test_int8_adam_tracks_fp32():
    """The reference's ``test_int8_adam_tracks_fp32``: from one gradient
    the int8 and fp32 update directions have cosine > 0.99."""
    cfg, params, batch = _port_setup("llama3-8b")
    grads, _ = T.grads_fn(Runtime(cfg=cfg), params, batch, T.TrainConfig())
    deltas = {}
    for st in ("fp32", "int8"):
        ocfg = O.OptConfig(lr=1e-3, state_dtype=st)
        p = TP.clone_tree(params)
        p, _, _ = O.apply_updates(p, grads, O.init_opt_state(p, ocfg), ocfg)
        deltas[st] = torch.cat([
            (a.float() - b.float()).reshape(-1)
            for a, b in zip(O.tree_leaves(p), O.tree_leaves(params))])
        assert torch.isfinite(deltas[st]).all() and deltas[st].abs().sum() > 0
    a, b = deltas["fp32"], deltas["int8"]
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos > 0.99, cos


def test_train_step_grad_compress_and_metrics():
    """``grad_compress`` adds ``compress_err``, the int8 round trip's max
    error; the step's metrics carry the loss's and the optimizer's."""
    cfg, params, batch = _port_setup("deepseek-v3-671b")
    tcfg = T.TrainConfig(opt=O.OptConfig(lr=1e-2, warmup_steps=1),
                         grad_compress=True)
    before = TP.clone_tree(params)
    params, opt, m = T.train_step(Runtime(cfg=cfg), params,
                                  O.init_opt_state(params, tcfg.opt), batch,
                                  tcfg)
    assert sorted(m) == sorted(["ce", "z", "balance", "dropped", "mtp_ce",
                                "loss", "compress_err", "grad_norm", "lr"])
    assert 0 < m["compress_err"].item() < 1e-2
    assert opt["step"].item() == 1
    moved = [not torch.equal(a, b) for a, b in zip(O.tree_leaves(params),
                                                   O.tree_leaves(before))]
    assert sum(moved) > 0.9 * len(moved)


def test_init_mtp_is_the_references_head():
    """``init_mtp`` builds the reference's ``mtp`` subtree (keys, shapes,
    dtypes, spread); ``format_params`` leaves it out of the served tree;
    ``loss_fn`` refuses an ``mtp_depth`` model without it."""
    jcfg = jax_get_config("deepseek-v3-671b", smoke=True)
    ref = jax_init_params(jcfg, jax.random.PRNGKey(0))["mtp"]
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              qk_rope_dim=32)
    got = M.init_mtp(get_config("deepseek-v3-671b", smoke=True),
                     torch.Generator().manual_seed(0), device="cpu")
    TP.assert_init_like(got, jax.device_get(ref))
    gen = torch.Generator().manual_seed(1)
    params = M.init_params(cfg, gen, device="cpu")
    params["mtp"] = M.init_mtp(cfg, gen, device="cpu")
    packed = packing.format_params(params, CassandraConfig(variant=1))
    assert "mtp" not in packed and "mtp" in params
    batch = D._one_batch(D.DataConfig(**_dcfg(cfg)), 0, "cpu")
    del params["mtp"]
    with pytest.raises(ValueError, match="init_mtp"):
        M.loss_fn(Runtime(cfg=cfg), params, batch)
