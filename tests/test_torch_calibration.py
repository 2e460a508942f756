"""Port vs reference, Wanda calibration at SMOKE width.

``wanda_scores`` is one f32 product and matches bit for bit;
``calibration_act_norm`` and the ``Calibrator``'s norms sum squares of
bf16 activations in f32 in another order than XLA, so they are held to
the reference within the tolerances stated in each test. Fed the same
norms, ``format_params`` and ``format_weight`` give every leaf bit for bit.

The reference's calibrator observes under the layer functions' labels
(``attn.wq``) and skips values traced inside its layer scan, so its walk
finds a norm for ``lm_head`` alone; the port observes under each weight's
path in the tree, one row per layer. The forward tests compare what both
compute: ``lm_head``'s norm, and each label's sum over the layers (the
reference's unrolled forward observes every layer).
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.configs import get_config as jax_get_config
from repro.core import format as jfmt, packing as jpack, pruning as jprune
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.models.layers import Runtime as JRuntime
from repro_torch.configs import get_config
from repro_torch.core import format as fmt, packing, pruning
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.layers import Runtime


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(node):
    """A packed tree without the port's prepared draft-kernel operands."""
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items() if k != "kernel"}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    return node


def test_wanda_scores_and_act_norm_match_reference():
    """wanda_scores bit for bit; calibration_act_norm over 300 bf16 tokens
    within rtol 2e-5 (300 f32 squares summed in another order: at most
    ~300 ulps apart, ~2e-5)."""
    rng = np.random.default_rng(0)
    w = TP.rand_bf16_np(rng, (256, 48))
    an = rng.uniform(0.1, 3.0, 256).astype(np.float32)
    TP.assert_bitwise(pruning.wanda_scores(TP.to_port(w), TP.to_port(an)),
                      jprune.wanda_scores(jnp.asarray(w), jnp.asarray(an)))
    acts = TP.rand_bf16_np(rng, (300, 256), scale=2.0)
    np.testing.assert_allclose(
        TP.f32(pruning.calibration_act_norm(TP.to_port(acts))),
        TP.f32(jprune.calibration_act_norm(jnp.asarray(acts))), rtol=2e-5)


def test_calibrator_matches_reference():
    """The same bf16 activations observed at the same paths, outside any
    layer scope: norms within rtol 2e-5 (f32 sums of squares in another
    order), counts equal; a path observed at a new width restarts."""
    rng = np.random.default_rng(1)
    ref, port = jpack.Calibrator(), packing.Calibrator()
    for path, shape in (("a", (2, 7, 64)), ("a", (3, 5, 64)),
                        ("b", (11, 32)), ("a", (1, 4, 64)),
                        ("b", (6, 48))):
        x = TP.rand_bf16_np(rng, shape, scale=3.0)
        ref.observe(path, jnp.asarray(x))
        port.observe(path, TP.to_port(x))
    assert port.counts == ref.counts
    for path in ("a", "b"):
        np.testing.assert_allclose(TP.f32(port.act_norm(path)),
                                   TP.f32(ref.act_norm(path)), rtol=2e-5)
    assert port.act_norm("c") is None and ref.act_norm("c") is None


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jplain = jax_init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    cfg = get_config("llama3-8b", smoke=True)
    plain = TP.to_port(jplain)
    calib = packing.Calibrator()
    with torch.inference_mode():
        logits, _ = M.forward_train(Runtime(cfg=cfg, collector=calib), plain,
                                    {"tokens": torch.from_numpy(prompt)})
    return {"jcfg": jcfg, "jplain": jplain, "prompt": prompt, "cfg": cfg,
            "plain": plain, "calib": calib, "logits": logits}


def test_forward_train_matches_reference(smoke):
    """All positions' logits against the reference's ``forward_train``:
    within 0.03 (the packages round bf16 at different places; measured
    0.0103 at logits up to 0.93), and
    the calibrating run's logits equal a plain run's bit for bit."""
    jrt = JRuntime(cfg=smoke["jcfg"])
    jlogits, _ = JM.forward_train(jrt, smoke["jplain"],
                                  {"tokens": jnp.asarray(smoke["prompt"])})
    got = smoke["logits"]
    assert got.shape == jlogits.shape and got.dtype == torch.float32
    assert np.abs(TP.f32(got) - TP.f32(jlogits)).max() < 0.03
    with torch.inference_mode():
        plain, _ = M.forward_train(Runtime(cfg=smoke["cfg"]), smoke["plain"],
                                   {"tokens": torch.from_numpy(
                                       smoke["prompt"])})
    assert torch.equal(plain, got)


def test_calibration_forward_matches_reference(smoke):
    """The port's norms from its calibration forward against the
    reference's: ``lm_head`` against its scanned forward (the only path
    that run observes) and each layer label's sum of squares over the
    layers against its unrolled forward, within rtol 2e-2 (bf16
    activations of two packages that round at different places; measured
    up to 0.0108, at ``ffn.w_down``)."""
    jcfg, jplain = smoke["jcfg"], smoke["jplain"]
    batch = {"tokens": jnp.asarray(smoke["prompt"])}
    jscan = jpack.Calibrator()
    JM.forward_train(JRuntime(cfg=jcfg, collector=jscan), jplain, batch)
    assert set(jscan.sq_sums) == {"lm_head"}
    junroll = jpack.Calibrator()
    JM.forward_train(JRuntime(cfg=jcfg, collector=junroll, unroll=True),
                     jplain, batch)
    calib = smoke["calib"]
    np.testing.assert_allclose(TP.f32(calib.act_norm("lm_head")),
                               TP.f32(jscan.act_norm("lm_head")), rtol=2e-2)
    labels = {"attn.wq": "attn.wq", "attn.wk": "attn.wk",
              "attn.wv": "attn.wv", "attn.wo": "attn.wo",
              "ffn.w_gate": "ffn.gate", "ffn.w_up": "ffn.up",
              "ffn.w_down": "ffn.down"}
    for port_label, ref_label in labels.items():
        norm = calib.act_norm(f"dec[0].e0.{port_label}")
        assert norm.shape[0] == jcfg.n_layers
        np.testing.assert_allclose(
            TP.f32(norm.square().sum(0)),
            TP.f32(jnp.square(junroll.act_norm(ref_label))), rtol=2e-2,
            err_msg=port_label)
        assert calib.counts[f"dec[0].e0.{port_label}"] \
            == junroll.counts[ref_label]


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_every_packed_weight_has_a_norm(arch):
    """After a calibration forward, every packed weight's path has a norm
    of its input width, one row per layer of a stacked weight, and Wanda
    selects other positions than |W| does."""
    cfg = get_config(arch, smoke=True)
    if cfg.mla:
        cfg = dataclasses.replace(cfg, n_layers=2, first_dense_layers=2,
                                  qk_rope_dim=32)
    cass = fmt.CassandraConfig(variant=1, gamma=3)
    plain = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    calib = packing.Calibrator()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.inference_mode():
        M.forward_train(Runtime(cfg=cfg, collector=calib), plain,
                        {"tokens": tokens})
    packed = packing.format_params(plain, cass, calib=calib)
    paths = packing.packed_paths(packed)
    assert "lm_head" in paths and len(paths) > 1
    for path in paths:
        node = packed
        for part in path.replace("[", ".").replace("]", "").split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        spec = node["w"]["spec"]
        norm = calib.act_norm(path)
        assert norm is not None, path
        assert norm.shape[:-1] == spec["bitmap"].shape[:-3], path
        n_in = spec["bitmap"].shape[-2] * spec["bitmap"].shape[-1] * 32
        assert norm.shape[-1] == n_in, path
    mag = packing.format_params(plain, cass)
    assert not torch.equal(packed["lm_head"]["w"]["spec"]["bitmap"],
                           mag["lm_head"]["w"]["spec"]["bitmap"])


@pytest.mark.parametrize("variant", [1, 2])
def test_format_params_with_reference_norms_bitwise(smoke, variant):
    """The reference's own calibrator, its norms set at every packed
    weight's path (and one at a wrong width, which both ignore), fed to
    both ``format_params``: every leaf bit for bit, and the calibrated
    format differs from the magnitude one."""
    jcass = jfmt.CassandraConfig(variant=variant)
    cass = fmt.CassandraConfig(variant=variant)
    jplain = smoke["jplain"]
    paths = packing.packed_paths(packing.format_params(smoke["plain"], cass))
    rng = np.random.default_rng(4 + variant)
    jcal, pcal = jpack.Calibrator(), packing.Calibrator()
    for i, path in enumerate(paths):
        node = jplain
        for part in path.replace("[", ".").replace("]", "").split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        shape = node["w"].shape[:-1]
        if i == 1:
            shape = shape[:-1] + (shape[-1] // 2,)      # a wrong width
        sq = rng.uniform(0.01, 9.0, shape).astype(np.float32)
        jcal.sq_sums[path] = jnp.asarray(sq)
        pcal.sq_sums[path] = torch.from_numpy(sq)
    jpacked = jpack.format_params(jplain, jcass, calib=jcal)
    packed = packing.format_params(smoke["plain"], cass, calib=pcal)
    TP.assert_bitwise(_strip(packed), jpacked)
    plain_fmt = jpack.format_params(jplain, jcass)
    same = [np.array_equal(TP.bits(a), TP.bits(b)) for a, b in zip(
        jax.tree.leaves(jpacked), jax.tree.leaves(plain_fmt))]
    assert not all(same)


@pytest.mark.parametrize("variant", [1, 2])
def test_format_weight_calibrated_matches_reference(variant):
    rng = np.random.default_rng(10 + variant)
    w = TP.outlier_bf16_np(rng, (1024, 96))
    an = rng.uniform(0.05, 4.0, 1024).astype(np.float32)
    jcass = jfmt.CassandraConfig(variant=variant)
    cass = fmt.CassandraConfig(variant=variant)
    ref = jfmt.format_weight(jnp.asarray(w), jnp.asarray(an), jcass)
    out = fmt.format_weight(TP.to_port(w), TP.to_port(an), cass)
    TP.assert_bitwise(out, ref)
    mag = fmt.format_weight(TP.to_port(w), None, cass)
    assert not torch.equal(out[0]["bitmap"], mag[0]["bitmap"])


def test_serve_cli_calibrate_greedy_attn_chunks(monkeypatch, tmp_path):
    """``--calibrate``, ``--greedy`` and ``--attn-chunk-q/-k`` on the CPU,
    through the Engine (with ``--metrics-out`` / ``--trace-out``) and the
    scheduler; the chunks reach the Runtime."""
    seen = []
    engine_cls, sched_cls = serve.Engine, serve.Scheduler

    def engine(*a, **kw):
        eng = engine_cls(*a, **kw)
        seen.append(eng.rt)
        return eng

    def scheduler(*a, **kw):
        sched = sched_cls(*a, **kw)
        seen.append(sched.rt)
        return sched

    monkeypatch.setattr(serve, "Engine", engine)
    monkeypatch.setattr(serve, "Scheduler", scheduler)
    common = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
              "--calibrate", "--greedy", "--attn-chunk-q", "8",
              "--attn-chunk-k", "16", "--requests", "2", "--prompt-len",
              "8", "--max-new", "5"]
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.run(common + ["--metrics-out", str(metrics),
                            "--trace-out", str(trace)])
        serve.run(common + ["--scheduler", "--paged", "--block-size", "4",
                            "--chunk-size", "8"])
    text = out.getvalue()
    assert "[format] spec=" in text and "[serve] 2 reqs" in text
    assert "[sched:fused] 2 reqs" in text
    assert [(rt.attn_chunk_q, rt.attn_chunk_k) for rt in seen] \
        == [(8, 16), (8, 16)]
    assert '"name": "cycles"' in metrics.read_text()
    assert '"cycle"' in trace.read_text()
