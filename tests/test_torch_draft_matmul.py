"""Port vs reference, the draft-matmul kernel module.

On the CPU the wrapper runs its plain version, which must be the
reference's ``ops.draft_matmul_rank3_oracle`` math: the operand prep
(``exp3``/``emax``/``book``) bit for bit, the decoded weight bit for bit,
and ``y`` within rtol 1e-5 (the same exact bf16 x bf16 products in f32,
summed in another order). The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as TP
from repro.core.format import CassandraConfig as JCass, format_weight
from repro.kernels import ops as jops
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels import build, draft_matmul as DM
from repro_torch.models import layers as L

# (in, out) shapes: superblocks of 512/256/128 values, a ragged N edge
SHAPES = [(1024, 96), (512, 40), (256, 64), (128, 33)]


def _pair(shape, trunc=4, seed=0):
    rng = np.random.default_rng(seed + shape[0] + shape[1])
    w = TP.rand_bf16_np(rng, shape)
    jc = JCass(variant=1, weight_trunc=trunc)
    jspec, _ = format_weight(jnp.asarray(w), None, jc)
    spec = TP.to_port(jspec)
    x = TP.rand_bf16_np(rng, (5, shape[0]))
    return jc, CassandraConfig(variant=1, weight_trunc=trunc), jspec, spec, x


def _kw(cass, n_in):
    block = cass.weight_block(n_in)
    return dict(block=block, keep=cass.weight_keep(block),
                trunc=cass.weight_trunc, exp_bits=cass.exp_bits)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("trunc", [4, 1])
def test_prepare_operands_bitwise(shape, trunc):
    jc, cass, jspec, spec, _ = _pair(shape, trunc)
    ref = jops.prepare_draft_operands(jspec, jc, shape)
    out = DM.prepare_draft_operands(spec, cass, shape)
    TP.assert_bitwise(out, ref)


def test_prepare_operands_row_chunks(monkeypatch):
    """The exponent decode runs ROW_CHUNK columns at a time: a ragged last
    chunk changes nothing."""
    shape = (512, 40)
    jc, cass, jspec, spec, _ = _pair(shape)
    monkeypatch.setattr(DM, "ROW_CHUNK", 16)
    TP.assert_bitwise(DM.prepare_draft_operands(spec, cass, shape),
                      jops.prepare_draft_operands(jspec, jc, shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_decode_and_product_match_rank3_oracle(shape):
    jc, cass, jspec, spec, x = _pair(shape)
    ops = DM.prepare_draft_operands(spec, cass, shape)
    args = (ops["bitmap"], ops["signmant"], ops["exp3"], ops["emax"],
            ops["book"])
    kw = _kw(cass, shape[0])
    # the oracle's decoded weight, read back exactly through identity rows
    eye = jnp.eye(shape[0], dtype=jnp.bfloat16)
    w_ref = jops.draft_matmul_rank3_oracle(eye, jspec, jc, shape).astype(
        jnp.bfloat16)
    TP.assert_bitwise(DM.draft_weight_plain(*args, **kw), w_ref)
    y = DM.draft_matmul(TP.to_port(x), *args, **kw)       # CPU: plain path
    y_ref = jops.draft_matmul_rank3_oracle(jnp.asarray(x), jspec, jc, shape)
    np.testing.assert_allclose(TP.f32(y), TP.f32(y_ref), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_counting():
    shape = (256, 64)
    _, cass, _, spec, x = _pair(shape)
    ops = DM.prepare_draft_operands(spec, cass, shape)
    args = (ops["bitmap"], ops["signmant"], ops["exp3"], ops["emax"],
            ops["book"])
    before = DM.draft_matmul.launches
    y = DM.draft_matmul(TP.to_port(x), *args, **_kw(cass, shape[0]))
    assert y.dtype == torch.float32 and y.shape == (5, 64)
    assert DM.draft_matmul.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        DM.draft_matmul(TP.to_port(x).to("meta"), *args, **_kw(cass, 256))


def test_packed_matmul_is_the_draft_dense():
    """``layers.dense`` in the draft view goes through ``packed_matmul`` on
    the prepared operands, cast to x's dtype like ``ops.draft_matmul``."""
    shape = (512, 40)
    jc, cass, jspec, spec, x = _pair(shape)
    w = DM.prepare_params({"w": {"spec": spec, "verif": {}}}, cass)["w"]
    assert set(w["kernel"]) == {"exp3", "emax", "book"}
    y = DM.packed_matmul(TP.to_port(x)[None], w, cass)
    assert y.shape == (1, 5, 40) and y.dtype == torch.bfloat16
    y_ref = jops.draft_matmul_rank3_oracle(jnp.asarray(x), jspec, jc, shape)
    TP.assert_bitwise(y[0], y_ref.astype(jnp.bfloat16))
    rt = L.Runtime(cfg=None, cass=cass, view="draft")
    TP.assert_bitwise(L.dense(rt, {"w": w}, TP.to_port(x)), y[0])
    with pytest.raises(ValueError, match="prepared kernel operands"):
        DM.packed_matmul(TP.to_port(x), {"spec": spec, "verif": {}}, cass)


def test_stacked_prepare_params_is_per_layer():
    shape = (256, 48)
    parts = [_pair(shape, seed=s) for s in range(3)]
    cass = parts[0][1]
    stacked = {k: torch.stack([p[3][k] for p in parts]) for k in parts[0][3]}
    w = DM.prepare_params({"w": {"spec": stacked, "verif": {}}}, cass)["w"]
    for r, p in enumerate(parts):
        one = DM.prepare_draft_operands(p[3], cass, shape)
        for k in ("exp3", "emax", "book"):
            TP.assert_bitwise(w["kernel"][k][r], one[k])


def test_build_is_lazy_and_content_addressed():
    """Importing the port never runs nvcc; the library name carries a hash
    of the source and flags, under the ignored build/ directory."""
    assert build.sources() == ["draft_matmul", "paged_gqa"]
    target = build._target("draft_matmul")
    assert target.parent == build.BUILD_DIR
    assert target.parent.parts[-2:] == ("build", "kernels")
    assert target.name.startswith("libdraft_matmul-") and \
        target.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
