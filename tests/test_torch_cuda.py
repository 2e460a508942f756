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
