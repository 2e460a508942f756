"""Port vs reference: checkpoints and the fault-tolerant training launcher on
the CPU.

The reference's checkpoint tests (roundtrip, partial writes, corruption,
elastic resharding, the manager's resume and garbage collection, async
saves) run against the port; checkpoints of parameters and optimizer
state (fp32 and int8 moments) cross between the two packages in both
directions bit for bit (the on-disk format is the reference's: bf16 as a
byte view, keystr paths, sha256 hashes); the launcher resumes after an
injected failure to the parameters of an uninterrupted run, bit for bit;
the straggler watchdog's four reference cases.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_parity as TP
from repro.checkpoint import manager as JCK
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.training import optim as JO
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.launch import train
from repro_torch.training import optim as O

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The SMOKE ops are tiny: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn((8, 16), generator=gen),
                      "b": torch.zeros((16,), dtype=torch.bfloat16)},
            "step_count": torch.tensor(7, dtype=torch.int32),
            "stacked": torch.randn((4, 8, 8), generator=gen).to(
                torch.bfloat16)}


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
        y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(O.tree_leaves(a), O.tree_leaves(b)))


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 10, tree)
    back = restore_checkpoint(str(tmp_path), 10, tree)
    assert _same(tree, back)


def test_partial_write_skipped(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 10, tree)
    bad = tmp_path / "step-00000020"            # a manifest, no shard
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps(
        {"step": 20, "n_hosts": 1, "leaves": {}}))
    assert latest_step(str(tmp_path)) == 10
    (bad / "manifest.json").write_text("{corrupt")
    assert latest_step(str(tmp_path)) == 10


def test_corruption_detected(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 5, tree)
    shard = os.path.join(path, "shard-0.npz")
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(data))
    with pytest.raises(Exception):
        restore_checkpoint(str(tmp_path), 5, tree)


def test_elastic_reshard(tmp_path):
    """Written from 2 hosts, restored on 1 (manifest-driven)."""
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree, host_id=0, n_hosts=2)
    save_checkpoint(str(tmp_path), 3, tree, host_id=1, n_hosts=2)
    back = restore_checkpoint(str(tmp_path), 3, tree, verify_hash=False)
    assert _same(tree, back)
    # and the reference reads the same two shards
    like = {"layer": {"w": 0, "b": 0}, "step_count": 0, "stacked": 0}
    jback = JCK.restore_checkpoint(str(tmp_path), 3, like,
                                   verify_hash=False)
    TP.assert_bitwise(back, jback)


def test_manager_resume_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2)
    tree = _tree()
    for step in range(1, 9):
        tree = {k: v for k, v in tree.items()}
        tree["layer"] = {k: v + 1 for k, v in tree["layer"].items()}
        tree["stacked"] = tree["stacked"] + 1
        mgr.maybe_save(step, tree)
    mgr.wait()
    step, restored = mgr.resume(_tree())
    assert step == 8
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step-"))
    assert len(steps) == 2           # gc keeps the last 2
    assert _same(restored, tree)


def test_async_save_snapshots_before_returning(tmp_path):
    """The async save copies every leaf before ``maybe_save`` returns, so
    writing the tree in place after it (as the next step does) leaves the
    checkpoint as it was; CPU leaves are copied too."""
    mgr = CheckpointManager(str(tmp_path), save_every=1, async_save=True)
    tree = _tree()
    want = TP.clone_tree(tree)
    mgr.maybe_save(1, tree)
    for leaf in O.tree_leaves(tree):
        leaf.add_(1)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1
    assert _same(restore_checkpoint(str(tmp_path), 1, _tree()), want)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's SMOKE Llama parameters with fp32 and int8 optimizer
    states after one update (non-zero moments)."""
    cfg = jax_get_config("llama3-8b", smoke=True)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda p: p * 0.01, params)
    out = {}
    for st in ("fp32", "int8"):
        ocfg = JO.OptConfig(state_dtype=st)
        p, s, _ = JO.apply_updates(params, grads,
                                   JO.init_opt_state(params, ocfg), ocfg)
        out[st] = jax.device_get((p, s))
    return out


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_port_checkpoint_restores_in_reference(tmp_path, ref_state,
                                               state_dtype):
    """Params + opt state written by the port restore through the
    reference's ``restore_checkpoint`` into its tree, bit for bit (bf16
    leaves, int8 codes, f32 scales, the int32 step)."""
    ref = ref_state[state_dtype]
    save_checkpoint(str(tmp_path), 4, TP.to_port(ref))
    assert JCK.latest_step(str(tmp_path)) == 4
    back = JCK.restore_checkpoint(str(tmp_path), 4, ref)
    TP.assert_bitwise(TP.to_port(back), ref)
    manifest = json.load(open(tmp_path / "step-00000004" / "manifest.json"))
    path = "[0]['dec'][0]['e0']['attn']['wq']['w']"
    assert manifest["leaves"][path]["dtype"] == "bfloat16"


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_reference_checkpoint_restores_in_port(tmp_path, ref_state,
                                               state_dtype):
    """And the other way: the reference writes, the port restores (no
    ml_dtypes: bf16 through its byte view), bit for bit, each leaf on the
    device of the tree it is restored like."""
    ref = ref_state[state_dtype]
    JCK.save_checkpoint(str(tmp_path), 9, ref)
    like = TP.to_port(ref)
    back = restore_checkpoint(str(tmp_path), 9, like)
    TP.assert_bitwise(back, ref)
    assert back[0]["embed"]["table"].dtype == torch.bfloat16
    assert back[1]["step"].dtype == torch.int32


def test_train_resumes_after_injected_failure(tmp_path, capsys):
    """``launch/train.run`` on the CPU: a failure injected at step 6
    restores step 4's checkpoint, replays the data from there and ends
    with the uninterrupted run's parameters and moments, bit for bit."""
    args = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps",
            "12", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
            "--lr", "1e-3"]
    p_fail, o_fail = train.run(args + ["--fail-at-step", "6", "--ckpt-dir",
                                       str(tmp_path / "fail")])
    out = capsys.readouterr().out
    assert "[failure] step 6" in out and "done." in out
    p_ok, o_ok = train.run(args + ["--ckpt-dir", str(tmp_path / "ok")])
    assert _same(p_fail, p_ok) and _same(o_fail, o_ok)
    assert o_ok["step"].item() == 12
    assert latest_step(str(tmp_path / "fail")) == 12
    # a restart resumes from the last checkpoint and has nothing left to do
    p_again, _ = train.run(args + ["--ckpt-dir", str(tmp_path / "ok")])
    assert "[resume] from step 12" in capsys.readouterr().out
    assert _same(p_again, p_ok)


def test_train_failure_before_the_first_save_restores_the_initial_state(
        tmp_path, capsys):
    """A failure injected at step 2, before the first periodic save (every
    4 steps), restores the step-0 checkpoint the run saved of its initial
    state: no step is applied twice, and the run ends with the
    uninterrupted run's parameters and moments bit for bit."""
    args = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps",
            "6", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
            "--lr", "1e-3"]
    p_fail, o_fail = train.run(args + ["--fail-at-step", "2", "--ckpt-dir",
                                       str(tmp_path / "fail")])
    assert "[failure] step 2" in capsys.readouterr().out
    p_ok, o_ok = train.run(args + ["--ckpt-dir", str(tmp_path / "ok")])
    assert o_fail["step"].item() == o_ok["step"].item() == 6
    assert _same(p_fail, p_ok) and _same(o_fail, o_ok)


def test_train_default_checkpoint_dir_is_per_arch_under_tmpdir(
        tmp_path, monkeypatch, capsys):
    """Without ``--ckpt-dir`` the checkpoints go to
    ``<TMPDIR>/repro_torch_ckpt/<arch>-smoke``: a second run of the same
    architecture resumes there, another architecture does not."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2"]
    train.run(["--arch", "llama3-8b"] + args)
    assert latest_step(str(tmp_path / "repro_torch_ckpt" /
                           "llama3-8b-smoke")) == 2
    train.run(["--arch", "qwen3-4b"] + args)
    assert "[resume]" not in capsys.readouterr().out
    train.run(["--arch", "llama3-8b"] + args)
    assert "[resume] from step 2" in capsys.readouterr().out


def test_train_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        train.run(["--arch", "llama3-8b", "--smoke", "--steps", "1"])


class TestWatchdog:
    def test_steady_state_ok(self):
        w = train.StragglerWatchdog()
        assert all(w.observe(0.1) == "ok" for _ in range(20))

    def test_single_blip_tolerated(self):
        w = train.StragglerWatchdog(patience=3)
        for _ in range(5):
            w.observe(0.1)
        assert w.observe(0.5) == "slow"
        assert w.observe(0.1) == "ok"        # strike reset

    def test_persistent_straggler_flagged(self):
        w = train.StragglerWatchdog(patience=3, alpha=0.01)
        for _ in range(5):
            w.observe(0.1)
        verdicts = [w.observe(0.6) for _ in range(3)]
        assert verdicts[-1] == "straggler"

    def test_gradual_slowdown_adapts(self):
        """EWMA tracks a slow drift without false straggler alarms."""
        w = train.StragglerWatchdog(patience=3, alpha=0.3)
        t = 0.1
        verdicts = []
        for _ in range(30):
            t *= 1.05
            verdicts.append(w.observe(t))
        assert "straggler" not in verdicts
