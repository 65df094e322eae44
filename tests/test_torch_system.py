"""End-to-end behaviour of the port: the twin of tests/test_system.py (all
3): dump at an arbitrary step, restore, continue, bitwise on the CPU; the
training CLI (``python -m repro_torch.launch.train --device cpu``)
SIGTERMed into a migration dump and exit 85; and a node failure, the
trainer SIGKILLed after its step-8 image and restarted with ``--resume``,
replaying to the uninterrupted run's step-12 loss exactly. Same tiny
arguments, step delay and timeouts as the JAX tests. Plus the
cross-package case: the port's mid-run image restores bit for bit in the
JAX package, whose data iterator resumes from the image's data state to
the port's next batches."""
import json
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import subprocess_env  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import Checkpointer, train_meta  # noqa: E402
from repro_torch.core.dump import flatten_with_paths  # noqa: E402
from repro_torch.data import DataIterator, TokenDataset  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    abstract_train_state, init_train_state, make_train_step)

CPU = "cpu"


def _run_steps(lm, state, it, step_fn, n):
    m = {}
    for _ in range(n):
        batch = {"tokens": torch.from_numpy(it.next()).to(torch.int64)}
        state, m = step_fn(state, batch)
    return state, m


def _interrupted(tmp_path):
    """The tiny qwen3 run of the first test, up to its step-6 image."""
    cfg = configs.get_tiny("qwen3-8b")
    lm = LM(cfg)
    ds = TokenDataset(str(tmp_path / "d"), vocab_size=cfg.vocab_size, seed=1)
    step_fn = make_train_step(lm, OptConfig(warmup_steps=2, total_steps=100))
    s = init_train_state(lm, torch.Generator().manual_seed(0), device=CPU)
    it = DataIterator(ds, global_batch=4, seq_len=32)
    s, _ = _run_steps(lm, s, it, step_fn, 6)
    ck = Checkpointer(str(tmp_path / "ck"), device=CPU)
    ck.save(s, step=6, meta=train_meta(arch=cfg.name, step=6,
                                       data_state=it.state()))
    return cfg, lm, ds, step_fn, ck


def test_dump_restore_bitwise_identical_continuation(tmp_path):
    """Paper row 1 (simple app), strengthened: the restored run must produce
    EXACTLY the same state as the uninterrupted one."""
    cfg, lm, ds, step_fn, ck = _interrupted(tmp_path)

    # uninterrupted: 10 steps
    s_ref = init_train_state(lm, torch.Generator().manual_seed(0),
                             device=CPU)
    it_ref = DataIterator(ds, global_batch=4, seq_len=32)
    s_ref, _ = _run_steps(lm, s_ref, it_ref, step_fn, 10)

    # interrupted at 6 (dumped by _interrupted), restored, continued to 10
    struct = abstract_train_state(lm)
    s2, man = ck.load_latest(target_struct=struct)
    it2 = DataIterator.restore(ds, man["meta"]["data"])
    s2, _ = _run_steps(lm, s2, it2, step_fn, 4)

    for (pa, a), (pb, b) in zip(flatten_with_paths(s_ref),
                                flatten_with_paths(s2)):
        assert pa == pb
        assert torch.equal(a, b), f"continuation diverged at {pa}"


@pytest.mark.parametrize("sig,expect_code", [(signal.SIGTERM, 85)])
def test_preemption_checkpoints_and_exits_85(tmp_path, sig, expect_code):
    """Paper's HTCondor scenario: SIGTERM mid-run -> dump -> exit 85; resume
    completes and matches an uninterrupted run's final loss."""
    env = subprocess_env()
    ck = str(tmp_path / "ck")
    data = str(tmp_path / "data")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            CPU, "--arch", "qwen3-8b", "--tiny", "--steps", "400",
            "--global-batch", "2", "--seq-len", "32", "--ckpt-dir", ck,
            "--ckpt-every", "5", "--log-every", "1", "--data-dir", data]
    proc = subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # wait until it makes progress, then preempt
    t0 = time.time()
    seen = 0
    while time.time() - t0 < 240:
        line = proc.stdout.readline()
        if '"step"' in line:
            seen += 1
        if seen >= 3:
            break
    assert seen >= 3, "trainer never progressed"
    proc.send_signal(sig)
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == expect_code, out[-2000:]
    assert "preemption (" in out          # names the signal that triggered it
    assert "migration image durable" in out

    # image exists and is resumable
    from repro_torch.core import Registry
    latest = Registry(ck).latest()
    assert latest is not None and latest["step"] > 0


def test_sigkill_crash_then_restart_is_deterministic(tmp_path):
    """Node failure: SIGKILL (no chance to checkpoint) -> restart from the
    last periodic image; final metrics equal an uninterrupted run (replay
    determinism)."""
    env = subprocess_env()
    ck = str(tmp_path / "ck")
    data = str(tmp_path / "data")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            CPU, "--arch", "musicgen-large", "--tiny", "--steps", "12",
            "--global-batch", "2", "--seq-len", "32", "--ckpt-every", "4",
            "--log-every", "1", "--data-dir", data]
    slow = ["--step-delay", "0.3"]  # make mid-run SIGKILL deterministic

    # uninterrupted reference
    mref = str(tmp_path / "ref.json")
    subprocess.run(base + ["--metrics-file", mref], env=env, check=True,
                   capture_output=True, timeout=600)
    ref = json.load(open(mref))

    # crash victim: SIGKILL after it writes the step-8 checkpoint
    proc = subprocess.Popen(base + slow + ["--ckpt-dir", ck], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    killed = False
    t0 = time.time()
    while time.time() - t0 < 300:
        line = proc.stdout.readline()
        if '"step": 9' in line:
            proc.kill()
            killed = True
            break
    assert killed, "never reached step 9"
    proc.wait(timeout=60)

    # restart and finish
    mres = str(tmp_path / "res.json")
    subprocess.run(base + ["--ckpt-dir", ck, "--resume", "--metrics-file",
                           mres], env=env, check=True, capture_output=True,
                   timeout=600)
    res = json.load(open(mres))
    final_ref = [r for r in ref if r["step"] == 12][0]
    final_res = [r for r in res if r["step"] == 12][0]
    assert final_ref["loss"] == pytest.approx(final_res["loss"], abs=0.0), \
        "crash-restart continuation diverged"


def test_mid_run_image_and_data_state_resume_in_jax(tmp_path):
    """The port's step-6 image of the first test, read by the JAX package:
    every stored leaf restores byte for byte, and JAX's DataIterator
    restored from the image's data state yields the port's next batches
    (compared exactly)."""
    from repro.core.restore import restore as jrestore
    from repro.data import DataIterator as JIterator
    from repro.data import TokenDataset as JDataset
    from repro_torch.core import restore

    cfg, lm, ds, _, ck = _interrupted(tmp_path)
    root = str(tmp_path / "ck")
    _, man_t, pairs_t = restore(root, device=CPU, with_pairs=True)
    _, man_j, pairs_j = jrestore(root, with_pairs=True)
    assert man_t["digest"] == man_j["digest"]
    assert sorted(pairs_t) == sorted(pairs_j)
    for p in pairs_t:
        a, b = np.asarray(pairs_t[p]), np.asarray(pairs_j[p])
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), p
    jds = JDataset(str(tmp_path / "jd"), vocab_size=cfg.vocab_size, seed=1)
    it_j = JIterator.restore(jds, man_j["meta"]["data"])
    it_t = DataIterator.restore(ds, man_t["meta"]["data"])
    for _ in range(4):
        assert np.array_equal(it_j.next(), it_t.next())
