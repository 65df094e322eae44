"""The PyTorch port's examples (examples/*_torch.py) end to end on the CPU,
each a subprocess with ``--device cpu``: its exit code and the invariants
it prints. Without a card and without ``--device cpu`` each refuses to
run (the "no CUDA" error) rather than falling back to the CPU."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import subprocess_env  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = ("quickstart_torch.py", "preemption_drill_torch.py",
            "elastic_resize_torch.py", "train_lm_torch.py")


def run_example(name, *args, timeout=600):
    # two CPU threads: the tiny models run faster than on every core, and
    # leave the cores to the suite's other workers
    env = dict(subprocess_env(), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        env=env, capture_output=True, text=True, timeout=timeout)


def ok(out):
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    return out.stdout


def test_quickstart_torch():
    out = ok(run_example("quickstart_torch.py", "--device", "cpu"))
    assert "capabilities: 29/29 supported" in out
    assert "continuation bitwise identical: True" in out
    assert "migrated serving session identical: True" in out
    assert out.rstrip().endswith("quickstart OK")


def test_preemption_drill_torch():
    out = ok(run_example("preemption_drill_torch.py", "--device", "cpu"))
    assert ">>> batch system preempts the job (SIGTERM)" in out
    assert "preemption (SIGTERM) at step" in out
    assert ">>> job exited 85" in out
    assert "resumed from step_" in out and "(migrated: SIGTERM)" in out
    assert "(bitwise)" in out
    assert out.rstrip().endswith("preemption drill OK")


def test_elastic_resize_torch():
    out = ok(run_example("elastic_resize_torch.py", "--device", "cpu"))
    for line in ("restore onto (2 data, 4 model): bit-identical, digest "
                 "verified",
                 "restore onto (8 data, 1 model): bit-identical",
                 "continued on mesh (2 data, 4 model): replay-deterministic",
                 "cross-mesh continuation equals uninterrupted run bitwise",
                 "4-host -> 2-host migration, deterministic DP: "
                 "bit-identical"):
        assert line in out, line
    assert out.rstrip().endswith("elastic resize drill OK")


def test_train_lm_torch(tmp_path):
    out = ok(run_example("train_lm_torch.py", "--device", "cpu", "--steps",
                         "20", "--ckpt-dir", str(tmp_path / "ck"),
                         "--metrics-file", str(tmp_path / "m.json")))
    assert "[train] ckpt plan:" in out
    assert "[train] done at step 20" in out
    assert os.path.exists(tmp_path / "m.json")
    assert os.listdir(tmp_path / "ck" / "images")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_example(name, "--ckpt-dir", str(tmp_path / "ck"),
                      "--metrics-file", str(tmp_path / "m.json")) \
        if name == "train_lm_torch.py" else run_example(name)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "OK" not in out.stdout
