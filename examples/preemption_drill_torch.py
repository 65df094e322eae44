"""Preemption drill through the PyTorch port — the OSPool/HTCondor scenario
from the paper:

1. launch a training job (python -m repro_torch.launch.train)
2. the batch system preempts it (SIGTERM)
3. the job checkpoints at the step boundary and exits 85
4. the scheduler reschedules it "on another node" (--resume)
5. verify the final loss matches a never-preempted run

``--device`` is where the jobs train: "cuda" by default (a job raises
without a card), "cpu" when asked. On the CPU the resumed run's final
loss equals the uninterrupted run's bit for bit. On a card the training
CLI keeps cuBLAS's and the embedding backward's own summation orders, so
the two losses are held to 1e-5 relative (as chip_smoke.py's lifecycle
path holds them).

Run:  PYTHONPATH=src python examples/preemption_drill_torch.py [--device cpu]
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ENV = dict(os.environ)
ENV["PYTHONPATH"] = SRC
ENV["PYTHONUNBUFFERED"] = "1"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)         # no card: raises, never the CPU

    tmp = tempfile.mkdtemp()
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "gemma2-2b", "--tiny", "--device", args.device, "--steps", "30",
            "--global-batch", "2", "--seq-len", "32", "--ckpt-every", "5",
            "--log-every", "1", "--data-dir", f"{tmp}/data"]

    # reference: never preempted
    ref_metrics = f"{tmp}/ref.json"
    subprocess.run(base + ["--metrics-file", ref_metrics], env=ENV,
                   check=True)
    ref = json.load(open(ref_metrics))

    # victim: preempted mid-run
    proc = subprocess.Popen(base + ["--ckpt-dir", f"{tmp}/ck",
                                    "--step-delay", "0.2"],
                            env=ENV, stdout=subprocess.PIPE, text=True)
    while True:
        line = proc.stdout.readline()
        assert line, "the victim exited before step 12"
        print("victim:", line, end="")
        if '"step": 12' in line:
            print(">>> batch system preempts the job (SIGTERM)")
            proc.send_signal(signal.SIGTERM)
            break
    out, _ = proc.communicate(timeout=300)
    print(out)
    assert proc.returncode == 85, f"expected exit 85, got {proc.returncode}"
    print(">>> job exited 85 (HTCondor self-checkpoint convention)")

    # reschedule "on another node"
    res_metrics = f"{tmp}/res.json"
    subprocess.run(base + ["--ckpt-dir", f"{tmp}/ck", "--resume",
                           "--metrics-file", res_metrics], env=ENV,
                   check=True)
    res = json.load(open(res_metrics))
    f_ref = [r for r in ref if r["step"] == 30][0]
    f_res = [r for r in res if r["step"] == 30][0]
    if dev.type == "cpu":
        assert f_ref["loss"] == f_res["loss"], (f_ref, f_res)
        how = "bitwise"
    else:
        assert abs(f_ref["loss"] - f_res["loss"]) <= \
            1e-5 * abs(f_ref["loss"]), (f_ref, f_res)
        how = "within 1e-5 relative"
    print(f">>> resumed run finished with loss {f_res['loss']:.6f} == "
          f"uninterrupted {f_ref['loss']:.6f} ({how})")
    print("preemption drill OK")


if __name__ == "__main__":
    main()
