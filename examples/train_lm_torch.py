"""End-to-end driver through the PyTorch port: train a small LM for a few
hundred steps with the full production lifecycle (checkpoint every N
steps, async writes, preemption handler armed, resumable).

Default is a ~5M-param qwen3-family model, 300 steps — tune --steps to
your patience. This is the same driver the fleet would run
(repro_torch.launch.train); this wrapper just picks small dimensions.
``--device`` is "cuda" by default (it raises without a card), "cpu" when
asked.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "src")))

from repro_torch.launch.train import main as train_main  # noqa: E402

if __name__ == "__main__":
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "repro_torch_train_lm"))
    ap.add_argument("--metrics-file", default=os.path.join(
        tmp, "repro_torch_train_lm_metrics.json"))
    args = ap.parse_args()
    train_main([
        "--arch", "qwen3-8b", "--tiny", "--device", args.device,
        "--layers", "4", "--d-model", "256", "--d-ff", "1024",
        "--vocab", "4096",
        "--steps", str(args.steps),
        "--global-batch", "8", "--seq-len", "128",
        "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50", "--ckpt-async",
        "--log-every", "10",
        "--data-dir", os.path.join(args.ckpt_dir, "data"),
        "--metrics-file", args.metrics_file,
    ])
