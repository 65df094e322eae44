#!/usr/bin/env python3
"""The full-width train-state restore onto a mesh, on one card: what it
costs, beside chip_smoke.py's path 14, which restores a serving session
onto a mesh and leaves this out for time.

    python3 scripts/torch_vision_train_restore.py [--seed N] [--dir DIR]
                                                  [--out FILE]

qwen2-vl-72b at full width, 80 -> 1 layer (3,369,099,264 params, 13.48 GB
a tree), its weights from a seeded torch.Generator: one train step through
AdamW on 1 x 512 vision embeddings with labels and M-RoPE streams (the
frontend stub, seeded); the 40.43 GB train state dumped lossless to
file:// under DIR (the temporary directory by default; its free space is
checked first); then restored with
``load_latest(shardings=named(make_test_mesh((1, 1)), train_state_pspecs(
lm, make_rules(cfg, mesh))))`` onto the card beside the live state, and
every leaf compared bitwise. It prints the dump and restore seconds, the
image's bytes, the device peak (two train states) and the host's RSS
peak. Exits 2 without a CUDA device, 1 if a check fails.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default=None, help="where the image goes")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.api import CheckpointSession
    from repro_torch.configs import get_config
    from repro_torch.core import flatten_with_paths
    from repro_torch.distributed.sharding import make_rules, named
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.frontends import synthetic_vision_embeds
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import (init_train_state, make_train_step,
                                      train_state_pspecs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-vl-72b").replace(num_layers=1)
    lm = LM(cfg)
    state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                             device=dev)
    batch = synthetic_vision_embeds(
        cfg, 1, 512, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    state, metrics = make_train_step(lm, OptConfig())(state, batch)
    torch.cuda.synchronize()
    rec = {"card": smi, "params": lm.n_params(), "loss": float(
        metrics["loss"])}
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in flatten_with_paths(state))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peak = {"start": rss_gb(), "peak": rss_gb()}
    done = threading.Event()

    def sample():
        while not done.wait(0.02):
            peak["peak"] = max(peak["peak"], rss_gb())
    threading.Thread(target=sample, daemon=True).start()
    tmp = tempfile.mkdtemp(prefix="vision-train-restore-", dir=args.dir)
    try:
        free = shutil.disk_usage(tmp).free
        if free < 1.1 * nbytes:
            print(f"{tmp}: {free / 1e9:.1f} GB free, the image needs "
                  f"{nbytes / 1e9:.1f} GB", file=sys.stderr)
            return 1
        t0 = time.time()
        saved = CheckpointSession(f"file://{tmp}", device=dev).save(
            state, step=1)
        rec["dump_s"] = time.time() - t0
        rec["image_bytes"] = saved["stats"]["bytes_stored"]
        mesh = make_test_mesh((1, 1), device=dev)
        sps = named(mesh, train_state_pspecs(lm, make_rules(cfg, mesh)))
        t0 = time.time()
        tree, _ = CheckpointSession(f"file://{tmp}", device=dev).load_latest(
            shardings=sps)
        torch.cuda.synchronize()
        rec["restore_s"] = time.time() - t0
        want = dict(flatten_with_paths(state))
        differ = [p for p, t in flatten_with_paths(tree)
                  if t.device != dev or t.dtype != want[p].dtype
                  or not torch.equal(t, want[p])]
        rec.update(leaves=len(want), leaves_differ=differ,
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        done.set()
        shutil.rmtree(tmp, ignore_errors=True)
    rec.update(state_bytes=nbytes, host_rss_start_gb=peak["start"],
               host_rss_peak_gb=peak["peak"])
    print(f"qwen2-vl-72b 1 of 80 layers, {rec['params']:,} params, loss "
          f"{rec['loss']:.4f}: train state {nbytes / 1e9:.2f} GB dumped "
          f"lossless to file:// in {rec['dump_s']:.1f} s "
          f"({rec['image_bytes'] / 1e9:.2f} GB stored), restored onto a "
          f"(1, 1) mesh of the card in {rec['restore_s']:.1f} s: "
          f"{rec['leaves'] - len(differ)} of {rec['leaves']} leaves "
          f"bit-identical; device peak {rec['peak_device_gb']:.1f} GB (two "
          f"train states), host RSS {peak['start']:.1f} -> "
          f"{peak['peak']:.1f} GB", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
