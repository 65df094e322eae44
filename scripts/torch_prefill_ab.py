#!/usr/bin/env python3
"""gemma2-2b's prefill wall time by prompt length through the repro_torch
of two trees, on one card, in turns: A, B, B, A, one fresh process each.

    python3 scripts/torch_prefill_ab.py A_ROOT B_ROOT [--reps 5] [--out FILE]

Each process imports repro_torch from its tree's src/ (its kernels build
into that tree's build/), makes gemma2-2b at full width and depth with
random weights (seed 0), prefills one prompt of each length once to warm
up, then `--reps` rounds over the lengths: LM.prefill into a cache of
4800 positions (the serving plane's page) with bf16 compute, the last
logits copied to the host, the host clock around it with the card
synchronised on both sides, as SessionManager does at admission. It
reports each side's times and K6's launches by route. A_ROOT is e.g. a
`git archive` of the parent commit unpacked under build/.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LENGTHS = (256, 512, 1024, 2048, 4608)


def child(root: str, reps: int) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch.configs.gemma2_2b import CONFIG
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM

    dev = torch.device("cuda", 0)
    lm = LM(CONFIG)
    params = lm.init(torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)

    def prefill(n):
        tokens = torch.from_numpy(rng.integers(0, CONFIG.vocab_size, (1, n))).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = lm.prefill(params, tokens=tokens, S_max=4800,
                               compute_dtype=torch.bfloat16)
        logits[0].cpu()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for n in LENGTHS:
        prefill(n)
    k6.reset_launches()
    out = {str(n): [] for n in LENGTHS}
    for _ in range(reps):
        for n in LENGTHS:
            out[str(n)].append(prefill(n))
    return {"root": root, "k6_routes": dict(k6.ROUTE_LAUNCHES), "s": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", metavar="ROOT", help="A_ROOT B_ROOT")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print("AB " + json.dumps(child(args.child, args.reps)), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give A_ROOT and B_ROOT")
    import torch
    if not torch.cuda.is_available():
        print("torch_prefill_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = {"A": [], "B": []}
    for side in "ABBA":
        root = args.roots[side == "B"]
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--reps", str(args.reps), "--child", root],
                             stdout=subprocess.PIPE, text=True, check=True)
        rec = json.loads(res.stdout.split("AB ", 1)[1])
        runs[side].append(rec)
        print(f"{side} ({root}): K6 {rec['k6_routes']}; " + "; ".join(
            f"{n}: {statistics.median(ts):.4f} s" for n, ts in rec["s"].items()),
            flush=True)
    for n in map(str, LENGTHS):
        a = [t for r in runs["A"] for t in r["s"][n]]
        b = [t for r in runs["B"] for t in r["s"][n]]
        print(f"prefill {n}: A median {statistics.median(a):.4f} s "
              f"({min(a):.4f}-{max(a):.4f}), B median {statistics.median(b):.4f} s "
              f"({min(b):.4f}-{max(b):.4f}); every B below every A: "
              f"{max(b) < min(a)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
