#!/usr/bin/env python3
"""What a weight's FSDP gather holds on the card against StepCost's count
of the same ops on meta: the check behind launch/stepcost.py's rule for
``_c10d_functional._wrap_tensor_autograd``.

    python3 scripts/torch_gather_peak_card.py

Under a fake process group of 256 on the (16, 16) mesh, xlstm-350m's
output head (50304 x 1024 fp32) placed as (vocab over ``model``, d over
``data``), gathered over ``data`` along dim 1 (a gather, then a
concatenation) and, placed the other way, along dim 0, then used once.
For each, StepCost's peak on meta and on the card's tensors, and the
card's own peak (``max_memory_allocated`` above what was allocated
before), beside the card's name and power limit. Exits 2 without a CUDA
device, 1 if a peak on meta differs from the card's.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.launch.stepcost import StepCost
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    P = shd.PartitionSpec
    ok = True
    with fake_group(256):
        for name, spec in (("dim 1", P("model", "data")),
                           ("dim 0", P("data", "model"))):
            peaks = {}
            for dev in ("meta", "cuda"):
                mesh = make_test_mesh((16, 16), device=dev)
                t = shd.distribute(torch.zeros(50304, 1024, device=dev),
                                   shd.NamedSharding(mesh, spec))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                with StepCost() as sc:
                    y = shd.gather_fsdp(t).to_local() * 1.0
                peaks[dev] = sc.peak
                if dev == "cuda":
                    torch.cuda.synchronize()
                    peaks["card"] = torch.cuda.max_memory_allocated() - base
                del t, y
            print(f"{card}: the gather along {name} and one use: StepCost "
                  f"on meta {peaks['meta']:,} B, on the card's tensors "
                  f"{peaks['cuda']:,} B, the card's peak {peaks['card']:,} B",
                  flush=True)
            ok &= peaks["meta"] == peaks["card"]
    print("ok" if ok else "FAILED: a peak on meta differs from the card's")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
