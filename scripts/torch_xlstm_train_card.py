#!/usr/bin/env python3
"""xlstm-350m's train_4k step as rank 0 of the (16, 16) mesh runs it, on
one card, against the dry run's record of the same program: the cell
chip_smoke.py's path 18 (c) runs with its sequence cut for time.

    python3 scripts/torch_xlstm_train_card.py [--seq 4096] [--layers 4]
                                              [--microbatches 4] [--out F]

Under a fake process group of 256 (launch/mesh.fake_group: collectives
move no data), the cell's trees are DTensors whose local shards alone live
on the card (weights drawn at 0.02 from a seeded generator, moments and
step zero, token ids uniform). The step runs once under StepCost (its
FLOPs counted) and once more plain, each timed with the host clock around
a synchronize; the record is traced on meta in a subprocess beside the
card's part (rank 0's program under its own fake group). Checks the
card's FLOPs equal to the record's cost and totals, and the device peak
above what was allocated before the state within 5% of the record's
argument + temp. Prints the seconds of the counted and the plain step and
of the record's trace beside the card's name and power limit. Exits 2
without a CUDA device, 1 if a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm-350m"
PEAK_TOL = 0.05


def shape(seq: int):
    from repro_torch.configs.base import SHAPES, ShapeConfig
    full = SHAPES["train_4k"]
    return full if seq == full.seq_len else \
        ShapeConfig(f"train_{seq}", "train", seq, full.global_batch)


def record(args) -> int:
    """The subprocess: the dry run's record of the cell, as JSON."""
    from repro_torch.launch import dryrun
    t0 = time.time()
    rec = dryrun.run_cell(ARCH, shape(args.seq), num_layers=args.layers,
                          microbatches=args.microbatches, verbose=False)
    rec["record_s"] = time.time() - t0
    with open(args.record, "w") as f:
        json.dump(rec, f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--record", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    if args.record:
        return record(args)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.launch.stepcost import StepCost
    tmp = tempfile.mkdtemp(prefix="xlstm-train-card-")
    path = os.path.join(tmp, "record.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--record", path,
         "--seq", str(args.seq), "--layers", str(args.layers),
         "--microbatches", str(args.microbatches)])
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    out = {"card": card, "seq": args.seq, "layers": args.layers,
           "microbatches": args.microbatches}
    try:
        with fake_group(256):
            mesh = make_test_mesh((16, 16), device=dev)
            cell = dryrun.lower_cell(ARCH, shape(args.seq), mesh,
                                     num_layers=args.layers,
                                     microbatches=args.microbatches)
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            trees = cs._card_trees(torch, cell, dev, gen)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with StepCost() as sc:
                res = cell.run(trees)
            torch.cuda.synchronize()
            out["counted_s"] = time.time() - t0
            out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            out["flops"] = sc.flops
            del res
            t0 = time.time()
            res = cell.run(trees)
            torch.cuda.synchronize()
            out["plain_s"] = time.time() - t0
            del res, trees
        print(f"{card}: {ARCH} train at {args.seq} x 256 rows, "
              f"{args.layers} of 24 layers, {args.microbatches} "
              f"microbatches, rank 0 of 16x16 (a fake group of 256): the "
              f"step {out['plain_s']:.2f} s, {out['counted_s']:.2f} s "
              f"under StepCost; {out['flops']:,} FLOPs; device peak "
              f"{out['peak_bytes']:,} B above what was allocated before "
              f"the state", flush=True)
        proc.wait()
        with open(path) as f:
            rec = json.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    mem, cost = rec["memory_analysis_per_device"], \
        rec["cost_analysis_per_device"]
    planned = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    out.update(record_s=rec["record_s"], plan_flops=cost["flops"],
               totals_flops=rec["totals_per_device"]["flops"],
               planned_bytes=planned,
               miss=planned / out["peak_bytes"] - 1)
    print(f"{card}: the record (traced on meta on this host in "
          f"{rec['record_s']:.1f} s): {cost['flops']:,} FLOPs, totals "
          f"{out['totals_flops']:,.0f}; argument + temp {planned:,} B, "
          f"{100 * out['miss']:+.2f}% of the card's peak", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    ok = (out["flops"] == cost["flops"] == out["totals_flops"]
          and abs(out["miss"]) <= PEAK_TOL)
    print("ok" if ok else "FAILED: FLOPs differ or the peak is off by more "
          f"than {100 * PEAK_TOL:g}%")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
