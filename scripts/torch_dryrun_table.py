"""Markdown table of the port's dry-run records (one row per arch, one
column per shape): per-device bytes on the (16, 16) and (2, 16, 16) mesh
records, and the counted FLOPs and bytes accessed of one step, or the
guard's skip.

Run after the sweep:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    python scripts/torch_dryrun_table.py [experiments/dryrun_torch]
"""
import json
import os
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def main(root="experiments/dryrun_torch"):
    recs = {}
    for fn in sorted(os.listdir(root)):
        with open(os.path.join(root, fn)) as f:
            r = json.load(f)
        recs[r["arch"], r["shape"], r["mesh"]["n_devices"]] = r
    archs = list(dict.fromkeys(a for a, _, _ in recs))
    print("| arch | n_params | " + " | ".join(SHAPES) + " |")
    print("|---|---|" + "---|" * len(SHAPES))
    for arch in archs:
        cells = []
        for shape in SHAPES:
            one, two = recs.get((arch, shape, 256)), recs.get((arch, shape,
                                                              512))
            if one is None:
                cells.append("—")
                continue
            gb = (f"{one['bytes_per_device']['total'] / 1e9:.3f} / "
                  f"{two['bytes_per_device']['total'] / 1e9:.3f} GB")
            tot = one.get("totals_per_device", {})
            what = (f"{tot['step_flops']:.3e} FLOPs, "
                    f"{tot['step_bytes']:.3e} B" if "step_flops" in tot
                    else tot.get("skipped", tot.get("error", "not measured")))
            cells.append(f"{gb}; {what}")
        n = next(r for k, r in recs.items() if k[0] == arch)
        print(f"| {arch} | {n['analytic']['n_params']:,} | "
              + " | ".join(cells) + " |")


if __name__ == "__main__":
    main(*sys.argv[1:])
