#!/usr/bin/env python3
"""K5 (the pre-dump classifier's digest-only sweep) as committed, against a
parent's K5, on the card.

    python3 scripts/torch_k5_variants.py [--parent FILE.cu] [--out FILE]
                                         [--batch N]

Builds src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu ("committed")
and, with --parent, another ckpt_codec.cu ("parent", e.g. `git show
<commit>:src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu >
build/parent_k5.cu`) into build/k5_variants/, one nvcc each, at once. A
source that exports ``ckpt_digest_leaves`` (the grouped kernel) is called
once per list of leaves through the wrapper's own planning and launch
code; one that exports only ``ckpt_digest_blocks`` once per leaf through
a copy of its own wrapper, the lanes joined as its classifier joined
them. For each variant it prints:

  - ptxas's registers and spill bytes of its K5 kernels;
  - from ``cuobjdump -sass``, the main loop of each dtype: the elements a
    thread digests per trip, the instructions of the trip by pipe, and the
    integer-issue bound those give (``chip_smoke.int_issue_ms``);
  - its lanes bitwise against the plain version (ref.py) on edge cases,
    the embedding and the bf16 leaf, and against the other variant at
    every shape;
  - for the grouped kernel, the host's time for each step of a call (one
    bf16 leaf; 42 small leaves) and its entry point's and whole call's
    time back to back;
  - times in turns (parent, committed, committed, parent), one call at a
    time (CUDA events around one Python call, the host's work included)
    and back to back (--batch calls between two events), then the host's
    time to enqueue one call and K5's kernel time under torch.profiler,
    at four shapes: qwen3-8b's fp32 embedding (2.49 GB), the pre-copy
    path's bf16 KV-cache leaf 4 x 4 x 2081 x 8 x 128 (68.2 MB), the
    pre-copy path's 16 classified leaves (4 layers, 8.21 GB) and the
    lifecycle path's train state at 1 layer (42 fp32 leaves, 17.26 GB),
    beside the bytes bound (3.35 TB/s) and the integer-issue bound (the
    card's SM count and maximum SM clock from torch and nvidia-smi).
Needs one CUDA device (~30 GB of it); ~1 min.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu"
PER_LEAF = "ckpt_digest_blocks"
GROUPED = "ckpt_digest_leaves"
# the parent's per-leaf entry: (x, w, out, n, nblk, blk, bf16, stream)
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PER_LEAF_SIG = [_P, _P, _P, _LL, _LL, _I, _I, _P]


def shapes(torch):
    """[(label, [(shape, dtype)])] of the timed cases."""
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import flatten_with_paths
    from repro_torch.models.model import LM
    from repro_torch.training import abstract_train_state

    def state(layers):
        lm = LM(CONFIG.replace(num_layers=layers))
        return flatten_with_paths(abstract_train_state(lm))
    kv = ((4, 4, 2081, 8, 128), torch.bfloat16)
    precopy = [(tuple(t.shape), t.dtype) for p, t in state(4)
               if p.startswith("params/")] + [kv, kv]
    train = [(tuple(t.shape), t.dtype) for _, t in state(1)
             if t.dtype == torch.float32]
    return [("embedding 152064x4096 fp32",
             [((152064, 4096), torch.float32)]),
            ("KV-cache leaf 4x4x2081x8x128 bf16", [kv]),
            (f"pre-copy tree, {len(precopy)} leaves", precopy),
            (f"lifecycle train state, {len(train)} fp32 leaves", train)]


def enter_device(torch, dev):
    with torch.cuda.device(dev):
        pass


def host_breakdown(torch, ckpt_codec, lib, w, randn, B, n=200):
    """The host's time (median us of n calls) for each step of one grouped
    call through the wrapper, on one bf16 leaf and on 42 small leaves, and
    the entry point's and the whole call's time back to back."""
    import statistics
    import time

    from repro_torch.kernels._build import stream_of

    def us(fn):
        fn()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        return statistics.median(ts)
    dev = w.device
    for label, leaves in (
            ("1 bf16 leaf", [randn((4 * 4 * 2081 * 8 * 128,),
                                   torch.bfloat16)]),
            ("42 fp32 leaves of 4096", [randn((4096,), torch.float32)
                                        for _ in range(42)])):
        plan = ckpt_codec.plan_digest(leaves, B)
        rows = ckpt_codec.leaf_rows(plan)
        out = torch.empty((4, plan.total), dtype=torch.int32, device=dev)
        st = torch.cuda.current_stream(dev).cuda_stream
        parts = {
            "plan_digest": lambda: ckpt_codec.plan_digest(leaves, B),
            "leaf_rows": lambda: ckpt_codec.leaf_rows(plan),
            "torch.empty": lambda: torch.empty((4, plan.total),
                                               dtype=torch.int32, device=dev),
            "with torch.cuda.device": lambda: enter_device(torch, dev),
            "stream_of": lambda: stream_of(out),
            "rows.ctypes.data": lambda: rows.ctypes.data,
            "entry point (memset + launch)": lambda: lib.call(
                GROUPED, rows.ctypes.data, len(rows), None, w.data_ptr(),
                out.data_ptr(), plan.total, B, st),
            "whole call": lambda: ckpt_codec._digest_many_cuda(
                ckpt_codec.plan_digest(leaves, B), w, lib),
        }
        print(f"host us a call, {label}: " + ", ".join(
            f"{k} {us(f):.1f}" for k, f in parts.items()), flush=True)
        import chip_smoke as cs
        print(f"back to back (CUDA events, 20 calls a timing), {label}: " +
              ", ".join(f"{k} {cs.cuda_ms(torch, parts[k], iters=5, batch=20) * 1e3:.1f} us"
                        for k in ("entry point (memset + launch)",
                                  "whole call")), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_k5_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels._build import BUILD_ROOT, Library, build_all
    from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref

    print(cs.smi_line(), flush=True)
    clocks = cs.card_clocks()
    print(f"card: {torch.cuda.get_device_name(0)}, {clocks['sms']} SMs, "
          f"max SM clock {clocks['max_sm_mhz']:.0f} MHz", flush=True)
    vdir = BUILD_ROOT / "k5_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    texts = {"committed": SRC.read_text()}
    if args.parent:
        texts["parent"] = Path(args.parent).read_text()
    libs, style = {}, {}
    for name, text in texts.items():
        path = vdir / f"{name}.cu"
        path.write_text(text)
        style[name] = GROUPED if GROUPED in text else PER_LEAF
        sigs = {style[name]: (PER_LEAF_SIG if style[name] == PER_LEAF
                              else ckpt_codec.LIB.sigs[GROUPED])}
        libs[name] = Library(f"k5_{name}", path, sigs,
                             ckpt_codec.LIB.error_fn)
    sos = dict(zip(libs, build_all(libs.values())))
    record = {"card": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
              **clocks, "variants": {}}
    for name, lib in libs.items():
        lib.load()
        ptxas = [ln for ln in lib.build_log.splitlines()
                 if "digest" in ln or "Used" in ln or "spill" in ln]
        loops = cs.k5_loops(str(sos[name]), "digest")
        record["variants"][name] = {"style": style[name], "loops": loops,
                                    "ptxas": ptxas}
        for ln in ptxas:
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print(f"{name}: ptxas: {ln.strip()}", flush=True)
        for k, lp in loops.items():
            per = {c: round(n / lp["elements"], 3)
                   for c, n in sorted(lp["counts"].items())}
            print(f"{name}: {k} main loop ({lp['function']} "
                  f"{lp['start']:#x}-{lp['end']:#x}): {lp['elements']} "
                  f"elements a thread a trip, {lp['bytes_per_element']:g} B "
                  f"of data an element, {lp['instructions']} instructions a "
                  f"trip ({lp['instructions'] / lp['elements']:.3f} an "
                  f"element), by pipe {lp['counts']}, an element {per}",
                  flush=True)

    dev = torch.device("cuda", 0)
    B = ops.BLOCK
    w = ops.digest_weights(B, dev)

    def per_leaf_call(lib, x):
        """The parent's wrapper (ckpt_codec.digest_blocks before the
        grouped kernel), step for step."""
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(x.dtype)
        n = x.numel()
        nblk = max(1, -(-n // B))
        ckpt_codec._blk_ok(nblk, B)
        ckpt_codec._check(x, "x", x.dtype, (n,))
        ckpt_codec._check(w, "weights", torch.int32, (2, B))
        with torch.cuda.device(x.device):
            out = torch.empty((4, nblk), dtype=torch.int32, device=x.device)
            lib.call(PER_LEAF, x.data_ptr(), w.data_ptr(), out.data_ptr(), n,
                     nblk, B, int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream(x.device).cuda_stream)
        return out

    def run(name, leaves):
        """One classification pass over the list as each version's
        classifier made it: the parent a launch a leaf and the lanes
        joined (core/predump.py's torch.cat), the grouped kernel one
        launch. -> the lanes, [4, total] or a list of [4, nblk]."""
        if style[name] == GROUPED:
            return ckpt_codec._digest_many_cuda(
                ckpt_codec.plan_digest(leaves, B), w, libs[name])
        outs = [per_leaf_call(libs[name], x) for x in leaves]
        if len(outs) > 1:
            torch.cat([o.reshape(-1) for o in outs])
        return outs

    def per_leaf_lanes(name, leaves):
        out = run(name, leaves)
        if style[name] == PER_LEAF:
            return out
        return [out[:, c:c + k]
                for c, k in ckpt_codec.plan_digest(leaves, B).cols]

    def plain(x):
        """The plain version, cs.SLAB blocks at a time (its int64
        temporaries would not fit the card for the embedding at once)."""
        n = x.numel()
        nblk = max(1, -(-n // B))
        xb = F.pad(x.reshape(-1), (0, nblk * B - n)).reshape(nblk, B)
        return torch.cat([torch.stack([*ref.digest_blocks_ref(s, w),
                                       *ref.mixed_lanes_ref(s, w)])
                          for s in xb.split(cs.SLAB)], dim=1)

    def host_and_kernel(fn, n=10):
        """The host's time to enqueue one call (median, the card idle
        before each), and under torch.profiler the device time a call of
        K5's kernels (their sum over the pass; with many launches a call
        the profiler has dropped some, so read it for one-launch calls)."""
        import statistics
        import time

        from torch.profiler import ProfilerActivity, profile
        host = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_us = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            dev_us[e.key] = t
        return {"host_us": statistics.median(host),
                "kernel_us": sum(v for k, v in dev_us.items()
                                 if "digest" in k) / n}

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # bitwise against the plain version: edge cases, then the bf16 leaf
    edge = randn((3 * B + 5,), torch.float32)
    edge[:4] = torch.tensor([-0.0, 1e-40, -1e-45, float("inf")])
    edges = [edge, randn((5,), torch.float32), randn((0,), torch.float32),
             randn((2 * B + 9,), torch.bfloat16), randn((4096,), torch.float32),
             randn((1_000_003,), torch.float32)]
    for name in libs:
        got = per_leaf_lanes(name, edges)
        same = all(torch.equal(g, plain(x)) for g, x in zip(got, edges))
        record["variants"][name]["edges_equal"] = same
        print(f"{name}: edge cases (ragged, n 5, n 0, bf16, one block, "
              f"1000003) bit-identical to the plain version: {same}",
              flush=True)

    if style["committed"] == GROUPED:
        host_breakdown(torch, ckpt_codec, libs["committed"], w, randn, B)
    order = list(libs) + list(libs)[::-1]
    for label, spec in shapes(torch):
        leaves = [randn(s, dt).reshape(-1) for s, dt in spec]
        outs = {name: per_leaf_lanes(name, leaves) for name in libs}
        ref_name = next(iter(libs))
        for name in libs:
            same = all(torch.equal(a, b) for a, b in zip(outs[name],
                                                          outs[ref_name]))
            record["variants"][name].setdefault("equal_to_committed",
                                                {})[label] = same
        if label.startswith("KV-cache") or label.startswith("embedding"):
            want = plain(leaves[0])
            for name in libs:
                same = torch.equal(outs[name][0], want)
                record["variants"][name].setdefault("plain_equal",
                                                    {})[label] = same
                print(f"{name}: {label} bit-identical to the plain version: "
                      f"{same}", flush=True)
        del outs
        nblk = [max(1, -(-x.numel() // B)) for x in leaves]
        nbytes = sum(x.numel() * x.element_size() for x in leaves) \
            + 2 * B * 4 + 16 * sum(nblk)
        bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        ints = {}
        for name in libs:
            loops = record["variants"][name]["loops"]
            ms = 0.0
            for k, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                el = sum(b * B for b, x in zip(nblk, leaves) if x.dtype == dt)
                if el and k in loops:
                    ms += cs.int_issue_ms(el, loops[k], clocks["sms"],
                                          clocks["max_sm_mhz"] * 1e6)
            ints[name] = ms
        times = {}
        for name in order:
            fn = (lambda name=name: run(name, leaves))
            t = times.setdefault(name, {"one_call": [], "back_to_back": []})
            t["one_call"].append(cs.cuda_ms(torch, fn, iters=20, warmup=2))
            t["back_to_back"].append(cs.cuda_ms(torch, fn, iters=5, warmup=2,
                                                batch=args.batch))
        for name in libs:
            times[name].update(host_and_kernel(lambda name=name: run(
                name, leaves)))
        for name, t in times.items():
            record["variants"][name].setdefault("ms", {})[label] = {
                **t, "launches": len(leaves) if style[name] == PER_LEAF else 1,
                "bytes": nbytes, "bytes_ms": bytes_ms,
                "int_ms": ints[name]}
        print(f"{label}: {len(leaves)} leaves, {sum(nblk)} blocks, "
              f"{nbytes / 1e9:.4f} GB; bound by bytes {bytes_ms:.4f} ms, by "
              f"integer issue " + ", ".join(
                  f"{n} {v:.4f} ms" for n, v in ints.items()), flush=True)
        for name, t in times.items():
            print(f"  {name} ({'1' if style[name] == GROUPED else len(leaves)}"
                  f" launch{'es' if style[name] == PER_LEAF and len(leaves) > 1 else ''}"
                  f" a pass): one call " + "/".join(
                      f"{v:.4f}" for v in t["one_call"]) + " ms, back to back "
                  + "/".join(f"{v:.4f}" for v in t["back_to_back"]) + " ms; "
                  f"host {t['host_us']:.1f} us to enqueue a call (the card "
                  f"idle before it); under torch.profiler K5's kernels "
                  f"{t['kernel_us']:.1f} us a call", flush=True)
        del leaves
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
