#!/usr/bin/env python3
"""K6's design choices at head dim 256, each timed on the card against the
kernel as committed.

    python3 scripts/torch_k6_variants.py [--parent FILE.cu] [--out FILE]

Each variant is the committed src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu with one choice undone (one textual change), built by
nvcc into build/k6_variants/ (one process per variant, all at once):

  committed      the source as it is
  warp_producer  a producer warp, 288 threads, no setmaxnreg at 256
  pv_2x128       P V at 256 as two wgmma.m64n128k16 over V's column halves
  precise_cap    the softcap through __fdiv_rn and tanhf
  tanh_approx    the softcap through tanh.approx.f32
  inline_tests   the edge and cap tests inside the unrolled scoring loop
  parent         --parent FILE.cu, whose bf16 at 256 runs the SIMT route
                 (e.g. `git show f78dea1:<the .cu> > build/parent_k6.cu`)

For each: ptxas's registers and spill bytes of flash_fwd_wgmma<256>, the
largest error over the attention-weighted |v| at gemma2-2b's shapes
(tolerance 2e-2, element-wise) and bit identity on repeat, then the
device time of back-to-back calls (1 x S, 8/4 heads x 256, softcap 50) at
S = 4608 with window 4096 (even layers) and 0 (odd), at S = 2048, and at
4608 without the cap, variants in turns (forward, then backward), beside
the live-pair bound.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"

FAST_CAP = "x = __fmaf_rn(rcp_approx(ex2(x * cap_e) + 1.0f), cap_m2, cap_l);"
HOISTED = """    auto scores = [&](auto with_edge, auto with_cap) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = sacc[i];
        if constexpr (decltype(with_cap)::value) {  // softcap * tanh(s / softcap)
          x = __fmaf_rn(rcp_approx(ex2(x * cap_e) + 1.0f), cap_m2, cap_l);
        } else {
          x *= scale_log2;
        }
        if constexpr (decltype(with_edge)::value) {"""
INLINE = """    auto scores = [&](auto, auto) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = sacc[i];
        if (softcap != 0.0f) {
          x = __fmaf_rn(rcp_approx(ex2(x * cap_e) + 1.0f), cap_m2, cap_l);
        } else {
          x *= scale_log2;
        }
        if (edge) {"""
DISPATCH = """    using Y = std::true_type;
    using N = std::false_type;
    if (softcap != 0.0f) {
      if (edge) scores(Y{}, Y{}); else scores(N{}, Y{});
    } else {
      if (edge) scores(Y{}, N{}); else scores(N{}, N{});
    }
"""
PV_DECL = "template <int HD>\nstruct PV;"


def _n128_at() -> str:
    """wgmma.m64n128k16 into d[OFF:OFF+64] of a 128-register accumulator."""
    ops = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[OFF + {i}])' for i in range(64))
    return (
        "template <int OFF>\n__device__ __forceinline__ void wgmma_rs_n128_at("
        "float (&d)[128], const uint32_t (&a)[4], uint64_t db) {\n"
        '  asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 '
        f'{{{ops}}}, {{%64, %65, %66, %67}}, %68, 1, 1, 1, 1;\\n"\n'
        f'      : {outs}\n'
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));\n}\n\n')


TANH = ("__device__ __forceinline__ float tanh_approx(float x) {\n  float y;\n"
        '  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;\n}\n\n')

VARIANTS = {  # name -> [(old, new), ...] applied to the committed source
    "committed": [],
    "warp_producer": [("static constexpr int NPROD = HD == 256 ? 128 : 32;",
                       "static constexpr int NPROD = 32;")],
    "pv_2x128": [
        ("    wgmma_rs_n256(d, a, db);\n",
         "    wgmma_rs_n128_at<0>(d, a, db);\n"
         "    wgmma_rs_n128_at<64>(d, a, db + ((2 * BK * BOX * 2) >> 4));\n"),
        (PV_DECL, _n128_at() + PV_DECL)],
    "precise_cap": [(FAST_CAP, "x = __fmul_rn(tanhf(__fdiv_rn(__fmul_rn(x, scale), "
                               "softcap)), softcap) * kLog2e;")],
    "tanh_approx": [(FAST_CAP, "x = tanh_approx(x * (0.5f * cap_e / kLog2e)) * cap_l;"),
                    (PV_DECL, TANH + PV_DECL)],
    "inline_tests": [(HOISTED, INLINE), (DISPATCH, "    scores(0, 0);\n")],
}

CASES = [  # label, B, S, window, softcap, qk
    ("1x4608 window 4096 softcap 50", 1, 4608, 4096, 50.0, 4.0),
    ("1x4608 global softcap 50", 1, 4608, 0, 50.0, 4.0),
    ("1x512 window 128 softcap 50", 1, 512, 128, 50.0, 4.0),
    ("2x1000 global", 2, 1000, 0, 0.0, 1.0),
]
TIMED = [(4608, 4096, 50.0), (4608, 0, 50.0), (2048, 4096, 50.0),
         (4608, 4096, 0.0)]  # S, window, softcap


def variant_sources(parent: str | None) -> dict:
    src = SRC.read_text()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the committed source does not hold "
                                 f"exactly one {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    if parent:
        out["parent"] = Path(parent).read_text()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_k6_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels._build import BUILD_ROOT, Library, build_all
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.kernels.flash_attention.ref import reference_attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    vdir = BUILD_ROOT / "k6_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in variant_sources(args.parent).items():
        path = vdir / f"{name}.cu"
        path.write_text(text)
        libs[name] = Library(f"k6_{name}", path, k6.LIB.sigs, k6.LIB.error_fn)
    build_all(libs.values())
    record = {"card": torch.cuda.get_device_name(0), "variants": {}}
    for name, lib in libs.items():
        lib.load()
        regs = [ln for ln in lib.ptxas_lines() if "Used" in ln]
        spills = {k.split("flash_fwd_wgmma")[1][:6]: v
                  for k, v in cs.wgmma_spills(lib.build_log).items()}
        record["variants"][name] = {"spills": spills}
        print(f"{name}: wgmma spill bytes (stores, loads) {spills}; first "
              f"ptxas line {regs[0] if regs else None}", flush=True)

    def fwd(name, q, k, v, window, cap):
        B, S, H, hd = q.shape
        KV = k.shape[2]
        out = torch.empty_like(q)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        st = torch.cuda.current_stream().cuda_stream
        if name == "parent":       # bf16 at 256 ran the SIMT route there
            libs[name].call("flash_attention_fwd_simt", *ptrs, B, S, S, H, KV, hd, 1,
                            1, window, cap, hd ** -0.5, st)
        else:
            libs[name].call("flash_attention_fwd_wgmma", *ptrs, B, S, S, H, KV, hd, 1,
                            window, cap, hd ** -0.5, st)
        return out

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, qk):
        q = (qk * torch.randn((B, S, 8, 256), generator=gen, device=dev)).bfloat16()
        k = (qk * torch.randn((B, S, 4, 256), generator=gen, device=dev)).bfloat16()
        v = torch.randn((B, S, 4, 256), generator=gen, device=dev).bfloat16()
        return q, k, v

    for label, B, S, window, cap, qk in CASES:
        q, k, v = inputs(B, S, qk)
        kw = dict(causal=True, window=window, softcap=cap)
        want = reference_attention(q.float(), k.float(), v.float(), **kw)
        mag = reference_attention(q.float(), k.float(), v.float().abs(), **kw)
        parts = []
        for name in libs:
            got = fwd(name, q, k, v, window, cap)
            again = fwd(name, q, k, v, window, cap)
            torch.cuda.synchronize()
            rel = float(((got.float() - want).abs() / mag.clamp_min(1e-30)).max())
            same = torch.equal(got, again)
            record["variants"][name].setdefault("max_rel_err", {})[label] = rel
            record["variants"][name].setdefault("repeat_equal", {})[label] = same
            parts.append(f"{name} {rel:.4g}{'' if same else ' NOT bit-identical'}")
        print(f"error over the weighted |v| at {label}: " + "; ".join(parts), flush=True)
        del want, mag

    order = list(libs) + list(libs)[::-1]
    for S, window, cap in TIMED:
        q, k, v = inputs(1, S, 4.0)
        bound_ms = cs._bound(1, S, S, 8, 4, 256, window)[0]
        times = {}
        for name in order:
            times.setdefault(name, []).append(cs.cuda_ms(
                torch, lambda name=name: fwd(name, q, k, v, window, cap), iters=5,
                batch=20))
        key = f"S {S} window {window} softcap {cap:g}"
        for name, ts in times.items():
            record["variants"][name].setdefault("ms", {})[key] = ts
        print(f"{key} (bound {bound_ms:.4f} ms): " + "; ".join(
            f"{n} " + "/".join(f"{t:.4f}" for t in ts) for n, ts in times.items()),
            flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
