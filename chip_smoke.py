#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--ckpt-dir DIR] [--out FILE]

Phases, one line each (plus details):
  1. card    — nvidia-smi name and power limit, torch and CUDA versions;
  2. build   — nvcc builds the codec kernels (K1-K5) and flash attention
               (K6) from the sources under src/repro_torch/kernels/*/csrc
               into build/, one nvcc process per source, all at once;
  3. kernels — each kernel against its plain torch version on the card, at
               the main paths' shapes: K1-K4 bitwise (the qwen3-8b
               embedding leaf, a stacked MLP leaf, a ragged length, a leaf
               with clean blocks), median times beside the HBM bound; K5
               bitwise, all four lanes (the embedding, a stacked 8-layer
               MLP leaf, a bf16 KV-cache leaf, a ragged length, a leaf with
               -0.0, denormals and inf and the same with its last element
               changed), timed beside its bound; K6 at the serving shape in
               bf16 (2e-2), an fp32 case (2e-6), a ragged length, a query
               offset and window + softcap in fp32 and in bf16 at head_dim
               128, each on the route route() gives it (wgmma for bf16 at
               head_dim 64/128, SIMT otherwise) and bit-identical on
               repeat; the serving shape timed beside its bound and
               scaled_dot_product_attention; the wgmma kernels must show
               0 spill bytes in ptxas's report;
  4. train path on qwen3-8b at full width (d_model 4096, 32/8 heads,
               head_dim 128, d_ff 12288, vocab 151936 padded to 152064)
               with num_layers cut from 36 to 2: train 3 steps -> image A
               (lossless) -> 1 step -> image B (opt/m delta8 against A,
               opt/v bf16, parent A) -> restore B on the card -> check ->
               2 more steps from the restored and from the live state. The
               codec kernels' counters are zeroed just before and read just
               after; all four must have launched. Its tensors and its
               mem:// tier are released afterwards;
  5. serve path on qwen3-8b at full width and full depth (36 layers,
               8,191,783,936 params, fp32 on the card): engine A generates
               32 tokens for 4 prompts of 2048 tokens; engine B generates
               16, checkpoints its live session through CheckpointSession
               (lossless, so the image carries the migration record and its
               digest) and is deleted; engine C resumes the session
               (digest verified) and generates to 32. C's tokens must equal
               A's exactly, and K6 must have launched once per layer for
               each of the two prefills, every launch on the wgmma route
               (counters zeroed just before, read just after). Then one
               decode step and one prefill run under torch.profiler for the
               kernel-time breakdown and K6's share of it;
  6. pre-copy path on qwen3-8b at full width with num_layers cut from 36
               to 8 (the image holds the weights): engine A generates 32
               tokens; engine P generates 8, then pre-dump round 0 through
               ServeEngine.checkpoint(mode="pre_dump", weights=True) of
               {"params", "session"} (every leaf written), 12 and round 1
               (every params leaf reused, the cache written), 16 and the
               residual dump through ServeEngine.checkpoint with the
               migration record (the cache's bytes stored, not the
               weights'); a lazy restore through CheckpointSession
               (skeleton, first fault of the embedding, materialize with
               the deferred digest check); engine D resumes through
               ServeEngine.resume_from(lazy=True), adopting the image's
               weights, and continues to 32 tokens, which must equal A's;
               an eager restore of the same image must equal the lazy one
               bitwise. K5 must have classified every fp32/bf16 leaf on
               the card once in each of the 3 passes, K6 run
               once per layer for each of the 2 prefills (A and P; D
               resumes a session and only decodes), K1-K4 not at all.
               K5's classification of the tree is timed beside the JAX
               package's host route (blake2b of the digest's host capture),
               and the path's own host peak RSS is sampled.
Then a JSON line of the kernels' numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero without
the last line. Without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM HBM3 (NVIDIA data sheet). Each codec kernel does about a dozen
# scalar operations or fewer per element against the 6-9 bytes it moves,
# and the card does ~20 fp32/int32 operations per byte of HBM rate: every
# kernel's bound is the bytes it must move.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
REPLACES = {
    "delta_encode_digest": "src/repro/kernels/ckpt_codec/ckpt_codec.py:124",
    "bf16_encode_digest": "src/repro/kernels/ckpt_codec/ckpt_codec.py:148",
    "delta_decode": "src/repro/kernels/ckpt_codec/ckpt_codec.py:178",
    "delta_encode": "src/repro/kernels/ckpt_codec/ckpt_codec.py:50",
    "digest_blocks": "src/repro/kernels/ckpt_codec/ckpt_codec.py:165",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:110",
}
SOURCE = "src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SLAB = 2048          # blocks per plain-version call (bounds its temporaries)
# qwen3-8b has 36 layers: params + m + v are ~98 GB in fp32, more than one
# 80 GB card; at 2 layers they are 19.6 GB and fit with gradients
LAYERS = 2
# serve path: qwen3-8b at full depth, 4 prompts of 2048 tokens, 32 tokens
# generated, the session checkpointed after 16
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_CUT = 4, 2048, 32, 16
# pre-copy path: the image holds the weights too, and the host holds the
# mem:// tier's copy of them beside the final dump's digest capture: at 36
# layers (32.8 GB) that would pass the machine's 96 GiB, at 8 (11.2 GB) the
# host peak stays near 40 GB. Rounds after tokens 8 and 12, the residual
# dump after 16, the same prompts and 32 tokens as the serve path.
PRECOPY_LAYERS = 8
PRECOPY_ROUNDS, PRECOPY_CUT = (8, 12), 16
# K6 cases: label, B, Sq, Skv, H, KV, hd, dtype, window, softcap, tolerance
FLASH_CASES = [
    ("serving 4x2048 32/8 heads x128 bf16", 4, 2048, 2048, 32, 8, 128,
     "bfloat16", 0, 0.0, 2e-2),
    ("fp32 2x512 8/2 heads x128", 2, 512, 512, 8, 2, 128, "float32", 0, 0.0,
     2e-6),
    ("ragged 2x1000 32/8 heads x128 bf16", 2, 1000, 1000, 32, 8, 128,
     "bfloat16", 0, 0.0, 2e-2),
    ("q_offset Sq 128 Skv 384 fp32", 1, 128, 384, 4, 2, 64, "float32", 0, 0.0,
     2e-6),
    ("window 128 + softcap 30 fp32", 1, 512, 512, 2, 1, 128, "float32", 128,
     30.0, 2e-6),
    ("q_offset Sq 128 Skv 384 bf16 x128", 1, 128, 384, 4, 2, 128, "bfloat16",
     0, 0.0, 2e-2),
    ("window 128 + softcap 30 bf16 x128", 1, 512, 512, 2, 1, 128, "bfloat16",
     128, 30.0, 2e-2),
]


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Median of per-call CUDA-event times (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------- kernels
def kernel_phase(torch, dev, seed):
    from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref

    B = ops.BLOCK
    w = ops.digest_weights(B, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def slabbed(fn, *args, per_block=2):
        """The plain version over SLAB blocks at a time, outputs joined;
        the first ``per_block`` args are split by block, the rest whole."""
        nblk = args[0].shape[0]
        outs = [fn(*[a[i:i + SLAB] for a in args[:per_block]],
                   *args[per_block:])
                for i in range(0, nblk, SLAB)]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat(outs)
        return tuple(torch.cat(parts) for parts in zip(*outs))

    as_bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def bits(t):
        return t.view(as_bits[t.dtype]) if t.dtype in as_bits else t

    def compare(a, b):
        """-> (bitwise equal, max abs error over the numeric outputs)."""
        if all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b)):
            return True, 0.0
        return False, max(float((x.double() - y.double()).abs().max())
                          for x, y in zip(a, b) if x.dtype != torch.bool)

    n_embed = 152064 * 4096
    shapes = [("params/embed/tok 152064x4096", n_embed, 0),
              ("stack/b0/mlp/w_up 2x4096x12288", 2 * 4096 * 12288, 0),
              ("ragged 1000003", 1_000_003, 0),
              ("clean blocks (half) 2x4096x12288", 2 * 4096 * 12288, 0.5)]
    rows = {}
    for label, n, clean in shapes:
        x = torch.randn(n, generator=gen, device=dev)
        prev = x + 0.01 * torch.randn(n, generator=gen, device=dev)
        if clean:
            k = int(n * clean) // B * B
            prev[:k] = x[:k]
        xb, _ = ops._blocked(x, B)
        pb, _ = ops._blocked(prev, B)
        del x, prev
        nblk = xb.shape[0]
        timed = label.startswith("params/embed/tok")
        res = {}

        k1 = ckpt_codec.delta_encode_digest(xb, pb, w)
        p1 = slabbed(ref.delta_encode_digest_ref, xb, pb, w)
        res["delta_encode_digest"] = compare(k1, p1)
        k4 = ckpt_codec.delta_encode(xb, pb)
        p4 = slabbed(ref.delta_encode_ref, xb, pb)
        res["delta_encode"] = compare(k4, p4)
        k2 = ckpt_codec.bf16_encode_digest(xb, w)
        p2 = slabbed(ref.bf16_encode_digest_ref, xb, w, per_block=1)
        res["bf16_encode_digest"] = compare(k2, p2)
        q, s = k1[0], k1[1]
        k3 = ckpt_codec.delta_decode(q, s, pb)
        p3 = slabbed(ref.delta_decode_ref, q, s, pb, per_block=3)
        res["delta_decode"] = compare([k3], [p3])
        torch.cuda.synchronize()
        dirty = int(k1[2].sum())
        log(f"kernels: {label}: nblk={nblk} dirty={dirty} " + " ".join(
            f"{k}={'bit-identical' if ok else 'MISMATCH'}"
            for k, (ok, _) in res.items()))
        for k, (ok, e) in res.items():
            check(ok, f"{k} differs from its plain version on {label} "
                      f"(max abs err {e})")
        if clean:
            check(dirty < nblk, f"{label}: clean blocks were not detected")
        del k1, p1, k4, p4, k2, p2, k3, p3

        if timed:
            n_el = nblk * B
            wbytes = 2 * B * 4
            byte_count = {
                "delta_encode_digest": 9 * n_el + wbytes + 13 * nblk,
                "delta_encode": 9 * n_el + 5 * nblk,
                "bf16_encode_digest": 6 * n_el + wbytes + 8 * nblk,
                "delta_decode": 9 * n_el + 4 * nblk,
            }
            q, s = ckpt_codec.delta_encode(xb, pb)[:2]
            calls = {
                "delta_encode_digest": (
                    lambda: ckpt_codec.delta_encode_digest(xb, pb, w),
                    lambda: slabbed(ref.delta_encode_digest_ref, xb, pb, w)),
                "delta_encode": (
                    lambda: ckpt_codec.delta_encode(xb, pb),
                    lambda: slabbed(ref.delta_encode_ref, xb, pb)),
                "bf16_encode_digest": (
                    lambda: ckpt_codec.bf16_encode_digest(xb, w),
                    lambda: slabbed(ref.bf16_encode_digest_ref, xb, w,
                                    per_block=1)),
                "delta_decode": (
                    lambda: ckpt_codec.delta_decode(q, s, pb),
                    lambda: slabbed(ref.delta_decode_ref, q, s, pb,
                                    per_block=3)),
            }
            for k, (kern, plain) in calls.items():
                ms = cuda_ms(torch, kern, iters=10)
                plain_ms = cuda_ms(torch, plain, iters=2)
                rows[k] = {
                    "name": k, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[k], "launches": 0,
                    "max_abs_err": res[k][1], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": byte_count[k] / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes",
                    "library_ms": None, "shape": [nblk, B],
                    "bytes": byte_count[k]}
                log(f"kernels: {k} on {label}: {ms:.3f} ms (bound "
                    f"{rows[k]['bound_ms']:.3f} ms, {rows[k]['bound_ms'] / ms:.0%}"
                    f" of HBM peak), plain {plain_ms:.1f} ms")
            del q, s
        del xb, pb
        torch.cuda.empty_cache()
    rows["digest_blocks"] = digest_phase(torch, dev, gen, slabbed)
    return rows


def digest_phase(torch, dev, gen, slabbed):
    """K5 against its plain version, bitwise, all four lanes, at the
    pre-copy path's shapes; timed on the embedding beside its HBM bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref
    B = ops.BLOCK
    w = ops.digest_weights(B, dev)

    def plain(x):
        n = x.numel()
        nblk = max(1, -(-n // B))
        xb = F.pad(x, (0, nblk * B - n)).reshape(nblk, B)
        return torch.cat([
            torch.stack(slabbed(ref.digest_blocks_ref, xb, w, per_block=1)),
            torch.stack(slabbed(ref.mixed_lanes_ref, xb, w, per_block=1))])

    edge = torch.randn(3 * B + 5, generator=gen, device=dev)
    edge[:4] = torch.tensor([-0.0, 1e-40, -1e-45, float("inf")])
    edge_changed = edge.clone()
    edge_changed[-1] += 1.0
    L = PRECOPY_LAYERS
    cases = [
        ("params/embed/tok 152064x4096 fp32",
         torch.randn(152064 * 4096, generator=gen, device=dev)),
        (f"params/stack/b0/mlp/w_up {L}x4096x12288 fp32",
         torch.randn(L * 4096 * 12288, generator=gen, device=dev)),
        (f"session/cache/stack/b0/k {L}x4x2081x8x128 bf16",
         torch.randn(L * 4 * 2081 * 8 * 128, generator=gen,
                     device=dev).to(torch.bfloat16)),
        ("ragged 1000003 fp32",
         torch.randn(1_000_003, generator=gen, device=dev)),
        ("-0.0, denormals, inf; 3x16384+5 fp32", edge),
        ("the same with its last element changed", edge_changed),
    ]
    row, edge_lanes = None, []
    for label, x in cases:
        got = ckpt_codec.digest_blocks(x, w)
        want = plain(x)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        log(f"kernels: digest_blocks on {label}: nblk={got.shape[1]} "
            f"{'bit-identical' if same else 'MISMATCH'} (4 lanes)")
        check(same, f"digest_blocks differs from its plain version on "
                    f"{label}")
        if label.startswith("-0.0") or label.startswith("the same"):
            edge_lanes.append(got)
        if row is None:          # the embedding: time it
            n = x.numel()
            nblk = got.shape[1]
            nbytes = n * x.element_size() + 2 * B * 4 + 16 * nblk
            ms = cuda_ms(torch, lambda: ckpt_codec.digest_blocks(x, w),
                         iters=10)
            plain_ms = cuda_ms(torch, lambda: plain(x), iters=2)
            row = {"name": "digest_blocks", "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES["digest_blocks"], "launches": 0,
                   "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "library_ms": None,
                   "shape": [nblk, B], "bytes": nbytes}
            log(f"kernels: digest_blocks on {label}: {ms:.3f} ms (bound "
                f"{row['bound_ms']:.3f} ms, {row['bound_ms'] / ms:.0%} of "
                f"HBM peak), plain {plain_ms:.1f} ms")
        elif "bf16" in label:
            ms = cuda_ms(torch, lambda: ckpt_codec.digest_blocks(x, w),
                         iters=10)
            nbytes = x.numel() * 2 + 2 * B * 4 + 16 * got.shape[1]
            log(f"kernels: digest_blocks on {label}: {ms:.3f} ms (bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms by bytes)")
        del got, want
    check(not torch.equal(edge_lanes[0], edge_lanes[1]),
          "digest_blocks did not see a changed last element")
    del cases, x, edge, edge_changed
    torch.cuda.empty_cache()
    return row


def live_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave live: the work this input needs."""
    import numpy as np
    qp = (Skv - Sq) + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qp, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_phase(torch, dev, seed):
    """K6 against its plain version at FLASH_CASES, each case on its route;
    times at the first (serving) case beside its bound and
    scaled_dot_product_attention."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.kernels.flash_attention.ref import reference_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    row = None
    for (label, B, Sq, Skv, H, KV, hd, dtype, window, cap,
         tol) in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dt)
        kw = dict(causal=True, window=window, softcap=cap)
        way = k6.route(dt, hd)
        k6.reset_launches()
        got = k6.flash_attention_fwd(q, k, v, **kw)
        want = reference_attention(q.float(), k.float(), v.float(), **kw)
        err = float((got.float() - want).abs().max())
        again = k6.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        log(f"kernels: flash_attention on {label} ({way} route): max abs err "
            f"{err:.3g} (tolerance {tol:g}); repeat bit-identical: {same}")
        check(k6.ROUTE_LAUNCHES[way] == 2,
              f"flash_attention on {label} did not take the {way} route: "
              f"{k6.ROUTE_LAUNCHES}")
        check(err < tol, f"flash_attention differs from its plain version "
                         f"on {label}: max abs err {err} >= {tol}")
        check(same, f"flash_attention is not deterministic on {label}")
        del got, want, again
        if row is None:        # the serving shape: time it
            ms = cuda_ms(torch, lambda: k6.flash_attention_fwd(q, k, v, **kw),
                         iters=20)
            plain_ms = cuda_ms(torch, lambda: reference_attention(
                q, k, v, **kw), iters=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = F.scaled_dot_product_attention
            library_ms = cuda_ms(torch, lambda: lib(
                qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
            pairs = live_pairs(Sq, Skv, True, window)
            ops = 4 * B * H * hd * pairs
            es = q.element_size()
            nbytes = es * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
            t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
            row = {"name": "flash_attention", "route": "cuda",
                   "source": FLASH_SOURCE,
                   "replaces": REPLACES["flash_attention"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": library_ms, "kernel_route": way,
                   "shape": [B, Sq, Skv, H, KV, hd],
                   "ops": ops, "bytes": nbytes}
            log(f"kernels: flash_attention on {label}: {way} route "
                f"{ms:.3f} ms (bound {row['bound_ms']:.3f} ms by "
                f"{row['bound_by']}: {ops / 1e9:.1f} GFLOP at 989 TFLOP/s "
                f"bf16, {nbytes / 1e6:.0f} MB at 3.35 TB/s; "
                f"{row['bound_ms'] / ms:.1%} of bound), plain "
                f"{plain_ms:.1f} ms, scaled_dot_product_attention "
                f"{library_ms:.3f} ms "
                f"({ms / library_ms:.2f}x its time)")
        del q, k, v
        torch.cuda.empty_cache()
    return row


# -------------------------------------------------------------- train path
def policy_b(path: str) -> str:
    if path.startswith("opt/m/"):
        return "delta8"
    return "bf16" if path.startswith("opt/v/") else "none"


def m_within_half_scale(got, live, prev):
    """delta8's bound, a slab of codec blocks at a time: every element
    within its block's scale/2, widened by 2^-12 relative for the fp32
    roundings of d = x - prev and of 1/scale (each ~2^-23 * amax, i.e.
    ~127 * 2^-23 of scale) and by one ulp of the value for the decode's
    own rounding. -> (holds, worst error / (scale/2))."""
    import torch

    from repro_torch.kernels.ckpt_codec import ops, ref
    B, n, worst, ok = ops.BLOCK, live.numel(), 0.0, True
    for lo in range(0, n, SLAB * B):
        hi = min(n, lo + SLAB * B)
        xb, _ = ops._blocked(live[lo:hi], B)
        pb, _ = ops._blocked(prev[lo:hi], B)
        _, scale, _ = ref.delta_encode_ref(xb, pb)
        half = torch.repeat_interleave(scale / 2, B)[:hi - lo]
        ax = live[lo:hi].abs()
        ulp = torch.nextafter(ax, torch.full_like(ax, float("inf"))) - ax
        e = (got[lo:hi] - live[lo:hi]).abs()
        ok &= bool((e <= half * (1 + 2 ** -12) + ulp).all())
        worst = max(worst, float((e / torch.clamp_min(half, 1e-30)).max()))
    return ok, worst


def train_path(torch, dev, args):
    import numpy as np

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import as_tier, dump, flatten_with_paths, restore
    from repro_torch.core.storage import LocalDirTier
    from repro_torch.device import to_host
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import (abstract_train_state, init_train_state,
                                      make_train_step)

    cfg = CONFIG.replace(num_layers=LAYERS)
    lm = LM(cfg)
    log(f"train: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}->{cfg.padded_vocab}; "
        f"cut: num_layers {CONFIG.num_layers} -> {cfg.num_layers} (the only "
        f"cut); params={lm.n_params():,}")
    root = (LocalDirTier(args.ckpt_dir, fsync="commit") if args.ckpt_dir
            else as_tier(f"mem://chip-smoke-{args.seed}"))
    rng = np.random.default_rng(args.seed)

    def batch():
        t = rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int64)
        return {"tokens": torch.from_numpy(t).to(dev)}

    t0 = time.time()
    state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                             device=dev)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in flatten_with_paths(state))
    log(f"train: init {time.time() - t0:.1f} s; train state "
        f"{state_bytes / 1e9:.2f} GB on the card")
    step = make_train_step(lm, OptConfig())
    out = {"state_bytes": state_bytes, "losses": [], "step_s": []}

    ckpt_codec.reset_launches()          # the main path's counts start here
    for _ in range(3):
        t0 = time.time()
        state, m = step(state, batch())
        loss = float(m["loss"])
        out["losses"].append(loss)
        out["step_s"].append(time.time() - t0)
        check(np.isfinite(loss), f"loss {loss} is not finite")
    log(f"train: 3 steps, losses {out['losses']}, step s "
        f"{[round(s, 3) for s in out['step_s']]}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    t0 = time.time()
    ra = dump(state, root, step=3, device=dev, device_codec="auto")
    out["dump_a_s"] = time.time() - t0
    log(f"train: image A {ra['image_id']} lossless in {out['dump_a_s']:.1f} s: "
        f"{ra['stats']['bytes_stored'] / 1e9:.2f} GB stored")
    prev = {p: to_host(t) for p, t in flatten_with_paths(state)
            if p.startswith("opt/m/")}

    state, m = step(state, batch())
    out["losses"].append(float(m["loss"]))
    torch.cuda.synchronize()
    t0 = time.time()
    rb = dump(state, root, step=4, parent=ra["image_id"],
              codec_policy=policy_b, prev_host_tree=prev, device=dev,
              device_codec="auto")
    out["dump_b_s"] = time.time() - t0
    st = rb["stats"]
    log(f"train: image B {rb['image_id']} (parent {ra['image_id']}) in "
        f"{out['dump_b_s']:.1f} s: {st['bytes_stored'] / 1e9:.2f} GB stored, "
        f"{st['leaves_device']} leaves through the device codec stage")
    check(st["leaves_device"] > 0, "no leaf went through the device stage")
    # A's m is kept on the card for the check below: the host holds the
    # mem:// tier and, during restore, the decoded leaves (~60 GB at peak)
    prev = {p: torch.from_numpy(a).to(dev) for p, a in prev.items()}

    t0 = time.time()
    tree, man = restore(root, rb["image_id"], device=dev,
                        expected=abstract_train_state(lm))
    torch.cuda.synchronize()
    out["restore_s"] = time.time() - t0
    digests = sum(1 for r in man["leaves"] if "digest" in r["codec_meta"])
    log(f"train: restore B in {out['restore_s']:.1f} s; {digests} payload "
        f"digests re-derived from the stored bytes and verified")
    check(digests > 0, "image B carries no payload digest")

    live = dict(flatten_with_paths(state))
    got = dict(flatten_with_paths(tree))
    check(set(live) == set(got), "restored leaves differ from the live ones")
    worst = 0.0
    for p, t in live.items():
        g = got[p]
        if p.startswith("opt/v/"):
            check(torch.equal(g.view(torch.int32),
                              t.to(torch.bfloat16).float().view(torch.int32)),
                  f"{p}: not the bf16 round trip of the live value")
        elif p.startswith("opt/m/"):
            ok, ratio = m_within_half_scale(g.reshape(-1), t.reshape(-1),
                                            prev[p].reshape(-1))
            check(ok, f"{p}: delta8 error above the block's scale/2 "
                      f"(worst error / (scale/2) = {ratio})")
            worst = max(worst, ratio)
        else:
            check(torch.equal(g, t), f"{p}: not bit-identical after restore")
    out["m_err_over_half_scale"] = worst
    log("train: params and step bit-identical; opt/v equals the bf16 round "
        "trip of the live v bitwise; opt/m within each block's scale/2 "
        f"(worst error / (scale/2) = {worst:.4f})")
    del prev, got, live

    # continue 2 steps from the restored and from the live state
    batches = [batch() for _ in range(2)]
    cont = {"restored": [], "live": []}
    for name, s in (("restored", tree), ("live", state)):
        for b in batches:
            s, m = step(s, b)
            cont[name].append(float(m["loss"]))
        if name == "restored":
            tree = s
        else:
            state = s
    out["continue"] = cont
    log(f"train: continue 2 steps: restored losses {cont['restored']}, live "
        f"losses {cont['live']} (held to 1e-5 relative at step 5, whose "
        f"params are bit-identical, and 1e-3 at step 6, after one update "
        f"with the lossy moments)")
    # step 5's loss is computed from bit-identical params: it must agree to
    # 1e-5 relative (the kernels are deterministic; the slack is for a
    # cuBLAS algorithm choice). Step 6 starts from params updated with the
    # lossy moments, which move a parameter by ~lr * 1e-2 relative; its loss
    # must agree to 1e-3 relative.
    r0, l0 = cont["restored"][0], cont["live"][0]
    r1, l1 = cont["restored"][1], cont["live"][1]
    check(abs(r0 - l0) <= 1e-5 * abs(l0), f"step 5 losses {r0} vs {l0}")
    check(abs(r1 - l1) <= 1e-3 * abs(l1), f"step 6 losses {r1} vs {l1}")
    check(all(np.isfinite(v) for v in cont["restored"] + cont["live"]),
          "non-finite loss after restore")
    check(int(tree["step"]) == 6 and tree["step"].dtype == torch.int32,
          "restored step counter did not continue")

    # read just after the train path: its kernels are K1-K4 (K5 runs on
    # the pre-copy path)
    launches = {k: v for k, v in ckpt_codec.LAUNCHES.items()
                if k != "digest_blocks"}
    out["launches"] = launches
    log("kernels: train-path launches " + " ".join(
        f"{k}={v}" for k, v in launches.items()))
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the train path")
    if not args.ckpt_dir:      # release the images held in host memory
        root.delete("chunks")
        root.delete("images")
    return out


# -------------------------------------------------------------- serve path
def serve_path(torch, dev, args):
    import numpy as np

    from repro_torch.api import CheckpointSession
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core.storage import as_tier
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine

    cfg = CONFIG
    lm = LM(cfg)
    t0 = time.time()
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params))
    log(f"serve: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, no cut); params={lm.n_params():,} ({pbytes / 1e9:.1f} GB "
        f"fp32 on the card), init {time.time() - t0:.1f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    uri = f"mem://chip-smoke-serve-{args.seed}"
    out = {"params": lm.n_params()}

    torch.use_deterministic_algorithms(True)   # A, B and C must agree bitwise
    k6.reset_launches()                        # the serve path's counts
    ckpt_codec.reset_launches()
    a = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    a.submit(prompts)
    torch.cuda.synchronize()
    out["prefill_s"] = time.time() - t0
    kv = a.cache["stack"]["b0"]["k"][:, :, :SERVE_PROMPT]
    check(bool(torch.isfinite(kv).all()), "prefill wrote non-finite keys")
    t0 = time.time()
    want = a.generate(SERVE_GEN).copy()
    out["decode_s_per_token"] = (time.time() - t0) / (SERVE_GEN - 1)
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(a.cache))
    del a, kv
    log(f"serve: engine A: prefill {SERVE_B}x{SERVE_PROMPT} in "
        f"{out['prefill_s']:.3f} s, decode {out['decode_s_per_token']:.4f} "
        f"s/token to {SERVE_GEN} tokens; KV cache {cache_bytes / 1e9:.3f} GB "
        f"bf16")
    check(want.shape == (SERVE_B, SERVE_GEN) and want.min() >= 0
          and want.max() < cfg.vocab_size, "generated tokens out of range")

    b = ServeEngine(lm, params, max_len=max_len)
    b.submit(prompts)
    b.generate(SERVE_CUT)
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    receipt = b.checkpoint(sess, arch=cfg.name)
    out["dump_s"] = time.time() - t0
    out["image_bytes"] = receipt.stats["bytes_stored"]
    del b
    log(f"serve: engine B checkpointed at token {SERVE_CUT} as "
        f"{receipt.image_id} in {out['dump_s']:.2f} s: "
        f"{out['image_bytes'] / 1e9:.3f} GB stored; engine B deleted")

    c = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    res = c.resume_from(CheckpointSession(uri, device=dev))
    torch.cuda.synchronize()
    out["restore_s"] = time.time() - t0
    log(f"serve: engine C resumed {res.image_id} in {out['restore_s']:.2f} s, "
        f"digest_verified={res.digest_verified}")
    check(res.digest_verified is True, "the resumed session's digest was "
                                       "not verified")
    check(np.array_equal(c.generated(), want[:, :SERVE_CUT]),
          "the resumed session's tokens differ from engine A's")
    got = c.generate(SERVE_GEN)
    same = bool(np.array_equal(got, want))
    torch.use_deterministic_algorithms(False)
    launches = dict(k6.LAUNCHES)               # read just after the path
    routes = dict(k6.ROUTE_LAUNCHES)
    codec = dict(ckpt_codec.LAUNCHES)
    out["launches"] = launches
    out["k6_routes"] = routes
    out["tokens_equal"] = same
    log(f"serve: engine C tokens {'equal' if same else 'DIFFER FROM'} "
        f"engine A's at all {SERVE_B}x{SERVE_GEN}; first row "
        f"{got[0, :8].tolist()}...")
    log(f"kernels: serve-path launches flash_attention="
        f"{launches['flash_attention']} (wgmma route {routes['wgmma']}, "
        f"SIMT route {routes['simt']}; codec kernels "
        f"{sum(codec.values())}: the serve image is lossless)")
    check(same, "engine C's continuation differs from engine A's tokens")
    check(launches["flash_attention"] == 2 * cfg.num_layers,
          f"flash_attention launched {launches['flash_attention']} times on "
          f"the serve path, not {2 * cfg.num_layers} (one per layer for each "
          f"of the two prefills)")
    check(routes == {"wgmma": 2 * cfg.num_layers, "simt": 0},
          f"the serve path's flash_attention launches did not all take the "
          f"wgmma route: {routes}")
    # where the time goes, after the counts were read: one decode step and
    # one prefill under torch.profiler, kernel time by name
    out["profile"] = {}
    for name, fn in (("decode step", c.step),
                     ("prefill", lambda: c.submit(prompts))):
        wall_ms, busy_ms, rows = device_breakdown(torch, fn)
        k6_ms = sum(ms for ms, k, _ in rows if "flash_fwd" in k)
        k6_n = sum(n for _, k, n in rows if "flash_fwd" in k)
        out["profile"][name] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                                "top": rows[:6], "k6_ms": k6_ms}
        log(f"serve: profile of one {name}: {wall_ms:.1f} ms wall under the "
            f"profiler, {busy_ms:.1f} ms of kernels ({busy_ms / wall_ms:.0%} "
            f"busy); K6 {k6_ms:.2f} ms x{k6_n} ({k6_ms / busy_ms:.1%} of the "
            f"kernel time); top: " + "; ".join(
                f"{k[:48]} {ms:.2f} ms x{n}" for ms, k, n in rows[:6]))
    del c, params
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    return out


# ----------------------------------------------------------- pre-copy path
def precopy_path(torch, dev, args):
    """Pre-copy migration of a serving job (CRIU pre-dump -> residual dump
    -> lazy-pages restore), the tree {"params", "session"} classified on the
    card by K5 in every pass."""
    import numpy as np

    from repro_torch.api import CheckpointSession, RestoreRequest
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import (flatten_with_paths, get_default_executor,
                                  host_tree_by_path, read_manifest)
    from repro_torch.core.migration import MIGRATION_META_KEY
    from repro_torch.core.predump import digest_pairs, leaf_digest, uses_lanes
    from repro_torch.core.storage import as_tier
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6
    from repro_torch.models.model import LM
    from repro_torch.serving import ServeEngine

    cfg = CONFIG.replace(num_layers=PRECOPY_LAYERS)
    lm = LM(cfg)
    t0 = time.time()
    params = lm.init(torch.Generator().manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"precopy: {cfg.name} at full width; cut: num_layers "
        f"{CONFIG.num_layers} -> {cfg.num_layers} (the only cut: the image "
        f"holds the weights and the host their mem:// copy); params="
        f"{lm.n_params():,} ({pbytes / 1e9:.3f} GB fp32 on the card), init "
        f"{time.time() - t0:.1f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    uri = f"mem://chip-smoke-precopy-{args.seed}"
    out = {"params": lm.n_params(), "layers": cfg.num_layers}

    torch.use_deterministic_algorithms(True)
    ckpt_codec.reset_launches()              # the path's counts start here
    k6.reset_launches()
    a = ServeEngine(lm, params, max_len=max_len)
    a.submit(prompts)
    want = a.generate(SERVE_GEN).copy()
    del a
    log(f"precopy: engine A generated {SERVE_B}x{SERVE_GEN} tokens "
        f"uninterrupted (the reference)")

    p = ServeEngine(lm, params, max_len=max_len)
    p.submit(prompts)

    def tree():
        return {"params": p.params, "session": p.session_state()}
    n_leaves = len(flatten_with_paths(tree()))
    n_params = len(flatten_with_paths(params))
    n_lanes = sum(1 for _, t in flatten_with_paths(tree())
                  if uses_lanes(t) and t.device.type == "cuda")
    cache_paths = [q for q, _ in flatten_with_paths(tree())
                   if q.startswith("session/cache/stack/")]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(p.cache))
    sess = CheckpointSession(uri, device=dev)

    def k5_pass(what, fn):
        """fn() once, checking that K5 classified every fp32/bf16 leaf on
        the card exactly once in it."""
        before = ckpt_codec.LAUNCHES["digest_blocks"]
        t0 = time.time()
        rec = fn()
        dt = time.time() - t0
        n = ckpt_codec.LAUNCHES["digest_blocks"] - before
        check(n == n_lanes, f"{what}: digest_blocks launched {n} times, not "
                            f"once for each of the {n_lanes} fp32/bf16 leaves "
                            f"on the card")
        return rec, dt

    rounds = []
    for r, upto in enumerate(PRECOPY_ROUNDS):
        p.generate(upto)
        torch.cuda.synchronize()
        rec, dt = k5_pass(f"round {r}", lambda: p.checkpoint(
            sess, arch=cfg.name, mode="pre_dump", weights=True))
        st = rec.stats
        rounds.append({"image_id": rec.image_id, "s": dt,
                       "leaves_dirty": st["leaves_dirty"],
                       "leaves_clean": st["leaves_clean"],
                       "bytes_stored": st["bytes_stored"]})
        log(f"precopy: round {r} at token {upto} -> {rec.image_id} in "
            f"{dt:.2f} s through ServeEngine.checkpoint(mode=\"pre_dump\"): "
            f"{st['leaves_dirty']} dirty, {st['leaves_clean']} clean of "
            f"{n_leaves} leaves, {st['bytes_stored'] / 1e9:.3f} GB stored")
        check(rec.image_id == f"step_{upto:010d}p{r:02d}",
              f"round {r} wrote {rec.image_id}")
    out["rounds"] = rounds
    check(rounds[0]["leaves_clean"] == 0
          and rounds[0]["leaves_dirty"] == n_leaves,
          "round 0 (a cold tracker) did not write every leaf")
    m0, m1 = (read_manifest(sess.tier, r["image_id"])["leaves"]
              for r in rounds)
    r0 = {x["path"]: x for x in m0}
    r1 = {x["path"]: x for x in m1}
    reused = [q for q in r1 if q.startswith("params/")
              and r1[q]["chunks"] == r0[q]["chunks"]]
    check(rounds[1]["leaves_clean"] >= n_params and len(reused) == n_params,
          f"round 1 reused {rounds[1]['leaves_clean']} leaves, not every "
          f"one of the {n_params} params leaves")
    for q in cache_paths + ["session/generated"]:
        check(r1[q]["chunks"] != r0[q]["chunks"],
              f"{q} changed between the rounds but was not written")

    # the final (residual) dump through the engine: its migration record
    # holds the tree digest of a host capture that the engine takes and
    # drops; the dump itself gets the live tree and copies only the dirty
    # leaves to the host
    p.generate(PRECOPY_CUT)
    torch.cuda.synchronize()
    fin, dt = k5_pass("the residual dump", lambda: p.checkpoint(
        sess, arch=cfg.name, weights=True))
    out["residual_s"] = fin.duration_s
    out["capture_digest_s"] = dt - fin.duration_s
    st = fin.stats
    out["residual"] = {"image_id": fin.image_id,
                       "leaves_reused": st["leaves_reused"],
                       "bytes_stored": st["bytes_stored"],
                       "bytes_reused": st["bytes_reused"]}
    digest = read_manifest(sess.tier, fin.image_id)["meta"][
        MIGRATION_META_KEY]["state_digest"]
    log(f"precopy: residual dump at token {PRECOPY_CUT} -> {fin.image_id} "
        f"through ServeEngine.checkpoint in {out['residual_s']:.2f} s (apart "
        f"from the migration digest's host capture and SHA-256, "
        f"{out['capture_digest_s']:.2f} s); round 0, in effect the "
        f"monolithic dump of this tree, took {rounds[0]['s']:.2f} s. "
        f"{st['leaves_reused']} leaves reused ({st['bytes_reused'] / 1e9:.3f}"
        f" GB), {st['bytes_stored'] / 1e9:.3f} GB stored against a "
        f"{cache_bytes / 1e9:.3f} GB KV cache")
    check(fin.image_id == f"step_{PRECOPY_CUT:010d}",
          f"the final dump wrote {fin.image_id}")
    check(st["leaves_reused"] >= n_params,
          "the residual dump did not reuse every params leaf")
    check(0 < st["bytes_stored"] <= 1.05 * cache_bytes + 2 ** 20,
          f"the residual dump stored {st['bytes_stored']} bytes, more than "
          f"the {cache_bytes}-byte KV cache")
    # the JAX package's classifier on the same tree, for comparison:
    # capture it to the host, then blake2b every leaf on the cpu pool
    t0 = time.time()
    host = host_tree_by_path(tree())
    out["capture_s"] = time.time() - t0
    t0 = time.time()
    get_default_executor().map_cpu(leaf_digest, host.values())
    out["host_classify_s"] = time.time() - t0
    del host, p, tree
    gc.collect()

    # lazy (post-copy) resume, timed: skeleton, first fault, materialize
    sess = CheckpointSession(uri, device=dev)
    t0 = time.time()
    res = sess.restore(RestoreRequest(lazy=True, prefetch_order=("params",)))
    out["skeleton_s"] = time.time() - t0
    check(res.image_id == fin.image_id,
          f"the lazy restore picked {res.image_id}, not the final image")
    srv = res.state.server
    t0 = time.time()
    emb = res.state["params"]["embed"]["tok"]
    torch.cuda.synchronize()
    out["first_fault_s"] = time.time() - t0
    check(emb.device.type == "cuda" and tuple(emb.shape) == (
        cfg.padded_vocab, cfg.d_model), "the embedding did not fault in "
                                        "onto the card")
    t0 = time.time()
    state = res.state.materialize()
    torch.cuda.synchronize()
    out["materialize_s"] = time.time() - t0
    verified = srv.verify_tree_digest()
    log(f"precopy: lazy resume of {res.image_id}: skeleton in "
        f"{out['skeleton_s']:.3f} s, first fault of params/embed/tok in "
        f"{out['first_fault_s']:.3f} s, materialize (deferred digest "
        f"check included) in {out['materialize_s']:.2f} s; digest verified: "
        f"{verified}; server stats {srv.stats}")
    check(verified is True and srv.expected_digest == digest,
          "the lazy resume did not verify the tree digest")
    lazy_flat = dict(flatten_with_paths(state))
    check(all(t.device.type == "cuda" for t in lazy_flat.values()),
          "a materialized leaf is not on the card")
    del res, srv, emb, state
    gc.collect()

    # engine D resumes the job lazily through its own entry point: it
    # adopts the image's weights and session, then decodes to the end
    d = ServeEngine(lm, params, max_len=max_len)
    t0 = time.time()
    res_d = d.resume_from(CheckpointSession(uri, device=dev), lazy=True,
                          prefetch_order=("params",))
    torch.cuda.synchronize()
    out["engine_resume_s"] = time.time() - t0
    check(res_d.image_id == fin.image_id and res_d.digest_verified is True,
          f"ServeEngine.resume_from(lazy=True) gave {res_d.image_id}, digest "
          f"verified {res_d.digest_verified}")
    d_flat = {**{f"params/{q}": t for q, t in flatten_with_paths(d.params)},
              **{f"session/cache/{q}": t
                 for q, t in flatten_with_paths(d.cache)}}
    check(d.params is not params and all(
        t.device.type == "cuda" and torch.equal(t, lazy_flat[q])
        for q, t in d_flat.items()),
          "engine D did not adopt the image's weights and cache on the card")
    check(np.array_equal(d.generated(), want[:, :PRECOPY_CUT]),
          "the resumed session's tokens differ from engine A's")
    del res_d, d_flat
    got = d.generate(SERVE_GEN)
    same = bool(np.array_equal(got, want))
    out["tokens_equal"] = same
    log(f"precopy: engine D resumed through ServeEngine.resume_from(lazy="
        f"True) in {out['engine_resume_s']:.2f} s (digest verified); its "
        f"tokens {'equal' if same else 'DIFFER FROM'} engine A's at all "
        f"{SERVE_B}x{SERVE_GEN}")
    check(same, "engine D's continuation differs from engine A's tokens")
    del d

    # eager restore of the same image: bitwise the lazily materialized tree
    t0 = time.time()
    eager = CheckpointSession(uri, device=dev).restore(
        RestoreRequest(image_id=fin.image_id))
    torch.cuda.synchronize()
    out["eager_s"] = time.time() - t0
    eager_flat = dict(flatten_with_paths(eager.state))
    check(eager.digest_verified is True, "the eager restore's digest was "
                                         "not verified")
    check(lazy_flat.keys() == eager_flat.keys()
          and all(eager_flat[q].dtype == t.dtype
                  and torch.equal(eager_flat[q], t)
                  for q, t in lazy_flat.items()),
          "the eager restore differs from the lazy one")
    log(f"precopy: eager restore of {fin.image_id} in {out['eager_s']:.2f} s "
        f"(digest verified); bitwise equal to the lazy one at all "
        f"{len(eager_flat)} leaves")
    torch.use_deterministic_algorithms(False)
    del eager, eager_flat

    routes = dict(k6.ROUTE_LAUNCHES)
    launches = {"digest_blocks": ckpt_codec.LAUNCHES["digest_blocks"],
                "flash_attention": k6.LAUNCHES["flash_attention"],
                "codec K1-K4": sum(v for k, v in ckpt_codec.LAUNCHES.items()
                                   if k != "digest_blocks")}
    out["launches"] = launches
    log(f"kernels: pre-copy-path launches digest_blocks="
        f"{launches['digest_blocks']} ({n_lanes} fp32/bf16 leaves on the card"
        f" x 3 classification passes), flash_attention="
        f"{launches['flash_attention']} (2 prefills, A and P, x "
        f"{cfg.num_layers} layers: D resumes a session and only decodes; "
        f"wgmma route {routes['wgmma']}, SIMT route {routes['simt']}), "
        f"codec K1-K4 {launches['codec K1-K4']} (lossless image)")
    check(launches["digest_blocks"] == 3 * n_lanes,
          f"digest_blocks launched {launches['digest_blocks']} times, not "
          f"{3 * n_lanes}")
    check(launches["codec K1-K4"] == 0, "a codec kernel ran on the lossless "
                                        "pre-copy path")
    check(launches["flash_attention"] == 2 * cfg.num_layers,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"not {2 * cfg.num_layers}")
    check(routes == {"wgmma": 2 * cfg.num_layers, "simt": 0},
          f"the pre-copy path's flash_attention launches did not all take "
          f"the wgmma route: {routes}")

    # K5's classification of the same tree (the dumped one), timed after
    # the counts were read, beside the host route above
    pairs = sorted(lazy_flat.items())
    digest_pairs(pairs)                    # warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        digest_pairs(pairs)
        times.append(time.time() - t0)
    out["k5_classify_s"] = statistics.median(times)
    tree_gb = sum(t.numel() * t.element_size() for _, t in pairs) / 1e9
    log(f"precopy: classifying the {tree_gb:.2f} GB tree: K5 on the card "
        f"{out['k5_classify_s'] * 1e3:.1f} ms (host clock, lanes to host "
        f"included); the JAX package's route (blake2b of the host capture "
        f"on the cpu pool) {out['host_classify_s']:.2f} s, after a "
        f"{out['capture_s']:.2f} s device-to-host capture")
    del lazy_flat, pairs, params
    as_tier(uri).delete("chunks")
    as_tier(uri).delete("images")
    return out


def _rss_gb() -> float:
    """The process's peak RSS so far, GB (ru_maxrss is in KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


class RssPeak:
    """The peak of the process's current RSS while the block runs, sampled
    every 20 ms from /proc/self/statm: a path's own host peak, which
    ru_maxrss hides behind an earlier path's."""

    def __init__(self):
        self.peak_gb = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.02):
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * self._page / 1e9
            self.peak_gb = max(self.peak_gb, rss)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def device_breakdown(torch, fn):
    """Run fn once under torch.profiler -> (wall ms, summed kernel ms,
    [(ms, kernel name, launches)] of every kernel, by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return wall_ms, sum(r[0] for r in rows), rows


def wgmma_spills(build_log: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} of the flash_fwd_wgmma
    instances in an nvcc -Xptxas -v log."""
    import re
    out, name = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1) if "flash_fwd_wgmma" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="train-path image directory (default: an in-memory "
                         "mem:// tier)")
    ap.add_argument("--out", default=None, help="write the run's record here")
    args = ap.parse_args(argv)

    # cuBLAS picks deterministic algorithms only with a fixed workspace;
    # set before CUDA initializes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.ckpt_codec import ckpt_codec
    from repro_torch.kernels.flash_attention import flash_attention as k6

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(card)
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}; "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.time()
    libs = [ckpt_codec.LIB, k6.LIB]
    sos = build_all(libs)
    for lib in libs:
        lib.load()
    log(f"build: {', '.join(os.path.relpath(so, ROOT) for so in sos)} in "
        f"{time.time() - t0:.1f} s (one nvcc each, in parallel)")
    for lib in libs:
        for ln in lib.ptxas_lines():
            log(f"build: {lib.name}: {ln}")
    spills = wgmma_spills(k6.LIB.build_log)
    log(f"build: flash_attention wgmma kernels' spill bytes (stores, loads): "
        f"{spills}")
    check(len(spills) == len(k6.WGMMA_HEAD_DIMS)
          and all(v == (0, 0) for v in spills.values()),
          f"the wgmma kernels spill or are missing from ptxas's report: "
          f"{spills}")

    rows = kernel_phase(torch, dev, args.seed)
    rows["flash_attention"] = flash_phase(torch, dev, args.seed)
    torch.cuda.reset_peak_memory_stats()
    record = train_path(torch, dev, args)
    record["train_peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for k, n in record["launches"].items():
        rows[k]["launches"] = n
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record["serve"] = serve_path(torch, dev, args)
    record["serve"]["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rows["flash_attention"]["launches"] = \
        record["serve"]["launches"]["flash_attention"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        record["precopy"] = precopy_path(torch, dev, args)
    record["precopy"]["host_peak_rss_gb"] = rss.peak_gb
    record["precopy"]["peak_device_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    rows["digest_blocks"]["launches"] = \
        record["precopy"]["launches"]["digest_blocks"]
    record["kernels"] = list(rows.values())
    record["card"] = card
    record["wall_s"] = time.time() - t_start
    record["host_peak_rss_gb"] = _rss_gb()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    log(f"precopy: host peak RSS of the path {rss.peak_gb:.1f} GB "
        f"(sampled every 20 ms)")
    log(f"done in {record['wall_s']:.0f} s; host peak RSS "
        f"{record['host_peak_rss_gb']:.1f} GB; peak device memory: train "
        f"{record['train_peak_device_gb']:.1f} GB, serve "
        f"{record['serve']['peak_device_gb']:.1f} GB, pre-copy "
        f"{record['precopy']['peak_device_gb']:.1f} GB")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in record["kernels"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
