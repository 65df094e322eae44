"""Hopper kernels for the checkpoint codec, bound with ctypes.

Each wrapper below takes a CUDA tensor to its hand-written kernel in
``csrc/ckpt_codec.cu`` (built for ``sm_90a`` by ``nvcc`` at first use into
``<repo>/build/ckpt_codec/``; see ``kernels/_build.py``) and a CPU tensor
to its plain torch version in ``ref.py``. A CUDA tensor never reaches the
plain version: the wrapper launches its kernel or raises.

  kernel                      replaces (src/repro/kernels/ckpt_codec/)
  K1 delta_encode_digest      ckpt_codec.py  delta_encode_digest_pallas
  K2 bf16_encode_digest       ckpt_codec.py  bf16_encode_digest_pallas
  K3 delta_decode             ckpt_codec.py  delta_decode_pallas
  K4 delta_encode             ckpt_codec.py  delta_encode_pallas
  K5 digest_blocks_many       ckpt_codec.py  digest_blocks_pallas
     (digest_blocks: its one-leaf case)

K1-K4 stream HBM once (~9 B/element for K1, K3, K4 and 6 B/element for
K2) with a few operations per element: they are bound by memory
bandwidth, one CTA per codec block. K5 digests a whole list of leaves in
one launch on a grid sized to the card; ``plan_digest`` lays the list out
(the same plan on both routes). See the .cu file for the designs and the
rounding rules that keep the kernels bit-identical to ``ref.py``.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are
not counted), so a run can show that its path went through the kernels;
``LEAVES`` counts the leaves K5's launches digested.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._build import Library, stream_of
from repro_torch.kernels.ckpt_codec import ref

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = Library(
    "ckpt_codec", Path(__file__).resolve().parent / "csrc" / "ckpt_codec.cu",
    {"ckpt_delta_encode_digest": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P],
     "ckpt_delta_encode": [_P, _P, _P, _P, _P, _LL, _I, _P],
     "ckpt_bf16_encode_digest": [_P, _P, _P, _P, _P, _LL, _I, _P],
     "ckpt_delta_decode": [_P, _P, _P, _P, _LL, _I, _P],
     "ckpt_digest_leaves": [_P, _I, _P, _P, _P, _LL, _I, _P]},
    error_fn="ckpt_error_string")

KERNELS = ("delta_encode_digest", "bf16_encode_digest", "delta_decode",
           "delta_encode", "digest_blocks")
LAUNCHES = {k: 0 for k in KERNELS}
LEAVES = {"digest_blocks": 0}     # leaves digested by K5's launches
# K5 (csrc/ckpt_codec.cu): a CTA owns 1024 positions of every block, and
# up to 128 leaves travel in the kernel's parameters (a longer list as a
# device copy of the same rows)
DIGEST_SLICE = 1024
PARAM_LEAVES = 128
DIGEST_DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()          # LAUNCHES, LEAVES


def reset_launches():
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LEAVES["digest_blocks"] = 0


def _count(name: str):
    with _lock:
        LAUNCHES[name] += 1


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _blk_ok(nblk: int, blk: int):
    if blk % 4 or blk <= 0 or blk * 4 > 200 * 1024 or nblk >= 2 ** 31:
        raise ValueError(f"unsupported codec geometry [{nblk}, {blk}]: blk "
                         f"must be a positive multiple of 4 up to 51200")


def _launch(name: str, fn, *args):
    LIB.call(fn, *args)
    _count(name)


def delta_encode_digest(x, prev, weights):
    """K1. x, prev: [nblk, blk] fp32; weights: [2, blk] int32 (uint32
    bits). -> (q int8, scale f32 [nblk], dirty bool [nblk], h1, h2 int32
    [nblk] holding uint32 bits)."""
    if x.device.type == "cpu":
        return ref.delta_encode_digest_ref(x, prev, weights)
    nblk, blk = x.shape
    _blk_ok(nblk, blk)
    _check(x, "x", torch.float32, (nblk, blk))
    _check(prev, "prev", torch.float32, (nblk, blk))
    _check(weights, "weights", torch.int32, (2, blk))
    with torch.cuda.device(x.device):
        q = torch.empty((nblk, blk), dtype=torch.int8, device=x.device)
        scale = torch.empty(nblk, dtype=torch.float32, device=x.device)
        dirty = torch.empty(nblk, dtype=torch.bool, device=x.device)
        h1 = torch.empty(nblk, dtype=torch.int32, device=x.device)
        h2 = torch.empty(nblk, dtype=torch.int32, device=x.device)
        _launch("delta_encode_digest", "ckpt_delta_encode_digest",
                x.data_ptr(), prev.data_ptr(), weights.data_ptr(),
                q.data_ptr(), scale.data_ptr(), dirty.data_ptr(),
                h1.data_ptr(), h2.data_ptr(), nblk, blk, stream_of(x))
    return q, scale, dirty, h1, h2


def delta_encode(x, prev):
    """K4. x, prev: [nblk, blk] fp32 -> (q int8, scale f32, dirty bool)."""
    if x.device.type == "cpu":
        return ref.delta_encode_ref(x, prev)
    nblk, blk = x.shape
    _blk_ok(nblk, blk)
    _check(x, "x", torch.float32, (nblk, blk))
    _check(prev, "prev", torch.float32, (nblk, blk))
    with torch.cuda.device(x.device):
        q = torch.empty((nblk, blk), dtype=torch.int8, device=x.device)
        scale = torch.empty(nblk, dtype=torch.float32, device=x.device)
        dirty = torch.empty(nblk, dtype=torch.bool, device=x.device)
        _launch("delta_encode", "ckpt_delta_encode",
                x.data_ptr(), prev.data_ptr(), q.data_ptr(),
                scale.data_ptr(), dirty.data_ptr(), nblk, blk, stream_of(x))
    return q, scale, dirty


def bf16_encode_digest(x, weights):
    """K2. x: [nblk, blk] fp32; weights: [2, blk] int32.
    -> (y bf16 [nblk, blk], h1, h2 int32 [nblk] holding uint32 bits)."""
    if x.device.type == "cpu":
        return ref.bf16_encode_digest_ref(x, weights)
    nblk, blk = x.shape
    _blk_ok(nblk, blk)
    _check(x, "x", torch.float32, (nblk, blk))
    _check(weights, "weights", torch.int32, (2, blk))
    with torch.cuda.device(x.device):
        y = torch.empty((nblk, blk), dtype=torch.bfloat16, device=x.device)
        h1 = torch.empty(nblk, dtype=torch.int32, device=x.device)
        h2 = torch.empty(nblk, dtype=torch.int32, device=x.device)
        _launch("bf16_encode_digest", "ckpt_bf16_encode_digest",
                x.data_ptr(), weights.data_ptr(), y.data_ptr(),
                h1.data_ptr(), h2.data_ptr(), nblk, blk, stream_of(x))
    return y, h1, h2


def delta_decode(q, scale, prev):
    """K3. q: [nblk, blk] int8; scale: [nblk] f32; prev: [nblk, blk] f32.
    -> fma(q, scale[blk], prev) (fp32, rounded once)."""
    if q.device.type == "cpu":
        return ref.delta_decode_ref(q, scale, prev)
    nblk, blk = q.shape
    _blk_ok(nblk, blk)
    _check(q, "q", torch.int8, (nblk, blk))
    _check(scale, "scale", torch.float32, (nblk,))
    _check(prev, "prev", torch.float32, (nblk, blk))
    with torch.cuda.device(q.device):
        out = torch.empty((nblk, blk), dtype=torch.float32, device=q.device)
        _launch("delta_decode", "ckpt_delta_decode",
                q.data_ptr(), scale.data_ptr(), prev.data_ptr(),
                out.data_ptr(), nblk, blk, stream_of(q))
    return out


class DigestPlan(NamedTuple):
    """A list of leaves laid out for K5: ``leaves`` contiguous and 16-byte
    aligned (a view that is not was copied), so a leaf's memory is its
    flat elements; ``cols`` each leaf's (first column, blocks) in the [4,
    total] lanes, ``max(1, ceil(n / blk))`` blocks, so an empty leaf is
    one zero block."""
    leaves: tuple
    cols: tuple
    total: int
    blk: int


def plan_digest(leaves, blk: int) -> DigestPlan:
    """Lay out fp32/bf16 tensors (any shape) for ``digest_blocks_many``;
    both routes take the same plan. It runs on the host before the launch,
    once a leaf, so it touches no tensor it need not copy."""
    kept, cols, total = [], [], 0
    for x in leaves:
        if x.dtype not in DIGEST_DTYPES:
            raise TypeError(f"digest_blocks takes fp32 or bf16, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            x = x.detach().clone(memory_format=torch.contiguous_format)
        k = max(1, -(-x.numel() // blk))
        kept.append(x)
        cols.append((total, k))
        total += k
    return DigestPlan(tuple(kept), tuple(cols), total, blk)


def leaf_rows(plan: DigestPlan) -> np.ndarray:
    """K5's leaf table, int64 [L, 3]: data pointer (| 1 for bf16),
    elements, first output column."""
    return np.array([(x.data_ptr() | int(x.dtype == torch.bfloat16),
                      x.numel(), c) for x, (c, _) in zip(plan.leaves,
                                                         plan.cols)],
                    dtype=np.int64).reshape(-1, 3)


def digest_blocks_many(leaves, weights):
    """K5. leaves: fp32 or bf16 tensors on one device (or their
    ``plan_digest``); weights: [2, blk] int32. -> lanes int32 [4, total]
    holding uint32 bits, leaf i in columns ``cols[i]`` of its plan: rows
    0-1 the digest of each block of the leaf's fp32 bit patterns (bf16
    widened exactly) as the Pallas kernel computes it, rows 2-3 the
    classifier's mixed lanes (ref.mixed_lanes_ref), elements past a leaf's
    end counting as zero. On the card one launch digests the whole list,
    reading ragged last blocks in place; on the CPU the plain version pads
    a copy of each leaf."""
    blk = weights.shape[-1]
    plan = leaves if isinstance(leaves, DigestPlan) else \
        plan_digest(leaves, blk)
    if not plan.leaves:
        raise ValueError("digest_blocks_many: no leaves")
    devices = {x.device for x in plan.leaves}
    if len(devices) != 1:
        raise ValueError(f"digest_blocks_many: leaves on {len(devices)} "
                         f"devices ({sorted(map(str, devices))}); one call "
                         f"takes one device")
    if plan.leaves[0].device.type != "cpu":
        return _digest_many_cuda(plan, weights)
    out = torch.empty((4, plan.total), dtype=torch.int32)
    for x, (c, k) in zip(plan.leaves, plan.cols):
        xb = F.pad(x.detach().reshape(-1), (0, k * blk - x.numel()))
        xb = xb.reshape(k, blk)
        out[:, c:c + k] = torch.stack([*ref.digest_blocks_ref(xb, weights),
                                       *ref.mixed_lanes_ref(xb, weights)])
    return out


def _digest_many_cuda(plan: DigestPlan, weights, lib=LIB):
    """One K5 launch over the plan (``lib``: a build of the same entry
    point; only ``LIB``'s launches are counted). Its host work comes
    before the launch and is not hidden behind the card's, so it is kept
    to the checks and one allocation."""
    x0, blk = plan.leaves[0], plan.blk
    dev = x0.device
    if dev.type != "cuda":
        raise ValueError(f"x: expected a CUDA tensor, got {dev}")
    if blk <= 0 or blk % DIGEST_SLICE or blk * 4 > 200 * 1024:
        raise ValueError(f"unsupported digest geometry [{plan.total}, {blk}]"
                         f": blk must be a positive multiple of "
                         f"{DIGEST_SLICE} up to 51200")
    _check(weights, "weights", torch.int32, (2, blk))
    if weights.device != dev:
        raise ValueError(f"weights on {weights.device}, leaves on {dev}")
    rows = leaf_rows(plan)
    ctx = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
           else contextlib.nullcontext())
    with ctx:
        # zeroed by the entry point, on the stream, before the launch
        out = torch.empty((4, plan.total), dtype=torch.int32, device=dev)
        dev_rows = None
        if len(rows) > PARAM_LEAVES:
            dev_rows = torch.from_numpy(rows).pin_memory().to(
                dev, non_blocking=True)
        lib.call("ckpt_digest_leaves", rows.__array_interface__["data"][0],
                 len(rows), None if dev_rows is None else dev_rows.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), plan.total, blk,
                 stream_of(x0))
    if lib is LIB:
        with _lock:
            LAUNCHES["digest_blocks"] += 1
            LEAVES["digest_blocks"] += len(rows)
    return out


def digest_blocks(x, weights):
    """K5's one-leaf case. x: fp32 or bf16 (any shape, n elements);
    weights: [2, blk] int32. -> lanes int32 [4, max(1, ceil(n / blk))]
    (``digest_blocks_many``)."""
    return digest_blocks_many([x], weights)
