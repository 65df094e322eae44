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

All four stream HBM once (~9 B/element for K1, K3, K4 and 6 B/element for
K2) with a few operations per element: they are bound by memory
bandwidth. One CTA per codec block; see the .cu file for the design and
the rounding rules that keep them bit-identical to ``ref.py``.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are
not counted), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, stream_of
from repro_torch.kernels.ckpt_codec import ref

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = Library(
    "ckpt_codec", Path(__file__).resolve().parent / "csrc" / "ckpt_codec.cu",
    {"ckpt_delta_encode_digest": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P],
     "ckpt_delta_encode": [_P, _P, _P, _P, _P, _LL, _I, _P],
     "ckpt_bf16_encode_digest": [_P, _P, _P, _P, _P, _LL, _I, _P],
     "ckpt_delta_decode": [_P, _P, _P, _P, _LL, _I, _P],
     "ckpt_digest_blocks": [_P, _P, _P, _LL, _LL, _I, _I, _P]},
    error_fn="ckpt_error_string")

KERNELS = ("delta_encode_digest", "bf16_encode_digest", "delta_decode",
           "delta_encode", "digest_blocks")
LAUNCHES = {k: 0 for k in KERNELS}

_lock = threading.Lock()          # LAUNCHES


def reset_launches():
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


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


def digest_blocks(x, weights):
    """K5. x: flat fp32 or bf16 (any length n); weights: [2, blk] int32.
    -> lanes int32 [4, max(1, ceil(n / blk))] holding uint32 bits: rows
    0-1 the digest of each block of x's fp32 bit patterns (bf16 widened
    exactly) as the Pallas kernel computes it, rows 2-3 the classifier's
    mixed lanes (ref.mixed_lanes_ref), elements past n counting as zero.
    The kernel reads the ragged last block in place; the plain version
    pads a copy."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"digest_blocks takes fp32 or bf16, got {x.dtype}")
    blk = weights.shape[-1]
    n = x.numel()
    nblk = max(1, -(-n // blk))
    if x.device.type == "cpu":
        xb = torch.nn.functional.pad(x.reshape(-1), (0, nblk * blk - n))
        xb = xb.reshape(nblk, blk)
        return torch.stack([*ref.digest_blocks_ref(xb, weights),
                            *ref.mixed_lanes_ref(xb, weights)])
    _blk_ok(nblk, blk)
    if blk % 8:
        raise ValueError(f"unsupported digest geometry [{nblk}, {blk}]: "
                         f"blk must be a multiple of 8")
    _check(x, "x", x.dtype, (n,))
    _check(weights, "weights", torch.int32, (2, blk))
    with torch.cuda.device(x.device):
        out = torch.empty((4, nblk), dtype=torch.int32, device=x.device)
        _launch("digest_blocks", "ckpt_digest_blocks",
                x.data_ptr(), weights.data_ptr(), out.data_ptr(), n, nblk,
                blk, int(x.dtype == torch.bfloat16), stream_of(x))
    return out
