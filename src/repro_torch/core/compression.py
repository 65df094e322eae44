"""Leaf codecs for checkpoint images.

  none   — raw bytes.
  bf16   — fp32 leaves stored as bf16 (2x, lossy; fine for optimizer moments).
  delta8 — int8 block-delta vs the SAME leaf in the parent image (4x vs fp32,
           lossy, error <= max|delta|/254 per block; clean blocks exact).
           Runs the ckpt_codec kernels (Hopper on CUDA, the plain torch
           versions on the CPU) on the caller's ``device``.

Stored layouts are byte-identical to the JAX package's, so an image
written by either package decodes in the other. bf16 payloads live on
the host as uint16 bit-pattern arrays (``repro_torch.device.BF16``).

Policies map leaf path -> codec; params default to lossless, optimizer
moments may opt into lossy codecs."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import dtype_name, to_device, to_host
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels.ckpt_codec.ops import delta_decode, delta_encode

CODEC_BLOCK = 16384


def _is_f32(dtype) -> bool:
    return dtype_name(dtype) == "float32"


def codec_applicable(codec: str, dtype, shape, prev: np.ndarray | None) -> bool:
    """Pure applicability predicate, evaluated at plan time so the executor
    never has to re-discover that a lossy codec will fall back to raw.
    encode_leaf guards on it too — one predicate, no drift."""
    if codec == "none":
        return True
    if codec == "bf16":
        return _is_f32(dtype)
    if codec == "delta8":
        return (prev is not None and _is_f32(dtype)
                and tuple(prev.shape) == tuple(shape))
    raise ValueError(f"unknown codec {codec!r}")


def encode_leaf(arr: np.ndarray, codec: str, prev: np.ndarray | None = None,
                *, device="cuda"):
    """-> (stored_array, codec_meta). stored_array is what gets chunked.
    The codec runs on ``device``: the host array is moved there first."""
    if codec == "none":
        return arr, {}
    if not codec_applicable(codec, arr.dtype, arr.shape, prev):
        return arr, {"applied": False}
    if codec == "bf16":
        y = to_device(arr, device).to(torch.bfloat16)
        return to_host(y), {"applied": True, "orig_dtype": "float32"}
    if codec == "delta8":
        flat = to_device(arr, device).reshape(-1)
        pflat = to_device(prev, device).reshape(-1)
        q, scale, dirty = delta_encode(flat, pflat, block=CODEC_BLOCK)
        q, scale = to_host(q), to_host(scale)
        stored = np.concatenate([scale.view(np.int8).reshape(-1),
                                 q.reshape(-1)])
        return stored, {"applied": True, "orig_dtype": "float32",
                        "orig_shape": list(arr.shape),
                        "block": CODEC_BLOCK, "nblk": int(q.shape[0]),
                        "dirty_blocks": int(dirty.sum())}
    raise ValueError(f"unknown codec {codec!r}")


def decode_leaf(stored: np.ndarray, codec: str, codec_meta: dict,
                prev=None, *, device="cuda"):
    """Stored payload -> the leaf's value: a host array, except that a
    delta8 leaf decoded on a CUDA ``device`` comes back as the K3 output
    tensor on that device (restore places it where it already is). ``prev``
    is the parent image's leaf, a host array or a tensor."""
    if codec == "none" or not codec_meta.get("applied", False):
        return stored
    if "digest" in codec_meta:
        # device-encoded leaves carry the fused kernels' payload digest:
        # recompute it from the stored bytes before decoding, so a bad
        # device->host transfer or a silently corrupted chunk trips here
        # (on top of — not instead of — SHA-256 chunk verification)
        from repro_torch.core.integrity import CorruptionError
        got = ops.payload_digest(np.asarray(stored), codec, codec_meta)
        if got != codec_meta["digest"]:
            raise CorruptionError(
                codec_meta.get("image_id", "?"),
                [f"payload digest mismatch: {got} != "
                 f"{codec_meta['digest']}"])
    if codec == "bf16":
        bits = np.ascontiguousarray(stored).view(np.int16)
        return to_host(torch.from_numpy(bits).view(torch.bfloat16)
                       .to(torch.float32))
    if codec == "delta8":
        if prev is None:
            raise ValueError("delta8 decode requires the parent leaf")
        nblk, block = codec_meta["nblk"], codec_meta["block"]
        scale_bytes = nblk * 4
        flat = stored.reshape(-1)
        scale = flat[:scale_bytes].view(np.float32)
        q = flat[scale_bytes:].reshape(nblk, block)
        n = int(np.prod(codec_meta["orig_shape"]))
        out = delta_decode(to_device(q, device), to_device(scale, device),
                           to_device(prev, device, torch.float32).reshape(-1),
                           n=n).reshape(codec_meta["orig_shape"])
        return out if out.device.type == "cuda" else to_host(out)
    raise ValueError(f"unknown codec {codec!r}")


def default_policy(lossy_optimizer: bool = False):
    """path -> codec. Master params stay lossless; optimizer moments may
    use delta8 (vs parent) when enabled."""
    def policy(path: str) -> str:
        if lossy_optimizer and (path.startswith("opt/")
                                or "/opt/" in path):
            return "delta8"
        return "none"
    return policy
