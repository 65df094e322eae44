"""Public door to the codec kernels: pad flat tensors to whole blocks and
dispatch on the tensor's device (CUDA -> the Hopper kernel, CPU -> the
plain torch version; see ckpt_codec.py). Padding beyond the flat length
encodes as clean and digests as zero (padded units add 0 to the lanes).

  delta_encode / delta_decode              plain codec
  delta_encode_digest / bf16_encode_digest fused encode + per-block digest
  digest_blocks / classifier_lanes         digest-only sweep (classification)
  fold_digest                              per-block lanes -> leaf hex digest
  payload_digest                           numpy re-verification on decode

Digest algorithm ("pmac32x2-v1"): two uint32 polynomial multiply-accumulate
lanes over the encoded payload units of each block, weights r^(i+1) mod 2^32
for two distinct odd multipliers; per-block lane pairs are folded into one
64-bit leaf digest with a second polynomial pass that also binds the element
count (and, for delta8, the scale bit patterns). The fold and the decode
re-verification are numpy, copied from the JAX package, so an image's
digest is the same whichever package wrote or reads it."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ckpt_codec import ckpt_codec

BLOCK = 16384  # fp32 elements per codec block (64 KiB per operand)

DIGEST_ALG = "pmac32x2-v1"
_R1 = np.uint32(0x01000193)   # FNV-1 prime (odd -> invertible mod 2^32)
_R2 = np.uint32(0x5BD1E995)   # MurmurHash2 multiplier (odd, independent)


@functools.lru_cache(maxsize=8)
def _weights_np(block: int) -> np.ndarray:
    """[2, block] uint32: row k holds r_k^(i+1) mod 2^32."""
    w = np.empty((2, block), np.uint32)
    w[0] = np.cumprod(np.full(block, _R1, np.uint32), dtype=np.uint32)
    w[1] = np.cumprod(np.full(block, _R2, np.uint32), dtype=np.uint32)
    return w


@functools.lru_cache(maxsize=8)
def _weights_on(block: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_weights_np(block).view(np.int32)).to(device)


def digest_weights(block: int = BLOCK, device="cpu") -> torch.Tensor:
    """The constant weight table the fused kernels take: [2, block] int32
    holding the uint32 weights' bits, on ``device``."""
    return _weights_on(block, str(torch.device(device)))


def _check_flat(x, prev=None):
    if x.ndim != 1 or (prev is not None and prev.shape != x.shape):
        raise ValueError(f"expected flat tensors of one length, got "
                         f"{tuple(x.shape)} and "
                         f"{None if prev is None else tuple(prev.shape)}")


def _blocked(flat: torch.Tensor, block: int):
    n = flat.shape[0]
    nblk = max(1, -(-n // block))
    pad = nblk * block - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(nblk, block), pad


def delta_encode(x, prev, *, block=BLOCK):
    """Flat tensors (any length) -> (q int8 [nblk,block], scale [nblk],
    dirty [nblk]). Padding beyond len(x) is clean by construction."""
    _check_flat(x, prev)
    xb, _ = _blocked(x, block)
    pb, _ = _blocked(prev, block)
    return ckpt_codec.delta_encode(xb, pb)


def delta_decode(q, scale, prev, *, n=None):
    """Inverse of delta_encode; returns a flat tensor of length n."""
    block = q.shape[1]
    pb, _ = _blocked(prev, block)
    flat = ckpt_codec.delta_decode(q, scale, pb).reshape(-1)
    return flat[:n] if n is not None else flat


def delta_encode_digest(x, prev, *, block=BLOCK):
    """Fused delta8 encode + per-block payload digest in one pass.
    Flat tensors (any length) -> (q int8 [nblk,block], scale f32 [nblk],
    dirty bool [nblk], h1, h2 int32 [nblk] holding uint32 bits)."""
    _check_flat(x, prev)
    xb, _ = _blocked(x, block)
    pb, _ = _blocked(prev, block)
    w = digest_weights(block, x.device)
    return ckpt_codec.delta_encode_digest(xb, pb, w)


def bf16_encode_digest(x, *, block=BLOCK):
    """Fused fp32 -> bf16 cast + per-block bit-pattern digest. Flat tensor
    (any length) -> (y bf16 [nblk,block] — caller slices to length,
    h1, h2 int32 [nblk] holding uint32 bits)."""
    _check_flat(x)
    xb, _ = _blocked(x, block)
    w = digest_weights(block, x.device)
    return ckpt_codec.bf16_encode_digest(xb, w)


def classifier_lanes(x, *, block=BLOCK):
    """The pre-dump classifier's view of a flat fp32 or bf16 tensor: K5's
    four lanes per block, int32 [4, nblk] holding uint32 bits — (h1, h2)
    of digest_blocks and the mixed pair that catches changes uniform over
    a block (see ref.mixed_lanes_ref). A CUDA tensor goes through one K5
    launch where it lies (a misaligned view is copied first), a CPU tensor
    through the plain version."""
    _check_flat(x)
    if x.device.type == "cuda" and (not x.is_contiguous()
                                    or x.data_ptr() % 16):
        x = x.clone(memory_format=torch.contiguous_format)
    return ckpt_codec.digest_blocks(x, digest_weights(block, x.device))


def digest_blocks(x, *, block=BLOCK):
    """Digest-only sweep over a flat fp32 or bf16 tensor -> (h1, h2) int32
    [nblk] holding uint32 bits: the lanes of x zero-padded to whole
    blocks, as the JAX package's ``digest_blocks``."""
    lanes = classifier_lanes(x, block=block)
    return lanes[0], lanes[1]


# --------------------------------------------------- host-side fold / verify
def _powers(r: np.uint32, n: int) -> np.ndarray:
    return np.cumprod(np.full(n, r, np.uint32), dtype=np.uint32)


def fold_digest(h1, h2, scale_bits=None, *, n: int) -> str:
    """Fold per-block lane pairs (+ optional scale bit patterns) into the
    16-hex-char leaf digest stored in codec_meta. Pure numpy — runs on the
    host for both the device encode path and decode verification."""
    v1 = np.asarray(h1).view(np.uint32)
    v2 = np.asarray(h2).view(np.uint32)
    if scale_bits is not None:
        sb = np.asarray(scale_bits).view(np.uint32).reshape(-1)
        v1 = np.concatenate([v1, sb])
        v2 = np.concatenate([v2, sb])
    f1 = int(np.sum(v1 * _powers(_R1, len(v1)), dtype=np.uint32))
    f2 = int(np.sum(v2 * _powers(_R2, len(v2)), dtype=np.uint32))
    f1 = (f1 * int(_R1) + n) & 0xFFFFFFFF   # bind the element count
    f2 = (f2 * int(_R2) + n) & 0xFFFFFFFF
    return f"{f1:08x}{f2:08x}"


def _lanes_np(units: np.ndarray, block: int):
    """units: [nblk, block] uint32 -> per-block (h1, h2) — the numpy twin
    of the kernels' mult-acc, for decode-time re-verification."""
    w = _weights_np(block)
    h1 = np.sum(units * w[0][None, :], axis=1, dtype=np.uint32)
    h2 = np.sum(units * w[1][None, :], axis=1, dtype=np.uint32)
    return h1, h2


_SLAB = 256   # blocks per slab: bounds the uint32 temporaries to 16 MiB


def _lanes_blocks(units: np.ndarray, nblk: int, block: int):
    """units: flat uint8/uint16 payload of at most nblk*block units (the
    tail past its end is zero padding) -> per-block (h1, h2), a slab of
    blocks at a time so a multi-GB leaf needs no leaf-sized temporaries."""
    h1 = np.empty(nblk, np.uint32)
    h2 = np.empty(nblk, np.uint32)
    for s in range(0, nblk, _SLAB):
        e = min(nblk, s + _SLAB)
        part = np.zeros((e - s) * block, np.uint32)
        src = units[s * block:e * block]
        part[:src.size] = src
        h1[s:e], h2[s:e] = _lanes_np(part.reshape(e - s, block), block)
    return h1, h2


def payload_digest(stored: np.ndarray, codec: str, meta: dict) -> str:
    """Recompute the leaf digest from a *stored* (encoded) buffer — what
    decode_leaf checks against codec_meta["digest"]. Layouts mirror
    core/compression.py exactly."""
    block = int(meta.get("block", BLOCK))
    if codec == "delta8":
        flat = np.ascontiguousarray(stored).reshape(-1)
        nblk = int(meta["nblk"])
        scale = flat[:nblk * 4]
        h1, h2 = _lanes_blocks(flat[nblk * 4:].view(np.uint8), nblk, block)
        n = int(np.prod(meta["orig_shape"], dtype=np.int64))
        return fold_digest(h1, h2, scale_bits=scale, n=n)
    if codec == "bf16":
        bits = np.ascontiguousarray(stored).view(np.uint16).reshape(-1)
        n = bits.size
        nblk = max(1, -(-n // block))
        h1, h2 = _lanes_blocks(bits, nblk, block)
        return fold_digest(h1, h2, n=n)
    raise ValueError(f"no payload digest for codec {codec!r} — raw leaves "
                     f"keep the blake2b classifier digest")
