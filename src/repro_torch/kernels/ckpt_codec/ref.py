"""Plain torch versions of the checkpoint delta codec + per-block digest.

These are the oracles the CUDA kernels (``ckpt_codec.py``) are held to,
bit for bit, and the path a CPU tensor takes. They compute what the JAX
package's ``repro.kernels.ckpt_codec.ref`` computes *as the JAX package
runs it* — jitted by XLA, inside ``ops.delta_encode``/``delta_decode``, the
device codec and the Pallas kernels — so both packages write the same
image bytes and restore the same values:

  * ``scale = amax * fl32(1/127)``: XLA rewrites the division by the
    constant 127 into a multiplication by its fp32 reciprocal (the eager,
    op-by-op ref divides, and differs in the last bit for ~5% of blocks);
  * ``inv = 1 / max(scale, 1e-30)`` is an IEEE division, written with
    full tensors: PyTorch's CUDA division by a Python scalar multiplies
    by the reciprocal instead;
  * ``torch.round`` rounds half to even, as ``jnp.round`` does;
  * decode is ``fma(q, scale, prev)``, rounded once: XLA:CPU contracts
    ``prev + q*scale`` into an FMA. torch exposes no fp32 FMA, so
    ``_fma32`` computes it exactly in float64 (the product of an int8
    and an fp32 is exact there) and repairs the one case where rounding
    the float64 sum to fp32 rounds twice: a sum on an fp32 midpoint.

Torch has little uint32 arithmetic, so the digest lanes are computed in
int64 and masked with ``& 0xFFFFFFFF``: units are <= 0xFFFF and weights
< 2^32, so each product is < 2^48 and a 16384-unit block sum < 2^62.
The 32-bit units of ``digest_blocks_ref`` (fp32 bit patterns) are split
into 16-bit halves, each summed that way: ``u*w = lo*w + (hi*w << 16)``
mod 2^32. The lanes come back as int32 tensors holding the uint32 bit
patterns (the kernels write uint32 into the same int32 storage).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
INV127 = 1.0 / 127.0   # rounded to fp32 where used: 0x3C010204


def _as_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32-bit pattern."""
    return (((v + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _lane_sums(units: torch.Tensor, weights: torch.Tensor):
    """units: [nblk, blk] int64 in [0, 2^16); weights: [2, blk] int32
    holding uint32 bits. -> (h1, h2) int64 [nblk] in [0, 2^32)."""
    w = weights.to(torch.int64) & _M32
    h1 = (units * w[0][None, :]).sum(dim=1) & _M32
    h2 = (units * w[1][None, :]).sum(dim=1) & _M32
    return h1, h2


def _digest_lanes(units: torch.Tensor, weights: torch.Tensor):
    """units: [nblk, blk] int64 in [0, 2^16); weights: [2, blk] int32
    holding uint32 bits. -> (h1, h2) int32 [nblk] (uint32 bits)."""
    h1, h2 = _lane_sums(units, weights)
    return _as_i32_bits(h1), _as_i32_bits(h2)


def delta_encode_ref(x: torch.Tensor, prev: torch.Tensor):
    """x, prev: [nblk, blk] fp32 (or bf16).
    -> (q int8 [nblk, blk], scale f32 [nblk], dirty bool [nblk])."""
    d = x.to(torch.float32) - prev.to(torch.float32)
    amax = d.abs().amax(dim=1)
    dirty = amax > 0.0
    zero = torch.zeros_like(amax)
    scale = torch.where(dirty, amax * torch.full_like(amax, INV127), zero)
    inv = torch.where(
        dirty, torch.ones_like(scale) / torch.clamp_min(scale, 1e-30), zero)
    q = torch.clamp(torch.round(d * inv[:, None]), -127, 127)
    return q.to(torch.int8), scale, dirty


def delta_encode_digest_ref(x, prev, weights):
    """delta_encode_ref + per-block digest of the int8 payload bytes.
    -> (q, scale, dirty, h1, h2)."""
    q, scale, dirty = delta_encode_ref(x, prev)
    units = q.to(torch.int64) & 0xFF
    h1, h2 = _digest_lanes(units, weights)
    return q, scale, dirty, h1, h2


def bf16_encode_digest_ref(x, weights):
    """fp32 -> bf16 (round to nearest even) + digest of the bf16 bit
    patterns. -> (y bf16 [nblk, blk], h1, h2)."""
    y = x.to(torch.bfloat16)
    units = y.view(torch.int16).to(torch.int64) & 0xFFFF
    h1, h2 = _digest_lanes(units, weights)
    return y, h1, h2


def _lanes32(units: torch.Tensor, weights: torch.Tensor):
    """_digest_lanes for 32-bit units, summed as two 16-bit halves."""
    lo1, lo2 = _lane_sums(units & 0xFFFF, weights)
    hi1, hi2 = _lane_sums(units >> 16, weights)
    return (_as_i32_bits((lo1 + (hi1 << 16)) & _M32),
            _as_i32_bits((lo2 + (hi2 << 16)) & _M32))


def _fp32_units(x):
    """[nblk, blk] fp32 or bf16 -> int64 fp32 bit patterns in [0, 2^32)."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _M32


def digest_blocks_ref(x, weights):
    """Lanes over the fp32 bit patterns of each block, as the JAX
    package's ``digest_blocks_ref``: x [nblk, blk] fp32 or bf16 (widened
    to fp32 exactly first); weights [2, blk] int32 holding uint32 bits.
    -> (h1, h2) int32 [nblk] holding uint32 bits."""
    return _lanes32(_fp32_units(x), weights)


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 a in [0, 2^32), in 16-bit halves so no
    product leaves int64."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def fmix32(h):
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2^32): a
    bijection that spreads every input bit over every output bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mixed_lanes_ref(x, weights):
    """The classifier's second lane pair, which K5 computes in the same
    pass: lanes over ``fmix32(bits + w_1[i])`` instead of the raw bits.
    The raw lanes are linear in the bits, so a change that is uniform over
    a block (a constant, a power-of-two scale, a sign flip of every
    element) cancels whenever the block's weight sum has enough factors of
    two; keyed by position and mixed, the same change is unstructured.
    -> (g1, g2) int32 [nblk] holding uint32 bits."""
    w1 = weights[0].to(torch.int64) & _M32
    return _lanes32(fmix32((_fp32_units(x) + w1[None, :]) & _M32), weights)


def _fma32(a, b, c):
    """fp32 a*b + c rounded once, for a*b exact in float64."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    t = s - p                                   # TwoSum: s + err == p + c
    err = (p - (s - t)) + (c64 - t)
    r = s.to(torch.float32)
    away = torch.where(s > r.to(torch.float64), torch.inf, -torch.inf)
    n = torch.nextafter(r, away.to(torch.float32))
    tie = (s == (r.to(torch.float64) + n.to(torch.float64)) * 0.5) & (err != 0)
    # on a tie the exact value lies past the midpoint on err's side
    toward_n = (err > 0) == (n > r)
    return torch.where(tie & toward_n, n, r)


def delta_decode_ref(q, scale, prev):
    """x_hat = fma(q, scale[blk], prev) in fp32, cast to prev's dtype."""
    q32 = q.to(torch.float32)
    s = scale[:, None].expand_as(q32)
    return _fma32(q32, s, prev.to(torch.float32)).to(prev.dtype)
