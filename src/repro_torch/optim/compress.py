"""Int8 error-feedback gradient compression for the DP reduction path.

The JAX package's optim/compress.py on tensors: plain torch on the leaf's
device, as JAX's is plain ``jnp`` (no kernel). Wire format shares the
ckpt_codec math: blockwise int8 with per-block scales (4x smaller than
fp32 on the wire). Error feedback (Seide et al. 2014; Karimireddy et al.
2019) accumulates the quantization residual locally and re-injects it next
step, preserving convergence to first order. OFF by default, as in the JAX
package: nothing in the train step calls it.

Bitwise equal to the JAX package's functions as they run jitted
(``jax.jit(compress_leaf)``), which is how a JAX train step would run
them. XLA rewrites two operations, and the port computes the rewritten
forms:

  * ``scale = amax * fl32(1/127)``, not ``amax / 127`` (the eager form
    differs in the last bit for some blocks);
  * the residual ``blocks - q * scale`` is one FMA, rounded once
    (``kernels/ckpt_codec/ref._fma32``, exact in float64).

Trees are nested dicts; a compressed leaf is the pair ``(q int8 [nblk,
BLOCK], scale fp32 [nblk])``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ckpt_codec.ref import INV127, _fma32
from repro_torch.models.params import tree_leaves, tree_map

BLOCK = 4096
# blocks per slice: every temporary (the float64 FMA's among them) is one
# slice, 8M elements, so a leaf costs its q and its residual and no more
_SLICE = 2048


def compress_leaf(g, err):
    """(g fp32[*], err fp32[*]) -> (q int8 [nblk,B], scale [nblk], err')."""
    flat = g.reshape(-1) + err.reshape(-1)          # error feedback
    n = flat.shape[0]
    if n % BLOCK:
        flat = torch.nn.functional.pad(flat, (0, (-n) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    nblk = blocks.shape[0]
    q = torch.empty(blocks.shape, dtype=torch.int8, device=blocks.device)
    scale = torch.empty(nblk, dtype=torch.float32, device=blocks.device)
    for i in range(0, nblk, _SLICE):
        b = blocks[i:i + _SLICE]
        amax = b.abs().amax(dim=1)
        live = amax > 0
        zero = torch.zeros_like(amax)
        s = torch.where(live, amax * torch.full_like(amax, INV127), zero)
        inv = torch.where(live, torch.ones_like(s) / torch.clamp_min(s, 1e-30),
                          zero)
        qs = torch.clamp(torch.round(b * inv[:, None]), -127, 127)
        q[i:i + _SLICE] = qs.to(torch.int8)
        scale[i:i + _SLICE] = s
        # the residual overwrites the slice it came from (flat is ours)
        b.copy_(_fma32(-qs, s[:, None].expand_as(qs), b))
    new_err = flat[:n].reshape(g.shape)
    return q, scale, new_err


def decompress_leaf(q, scale, shape):
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape))


def init_error_state(params):
    return tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def compress_tree(grads, err_state):
    """-> (compressed tree of (q, scale), new error state). Wire bytes
    ~= raw/4 + scales."""
    qs = tree_map(lambda path, g: compress_leaf(g, _at(err_state, path)),
                  grads)
    comp = tree_map(lambda _, t: (t[0], t[1]), qs)
    new_err = tree_map(lambda _, t: t[2], qs)
    return comp, new_err


def decompress_tree(comp, like):
    return tree_map(lambda path, c: decompress_leaf(
        c[0], c[1], _at(like, path).shape), comp)


def wire_bytes(comp) -> int:
    total = 0
    for q, s in tree_leaves(comp):
        total += q.numel() + s.numel() * 4
    return total


def _at(tree, path: str):
    for k in path.split("/") if path else ():
        tree = tree[k]
    return tree
