"""Public door to flash attention: one torch op,
``torch.ops.repro_torch.flash_attention_fwd``, that prefill calls on every
device, so a dispatch mode (``FlopCounterMode``, ``launch/stepcost.py``'s
``StepCost``) sees the attention as one op wherever it runs:

- CUDA: the Hopper kernel K6 (``flash_attention.flash_attention_fwd``),
  counted in its ``LAUNCHES``; a failed build or launch raises;
- CPU: the port's online-softmax path ``models.attention.xla_flash`` with
  the query offset applied — the JAX package's dispatcher, with the
  device in the place of the backend (tests/test_torch_flash.py);
- fake (``meta``, FakeTensor): K6's shape and dtype rules
  (``flash_attention.check_shapes``), then ``torch.empty_like(q)``.

Its FLOP formula is K6's: ``flash_attention.flops``, 4 * B * H * hd over
the pairs the masks leave live. A dispatch mode counts its bytes as its
inputs read and its output written, and its output as all it allocates.

On DTensors (a multi-device mesh) the op has a sharding rule
(``register_sharding``): q, k, v and the output all split alike on each
mesh dim, over the batch (dim 0), over the heads (dim 2), or not at all;
the sequences stay whole. So each rank runs the op, K6 on its card, on
its own batch rows and heads, and the FLOPs counted are the local op's.
GQA's K/V are repeated to the query heads first where the query heads
are split and theirs are not (``sharding.repeat_kv``: each rank takes
its query heads' KV heads by its head offset).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.flash_attention import (
    check_shapes, flash_attention_fwd, flops)

SCHEMA = ("(Tensor q, Tensor k, Tensor v, bool causal, int window, "
          "float softcap) -> Tensor")


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu", schema=SCHEMA)
def _op(q, k, v, causal, window, softcap):
    # models/attention.py imports this package: import inside, not on top
    from repro_torch.models.attention import xla_flash
    return xla_flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     q_offset=k.shape[1] - q.shape[1])


@_op.register_kernel("cuda")
def _(q, k, v, causal, window, softcap):
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap)


@_op.register_fake
def _(q, k, v, causal, window, softcap):
    check_shapes(q, k, v)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, causal=True, window=0, softcap=0.0, *,
      out_shape=None, **kwargs):
    B, Sq, H, hd = q_shape
    return flops(B, Sq, k_shape[1], H, hd, causal, window)


def _sharding_rule():
    """Register the op's DTensor sharding rule (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
    def _(q, k, v, causal, window, softcap):
        return [([p], [p, p, p, None, None, None])
                for p in (Replicate(), Shard(0), Shard(2))]


if torch.distributed.is_available():
    _sharding_rule()


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (GQA); q holds the last Sq
    positions of the kv stream. The copies that make the inputs
    contiguous are made here, outside the op, as the card needs them."""
    from repro_torch.distributed import sharding as shd
    if shd.is_dtensor(q) and k.shape[2] != q.shape[2] and any(
            getattr(p, "dim", None) == 2 for p in q.placements):
        rep = q.shape[2] // k.shape[2]
        k, v = shd.repeat_kv(k, rep, q), shd.repeat_kv(v, rep, q)
    return torch.ops.repro_torch.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
        int(window), float(softcap))
