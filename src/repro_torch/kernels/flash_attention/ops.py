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


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (GQA); q holds the last Sq
    positions of the kv stream. The copies that make the inputs
    contiguous are made here, outside the op, as the card needs them."""
    return torch.ops.repro_torch.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
        int(window), float(softcap))
