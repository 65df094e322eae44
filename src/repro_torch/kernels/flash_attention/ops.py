"""Public door to flash attention: a CUDA tensor goes to the Hopper kernel
(K6, flash_attention.py), a CPU tensor to the port's online-softmax path
``models.attention.xla_flash`` — the JAX package's dispatcher, with the
device in the place of the backend. Both compute the same math
(tests/test_torch_flash.py)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (GQA); q holds the last Sq
    positions of the kv stream."""
    if q.device.type == "cuda":
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, softcap=softcap)
    # models/attention.py calls this module: import inside, not at the top
    from repro_torch.models.attention import xla_flash
    return xla_flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     q_offset=k.shape[1] - q.shape[1])
