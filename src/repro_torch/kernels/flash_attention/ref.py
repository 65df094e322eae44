"""Plain torch version of the flash-attention kernel: materialized scores,
exact masks, as the JAX package's ``reference_attention``. O(S^2) memory —
test shapes, and the card's check of K6 at the serving shape."""
from __future__ import annotations

import torch


def reference_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd]; returns [B,Sq,H,hd].
    Positions assume q occupies the LAST Sq slots of the Skv stream
    (q_offset = Skv - Sq), matching decode/prefill semantics. Products take
    the inputs upcast to fp32 (exact for bf16) and accumulate in fp32."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    q_off = Skv - Sq
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (hd ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dev = q.device
    qpos = (q_off + torch.arange(Sq, device=dev))[None, None, :, None]
    kpos = torch.arange(Skv, device=dev)[None, None, None, :]
    mask = torch.ones((1, 1, Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, torch.full((), -1e30, device=dev))
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)
