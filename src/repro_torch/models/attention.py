"""Attention: GQA projections + RoPE/qk-norm and the online-softmax
("flash in XLA") chunked implementation for training, ported from the JAX
package's models/attention.py with the same chunking, the same -1e30 mask
and the same -1e9 floor on the running max.

Score and value products take bf16 (or fp32) inputs and accumulate and
return fp32, as the JAX code asks with ``preferred_element_type``: the
inputs are upcast and multiplied in fp32, which is exact for bf16 inputs.
The sliding-window path and decode attention are not ported yet (qwen3
uses neither); the Pallas flash kernel is not on any model path.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pm
from repro_torch.models.layers import apply_rope, rms_norm

_NEG = -1e30
_MFLOOR = -1e9  # clamp for the online-softmax running max (fully-masked rows)


# ------------------------------------------------------------------ qkv specs
def mha_specs(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    t = {
        "wq": pm.dense((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": pm.dense((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": pm.dense((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": pm.dense((h, hd, d), ("heads", "head_dim", "embed"), fan_in=h * hd),
    }
    if cfg.qk_norm:
        t["q_norm"] = pm.scale_ones(hd)
        t["k_norm"] = pm.scale_ones(hd)
    return t


def project_qkv(p, x, cfg: ModelConfig, positions):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] with rope + optional qk-norm."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def out_proj(p, attn_out):
    return torch.einsum("bshk,hkd->bsd", attn_out, p["wo"].to(attn_out.dtype))


# ------------------------------------------------------- online-softmax flash
def _chunk(n: int, c: int) -> int:
    """Largest chunk <= c dividing n (tiny smoke shapes -> single chunk)."""
    c = min(c, n)
    while n % c:
        c -= 1
    return c


def xla_flash(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, chunk_q: int = 512, chunk_kv: int = 1024):
    """Online-softmax attention, O(chunk) memory in sequence length.

    q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (GQA: KV divides H, repeated here)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    scale = hd ** -0.5
    q = q * torch.tensor(scale, dtype=q.dtype)
    if window and causal and window < k.shape[1]:
        raise NotImplementedError(
            "sliding-window attention is not ported to repro_torch yet")
    return _dense_flash(q, k, v, causal, window, softcap, chunk_q, chunk_kv)


def _scores(qc, kc, softcap):
    s = torch.einsum("bnchd,bkhd->bnchk", qc.to(torch.float32),
                     kc.to(torch.float32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def _online_update(carry, s, vc):
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.clamp_min(m_new, _MFLOOR)
    p = torch.exp(s - m_safe[..., None])                      # [B,n,c,H,k]
    corr = torch.exp(torch.clamp_min(m, _MFLOOR) - m_safe)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bnchk,bkhd->bnchd", p.to(vc.dtype).to(torch.float32),
        vc.to(torch.float32))
    return m_new, l, acc


def _dense_flash(q, k, v, causal, window, softcap, chunk_q, chunk_kv):
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    cq, ckv = _chunk(Sq, chunk_q), _chunk(Skv, chunk_kv)
    nq, nkv = Sq // cq, Skv // ckv
    dev = q.device
    q5 = q.reshape(B, nq, cq, H, hd)
    qpos = torch.arange(Sq, device=dev).reshape(nq, cq)[None, :, :, None, None]

    m = torch.full((B, nq, cq, H), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nq, cq, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, cq, H, hd), dtype=torch.float32, device=dev)
    for j in range(nkv):
        kc = k[:, j * ckv:(j + 1) * ckv]
        vc = v[:, j * ckv:(j + 1) * ckv]
        s = _scores(q5, kc, softcap)                          # [B,nq,cq,H,ckv]
        kpos = (j * ckv + torch.arange(ckv, device=dev))[
            None, None, None, None, :]
        mask = torch.ones(s.shape, dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (qpos >= kpos)
        if window:
            mask = mask & (qpos - kpos < window)
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m, l, acc = _online_update((m, l, acc), s, vc)
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)
