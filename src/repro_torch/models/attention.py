"""Attention: GQA projections + RoPE/qk-norm, the online-softmax
("flash in XLA") chunked implementation, its block-windowed path for
sliding-window layers, and decode attention over a KV cache — ported from
the JAX package's models/attention.py with the same chunking, the same
-1e30 mask and the same -1e9 floor on the running max.

Score and value products take bf16 (or fp32) inputs and accumulate and
return fp32, as the JAX code asks with ``preferred_element_type``: the
inputs are upcast and multiplied in fp32, which is exact for bf16 inputs.

Where each runs: training uses ``xla_flash`` (K6 has no backward yet);
prefill calls the torch op ``repro_torch::flash_attention_fwd``
(``kernels.flash_attention.ops.flash_attention``) on every device: the
Hopper kernel K6 on a CUDA tensor, ``xla_flash`` on a CPU one, K6's
shape rules and an empty output on ``meta``; decode uses
``decode_attention`` (plain torch ops).

Under autograd every chunk step of ``_dense_flash`` and ``_windowed`` is
checkpointed, as the JAX package's are: the backward pass recomputes a
chunk's scores instead of keeping them (O(S^2) in all), and keeps only
each step's inputs and the O(S) online-softmax carries.

On DTensors (a multi-device mesh) ``xla_flash`` runs on each rank's own
batch rows and heads (``sharding.local_heads``), GQA's K/V taken by the
rank's head offset (``sharding.repeat_kv``); ``decode_attention`` over a
cache split on the sequence reduces its softmax across the shards
(split-K).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as pm
from repro_torch.models.layers import apply_rope, checkpointed, rms_norm

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
              softcap: float = 0.0, chunk_q: int = 512, chunk_kv: int = 1024,
              q_offset: int = 0):
    """Online-softmax attention, O(chunk) memory in sequence length.

    q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (GQA: KV divides H, repeated here);
    query row i sits at position ``q_offset + i``. ``window`` > 0 uses the
    block-windowed path: per-q-chunk slice of the KV stream -> flops
    O(S*(W+cq)) instead of O(S^2)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = shd.repeat_kv(k, H // KV, q)
        v = shd.repeat_kv(v, H // KV, q)

    def attend(q, k, v):
        q = q * torch.tensor(hd ** -0.5, dtype=q.dtype)
        if window and causal and window < k.shape[1]:
            return _windowed(q, k, v, window, softcap, chunk_q, q_offset)
        return _dense_flash(q, k, v, causal, window, softcap, chunk_q,
                            chunk_kv, q_offset)
    # on DTensors each rank attends its own batch rows and heads
    return shd.local_heads(attend, q, k, v)


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


def _dense_flash(q, k, v, causal, window, softcap, chunk_q, chunk_kv,
                 q_offset):
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    cq, ckv = _chunk(Sq, chunk_q), _chunk(Skv, chunk_kv)
    nq, nkv = Sq // cq, Skv // ckv
    dev = q.device
    q5 = q.reshape(B, nq, cq, H, hd)
    qpos = (q_offset + torch.arange(Sq, device=dev)).reshape(nq, cq)[
        None, :, :, None, None]

    # one KV chunk against every query chunk; checkpointed, so the backward
    # pass recomputes the chunk's scores (the flash-attention backward
    # strategy) instead of keeping them
    def step(m, l, acc, q5, kc, vc, j):
        s = _scores(q5, kc, softcap)                          # [B,nq,cq,H,ckv]
        kpos = (j * ckv + torch.arange(ckv, device=dev))[
            None, None, None, None, :]
        mask = torch.ones(s.shape, dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (qpos >= kpos)
        if window:
            mask = mask & (qpos - kpos < window)
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        return _online_update((m, l, acc), s, vc)

    m = torch.full((B, nq, cq, H), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nq, cq, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, cq, H, hd), dtype=torch.float32, device=dev)
    for j in range(nkv):
        m, l, acc = checkpointed(step, m, l, acc, q5,
                                 k[:, j * ckv:(j + 1) * ckv],
                                 v[:, j * ckv:(j + 1) * ckv], j)
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _windowed(q, k, v, window, softcap, chunk_q, q_offset):
    """Sliding-window attention: per-q-chunk slice of a front-padded KV
    stream; static slice size (W + cq) -> real flop saving."""
    B, Sq, H, hd = q.shape
    cq = _chunk(Sq, chunk_q)
    nq = Sq // cq
    W = window
    dev = q.device
    pad = torch.zeros((B, W) + tuple(k.shape[2:]), dtype=k.dtype, device=dev)
    kp = torch.cat([pad, k], dim=1)                           # [B, W+Skv, H, hd]
    vp = torch.cat([pad.to(v.dtype), v], dim=1)

    # one query chunk; checkpointed, so the backward pass recomputes its
    # scores instead of keeping them
    def one_chunk(qc, kc, vc, start):
        s = torch.einsum("bchd,bkhd->bchk", qc.to(torch.float32),
                         kc.to(torch.float32))
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qpos = (start + torch.arange(cq, device=dev))[None, :, None, None]
        kpos = (start - W + torch.arange(W + cq, device=dev))[
            None, None, None, :]
        valid = (qpos >= kpos) & (qpos - kpos < W) & (kpos >= 0)
        s = torch.where(valid, s, torch.full_like(s, _NEG))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bchk,bkhd->bchd",
                            p.to(vc.dtype).to(torch.float32),
                            vc.to(torch.float32))

    outs = []
    for n in range(nq):
        # q rows [n*cq, n*cq+cq); allowed k in (q-W, q]; padded index base n*cq
        start = n * cq + q_offset
        outs.append(checkpointed(one_chunk, q[:, n * cq:(n + 1) * cq],
                                 kp[:, start:start + W + cq],
                                 vp[:, start:start + W + cq], start))
    return torch.cat(outs, dim=1).to(q.dtype)


# --------------------------------------------------------------------- decode
def decode_attention(q, k_cache, v_cache, kv_len, *, softcap: float = 0.0,
                     window: int = 0):
    """One-token attention over a KV cache.

    q [B,1,H,hd]; caches [B,S,KV,hd]; kv_len: number of valid cache
    entries (int or 0-d tensor). GQA is handled without materializing
    repeated KV (grouped einsum) — decode is memory-bound, the cache is
    read once."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if shd.is_dtensor(q):
        # the cache keeps its heads whole and splits the sequence over
        # ``model``: the one token's query joins it with every head
        q = shd.heads_whole(q)
    q5 = q.reshape(B, KV, G, hd) * torch.tensor(hd ** -0.5, dtype=q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", q5.to(torch.float32),
                     k_cache.to(torch.float32))               # [B,KV,G,S]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    valid = pos < kv_len
    if window:
        valid = valid & (pos > kv_len - 1 - window)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    if shd.is_dtensor(s):
        # the cache is sharded over ``model`` on the sequence: split-K
        # (flash-decoding). Each rank takes its slice's exponentials
        # against the all-reduced max; the sum and the value product are
        # partial sums, all-reduced. No rank gathers the cache.
        m = shd.reduce_partial(s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m)
        den = shd.reduce_partial(e.sum(dim=-1, keepdim=True))
        out = torch.einsum("bkgs,bskd->bkgd",
                           e.to(v_cache.dtype).to(torch.float32),
                           v_cache.to(torch.float32))
        out = shd.reduce_partial(out) / den
        return out.reshape(B, 1, H, hd).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)
