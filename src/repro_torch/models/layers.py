"""Shared layers: norms, rotary embeddings, MLPs, embedding/head.

Same math and dtypes as the JAX package's models/layers.py, written on
tensors. M-RoPE (qwen2-vl) is not ported yet: qwen3 does not use it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pm


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * scale.to(torch.float32)).to(dt)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


# --------------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float, sections: tuple = ()):
    """x: [B, S, H, D]; positions: [B, S]."""
    if sections or positions.ndim != 2:
        raise NotImplementedError("M-RoPE is not ported to repro_torch yet")
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    angles = positions.to(torch.float32)[..., None] * freqs   # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]                    # [B, S, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ MLP
def mlp_specs(cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    t = {"w_up": pm.dense((d, d_ff), ("embed", "mlp")),
         "w_down": pm.dense((d_ff, d), ("mlp", "embed"), fan_in=d_ff)}
    if cfg.glu:
        t["w_gate"] = pm.dense((d, d_ff), ("embed", "mlp"))
    return t


def _act(x, kind: str):
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp_apply(p, x, cfg: ModelConfig):
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if cfg.glu:
        up = _act(x @ p["w_gate"].to(dt), cfg.activation) * up
    else:
        up = _act(up, cfg.activation)
    return up @ p["w_down"].to(dt)


# ------------------------------------------------------------ embedding/head
def embed_specs(cfg: ModelConfig):
    v, d = cfg.padded_vocab, cfg.d_model
    t = {"tok": pm.ParamSpec((v, d), ("vocab", "embed"), "normal",
                             float(d) ** -0.5)}
    if not cfg.tie_embeddings:
        t["head"] = pm.dense((d, v), ("embed", "vocab"))
    return t


def embed_lookup(p, tokens, cfg: ModelConfig, dtype=torch.bfloat16):
    # gather, then cast: the same values as casting the table first, without
    # a bf16 copy of the whole [V, d] table
    emb = F.embedding(tokens, p["tok"]).to(dtype)
    if cfg.tie_embeddings:  # gemma-style scaling for tied tables
        emb = emb * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return emb


def unembed(p, x, cfg: ModelConfig):
    w = p["head"] if not cfg.tie_embeddings else p["tok"].T
    logits = x @ w.to(x.dtype)
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padded vocab columns
        mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits
