"""Shared layers: norms, rotary embeddings (incl. M-RoPE), MLPs,
embedding/head, and ``checkpointed`` (a step run under a checkpoint).

Same math and dtypes as the JAX package's models/layers.py, written on
tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as pm


def checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint when autograd records
    (the JAX package's ``jax.checkpoint`` on a step): the backward pass
    keeps only the tensor arguments and recomputes the rest. Pass every
    activation the step reads as an argument. Without autograd (prefill,
    decode) it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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
    """x: [B, S, H, D]; positions: [B, S] or [3, B, S] for M-RoPE.

    M-RoPE (qwen2-vl): the D/2 frequency slots are split into ``sections``
    (t, h, w); each section rotates with its own position stream. With equal
    position streams this reduces exactly to standard RoPE.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    if positions.ndim == 2:
        pos = positions[None].to(torch.float32)               # [1, B, S]
    else:
        pos = positions.to(torch.float32)                     # [3, B, S]
    if sections:
        assert sum(sections) == d // 2, (sections, d)
        idx = []
        for i, s in enumerate(sections):
            idx.extend([min(i, pos.shape[0] - 1)] * s)
        stream = torch.tensor(idx, device=pos.device)         # [D/2]
        # angles[b, s, j] = pos[stream[j], b, s] * freqs[j]
        angles = pos.index_select(0, stream)                  # [D/2, B, S]
        angles = torch.movedim(angles, 0, -1) * freqs         # [B, S, D/2]
    else:
        angles = pos[0][..., None] * freqs                    # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]                    # [B, S, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ MLP
def mlp_specs(cfg: ModelConfig, d_ff: int, mlp_axis: str = "mlp"):
    d = cfg.d_model
    t = {"w_up": pm.dense((d, d_ff), ("embed", mlp_axis)),
         "w_down": pm.dense((d_ff, d), (mlp_axis, "embed"), fan_in=d_ff)}
    if cfg.glu:
        t["w_gate"] = pm.dense((d, d_ff), ("embed", mlp_axis))
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
    emb = shd.embedding(tokens, p["tok"]).to(dtype)
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
