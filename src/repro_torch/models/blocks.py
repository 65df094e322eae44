"""Decoder blocks: specs + train-mode apply for the attention block.

Same tree and math as the JAX package's models/blocks.py. Only the dense
attention block in train mode is ported; MoE and SSM blocks, prefill and
decode modes come with the serving plane.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pm
from repro_torch.models.attention import (mha_specs, out_proj, project_qkv,
                                          xla_flash)
from repro_torch.models.layers import mlp_apply, mlp_specs, rms_norm


def block_specs(kind: str, cfg: ModelConfig):
    if kind != "attn" or cfg.num_experts:
        raise NotImplementedError(
            f"block kind {kind!r} (experts={cfg.num_experts}) is not "
            f"ported to repro_torch yet")
    d = cfg.d_model
    t = {"ln1": pm.scale_ones(d), "ln2": pm.scale_ones(d),
         "attn": mha_specs(cfg), "mlp": mlp_specs(cfg, cfg.d_ff)}
    if cfg.post_norm:
        t["ln1_post"] = pm.scale_ones(d)
        t["ln2_post"] = pm.scale_ones(d)
    return t


def apply_attn_block(p, x, cfg: ModelConfig, *, positions, window):
    """Train-mode attention block: x [B,S,d] -> x."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(p["attn"], h, cfg, positions)
    att = xla_flash(q, k, v, causal=True, window=window,
                    softcap=cfg.attn_softcap,
                    chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    o = out_proj(p["attn"], att)
    if cfg.post_norm:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    o = mlp_apply(p["mlp"], h, cfg)
    if cfg.post_norm:
        o = rms_norm(o, p["ln2_post"], cfg.norm_eps)
    return x + o
