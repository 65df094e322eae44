"""Decoder blocks: specs + apply for the attention block, with the JAX
package's uniform (train | prefill | decode) interface:

  apply_attn_block(p, x, cfg, ...) -> (x, new_cache)
  - train:   cache is None, returns (x, None)
  - prefill: K/V written into the given zeroed S_max cache at [0, S)
  - decode:  x is [B, 1, d]; K/V written at position ``pos`` (an int),
             attention over the first pos + 1 entries

Prefill attention goes through ``kernels.flash_attention.ops`` (K6 on a
CUDA tensor, ``xla_flash`` on a CPU one); training keeps ``xla_flash``
because K6 has no backward yet. The cache entry is updated in place (the
JAX package builds a new array): a second copy of a serving cache would
cost as much memory as the cache itself. MoE and SSM blocks are not
ported yet.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import params as pm
from repro_torch.models.attention import (decode_attention, mha_specs,
                                          out_proj, project_qkv, xla_flash)
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


def _attn_mix(p, x, cfg: ModelConfig, positions, window, mode, cache, pos):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(p["attn"], h, cfg, positions)
    new_cache = None
    if mode == "train":
        att = xla_flash(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_softcap,
                        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    elif mode == "prefill":
        att = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap)
        S = k.shape[1]
        for name, t in (("k", k), ("v", v)):
            c = cache[name]
            c[:, S:].zero_()
            c[:, :S].copy_(t)
        new_cache = cache
    elif mode == "decode":
        cache["k"][:, pos:pos + 1].copy_(k)
        cache["v"][:, pos:pos + 1].copy_(v)
        att = decode_attention(q, cache["k"], cache["v"], pos + 1,
                               softcap=cfg.attn_softcap, window=window)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    o = out_proj(p["attn"], att)
    if cfg.post_norm:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    return x + o, new_cache


def apply_attn_block(p, x, cfg: ModelConfig, *, positions, window,
                     mode: str = "train", cache=None, pos=None):
    """x [B,S,d] -> (x, new_cache); see the module docstring for modes."""
    x, new_cache = _attn_mix(p, x, cfg, positions, window, mode, cache, pos)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    o = mlp_apply(p["mlp"], h, cfg)
    if cfg.post_norm:
        o = rms_norm(o, p["ln2_post"], cfg.norm_eps)
    return x + o, new_cache
