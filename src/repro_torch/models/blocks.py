"""Decoder blocks: specs + apply for each kind (attention, with a dense MLP
or MoE; mamba2, mlstm, slstm), with the JAX package's uniform
(train | prefill | decode) interface:

  apply_block(kind, p, x, cfg, ...) -> (x, new_cache, aux)
  - train:   cache is None, returns (x, None, aux)
  - prefill: K/V written into the given zeroed S_max cache at [0, S); a
             recurrent block writes its final state into the given entry
  - decode:  x is [B, 1, d]; K/V written at position ``pos`` (an int),
             attention over the first pos + 1 entries; a recurrent block
             steps its state once

aux is the MoE load-balance loss of an attention block with experts (an
fp32 scalar), zero for every other block. An MoE block drops tokens over
capacity in train and prefill (``moe_apply``) and runs the dense oracle
in decode (``moe_dense_reference``), as the JAX package does.

Prefill attention is the op ``repro_torch::flash_attention_fwd``
(``kernels.flash_attention.ops``: K6 on a CUDA tensor, ``xla_flash`` on a
CPU one, an empty output on ``meta``); training keeps ``xla_flash``
because K6 has no backward yet. The cache entry is updated in place with
``copy_`` (the JAX package builds a new array): a second copy of a serving
cache would cost as much memory as the cache itself. An unknown block
kind raises.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import params as pm
from repro_torch.models import ssm
from repro_torch.models.attention import (decode_attention, mha_specs,
                                          out_proj, project_qkv, xla_flash)
from repro_torch.models.layers import mlp_apply, mlp_specs, rms_norm
from repro_torch.models.moe import moe_apply, moe_dense_reference, moe_specs

_SSM = {"mamba2": (ssm.mamba2_specs, ssm.mamba2_apply, ssm.mamba2_step,
                   ssm.mamba2_apply_with_state),
        "mlstm": (ssm.mlstm_specs, ssm.mlstm_apply, ssm.mlstm_step,
                  ssm.mlstm_apply_with_state),
        "slstm": (ssm.slstm_specs, ssm.slstm_apply, ssm.slstm_step,
                  ssm.slstm_apply_with_state)}


def _ssm_fns(kind: str):
    if kind not in _SSM:
        raise NotImplementedError(
            f"block kind {kind!r} is not a block of repro_torch (attn, "
            f"{', '.join(_SSM)})")
    return _SSM[kind]


# ---------------------------------------------------------------------- specs
def block_specs(kind: str, cfg: ModelConfig, *, shared: bool = False):
    d = cfg.d_model
    if kind == "attn":
        t = {"ln1": pm.scale_ones(d), "ln2": pm.scale_ones(d),
             "attn": mha_specs(cfg)}
        if shared:
            t["mlp"] = mlp_specs(cfg, cfg.shared_attn_dff,
                                 mlp_axis="shared_mlp")
        elif cfg.num_experts:
            t["moe"] = moe_specs(cfg)
        else:
            t["mlp"] = mlp_specs(cfg, cfg.d_ff)
        if cfg.post_norm:
            t["ln1_post"] = pm.scale_ones(d)
            t["ln2_post"] = pm.scale_ones(d)
        return t
    return {"ln": pm.scale_ones(d), "m": _ssm_fns(kind)[0](cfg)}


# ---------------------------------------------------------------- attn block
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
            if shd.is_dtensor(c):       # sharded over the sequence
                shd.write_at(c, 0, t)
                continue
            c[:, S:].zero_()
            c[:, :S].copy_(t)
        new_cache = cache
    elif mode == "decode":
        shd.write_at(cache["k"], pos, k)
        shd.write_at(cache["v"], pos, v)
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
    """x [B,S,d] -> (x, new_cache, aux); see the module docstring."""
    x, new_cache = _attn_mix(p, x, cfg, positions, window, mode, cache, pos)
    x = shd.constrain_act(x)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        if mode == "decode":
            o = moe_dense_reference(p["moe"], h, cfg)
        else:
            o, aux = moe_apply(p["moe"], h, cfg)
    else:
        o = mlp_apply(p["mlp"], h, cfg)
    if cfg.post_norm:
        o = rms_norm(o, p["ln2_post"], cfg.norm_eps)
    return shd.constrain_act(x + o), new_cache, aux


# ----------------------------------------------------------------- ssm block
def _write_state(cache, state):
    """Copy a recurrent state into its cache entry in place."""
    for name, t in state.items():
        cache[name].copy_(t)
    return cache


def apply_ssm_block(kind: str, p, x, cfg: ModelConfig, *, mode, cache):
    """x [B,S,d] -> (x, new_cache, aux 0); the prefill and decode states
    are written into ``cache`` (a dict of the entry's tensors) in place."""
    _, apply_fn, step_fn, apply_with_state = _ssm_fns(kind)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return shd.constrain_act(x + apply_fn(p["m"], h, cfg)), None, aux
    if mode == "prefill":
        y, state = apply_with_state(p["m"], h, cfg)
        return shd.constrain_act(x + y), _write_state(cache, state), aux
    if mode == "decode":
        y1, state = step_fn(p["m"], h[:, 0], cache, cfg)
        return shd.constrain_act(x + y1[:, None]), \
            _write_state(cache, state), aux
    raise ValueError(f"unknown mode {mode!r}")


def apply_block(kind: str, p, x, cfg: ModelConfig, *, positions, window,
                mode, cache, pos):
    if kind == "attn":
        return apply_attn_block(p, x, cfg, positions=positions, window=window,
                                mode=mode, cache=cache, pos=pos)
    return apply_ssm_block(kind, p, x, cfg, mode=mode, cache=cache)
