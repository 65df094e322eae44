"""Decode-time state: KV caches for attention layers.

The cache is an ordinary nested dict of tensors, so the checkpoint engine
dumps it like any other job state — a serving session can be dumped,
moved and continued (the paper's "network applications" row). Same tree,
shapes and dtypes as the JAX package's models/kvcache.py:

  {"stack": {"b<j>": {"k": [G, B, S_max, KV, hd], "v": ...}},
   "pos":   int32 scalar (tokens already in cache)}

Recurrent (SSM) entries, zamba2's tail and shared caches, and the slot-pool
helpers (``slot_take`` / ``slot_put``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _check(cfg: ModelConfig):
    kinds = [k for k in cfg.pattern if k != "attn"]
    if kinds or cfg.tail_layers or cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: KV caches for {kinds or 'tail/shared'} entries are "
            f"not ported to repro_torch yet")


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
               device="cuda"):
    """Zeroed cache for B sequences of up to S_max tokens on ``device``."""
    _check(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_groups, B, S_max, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    stack = {f"b{j}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
             for j in range(len(cfg.pattern))}
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "stack": stack}


def cache_struct(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16):
    """The cache's shapes and dtypes on the ``meta`` device (no memory)."""
    _check(cfg)
    shape = (cfg.num_groups, B, S_max, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    stack = {f"b{j}": {"k": torch.empty(shape, dtype=dtype, device="meta"),
                       "v": torch.empty(shape, dtype=dtype, device="meta")}
             for j in range(len(cfg.pattern))}
    return {"pos": torch.empty((), dtype=torch.int32, device="meta"),
            "stack": stack}


def cache_bytes(cfg: ModelConfig, B: int, S_max: int,
                dtype=torch.bfloat16) -> int:
    from repro_torch.core.dump import flatten_with_paths
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_paths(cache_struct(cfg, B, S_max,
                                                           dtype)))
