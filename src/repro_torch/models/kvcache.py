"""Decode-time state: KV caches for attention layers.

The cache is an ordinary nested dict of tensors, so the checkpoint engine
dumps it like any other job state — a serving session can be dumped,
moved and continued (the paper's "network applications" row). Same tree,
shapes and dtypes as the JAX package's models/kvcache.py:

  {"stack": {"b<j>": {"k": [G, B, S_max, KV, hd], "v": ...}},
   "pos":   int32 scalar (tokens already in cache)}

A cache built with B = n_slots doubles as a pool of per-session pages
(``slot_axes`` / ``slot_take`` / ``slot_put``, the serving plane's).
Recurrent (SSM) entries, zamba2's tail and shared caches and
``cache_pspecs`` are not ported yet.
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


# ------------------------------------------------------------- slot pool
# A cache built with B = n_slots doubles as a POOL of per-session pages:
# every leaf with a "batch" axis is indexed by slot id, so a serving plane
# gathers an ad-hoc cohort of sessions into a dense decode batch and
# scatters the updated pages back. The pool's "pos" scalar is meaningless
# (each session has its own cursor): cohorts get their pos at gather time.

def slot_axes(cfg: ModelConfig):
    """Per-leaf index of the "batch" (slot) axis, -1 for the pos scalar.
    Parallel to init_cache's output: stacked leaves are [G, B, S, KV, hd],
    so the slot axis is 1 (the JAX package's cache_axes with its leading
    None for the stacked layer axis)."""
    _check(cfg)
    return {"pos": -1,
            "stack": {f"b{j}": {"k": 1, "v": 1}
                      for j in range(len(cfg.pattern))}}


def slot_take(pool, cfg: ModelConfig, idx, *, pos):
    """Gather slots ``idx`` ([k] int) out of a pool cache into a dense
    cohort cache of batch k, with the cohort's ``pos`` cursor set. The
    cohort is a copy (``index_select``), never a view of the pool: decode
    writes the cohort's cache in place.

    Example::

        cohort = slot_take(pool, cfg, [3, 7], pos=12)
    """
    dev = pool["pos"].device
    ix = torch.as_tensor(idx, dtype=torch.long, device=dev)

    stack = {b: {n: torch.index_select(pool["stack"][b][n], a, ix)
                 for n, a in entry.items()}
             for b, entry in slot_axes(cfg)["stack"].items()}
    return {"pos": torch.as_tensor(int(pos), dtype=torch.int32, device=dev),
            "stack": stack}


def slot_put(pool, cohort, cfg: ModelConfig, idx):
    """Scatter a cohort cache (batch k) back into pool slots ``idx``, in
    place (``index_copy_``), and return the pool. The pool's own ``pos``
    scalar is kept (per-session cursors live in the session table)."""
    ix = torch.as_tensor(idx, dtype=torch.long, device=pool["pos"].device)
    for b, entry in slot_axes(cfg)["stack"].items():
        for n, a in entry.items():
            pool["stack"][b][n].index_copy_(a, ix, cohort["stack"][b][n])
    return pool
