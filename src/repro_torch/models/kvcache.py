"""Decode-time state: KV caches (attention) and recurrent states (SSM).

The cache is an ordinary nested dict of tensors, so the checkpoint engine
dumps it like any other job state — a serving session can be dumped,
moved and continued (the paper's "network applications" row). Same tree,
shapes and dtypes as the JAX package's models/kvcache.py:

  {"stack":  {"b<j>": stacked [G, ...] per pattern entry},
   "tail":   {"t<j>": ...},                      # zamba2 tail layers
   "shared": stacked [n_apps, ...],              # zamba2 shared-attn caches
   "pos":    int32 scalar (tokens already in cache)}

An attention entry is {"k", "v": [B, S_max, KV, hd]} in the compute dtype;
a recurrent one is its block's state (``models/ssm.py``: mamba2's fp32
``h`` and its conv tails, mlstm's C/n/m and conv tail, slstm's c/n/m/h).

A cache built with B = n_slots doubles as a pool of per-session pages
(``slot_axes`` / ``slot_take`` / ``slot_put``, the serving plane's).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm


def n_shared_apps(cfg: ModelConfig) -> int:
    return cfg.num_groups + (1 if cfg.tail_layers else 0)


def _attn_entry(cfg: ModelConfig, B: int, S_max: int, dtype, dev, lead=()):
    shape = lead + (B, S_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _attn_axes():
    ax = ("batch", "seq_kv", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


_SSM_INIT = {"mamba2": ssm.mamba2_init_state, "mlstm": ssm.mlstm_init_state,
             "slstm": ssm.slstm_init_state}
_SSM_AXES = {"mamba2": ssm.mamba2_state_axes, "mlstm": ssm.mlstm_state_axes,
             "slstm": ssm.slstm_state_axes}


def _entry(kind: str, cfg: ModelConfig, B: int, S_max: int, dtype, dev,
           lead=()):
    """One layer's entry, with the leading dims ``lead`` on every leaf."""
    if kind == "attn":
        return _attn_entry(cfg, B, S_max, dtype, dev, lead)
    one = _SSM_INIT[kind](cfg, B, dtype, dev)
    # a fresh copy at every depth (``contiguous()`` would skip the copy of
    # a one-group stack, and a depth-extrapolated count would miss it)
    return {n: t.expand(lead + t.shape).clone(
        memory_format=torch.contiguous_format) for n, t in one.items()}


def _entry_axes(kind: str, cfg: ModelConfig):
    if kind == "attn":
        return _attn_axes()
    return _SSM_AXES[kind](cfg)


def _build(cfg: ModelConfig, B: int, S_max: int, dtype, dev):
    G = cfg.num_groups
    out = {"pos": torch.zeros((), dtype=torch.int32, device=dev),
           "stack": {f"b{j}": _entry(k, cfg, B, S_max, dtype, dev, (G,))
                     for j, k in enumerate(cfg.pattern)}}
    if cfg.tail_layers:
        out["tail"] = {f"t{j}": _entry(cfg.pattern[j], cfg, B, S_max, dtype,
                                       dev)
                       for j in range(cfg.tail_layers)}
    if cfg.shared_attn_every:
        out["shared"] = _attn_entry(cfg, B, S_max, dtype, dev,
                                    (n_shared_apps(cfg),))
    return out


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
               device="cuda", shardings=None):
    """Zeroed cache for B sequences of up to S_max tokens on ``device``
    (the recurrent stabilisers ``m`` at -1e30, as in the JAX package).
    ``shardings`` (a tree of NamedShardings over a multi-device mesh,
    ``named(mesh, cache_pspecs(...))``) makes each leaf a DTensor of which
    only this rank's shard is allocated."""
    dev = resolve_device(device)
    if shardings is None:
        return _build(cfg, B, S_max, dtype, dev)
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.params import tree_map
    # every leaf of a fresh cache holds one value: read it off a one-row,
    # one-position cache, then make each shard at its local shape (the
    # global shape: "batch" B, "seq_kv" S_max, the rest as they are)
    one = _build(cfg, 1, 1, dtype, torch.device("cpu"))
    axes = cache_axes(cfg)

    def leaf(path, t):
        if path == "pos":
            return torch.zeros((), dtype=torch.int32, device=dev)
        ax, sh = axes, shardings
        for k in path.split("/"):
            ax, sh = ax[k], sh[k]
        shape = tuple(B if a == "batch" else S_max if a == "seq_kv" else n
                      for a, n in zip(ax, t.shape))
        return shd.full(shape, t.reshape(-1)[0].item(), t.dtype, sh, dev)
    return tree_map(leaf, one)


def cache_struct(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16):
    """The cache's shapes and dtypes on the ``meta`` device (no memory)."""
    return _build(cfg, B, S_max, dtype, torch.device("meta"))


def cache_axes(cfg: ModelConfig):
    """Logical-axis tree parallel to init_cache's output (the stacked
    entries lead with None)."""
    def stacked(tree):
        return {n: (None,) + tuple(ax) for n, ax in tree.items()}
    out = {"pos": (),
           "stack": {f"b{j}": stacked(_entry_axes(k, cfg))
                     for j, k in enumerate(cfg.pattern)}}
    if cfg.tail_layers:
        out["tail"] = {f"t{j}": _entry_axes(cfg.pattern[j], cfg)
                       for j in range(cfg.tail_layers)}
    if cfg.shared_attn_every:
        out["shared"] = stacked(_attn_axes())
    return out


def cache_pspecs(cfg: ModelConfig, rules: dict):
    """cache_axes mapped through ``rules`` (distributed/sharding
    cache_rules) to PartitionSpecs."""
    from repro_torch.distributed.sharding import PartitionSpec

    def one(ax):
        return PartitionSpec(*[(rules.get(a) if a else None) for a in ax])

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)
    return walk(cache_axes(cfg))


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

def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def slot_axes(cfg: ModelConfig):
    """Per-leaf index of the "batch" (slot) axis, -1 for leaves without
    one (the pos scalar). Parallel to init_cache's output: stacked KV
    leaves are [G, B, S, KV, hd], so their slot axis is 1."""
    return _map(lambda ax: ax.index("batch") if "batch" in ax else -1,
                cache_axes(cfg))


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
    out = _map(lambda a, leaf: leaf if a < 0
               else torch.index_select(leaf, a, ix), slot_axes(cfg), pool)
    out["pos"] = torch.as_tensor(int(pos), dtype=torch.int32, device=dev)
    return out


def slot_put(pool, cohort, cfg: ModelConfig, idx):
    """Scatter a cohort cache (batch k) back into pool slots ``idx``, in
    place (``index_copy_``), and return the pool. The pool's own ``pos``
    scalar is kept (per-session cursors live in the session table)."""
    ix = torch.as_tensor(idx, dtype=torch.long, device=pool["pos"].device)

    def put(a, pleaf, cleaf):
        if a >= 0:
            pleaf.index_copy_(a, ix, cleaf)
    _map(put, slot_axes(cfg), pool, cohort)
    return pool
