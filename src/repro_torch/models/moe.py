"""Token-choice top-k MoE with sort-based scatter dispatch — the JAX
package's models/moe.py on tensors (no [T, E, C] one-hot dispatch
tensors).

Dispatch: top-k routing -> position-in-expert via stable argsort ->
scatter into [E, C, d] slots (capacity C = max(8, k*T*cf // E), overflow
dropped) -> per-expert GEMMs (einsum) -> gather-combine with renormalized
router weights. Load-balance aux loss per Switch/GShard.

On one device the JAX code's token groups (one per data shard,
``ctx_data_shards()``) are one group and nothing is sharded. On DTensors (a
multi-device mesh) ``moe_apply`` dispatches shard-locally, as the JAX
package does: each data shard's tokens are one group, routed, sorted and
scattered on their own rank with no traffic; the expert GEMMs run on
DTensors pinned as the JAX code constrains them (group over the data axes,
d_ff over ``model``), so DTensor gathers the FSDP weight shards and
all-reduces only the [G, E, C, d] output; the aux loss sums the counts
and averages the router probabilities over the groups.
Port differences that keep the JAX results:

  * ``jax.lax.top_k`` returns the lower expert index first among equal
    probabilities; ``torch.topk`` promises no order, so the top k come
    from a stable descending sort;
  * JAX's scatter with ``mode="drop"`` sends a dropped token to the
    out-of-range slot E*C; here the slot rows get one extra row that
    takes them and is cut off (and the gather reads a zero row there,
    JAX's ``mode="fill"``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pm
from repro_torch.models.layers import _act


def moe_specs(cfg: ModelConfig):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    t = {
        "router": pm.dense((d, e), ("embed", None)),
        "w_up": pm.dense((e, d, ff), ("expert", "embed", "mlp"), fan_in=d),
        "w_down": pm.dense((e, ff, d), ("expert", "mlp", "embed"), fan_in=ff),
    }
    if cfg.glu:
        t["w_gate"] = pm.dense((e, d, ff), ("expert", "embed", "mlp"), fan_in=d)
    return t


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            // cfg.num_experts)
    return max(8, c)


def _route(p, xt, cfg: ModelConfig):
    """xt [T, d] -> (probs [T, E] fp32, gate [T, K] renormalized, idx [T, K]).
    The top k by a stable descending sort: among equal probabilities the
    lower expert index comes first, as ``jax.lax.top_k`` orders them."""
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    gate, idx = gate[:, :K], idx[:, :K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def expert_counts(flat_e, E: int):
    """Tokens routed to each expert: ``torch.bincount(flat_e,
    minlength=E)``'s int64 counts, by an integer ``index_add_``, which has
    a meta kernel (the dry run traces MoE steps on ``meta``; bincount has
    none). Integer adds are exact in any order."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def _dispatch_group(p, xt, cfg: ModelConfig, C: int):
    """Routing for one token group. xt [T, d] ->
    (disp [E*C, d], slot [T*K], weight [T*K], counts [E], mean_prob [E])."""
    T, d = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    probs, gate, idx = _route(p, xt, cfg)

    # position-in-expert via stable sort (memory O(T*K), not O(T*E*C))
    flat_e = idx.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    counts = expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * K, device=xt.device) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)

    slot = flat_e * C + pos                                         # [T*K]
    keep = pos < C
    slot = torch.where(keep, slot, torch.full_like(slot, E * C))   # -> drop row
    tok = torch.arange(T, device=xt.device).repeat_interleave(K)
    # kept slots are unique, so each kept row is one value added to zero:
    # the same bits on every run, atomics or not; the dropped tokens pile
    # up in row E*C, which is cut off
    disp = torch.zeros((E * C + 1, d), dtype=xt.dtype,
                       device=xt.device).index_add(0, slot, xt[tok])[:E * C]
    w = (gate.reshape(T * K) * keep).to(xt.dtype)
    return disp, slot, w, counts, probs.mean(dim=0)


def _combine_group(out, slot, w, T: int, K: int):
    """out [E*C, d] -> [T, d]: each token's K slots, weighted and summed; a
    dropped token's slot E*C reads a zero row."""
    padded = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    gathered = padded[slot]                                          # [T*K, d]
    return (gathered * w[:, None]).reshape(T, K, -1).sum(dim=1)


def _moe_apply_sharded(p, x, cfg: ModelConfig):
    """moe_apply on DTensors: JAX's shard-local dispatch (module
    docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed import sharding as shd
    mesh = x.device_mesh
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    data = [i for i, n in enumerate(mesh.mesh_dim_names)
            if n in ("pod", "data", shd.POD_DATA)]
    G = 1
    for i in data:
        G *= mesh.size(i)
    if B % G:
        G, data = 1, []
    rows = [Shard(0) if i in data else Replicate() for i in range(mesh.ndim)]
    part = [Partial() if i in data else Replicate()
            for i in range(mesh.ndim)]
    Tg = B // G * S
    C = capacity(cfg, Tg)
    x = shd.pin(x, rows)
    # every model rank routes the same tokens alike; a data shard's
    # router gradient is its own tokens' share of the sum
    router = shd.pin(p["router"], [Replicate()] * mesh.ndim)
    disp, slot, w, counts, mean_prob = _dispatch_group(
        {"router": shd.local(router, part)},
        shd.local(x, rows).reshape(Tg, d), cfg, C)

    def wrap(t, shape, placements):
        return DTensor.from_local(t, mesh, placements,
                                  shape=torch.Size(shape),
                                  stride=shd.contiguous_stride(shape))
    h = wrap(disp.reshape(1, E, C, d), (G, E, C, d), rows)
    dt = x.dtype
    ff = [Shard(0) if i in data else Shard(3) if n == "model" else
          Replicate() for i, n in enumerate(mesh.mesh_dim_names)]
    up = shd.pin(torch.einsum("gecd,edf->gecf", h, p["w_up"].to(dt)), ff)
    if cfg.glu:
        gt = shd.pin(torch.einsum("gecd,edf->gecf", h, p["w_gate"].to(dt)),
                     ff)
        up = _act(gt, cfg.activation) * up
    else:
        up = _act(up, cfg.activation)
    out = shd.pin(torch.einsum("gecf,efd->gecd", up, p["w_down"].to(dt)),
                  rows)
    y = _combine_group(shd.local(out, rows).reshape(E * C, d),
                       slot, w, Tg, K)
    y = wrap(y.reshape(B // G, S, d), (B, S, d), rows)
    # Switch/GShard load-balance loss over the GLOBAL batch
    counts = shd.reduce_partial(wrap(counts.to(torch.float32), (E,), part))
    mean_prob = shd.reduce_partial(wrap(mean_prob, (E,), part)) / G
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    aux = E * torch.sum(frac * mean_prob)
    return y, aux


def moe_apply(p, x, cfg: ModelConfig):
    """x [B,S,d] -> (y [B,S,d], aux_loss fp32 scalar). Tokens over an
    expert's capacity are dropped (they contribute zero). On DTensors the
    dispatch is shard-local (``_moe_apply_sharded``)."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(x):
        return _moe_apply_sharded(p, x, cfg)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = capacity(cfg, T)
    disp, slot, w, counts, mean_prob = _dispatch_group(
        p, x.reshape(T, d), cfg, C)
    h = disp.reshape(E, C, d)
    dt = x.dtype
    up = torch.einsum("ecd,edf->ecf", h, p["w_up"].to(dt))
    if cfg.glu:
        gt = torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(dt))
        up = _act(gt, cfg.activation) * up
    else:
        up = _act(up, cfg.activation)
    out = torch.einsum("ecf,efd->ecd", up, p["w_down"].to(dt))
    y = _combine_group(out.reshape(E * C, d), slot, w, T, K).reshape(B, S, d)

    # Switch/GShard load-balance loss over the batch
    counts = counts.to(torch.float32)
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    aux = E * torch.sum(frac * mean_prob)
    return y, aux


def moe_dense_reference(p, x, cfg: ModelConfig):
    """O(T*E) oracle: every expert on every token, combined by the
    (renormalized) top-k gates; nothing is dropped. Decode runs it, as in
    the JAX package; tests use it to validate the scatter dispatch."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    dt = x.dtype
    probs, gate, idx = _route(p, xt, cfg)
    dense_gate = torch.zeros_like(probs).scatter(1, idx, gate)       # [T, E]
    up = torch.einsum("td,edf->tef", xt, p["w_up"].to(dt))
    if cfg.glu:
        up = _act(torch.einsum("td,edf->tef", xt, p["w_gate"].to(dt)),
                  cfg.activation) * up
    else:
        up = _act(up, cfg.activation)
    y = torch.einsum("tef,efd->ted", up, p["w_down"].to(dt))
    y = torch.einsum("ted,te->td", y, dense_gate.to(dt))
    return y.reshape(B, S, d)
