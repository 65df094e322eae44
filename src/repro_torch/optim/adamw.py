"""AdamW with decoupled weight decay and global-norm clipping.

Optimizer states are plain nested dicts mirroring the params tree and are
checkpointed by repro_torch.core as ordinary job state. Same formulas, in
the same fp32 order, as the JAX package's optim/adamw.py. Unlike the JAX
version, which is pure, ``adamw_update`` and ``clip_by_global_norm``
update their tensors in place: at qwen3-8b width a second copy of params,
m and v would cost another ~20 GB of device memory per step. On DTensor
leaves (a multi-device mesh) the same code updates each rank's shards in
place, and the global norm's per-leaf sums are partial sums over the
shards, all-reduced where the norm is taken.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_opt_state(params):
    zeros = lambda t: tree_map(lambda _, a: torch.zeros_like(a), t)
    return {"m": zeros(params), "v": zeros(params)}


def global_norm(tree) -> torch.Tensor:
    sums = [x.to(torch.float32).square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place so their global norm is <= max_norm.
    -> (grads, norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(grads, opt_state, params, step, cfg: OptConfig, lr=None):
    """Updates params, m and v in place; returns (params, opt_state).
    ``step`` is the 1-based update count (0-d tensor); ``lr`` overrides
    the schedule if given."""
    lr = cfg.lr if lr is None else lr
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        g = g.to(torch.float32)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p
        p.sub_(lr * upd)
    return params, opt_state
