"""Parameter-spec system: declarative shapes + logical axes.

A model is described as a nested dict of ``ParamSpec`` leaves — the same
tree, shapes and axis names as the JAX package — and from that single
source of truth we derive (a) abstract params on the ``meta`` device (no
allocation), (b) initialized params, (c) the bridge ``from_jax`` that
carries the JAX package's parameters (as numpy arrays) into tensors, so
both packages can be run on the same weights.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis name (or None) per dim
    init: str = "normal"   # normal | zeros | ones
    stddev: float = 0.02


def dense(shape, axes, fan_in=None) -> ParamSpec:
    """Dense weight with 1/sqrt(fan_in) init."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return ParamSpec(tuple(shape), tuple(axes), "normal", float(fan_in) ** -0.5)


def scale_ones(dim) -> ParamSpec:
    return ParamSpec((dim,), (None,), "ones")


def tree_map(fn, tree, path: str = ""):
    """Map ``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the JAX flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_specs(tree, n: int):
    """Add a leading stacked-layer dim (never sharded) to every leaf."""
    return tree_map(lambda _, p: ParamSpec((n,) + p.shape, (None,) + p.axes,
                                           p.init, p.stddev), tree)


def abstract(tree, dtype=torch.float32):
    """Spec tree -> tree of ``meta`` tensors (shapes and dtypes only)."""
    return tree_map(lambda _, p: torch.empty(p.shape, dtype=dtype,
                                             device="meta"), tree)


def init(tree, generator: torch.Generator, dtype=torch.float32,
         device="cuda"):
    """Deterministic init on ``device``: each parameter draws from its own
    generator, seeded from ``generator``'s seed and a hash of its path
    (stable across restructuring, like the JAX package's fold_in). The
    numbers differ from JAX's: use ``from_jax`` to share weights."""
    dev = resolve_device(device)
    base = generator.initial_seed()

    def one(path, p: ParamSpec):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        h = int.from_bytes(
            hashlib.sha256(path.encode()).digest()[:4], "little")
        g = torch.Generator(device=dev)
        g.manual_seed((base * 0x9E3779B1 + h) % (1 << 63))
        w = torch.randn(p.shape, generator=g, dtype=torch.float32, device=dev)
        return (w * p.stddev).to(dtype)
    return tree_map(one, tree)


def from_jax(tree, device="cuda"):
    """Nested dict of numpy arrays (the JAX package's params through
    ``np.asarray``) -> the same tree of tensors on ``device``. Leaves keep
    their dtypes and never share memory with the arrays given (the train
    step updates its state in place); a bfloat16 array (ml_dtypes, which
    the port does not import) is carried across by its bit pattern."""
    dev = resolve_device(device)

    def one(_, a):
        a = np.asarray(a)
        if str(a.dtype) == "bfloat16":
            bits = np.ascontiguousarray(a).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
        return to_device(a.copy(), dev)
    return tree_map(one, tree)


def count(tree) -> int:
    total = 0
    for p in tree_leaves(tree):
        n = 1
        for s in p.shape:
            n *= s
        total += n
    return total
