"""Logical-axis sharding rules (MaxText-style), computed per (arch, mesh).

The JAX package's distributed/sharding.py on the port's own records: torch
has no ``jax.sharding``, so ``PartitionSpec``, ``Mesh`` and
``NamedSharding`` are small records here with the JAX package's fields,
and the rules, specs and topology records equal its own for the same
mesh shape and axes.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod. Weights are Megatron-TP sharded on `model` (d_ff / heads / vocab)
and FSDP/ZeRO-3 sharded on `(pod, data)` (d_model); optimizer states inherit
param shardings. Divisibility is checked per axis with graceful fallback to
replication (e.g. GQA kv_heads=8 < model=16 -> KV projections replicate over
`model`).

The port runs one process on one device: a mesh is a record of axis names
over an ndarray of ``torch.device``, and placing a tree under
``named(mesh, specs)`` puts every leaf on the mesh's one device
(``placement_device``); a mesh over several distinct devices raises there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _canon(p):
    """A spec entry as jax.sharding canonicalizes it: a one-name tuple is
    the name, an empty tuple None."""
    if isinstance(p, (tuple, list)):
        p = tuple(p)
        return None if not p else p[0] if len(p) == 1 else p
    return p


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) per array dim;
    repr and equality as ``jax.sharding.PartitionSpec``'s (equal to a
    tuple of the same canonical entries)."""

    def __new__(cls, *partitions):
        return super().__new__(cls, tuple(_canon(p) for p in partitions))

    def __repr__(self):
        return f"PartitionSpec({tuple.__repr__(self)[1:-1]})"

    def __eq__(self, other):
        if isinstance(other, tuple):
            return tuple(self) == tuple(_canon(o) for o in other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__


class Mesh:
    """Axis names over an ndarray of ``torch.device`` (the record
    ``jax.sharding.Mesh`` is to JAX)."""

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            self.devices[idx] = torch.device(given[idx])
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")


class NamedSharding:
    """A PartitionSpec over a Mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def shard_shape(self, global_shape) -> tuple:
        """The shape of one device's shard of an array of
        ``global_shape``, as ``jax.sharding.NamedSharding.shard_shape``
        gives it; raises ValueError where a dim does not divide evenly."""
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            names = () if entry is None else \
                entry if isinstance(entry, tuple) else (entry,)
            n = 1
            for a in names:
                n *= int(sizes[a])
            if dim % n:
                raise ValueError(f"{self.spec} splits axis {i} of "
                                 f"{tuple(global_shape)} {n} ways")
            out.append(dim // n)
        return tuple(out)


def _axis_size(mesh: Mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_size(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= _axis_size(mesh, a)
    return n


def make_rules(cfg: ModelConfig, mesh: Mesh, *, fsdp: bool = True,
               expert_parallel: bool = False) -> dict:
    """logical axis -> mesh axis (or tuple / None)."""
    model = _axis_size(mesh, "model")
    dax = data_axes(mesh)
    dsize = data_size(mesh)

    def if_div(n: int, target):
        return target if model > 1 and n % model == 0 else None

    rules = {
        "embed": dax if (fsdp and cfg.d_model % dsize == 0) else None,
        "mlp": if_div(cfg.d_ff, "model") if cfg.d_ff else None,
        "shared_mlp": if_div(cfg.shared_attn_dff, "model") if cfg.shared_attn_dff else None,
        "heads": if_div(cfg.num_heads, "model"),
        "kv_heads": if_div(cfg.num_kv_heads, "model"),
        "head_dim": None,
        "vocab": if_div(cfg.padded_vocab, "model"),
        "inner": if_div(cfg.d_inner, "model") if cfg.ssm_expand else None,
        "state": None,
        "conv": None,
        "expert": None,
        # activations
        "batch": dax,
        "seq": None,
        "seq_kv": None,  # set per-shape in cache_rules
    }
    if expert_parallel and cfg.num_experts and cfg.num_experts % model == 0:
        rules["expert"] = "model"
        rules["mlp"] = None  # EP replaces TP inside experts
    return rules


def mesh_topology(mesh: Mesh | None) -> dict:
    """JSON-able topology record for checkpoint manifests: axis names/sizes,
    DP degree, device and host counts. ``None`` mesh (unsharded single-
    process run) records the trivial topology — the migration layer treats
    the record as informational, never as a restore requirement. The port
    is one process: ``host_count`` is 1."""
    if mesh is None:
        return {"axes": [], "dp_degree": 1, "device_count": 1,
                "host_count": 1}
    return {
        "axes": [[name, int(size)] for name, size in
                 zip(mesh.axis_names, mesh.devices.shape)],
        "dp_degree": data_size(mesh),
        "device_count": int(mesh.devices.size),
        "host_count": 1,
    }


def batch_axes(mesh: Mesh, global_batch: int):
    """Shard batch over (pod, data) when divisible, else replicate (bs=1
    long-context decode)."""
    return data_axes(mesh) if global_batch % data_size(mesh) == 0 else None


def cache_rules(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig) -> dict:
    """Sharding for decode-time state. Attention KV caches are sharded over
    `model` on the *sequence* dim (flash-decoding style split-K); batch over
    data when divisible."""
    model = _axis_size(mesh, "model")
    return {
        "batch": batch_axes(mesh, shape.global_batch),
        "seq_kv": "model" if model > 1 and shape.seq_len % model == 0 else None,
        "kv_heads": None,   # cache keeps kv heads unsharded (GQA kv < model)
        "head_dim": None,
        "heads": None,
        "inner": "model" if cfg.ssm_expand and cfg.d_inner % model == 0 else None,
        "state": None,
        "conv": None,
    }


def input_pspec(mesh: Mesh, shape: ShapeConfig) -> PartitionSpec:
    return PartitionSpec(batch_axes(mesh, shape.global_batch))


def named(mesh: Mesh, tree_pspecs):
    """A nested dict of PartitionSpecs -> the same tree of
    NamedShardings on ``mesh``."""
    if isinstance(tree_pspecs, dict):
        return {k: named(mesh, v) for k, v in tree_pspecs.items()}
    return NamedSharding(mesh, tree_pspecs)


def placement_device(shardings) -> torch.device:
    """The one device a tree of NamedShardings (or a single one) places
    its leaves on. Raises NotImplementedError for a mesh over several
    distinct devices, or leaves on different devices: the port places a
    tree on one device and never pretends otherwise."""
    devs = set()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, NamedSharding):
            devs.update(node.mesh.devices.flat)
        elif isinstance(node, Mesh):
            devs.update(node.devices.flat)
        else:
            raise TypeError(f"expected NamedShardings, got "
                            f"{type(node).__name__}")
    walk(shardings)
    if not devs:
        raise ValueError("the shardings name no device")
    if len(devs) != 1:
        raise NotImplementedError(
            f"multi-device placement (a mesh over {sorted(map(str, devs))}) "
            f"is not supported by repro_torch: it places a tree on one "
            f"device")
    return devs.pop()


def check_tree(shardings, tree) -> None:
    """Raise ValueError unless a tree of shardings has ``tree``'s leaf
    paths (a single NamedSharding applies to every leaf)."""
    if not isinstance(shardings, dict):
        return
    from repro_torch.models.params import leaf_paths
    want, got = leaf_paths(tree), leaf_paths(shardings)
    if want != got:
        raise ValueError(
            f"the shardings tree does not match the restored tree: "
            f"{sorted(set(want) ^ set(got))[:5]}")


# ------------------------------------------------------- trace-time context
# Mesh context for sharding constraints INSIDE model code (MoE shard-local
# dispatch). The port runs on one device: the context records the mesh
# and ``constrain`` leaves its tensor as it is.
_CTX = {"mesh": None}


class mesh_context:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._old = _CTX["mesh"]
        _CTX["mesh"] = self.mesh
        return self

    def __exit__(self, *a):
        _CTX["mesh"] = self._old


def ctx_data_shards() -> int:
    mesh = _CTX["mesh"]
    return data_size(mesh) if mesh is not None else 1


def constrain(x, *axes):
    """The JAX package's with_sharding_constraint against the context mesh:
    the identity on one device."""
    return x
