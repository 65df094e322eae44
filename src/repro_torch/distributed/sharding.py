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

A mesh is a record of axis names over an ndarray of ``torch.device``. A
mesh whose positions all name one device (``ranks`` None) is a one-device
mesh: placing a tree under ``named(mesh, specs)`` puts every leaf on that
device, as plain tensors. A mesh with ``ranks`` spans the ranks of a
``torch.distributed`` process group, one device per rank
(``launch/mesh.make_test_mesh`` builds one when a group is initialised):
``device_mesh`` maps it to a ``DeviceMesh``, ``placements`` maps a
PartitionSpec to ``Shard``/``Replicate``, and ``place`` turns a tree of
full tensors into ``DTensor``s whose local shards are the slices of the
leaves. The group is real (gloo, NCCL) or fake (``launch/mesh.fake_group``:
one process plays rank 0 and collectives move no data); both run the same
program. A mesh over several devices without a group that spans it
raises (``placement_device``).

Inside model code the DTensor program follows the JAX one: weights are
gathered over the data axes right before use (``gather_fsdp``, FSDP's
all-gather; their ``model`` shards stay), activations follow DTensor's
sharding propagation, and ``LM(act_sharding=)`` pins the residual stream
at group boundaries (``constrain``).
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
    ``jax.sharding.Mesh`` is to JAX). ``ranks`` (same shape, or None) are
    the process-group ranks of the positions of a multi-device mesh."""

    def __init__(self, devices, axis_names, ranks=None):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            self.devices[idx] = torch.device(given[idx])
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.ranks = None if ranks is None else \
            np.asarray(ranks, dtype=np.int64).reshape(self.devices.shape)


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


def _meshes(shardings) -> list:
    out = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, NamedSharding):
            out.append(node.mesh)
        elif isinstance(node, Mesh):
            out.append(node)
        else:
            raise TypeError(f"expected NamedShardings, got "
                            f"{type(node).__name__}")
    walk(shardings)
    return out


def group_size() -> int:
    """Ranks in the initialised default process group, 0 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 0


def _no_group(n: int, what: str) -> RuntimeError:
    have = group_size()
    return RuntimeError(
        f"{what} spans {n} devices and needs a process group of {n} ranks "
        f"(torch.distributed.init_process_group, or launch.mesh.fake_group); "
        + (f"the initialised group has {have}" if have
           else "none is initialised"))


def placement_device(shardings) -> torch.device:
    """The device this process places a tree of NamedShardings (or a
    single one, or a Mesh) on: a one-device mesh's device, or this rank's
    device of a multi-device mesh whose ranks the initialised process
    group spans. Raises RuntimeError for a mesh over several devices
    without such a group, or meshes that disagree."""
    meshes = _meshes(shardings)
    if not meshes:
        raise ValueError("the shardings name no device")
    devs = set()
    for m in meshes:
        if m.ranks is not None:
            n = int(m.ranks.size)
            if group_size() != n:
                raise _no_group(n, f"a mesh of shape {m.devices.shape}")
            import torch.distributed as dist
            at = np.argwhere(m.ranks == dist.get_rank())[0]
            devs.add(m.devices[tuple(at)])
        else:
            devs.update(m.devices.flat)
    if len(devs) != 1 or len({m.ranks is None for m in meshes}) != 1:
        raise _no_group(len(devs), f"placement over "
                                   f"{sorted(map(str, devs))}")
    return devs.pop()


def is_multi(mesh: Mesh) -> bool:
    """True for a mesh over the ranks of a process group."""
    return mesh.ranks is not None


_DEVICE_MESHES = {}


# the DeviceMesh dim that a (pod, data, model) mesh's pod and data axes
# become together (see device_mesh)
POD_DATA = "pod_data"


def _dm_groups(mesh: Mesh) -> list:
    """The mesh record's axes grouped as its DeviceMesh's dims: ``pod``
    and ``data`` side by side are one dim (pod outermost)."""
    names, groups = mesh.axis_names, []
    i = 0
    while i < len(names):
        if names[i:i + 2] == ("pod", "data"):
            groups.append(("pod", "data"))
            i += 2
        else:
            groups.append((names[i],))
            i += 1
    return groups


def device_mesh(mesh: Mesh):
    """The ``torch.distributed.device_mesh.DeviceMesh`` of a multi-device
    mesh record over the ranks of the current process group (built once
    per group; new_group is collective on a real group). A (pod, data,
    model) mesh becomes a 2-D DeviceMesh (``POD_DATA``, model): the JAX
    rules only ever split a dim over pod and data together
    (``data_axes``), so the two are one dim of pod x data ranks, pod
    outermost, as the tuple entry orders them; DTensor's sharding
    propagation then weighs strategies over two mesh dims, not three,
    which on the 512-device mesh is the difference between seconds and
    tens of minutes a cell."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not is_multi(mesh):
        raise ValueError("a one-device mesh has no DeviceMesh")
    n = int(mesh.ranks.size)
    if group_size() != n:
        raise _no_group(n, f"a mesh of shape {mesh.devices.shape}")
    kind = "cuda" if mesh.devices.flat[0].type == "cuda" else "cpu"
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    groups = _dm_groups(mesh)
    shape = tuple(int(np.prod([sizes[a] for a in g])) for g in groups)
    names = tuple(POD_DATA if len(g) > 1 else g[0] for g in groups)
    key = (id(dist.group.WORLD), kind, shape, names)
    if key not in _DEVICE_MESHES:
        _DEVICE_MESHES[key] = init_device_mesh(kind, shape,
                                               mesh_dim_names=names)
    return _DEVICE_MESHES[key]


def forget_device_meshes() -> None:
    """Drop the DeviceMeshes built over a group about to be destroyed."""
    _DEVICE_MESHES.clear()


def _entry_axes(entry) -> tuple:
    return () if entry is None else \
        entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> list:
    """A PartitionSpec -> one ``Shard``/``Replicate`` per dim of the
    mesh's DeviceMesh: a mesh axis (or ``POD_DATA``, pod and data
    together) shards the array dim whose entry names it; a tuple entry
    such as ``("pod", "data")`` shards its dim over both, the first name
    outermost, as in JAX. ``mesh`` is a Mesh record or a DeviceMesh."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(mesh, Mesh):
        groups = _dm_groups(mesh)
    else:
        groups = [("pod", "data") if n == POD_DATA else (n,)
                  for n in mesh.mesh_dim_names]
    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    out = []
    for g in groups:
        dims = []
        for d, e in enumerate(spec):
            ax = _entry_axes(e)
            hit = [a for a in ax if a in g]
            if hit and tuple(a for a in ax if a in g) != g:
                raise ValueError(f"{spec} splits a dim over {hit} without "
                                 f"the rest of {g}, which share one mesh "
                                 f"dim")
            if hit:
                dims.append(d)
        if len(dims) > 1:
            raise ValueError(f"{spec} names mesh axes {g} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """A full tensor (the same on every rank) -> the DTensor of
    ``sharding`` whose local shard is this rank's slice of it, bitwise,
    with no communication. A one-device sharding leaves it as it is."""
    if not is_multi(sharding.mesh):
        return t
    from torch.distributed.tensor import distribute_tensor
    sharding.shard_shape(tuple(t.shape))          # raises if uneven
    return distribute_tensor(t, device_mesh(sharding.mesh),
                             placements(sharding.spec, sharding.mesh),
                             src_data_rank=None)


def place(tree, shardings):
    """A nested dict of full tensors -> the same tree placed under a tree
    of NamedShardings (or one for every leaf): DTensors on a
    multi-device mesh (``distribute``), the tensors as given on a
    one-device mesh."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k] if isinstance(shardings, dict)
                         else shardings) for k, v in tree.items()}
    return distribute(tree, shardings)


def full(shape, fill, dtype, sharding: NamedSharding, device):
    """A tensor of ``shape`` filled with ``fill`` under ``sharding``: on a
    multi-device mesh a DTensor whose local shard alone is allocated
    (``shape`` is global), else a plain tensor on ``device``."""
    if not is_multi(sharding.mesh):
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    shard = torch.full(sharding.shard_shape(tuple(shape)), fill,
                       dtype=dtype, device=device)
    shape = torch.Size(shape)
    return DTensor.from_local(shard, device_mesh(sharding.mesh),
                              placements(sharding.spec, sharding.mesh),
                              shape=shape, stride=contiguous_stride(shape))


def write_at(dst, index: int, src, dim: int = 1):
    """``dst.narrow(dim, index, src.shape[dim]).copy_(src)`` in place.
    Where ``dst`` is a DTensor sharded on ``dim`` (a KV cache over
    ``model`` on the sequence, flash-decoding's split), the rank that
    holds those positions writes them into its own shard."""
    n = src.shape[dim]
    if not is_dtensor(dst):
        dst.narrow(dim, index, n).copy_(src)
        return dst
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = dst.device_mesh, list(dst.placements)
    other = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in pl]
    if not is_dtensor(src):
        from torch.distributed.tensor import DTensor
        src = DTensor.from_local(src, mesh, [Replicate()] * len(pl))
    src = src.redistribute(mesh, other).to_local()
    shard = dst.to_local()
    _, offset = compute_local_shape_and_global_offset(dst.shape, mesh, pl)
    lo = int(offset[dim])
    a, b = max(index, lo), min(index + n, lo + shard.shape[dim])
    if a < b:
        shard.narrow(dim, a - lo, b - a).copy_(
            src.narrow(dim, a - index, b - a))
    return dst


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local(t, grad_placements=None):
    """A DTensor's local shard, differentiably (``to_local``), its
    gradient made contiguous on the way back: ``to_local``'s backward
    wraps the local gradient in the DTensor's own (contiguous) stride, so
    a gradient that local ops leave strided would mislabel its layout."""
    out = t.to_local(grad_placements=grad_placements)
    return _ContiguousGrad.apply(out) if out.requires_grad else out


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def gather_tree(tree):
    """A tree whose DTensor leaves are gathered to full tensors
    (``full_tensor``: collective, every rank of the group calls it);
    other leaves as they are."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda _, t: t.full_tensor() if is_dtensor(t) else t,
                    tree)


def shard_box(global_shape, mesh_shape, placements, coord) -> tuple:
    """(local shape, global offset) of the shard at mesh coordinate
    ``coord`` of a tensor of ``global_shape`` under ``placements``
    (``Shard``/``Replicate``), laid out as DTensor lays it: in mesh-dim
    order each ``Shard(d)`` splits the current piece of dim ``d`` into
    ``torch.chunk``'s pieces (ceil-sized, the last ones short or empty).
    ``compute_local_shape_and_global_offset`` gives the same for this
    rank's own coordinate only."""
    from torch.distributed.tensor import Replicate, Shard
    shape, off = list(global_shape), [0] * len(global_shape)
    for n, c, p in zip(mesh_shape, coord, placements):
        if isinstance(p, Shard):
            d = p.dim
            step = -(-shape[d] // n)
            start = min(step * c, shape[d])
            shape[d], off[d] = min(shape[d], start + step) - start, \
                off[d] + start
        elif not isinstance(p, Replicate):
            raise ValueError(f"no shard layout for placement {p}")
    return tuple(shape), tuple(off)


def gather_leaf(t):
    """A DTensor's full value on global rank 0, None on every other rank
    (collective: every rank of the group calls it, leaf by leaf in one
    order). Only the ranks that hold distinct shards take part — those at
    coordinate 0 on the mesh dims the leaf is replicated over, which is
    the whole group or one mesh dim's group on the port's 1-D and 2-D
    meshes — each sending its local shard, padded to rank 0's (the
    largest), with one ``dist.gather``; rank 0 lays each at its offset
    (``shard_box``). No rank but 0 holds more than its own shard, and rank
    0 at most the gathered shards and the full leaf. A plain tensor is
    the same on every rank: rank 0 gets it as it is."""
    import torch.distributed as dist
    rank = dist.get_rank()
    if not is_dtensor(t):
        return t if rank == 0 else None
    dm, pl = t.device_mesh, list(t.placements)
    ranks = dm.mesh
    if int(ranks.reshape(-1)[0]) != 0 or dm.size() != dist.get_world_size():
        raise ValueError("a leaf is gathered to rank 0 over a mesh that "
                         "spans the whole group, rank 0 first")
    shard_dims = [i for i, p in enumerate(pl) if p.is_shard()]
    if any(p.is_partial() for p in pl) or \
            len(shard_dims) not in (0, 1, ranks.ndim):
        raise ValueError(f"cannot gather a leaf placed as {pl}")
    local = t.to_local().detach()
    if not shard_dims:
        return local if rank == 0 else None
    if rank not in shard_holders(t):
        return None                     # a replica of another's shard
    group = None if len(shard_dims) == ranks.ndim else \
        dm.get_group(shard_dims[0])
    top, _ = shard_box(t.shape, tuple(ranks.shape), pl, [0] * ranks.ndim)
    if tuple(local.shape) != top:
        local = torch.nn.functional.pad(
            local, [x for a, b in zip(reversed(top), reversed(local.shape))
                    for x in (0, a - b)])
    local = local.contiguous()
    members = dist.get_process_group_ranks(group or dist.group.WORLD)
    if rank != 0:
        dist.gather(local, None, dst=0, group=group)
        return None
    bufs = [torch.empty_like(local) for _ in members]
    dist.gather(local, bufs, dst=0, group=group)
    del local
    full = torch.empty(t.shape, dtype=t.dtype, device=bufs[0].device)
    for r, buf in zip(members, bufs):
        at = [int(c) for c in (ranks == r).nonzero()[0]]
        shape, off = shard_box(t.shape, tuple(ranks.shape), pl, at)
        full[tuple(slice(o, o + s) for o, s in zip(off, shape))] = \
            buf[tuple(slice(0, s) for s in shape)]
    return full


def shard_holders(t) -> list:
    """The ranks that hold a DTensor's distinct shards, in rank order:
    those at coordinate 0 on the mesh dims it is replicated over (the
    ranks ``gather_leaf`` gathers from)."""
    pl = list(t.placements)
    if any(p.is_partial() for p in pl):
        raise ValueError(f"no distinct shards of a leaf placed as {pl}")
    ranks = t.device_mesh.mesh
    first = tuple(slice(None) if p.is_shard() else slice(0, 1) for p in pl)
    return sorted(int(r) for r in ranks[first].reshape(-1))


def rank0_decides(fn):
    """``fn()`` on global rank 0 alone; its result (small, picklable) on
    every rank, or its error raised on every rank (collective: every rank
    of the group calls it)."""
    import torch.distributed as dist
    out, err = [None], None
    if dist.get_rank() == 0:
        try:
            out = [{"ok": fn()}]
        except Exception as e:
            out, err = [{"error": f"{type(e).__name__}: {e}"}], e
    dist.broadcast_object_list(out, src=0)
    if "error" in out[0]:
        if err is not None:
            raise err
        raise RuntimeError(f"rank 0 failed: {out[0]['error']}")
    return out[0]["ok"]


def gathered_on_rank0(todo, body):
    """Collective over [(path, leaf)] ``todo``: rank 0 runs ``body(pull)``,
    where ``pull(path, leaf)`` gathers the next leaf of ``todo`` to it
    (``gather_leaf``), while every other rank sends its shards of each
    leaf in ``todo``'s order. ``body`` pulls leaves in that order; should
    it stop early or raise, rank 0 finishes the gathers the other ranks
    are in. -> ``body``'s result (small, picklable) on every rank, or its
    error raised on every rank."""
    import torch.distributed as dist
    done = 0

    def pull(path, t):
        nonlocal done
        if todo[done][0] != path:
            raise ValueError(f"pulled {path!r}, the gather order's next "
                             f"leaf is {todo[done][0]!r}")
        done += 1
        return gather_leaf(t)

    def run():
        try:
            return body(pull)
        finally:
            for _, t in todo[done:]:
                gather_leaf(t)
    if dist.get_rank() != 0:
        for _, t in todo:
            gather_leaf(t)
    return rank0_decides(run)


def has_dtensor(tree) -> bool:
    from repro_torch.models.params import tree_leaves
    return any(is_dtensor(t) for t in tree_leaves(tree))


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
# Mesh context for sharding constraints INSIDE model code, kept from the
# JAX package (its MoE's shard-local dispatch): the context records the
# mesh and ``constrain`` leaves its tensor as it is. The port's MoE reads
# its groups off its DTensors (models/moe.py). ``activation_sharding``
# is the port's own: the residual stream's pin inside the blocks.
_CTX = {"mesh": None, "act": None}


class activation_sharding:
    """The residual stream's NamedSharding (``LM(act_sharding=)``) for
    the blocks run inside: ``constrain_act`` pins each residual add to
    it. DTensor propagates a sharding greedily, op by op, where XLA
    plans a whole program: without the pin a partial sum coming out of
    an attention or MLP block may be reduce-scattered over ``d`` and the
    next block's weights then gathered whole, replicating its work."""

    def __init__(self, sharding):
        self.sharding = sharding

    def __enter__(self):
        self._old = _CTX["act"]
        _CTX["act"] = self.sharding
        return self

    def __exit__(self, *a):
        _CTX["act"] = self._old


def constrain_act(x):
    """``x`` [B, S, d] redistributed to the activation sharding in force
    (``activation_sharding``); the identity without one or on one
    device."""
    act = _CTX["act"]
    if act is None or not is_dtensor(x) or x.ndim != 3:
        return x
    return redistribute(x, act)


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


class _Pin(torch.autograd.Function):
    """Redistribute to fixed placements, and the gradient to the same
    ones: a sharding constraint binds the cotangent too, as JAX's does.
    (DTensor's own redistribute leaves a gradient as the next op made
    it: a partial sum over ``model`` coming back into the residual
    stream would stay partial, and the block before would gather its
    weights whole to multiply it.)"""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if list(grad.placements) != list(ctx.want):
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad, None, None


def pin(x, want):
    """A DTensor redistributed to the placements ``want`` (one per mesh
    dim of its own mesh), its gradient too (``_Pin``)."""
    want = tuple(want)
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Pin.apply(x, x.device_mesh, want)


def redistribute(x, sharding: NamedSharding):
    """A DTensor redistributed to ``sharding``'s placements, its gradient
    too (the JAX package's with_sharding_constraint); a plain tensor as
    it is."""
    if not is_dtensor(x) or not is_multi(sharding.mesh):
        return x
    want = placements(sharding.spec, sharding.mesh)
    return _Pin.apply(x, device_mesh(sharding.mesh), tuple(want))


def constrain(x, *axes):
    """The JAX package's with_sharding_constraint against the context mesh:
    the identity (the port pins with ``redistribute``)."""
    return x


def _vocab_split(x, dim: int):
    """The mesh dims that shard ``x``'s ``dim`` (the vocab), and this
    rank's slice of it as (start, length); ([], None) when unsplit."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return [], None
    cut = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == dim % x.ndim]
    if not cut:
        return [], None
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return cut, (int(offset[dim % x.ndim]), int(shape[dim % x.ndim]))


def contiguous_stride(shape) -> tuple:
    """The stride of a contiguous tensor of ``shape``."""
    return torch.empty(shape, device="meta").stride()


def _partial_sum(part, mesh, cut, rest, shape):
    """``part`` (a local tensor) as a DTensor partial over the ``cut``
    mesh dims (else ``rest``), all-reduced to ``rest``."""
    from torch.distributed.tensor import DTensor, Partial
    shape = torch.Size(shape)
    out = DTensor.from_local(
        part, mesh, [Partial() if i in cut else p
                     for i, p in enumerate(rest)],
        shape=shape, stride=contiguous_stride(shape))
    return out.redistribute(mesh, rest)


def _ids_like(ids, mesh, rest):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(ids):
        return ids.redistribute(mesh, rest)
    return DTensor.from_local(ids, mesh, [Replicate()] * len(rest))


def take_last(x, idx):
    """``torch.gather(x, -1, idx)`` where ``x``'s last dim may be sharded
    (the chunked CE's gold logit from vocab-sharded logits): each rank
    gathers from its own vocab slice, indices outside it give 0, and the
    partial sums are all-reduced, as XLA lowers the JAX package's
    ``take_along_axis``. (DTensor's own gather strategy leaves a masked
    partial that its mask buffer cannot reduce.) Plain tensors, and a
    last dim that is not sharded, take ``torch.gather``."""
    from torch.distributed.tensor import Replicate
    cut, span = _vocab_split(x, -1)
    if not cut:
        return torch.gather(x, -1, idx)
    lo, n = span
    mesh = x.device_mesh
    rest = [Replicate() if i in cut else p
            for i, p in enumerate(x.placements)]
    idx = _ids_like(idx, mesh, rest)
    li = idx.to_local()
    mine = (li >= lo) & (li < lo + n)
    got = torch.gather(local(x), -1, (li - lo).clamp(0, n - 1))
    got = torch.where(mine, got, torch.zeros_like(got))
    return _partial_sum(got, mesh, cut, rest, idx.shape)


def embedding(ids, table):
    """``F.embedding(ids, table)`` where ``table``'s rows (the vocab) may
    be sharded: each rank looks up the ids in its own rows, others give
    zero rows, and the partial sums are all-reduced, the rows' gradient
    landing on the rank that holds them. Plain tensors, and an unsplit
    vocab, take ``F.embedding``."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    cut, span = _vocab_split(table, 0)
    if not cut:
        return F.embedding(ids, table)
    lo, n = span
    mesh = table.device_mesh
    # the ids' sharding on the mesh dims that do not split the vocab
    rest = [p if (is_dtensor(ids) and i not in cut) else Replicate()
            for i, p in enumerate(ids.placements if is_dtensor(ids)
                                  else table.placements)]
    ids = _ids_like(ids, mesh, rest)
    li = ids.to_local()
    mine = (li >= lo) & (li < lo + n)
    # a data shard's rows take only its own tokens' share of the gradient
    grad = [Shard(0) if i in cut else Partial()
            if isinstance(rest[i], Shard) else Replicate()
            for i in range(len(rest))]
    rows = F.embedding((li - lo).clamp(0, n - 1),
                       local(table, grad))
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return _partial_sum(rows, mesh, cut, rest,
                        tuple(ids.shape) + (table.shape[1],))


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)`` where the last dim may be sharded (the
    CE over vocab-sharded logits): the max and the sum of exponentials
    are all-reduced, not the logits gathered. Plain tensors, and an
    unsplit last dim, take ``torch.logsumexp``."""
    if not _vocab_split(x, -1)[0]:
        return torch.logsumexp(x, dim=-1)
    m = reduce_partial(x.detach().amax(dim=-1, keepdim=True))
    total = reduce_partial(torch.exp(x - m).sum(dim=-1))
    return torch.log(total) + m[..., 0]


def repeat_kv(k, rep: int, q):
    """GQA's K or V [B, S, KV, hd] repeated to the query heads
    (``torch.repeat_interleave(k, rep, dim=2)``) and placed as ``q``
    [B, S, KV * rep, hd] is. Where ``q``'s heads are sharded and ``k``'s
    are not (qwen3-8b: 32 query heads, 8 KV heads, a ``model`` axis of
    16), a rank's query heads must meet their own KV heads: each rank
    takes, by its head offset, the KV head of each of its query heads
    (query head h reads KV head h // rep), so nothing is gathered, and
    the gradient comes back as a partial sum over those mesh dims."""
    if not is_dtensor(q):
        return torch.repeat_interleave(k, rep, dim=2)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, qp = q.device_mesh, list(q.placements)
    heads = [i for i, p in enumerate(qp) if isinstance(p, Shard)
             and p.dim == 2]
    if not is_dtensor(k):
        k = DTensor.from_local(k, mesh, [Replicate()] * len(qp))
    kp = list(k.placements)
    split = [i for i in heads if kp[i] == Shard(2)]
    want = [kp[i] if i in split else Replicate() if i in heads else qp[i]
            for i in range(len(qp))]
    k = k.redistribute(mesh, want)
    if len(split) == len(heads):
        # K/V split as the query heads: the local repeat lines up
        shard = torch.repeat_interleave(local(k), rep, dim=2)
    else:
        if split:
            raise ValueError(f"K/V heads split over some of the query "
                             f"heads' mesh dims only: {kp} vs {qp}")
        _, off = compute_local_shape_and_global_offset(q.shape, mesh, qp)
        n = q.to_local().shape[2]
        grad = [Partial() if i in heads else p for i, p in enumerate(want)]
        idx = (int(off[2]) + torch.arange(n, device=k.to_local().device)) \
            // rep
        shard = local(k, grad).index_select(2, idx)
    shape = torch.Size(tuple(k.shape[:2]) + (q.shape[2],)
                       + tuple(k.shape[3:]))
    return DTensor.from_local(shard, mesh, qp, shape=shape,
                              stride=contiguous_stride(shape))


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` of [B, S, H, hd] attention inputs, run on each
    rank's own batch rows and heads when ``q`` is a DTensor: the three are
    pinned to ``q``'s splits of dims 0 and 2 (the sequences whole), and
    ``fn`` runs on their local shards as plain tensors, so a chunked
    attention's many small ops cost no DTensor dispatch and no batched
    product flattens a split dim. Plain tensors: ``fn(q, k, v)``."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    want = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in q.placements)
    # contiguous: the local gradients come back contiguous, and a
    # DTensor's stride must describe its local shard's
    q, k, v = (pin(t, want).contiguous() for t in (q, k, v))
    out = fn(local(q), local(k), local(v))
    shape = torch.Size(tuple(q.shape[:3]) + tuple(out.shape[3:]))
    return DTensor.from_local(out, q.device_mesh, want, shape=shape,
                              stride=contiguous_stride(shape))


def local_rows(fn, rows, whole=()):
    """``fn(*rows, *whole)`` run on each rank's own batch rows: where the
    first of ``rows`` (batch-first tensors) is a DTensor, every one of
    ``rows`` is pinned to its batch split (dim 0 split as the first one's
    is, every other dim whole, a partial sum reduced) and every one of
    ``whole`` (weights) is replicated, and ``fn`` runs on their local
    shards as plain tensors. A recurrence over heads that the mesh cannot
    split (xLSTM's 4 over 16 ranks) so runs with its heads whole on each
    rank, its many small ops outside DTensor's dispatch; a weight's
    gradient comes back as a partial sum over the batch's mesh dims.
    ``fn`` returns a tuple of tensors, batch first, which come back as
    DTensors split as the rows are. Plain tensors: ``fn(*rows, *whole)``."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *whole)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = rows[0].device_mesh
    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in rows[0].placements)
    rep = (Replicate(),) * len(want)
    grad = [Partial() if isinstance(p, Shard) else p for p in want]
    out = fn(*[local(pin(t, want).contiguous()) for t in rows],
             *[local(pin(t, rep), grad) for t in whole])
    B = rows[0].shape[0]

    def back(t):
        shape = torch.Size((B,) + tuple(t.shape[1:]))
        return DTensor.from_local(t.contiguous(), mesh, want, shape=shape,
                                  stride=contiguous_stride(shape))
    return tuple(back(t) for t in out)


def local_channels(fn, x, *weights):
    """``fn(x, *weights)`` of a [B, S, C] tensor and per-channel weights
    (their last dim C) run on each rank's shard where ``x`` is a DTensor:
    ``x`` pinned with its sequence whole and its rows and channels split
    as they were, each weight split over its channels as ``x`` is (a
    weight's gradient a partial sum over the mesh dims that split the
    rows), and ``fn`` on the local shards as plain tensors; the output
    comes back split as ``x``. A depthwise causal conv's shifted slices so
    cost no DTensor dispatch (torch 2.11's DTensor cannot pad a tensor
    split over both mesh dims). Plain tensors: ``fn(x, *weights)``."""
    if not is_dtensor(x):
        return fn(x, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    last = x.ndim - 1
    want = tuple(p if isinstance(p, Shard) and p.dim in (0, last)
                 else Replicate() for p in x.placements)
    x = pin(x, want)

    def split(t):
        pl = tuple(Shard(t.ndim - 1) if isinstance(p, Shard) and p.dim == last
                   else Replicate() for p in want)
        grad = [Partial() if isinstance(p, Shard) and p.dim == 0 else q
                for p, q in zip(want, pl)]
        return local(pin(t, pl), grad)
    out = fn(local(x.contiguous()), *[split(t) for t in weights])
    shape = torch.Size((x.shape[0],) + tuple(out.shape[1:-1])
                       + (x.shape[-1],))
    return DTensor.from_local(out.contiguous(), x.device_mesh, want,
                              shape=shape, stride=contiguous_stride(shape))


def heads_whole(q):
    """``q`` [B, S, H, hd] with its head dim gathered (``Replicate`` where
    it was sharded): decode's one-token query meets a cache sharded over
    the sequence, not the heads."""
    if not is_dtensor(q):
        return q
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
            for p in q.placements]
    return q if want == list(q.placements) else \
        q.redistribute(q.device_mesh, want)


def reduce_partial(t):
    """A DTensor whose partial placements (a sum or max over a sharded
    dim) are all-reduced to ``Replicate``; other tensors as they are."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


_DATA_AXES = ("pod", "data", POD_DATA)


def gather_fsdp(t):
    """A weight DTensor with its data-axis shards gathered (FSDP's
    all-gather right before use; its ``model`` shards stay, Megatron's
    tensor parallelism). Its backward is the gradient's reduce-scatter
    over the data axes. A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    want = [Replicate() if n in _DATA_AXES else p
            for n, p in zip(names, t.placements)]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _log_sigmoid_rules():
    """DTensor sharding rules for ``F.logsigmoid``'s two ops, which
    DTensor has none for (its backward): pointwise, so each keeps its
    input's placements, replicated or split on any dim. The forward's
    second output is the CPU kernel's buffer (``exp(-|x|)``, laid out as
    the input) or, on CUDA, an empty tensor, which stays replicated. Each
    rank runs the op on its shard, so every element is the one-device
    op's, bitwise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    def pointwise(x):
        return [Replicate()] + [Shard(d) for d in range(len(x.shape))]

    def alike(buf, p):
        return p if len(buf.shape) and buf.shape[0] else Replicate()

    @register_sharding(aten.log_sigmoid_forward.default)
    def _(x):
        cuda = x.mesh.device_type == "cuda"
        return [([p, Replicate() if cuda else p], [p]) for p in pointwise(x)]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _(grad, x, buf):
        return [([p], [p, p, alike(buf, p)]) for p in pointwise(x)]


if torch.distributed.is_available():
    _log_sigmoid_rules()
