"""What one step moves and what it holds, counted while the step runs:
the dry run's bytes accessed and memory analysis (launch/dryrun.py).

``StepCost`` is a ``TorchDispatchMode``, so it runs in the same trace as
``FlopCounterMode`` and sees every aten op that reaches the dispatcher (a
composite op as the ops it decomposes into; an op a selective checkpoint
serves from its cache is never run, and counts nothing). On the ``meta``
device and on CPU tensors it gives the same numbers.

Bytes accessed (``bytes_accessed``), per op:

- a view or metadata op (``func.is_view``: view, slice, select,
  transpose, expand, unbind, ``detach``, ...) counts 0, and so does
  ``_unsafe_view``, a reshape's view that its schema does not mark;
- ``_c10d_functional._wrap_tensor_autograd`` hands a collective's output
  to autograd: on a device a wrapper over the same storage, on ``meta``
  a new storage from its fake. It is counted as the device holds it:
  bytes as any op's, the new storage as the input's, which stays live as
  long as either does (scripts/torch_gather_peak_card.py: on the H100 a
  12.9 MB gather along dim 1, its concatenation and one use hold 25.76
  MB, the card's peak and this count on meta; the fake's own storage
  made a third copy);
  shape queries never reach the dispatcher; ``empty``, ``empty_like``
  and ``empty_strided`` only allocate, and count 0;
- any other op counts the bytes of its tensor inputs, each read once,
  and of its tensor outputs, each written once. An in-place op's mutated
  operand is both, so it counts once as read and once as written; an
  ``out=`` operand counts only as written;
- a gather-class op (``embedding``, ``index_select``, ``gather``,
  ``index``) counts the rows it reads, which are its output's bytes, and
  its indices, not the whole source; and its output as written.

A tensor's bytes are its element count times its element size: a view
counts its own elements, not its storage's.

Live bytes (``live``, ``peak``): a storage that an op allocates is live
from that op until the storage is freed. A storage is the op's own when
the op is not a view and its output does not share an input's storage.
Its end is seen through ``weakref.finalize`` on the storage object,
which torch keeps alive exactly as long as the storage. Storages that
existed before the block (the step's arguments) are never counted.
``peak`` is the most bytes live at once: the step's temp above its
arguments. Autograd's saved tensors, the gradients, a microbatch loop's
accumulation buffers and what a remat policy recomputes all count for as
long as they are really held.

The counter must not change what it counts. Under any dispatch mode
autograd adds the contributions to one gradient out of place (torch's
``isTensorSubclassLike`` holds whenever a mode is on). Without one, on
the card (measured on an H100, torch 2.11), it adds the second
contribution to the first out of place and every later one into that sum
in place. So an ``add`` in a backward pass whose first operand is the sum
of such an earlier ``add`` and is freed before the next op counts as
that in-place add: its output raises no peak.

FLOPs (``flops``): each op's count from torch's FLOP formulas
(``torch.utils.flop_counter``'s registry, which ``FlopCounterMode``
reads; the flash op registers K6's), so matmul-class ops only.

The local program: a step over DTensors (a multi-device mesh,
distributed/sharding.py) is counted as this rank runs it. An op on
DTensors is handed back to DTensor (the mode returns NotImplemented),
which runs it as ops on the local shards, and those are what the mode
counts, with the collectives its redistributions issue. (``FlopCounterMode``
entered above DTensor counts the global op: a (16, 16) mesh's sharded
matmul as 256 times its local work.) The ops that DTensor's sharding
propagation runs on FakeTensors to learn output shapes run uncounted.

Collectives (``collectives``): every ``_c10d_functional`` collective,
per kind (all-gather, all-reduce, reduce-scatter, all-to-all), its count,
its operand bytes (the input a rank contributes) and the JAX package's
ring-traffic model of the bytes a rank moves (``TRAFFIC``), with the
group size from its process group; ``"total"`` sums the kinds, as the
JAX package's ``collective_stats`` reports them.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
_funcol = torch.ops._c10d_functional

_NO_DATA = {aten.empty, aten.empty_like, aten.empty_strided,
            aten._unsafe_view, _funcol.wait_tensor}
# hands a collective's output to autograd: on a device the same storage
# (a wrapper), on meta a new one from its fake
_WRAP = "_c10d_functional::_wrap_tensor_autograd"
# collective -> (kind, position of its group-size argument or None)
_COLLECTIVES = {
    _funcol.all_gather_into_tensor: ("all-gather", 1),
    _funcol.reduce_scatter_tensor: ("reduce-scatter", 2),
    _funcol.all_reduce: ("all-reduce", None),
    _funcol.all_to_all_single: ("all-to-all", None),
}
# ring-traffic model, bytes moved per participating device per byte of
# operand (the JAX package's launch/dryrun.py _TRAFFIC)
TRAFFIC = {"all-gather": lambda p: p - 1,
           "all-reduce": lambda p: 2 * (p - 1) / p,
           "reduce-scatter": lambda p: (p - 1) / p,
           "all-to-all": lambda p: (p - 1) / p,
           "collective-permute": lambda p: 1.0}
_GATHER = {aten.embedding, aten.index_select, aten.gather, aten.index}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors in an op's arguments or outputs: tensors, and tuples,
    lists and dicts of them (what aten schemas hold)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _is_fake(tree) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in _tensors(tree))


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def collective_totals(stats: dict) -> dict:
    """``stats`` (kind -> {count, operand_bytes, modeled_traffic_bytes})
    with its ``"total"`` entry."""
    kinds = {k: v for k, v in stats.items() if k != "total"}
    return {**kinds, "total": {
        f: sum(v[f] for v in kinds.values())
        for f in ("count", "operand_bytes", "modeled_traffic_bytes")}}


class StepCost(TorchDispatchMode):
    """Counts ``bytes_accessed`` and tracks ``live`` / ``peak`` bytes of
    the storages allocated inside the block (the module's rules)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives = {}        # kind -> count, operand and traffic
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._own = {}               # id(storage) -> (nbytes, finalizer)
        self._open = True
        self._held = None            # an add's (first operand, peak with it)
        self._sums = set()           # storages that gradient adds made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented    # DTensor runs it as local ops
        kwargs = kwargs or {}
        if _is_fake((args, kwargs)):
            return func(*args, **kwargs)
        self._settle()
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if _is_fake(out):            # a factory under DTensor's propagation
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if packet in _COLLECTIVES:
            self._collective(packet, args)
        if func.is_view or packet in _NO_DATA:
            return out
        outs = _tensors(out)
        out_names = {a.name for a in func._schema.arguments if a.is_out}
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k not in out_names}))
        written = sum(tensor_bytes(t) for t in outs)
        if packet in _GATHER:
            indices = [t for t in ins if not t.is_floating_point()]
            read = written + sum(tensor_bytes(t) for t in indices)
        else:
            read = sum(tensor_bytes(t) for t in ins)
        self.bytes_accessed += read + written
        inputs = {id(t.untyped_storage()) for t in ins}
        inputs |= {id(t.untyped_storage()) for t in _tensors(kwargs)}
        if func._schema.name == _WRAP:
            self._alias(ins[0].untyped_storage(), outs[0].untyped_storage())
            return out
        peak = self.peak
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in inputs and id(st) not in self._own:
                self._allocate(st)
        first = args[0] if args else None
        if (func is aten.add.Tensor and not torch.is_grad_enabled()
                and not kwargs and isinstance(first, torch.Tensor)
                and id(first.untyped_storage()) in self._own):
            # a gradient's contributions added by autograd
            key = id(first.untyped_storage())
            self._sums.add(id(outs[0].untyped_storage()))
            if key in self._sums and self.peak > peak:
                # into a running sum: settled at the next op, once it is
                # known whether nothing else held the sum
                self._held = (key, self.peak)
                self.peak = peak
        return out

    def _collective(self, packet, args):
        kind, at = _COLLECTIVES[packet]
        p = int(args[at]) if at is not None else _group_size(args[-1])
        n = tensor_bytes(args[0])
        s = self.collectives.setdefault(kind, {
            "count": 0, "operand_bytes": 0, "modeled_traffic_bytes": 0.0})
        s["count"] += 1
        s["operand_bytes"] += n
        s["modeled_traffic_bytes"] += n * TRAFFIC[kind](p)

    def _settle(self):
        """An add held back: in place if its first operand is gone."""
        if self._held is not None:
            key, peak = self._held
            self._held = None
            if key in self._own:
                self.peak = max(self.peak, peak)

    def _alias(self, src, st):
        """``st`` holds ``src``'s bytes (a wrapper on a device): ``src``
        stays live while ``st`` does, and ``st`` counts nothing."""
        if st is not src:
            weakref.finalize(st, lambda keep=src: None)

    def _allocate(self, st):
        key, n = id(st), st.nbytes()
        self._own[key] = (n, weakref.finalize(st, self._free, key))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key):
        if self._open:
            n, _ = self._own.pop(key)
            self.live -= n
            self._sums.discard(key)

    def __exit__(self, *exc):
        self._settle()
        self._open = False           # storages that outlive the block
        for _, fin in self._own.values():
            fin.detach()
        return super().__exit__(*exc)
