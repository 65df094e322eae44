"""criu-dump for torch job state: plan, then execute.

Flow: plan_dump (leaf partition, codec applicability, chunk geometry —
pure data) -> the device codec stage reads its leaves in place -> quiesce
(``.cpu()`` of every other leaf waits for the in-flight work that produces
it — the step boundary IS the quiesce point; leaves re-emitted from a
pre-dump round's records are not captured) ->
CheckpointExecutor pipelines encode+hash and deduplicated pool writes
(unchanged chunks cost nothing — incremental dumps for free) -> manifest
committed last (atomic rename). Multi-host: leaves are partitioned
round-robin by process; each process writes a manifest part and process 0
merges (single-process containers just take the fast path).

State is a plain nested dict of tensors. Paths are built as the JAX
package builds them ("params/stack/b0/attn/wq") and dicts are flattened in
sorted key order, as JAX does, so both packages write the same manifest
for the same state."""
from __future__ import annotations

import json

from repro_torch.core import chunking, manifest
from repro_torch.core import device_codec as device_codec_mod
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.plan import plan_dump
from repro_torch.core.storage import Tier, as_tier
from repro_torch.device import resolve_device, to_host


def flatten_with_paths(tree, prefix: str = "") -> list:
    """-> [(path, leaf)] with dict keys in sorted order (JAX's order);
    lists and tuples contribute their index; None is an empty subtree."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            out.append((path, node))

    walk(tree, prefix)
    return out


def dump(tree, root, *, step: int, image_id: str | None = None,
         meta: dict | None = None, parent: str | None = None,
         codec_policy=None, prev_host_tree: dict | None = None,
         replicas=(), topology: dict | None = None,
         chunk_bytes: int = chunking.CHUNK_BYTES, chunking_mode: str = "fixed",
         process_index: int = 0, num_processes: int = 1,
         executor: CheckpointExecutor | None = None,
         reuse_records: dict | None = None,
         device_codec: str = "off", device_source=None,
         device="cuda") -> dict:
    """Returns {"image_id", "stats", "records"}. ``tree`` is a nested dict
    of tensors (any device) or host arrays. ``prev_host_tree`` (path->np
    array) enables delta8; ``parent`` links the incremental chain;
    ``reuse_records`` re-emits cached records for digest-proven unchanged
    leaves. ``executor`` defaults to the process-wide pipelined engine.
    ``chunking_mode``: "fixed" windows or "cdc" rolling-hash boundaries.
    ``device`` is where the codecs run ("cuda" by default; raises without
    a card unless "cpu" is asked for). ``device_codec`` ("off"/"auto"/"on")
    routes codec-applied fp32 leaves through the fused device
    encode+digest stage (core/device_codec.py), double-buffered against
    the host chunk writes; ``device_source`` is the tree the stage reads —
    by default ``tree`` itself, so the kernels read the live device
    tensors."""
    dev = resolve_device(device)
    tier = as_tier(root)
    replicas = [as_tier(r) for r in replicas]
    ex = executor or get_default_executor()

    live = flatten_with_paths(tree)
    plan = plan_dump(live, step=step, image_id=image_id, parent=parent,
                     codec_policy=codec_policy,
                     prev_host_tree=prev_host_tree, chunk_bytes=chunk_bytes,
                     chunking=chunking_mode,
                     process_index=process_index,
                     num_processes=num_processes,
                     reuse_records=reuse_records)

    encoded = {}
    if device_codec_mod.resolve_mode(device_codec, dev):
        src = dict(flatten_with_paths(device_source)
                   if device_source is not None else live)
        encoded = device_codec_mod.encode_leaves(
            plan, src, prev_host_tree, ex, device=dev)

    # quiesce + capture: .cpu() of every leaf the host path writes (the
    # device stage reads its leaves in place, on the same stream); a leaf
    # whose record is re-emitted is captured only if its reuse falls back
    reused = {lp.path for lp in plan.leaves if lp.reuse is not None}
    arrays = _Capture({p: to_host(a) for p, a in live
                       if p not in encoded and p not in reused},
                      {p: a for p, a in live if p in reused})
    del live
    # the writer guard spans probe->write->commit: a concurrent gc on the
    # SAME tier object (sessions sharing a mem:// URI) waits here instead
    # of reaping chunks this dump has written but not yet referenced from
    # a committed manifest
    with tier.writer():
        out = ex.run_dump(plan, arrays, tier, replicas,
                          prev_host_tree=prev_host_tree, encoded=encoded,
                          device=dev)

        man = manifest.build(plan.image_id, step=step, leaves=out["records"],
                             meta=meta or {}, parent=parent,
                             env=manifest.env_fingerprint(dev),
                             topology=topology)
        if num_processes > 1:
            part = f"images/{plan.image_id}/manifest.part{process_index}.json"
            tier.write_bytes(part, manifest.to_json(man))
            if process_index == 0:
                merge_parts(tier, plan.image_id, num_processes,
                            replicas=replicas)
        else:
            blob = manifest.to_json(man)
            tier.write_bytes(tier.manifest_path(plan.image_id), blob,
                             atomic=True)
            for r in replicas:
                r.write_bytes(r.manifest_path(plan.image_id), blob,
                              atomic=True)
    return {"image_id": plan.image_id, "stats": out["stats"],
            "records": man["leaves"]}


class _Capture(dict):
    """{path: host array} of the leaves the host path writes. A leaf the
    planner re-emits from a cached record is left on its device; if the
    executor falls back to a full encode (its chunks vanished from the
    pool), indexing the leaf captures it then."""

    def __init__(self, captured: dict, deferred: dict):
        super().__init__(captured)
        self._deferred = deferred

    def __missing__(self, path):
        return to_host(self._deferred[path])


def merge_parts(tier: Tier, image_id: str, num_processes: int, replicas=()):
    """Process 0 merges per-process manifest parts into the final manifest
    (commit point for the whole distributed dump — the 'global barrier')."""
    parts = []
    for k in range(num_processes):
        raw = tier.read_bytes(f"images/{image_id}/manifest.part{k}.json")
        parts.append(json.loads(raw))
    base = parts[0]
    leaves = []
    for p in parts:
        leaves.extend(p["leaves"])
    leaves.sort(key=lambda r: r["path"])
    man = manifest.build(image_id, step=base["step"], leaves=leaves,
                         meta=base["meta"], parent=base["parent"],
                         env=base["env"], topology=base["topology"])
    blob = manifest.to_json(man)
    tier.write_bytes(tier.manifest_path(image_id), blob, atomic=True)
    for r in replicas:
        r.write_bytes(r.manifest_path(image_id), blob, atomic=True)


def host_tree_by_path(tree) -> dict:
    """Snapshot {path: np.ndarray} — kept by callers that use delta8."""
    return {p: to_host(a) for p, a in flatten_with_paths(tree)}

