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

A sharded tree's leaves are pulled instead (``pull``): one at a time, in
the image's leaf order, on the calling thread, each gathered leaf is
encoded (device stage or host capture), written through the same
executor path and dropped before the next pull; a leaf whose record is
re-emitted is not pulled.

State is a plain nested dict of tensors. Paths are built as the JAX
package builds them ("params/stack/b0/attn/wq") and dicts are flattened in
sorted key order, as JAX does, so both packages write the same manifest
for the same state."""
from __future__ import annotations

import dataclasses
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


def leaf_paths_of(tree) -> list:
    """Leaf paths of ``tree`` in flatten order — what a manifest lists."""
    return [p for p, _ in flatten_with_paths(tree)]


def dump(tree, root, *, step: int, image_id: str | None = None,
         meta: dict | None = None, parent: str | None = None,
         codec_policy=None, prev_host_tree: dict | None = None,
         replicas=(), topology: dict | None = None,
         chunk_bytes: int = chunking.CHUNK_BYTES, chunking_mode: str = "fixed",
         process_index: int = 0, num_processes: int = 1,
         executor: CheckpointExecutor | None = None,
         reuse_records: dict | None = None,
         device_codec: str = "off", device_source=None,
         device="cuda", pull=None) -> dict:
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
    tensors. ``pull(path, leaf)`` (a sharded tree, whose DTensor leaves
    are planned by their global shapes) returns each leaf's full tensor,
    called in plan order on the calling thread for every leaf whose
    record is not re-emitted (``_run_pulled``)."""
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

    if pull is not None:
        if device_source is not None or num_processes > 1:
            raise ValueError("a pulled dump is one process's and reads no "
                             "other device source")
        with tier.writer():
            out = _run_pulled(plan, live, pull, ex, tier, replicas,
                              prev_host_tree,
                              device_codec_mod.resolve_mode(device_codec,
                                                            dev), dev)
            return _commit(plan, out, tier, replicas, step=step, meta=meta,
                           parent=parent, topology=topology, device=dev,
                           process_index=process_index,
                           num_processes=num_processes)

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
    # SAME tier object (sessions sharing a mem://, remote:// or
    # cache+remote:// URI) waits here instead of reaping chunks this dump
    # has written but not yet referenced from a committed manifest
    with tier.writer():
        out = ex.run_dump(plan, arrays, tier, replicas,
                          prev_host_tree=prev_host_tree, encoded=encoded,
                          device=dev)
        return _commit(plan, out, tier, replicas, step=step, meta=meta,
                       parent=parent, topology=topology, device=dev,
                       process_index=process_index,
                       num_processes=num_processes)


def _commit(plan, out, tier, replicas, *, step, meta, parent, topology,
            device, process_index, num_processes) -> dict:
    """The manifest of an executed plan: the refcount journal, then the
    manifest (or this process's part), committed last. Runs inside the
    tier's writer guard."""
    man = manifest.build(plan.image_id, step=step, leaves=out["records"],
                         meta=meta or {}, parent=parent,
                         env=manifest.env_fingerprint(device),
                         topology=topology)
    journal = tier.ref_journal()
    if journal is not None and num_processes == 1:
        # refcount journal entry lands BEFORE the manifest (both
        # inside the writer guard): a crash between the two leaves an
        # orphan ref (bounded leak, swept later), never a committed
        # manifest whose chunks a peer job's gc may reap
        journal.publish(
            plan.image_id,
            {h for rec in out["records"] for h in rec["chunks"]},
            manifest_rel=tier.manifest_path(plan.image_id))
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


def _run_pulled(plan, live, pull, ex, tier, replicas, prev_host_tree,
                on_device: bool, dev) -> dict:
    """``ex.run_dump`` of ``plan`` one leaf at a time, each leaf pulled
    first (``pull(path, leaf)`` on the calling thread, in plan order: the
    gathers of a sharded tree are collectives, so no worker thread issues
    one). The pulled tensor goes to the device stage (an eligible leaf,
    encoded and landed inline) or to the host, and is dropped before the
    next pull; the leaf's chunks are written before it too, so the dump
    holds one gathered leaf at a time. A leaf the plan re-emits from a
    cached record is not pulled: should its chunks have left the pool,
    the executor's fall-back to a full encode finds no array and fails
    the dump."""
    by_path = {lp.path: lp for lp in plan.leaves}
    records, stats = [], {}
    for path, leaf in live:
        sub = dataclasses.replace(plan, leaves=(by_path[path],))
        if by_path[path].reuse is not None:
            out = ex.run_dump(sub, {}, tier, replicas, device=dev)
        else:
            x = pull(path, leaf)
            encoded = device_codec_mod.encode_leaves(
                sub, {path: x}, prev_host_tree, None, device=dev) \
                if on_device else {}
            arrays = {} if path in encoded else \
                {path: to_host(x, copy=False)}
            del x
            out = ex.run_dump(sub, arrays, tier, replicas,
                              prev_host_tree=prev_host_tree,
                              encoded=encoded, device=dev)
            del arrays, encoded
        records += out["records"]
        for k, v in out["stats"].items():
            stats[k] = stats.get(k, 0) + v
    return {"records": records, "stats": stats}


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
    journal = tier.ref_journal()
    if journal is not None:
        # the merged manifest is the whole distributed image — publish
        # its full chunk set before the commit point (same crash
        # ordering as the single-process path)
        journal.publish(image_id,
                        {h for r in leaves for h in r["chunks"]},
                        manifest_rel=tier.manifest_path(image_id))
    blob = manifest.to_json(man)
    tier.write_bytes(tier.manifest_path(image_id), blob, atomic=True)
    for r in replicas:
        r.write_bytes(r.manifest_path(image_id), blob, atomic=True)


def host_tree_by_path(tree) -> dict:
    """Snapshot {path: np.ndarray} — kept by callers that use delta8."""
    return {p: to_host(a) for p, a in flatten_with_paths(tree)}

