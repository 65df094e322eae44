"""Checkpoint planning: immutable plans separated from execution.

A plan is pure data — which leaves this process owns, which codec each one
gets (applicability resolved up front, so execution never branches on
"would the codec fall back?"), chunk geometry, and for restore the fully
loaded manifest chain. Planning does all per-dump decision making and all
per-restore manifest parsing exactly once; the executor then only moves and
transforms bytes. Plans are cheap to build from abstract leaves (torch
``meta`` tensors), which gives dry-run planning ("what would this dump
look like?") without touching device memory."""
from __future__ import annotations

import dataclasses
from types import MappingProxyType

import numpy as np

from repro_torch.core import manifest as manifest_mod
from repro_torch.core.chunking import CHUNK_BYTES
from repro_torch.core.compression import codec_applicable
from repro_torch.core.integrity import CorruptionError
from repro_torch.device import dtype_name, itemsize


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf this process will encode + store."""
    path: str
    codec: str          # decided codec ("none" if the policy's pick can't apply)
    dtype: str
    shape: tuple
    nbytes: int
    use_prev: bool      # delta8: parent-leaf baseline available
    reuse: dict | None = None   # pre-dump: cached manifest record for a
    #                             provably-unchanged leaf; the executor
    #                             emits it verbatim (no encode/hash/write)
    #                             after probing its chunks are still pooled


@dataclasses.dataclass(frozen=True)
class DumpPlan:
    image_id: str
    step: int
    parent: str | None
    chunk_bytes: int
    process_index: int
    num_processes: int
    leaves: tuple          # tuple[LeafPlan] — only this process's partition
    all_paths: tuple       # every leaf path across processes (round-robin order)
    chunking: str = "fixed"   # chunker: "fixed" windows or "cdc"
    #                           rolling-hash boundaries (chunk_bytes = avg)

    @property
    def num_leaves(self) -> int:
        return len(self.leaves)

    @property
    def total_bytes(self) -> int:
        return sum(lp.nbytes for lp in self.leaves)


@dataclasses.dataclass(frozen=True)
class RestorePlan:
    image_id: str
    manifests: MappingProxyType  # image_id -> manifest, this image + the
    #                              delta8 ancestor chain, each parsed once
    records: MappingProxyType    # image_id -> {path: leaf record}

    @property
    def manifest(self) -> dict:
        return self.manifests[self.image_id]

    @property
    def chain_depth(self) -> int:
        return len(self.manifests)

    def chunk_set(self) -> frozenset:
        """Every chunk hash this restore may read, across the loaded
        manifest chain — the unit peer-fetch wiring and warm-start
        planning reason about (fleet placement scores hosts by overlap
        with exactly this set)."""
        return frozenset(h for m in self.manifests.values()
                         for r in m["leaves"] for h in r["chunks"])

    @property
    def prefetch_order(self) -> tuple:
        """Default lazy-restore streaming order: params first (the forward
        pass touches them before anything else), then misc state, then
        optimizer moments (only the next update step needs those). Within
        a group, manifest order. A restored-but-idle job faulting in this
        order can usually serve/compute before the image fully arrives —
        CRIU's lazy-pages argument, leaf-granular.

        A dump may override the static grouping by recording
        ``meta["prefetch_hint"]`` — an ordered list of path prefixes
        (e.g. the serving plane's activity-ranked sessions): leaves
        matching an earlier prefix stream first; unmatched leaves keep
        the params-first default after all hinted ones."""
        hint = list((self.manifest.get("meta") or {})
                    .get("prefetch_hint") or [])

        def group(path: str) -> int:
            if path.startswith("params/") or path == "params":
                return 0
            if path.startswith("opt/") or "/opt/" in path:
                return 2
            return 1

        def rank(path: str) -> tuple:
            for i, pre in enumerate(hint):
                if path == pre or path.startswith(pre.rstrip("/") + "/"):
                    return (0, i, 0)
            return (1, 0, group(path))
        recs = self.manifest["leaves"]
        return tuple(r["path"] for r in sorted(
            recs, key=lambda r: rank(r["path"])))


def plan_dump(leaves, *, step: int, image_id: str | None = None,
              parent: str | None = None, codec_policy=None,
              prev_host_tree: dict | None = None,
              chunk_bytes: int = CHUNK_BYTES, chunking: str = "fixed",
              process_index: int = 0, num_processes: int = 1,
              reuse_records: dict | None = None) -> DumpPlan:
    """leaves: [(path, array-or-tensor)]. Pure: no tier access,
    no device access — applicability and partition decisions only.

    reuse_records: {path: manifest record} for leaves the dirty tracker
    proved unchanged since a previous image (core/predump.py) — those
    leaves plan as record re-emission instead of encode+store. The caller
    owns the proof (content digest match + portable record); the executor
    still probes chunk presence and falls back to a full encode if the
    pool lost the chunks."""
    policy = codec_policy or (lambda p: "none")
    prev_host_tree = prev_host_tree or {}
    reuse_records = reuse_records or {}
    plans, all_paths = [], []
    for i, (path, leaf) in enumerate(leaves):
        all_paths.append(path)
        if i % num_processes != process_index:
            continue
        if not hasattr(leaf, "dtype"):   # python-scalar / list leaf
            leaf = np.asarray(leaf)
        dtype = dtype_name(leaf)
        shape = tuple(leaf.shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize(dtype)
        reuse = reuse_records.get(path)
        if reuse is not None:
            plans.append(LeafPlan(
                path=path, codec=reuse.get("codec", "none"),
                dtype=dtype, shape=shape, nbytes=nbytes,
                use_prev=False, reuse=reuse))
            continue
        codec = policy(path)
        prev = prev_host_tree.get(path)
        applicable = codec_applicable(codec, dtype, shape, prev)
        use_prev = applicable and codec == "delta8"
        if not applicable:
            codec = "none"
        plans.append(LeafPlan(
            path=path, codec=codec, dtype=dtype, shape=shape,
            nbytes=nbytes, use_prev=use_prev))
    return DumpPlan(
        image_id=image_id or f"step_{int(step):010d}", step=int(step),
        parent=parent, chunk_bytes=int(chunk_bytes),
        process_index=process_index, num_processes=num_processes,
        leaves=tuple(plans), all_paths=tuple(all_paths),
        chunking=str(chunking))


def plan_restore(tier, image_id: str) -> RestorePlan:
    """Load the manifest plus every ancestor manifest a delta8 chain can
    reach — once. The seed path re-read + re-parsed the parent manifest for
    every delta8 leaf (O(leaves x chain) parses); a plan makes chain
    resolution O(chain) parses total."""
    def read(iid):
        return manifest_mod.from_json(
            tier.read_bytes(tier.manifest_path(iid)))

    man = read(image_id)
    manifests, records = {image_id: man}, {}
    cur = man
    while cur["parent"] and any(
            r["codec"] == "delta8" and r["codec_meta"].get("applied")
            for r in cur["leaves"]):
        pid = cur["parent"]
        if pid in manifests:
            # the walk is linear (one parent per image), so revisiting an
            # image means a parent cycle — the executor would deadlock on
            # its own memo future chasing it
            raise CorruptionError(pid, [f"cyclic parent chain via "
                                        f"{cur['image_id']}"])
        cur = read(pid)
        manifests[pid] = cur
    for iid, m in manifests.items():
        records[iid] = MappingProxyType({r["path"]: r for r in m["leaves"]})
    return RestorePlan(image_id=image_id,
                       manifests=MappingProxyType(manifests),
                       records=MappingProxyType(records))
