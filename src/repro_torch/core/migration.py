"""Migration records and the restore side of preempt-to-migrate.

Ported from the JAX package's core/migration.py:

  MigrationManifest  the record an image carries under meta["migration"]
                     (topology, data cursor, logical-state digest, why) —
                     the same fields and JSON form, so either package reads
                     the other's records;
  resume             image -> migration record -> topology-change plan ->
                     bit-identity check of the decoded bytes -> placement
                     on the session's device; or, with ``lazy=True``, a
                     post-copy skeleton whose digest check runs when it
                     fully materializes (core/lazy.py).

The dump side (``MigrationOrchestrator``: signal -> drain -> migration
dump -> exit 85, with its budgeted pre-copy rounds) is not ported yet and
raises.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any

from repro_torch.core.elastic import plan_topology_change
from repro_torch.core.integrity import CorruptionError, tree_digest

log = logging.getLogger(__name__)

MIGRATION_META_KEY = "migration"
MIGRATION_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MigrationManifest:
    """What the next incarnation needs to carry on — stored (JSON) under
    meta["migration"] of the dump, next to but independent of the array
    manifest. Topology fields are a *record* of where the image came from,
    never a requirement on where it restores."""
    step: int
    arch: str = ""
    host_count: int = 1
    dp_degree: int = 1
    mesh_axes: list = dataclasses.field(default_factory=list)
    global_batch: int | None = None
    data: dict = dataclasses.field(default_factory=dict)   # iterator cursor
    rng: list | None = None            # e.g. raw PRNGKey words
    state_digest: str | None = None    # integrity.tree_digest of the dump
    reason: str | None = None          # SIGTERM / straggler / request / ...
    planned_host_count: int | None = None   # straggler escalation: restart
    planned_dp_degree: int | None = None    # ... already minus slow hosts
    hosts_dropped: list = dataclasses.field(default_factory=list)

    def to_meta(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = MIGRATION_VERSION
        return d

    @classmethod
    def from_meta(cls, meta: dict) -> "MigrationManifest":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in meta.items() if k in fields})

    @classmethod
    def from_image(cls, manifest: dict) -> "MigrationManifest":
        """Read the record off an image manifest; synthesize a minimal one
        from train_meta/topology for pre-migration images (the lifecycle
        must be able to adopt any existing checkpoint)."""
        meta = manifest.get("meta", {})
        if MIGRATION_META_KEY in meta:
            return cls.from_meta(meta[MIGRATION_META_KEY])
        topo = manifest.get("topology", {})
        return cls(step=meta.get("step", manifest.get("step", 0)),
                   arch=meta.get("arch", ""),
                   host_count=topo.get("host_count", 1),
                   dp_degree=topo.get("dp_degree", 1),
                   mesh_axes=topo.get("axes", []),
                   global_batch=meta.get("data", {}).get("global_batch"),
                   data=meta.get("data", {}))


class MigrationOrchestrator:
    """The dump side of preempt-to-migrate (signal handling, straggler
    escalation, pre-copy rounds, the exit-85 migration dump): not ported
    to repro_torch yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MigrationOrchestrator (SIGTERM -> migration dump -> exit 85) is "
            "not ported to repro_torch yet")


@dataclasses.dataclass
class ResumeReport:
    state: Any
    manifest: dict
    migration: MigrationManifest
    topology_changed: bool
    changes: dict
    host_count: int
    dp_degree: int
    data: dict                    # remapped cursor (validate_elastic output)
    digest_verified: bool | None  # None: image predates digests

    def make_iterator(self, ds, **kw):
        raise NotImplementedError(
            "the data pipeline (data/pipeline.py) is not ported to "
            "repro_torch yet")


def resume(root, *, expected=None, device="cuda",
           host_count: int | None = None, dp_degree: int | None = None,
           global_batch: int | None = None, image_id: str | None = None,
           replicas=(), executor=None, verify_digest: bool = True,
           allow_env_mismatch: bool = True, lazy: bool = False,
           prefetch_order=None) -> ResumeReport:
    """Restore-side lifecycle: image -> migration record -> topology-change
    plan -> bit-identity verification -> placement on ``device``.

    Digest verification runs on the raw decoded pairs BEFORE placement and
    before any cast to ``expected``'s dtypes: what is proven is that the
    bytes that came back are the bytes that were dumped, independent of
    where they are about to live. A mismatch raises CorruptionError.
    ``expected`` (nested dict of ``meta`` tensors) plays the role of the
    JAX package's target_struct.

    lazy: post-copy restore — the report's ``state`` is a LazyState whose
    skeleton is immediate and whose leaves fault in onto ``device`` on
    access (prefetched in ``prefetch_order``; see core/lazy.py). Chunk
    hashes are still verified per read; the whole-tree digest check cannot
    run before the leaves exist, so ``digest_verified`` stays None in the
    report and the recorded digest is instead checked automatically the
    moment the tree fully materializes (state.materialize() —
    CorruptionError on mismatch, exactly like the eager path, just
    deferred); ``expected`` does not apply to a tree that isn't there yet
    — materialize() first, then cast."""
    from repro_torch.core.restore import place, restore_pairs

    if lazy:
        if expected is not None:
            raise ValueError(
                "lazy restore serves leaves on fault; target_struct applies "
                "after materialize() — restore eagerly, or cast the "
                "materialized tree yourself")
        from repro_torch.core.lazy import lazy_restore
        tree, man, server = lazy_restore(
            root, image_id, replicas=replicas, executor=executor,
            prefetch_order=prefetch_order,
            allow_env_mismatch=allow_env_mismatch, device=device)
        if verify_digest:
            # deferred bit-identity: the server checks this digest when
            # the tree fully materializes (LazyState.materialize /
            # LeafServer.verify_tree_digest) — the lazy analogue of the
            # eager pre-placement check below
            server.expected_digest = \
                MigrationManifest.from_image(man).state_digest
        pairs = None
    else:
        pairs, man = restore_pairs(root, image_id, device=device,
                                   replicas=replicas, executor=executor,
                                   allow_env_mismatch=allow_env_mismatch)
    rec = MigrationManifest.from_image(man)
    plan = plan_topology_change(
        {**dataclasses.asdict(rec), "data": rec.data},
        new_host_count=host_count, new_dp_size=dp_degree,
        global_batch=global_batch)

    digest_ok: bool | None = None
    if lazy:
        verify_digest = False     # nothing to digest until leaves arrive
    if verify_digest and rec.state_digest:
        got = tree_digest(pairs)     # raw decoded bytes, pre-cast/pre-place
        digest_ok = got == rec.state_digest
        if not digest_ok:
            raise CorruptionError(man["image_id"],
                                  [f"state digest {got[:12]} != recorded "
                                   f"{rec.state_digest[:12]}"])
    if plan["changed"]:
        log.info("topology change on resume of %s: %s", man["image_id"],
                 plan["changes"])
    if not lazy:
        tree = place(pairs, device, expected)
    return ResumeReport(state=tree, manifest=man, migration=rec,
                        topology_changed=plan["changed"],
                        changes=plan["changes"],
                        host_count=plan["host_count"],
                        dp_degree=plan["dp_degree"], data=plan["data"],
                        digest_verified=digest_ok)
