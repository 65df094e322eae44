"""repro_torch.core — CRIU-style userspace checkpoint/restore for torch jobs.

The engine room of the port: plan/execute pipeline (core/plan.py,
core/executor.py), content-addressed storage tiers (file://, mem://, and
remote:// and cache+remote:// over a simulated object store, with the
cross-job chunk pool and its refcount journal: core/remote.py,
core/chunkindex.py),
integrity + replica repair, leaf codecs with the Hopper codec kernels
(core/compression.py, core/device_codec.py), the image registry, pre-copy
dirty tracking (core/predump.py, K5 on the card), lazy post-copy restore
(core/lazy.py), async dumps (core/async_engine.py) and the
preempt-to-migrate lifecycle (core/preempt.py, core/migration.py: signal
-> pre-copy rounds -> migration dump -> exit 85 -> resume). Images are
byte-compatible
with the JAX package's: the same state dumps to the same chunks and
manifest, and an image written by either package restores in the other.

    from repro_torch.core import dump, restore

    dump(state, "mem://ck", step=3, device="cuda")
    state, manifest = restore("mem://ck", device="cuda")
"""
from __future__ import annotations

from repro_torch.core.compression import default_policy
from repro_torch.core.dump import dump, flatten_with_paths, host_tree_by_path
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.integrity import CorruptionError, tree_digest
from repro_torch.core.lazy import LazyState, LeafServer, lazy_restore
from repro_torch.core.migration import (MIGRATION_META_KEY, MigrationManifest,
                                        MigrationOrchestrator, ResumeReport,
                                        generator_from_record, resume,
                                        rng_record)
from repro_torch.core.plan import (DumpPlan, LeafPlan, RestorePlan, plan_dump,
                                   plan_restore)
from repro_torch.core.predump import (DirtyLeafTracker, digest_pairs,
                                      leaf_digest, tensor_digest)
from repro_torch.core.preempt import EXIT_CHECKPOINTED, PreemptionHandler
from repro_torch.core.registry import Registry
from repro_torch.core.remote import (CachingTier, RemoteTier,
                                     SimulatedObjectStore, TransferError)
from repro_torch.core.restore import (latest_image_id, place, read_manifest,
                                      restore, restore_pairs)
from repro_torch.core.state import serve_meta, train_meta
from repro_torch.core.storage import LocalDirTier, MemoryTier, as_tier

__all__ = [
    "default_policy", "dump", "flatten_with_paths", "host_tree_by_path",
    "CheckpointExecutor", "get_default_executor", "CorruptionError",
    "tree_digest", "DumpPlan", "LeafPlan", "RestorePlan", "plan_dump",
    "plan_restore", "latest_image_id", "read_manifest", "restore",
    "restore_pairs", "place", "LocalDirTier", "MemoryTier", "as_tier",
    "Registry", "MIGRATION_META_KEY", "MigrationManifest", "ResumeReport",
    "resume", "serve_meta", "train_meta", "Checkpointer", "LazyState",
    "LeafServer", "lazy_restore", "DirtyLeafTracker", "digest_pairs",
    "leaf_digest", "tensor_digest", "MigrationOrchestrator",
    "EXIT_CHECKPOINTED", "PreemptionHandler", "AsyncCheckpointer",
    "rng_record", "generator_from_record", "CachingTier", "RemoteTier",
    "SimulatedObjectStore", "TransferError",
]

# Names resolved through repro_torch.api on first access, and the legacy
# facades (which subclass api.CheckpointSession). Lazy because
# repro_torch.api imports repro_torch.core submodules: a top-level import
# here would cycle whichever package is imported second into a
# partially-initialized first.
_API_EXPORTS = (
    "API_VERSION", "CheckpointSession",
    "SessionConfig", "RetentionPolicy", "CodecPolicy", "AsyncPolicy",
    "PreemptionPolicy", "MigrationPolicy",
    "DumpRequest", "DumpReceipt", "RestoreRequest", "RestoreResult",
    "MigrateRequest", "MigrationTicket",
    "capabilities", "Capability", "CapabilityReport", "TABLE1",
)
_FACADE_EXPORTS = ("Checkpointer", "AsyncCheckpointer")


def __getattr__(name):
    if name in _API_EXPORTS:
        import repro_torch.api
        obj = getattr(repro_torch.api, name)
    elif name in _FACADE_EXPORTS:
        from repro_torch.core import facade
        obj = getattr(facade, name)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    globals()[name] = obj       # cache: one class object per process
    return obj


def __dir__():
    return sorted(set(globals()) | set(_API_EXPORTS) | set(_FACADE_EXPORTS))
