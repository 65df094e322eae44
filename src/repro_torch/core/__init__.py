"""repro_torch.core — CRIU-style userspace checkpoint/restore for torch jobs.

The engine room of the port: plan/execute pipeline (core/plan.py,
core/executor.py), content-addressed storage tiers (file:// and mem://),
integrity + replica repair, leaf codecs with the Hopper codec kernels
(core/compression.py, core/device_codec.py), the image registry, pre-copy
dirty tracking (core/predump.py, K5 on the card), lazy post-copy restore
(core/lazy.py) and the restore side of migration (core/migration.py). Images are byte-compatible
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
                                        ResumeReport, resume)
from repro_torch.core.plan import (DumpPlan, LeafPlan, RestorePlan, plan_dump,
                                   plan_restore)
from repro_torch.core.predump import (DirtyLeafTracker, digest_pairs,
                                      leaf_digest, tensor_digest)
from repro_torch.core.registry import Registry
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
    "leaf_digest", "tensor_digest",
]


def __getattr__(name):
    # the facade imports repro_torch.api, which imports this package:
    # resolve it on first use (PEP 562) so neither import order cycles
    if name == "Checkpointer":
        from repro_torch.core.facade import Checkpointer
        return Checkpointer
    raise AttributeError(name)
