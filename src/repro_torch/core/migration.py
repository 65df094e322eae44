"""Preempt-to-migrate: the paper's central workflow as one testable
lifecycle, ported from the JAX package's core/migration.py.

The batch scheduler (OSPool/HTCondor) interrupts a running job at an
arbitrary point; the job must turn that interrupt into a restorable image
and a rescheduling request, and the *next* incarnation — possibly on a
different machine shape, or in the other framework — must carry on:

  dump side (MigrationOrchestrator):
    SIGTERM / SIGUSR2 / straggler escalation
      -> flag only (never dump mid-step; the step boundary is the quiesce
         point)
      -> optional pre-copy rounds while training goes on (pre_dump_round)
      -> at the boundary: quiesce the data pipeline, drain in-flight async
         dumps (their images are the incremental parents of this one),
         dump the live tensors with a migration record (topology, DP
         degree, data cursor, RNG, logical-state digest, why), wait for
         durability, exit EXIT_CHECKPOINTED (85: "reschedule me anywhere")

  restore side (resume):
    latest image -> migration record -> topology-change plan -> bit-identity
    check of the decoded bytes -> placement on the session's device; or,
    with ``lazy=True``, a post-copy skeleton whose digest check runs when
    it fully materializes (core/lazy.py).

MigrationManifest has the JAX package's fields and JSON form, so either
package reads the other's records. Port difference: the ``rng`` field of a
record the port writes for a ``torch.Generator`` is tagged with its
framework (``rng_record``); a resume that finds another framework's rng
reports it as foreign and re-seeds (``generator_from_record``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.dump import flatten_with_paths
from repro_torch.core.elastic import plan_topology_change
from repro_torch.core.integrity import CorruptionError, tree_digest
from repro_torch.core.preempt import EXIT_CHECKPOINTED, PreemptionHandler
from repro_torch.core.state import train_meta
from repro_torch.device import to_host

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
    rng: list | dict | None = None     # raw key words, or a tagged
    #                                    generator state (rng_record)
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


def _topology_of(mesh, topology: dict | None) -> dict:
    if topology is not None:
        return topology
    from repro_torch.distributed.sharding import mesh_topology
    return mesh_topology(mesh)


def _state_step(state) -> int:
    """The train step of a dict-shaped state: ONE scalar read (``.item()``),
    never a capture of the whole tree."""
    try:
        s = state["step"]
    except (TypeError, KeyError, IndexError):
        pairs = dict(flatten_with_paths(state))
        s = pairs.get("step", 0)
    return int(s.item() if isinstance(s, torch.Tensor) else s)


# ------------------------------------------------------------- rng record
RNG_FRAMEWORK = "torch"


def rng_record(rng):
    """The migration record's ``rng`` field. A ``torch.Generator`` is
    recorded under a framework tag, ``{"framework": "torch", "device": ...,
    "state": hex of get_state()}``; raw key words (what the JAX package
    stores: a PRNGKey) stay a list of ints, as there. ``None`` stays None,
    so a record without one is key for key the JAX package's."""
    if rng is None:
        return None
    if isinstance(rng, torch.Generator):
        state = rng.get_state().numpy().tobytes()
        return {"framework": RNG_FRAMEWORK, "device": str(rng.device),
                "state": state.hex()}
    return [int(w) for w in np.asarray(to_host(rng)).ravel()]


def generator_from_record(rng, *, seed: int = 0, device="cpu"):
    """-> (torch.Generator, how). how is "restored" for a generator state
    the port recorded, "seeded" when the record holds no rng, and
    "foreign" when it holds another framework's (the JAX package's key
    words, or another tag): that state is not reproduced; the generator is
    seeded from ``seed`` and the caller should say so."""
    gen = torch.Generator(device=device)
    if isinstance(rng, dict) and rng.get("framework") == RNG_FRAMEWORK:
        gen.set_state(torch.frombuffer(bytearray.fromhex(rng["state"]),
                                       dtype=torch.uint8))
        return gen, "restored"
    gen.manual_seed(int(seed))
    if rng is None:
        return gen, "seeded"
    log.warning("migration record holds a foreign rng (%s); not reproduced, "
                "re-seeded from %d", rng.get("framework") if isinstance(
                    rng, dict) else "raw key words", seed)
    return gen, "foreign"


class MigrationOrchestrator:
    """Composes PreemptionHandler + StragglerMonitor + a session into the
    dump side of the lifecycle. The training loop owns the step; the
    orchestrator owns everything between "something wants this job gone"
    and "the image is durable, exit 85"."""

    def __init__(self, checkpointer, *, handler: PreemptionHandler | None = None,
                 monitor=None, arch: str = "", mesh=None,
                 topology: dict | None = None, predump_rounds: int = 0):
        self.ckpt = checkpointer
        self.handler = handler or PreemptionHandler()
        self.monitor = monitor
        self.arch = arch
        self.mesh = mesh
        self.topology = topology
        self.predump_rounds = int(predump_rounds)
        self.predump_rounds_run = 0
        self.planned_host_count: int | None = None
        self.planned_dp_degree: int | None = None
        self.hosts_dropped: list = []
        self.last_migration: MigrationManifest | None = None
        self.last_image_id: str | None = None
        self.migrate_latency_s: float | None = None
        self.digest_s: float | None = None   # the last migrate's digest

    # ------------------------------------------------------------ lifecycle
    def install(self):
        self.handler.install()
        return self

    def uninstall(self):
        self.handler.uninstall()

    def __enter__(self):
        return self.install()

    def __exit__(self, *a):
        self.uninstall()

    # ------------------------------------------------------------- triggers
    def should_migrate(self) -> bool:
        """Poll at the step boundary — signals delivered mid-step only set
        the flag; the dump always happens here, never in the handler."""
        return self.handler.preempt_requested()

    def observe_step(self, host_times: list[float]) -> dict:
        """Feed per-host step times to the straggler policy and make its
        advice executable: ``checkpoint_and_replace`` escalates into a
        preemption request whose migration record pre-plans the shrunken
        fleet (restart defaults to N - dropped hosts)."""
        if self.monitor is None:
            return {"action": "none", "hosts": []}
        self.monitor.observe(host_times)
        advice = self.monitor.advice()
        if advice["action"] == "checkpoint_and_replace" \
                and not self.handler.preempt_requested():
            drop = list(advice["hosts"])
            keep = advice.get("suggested_host_count",
                              max(1, self.monitor.num_hosts - len(drop)))
            self.hosts_dropped = drop
            self.planned_host_count = keep
            # the restart DP degree scales with the surviving devices but
            # must preserve the dumped model-parallel factor: with
            # devices = dp * mp, dropping hosts shrinks dp, never mp. An
            # indivisible shape records no plan (resume() then keeps the
            # dumped dp or the caller chooses).
            topo = _topology_of(self.mesh, self.topology)
            dev = topo.get("device_count") or topo.get("host_count", 1)
            hostc = topo.get("host_count", 1) or 1
            dp = topo.get("dp_degree", 1) or 1
            mp = max(1, dev // dp)
            planned_devices = keep * max(1, dev // hostc)
            self.planned_dp_degree = planned_devices // mp \
                if planned_devices % mp == 0 else None
            self.handler.request("straggler")
            log.warning("straggler escalation: dropping hosts %s, planned "
                        "restart fleet %d", drop, keep)
        return advice

    def should_predump(self) -> bool:
        """True while a preemption is pending and configured pre-copy
        rounds remain: the loop should run pre_dump_round() and keep
        training toward its drain boundary instead of migrating yet. The
        rounds stream state out while steps still make progress, so the
        eventual migrate() freezes only for the residual dirty set."""
        return (self.handler.preempt_requested()
                and self.predump_rounds_run < self.predump_rounds)

    def pre_dump_round(self, state, *, step: int | None = None) -> dict:
        """One iterative pre-copy round between the preemption signal and
        the boundary drain (CRIU `criu pre-dump` before the final
        `criu dump`). Delegates to the session's pre_dump — a complete,
        restorable image whose cost is only the leaves dirtied since the
        previous round, classified where they lie (K5 on the card) — and
        counts it against ``predump_rounds``. The step is one scalar read,
        not a capture of the tree."""
        if step is None:
            step = _state_step(state)
        out = self.ckpt.pre_dump(
            state, step=step,
            topology=_topology_of(self.mesh, self.topology))
        self.predump_rounds_run += 1
        log.info("pre-dump round %d/%d: image %s (%d dirty / %d clean "
                 "leaves)", self.predump_rounds_run, self.predump_rounds,
                 out["image_id"], out["stats"]["leaves_dirty"],
                 out["stats"]["leaves_clean"])
        return out

    # ----------------------------------------------------------------- dump
    def build_manifest(self, *, step: int, data_state: dict | None,
                       state_digest: str | None, rng=None) -> MigrationManifest:
        topo = _topology_of(self.mesh, self.topology)
        data = data_state or {}
        gb = data.get("global_batch")
        planned_dp = self.planned_dp_degree
        if planned_dp and gb and gb % planned_dp:
            planned_dp = None   # indivisible plan would fail every default
            #                     restart; let resume fall back / choose
        return MigrationManifest(
            step=int(step), arch=self.arch,
            host_count=topo.get("host_count", 1),
            dp_degree=topo.get("dp_degree", 1),
            mesh_axes=topo.get("axes", []),
            global_batch=data.get("global_batch"),
            data=data,
            rng=rng_record(rng),
            state_digest=state_digest,
            reason=self.handler.reason,
            planned_host_count=self.planned_host_count,
            planned_dp_degree=planned_dp,
            hosts_dropped=self.hosts_dropped)

    def migrate(self, state, iterator=None, *, step: int | None = None,
                data_state: dict | None = None, rng=None,
                meta_extra: dict | None = None, opt_cfg=None) -> int:
        """The preempt path, start to durable: quiesce -> drain -> dump with
        migration record -> wait. Returns EXIT_CHECKPOINTED for the caller
        to sys.exit() with (the orchestrator never exits by itself — tests
        and multi-stage launchers need the control back).

        Port difference: the dump gets the live tensors, as
        ServeEngine.checkpoint hands them over, so after pre-dump rounds K5
        classifies them on the card and only dirty leaves are captured.
        The host copy is taken only for the tree digest, one leaf at a
        time, and only under a lossless codec policy.

        On a mesh (DTensor leaves; every rank calls it, as it calls
        pre_dump_round) the digest is a pass of its own before the dump:
        each leaf gathered to rank 0 alone and hashed there
        (integrity.tree_digest; its seconds in ``digest_s``); the dump
        after rounds classifies each rank's local shards and gathers only
        the dirty leaves."""
        t0 = time.monotonic()
        if iterator is not None and hasattr(iterator, "stop_prefetch"):
            iterator.stop_prefetch()
        # drain in-flight async dumps first: they are this image's
        # incremental ancestors and gc must never race their chunks
        self.ckpt.wait()
        if data_state is None and iterator is not None:
            data_state = iterator.state()
        # the digest proves the restored bytes ARE the dumped bytes; a
        # lossy codec policy (delta8/bf16 optimizer state) breaks that
        # identity by design, so record no digest rather than make every
        # lossy migration image fail verification on resume
        t1 = time.monotonic()
        digest = tree_digest(flatten_with_paths(state)) \
            if getattr(self.ckpt, "codec_policy", None) is None else None
        self.digest_s = time.monotonic() - t1
        if step is None:
            step = _state_step(state)
        rec = self.build_manifest(step=step, data_state=data_state,
                                  state_digest=digest, rng=rng)
        meta = train_meta(arch=self.arch or "unknown", step=step,
                          data_state=data_state or {}, opt_cfg=opt_cfg,
                          extra=meta_extra)
        if meta_extra and "serve_plane" in meta_extra:
            # a serving plane migrated through the trainer path: the
            # image must announce itself so restorers rebuild sessions
            meta["job_kind"] = "serve"
            meta["serve_plane"] = meta_extra["serve_plane"]
            if "prefetch_hint" in meta_extra:
                meta["prefetch_hint"] = meta_extra["prefetch_hint"]
        meta[MIGRATION_META_KEY] = rec.to_meta()
        out = self.ckpt.save(state, step=step, meta=meta,
                             topology=_topology_of(self.mesh, self.topology))
        self.ckpt.wait()                 # idempotent; async engines drain
        self.last_migration = rec
        self.last_image_id = out["image_id"]
        self.migrate_latency_s = time.monotonic() - t0
        self.predump_rounds_run = 0   # a later migration pre-copies afresh
        log.info("migrated: image %s at step %d (%s) in %.3fs",
                 out["image_id"], step, rec.reason, self.migrate_latency_s)
        return EXIT_CHECKPOINTED


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

    def make_iterator(self, ds, *, dp_rank: int = 0, dp_size: int = 1,
                      prefetch: int = 2):
        """Remapped data cursor: same global batch -> the bitwise-identical
        global token stream; changed global batch -> the step was remapped
        by validate_elastic to the same token offset.

        dp_rank/dp_size are the DATA-FEEDING process layout — how many
        processes each feed a slice of the batch — NOT the DP degree: a
        single-process job feeds the full global batch (the default), while
        a per-host pipeline passes its own rank and the feeding process
        count (typically host_count)."""
        from repro_torch.data import DataIterator
        state = dict(self.migration.data)
        state["global_batch"] = self.data["global_batch"]
        state["step"] = self.data["step"]
        return DataIterator.restore(ds, state, dp_rank=dp_rank,
                                    dp_size=dp_size, prefetch=prefetch)

    def generator(self, *, seed: int = 0, device="cpu"):
        """-> (torch.Generator, how) from the record's ``rng``: "restored",
        "seeded" (none recorded) or "foreign" (another framework's, not
        reproduced: re-seeded from ``seed``). See generator_from_record."""
        return generator_from_record(self.migration.rng, seed=seed,
                                     device=device)


def resume(root, *, expected=None, shardings=None, mesh=None,
           device="cuda",
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
    — materialize() first, then cast.

    The new topology comes from ``mesh`` (host/DP counts derived, as the
    JAX package derives them) or explicit ``host_count``/``dp_degree``.
    ``shardings`` (a tree of NamedShardings) places the leaves on its
    mesh in place of ``device``: its one device, or, over the ranks of
    the initialised process group, DTensors whose local shards are the
    slices of the leaves; a mesh over several devices without such a
    group raises RuntimeError."""
    from repro_torch.core.restore import place, restore_pairs
    from repro_torch.distributed.sharding import check_tree, placement_device
    from repro_torch.distributed.sharding import place as place_on_mesh

    if mesh is not None:
        placement_device(mesh)          # one device, or raise
        if host_count is None or dp_degree is None:
            topo = _topology_of(mesh, None)
            host_count = host_count or topo["host_count"]
            dp_degree = dp_degree or topo["dp_degree"]
    if shardings is not None:
        device = placement_device(shardings)
    if lazy:
        if expected is not None or shardings is not None:
            raise ValueError(
                "lazy restore serves leaves on fault; target_struct/"
                "shardings apply after materialize() — restore eagerly, or "
                "cast/place the materialized tree yourself")
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
        if shardings is not None:
            check_tree(shardings, tree)
            tree = place_on_mesh(tree, shardings)
    return ResumeReport(state=tree, manifest=man, migration=rec,
                        topology_changed=plan["changed"],
                        changes=plan["changes"],
                        host_count=plan["host_count"],
                        dp_degree=plan["dp_degree"], data=plan["data"],
                        digest_verified=digest_ok)
