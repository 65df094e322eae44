"""Typed request/response pairs for the service façade — the libcriu-RPC
analogue: every operation on a CheckpointSession is a frozen request object
in and a frozen receipt/result/ticket object out.

  DumpRequest    -> DumpReceipt       (criu dump)
  RestoreRequest -> RestoreResult     (criu restore, incl. cross-topology)
  MigrateRequest -> MigrationTicket   (preempt-to-migrate: dump + exit 85)

Requests carry only caller intent; everything environment-shaped (tiers,
policies, executor) lives in the SessionConfig the session was opened with.

A copy of the JAX package's api/requests.py: the same fields and wire
kinds, so a JAX fleet coordinator can drive a torch job. Every
request/receipt here is also a WIRE MESSAGE (repro_torch.api.wire): it
round-trips through ``to_wire()``/``from_wire(dict)`` with an explicit
``schema_version``, rejecting future-major peers and tolerating unknown
fields within a major. Runtime-only fields (the live ``state`` pytree, an
open ``iterator``) never travel — a fleet coordinator sends the request
with those unset and the job-side FleetClient supplies them."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.wire import WireRecord


# ------------------------------------------------------------------- dump
@dataclasses.dataclass(frozen=True)
class DumpRequest(WireRecord):
    """Dump ``state`` (a device/host pytree) as the image for ``step``.

    mode: "sync" blocks until the image is durable; "async" captures the
    device state synchronously (the step barrier) and returns immediately —
    the receipt is pending until CheckpointSession.wait(); "pre_dump" runs
    one iterative pre-copy round (CRIU `criu pre-dump`): a complete,
    restorable image written while training continues, paying only for
    leaves dirtied since the previous round, so the *next* sync dump's
    stop-the-world window shrinks to the residual dirty set.

    Example::

        sess.dump(DumpRequest(state=state, step=s, mode="pre_dump"))
        ...                                    # more training steps
        sess.dump(DumpRequest(state=state, step=s2))   # residual dump
    """
    state: Any
    step: int
    meta: dict | None = None
    topology: dict | None = None
    mode: str = "sync"                    # "sync" | "async" | "pre_dump"

    # the live pytree never travels: a coordinator sends state=None and
    # the job-side FleetClient substitutes its own device state
    _WIRE_OPAQUE = ("state",)

    def __post_init__(self):
        if self.mode not in ("sync", "async", "pre_dump"):
            raise ValueError(f"DumpRequest.mode must be 'sync', 'async' or "
                             f"'pre_dump', got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class DumpReceipt(WireRecord):
    """Proof of a dump. ``committed`` is False for an async request that has
    been captured+enqueued but not yet waited on (image_id/stats arrive with
    the receipts returned by CheckpointSession.wait()).

    Example::

        r = sess.dump(DumpRequest(state=state, step=s, mode="async"))
        assert not r.committed
        (r2,) = sess.wait()                # now durable
        print(r2.image_id, r2.stats["bytes_stored"])
    """
    step: int
    mode: str
    committed: bool
    image_id: str | None = None
    stats: dict | None = None
    duration_s: float | None = None


# ---------------------------------------------------------------- restore
@dataclasses.dataclass(frozen=True)
class RestoreRequest(WireRecord):
    """Restore an image (latest by default) — possibly onto a different
    topology than it was dumped from.

    target_struct: pytree of ShapeDtypeStructs the output must match.
    shardings: matching pytree of Shardings -> leaves are device_put onto
    the new mesh. host_count/dp_degree/global_batch: the topology the job
    is restarting on (None keeps the dumped — or straggler-planned —
    value). verify_digest: check the recorded logical-state digest against
    the decoded bytes before any device placement.

    lazy: post-copy restore (CRIU lazy-pages). The result materializes the
    model *skeleton* immediately; leaf bytes are served on first access by
    a LeafServer over the chunk index (``result.state[...]`` faults leaves
    in; ``result.state.materialize()`` forces the rest). Chunk hashes are
    still verified per read, but the whole-tree digest check is deferred
    to full materialization, and shardings/target-dtype casts apply only
    as leaves arrive. prefetch_order: path prefixes to stream in the
    background first (default: the restore plan's own hint — params before
    optimizer state).

    Example::

        res = sess.restore(RestoreRequest(lazy=True,
                                          prefetch_order=("params",)))
        logits = model.apply(res.state["params"], x)   # faults params in
        res.state.materialize()                        # the rest, eagerly
    """
    image_id: str | None = None
    target_struct: Any = None
    shardings: Any = None
    mesh: Any = None
    host_count: int | None = None
    dp_degree: int | None = None
    global_batch: int | None = None
    verify_digest: bool = True
    allow_env_mismatch: bool = True
    lazy: bool = False
    prefetch_order: tuple | None = None

    # device-shaped runtime objects stay with the job; the restoring
    # FleetClient supplies its own struct/shardings/mesh
    _WIRE_OPAQUE = ("target_struct", "shardings", "mesh")
    _WIRE_TUPLES = ("prefetch_order",)


@dataclasses.dataclass(frozen=True)
class RestoreResult:
    """The restored state plus everything the next incarnation needs: the
    migration record, the topology-change plan, and the remapped data
    cursor. Wraps core.migration.ResumeReport (kept at ``report``).

    When ``lazy`` is True, ``state`` is a core.lazy.LazyState: the tree
    skeleton exists now, leaf bytes arrive on first access (or from the
    background prefetcher) — call ``state.materialize()`` for a plain
    nested dict.

    Example::

        res = sess.restore(RestoreRequest(host_count=2, dp_degree=2))
        state, it = res.state, res.make_iterator(dataset)
        assert res.digest_verified is not False
    """
    state: Any
    image_id: str
    step: int
    manifest: dict
    migration: Any                    # core.migration.MigrationManifest
    topology_changed: bool
    changes: dict
    host_count: int
    dp_degree: int
    data: dict
    digest_verified: bool | None      # None: image predates digests
    report: Any = None                # the underlying ResumeReport
    lazy: bool = False                # state is a LazyState (post-copy)

    def make_iterator(self, ds, *, dp_rank: int = 0, dp_size: int = 1,
                      prefetch: int = 2):
        """Rebuild the data iterator at the remapped cursor (see
        core.migration.ResumeReport.make_iterator for the dp_rank/dp_size
        contract — they are the data-feeding process layout, not the mesh
        DP degree)."""
        return self.report.make_iterator(ds, dp_rank=dp_rank,
                                         dp_size=dp_size, prefetch=prefetch)


# ---------------------------------------------------------------- migrate
@dataclasses.dataclass(frozen=True)
class MigrateRequest(WireRecord):
    """Turn "this job must go away" into a durable, restorable image.

    state: the device pytree to dump. iterator: the live data iterator
    (quiesced and cursor-captured). reason: recorded in the migration
    manifest when no signal/escalation already set one.

    Example::

        if sess.should_migrate():
            ticket = sess.migrate(MigrateRequest(state=state, iterator=it))
            sys.exit(ticket.exit_code)
    """
    state: Any
    iterator: Any = None
    step: int | None = None
    data_state: dict | None = None
    rng: Any = None
    meta_extra: dict | None = None
    opt_cfg: Any = None
    reason: str | None = None

    # live job objects (pytree, open iterator, PRNG key, optimizer cfg)
    # never travel; the FleetClient fills them at execution time
    _WIRE_OPAQUE = ("state", "iterator", "rng", "opt_cfg")


@dataclasses.dataclass(frozen=True)
class MigrationTicket(WireRecord):
    """The dump side's half of a migration: the image is durable, the
    process should exit with ``exit_code`` (85, HTCondor's self-checkpoint
    convention) and the next incarnation resumes from ``image_id`` on
    whatever topology it gets.

    Example::

        ticket = sess.migrate(MigrateRequest(state=state))
        log.info("image %s durable in %.2fs", ticket.image_id,
                 ticket.latency_s)
        sys.exit(ticket.exit_code)          # 85: reschedule me anywhere
    """
    exit_code: int
    image_id: str
    step: int
    reason: str | None
    latency_s: float
    record: Any                       # core.migration.MigrationManifest

    def _wire_encode_field(self, name: str, value):
        # the migration record is a frozen dataclass with a JSON form of
        # its own (to_meta) — reuse it rather than inventing a second one
        if name == "record" and value is not None:
            return value.to_meta()
        return super()._wire_encode_field(name, value)

    @classmethod
    def _wire_decode_field(cls, name: str, value):
        if name == "record" and isinstance(value, dict):
            from repro_torch.core.migration import MigrationManifest
            known = {f.name for f in dataclasses.fields(MigrationManifest)}
            return MigrationManifest(**{k: v for k, v in value.items()
                                        if k in known})
        return super()._wire_decode_field(name, value)
