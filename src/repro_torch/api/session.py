"""CheckpointSession: the one door to the port's checkpoint/restore engine.

Ported from the JAX package's api/session.py. A session is opened from a
typed SessionConfig (or a root URI) on an explicit device — where codecs
run and restored leaves are placed, "cuda" by default — owns the storage
tiers, the registry and the plan/execute engine, and exposes the typed
operations:

    sess = CheckpointSession("mem://serve", device="cuda")
    receipt = sess.dump(DumpRequest(state=state, step=s, meta=meta))
    res = sess.restore(RestoreRequest())          # latest image, verified
    tree, man = sess.load_latest()                # raw restore

What is ported: sync dumps (``dump`` with mode="sync", ``save``),
pre-copy rounds (``dump`` with mode="pre_dump", ``pre_dump``) and the
residual dump after them, eager and lazy restore (``restore``,
``load_latest``, ``load``), dry-run ``plan``, retention and gc after every
dump, incremental delta8 chains. Not yet: the async mode and the
migration orchestrator (``migrate``, ``pre_dump_round``,
``should_predump`` and the preemption machinery) raise
NotImplementedError; ``capabilities`` does not exist yet.

The dirty classifier of pre-copy runs on the card: an fp32 or bf16 leaf
on the card is digested there by K5 (core/predump.py), and a leaf whose
record a dump re-emits is never copied to the host.

One tier object is shared between the dumper and its registry: gc must
update the same in-memory chunk index the dump path dedups against."""
from __future__ import annotations

import time

from repro_torch.api.config import SessionConfig
from repro_torch.api.requests import (DumpReceipt, DumpRequest, MigrateRequest,
                                      MigrationTicket, RestoreRequest,
                                      RestoreResult)
from repro_torch.core.dump import dump as _dump
from repro_torch.core.dump import flatten_with_paths, host_tree_by_path
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.plan import DumpPlan, plan_dump
from repro_torch.core.registry import Registry
from repro_torch.core.restore import restore as _restore
from repro_torch.core.storage import as_tier
from repro_torch.device import resolve_device


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


class CheckpointSession:
    """Typed facade over the plan/execute engine (see module docstring).

    Example::

        sess = CheckpointSession(SessionConfig(root="file:///ckpts"),
                                 device="cuda")
        sess.dump(DumpRequest(state=state, step=1))
        res = sess.restore(RestoreRequest())
    """

    def __init__(self, config: SessionConfig | str, *, device="cuda",
                 **overrides):
        """``config`` is a SessionConfig, or a root tier reference (URI,
        path or Tier) for the all-defaults session; ``overrides`` are
        SessionConfig field replacements for the shorthand form."""
        if not isinstance(config, SessionConfig):
            config = SessionConfig(root=config, **overrides)
        elif overrides:
            config = SessionConfig(**{
                **{f.name: getattr(config, f.name)
                   for f in config.__dataclass_fields__.values()},
                **overrides})
        self.config = config
        self.device = resolve_device(device)
        self.tier = as_tier(config.root)
        self.replicas = [as_tier(r) for r in config.replicas]
        self.codec_policy = config.codec.to_leaf_policy()
        self.incremental = config.codec.incremental
        self.chunk_bytes = config.chunk_bytes
        self.keep_last = config.retention.keep_last
        self.keep_every = config.retention.keep_every
        self.executor = config.executor or (
            CheckpointExecutor(serial=True) if config.serial
            else get_default_executor())
        self.registry = Registry(self.tier)
        self._prev_host = None  # for delta8 chains
        self._prev_step = None  # step whose image _prev_host belongs to
        self._prev_image = None  # image id _prev_host is the content of
        self._tracker = None    # lazy DirtyLeafTracker (pre-dump rounds)

    # ------------------------------------------------------------ lifecycle
    def __enter__(self):
        if self.config.preemption.install_signals:
            raise _not_ported("signal-driven preemption (PreemptionPolicy."
                              "install_signals)")
        return self

    def __exit__(self, exc_type, exc, tb):
        """Nothing to drain: every dump of a port session is sync."""

    # ------------------------------------------------------- typed requests
    def dump(self, request: DumpRequest) -> DumpReceipt:
        """DumpRequest -> DumpReceipt (the image is durable when this
        returns). mode="pre_dump" runs one iterative pre-copy round (see
        pre_dump()) and returns a committed receipt whose stats carry the
        dirty/clean split; mode="async" is not ported yet.

        Example::

            sess.dump(DumpRequest(state=state, step=s, mode="pre_dump"))
            ...                       # serving goes on, the cache drifts
            sess.dump(DumpRequest(state=state, step=s2))   # residual only
        """
        if not isinstance(request, DumpRequest):
            raise TypeError(f"dump() takes a DumpRequest, got "
                            f"{type(request).__name__} — build one, or use "
                            f"the legacy save() shim")
        t0 = time.monotonic()
        if request.mode == "pre_dump":
            out = self.pre_dump(request.state, step=request.step,
                                meta=request.meta,
                                topology=request.topology)
            return DumpReceipt(step=int(request.step), mode="pre_dump",
                               committed=True, image_id=out["image_id"],
                               stats=out["stats"],
                               duration_s=time.monotonic() - t0)
        if request.mode != "sync":
            raise _not_ported(f'DumpRequest(mode="{request.mode}")')
        out = self.save(request.state, step=request.step, meta=request.meta,
                        topology=request.topology)
        return DumpReceipt(step=int(request.step), mode="sync",
                           committed=True, image_id=out["image_id"],
                           stats=out["stats"],
                           duration_s=time.monotonic() - t0)

    def restore(self, request: RestoreRequest | None = None) -> RestoreResult:
        """RestoreRequest -> RestoreResult: image -> migration record ->
        topology plan -> digest verification of the decoded bytes ->
        placement on the session's device. ``target_struct`` is a nested
        dict of tensors (``meta`` ones do) giving the leaves' shapes and
        dtypes. ``lazy=True`` is the post-copy restore: the result's state
        is a core.lazy.LazyState whose leaves fault in onto the session's
        device, ``prefetch_order`` first."""
        from repro_torch.core.migration import resume
        req = request or RestoreRequest()
        if not isinstance(req, RestoreRequest):
            raise TypeError(f"restore() takes a RestoreRequest, got "
                            f"{type(req).__name__}")
        if req.shardings is not None or req.mesh is not None:
            raise _not_ported("restore onto a mesh (shardings / mesh)")
        rep = resume(self.tier, expected=req.target_struct,
                     device=self.device, host_count=req.host_count,
                     dp_degree=req.dp_degree,
                     global_batch=req.global_batch, image_id=req.image_id,
                     replicas=self.replicas, executor=self.executor,
                     verify_digest=(req.verify_digest
                                    and self.config.migration.verify_digest),
                     allow_env_mismatch=req.allow_env_mismatch,
                     lazy=req.lazy, prefetch_order=req.prefetch_order)
        return RestoreResult(
            state=rep.state, image_id=rep.manifest["image_id"],
            step=int(rep.migration.step), manifest=rep.manifest,
            migration=rep.migration, topology_changed=rep.topology_changed,
            changes=rep.changes, host_count=rep.host_count,
            dp_degree=rep.dp_degree, data=rep.data,
            digest_verified=rep.digest_verified, report=rep,
            lazy=req.lazy)

    def migrate(self, request: MigrateRequest) -> MigrationTicket:
        raise _not_ported("migrate() (the preempt-to-migrate dump side)")

    def should_predump(self) -> bool:
        raise _not_ported("should_predump() (the migration orchestrator)")

    def pre_dump_round(self, state, *, step: int | None = None) -> dict:
        raise _not_ported("pre_dump_round() (the migration orchestrator's "
                          "budgeted rounds; the bare engine entry point "
                          "pre_dump() is ported)")

    # --------------------------------------------------------- engine: save
    def _save_kw(self, step, meta, topology, with_parent: bool = True):
        parent = None
        prev_host = self._prev_host
        if not self.incremental:
            # no parent link will ever be written, so a delta8 leaf could
            # never be decoded — force full encodes
            prev_host = None
        elif with_parent:
            parent, prev_host = self.registry.resolve_parent_baseline(
                self._prev_step, prev_host, step,
                baseline_image=self._prev_image)
        kw = dict(step=step, meta=meta or {}, parent=parent,
                  codec_policy=self.codec_policy,
                  prev_host_tree=prev_host, topology=topology or {},
                  chunking_mode=self.config.codec.chunking,
                  device_codec=self.config.codec.device)
        if self.chunk_bytes:
            kw["chunk_bytes"] = self.chunk_bytes
        return kw

    def _classify(self, tree):
        """(reuse_records, digests) from the dirty tracker — ({}, None)
        when no pre-dump round has warmed it, so sessions that never
        pre-dump pay nothing for the machinery."""
        if self._tracker is None or not self._tracker.warm:
            return {}, None
        from repro_torch.core.predump import digest_pairs
        digests = digest_pairs(flatten_with_paths(tree),
                               executor=self.executor)
        return self._tracker.reuse_for(digests), digests

    def save(self, tree, *, step: int, meta: dict | None = None,
             topology: dict | None = None) -> dict:
        """Raw-dict sync dump (the engine under DumpRequest(mode="sync")):
        blocks until the image is durable, returns {"image_id", "stats",
        "records"}; then applies retention and gc. After pre-dump rounds
        this is automatically the residual dump — digest-unchanged leaves
        re-emit cached records and are never copied to the host.

        Example::

            out = sess.save(state, step=7)
            print(out["image_id"], out["stats"]["bytes_stored"])
        """
        # residual-dump path: after pre-dump rounds, digest-unchanged
        # leaves re-emit their cached records — the freeze window pays
        # only for the dirty set (plus the classification pass itself)
        reuse, digests = self._classify(tree)
        out = _dump(tree, self.tier, replicas=self.replicas,
                    executor=self.executor, device=self.device,
                    reuse_records=reuse,
                    **self._save_kw(step, meta, topology))
        if digests is not None:
            self._tracker.update(digests, out["records"], out["image_id"],
                                 pre_dump=False)
        self._committed(tree, step, out)
        return out

    def _committed(self, tree, step, out):
        """After a dump of ``tree`` committed as ``out``: advance the delta8
        baseline to it, then apply retention and gc."""
        if self.codec_policy is not None and self.incremental:
            self._prev_host = host_tree_by_path(tree)
            self._prev_step = step
            self._prev_image = out["image_id"]
        self.registry.retain(self.keep_last, self.keep_every)
        self.registry.gc()

    def pre_dump(self, tree, *, step: int, meta: dict | None = None,
                 topology: dict | None = None) -> dict:
        """One iterative pre-copy round (CRIU `criu pre-dump`): commit a
        complete, restorable image of the current state while the job goes
        on, writing only leaves dirtied since the previous round. The
        dirty tracker remembers this round's records, so the *final* dump
        at the step boundary (an ordinary save()/DumpRequest) writes only
        the residual dirty set — that is the stop-the-world window this
        call exists to shrink.

        Returns {"image_id", "stats", "records"}; stats carry
        ``leaves_dirty``/``leaves_clean``/``predump_round``. Rounds never
        delta8-encode (a reused record must decode parent-free — see
        core/predump.py), but they do advance the session's delta8
        baseline so the final dump's dirty leaves delta against the last
        round's image.

        Example::

            r = sess.pre_dump(state, step=12)
            print(r["image_id"], r["stats"]["leaves_clean"])
        """
        from repro_torch.core.predump import (PRE_DUMP_META_KEY,
                                              DirtyLeafTracker, digest_pairs)
        if self._tracker is None:
            self._tracker = DirtyLeafTracker()
        pairs = flatten_with_paths(tree)
        digests = digest_pairs(pairs, executor=self.executor)
        reuse = self._tracker.reuse_for(digests)
        latest = self.registry.latest()
        parent = latest["image_id"] if latest else None
        rnd = self._tracker.rounds
        existing = set(self.tier.image_ids())
        image_id = f"step_{int(step):010d}p{rnd:02d}"
        while image_id in existing:   # a foreign session's round at this
            rnd += 1                  # step: never overwrite an image a
            image_id = f"step_{int(step):010d}p{rnd:02d}"   # delta child
            #                           may decode through
        kw = self._save_kw(step, {**(meta or {}),
                                  PRE_DUMP_META_KEY: {
                                      "round": rnd,
                                      "dirty": len(pairs) - len(reuse),
                                      "clean": len(reuse)}},
                           topology, with_parent=False)
        kw.update(parent=parent, prev_host_tree=None)
        out = _dump(tree, self.tier, replicas=self.replicas,
                    executor=self.executor, image_id=image_id,
                    reuse_records=reuse, device=self.device, **kw)
        self._tracker.update(digests, out["records"], out["image_id"],
                             pre_dump=True)
        self._committed(tree, step, out)
        out["stats"]["predump_round"] = rnd
        out["stats"]["leaves_dirty"] = len(pairs) - len(reuse)
        out["stats"]["leaves_clean"] = len(reuse)
        return out

    # --------------------------------------------------------- engine: plan
    def plan(self, tree_or_abstract, *, step: int = 0) -> DumpPlan:
        """Dry-run dump plan (works on ``meta`` tensors — no device or tier
        access): leaf partition, codec decisions, sizes."""
        from repro_torch.core.chunking import CHUNK_BYTES
        return plan_dump(flatten_with_paths(tree_or_abstract), step=step,
                         codec_policy=self.codec_policy,
                         prev_host_tree=self._prev_host,
                         chunk_bytes=self.chunk_bytes or CHUNK_BYTES,
                         chunking=self.config.codec.chunking)

    # --------------------------------------------------------- engine: load
    def load_latest(self, target_struct=None):
        """Raw restore of the newest image -> (tree, manifest) on the
        session's device. The typed path (RestoreRequest) adds the
        migration record and digest check on top.

        Example::

            tree, man = sess.load_latest()
        """
        return _restore(self.tier, device=self.device,
                        expected=target_struct, replicas=self.replicas,
                        executor=self.executor)

    def load(self, image_id: str, target_struct=None):
        """Raw restore of a specific image id -> (tree, manifest).

        Example::

            tree, man = sess.load("step_0000000040")
        """
        return _restore(self.tier, image_id, device=self.device,
                        expected=target_struct, replicas=self.replicas,
                        executor=self.executor)
