"""CheckpointSession: the one door to the port's checkpoint/restore engine.

Ported from the JAX package's api/session.py. A session is opened from a
typed SessionConfig (or a root URI) on an explicit device — where codecs
run and restored leaves are placed, "cuda" by default — owns the storage
tiers, the registry, the plan/execute engine and the preemption/migration
machinery, and exposes the typed operations:

    with CheckpointSession(SessionConfig(root="file:///ckpts"),
                           device="cuda") as sess:
        receipt = sess.dump(DumpRequest(state=state, step=s, meta=meta))
        ...
        if sess.should_predump():
            sess.pre_dump_round(state)           # pre-copy, keep training
        elif sess.should_migrate():
            ticket = sess.migrate(MigrateRequest(state=state, iterator=it))
            sys.exit(ticket.exit_code)

    # next incarnation, any machine / topology / framework:
    res = CheckpointSession(cfg, device="cuda").restore(RestoreRequest())

Ported: sync, async and pre-copy dumps (``dump`` with mode="sync" /
"async" / "pre_dump"; ``save``, ``save_async``, ``pre_dump``, ``wait``)
and the residual dump after pre-copy rounds; eager and lazy restore
(``restore``, ``load_latest``, ``load``); dry-run ``plan``; retention and
gc after every dump; incremental delta8 chains; and the migration
lifecycle (``migrate``, ``should_migrate``, ``should_predump``,
``pre_dump_round``, ``observe_step``, signal handlers installed by
``__enter__`` under PreemptionPolicy(install_signals=True)), and the
`criu check` probe ``capabilities``; restore onto a mesh (``shardings=``
/ ``mesh=`` records of distributed/sharding.py) places every leaf on the
mesh's one device, or as DTensors over the ranks of a process group; and
a state of DTensor leaves in every dump mode, ``migrate`` and the tree
digest, every rank calling each: a pre-dump round classifies each rank's
local shards, and every dump streams the leaves it writes to rank 0 one
gathered leaf at a time (an async dump copies them to rank 0's host).

The dirty classifier of pre-copy runs on the card: an fp32 or bf16 leaf
on the card is digested there by K5 (core/predump.py), and a leaf whose
record a dump re-emits is never copied to the host. ``migrate`` hands the
dump the live tensors too. An async dump instead takes a finished host
copy of every leaf before it returns and encodes that copy with the host
codec (core/async_engine.py), because the train step updates the live
tensors in place while the job runs.

One tier object is shared between the dumper and its registry: gc must
update the same in-memory chunk index the dump path dedups against."""
from __future__ import annotations

import time

from repro_torch.api.config import SessionConfig
from repro_torch.api.requests import (DumpReceipt, DumpRequest, MigrateRequest,
                                      MigrationTicket, RestoreRequest,
                                      RestoreResult)
from repro_torch.core.async_engine import AsyncCheckpointer as _AsyncEngine
from repro_torch.core.dump import dump as _dump
from repro_torch.core.dump import flatten_with_paths, host_tree_by_path
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.plan import DumpPlan, plan_dump
from repro_torch.core.registry import Registry
from repro_torch.core.restore import restore as _restore
from repro_torch.core.storage import as_tier
from repro_torch.device import resolve_device, to_host


def _step_of(image_id: str) -> int | None:
    try:
        return int(image_id.rsplit("_", 1)[-1])
    except (ValueError, AttributeError):
        return None


class CheckpointSession:
    """Typed facade over the plan/execute engine (see module docstring).

    Example::

        with CheckpointSession(SessionConfig(root="file:///ckpts"),
                               device="cuda") as s:
            s.dump(DumpRequest(state=state, step=1))
            if s.should_predump():
                s.pre_dump_round(state)          # pre-copy, keep training
            elif s.should_migrate():
                sys.exit(s.migrate(MigrateRequest(state=state)).exit_code)
        res = CheckpointSession("file:///ckpts", device="cuda").restore(
            RestoreRequest(lazy=True))           # post-copy resume
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
        self._prev_digests = None  # a sharded dump's digests of _prev_host
        self._tracker = None    # lazy DirtyLeafTracker (pre-dump rounds)
        self._async = None
        self._drained = []      # async results consumed by sync-save drains
        self._sharded_async = False   # wait() is collective from then on
        self._orch = None       # lazy MigrationOrchestrator
        self._installed = False
        self._closed = False

    def capabilities(self):
        """`criu check` for this session's environment, configuration and
        device: every probe runs the port's own code there."""
        from repro_torch.api.capabilities import capabilities
        return capabilities(self.config, device=self.device)

    # ------------------------------------------------------------ lifecycle
    def _orchestrator(self):
        if self._orch is None:
            from repro_torch.core.migration import MigrationOrchestrator
            from repro_torch.core.preempt import PreemptionHandler
            mig = self.config.migration
            self._orch = MigrationOrchestrator(
                self,
                handler=PreemptionHandler(
                    signals=self.config.preemption.signals),
                monitor=mig.monitor, arch=mig.arch, mesh=mig.mesh,
                topology=mig.topology,
                predump_rounds=mig.predump_rounds)
        return self._orch

    @property
    def handler(self):
        """The session's PreemptionHandler (flag-only signal recorder)."""
        return self._orchestrator().handler

    def __enter__(self):
        if self.config.preemption.install_signals:
            self._orchestrator().install()
            self._installed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(drain=exc_type is None)

    def close(self, drain: bool = True):
        """Drain in-flight async dumps (unless ``drain=False`` — e.g. the
        body raised and durability is moot), release signal handlers and
        the host copy of the delta8 baseline (a dump after close encodes
        in full)."""
        if self._closed:
            return
        self._closed = True
        try:
            if drain and (self._async is not None or self._sharded_async):
                self._wait_raw()
        finally:
            self._prev_host = None
            if self._installed:
                self._orch.uninstall()
                self._installed = False

    # ------------------------------------------------------- typed requests
    def dump(self, request: DumpRequest) -> DumpReceipt:
        """DumpRequest -> DumpReceipt. mode="sync" returns once the image
        is durable; mode="async" returns an uncommitted receipt once the
        state is captured (the committed ones come back from wait());
        mode="pre_dump" runs one iterative pre-copy round (see pre_dump())
        and returns a committed receipt whose stats carry the dirty/clean
        split.

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
        if request.mode == "async":
            if not self.config.async_dumps.enabled:
                raise RuntimeError("async dumps are disabled by this "
                                   "session's AsyncPolicy")
            self.save_async(request.state, step=request.step,
                            meta=request.meta, topology=request.topology)
            return DumpReceipt(step=int(request.step), mode="async",
                               committed=False,
                               duration_s=time.monotonic() - t0)
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
        rep = resume(self.tier, expected=req.target_struct,
                     shardings=req.shardings, mesh=req.mesh,
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

    def wait(self) -> list:
        """Barrier: every async dump enqueued since the last barrier is
        durable (or this raises). Returns their committed DumpReceipts."""
        return [DumpReceipt(step=_step_of(o["image_id"]), mode="async",
                            committed=True, image_id=o["image_id"],
                            stats=o["stats"])
                for o in self._wait_raw()]

    def migrate(self, request: MigrateRequest) -> MigrationTicket:
        """MigrateRequest -> MigrationTicket: quiesce -> drain -> dump of
        the live tensors with the migration record -> durable. The caller
        owns the actual sys.exit(ticket.exit_code)."""
        if not isinstance(request, MigrateRequest):
            raise TypeError(f"migrate() takes a MigrateRequest, got "
                            f"{type(request).__name__}")
        orch = self._orchestrator()
        if not orch.handler.preempt_requested():
            orch.handler.request(request.reason or "request")
        orch.migrate(request.state, request.iterator, step=request.step,
                     data_state=request.data_state, rng=request.rng,
                     meta_extra=request.meta_extra, opt_cfg=request.opt_cfg)
        rec = orch.last_migration
        return MigrationTicket(
            exit_code=self.config.preemption.exit_code,
            image_id=orch.last_image_id, step=rec.step, reason=rec.reason,
            latency_s=orch.migrate_latency_s, record=rec)

    # -------------------------------------------------- preemption / fleet
    def should_migrate(self) -> bool:
        """Poll at the step boundary: did a signal / escalation ask this
        job to go away? (The dump itself always happens here, never in the
        signal handler.)"""
        return self._orchestrator().should_migrate()

    def should_predump(self) -> bool:
        """True while a preemption is pending and MigrationPolicy's
        pre-copy budget (``predump_rounds``) has rounds left: run
        pre_dump_round() and keep training instead of migrating yet.

        Example::

            if sess.should_predump():
                sess.pre_dump_round(state)       # stream, keep stepping
            elif sess.should_migrate():
                ticket = sess.migrate(MigrateRequest(state=state))
                sys.exit(ticket.exit_code)       # residual freeze only
        """
        return self._orchestrator().should_predump()

    def pre_dump_round(self, state, *, step: int | None = None) -> dict:
        """One orchestrated pre-copy round on the way to migration
        (counts against MigrationPolicy.predump_rounds; the bare engine
        entry point is pre_dump())."""
        return self._orchestrator().pre_dump_round(state, step=step)

    def observe_step(self, host_times) -> dict:
        """Feed per-host step times to the straggler policy (configured via
        MigrationPolicy.monitor); persistent stragglers escalate into a
        preemption request whose record pre-plans the shrunken fleet."""
        return self._orchestrator().observe_step(host_times)

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
        re-emit cached records and are never copied to the host. A tree
        with DTensor leaves: every rank calls it (``_save_sharded``).

        Example::

            out = sess.save(state, step=7)
            print(out["image_id"], out["stats"]["bytes_stored"])
        """
        from repro_torch.distributed import sharding as shd
        if shd.has_dtensor(tree):
            return self._save_sharded(tree, step=step, meta=meta,
                                      topology=topology)
        self._drain_async()
        # residual-dump path: after pre-dump rounds, digest-unchanged
        # leaves re-emit their cached records — the freeze window pays
        # only for the dirty set (plus the classification pass itself)
        reuse, digests = self._classify(tree)
        out = _dump(tree, self.tier, replicas=self.replicas,
                    executor=self.executor, device=self.device,
                    reuse_records=reuse,
                    **self._save_kw(step, meta, topology))
        self._dumped(tree, step, out, digests, pre_dump=False)
        return out

    def _save_sharded(self, tree, *, step, meta, topology,
                      pre_dump: bool = False) -> dict:
        """save() or pre_dump() of a tree with DTensor leaves (a
        multi-device mesh): every rank of the group calls it.

        Once the session has run a pre-dump round (and in one), the leaves
        are classified first on each rank's local shards
        (core/predump.py ``digest_pairs``: one K5 launch a rank, and one
        small collective gives every rank the same digests). Rank 0's
        tracker picks the leaves whose records the dump re-emits
        (``_sharded_reuse``) and every rank learns that set. The other
        leaves are gathered one at a time, in the image's leaf order, to
        rank 0 alone (``sharding.gather_leaf``: the other ranks send their
        shards and keep no full copy). Rank 0 pulls each gathered leaf
        through the dump pipeline (core/dump.py ``pull``: the plan, codec,
        device stage, SHA-256 and chunk writes of an unsharded dump) and
        drops it before the next gather, so the image holds the chunk
        bytes and manifest of an unsharded dump of the same values and no
        device holds more than one gathered leaf. Rank 0 keeps the tracker
        and the delta8 baseline (copied to the host as each leaf passes, a
        re-emitted leaf's copy kept from the last dump); every rank gets
        rank 0's image id and stats, or its error."""
        from repro_torch.core.predump import DirtyLeafTracker, digest_pairs
        from repro_torch.distributed import sharding as shd
        if pre_dump and self._tracker is None:
            self._tracker = DirtyLeafTracker()   # every rank: later dumps
            #                                      classify too
        pairs = flatten_with_paths(tree)
        digests = None if self._tracker is None else \
            digest_pairs(pairs, executor=self.executor)
        job = {}

        def decide():                    # rank 0: what the dump re-emits
            self._drain_async()
            job["reuse"] = self._sharded_reuse(digests)
            return sorted(job["reuse"])
        reused = set(shd.rank0_decides(decide))

        def write(pull):                 # rank 0: the dump itself
            reuse, keep = job["reuse"], self._baseline_paths()
            base = {p: self._prev_host[p] for p in reuse if keep(p)}

            def pulled(path, t):
                x = pull(path, t)
                if keep(path):
                    base[path] = to_host(x)
                return x
            if pre_dump:
                rnd, kw = self._round_kw(step, meta, topology, len(pairs),
                                         reuse)
            else:
                kw = self._save_kw(step, meta, topology)
            out = _dump(tree, self.tier, replicas=self.replicas,
                        executor=self.executor, device=self.device,
                        pull=pulled, reuse_records=reuse, **kw)
            self._dumped(tree, step, out, digests, pre_dump=pre_dump,
                         baseline=base)
            if pre_dump:
                self._round_stats(out, rnd, len(pairs), reuse)
            return {"image_id": out["image_id"], "stats": out["stats"]}
        todo = [(p, t) for p, t in pairs if p not in reused]
        return dict(shd.gathered_on_rank0(todo, write), records=None)

    def _sharded_reuse(self, digests) -> dict:
        """Rank 0: the records a sharded dump classified as ``digests``
        re-emits: the tracker's clean leaves whose chunks are all still
        pooled (a re-emitted leaf is not gathered, so the executor's
        fall-back to a full encode would have nothing to read) and, for a
        leaf of the delta8 baseline, whose host copy on rank 0 holds the
        digested content."""
        if digests is None:
            return {}
        keep, held = self._baseline_paths(), self._prev_digests or {}

        def pooled(rec):
            uniq = set(rec["chunks"])
            return len(self.tier.has_chunks(uniq)) == len(uniq)
        return {p: r for p, r in self._tracker.reuse_for(digests).items()
                if (not keep(p) or held.get(p) == digests[p])
                and pooled(r)}

    def _drain_async(self):
        """Drain in-flight async dumps before a sync dump or a pre-copy
        round: the submit-time parent scan must see them committed (causal
        chain), and retain/gc must never run while a dump is still writing
        — gc would reap its not-yet-manifest-referenced chunks. The drained
        results are kept: the next wait() still owes them to the caller."""
        if self._async is not None:
            self._drained.extend(self._async.wait())

    def _dumped(self, tree, step, out, digests, *, pre_dump: bool,
                baseline=None):
        """After a dump of ``tree``, classified as ``digests`` (None: not
        classified), committed as ``out``: the tracker adopts its records,
        then ``_committed``."""
        if digests is not None:
            self._tracker.update(digests, out["records"], out["image_id"],
                                 pre_dump=pre_dump)
        self._committed(tree, step, out, baseline=baseline,
                        digests=None if baseline is None else digests)

    def _committed(self, tree, step, out, baseline=None, digests=None):
        """After a dump of ``tree`` committed as ``out``: advance the delta8
        baseline to it (``baseline``, where the dump already copied it;
        ``digests``, a sharded dump's, of the leaves it holds), then apply
        retention and gc."""
        if self.codec_policy is not None and self.incremental:
            self._prev_host = self._baseline_of(tree) if baseline is None \
                else baseline
            self._prev_digests = digests
            self._prev_step = step
            self._prev_image = out["image_id"]
        self.registry.retain(self.keep_last, self.keep_every)
        self.registry.gc()

    def _baseline_paths(self):
        """-> path -> bool: is the leaf at ``path`` part of the delta8
        baseline (the codec policy delta8-codes it and dumps chain)?"""
        policy = self.codec_policy
        if policy is None or not self.incremental:
            return lambda p: False
        return lambda p: policy(p) == "delta8"

    def _baseline_of(self, tree) -> dict:
        """{path: host array} of the leaves the codec policy delta8-codes:
        the only leaves a later dump encodes against a baseline, copied to
        the host one at a time (the params of a train state stay out)."""
        keep = self._baseline_paths()
        return {p: to_host(a) for p, a in flatten_with_paths(tree)
                if keep(p)}

    def adopt_baseline(self, tree, *, image_id: str, step: int):
        """Take a restored ``tree`` (the decoded content of ``image_id``)
        as the delta8 baseline of this session's next dump. A session
        opened to restore starts with no baseline, so without this its
        first dump encodes every delta8 leaf in full; with it, a dump whose
        parent is ``image_id`` (the latest image in the root, checked at
        dump time) encodes them against the restored values. No-op unless
        the codec policy is lossy and incremental.

        Example::

            res = sess.restore(RestoreRequest(image_id=iid))
            sess.adopt_baseline(res.state, image_id=res.image_id,
                                step=res.step)
        """
        if self.codec_policy is None or not self.incremental:
            return
        self._prev_host = self._baseline_of(tree)
        self._prev_digests = None
        self._prev_step = int(step)
        self._prev_image = image_id

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
        round's image. A tree with DTensor leaves: every rank calls it,
        and it classifies each rank's local shards (``_save_sharded``).

        Example::

            r = sess.pre_dump(state, step=12)
            print(r["image_id"], r["stats"]["leaves_clean"])
        """
        from repro_torch.core.predump import DirtyLeafTracker, digest_pairs
        from repro_torch.distributed import sharding as shd
        if shd.has_dtensor(tree):
            return self._save_sharded(tree, step=step, meta=meta,
                                      topology=topology, pre_dump=True)
        if self._tracker is None:
            self._tracker = DirtyLeafTracker()
        self._drain_async()
        pairs = flatten_with_paths(tree)
        digests = digest_pairs(pairs, executor=self.executor)
        reuse = self._tracker.reuse_for(digests)
        rnd, kw = self._round_kw(step, meta, topology, len(pairs), reuse)
        out = _dump(tree, self.tier, replicas=self.replicas,
                    executor=self.executor, reuse_records=reuse,
                    device=self.device, **kw)
        self._dumped(tree, step, out, digests, pre_dump=True)
        self._round_stats(out, rnd, len(pairs), reuse)
        return out

    def _round_kw(self, step, meta, topology, n: int, reuse) -> tuple:
        """(round, dump kwargs) of a pre-dump round over ``n`` leaves that
        re-emits ``reuse``: an image id of its own (never one that
        exists), the latest image as parent, no delta8 baseline."""
        from repro_torch.core.predump import PRE_DUMP_META_KEY
        latest = self.registry.latest()
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
                                      "dirty": n - len(reuse),
                                      "clean": len(reuse)}},
                           topology, with_parent=False)
        kw.update(parent=latest["image_id"] if latest else None,
                  prev_host_tree=None, image_id=image_id)
        return rnd, kw

    @staticmethod
    def _round_stats(out, rnd: int, n: int, reuse) -> None:
        out["stats"]["predump_round"] = rnd
        out["stats"]["leaves_dirty"] = n - len(reuse)
        out["stats"]["leaves_clean"] = len(reuse)

    def save_async(self, tree, *, step: int, meta: dict | None = None,
                   topology: dict | None = None):
        """Raw-dict async dump (the engine under DumpRequest(mode=
        "async")): takes a finished host copy of every leaf now, writes it
        in the background on the ordered lane with the host codec; wait()
        is the durability barrier. The next train step may update the live
        tensors in place as soon as this returns.

        Example::

            sess.save_async(state, step=7)   # returns once captured
            ...                              # training continues
            sess.wait()                      # durable (or raises)

        A tree with DTensor leaves: every rank calls it (and wait()). Each
        leaf is gathered to rank 0 alone, one at a time, and copied to
        rank 0's host, which holds the whole capture until the write job
        ends (the JAX package's ``device_get``); rank 0 alone writes it
        and keeps it as the delta8 baseline.
        """
        from repro_torch.distributed import sharding as shd
        if shd.has_dtensor(tree):
            self._sharded_async = True
            todo = flatten_with_paths(tree)

            def submit(pull):
                self._submit_async(tree, step, meta, topology, lambda _: {
                    p: to_host(pull(p, t)) for p, t in todo})
            shd.gathered_on_rank0(todo, submit)
            return
        self._submit_async(tree, step, meta, topology)

    def _submit_async(self, tree, step, meta, topology,
                      capture=host_tree_by_path):
        if self._async is None:
            self._async = _AsyncEngine(
                self.tier, replicas=self.replicas,
                max_pending=self.config.async_dumps.max_pending,
                executor=self.executor)
        # parent=None here: the incremental link is resolved when the
        # ordered job runs (a submit-time registry scan would both block
        # the step and miss still-in-flight parents)
        kw = self._save_kw(step, meta, topology, with_parent=False)
        # one capture: the job's input and the next call's delta baseline
        host = self._async.dump_async(tree, resolve_parent=self.incremental,
                                      baseline_step=self._prev_step,
                                      baseline_image=self._prev_image,
                                      capture=capture, **kw)
        if self.codec_policy is not None and self.incremental:
            # mirror save(): job N's delta baseline (kw's prev_host_tree,
            # the tree of the PRECEDING save call) must equal the content
            # of the image the job resolves as parent at run time, so the
            # next call's baseline becomes this tree
            self._prev_host = host
            self._prev_digests = None
            self._prev_step = step
            self._prev_image = f"step_{int(step):010d}"  # dump()'s default

    def _wait_raw(self) -> list:
        """The async results since the last barrier, durable. After an
        async dump of DTensor leaves it is collective: rank 0 waits for
        its write jobs and every rank gets their image ids and stats, or
        the error of a failed job."""
        if self._sharded_async:
            from repro_torch.distributed import sharding as shd
            return shd.rank0_decides(lambda: [
                {"image_id": o["image_id"], "stats": o["stats"]}
                for o in self._wait_local()])
        return self._wait_local()

    def _wait_local(self) -> list:
        if self._async is not None:
            out, self._drained = self._drained + self._async.wait(), []
            self.registry.retain(self.keep_last, self.keep_every)
            self.registry.gc()
            return out
        return []

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
    def _load(self, image_id, target_struct, shardings):
        """Raw restore onto the shardings' device (else the session's); a
        shardings tree must have the image's leaf paths. On a mesh over
        the ranks of a process group every rank restores the image and
        keeps its slices (DTensors)."""
        from repro_torch.distributed.sharding import (check_tree, place,
                                                      placement_device)
        dev = self.device if shardings is None \
            else placement_device(shardings)
        tree, man = _restore(self.tier, image_id, device=dev,
                             expected=target_struct, replicas=self.replicas,
                             executor=self.executor)
        if shardings is not None:
            check_tree(shardings, tree)
            tree = place(tree, shardings)
        return tree, man

    def load_latest(self, target_struct=None, shardings=None):
        """Raw restore of the newest image -> (tree, manifest) on the
        session's device. The typed path (RestoreRequest) adds the
        migration record and digest check on top. ``shardings`` (a tree
        of distributed/sharding.NamedSharding, e.g. ``named(mesh,
        train_state_pspecs(lm, rules))``) places every leaf on the mesh
        instead: on its one device, or, on a mesh over the ranks of the
        initialised process group, as DTensors whose local shards are
        bitwise the slices of the image's leaves; a mesh over several
        devices without such a group raises RuntimeError.

        Example::

            tree, man = sess.load_latest()
        """
        return self._load(None, target_struct, shardings)

    def load(self, image_id: str, target_struct=None, shardings=None):
        """Raw restore of a specific image id -> (tree, manifest).
        ``shardings`` as in load_latest.

        Example::

            tree, man = sess.load("step_0000000040")
        """
        return self._load(image_id, target_struct, shardings)
