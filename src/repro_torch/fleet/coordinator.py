"""FleetCoordinator: global preemption waves + placed restores over wire.

The control plane the paper's single-process story is missing: when a
whole partition is preempted (maintenance window, spot reclaim, the
NERSC drain), every job must reach a durable image — but twenty jobs
dumping at once saturate the shared store and ALL of them finish late
(the DMTCP-at-scale finding: aggregate filesystem bandwidth, not
per-job speed, is the binding constraint). The coordinator therefore
runs a wave in two phases:

  drain     all jobs concurrently run to their next step boundary and
            pause (cheap, no I/O — the stop-the-world part stays short);
  dump      MigrateRequests go out in STAGGERED batches of
            ``dump_concurrency`` — the bandwidth budget — instead of
            all at once, keeping the store below its overload knee.

Wave semantics are per-job atomic: a job either completes its dump
(manifest committed — the session's commit-last discipline) or is
untouched, still restorable from its previous image; a TransferError
marks that job failed and, with ``abort_on_error``, skips the jobs not
yet started. A host that dies mid-wave fails loudly (HostDownError),
its jobs become ``lost``, and after the dump phase the coordinator
re-places them from their last committed images via the
PlacementPlanner — preferring hosts whose hot caches already hold the
image's chunks.

Every job interaction is a wire frame through a transport: the
coordinator owns no session, no pytree, no tier handle for any job —
only JSON-able dicts and the registry. ``wire_frames`` counts every
round trip; the acceptance harness asserts the count matches the sum
over transports, i.e. nothing bypassed the contract.

A copy of the JAX package's fleet/coordinator.py. On a card, a dump
batch runs up to ``dump_concurrency`` device-codec dumps at once, one
host thread each: they share the device's current stream, the
executor's pools and the kernels' launch counters. Each dump allocates
its own pinned landing buffers and records its own events
(core/device_codec.py), the counters take a lock
(kernels/ckpt_codec/ckpt_codec.py), and a leaf task on the shared cpu
pool only waits on an encode pump submitted before it, so concurrent
dumps neither race nor deadlock, and none of them is serialized beyond
the stream."""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.api import wire
from repro_torch.api.requests import MigrateRequest, MigrationTicket, \
    RestoreRequest
from repro_torch.fleet.client import HostDownError
from repro_torch.fleet.messages import DrainAck, DrainCommand, ErrorReply, \
    Heartbeat, RestoreAck
from repro_torch.fleet.placement import PlacementPlanner
from repro_torch.fleet.registry import JobRegistry
from repro_torch.fleet.topology import ClusterTopology, retarget_root


@dataclasses.dataclass
class WaveReport:
    """What one preemption wave did, job by job (plain data)."""
    requested: list
    drained: dict = dataclasses.field(default_factory=dict)
    dumped: dict = dataclasses.field(default_factory=dict)
    failed: dict = dataclasses.field(default_factory=dict)
    skipped: list = dataclasses.field(default_factory=list)
    lost: list = dataclasses.field(default_factory=list)
    replaced: dict = dataclasses.field(default_factory=dict)
    aborted: bool = False
    stagger: bool = True
    batches: int = 0
    wall_s: float = 0.0

    @property
    def complete(self) -> bool:
        return not self.failed and not self.skipped and not self.aborted


class FleetCoordinator:
    """The fleet's single point of orchestration (and of nothing else).

    ``clock`` is a zero-arg callable defining fleet time (virtual in
    tests, ``time.monotonic`` live); ``spawner(job_record, host_id,
    config_wire) -> transport`` launches a job's next incarnation on a
    chosen host — the cluster provides it, the coordinator only decides
    where and speaks wire to whatever comes back.

    Example::

        coord = FleetCoordinator(topology=topo, clock=cluster.clock,
                                 spawner=cluster.spawn, dump_concurrency=4)
        coord.attach("j0", transport, host="h0", config_wire=cfg.to_wire())
        report = coord.preemption_wave()
    """

    def __init__(self, *, topology: ClusterTopology | None = None,
                 registry: JobRegistry | None = None,
                 planner: PlacementPlanner | None = None,
                 clock=None, heartbeat_timeout_s: float = 30.0,
                 dump_concurrency: int = 4, spawner=None, policy=None):
        self.clock = clock or (lambda: 0.0)
        self.topology = topology or ClusterTopology()
        self.registry = registry or JobRegistry(
            clock=self.clock, heartbeat_timeout_s=heartbeat_timeout_s)
        self.planner = planner or PlacementPlanner(self.topology,
                                                   self.registry)
        self.dump_concurrency = max(1, int(dump_concurrency))
        self.spawner = spawner
        # optional training.fault_tolerance.FleetPolicy: the scheduler
        # verdict before a re-place — a checkpointed job (exit 85)
        # reschedules immediately; a lost incarnation burns the
        # RestartPolicy budget and can be aborted for good
        self.policy = policy
        self.transports: dict = {}
        self.stats = {"wire_frames": 0, "waves": 0, "dumps": 0,
                      "restores": 0, "heartbeats": 0, "hosts_failed": 0}
        self._downed: set = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ plumbing
    def attach(self, job_id: str, transport, *, host: str,
               config_wire: dict, topology: dict | None = None,
               kind: str = "train"):
        """Admit a job: its transport plus its WIRE-LEVEL description.
        ``kind`` picks the drain boundary ("serve" jobs pause at a
        decode step, trainers at a training step)."""
        self.registry.register(job_id, config_wire, host=host,
                               topology=topology, kind=kind)
        self.transports[job_id] = transport

    def deliver(self, frame: dict):
        """Job -> coordinator ingress (heartbeats). Unknown wire kinds
        raise — the contract is closed, not best-effort."""
        msg = wire.decode(frame)
        with self._lock:
            self.stats["wire_frames"] += 1
        if isinstance(msg, Heartbeat):
            with self._lock:
                self.stats["heartbeats"] += 1
            self.registry.heartbeat(msg.job_id, msg.step, now=msg.sent_at)
            return
        raise TypeError(f"coordinator cannot ingest "
                        f"{type(msg).__name__} frames")

    def send(self, job_id: str, msg) -> object:
        """One wire round trip: encode, transport, decode. Raises
        HostDownError when the job's host is gone."""
        frame = msg.to_wire()
        reply = self.transports[job_id].send(frame)
        with self._lock:
            self.stats["wire_frames"] += 1
        return wire.decode(reply)

    # ---------------------------------------------------------- wave logic
    def drain(self, job_ids) -> dict:
        """Phase one: ask every job (concurrently — draining is I/O-free)
        to pause at its next step boundary. Returns job_id -> paused
        step; jobs whose host died are left out (they are wave 'lost')."""
        acks: dict = {}
        errors: dict = {}

        def one(jid):
            try:
                kind = getattr(self.registry.get(jid), "kind", "train")
                ack = self.send(jid, DrainCommand(
                    job_id=jid,
                    boundary="decode" if kind == "serve" else "step"))
                if isinstance(ack, DrainAck):
                    acks[jid] = ack.step
                    self.registry.mark(jid, "drained")
                else:
                    errors[jid] = ack
            except HostDownError as e:
                errors[jid] = e

        threads = [threading.Thread(target=one, args=(j,), daemon=True)
                   for j in job_ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for jid, err in errors.items():
            if isinstance(err, HostDownError):
                self._host_down(self.registry.get(jid).host)
        return acks

    def preemption_wave(self, job_ids=None, *, stagger: bool = True,
                        batch: int | None = None,
                        reason: str = "preemption_wave",
                        abort_on_error: bool = False,
                        replace_lost: bool = True) -> WaveReport:
        """Drain-then-dump across the fleet; see the module docstring
        for the phase semantics. ``stagger=False`` is the naive
        all-at-once baseline the benchmark measures against."""
        jobs = list(job_ids) if job_ids is not None else \
            [r.job_id for r in self.registry.jobs()
             if r.phase in ("running", "registered", "drained")]
        report = WaveReport(requested=jobs, stagger=stagger)
        with self._lock:
            self.stats["waves"] += 1
        t0 = self.clock()

        report.drained = self.drain(jobs)
        live = [j for j in jobs if j in report.drained]
        report.lost = [j for j in jobs if j not in report.drained]

        width = (batch or self.dump_concurrency) if stagger else len(live)
        width = max(1, width)
        batches = [live[i:i + width] for i in range(0, len(live), width)]
        report.batches = len(batches)
        for group in batches:
            if report.aborted:
                report.skipped.extend(group)
                continue
            self._dump_batch(group, reason, report, abort_on_error)
        report.lost = sorted(set(report.lost))

        if replace_lost:
            for jid in report.lost:
                rec = self.registry.get(jid)
                if rec.image_id is None:
                    report.failed.setdefault(
                        jid, "lost with no committed image")
                    continue
                try:
                    ack = self.restore_job(jid)
                except (RuntimeError, HostDownError) as e:
                    report.failed.setdefault(jid, f"re-place failed: {e}")
                else:
                    if ack is not None:
                        report.replaced[jid] = ack.host
        report.wall_s = self.clock() - t0
        return report

    def _dump_batch(self, group, reason, report, abort_on_error):
        """One staggered batch: concurrent MigrateRequests, each reply a
        MigrationTicket (dumped), an ErrorReply (failed, image
        untouched) or a HostDownError (host lost, jobs re-placed after
        the wave)."""
        results: dict = {}

        def one(jid):
            try:
                results[jid] = self.send(
                    jid, MigrateRequest(state=None, reason=reason))
            except HostDownError as e:
                results[jid] = e

        threads = [threading.Thread(target=one, args=(j,), daemon=True)
                   for j in group]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        for jid, res in results.items():
            if isinstance(res, MigrationTicket):
                digest = res.record.state_digest if res.record else None
                self.registry.record_dump(jid, image_id=res.image_id,
                                          step=res.step,
                                          state_digest=digest)
                report.dumped[jid] = res.image_id
                with self._lock:
                    self.stats["dumps"] += 1
            elif isinstance(res, HostDownError):
                host = self.registry.get(jid).host
                self._host_down(host)
                report.lost.extend(
                    r.job_id for r in self.registry.on_host(host))
            else:
                detail = res.detail if isinstance(res, ErrorReply) \
                    else repr(res)
                report.failed[jid] = detail
                self.registry.mark(jid, "running")   # image untouched
                if abort_on_error:
                    report.aborted = True

    # ------------------------------------------------- failures / restores
    def _host_down(self, host: str):
        with self._lock:
            if host is None or host in self._downed:
                return
            self._downed.add(host)
            self.stats["hosts_failed"] += 1
        if self.topology.alive(host):
            self.topology.fail_host(host)
        self.registry.mark_host_lost(host)

    def host_failed(self, host: str, *, replace: bool = True) -> dict:
        """External failure notification (the cluster's watchdog). Marks
        the host dead and, with ``replace``, re-places every job that
        has a committed image. Returns job_id -> new host."""
        self._host_down(host)
        moved: dict = {}
        if replace:
            for rec in self.registry.on_host(host):
                if rec.image_id is None:
                    continue
                ack = self.restore_job(rec.job_id)
                if ack is not None:
                    moved[rec.job_id] = ack.host
        return moved

    def check_heartbeats(self) -> dict:
        """The liveness sweep: re-place jobs past the heartbeat timeout
        (from their last committed image). A slow-but-alive job — stale
        heartbeat but within the timeout — is never touched, and the
        registry's claim CAS makes a second sweep (or a racing failure
        handler) a no-op: no double restores."""
        moved: dict = {}
        for rec in self.registry.stale_jobs():
            if rec.image_id is None:
                continue
            ack = self.restore_job(rec.job_id,
                                   exclude=(rec.host,) if rec.host else ())
            if ack is not None:
                moved[rec.job_id] = ack.host
        return moved

    def restore_job(self, job_id: str, *, host: str | None = None,
                    exclude: tuple = ()) -> RestoreAck | None:
        """Place and restore one job's next incarnation from its last
        committed image. Returns None if another actor already claimed
        the restore (the no-double-restore path); otherwise the
        RestoreAck, with its recomputed state digest checked against
        the digest recorded at dump time."""
        rec = self.registry.get(job_id)
        was_lost = rec.phase == "lost"
        if not self.registry.claim_restore(job_id):
            return None
        if rec.image_id is None:
            raise RuntimeError(f"job {job_id!r} has no committed image "
                               f"to restore from")
        if self.policy is not None:
            # checkpointed incarnations (exit 85) reschedule free; a
            # LOST one is a failure charged to the restart budget
            verdict = (self.policy.restart.on_failure(int(rec.step))
                       if was_lost else
                       self.policy.on_exit(
                           self.policy.checkpointed_exit_code,
                           step=int(rec.step)))
            if verdict.get("action") != "restart":
                self.registry.mark(job_id, "dead")
                return None
        if host is None:
            if self.topology.hosts():
                decision = self.planner.plan(rec, exclude=tuple(exclude))
                host = decision.host
            else:
                # socket fleets without a modeled topology: the job's own
                # (relaunched) endpoint IS the placement
                host = rec.host
        if self.spawner is None:
            raise RuntimeError("restore placement needs a spawner "
                               "(cluster-provided job launcher)")
        if self.topology.hosts():
            # peer-aware fetch: the chosen host's hot fronts pull chunks
            # from the nearest warm peer (hash-verified, LAN-speed)
            # before paying the cold remote — wired from the same
            # hot-inventory snapshots the placement score used
            self.topology.wire_peer_fetch(host)
        config = retarget_root(rec.config_wire, host)
        transport = self.spawner(rec, host, config)
        self.transports[job_id] = transport
        rec.config_wire = config
        rec.host = host
        ack = self.send(job_id, RestoreRequest(image_id=rec.image_id))
        if isinstance(ack, ErrorReply):
            self.registry.mark(job_id, "lost")
            raise RuntimeError(f"restore of {job_id!r} on {host!r} "
                               f"failed: {ack.detail}")
        if rec.state_digest and ack.state_digest \
                and ack.state_digest != rec.state_digest:
            raise RuntimeError(
                f"restore of {job_id!r} on {host!r} is NOT bit-identical: "
                f"digest {ack.state_digest[:12]} != recorded "
                f"{rec.state_digest[:12]}")
        self.registry.complete_restore(job_id, host=host, step=ack.step)
        with self._lock:
            self.stats["restores"] += 1
        return ack
