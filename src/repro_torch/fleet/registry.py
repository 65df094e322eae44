"""Job registry: the coordinator's only memory of the fleet.

One ``JobRecord`` per job id — the session description AS WIRE DATA
(never a live CheckpointSession), current placement, last-known step,
last COMMITTED image, and heartbeat liveness. DMTCP's coordinator keeps
exactly this shape of table: sockets and barriers, never page contents;
here it is configs and image ids, never pytrees.

Liveness is two distinct questions the tests keep apart:

  * slow-but-alive — last heartbeat is old but within
    ``heartbeat_timeout_s``: the job keeps its claim, nobody restores
    over it;
  * timed out — past the timeout: the job is presumed lost and becomes
    a re-placement candidate, but only ONE actor wins ``claim_restore``
    (a compare-and-set on the record's phase), which is what makes a
    double restore impossible even when a node-failure handler and the
    heartbeat sweeper race."""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.api import wire


@dataclasses.dataclass
class JobRecord:
    """Everything the coordinator knows about one job (all wire data).

    ``phase`` lifecycle: registered -> running -> draining -> drained ->
    dumped -> restoring -> running (next incarnation), with ``lost``
    for a dead host / timed-out heartbeat pending re-placement."""
    job_id: str
    config_wire: dict
    host: str | None = None
    topology: dict | None = None
    kind: str = "train"               # workload: "train" | "serve"
    phase: str = "registered"
    step: int = 0
    image_id: str | None = None
    image_step: int | None = None
    state_digest: str | None = None
    last_heartbeat: float = 0.0
    heartbeats: int = 0
    incarnation: int = 0

    @property
    def root_uri(self) -> str:
        return self.config_wire["root"]


class JobRegistry:
    """Thread-safe table of JobRecords keyed by job id.

    ``clock`` is a zero-arg callable in the coordinator's time domain
    (SimCluster's virtual clock in tests, ``time.monotonic`` live)."""

    def __init__(self, *, clock=None, heartbeat_timeout_s: float = 30.0,
                 on_change=None):
        self.clock = clock or (lambda: 0.0)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._jobs: dict = {}
        self._lock = threading.Lock()
        # zero-arg callback fired after every mutation, OUTSIDE the lock
        # — the socket coordinator journals registry.to_wire() here so a
        # restarted coordinator resumes from the last committed table
        self.on_change = on_change

    def _changed(self):
        cb = self.on_change
        if cb is not None:
            cb()

    # ---------------------------------------------------------- wire form
    def to_wire(self) -> dict:
        """The whole table as wire data (JobRecords are already wire-safe
        by construction: configs travel as dicts, never sessions). This
        is what the socket coordinator journals after every mutation."""
        with self._lock:
            jobs = [dataclasses.asdict(r) for r in self._jobs.values()]
        return {"kind": "JobRegistry",
                "schema_version": wire.SCHEMA_VERSION,
                "heartbeat_timeout_s": self.heartbeat_timeout_s,
                "jobs": jobs}

    @classmethod
    def from_wire(cls, d: dict, *, clock=None,
                  heartbeat_timeout_s: float | None = None,
                  on_change=None) -> "JobRegistry":
        """Rebuild the table from a journaled snapshot. Every record's
        ``last_heartbeat`` is restamped to the NEW clock: heartbeat
        timestamps do not survive a process restart (the clock domain
        died with the old coordinator), so every job gets a fresh
        liveness window — re-adopted on its next HELLO, re-placed via
        check_heartbeats() if it never returns."""
        wire.check_version(d, "JobRegistry")
        reg = cls(clock=clock,
                  heartbeat_timeout_s=float(
                      d.get("heartbeat_timeout_s", 30.0)
                      if heartbeat_timeout_s is None else heartbeat_timeout_s),
                  on_change=on_change)
        known = {f.name for f in dataclasses.fields(JobRecord)}
        now = reg.clock()
        for j in d.get("jobs", []):
            rec = JobRecord(**{k: v for k, v in j.items() if k in known})
            rec.last_heartbeat = now
            reg._jobs[rec.job_id] = rec
        return reg

    # ----------------------------------------------------------- lifecycle
    def register(self, job_id: str, config_wire: dict, *,
                 host: str | None = None,
                 topology: dict | None = None,
                 kind: str = "train") -> JobRecord:
        if not isinstance(config_wire, dict):
            raise TypeError("JobRegistry.register takes the config as "
                            "WIRE DATA (SessionConfig.to_wire()), got "
                            f"{type(config_wire).__name__}")
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already registered")
            rec = JobRecord(job_id=job_id, config_wire=dict(config_wire),
                            host=host, topology=topology, kind=kind,
                            phase="running",
                            last_heartbeat=self.clock())
            self._jobs[job_id] = rec
        self._changed()
        return rec

    def get(self, job_id: str) -> JobRecord:
        with self._lock:
            return self._jobs[job_id]

    def jobs(self, *, phase: str | None = None) -> list:
        with self._lock:
            recs = list(self._jobs.values())
        return [r for r in recs if phase is None or r.phase == phase]

    def on_host(self, host: str) -> list:
        return [r for r in self.jobs() if r.host == host]

    # ----------------------------------------------------------- liveness
    def heartbeat(self, job_id: str, step: int,
                  now: float | None = None) -> JobRecord:
        with self._lock:
            rec = self._jobs[job_id]
            rec.last_heartbeat = self.clock() if now is None else now
            rec.heartbeats += 1
            rec.step = max(rec.step, int(step))
        self._changed()
        return rec

    def adopt(self, job_id: str, *, host: str | None = None,
              incarnation: int = 0, step: int = 0) -> JobRecord:
        """A live worker announced itself (a socket HELLO): refresh
        liveness and reconcile the phase with the evidence. A job the
        old coordinator marked ``lost`` is running after all; a HELLO
        carrying a HIGHER incarnation proves a restore the table never
        saw complete. A ``restoring`` claim at the SAME incarnation is
        left standing — the claim CAS holds across restarts."""
        with self._lock:
            rec = self._jobs[job_id]
            rec.last_heartbeat = self.clock()
            rec.heartbeats += 1
            if host:
                rec.host = host
            rec.step = max(rec.step, int(step))
            if int(incarnation) > rec.incarnation:
                rec.incarnation = int(incarnation)
                if rec.phase == "restoring":
                    rec.phase = "running"
            if rec.phase == "lost":
                rec.phase = "running"
        self._changed()
        return rec

    def alive(self, job_id: str, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        with self._lock:
            rec = self._jobs[job_id]
            if rec.phase in ("lost", "dead"):
                return False
            return (now - rec.last_heartbeat) <= self.heartbeat_timeout_s

    def stale_jobs(self, now: float | None = None) -> list:
        """Jobs past the heartbeat timeout that are not already being
        handled — the re-placement work list. Slow-but-alive jobs (old
        heartbeat, within timeout) never appear here."""
        now = self.clock() if now is None else now
        out = []
        with self._lock:
            for rec in self._jobs.values():
                if rec.phase in ("restoring", "lost", "dead", "dumped"):
                    continue
                if (now - rec.last_heartbeat) > self.heartbeat_timeout_s:
                    out.append(rec)
        return out

    # ------------------------------------------------------- dump/restore
    def record_dump(self, job_id: str, *, image_id: str, step: int,
                    state_digest: str | None = None):
        with self._lock:
            rec = self._jobs[job_id]
            rec.image_id = image_id
            rec.image_step = int(step)
            rec.step = max(rec.step, int(step))
            rec.state_digest = state_digest
            rec.phase = "dumped"
        self._changed()

    def claim_restore(self, job_id: str) -> bool:
        """Compare-and-set: True for exactly one caller per incarnation.
        The loser (a racing failure handler, a second heartbeat sweep)
        must NOT restore — this is the no-double-restore guarantee."""
        with self._lock:
            rec = self._jobs[job_id]
            if rec.phase == "restoring":
                return False
            rec.phase = "restoring"
        self._changed()          # the claim itself is durable: a restarted
        return True              # coordinator must not become a second winner

    def complete_restore(self, job_id: str, *, host: str, step: int):
        with self._lock:
            rec = self._jobs[job_id]
            rec.host = host
            rec.step = int(step)
            rec.phase = "running"
            rec.incarnation += 1
            rec.last_heartbeat = self.clock()
        self._changed()

    def mark(self, job_id: str, phase: str):
        with self._lock:
            self._jobs[job_id].phase = phase
        self._changed()

    def mark_host_lost(self, host: str) -> list:
        """Every non-durable job on a dead host becomes ``lost`` (its
        last COMMITTED image is untouched — that is what re-placement
        restores from). Returns the affected records."""
        out = []
        with self._lock:
            for rec in self._jobs.values():
                if rec.host == host and rec.phase not in ("dead",):
                    if rec.phase != "restoring":
                        rec.phase = "lost"
                    out.append(rec)
        if out:
            self._changed()
        return out
