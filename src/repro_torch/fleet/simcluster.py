"""SimCluster: a deterministic many-job fleet for tests and benchmarks.

Everything the coordinator needs a cluster to be, in one process:

  * hosts with device capacity and per-host hot caches — every job's
    root tier is ``cache+remote://<store>?front=<host>&prefix=<job>``:
    ONE shared simulated object store (one network, one aggregate
    bandwidth pool — the thing a wave contends for), a hot front per
    host, a key namespace per job;
  * seeded jobs — ``SimJob`` is a tiny deterministic trainer whose
    state is a pure function of (seed, step), so bit-identity across
    dump/restore/re-place is checkable by digest;
  * a seeded arrival process (exponential inter-arrival draws) that
    places jobs on the least-loaded host as they appear;
  * seeded node failures — armed to fire when the Nth wire frame of a
    chosen kind crosses a transport (``arm_failure``), so "host dies
    mid-wave" is an exact, replayable protocol moment, not a sleep
    race;
  * a virtual cluster clock (``tick`` advances it, steps running jobs
    and emits their heartbeats through the wire path).

Jobs run ``serial=True`` sessions: each dump is one thread of storage
ops, so the store's ``peak_active`` measures exactly the wave's
concurrency policy — the staggered-vs-naive comparison is about the
COORDINATOR's batching, not thread-pool incidentals.

A copy of the JAX package's fleet/simcluster.py over the port: jobs keep
their leaves as torch tensors on the cluster's ``device`` ("cuda" by
default), drawn from the same seeded numpy streams, so a JAX job and its
twin here hold the same bits and dump the same chunks. With
``transport="socket"`` every frame crosses a real Unix-domain socket
(fleet/transport.py) as in the JAX package; the jobs' tensors stay on the
cluster's device either way."""
from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from repro_torch.api.config import CodecPolicy, MigrationPolicy, \
    SessionConfig
from repro_torch.core.remote import get_store
from repro_torch.device import resolve_device
from repro_torch.fleet.client import FleetClient, LoopbackTransport
from repro_torch.fleet.coordinator import FleetCoordinator
from repro_torch.fleet.placement import PlacementPlanner
from repro_torch.fleet.registry import JobRegistry
from repro_torch.fleet.topology import ClusterTopology
from repro_torch.fleet.transport import CoordinatorServer, \
    ReconnectPolicy, WorkerAgent, parse_url

_STORE_SEQ = itertools.count()


class SimJob:
    """Deterministic toy trainer: ``state(seed, step)`` is reproducible,
    so two incarnations that agree on (seed, step) agree bit-for-bit.

    The leaves are fp32 tensors on ``device``, drawn on the host from
    the JAX package's seeded streams; a step adds each leaf's delta in
    fp32, which rounds alike on either device and in numpy.

    Example::

        j = SimJob("j0", seed=7, device="cuda")
        j.run(10)
        assert j.step == 10
    """

    def __init__(self, job_id: str, *, seed: int = 0, leaves: int = 4,
                 leaf_kb: int = 32, device="cuda"):
        self.job_id = job_id
        self.seed = int(seed)
        self.device = resolve_device(device)
        rng = np.random.default_rng(self.seed)
        n = max(1, (leaf_kb * 1024) // 4)
        params = {f"w{i}": rng.standard_normal(n).astype(np.float32)
                  for i in range(leaves)}
        delta = {k: rng.standard_normal(n).astype(np.float32) * 1e-3
                 for k in params}
        self.params = {k: torch.from_numpy(v).to(self.device)
                       for k, v in params.items()}
        self._delta = {k: torch.from_numpy(v).to(self.device)
                       for k, v in delta.items()}
        self.step = 0
        self.running = True
        self.paused = False

    def run(self, steps: int = 1):
        if not self.running or self.paused:
            return
        for _ in range(int(steps)):
            for k, w in self.params.items():
                w += self._delta[k]
            self.step += 1

    def state(self) -> dict:
        return {"params": {k: v.clone() for k, v in self.params.items()},
                "step": torch.tensor(self.step, dtype=torch.int64,
                                     device=self.device)}

    def adopt(self, state: dict, step: int):
        """Become the restored incarnation: take the image's leaves."""
        self.params = {k: torch.as_tensor(v).to(self.device).clone()
                       for k, v in state["params"].items()}
        self.step = int(step)
        self.paused = False
        self.running = True


class SimServeJob:
    """A live serving plane as a fleet job: a tiny real model behind a
    SessionManager, fed by a seeded TrafficGenerator. The coordinator
    wave-migrates it like any trainer — drain pauses at a DECODE
    boundary, the dump carries the serve-plane side-table as meta, and
    ``adopt`` rebuilds the plane (zero dropped sessions) from the
    RestoreResult alone.

    Example::

        j = SimServeJob("s0", seed=3, device="cuda")
        j.run(4)
        assert j.mgr.stats["admitted"] > 0
    """

    kind = "serve"

    def __init__(self, job_id: str, *, seed: int = 0,
                 arch: str = "gemma2-2b", slots: int = 4,
                 page_len: int = 24, rate: float = 2.0, device="cuda"):
        from repro_torch.serving import SessionManager, TrafficGenerator
        self.job_id = job_id
        self.seed = int(seed)
        self.arch = arch
        self.device = resolve_device(device)
        self.lm = self._lm(arch)
        params = self.lm.init(torch.Generator().manual_seed(self.seed),
                              device=self.device)
        self.mgr = SessionManager(self.lm, params, slots=slots,
                                  page_len=page_len, device=self.device)
        self.traffic = TrafficGenerator(
            seed=self.seed, vocab_size=self.lm.cfg.vocab_size, rate=rate,
            prompt_support=(4, 6), target_max=6)
        self.running = True
        self.paused = False

    @staticmethod
    def _lm(arch: str):
        from repro_torch import configs
        from repro_torch.models.model import LM
        return LM(configs.get_tiny(arch))

    @property
    def step(self) -> int:
        return self.mgr.clock

    def run(self, steps: int = 1):
        if not self.running or self.paused:
            return
        self.mgr.draining = False
        self.mgr.run(steps, traffic=self.traffic)

    def drain(self) -> int:
        self.paused = True
        return self.mgr.drain()

    def state(self) -> dict:
        """The plane's live tensors where they lie: the dump reads each
        leaf there and the digest copies one leaf at a time to the host.
        The plane only changes inside step(), which a drained job never
        runs."""
        return self.mgr.plane_state()

    def meta(self) -> dict:
        """What rides the wire-dump as meta: the serve-plane side-table
        plus the activity-ranked lazy prefetch hint."""
        return {"serve_plane": self.mgr.serve_table(self.traffic.state()),
                "prefetch_hint": self.mgr.prefetch_hint()}

    def sessions_live(self) -> int:
        return len(self.mgr.live_sids())

    def adopt(self, res):
        """Become the restored incarnation: rebuild the plane and
        fast-forward a fresh traffic stream to the dumped cursor."""
        from repro_torch.serving import SessionManager, TrafficGenerator
        meta = res.manifest["meta"]
        table = meta.get("serve_plane") \
            or (meta.get("extra") or {}).get("serve_plane")
        self.mgr = SessionManager.adopt(self.lm, res.state, table,
                                        device=self.device)
        # the recorded cursor wins over these defaults (which only cover
        # images old enough not to carry the distribution parameters)
        cur = dict(table.get("traffic") or {})
        cur.setdefault("seed", self.seed)
        cur.setdefault("vocab_size", self.lm.cfg.vocab_size)
        cur.setdefault("rate", 2.0)
        cur.setdefault("prompt_support", (4, 6))
        cur.setdefault("target_max", 6)
        self.traffic = TrafficGenerator.from_state(cur)
        self.paused = False
        self.running = True


class SimCluster:
    """Hosts + jobs + coordinator, wired through loopback transports by
    default — or over a REAL Unix-domain socket with
    ``transport="socket"`` (every frame crosses the framed wire through
    per-job WorkerAgents; same jobs, same digests, same seeded chaos).
    ``device`` is where every job's leaves live and every session runs
    ("cuda" by default), whichever the wire.

    Example::

        cl = SimCluster(hosts=4, agg_mbps=200, knee=4, device="cuda")
        cl.submit_jobs(8, steps=5)
        report = cl.coordinator.preemption_wave()
        assert len(report.dumped) == 8
    """

    def __init__(self, *, hosts: int = 4, devices_per_host: int = 4,
                 store: str | None = None, seed: int = 0,
                 latency_ms: float = 0.0, bw_mbps: float = 0.0,
                 agg_mbps: float = 0.0, knee: int = 0,
                 penalty: float = 1.0, realtime: bool = False,
                 heartbeat_timeout_s: float = 30.0,
                 dump_concurrency: int = 4,
                 leaf_kb: int = 32, leaves: int = 4,
                 codec: CodecPolicy | None = None,
                 extra_uri_params: str = "", policy=None,
                 transport: str = "loopback",
                 resume_timeout_s: float = 5.0, device="cuda"):
        if transport not in ("loopback", "socket"):
            raise ValueError(f"transport must be 'loopback' or 'socket', "
                             f"got {transport!r}")
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.store_name = store or f"fleet{next(_STORE_SEQ)}"
        self._uri_params = "&".join(
            p for p in (f"latency_ms={latency_ms}" if latency_ms else "",
                        f"bw_mbps={bw_mbps}" if bw_mbps else "",
                        f"agg_mbps={agg_mbps}" if agg_mbps else "",
                        f"knee={knee}" if knee else "",
                        f"penalty={penalty}" if penalty != 1.0 else "",
                        "realtime=1" if realtime else "",
                        extra_uri_params) if p)
        self.leaf_kb, self.leaves = int(leaf_kb), int(leaves)
        self.codec = codec or CodecPolicy()     # lossless: digests travel
        self.now = 0.0
        self.jobs: dict = {}                    # job_id -> SimJob
        self.clients: dict = {}                 # job_id -> FleetClient
        self.all_transports: list = []          # every incarnation's wire
        self._armed: list = []                  # (kind, countdown, host)
        self._frame_lock = threading.Lock()
        self.topology = ClusterTopology()
        for i in range(int(hosts)):
            self.topology.add_host(f"h{i}", devices=devices_per_host)
        registry = JobRegistry(clock=self.clock,
                               heartbeat_timeout_s=heartbeat_timeout_s)
        self.coordinator = FleetCoordinator(
            topology=self.topology, registry=registry,
            planner=PlacementPlanner(self.topology, registry),
            clock=self.clock, heartbeat_timeout_s=heartbeat_timeout_s,
            dump_concurrency=dump_concurrency, spawner=self.spawn,
            policy=policy)
        self.transport_mode = transport
        self.server = None
        self.agents: dict = {}              # job_id -> live WorkerAgent
        if transport == "socket":
            sockdir = tempfile.mkdtemp(prefix="repro-simfleet-")
            self.socket_url = f"unix://{sockdir}/coord.sock"
            self.server = CoordinatorServer(
                self.socket_url, coordinator=self.coordinator,
                resume_timeout_s=resume_timeout_s)

    # ------------------------------------------------------------- plumbing
    def clock(self) -> float:
        return self.now

    @property
    def store(self):
        return get_store(self.store_name)

    def root_uri(self, job_id: str, host_id: str) -> str:
        uri = (f"cache+remote://{self.store_name}"
               f"?front={host_id}&prefix={job_id}")
        return uri + ("&" + self._uri_params if self._uri_params else "")

    def _config(self, job_id: str, host_id: str) -> SessionConfig:
        return SessionConfig(root=self.root_uri(job_id, host_id),
                             codec=self.codec, serial=True,
                             migration=MigrationPolicy(arch="simjob"))

    # ------------------------------------------------------------ admission
    def least_loaded_host(self) -> str:
        load = self.topology.device_load(self.coordinator.registry)
        live = self.topology.hosts()
        return min(live, key=lambda h: (load.get(h.host_id, 0),
                                        h.host_id)).host_id

    def submit_jobs(self, n: int, *, steps: int = 3,
                    arrival_rate: float | None = None) -> list:
        """Admit ``n`` seeded jobs. With ``arrival_rate`` the cluster
        clock advances by seeded exponential inter-arrival gaps (a
        Poisson arrival process); each job lands on the least-loaded
        live host and runs ``steps`` initial steps."""
        ids = []
        for _ in range(int(n)):
            if arrival_rate:
                self.now += float(self.rng.exponential(1.0 / arrival_rate))
            job_id = f"j{len(self.jobs)}"
            host = self.least_loaded_host()
            job = SimJob(job_id, seed=self.seed * 1000 + len(self.jobs),
                         leaves=self.leaves, leaf_kb=self.leaf_kb,
                         device=self.device)
            job.run(steps)
            self._attach(job, host)
            ids.append(job_id)
        return ids

    def submit_serve_jobs(self, n: int, *, ticks: int = 2,
                          slots: int = 4, page_len: int = 24,
                          rate: float = 2.0) -> list:
        """Admit ``n`` serving planes (SimServeJob) — the coordinator
        sees them as kind="serve" and drains them at decode
        boundaries."""
        ids = []
        for _ in range(int(n)):
            job_id = f"j{len(self.jobs)}"
            host = self.least_loaded_host()
            job = SimServeJob(job_id,
                              seed=self.seed * 1000 + len(self.jobs),
                              slots=slots, page_len=page_len, rate=rate,
                              device=self.device)
            job.run(ticks)
            self._attach(job, host)
            ids.append(job_id)
        return ids

    def _attach(self, job, host: str):
        cfg = self._config(job.job_id, host)
        client = self._client(job, cfg.to_wire(), host)
        self.jobs[job.job_id] = job
        self.clients[job.job_id] = client
        if self.server is not None:
            transport = self.server.attach(
                job.job_id, cfg.to_wire(), host=host,
                kind=getattr(job, "kind", "train"))
            transport.on_send = self._on_frame
            self._dial(job.job_id, client, incarnation=0)
        else:
            transport = LoopbackTransport(client, host=host,
                                          on_send=self._on_frame)
            self.coordinator.attach(job.job_id, transport, host=host,
                                    config_wire=cfg.to_wire(),
                                    kind=getattr(job, "kind", "train"))
        self.all_transports.append(transport)

    def _dial(self, job_id: str, client: FleetClient, *,
              incarnation: int):
        """Socket mode: connect one worker agent for this incarnation
        (the previous incarnation's agent, if any, is retired first)."""
        old = self.agents.get(job_id)
        if old is not None:
            old.stop(bye=False)
        agent = WorkerAgent(client, self.socket_url,
                            incarnation=incarnation,
                            reconnect=ReconnectPolicy(attempts=40,
                                                      backoff_s=0.02,
                                                      backoff_max_s=0.2))
        agent.start()
        self.agents[job_id] = agent
        self.server.wait_connected([job_id], timeout=10.0)
        return agent

    def _client(self, job, config_wire: dict,
                host: str) -> FleetClient:
        serve = getattr(job, "kind", "train") == "serve"

        def drain():
            if serve:
                return job.drain()
            job.paused = True
            return job.step

        def restored(res):
            if serve:
                job.adopt(res)
            else:
                job.adopt(res.state, res.step)

        return FleetClient(
            job.job_id, config_wire, host=host,
            state_provider=lambda: (job.state(), job.step),
            on_drain=drain, on_restore=restored,
            meta_provider=job.meta if serve else None,
            sessions_provider=job.sessions_live if serve else None,
            device=self.device)

    def spawn(self, rec, host: str, config_wire: dict):
        """The coordinator's job launcher: a fresh incarnation of the
        job on ``host`` (new client, new session over the retargeted
        config) — state arrives via the RestoreRequest that follows. In
        socket mode the new incarnation DIALS IN like a relaunched
        worker would; the old incarnation's reconnects are refused as
        stale at the HELLO."""
        job = self.jobs[rec.job_id]
        job.paused = True                     # old incarnation is gone
        client = self._client(job, config_wire, host)
        self.clients[rec.job_id] = client
        if self.server is not None:
            transport = self.server.new_incarnation(rec.job_id, host=host)
            transport.on_send = self._on_frame
            self._dial(rec.job_id, client,
                       incarnation=transport.incarnation)
        else:
            transport = LoopbackTransport(client, host=host,
                                          on_send=self._on_frame)
        self.all_transports.append(transport)
        return transport

    # ------------------------------------------------------------ liveness
    def tick(self, dt: float = 1.0, *, steps: int = 1,
             heartbeat: bool = True, mute: tuple = ()):
        """Advance the cluster: clock += dt, running jobs step, and (by
        default) every live job's heartbeat crosses the wire. ``mute``
        silences chosen jobs — how a test makes one job look dead."""
        self.now += float(dt)
        for job_id, job in self.jobs.items():
            job.run(steps)
            if heartbeat and job_id not in mute and job.running \
                    and not job.paused \
                    and self.topology.alive(self._host_of(job_id)):
                if self.server is not None:
                    # socket mode: the beacon crosses the real wire as
                    # an event envelope (delivery is asynchronous)
                    self.agents[job_id].heartbeat(self.now)
                else:
                    self.coordinator.deliver(
                        self.clients[job_id].heartbeat(self.now))

    def _host_of(self, job_id: str) -> str:
        return self.coordinator.registry.get(job_id).host

    # ------------------------------------------------------------- failures
    def fail_host(self, host: str):
        """Kill a host NOW: its transports stop delivering, its hot
        fronts stop counting, its jobs are lost until re-placed."""
        self.topology.fail_host(host)
        for job_id, t in self.coordinator.transports.items():
            if t.host == host:
                t.dead = True
        self.coordinator.registry.mark_host_lost(host)

    def arm_failure(self, *, kind: str, nth: int, host: str | None = None):
        """Seeded chaos: when the ``nth`` wire frame of ``kind`` (e.g.
        "MigrateRequest") is about to cross any transport, kill
        ``host`` (default: the frame's own target host). Exact and
        replayable — the same schedule produces the same wave."""
        self._armed.append([kind, int(nth), host])

    def seeded_failures(self, count: int, *, kind: str = "MigrateRequest",
                        span: int = 10) -> list:
        """Draw ``count`` distinct frame ordinals in [1, span] from the
        cluster seed and arm them (host = each frame's target): the
        acceptance harness's "2 seeded node failures mid-wave"."""
        picks = sorted(self.rng.choice(np.arange(1, span + 1),
                                       size=count, replace=False).tolist())
        for nth in picks:
            self.arm_failure(kind=kind, nth=nth)
        return picks

    def _on_frame(self, host: str, frame: dict):
        with self._frame_lock:
            for armed in self._armed:
                kind, nth, target = armed
                if frame.get("kind") != kind:
                    continue
                armed[1] = nth - 1
                if armed[1] == 0:
                    self.fail_host(target or host)
            self._armed = [a for a in self._armed if a[1] > 0]

    # ------------------------------------------------------------- shutdown
    def shutdown(self):
        """Socket mode cleanup: stop every agent, close the server and
        remove the socket's directory. Loopback clusters have nothing to
        tear down (no-op)."""
        for agent in self.agents.values():
            agent.stop(bye=False)
        self.agents.clear()
        if self.server is not None:
            self.server.close(bye=True)
            shutil.rmtree(os.path.dirname(parse_url(self.socket_url)[1]),
                          ignore_errors=True)

    # ------------------------------------------------------------- digests
    def job_digest(self, job_id: str) -> str:
        """The job's CURRENT logical-state digest (for bit-identity
        assertions against dump records and restore acks). A job's state
        lies on its one device: no DTensor, so no collective."""
        from repro_torch.core.dump import flatten_with_paths
        from repro_torch.core.integrity import tree_digest
        return tree_digest(flatten_with_paths(self.jobs[job_id].state()))
