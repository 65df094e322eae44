"""Chaos tests for the port's socket transport (repro_torch.fleet.transport):
the twin of tests/test_transport_chaos.py, all 9 scenarios with the same
seeds, cut points and asserts, every job a port SimJob on device="cpu"
behind a port FleetClient.

Every scenario arms its failure at an exact protocol moment (ChaosSocket
cuts at chosen byte offsets inside chosen frames; ChaosPlan draws them
from a seed). Where the JAX test sleeps for a liveness window to pass,
this one drives the restarted coordinator's ``clock=`` instead, and waits
on the transport's ``on_send`` for the pending command, never on a sleep.
Where the JAX test reads a cut the worker's thread may not have recorded
yet (a cut past a reply's last byte), this one waits for the cut.
Every wait and every subprocess has a timeout (the example's --serve
carries its own watchdog), so a hung scenario fails on its own.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

from faultinject import ChaosPlan, ChaosSocket  # noqa: E402
from repro_torch.api import wire  # noqa: E402
from repro_torch.api.config import MigrationPolicy, SessionConfig  # noqa: E402
from repro_torch.fleet import (FleetClient, HostDownError,  # noqa: E402
                               ReconnectPolicy, WorkerAgent,
                               coordinator_serve)
from repro_torch.fleet.messages import DrainAck, DrainCommand  # noqa: E402
from repro_torch.fleet.simcluster import SimJob  # noqa: E402

_EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "fleet_multiprocess_torch.py")
_FAST = ReconnectPolicy(attempts=60, backoff_s=0.02, backoff_max_s=0.1)
DEV = "cpu"


def make_client(tmp, job_id, *, seed=7, steps=3):
    """One seeded SimJob behind a FleetClient (state = f(seed, step),
    so bit-identity is checkable by digest)."""
    job = SimJob(job_id, seed=seed, leaves=2, leaf_kb=4, device=DEV)
    job.run(steps)
    cfg = SessionConfig(root=f"file://{tmp}/{job_id}", serial=True,
                        migration=MigrationPolicy(arch="simjob"))

    def drain():
        job.paused = True
        return job.step

    client = FleetClient(
        job_id, cfg.to_wire(), host="w0",
        state_provider=lambda: (job.state(), job.step),
        on_drain=drain,
        on_restore=lambda res: job.adopt(res.state, res.step), device=DEV)
    return job, cfg, client


class SignalledChaos(ChaosSocket):
    """A ChaosSocket that sets ``fired`` once its cut is recorded. A cut
    placed past a reply's last byte lets the coordinator finish before
    the worker's thread records the cut, so a test waits on ``fired``
    instead of racing that thread."""

    def __init__(self, sock, **kw):
        super().__init__(sock, **kw)
        self.fired = threading.Event()

    def sendall(self, data):
        try:
            return super().sendall(data)
        finally:
            if self.cuts:
                self.fired.set()

    def recv(self, n):
        try:
            return super().recv(n)
        finally:
            if self.cuts:
                self.fired.set()


def one_shot_wrap(chaos_kw):
    """wrap_socket that arms SignalledChaos(**chaos_kw) on the FIRST
    connection only; later (re)connections get a clean wire."""
    armed = []

    def wrap(sock):
        if armed:
            return sock
        cs = SignalledChaos(sock, **chaos_kw)
        armed.append(cs)
        return cs
    return wrap, armed


class Clock:
    """A coordinator clock the test advances by hand."""

    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now


# ------------------------------------------------- cut mid-command (recv)
def test_cut_mid_drain_command_executes_exactly_once(tmp_path):
    """The connection dies 9 bytes into the DrainCommand frame (frame 1
    is the hello_ack, frame 2 the cmd): the worker reconnects, the
    coordinator replays the command on the resumed connection, and it
    executes EXACTLY once."""
    server = coordinator_serve(f"unix://{tmp_path}/c.sock",
                               resume_timeout_s=10.0)
    job, cfg, client = make_client(tmp_path, "j0")
    t = server.attach("j0", cfg.to_wire(), host="w0")
    wrap, armed = one_shot_wrap(dict(cut_recv_frame=(2, 9)))
    agent = WorkerAgent(client, server.url, wrap_socket=wrap,
                        reconnect=_FAST)
    agent.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        ack = wire.decode(t.send(DrainCommand(job_id="j0").to_wire()))
        assert isinstance(ack, DrainAck) and ack.step == job.step
        assert job.paused
        assert armed[0].cuts == [("recv", 2, 9)]   # the cut really fired
        assert agent.stats["reconnects"] == 1
        assert client.commands_executed == 1       # exactly once
        assert agent.stats["dedup_hits"] == 0      # never even executed
    finally:
        agent.stop()
        server.close()


# --------------------------------------------------- cut mid-reply (send)
def test_cut_mid_reply_dedups_on_replay(tmp_path):
    """The connection dies 10 bytes into the worker's reply (frame 1 is
    the hello, frame 2 the reply): the command HAS executed, so the
    replayed command on the resumed connection must hit the dedup
    window — answered from cache, not run again."""
    server = coordinator_serve(f"unix://{tmp_path}/c.sock",
                               resume_timeout_s=10.0)
    job, cfg, client = make_client(tmp_path, "j0")
    t = server.attach("j0", cfg.to_wire(), host="w0")
    wrap, armed = one_shot_wrap(dict(cut_send_frame=(2, 10)))
    agent = WorkerAgent(client, server.url, wrap_socket=wrap,
                        reconnect=_FAST)
    agent.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        ack = wire.decode(t.send(DrainCommand(job_id="j0").to_wire()))
        assert isinstance(ack, DrainAck) and ack.step == job.step
        assert armed[0].cuts and armed[0].cuts[0][0] == "send"
        assert agent.stats["reconnects"] == 1
        assert client.commands_executed == 1       # executed once...
        assert agent.stats["dedup_hits"] == 1      # ...replay from cache
    finally:
        agent.stop()
        server.close()


# ------------------------------------------- kill after the ack: no loss
def test_kill_after_dump_ack_loses_nothing(tmp_path):
    """The connection is severed the instant the dump reply's last byte
    leaves the worker (cut offset past the frame end): the receipt
    landed, the registry committed it, and the restore over the resumed
    connection is bit-identical — a post-ack kill loses NOTHING."""
    server = coordinator_serve(f"unix://{tmp_path}/c.sock",
                               resume_timeout_s=10.0)
    job, cfg, client = make_client(tmp_path, "j0")
    server.attach("j0", cfg.to_wire(), host="w0")
    # worker send frames: 1 = hello, 2 = drain reply, 3 = migrate reply
    wrap, armed = one_shot_wrap(dict(cut_send_frame=(3, 1 << 20)))
    agent = WorkerAgent(client, server.url, wrap_socket=wrap,
                        reconnect=_FAST)
    agent.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        report = server.coordinator.preemption_wave(replace_lost=False)
        assert report.complete and "j0" in report.dumped
        rec = server.registry.get("j0")
        assert rec.phase == "dumped" and rec.state_digest
        assert armed[0].fired.wait(timeout=10.0)   # died right after the ack
        assert armed[0].cuts
        assert server.wait_connected(["j0"], timeout=10.0)  # resumed
        ack = server.coordinator.restore_job("j0")
        assert ack is not None
        assert ack.state_digest == rec.state_digest
        assert agent.stats["reconnects"] == 1
    finally:
        agent.stop()
        server.close()


# ------------------------------------------------------- seeded cut soak
def test_seeded_chaos_plan_soak_exactly_once(tmp_path):
    """A seeded ChaosPlan keeps cutting fresh connections at drawn
    (frame, offset) points while a stream of commands runs through:
    every command still executes exactly once, and the same seed
    replays the same cut schedule."""
    server = coordinator_serve(f"unix://{tmp_path}/c.sock",
                               resume_timeout_s=20.0)
    job, cfg, client = make_client(tmp_path, "j0")
    t = server.attach("j0", cfg.to_wire(), host="w0")
    plan = ChaosPlan(seed=1234, limit=5, frame_span=(2, 3),
                     off_span=(1, 40))
    agent = WorkerAgent(client, server.url, wrap_socket=plan.wrap,
                        reconnect=_FAST)
    agent.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        commands = 6
        for i in range(commands):
            ack = wire.decode(t.send(
                DrainCommand(job_id="j0", reason=f"soak-{i}").to_wire()))
            assert isinstance(ack, DrainAck) and ack.step == job.step
        assert client.commands_executed == commands    # exactly once each
        assert 1 <= plan.cuts_fired() <= plan.limit
        assert agent.stats["reconnects"] == plan.cuts_fired()
        # determinism: the same seed draws the same schedule
        replay = ChaosPlan(seed=1234, limit=5, frame_span=(2, 3),
                           off_span=(1, 40))
        redrawn = [(replay._rng.randint(2, 3), replay._rng.randint(1, 40))
                   for _ in plan.planned]
        assert redrawn == plan.planned
    finally:
        agent.stop()
        server.close()


# ---------------------------------------------- reconnect budget runs out
def test_reconnect_budget_exhaustion_fails_typed(tmp_path):
    """A coordinator that is never coming back: the agent burns its
    bounded reconnect budget and fails for good; the coordinator-side
    send times out with HostDownError — both ends fail TYPED."""
    server = coordinator_serve(f"unix://{tmp_path}/c.sock",
                               resume_timeout_s=0.5)
    job, cfg, client = make_client(tmp_path, "j0")
    t = server.attach("j0", cfg.to_wire(), host="w0")
    agent = WorkerAgent(client, server.url,
                        reconnect=ReconnectPolicy(attempts=3,
                                                  backoff_s=0.01,
                                                  backoff_max_s=0.02))
    agent.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        server.kill()                       # no bye, no coming back
        with pytest.raises(HostDownError):
            t.send(DrainCommand(job_id="j0").to_wire())
        assert agent.failed.wait(timeout=10.0)
        assert client.commands_executed == 0
    finally:
        agent.stop(bye=False)


# ------------------------------------- coordinator crash-restart, in-proc
def test_coordinator_restart_readopts_and_cas_holds(tmp_path):
    """kill() the coordinator with a claim in flight; the restarted one
    (same journal) re-adopts live workers at a bumped epoch, the claim
    CAS still has exactly one winner, and the pending restore completes
    bit-identical over the re-bound connections."""
    journal = f"file://{tmp_path}/journal"
    url = f"unix://{tmp_path}/c.sock"
    server = coordinator_serve(url, registry_tier=journal,
                               resume_timeout_s=10.0)
    agents = {}
    digests = {}
    try:
        for jid in ("j0", "j1"):
            job, cfg, client = make_client(tmp_path, jid,
                                           seed=11 + int(jid[1]))
            server.attach(jid, cfg.to_wire(), host="w0")
            agents[jid] = WorkerAgent(client, url, reconnect=_FAST)
            agents[jid].start()
        assert server.wait_connected(["j0", "j1"], timeout=10.0)
        report = server.coordinator.preemption_wave(replace_lost=False)
        assert report.complete and len(report.dumped) == 2
        digests = {j: server.registry.get(j).state_digest
                   for j in ("j0", "j1")}
        # a restore claim taken... and then the coordinator dies
        assert server.registry.claim_restore("j1")
        server.kill()

        server2 = coordinator_serve(url, registry_tier=journal,
                                    resume_timeout_s=10.0)
        try:
            assert server2.epoch == server.epoch + 1
            assert server2.registry.get("j0").phase == "dumped"
            assert server2.registry.get("j1").phase == "restoring"
            # live workers redial into the NEW coordinator on their own
            assert server2.wait_connected(["j0", "j1"], timeout=15.0)
            for agent in agents.values():
                # wait_connected returns once the coordinator has sent
                # hello_ack; the agent stores the epoch after reading it
                agent.wait_epoch(server2.epoch, timeout=10.0)
                assert agent._epoch == server2.epoch   # windows dropped
            # single-winner CAS across the restart: the journaled claim
            # still blocks a second winner
            assert server2.coordinator.restore_job("j1") is None
            ack = server2.coordinator.restore_job("j0")
            assert ack is not None
            assert ack.state_digest == digests["j0"]   # bit-identical
        finally:
            server2.close()
    finally:
        for agent in agents.values():
            agent.stop(bye=False)


class HelloSpy(ChaosSocket):
    """A fault-free ChaosSocket that sets ``hello`` once the agent has
    sent anything (its HELLO comes first on every connection)."""

    def __init__(self, sock, hello):
        super().__init__(sock)
        self.hello = hello

    def sendall(self, data):
        try:
            return super().sendall(data)
        finally:
            self.hello.set()


def test_restart_serves_no_hello_before_its_journaled_jobs(tmp_path,
                                                           monkeypatch):
    """A worker that redials while the restarted coordinator is still
    giving its journaled jobs their transports waits in the listen
    backlog: it is not refused as an unknown job, which would fail its
    agent for good. The restart is held between its listener and its
    transports until the agent's HELLO is out, and a little longer if the
    coordinator has accepted it, so the HELLO lands in that gap on every
    run."""
    from repro_torch.fleet import transport
    journal = f"file://{tmp_path}/journal"
    url = f"unix://{tmp_path}/c.sock"
    server = coordinator_serve(url, registry_tier=journal,
                               resume_timeout_s=10.0)
    job, cfg, client = make_client(tmp_path, "j0", seed=31)
    server.attach("j0", cfg.to_wire(), host="w0")
    sent = threading.Event()
    agent = WorkerAgent(client, url, reconnect=_FAST,
                        wrap_socket=lambda sock: HelloSpy(sock, sent))
    agent.start()
    real = transport.CoordinatorServer._ensure_transports

    def held(self):
        assert sent.wait(timeout=10.0)
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline and not (
                self.stats["hellos"] or self.stats["rejected"]):
            time.sleep(0.01)     # a coordinator that took the HELLO
        return real(self)
    server2 = None
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        sent.clear()
        monkeypatch.setattr(transport.CoordinatorServer,
                            "_ensure_transports", held)
        server.kill()
        server2 = coordinator_serve(url, registry_tier=journal,
                                    resume_timeout_s=10.0)
        assert server2.wait_connected(["j0"], timeout=10.0), \
            (agent.failed.is_set(), server2.stats)
        assert not agent.failed.is_set()
        assert server2.stats["rejected"] == 0
        agent.wait_epoch(server2.epoch, timeout=10.0)
        assert agent._epoch == server2.epoch
    finally:
        agent.stop(bye=False)
        if server2 is not None:
            server2.close()


# ----------------------------- heartbeats never return: re-place via sweep
def test_restart_replaces_job_whose_heartbeats_never_return(tmp_path):
    """After a coordinator restart, a job whose worker never redials
    falls out of the liveness window; check_heartbeats() claims it and
    the restore executes on the NEXT incarnation that dials in — the
    stale incarnation's late HELLO is refused. The restarted
    coordinator's clock is driven by hand: the liveness window passes
    because the clock says so, not because the test slept."""
    journal = f"file://{tmp_path}/journal"
    url = f"unix://{tmp_path}/c.sock"
    server = coordinator_serve(url, registry_tier=journal,
                               resume_timeout_s=15.0)
    job, cfg, client = make_client(tmp_path, "j0", seed=23)
    server.attach("j0", cfg.to_wire(), host="w0")
    agent = WorkerAgent(client, url, reconnect=_FAST)
    agent.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        report = server.coordinator.preemption_wave(replace_lost=False)
        assert report.complete
        digest = server.registry.get("j0").state_digest
        ack = server.coordinator.restore_job("j0")     # phase: running
        assert ack is not None and ack.state_digest == digest
        inc = server.registry.get("j0").incarnation
        agent.stop(bye=False)          # the worker silently disappears
        server.kill()

        clock = Clock(100.0)
        server2 = coordinator_serve(url, registry_tier=journal,
                                    heartbeat_timeout_s=0.3, clock=clock,
                                    resume_timeout_s=15.0)
        try:
            assert server2.registry.get("j0").phase == "running"
            assert server2.coordinator.check_heartbeats() == {}  # in time
            clock.now += 0.6           # liveness window expires, no HELLO
            t = server2.transport("j0")
            sending = threading.Event()
            t.on_send = lambda host, frame: sending.set()
            moved = {}
            sweeper = threading.Thread(
                target=lambda: moved.update(
                    server2.coordinator.check_heartbeats()),
                daemon=True)
            sweeper.start()            # blocks in send() awaiting a worker
            assert sending.wait(timeout=10.0)   # the RestoreRequest is out
            assert server2.registry.get("j0").phase == "restoring"
            # the batch system relaunches the job: a NEW incarnation
            # dials in and the pending RestoreRequest replays onto it
            job2, _cfg2, client2 = make_client(tmp_path, "j0", seed=99,
                                               steps=0)
            agent2 = WorkerAgent(client2, url, incarnation=inc + 1,
                                 reconnect=_FAST)
            agent2.start()
            sweeper.join(timeout=20.0)
            assert not sweeper.is_alive() and moved == {"j0": "w0"}
            # seed 99 state was overwritten by the image: bit-identical
            assert client2.last_restore is not None
            # the HELLO's adopt proved incarnation inc+1, and completing
            # the restore advanced the record once more
            assert server2.registry.get("j0").incarnation == inc + 2
            assert server2.registry.get("j0").phase == "running"
            agent2.stop(bye=False)
        finally:
            server2.close()
    finally:
        agent.stop(bye=False)


# ------------------------------------------------- incarnation fencing
def test_stale_incarnation_redial_is_refused(tmp_path):
    """Once the coordinator moves a job to its next incarnation, the
    dead incarnation's late redial is refused at the HELLO (typed
    HandshakeError, agent fails for good) — zombies cannot rebind."""
    server = coordinator_serve(f"unix://{tmp_path}/c.sock",
                               resume_timeout_s=5.0)
    job, cfg, client = make_client(tmp_path, "j0")
    server.attach("j0", cfg.to_wire(), host="w0")
    agent0 = WorkerAgent(client, server.url, incarnation=0,
                         reconnect=_FAST)
    agent0.start()
    try:
        assert server.wait_connected(["j0"], timeout=10.0)
        agent0.stop(bye=False)         # the incarnation dies silently
        t2 = server.new_incarnation("j0", host="w1")
        assert t2.incarnation == 1
        # the relaunched incarnation is admitted...
        job2, _cfg2, client2 = make_client(tmp_path, "j0", seed=8)
        agent2 = WorkerAgent(client2, server.url, incarnation=1,
                             reconnect=_FAST)
        agent2.start()
        assert server.wait_connected(["j0"], timeout=10.0)
        # ...and the zombie's redial is refused, not retried
        job3, _cfg3, client3 = make_client(tmp_path, "j0", seed=9)
        stale = WorkerAgent(client3, server.url, incarnation=0,
                            reconnect=_FAST)
        stale.start()
        assert stale.failed.wait(timeout=10.0)
        assert stale.stats["reconnects"] == 0      # refusal is final
        assert t2.connected                        # the live conn held
        agent2.stop(bye=False)
        stale.stop(bye=False)
    finally:
        agent0.stop(bye=False)
        server.close()


# ------------------------- SIGKILL the coordinator subprocess mid-wave
def _serve_proc(url, journal, root, out, *, die_after=0, timeout=120.0):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    cmd = [sys.executable, _EXAMPLE, "--serve", "--device", DEV,
           "--socket", url, "--journal", journal, "--root", root,
           "--jobs", "j0,j1,j2", "--out", out, "--timeout", str(timeout),
           "--resume-timeout", "20"]
    if die_after:
        cmd += ["--die-after-dumps", str(die_after)]
    return subprocess.Popen(cmd, env=env)


def _journaled(path, jobs, timeout: float) -> bool:
    """True once the coordinator's journal lists every job in ``jobs`` (it
    journals each attach), False after ``timeout``. The example's --serve
    listens before it attaches its jobs, and a worker whose HELLO beats
    its job's attach is refused for good."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                if {j["job_id"] for j in json.load(f)["jobs"]} >= set(jobs):
                    return True
        except (OSError, ValueError, KeyError):
            pass
        threading.Event().wait(0.02)
    return False


def _wave_digests(tmp_path, name, *, die_after=0):
    """Run the port example's --serve coordinator (a real subprocess) over
    3 in-test workers; with ``die_after`` it SIGKILLs itself mid-wave and
    is restarted from the journal. Returns the final digests."""
    root = str(tmp_path / name)
    os.makedirs(root, exist_ok=True)
    url = f"unix://{root}/c.sock"
    journal = f"file://{root}/journal"
    out = f"{root}/wave.json"
    agents, procs = [], []
    try:
        procs.append(_serve_proc(url, journal, root, out,
                                 die_after=die_after))
        assert _journaled(f"{root}/journal/fleet/registry.json",
                          ("j0", "j1", "j2"), timeout=120.0)
        for i, jid in enumerate(("j0", "j1", "j2")):
            _job, _cfg, client = make_client(root, jid, seed=41 + i)
            agents.append(WorkerAgent(
                client, url,
                reconnect=ReconnectPolicy(attempts=400, backoff_s=0.05,
                                          backoff_max_s=0.25)))
            agents[-1].start()
        rc = procs[-1].wait(timeout=120)
        if die_after:
            # the coordinator was SIGKILLed mid-wave, by construction
            assert rc == -signal.SIGKILL, rc
            assert not os.path.exists(out)
            with open(f"{root}/journal/fleet/registry.json") as f:
                snap = json.load(f)
            phases = {j["job_id"]: j["phase"] for j in snap["jobs"]}
            assert sum(p == "dumped" for p in phases.values()) == die_after
            # restart from the journal: the wave completes
            procs.append(_serve_proc(url, journal, root, out))
            rc = procs[-1].wait(timeout=120)
        assert rc == 0, rc
        with open(out) as f:
            result = json.load(f)
        assert set(result["phases"]) == {"j0", "j1", "j2"}
        # every job landed dumped-or-running, none stuck in limbo
        assert all(p in ("dumped", "running")
                   for p in result["phases"].values()), result["phases"]
        assert all(result["digests"].values())
        if die_after:
            assert result["epoch"] == 2        # the restart really bumped
        return result["digests"]
    finally:
        for a in agents:
            a.stop(bye=False)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_sigkill_coordinator_mid_wave_completes_bit_identical(tmp_path):
    """The port example's coordinator subprocess SIGKILLs itself after the
    first committed dump (mid-wave, by construction), restarts from the
    journaled registry, and the completed wave's digests are
    bit-identical to an uninterrupted control run with the same seeds."""
    control = _wave_digests(tmp_path, "control")
    crashed = _wave_digests(tmp_path, "crashed", die_after=1)
    assert crashed == control                  # bit-identical wave
