"""The socket wire across packages, over real Unix-domain sockets: the JAX
package's fleet (repro.fleet.transport) and the port's
(repro_torch.fleet.transport) speak the same frames, so each package's
coordinator serves the other's workers, and each re-adopts the other's
journal.

  (a) mixed fleets: a JAX ``coordinator_serve`` drives port workers
      (SimJobs on device="cpu") beside a JAX one, and the port's drives
      JAX workers beside a port one; the wave, the restores, the digests
      and every stored object (chunks byte for byte, manifests apart from
      ``env``, ``created_at`` and ``digest``) equal an all-JAX run's, as
      the loopback parity (a) in tests/test_torch_fleet.py holds them;
  (b) a journal written by one package's coordinator, killed mid-claim,
      is re-adopted by the other's: the epoch bumps, the table reloads,
      the live workers redial, the claim CAS keeps one winner, and the
      restore is bit-identical;
  (c) SimCluster(transport="socket") in both packages and the port's
      loopback SimCluster give equal waves, restores and stored objects
      under a seeded node failure (the coordinators' per-job threads run
      inline, as in tests/test_torch_fleet.py, so the failure strikes the
      same frame in every run).

Every wait has a timeout; nothing sleeps a fixed time.
"""
import dataclasses
import json
import os
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro import fleet as jfleet  # noqa: E402
from repro.core import remote as jremote  # noqa: E402
from repro.fleet import coordinator as jcoord  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core import remote as tremote  # noqa: E402
from repro_torch.fleet import coordinator as tcoord  # noqa: E402

DEV = "cpu"
SKIP = ("env", "created_at", "digest")
PKGS = {"jax": jfleet, "torch": tfleet}
_RECONNECT = dict(attempts=200, backoff_s=0.02, backoff_max_s=0.1)


@pytest.fixture(autouse=True)
def _fresh_registry():
    tremote.reset_tier_registry()
    jremote.reset_tier_registry()
    yield
    tremote.reset_tier_registry()
    jremote.reset_tier_registry()


def _config(pkg, root, job_id):
    if pkg is jfleet:
        from repro.api.config import MigrationPolicy, SessionConfig
    else:
        from repro_torch.api.config import MigrationPolicy, SessionConfig
    return SessionConfig(root=f"file://{root}/{job_id}", serial=True,
                         migration=MigrationPolicy(arch="simjob")).to_wire()


def _client(pkg, root, job_id, seed, steps=3):
    """A seeded SimJob of ``pkg`` behind that package's FleetClient."""
    kw = {} if pkg is jfleet else {"device": DEV}
    job = pkg.SimJob(job_id, seed=seed, leaves=2, leaf_kb=4, **kw)
    job.run(steps)

    def drain():
        job.paused = True
        return job.step

    return job, pkg.FleetClient(
        job_id, _config(pkg, root, job_id), host=f"w-{job_id}",
        state_provider=lambda: (job.state(), job.step), on_drain=drain,
        on_restore=lambda res: job.adopt(res.state, res.step), **kw)


def _until(pred, timeout: float) -> bool:
    """Poll ``pred`` until it holds or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            return False
        threading.Event().wait(0.005)
    return True


def _dial(pkg, client, url):
    agent = pkg.WorkerAgent(client, url,
                            reconnect=pkg.ReconnectPolicy(**_RECONNECT))
    agent.start()
    return agent


def _stored(root, job_ids) -> dict:
    """Every object under each job's file:// root: bytes, manifests
    without the fields that name the writer and the time."""
    out = {}
    for jid in job_ids:
        base = os.path.join(root, jid)
        for d, _dirs, files in os.walk(base):
            for name in files:
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    data = f.read()
                if name == "manifest.json":
                    man = json.loads(data)
                    data = {k: v for k, v in man.items() if k not in SKIP}
                out[os.path.relpath(path, root)] = data
    return out


def _table(registry, root="") -> list:
    """The registry's jobs without their liveness stamps, ``root`` (a
    run's directory) written as <root>."""
    jobs = [{k: v for k, v in j.items() if k != "last_heartbeat"}
            for j in registry.to_wire()["jobs"]]
    return json.loads(json.dumps(jobs).replace(root, "<root>")) if root \
        else jobs


# ----------------------------------------------- (a) mixed fleets
def _mixed_run(tmp_path, name, coord, workers):
    """``coord``'s coordinator_serve on a UDS; job i a SimJob of
    ``workers[i]`` (seed 41 + i) dialing in through that package's
    WorkerAgent; one wave, then every job restored. -> (dumped digests,
    restore-ack digests, stored objects, registry table)."""
    root = str(tmp_path / name)
    os.makedirs(root)
    server = PKGS[coord].coordinator_serve(
        f"unix://{root}/c.sock", registry_tier=f"file://{root}/journal",
        resume_timeout_s=30.0)
    ids = [f"j{i}" for i in range(len(workers))]
    agents = []
    try:
        for i, (jid, pkg) in enumerate(zip(ids, workers)):
            _job, client = _client(PKGS[pkg], root, jid, 41 + i)
            server.attach(jid, _config(PKGS[pkg], root, jid),
                          host=f"w-{jid}")
            agents.append(_dial(PKGS[pkg], client, server.url))
        assert server.wait_connected(ids, timeout=30.0)
        report = server.coordinator.preemption_wave(replace_lost=False)
        assert report.complete and sorted(report.dumped) == ids
        digests = {j: server.registry.get(j).state_digest for j in ids}
        acks = {}
        for j in ids:
            ack = server.coordinator.restore_job(j)
            assert ack is not None
            acks[j] = ack.state_digest
        assert all(a.stats["commands"] == 3 for a in agents)
        return (digests, acks, _stored(root, ids),
                _table(server.registry, root))
    finally:
        for a in agents:
            a.stop(bye=False)
        server.close()


@pytest.mark.parametrize("coord,workers", [
    ("jax", ("torch", "jax", "torch")),
    ("torch", ("jax", "torch", "jax")),
], ids=["jax-coordinator", "torch-coordinator"])
def test_mixed_fleet_wave_over_uds_equals_all_jax(tmp_path, coord, workers):
    ref = _mixed_run(tmp_path, "ref", "jax", ("jax",) * 3)
    got = _mixed_run(tmp_path, "mixed", coord, workers)
    digests, acks, stored, table = got
    assert digests == ref[0] and all(digests.values())
    assert acks == digests == ref[1]                  # bit-identical
    assert sorted(stored) == sorted(ref[2])
    assert any("/chunks/" in k for k in stored)
    for key, want in ref[2].items():
        assert stored[key] == want, key
    assert table == ref[3]


# ----------------------------------------- (b) the journal crosses
@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")],
                         ids=["jax-journal-to-torch", "torch-journal-to-jax"])
def test_journal_readopted_across_packages(tmp_path, first, second):
    """``first``'s coordinator journals a wave and a restore claim, then
    dies (no bye, nothing flushed past the journal); ``second``'s
    coordinator starts over the same journal and socket path: epoch + 1,
    the same table, the live (mixed) workers redial on their own, the
    journaled claim still blocks a second winner, and the other job's
    restore is bit-identical."""
    journal = f"file://{tmp_path}/journal"
    url = f"unix://{tmp_path}/c.sock"
    server = PKGS[first].coordinator_serve(url, registry_tier=journal,
                                           resume_timeout_s=30.0)
    agents = []
    try:
        for i, (jid, pkg) in enumerate((("j0", "torch"), ("j1", "jax"))):
            _job, client = _client(PKGS[pkg], tmp_path, jid, 11 + i)
            server.attach(jid, _config(PKGS[pkg], tmp_path, jid),
                          host=f"w-{jid}")
            agents.append(_dial(PKGS[pkg], client, url))
        assert server.wait_connected(["j0", "j1"], timeout=30.0)
        report = server.coordinator.preemption_wave(replace_lost=False)
        assert report.complete and len(report.dumped) == 2
        digests = {j: server.registry.get(j).state_digest
                   for j in ("j0", "j1")}
        assert server.registry.claim_restore("j1")
        table = _table(server.registry)
        server.kill()
        # the second package reads the first's journal as it lies on disk
        # (once its coordinator listens, the redialing workers' HELLOs
        # update the live table at their own pace)
        snap = json.loads((tmp_path / "journal" / "fleet" /
                           "registry.json").read_text())
        assert _table(PKGS[second].JobRegistry.from_wire(
            snap, clock=lambda: 0.0)) == table

        server2 = PKGS[second].coordinator_serve(url, registry_tier=journal,
                                                 resume_timeout_s=30.0)
        try:
            assert type(server2).__module__.startswith(
                "repro_torch" if second == "torch" else "repro.")
            assert server2.epoch == server.epoch + 1
            assert server2.registry.get("j0").phase == "dumped"
            assert server2.registry.get("j1").phase == "restoring"
            assert server2.wait_connected(["j0", "j1"], timeout=30.0)
            for agent in agents:
                # wait_connected returns once the coordinator has SENT
                # hello_ack; the agent (of either package) stores the
                # epoch after reading it
                _until(lambda: agent._epoch == server2.epoch, 10.0)
                assert agent._epoch == server2.epoch   # windows dropped
            assert server2.coordinator.restore_job("j1") is None
            ack = server2.coordinator.restore_job("j0")
            assert ack is not None and ack.state_digest == digests["j0"]
        finally:
            server2.close()
        # the journal the second package left reads back in the first's
        snap = json.loads((tmp_path / "journal" / "fleet" /
                           "registry.json").read_text())
        assert snap["epoch"] == server2.epoch
        again = PKGS[first].JobRegistry.from_wire(snap, clock=lambda: 0.0)
        assert _table(again) == _table(server2.registry)
    finally:
        for a in agents:
            a.stop(bye=False)


# ------------------------------- (c) SimCluster over the socket
class _InlineThread:
    """A coordinator's per-job thread run to its end at start()."""

    def __init__(self, target=None, args=(), kwargs=None, daemon=None):
        self._run = lambda: target(*args, **(kwargs or {}))

    def start(self):
        self._run()

    def join(self, timeout=None):
        pass


def _cluster_run(fleet, **kw):
    """6 SimJobs on 3 hosts, a wave, every job restored, 2 more steps, a
    second wave under one seeded node failure, the lost jobs re-placed and
    the rest restored -> (reports, restore-ack digests, job digests,
    store objects, frames on the wire)."""
    cl = fleet.SimCluster(hosts=3, devices_per_host=4, seed=5,
                          dump_concurrency=2, leaf_kb=8, leaves=2,
                          store="socket-parity", **kw)
    try:
        cl.submit_jobs(6, steps=3, arrival_rate=1.0)
        reports = [cl.coordinator.preemption_wave()]
        acks = [cl.coordinator.restore_job(j).state_digest for j in cl.jobs]
        for job in cl.jobs.values():
            job.run(2)
        cl.seeded_failures(1, kind="MigrateRequest", span=6)
        reports.append(cl.coordinator.preemption_wave())
        reg = cl.coordinator.registry
        acks += [cl.coordinator.restore_job(j).state_digest
                 for j in sorted(cl.jobs) if reg.get(j).phase == "dumped"]
        digests = {j: cl.job_digest(j) for j in cl.jobs}
        for j in cl.jobs:
            assert digests[j] == reg.get(j).state_digest
        store = (tremote if fleet is tfleet else jremote).get_store(
            "socket-parity")
        objects = {}
        for key in sorted(store._objects):
            data = bytes(store.get(key))
            if key.endswith("manifest.json"):
                data = {k: v for k, v in json.loads(data).items()
                        if k not in SKIP}
            objects[key] = data
        frames = sum(t.frames_received for t in cl.all_transports)
        assert cl.coordinator.stats["wire_frames"] == frames
        return reports, acks, digests, objects, cl.coordinator.stats
    finally:
        cl.shutdown()


def test_socket_simcluster_equals_loopback_in_both_packages(monkeypatch):
    inline = types.SimpleNamespace(Thread=_InlineThread, Lock=threading.Lock)
    monkeypatch.setattr(jcoord, "threading", inline)
    monkeypatch.setattr(tcoord, "threading", inline)
    runs = {}
    for name, fleet, kw in (
            ("torch-loopback", tfleet, dict(device=DEV)),
            ("torch-socket", tfleet, dict(device=DEV, transport="socket")),
            ("jax-socket", jfleet, dict(transport="socket"))):
        tremote.reset_tier_registry()
        jremote.reset_tier_registry()
        runs[name] = _cluster_run(fleet, **kw)

    def plain(report):
        return {k: v for k, v in dataclasses.asdict(report).items()
                if k != "wall_s"}

    ref = runs["torch-loopback"]
    assert ref[0][1].lost and ref[0][1].replaced      # the failure struck
    for name in ("torch-socket", "jax-socket"):
        reports, acks, digests, objects, stats = runs[name]
        assert [plain(r) for r in reports] == [plain(r) for r in ref[0]], \
            name
        assert acks == ref[1] and digests == ref[2], name
        assert sorted(objects) == sorted(ref[3]), name
        for key, want in ref[3].items():
            assert objects[key] == want, (name, key)
        assert stats == ref[4], name


def test_socket_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    """SimCluster(transport="socket") and a FleetClient to connect() run
    on the card by default: without one they raise before any socket is
    opened; asked for the CPU, they serve."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tfleet.SimCluster(transport="socket")
    with pytest.raises(RuntimeError, match="cuda"):
        tfleet.FleetClient("j0", _config(tfleet, tmp_path, "j0"),
                           state_provider=lambda: ({}, 0))
    cl = tfleet.SimCluster(transport="socket", device=DEV, hosts=1)
    try:
        cl.submit_jobs(1, steps=1)
        assert cl.server.wait_connected(["j0"], timeout=10.0)
        # the server counts j0 connected once it has sent hello_ack; the
        # agent sets its event after reading it
        assert cl.agents["j0"].connected.wait(timeout=10.0)
        sock_dir = os.path.dirname(tfleet.parse_url(cl.socket_url)[1])
    finally:
        cl.shutdown()
    assert not os.path.exists(sock_dir)
