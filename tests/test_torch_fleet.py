"""The port's fleet control plane (repro_torch.fleet) on device="cpu":
the twin of tests/test_fleet.py (all 12 tests, the same seeds and
asserts), and parity with the JAX package's fleet:

  (a) the acceptance scenario (20 jobs, 5 hosts x 8 devices, seed 42, 2
      seeded node failures) through both packages' SimCluster gives equal
      wave reports (all fields but ``wall_s``), registry tables, frame
      kinds in order, store contents (chunks byte for byte, manifests
      apart from ``env``, ``created_at`` and ``digest``) and state
      digests. Both coordinators run their per-job threads inline here,
      so the seeded failures strike the same frames in both packages
      (with threads, which frame of a batch is the Nth is a race);
  (b) a mixed fleet: the port's coordinator drives a JAX FleetClient and
      a torch one over LoopbackTransports with file:// roots; the JAX
      job's host fails and a torch incarnation restores its image, with
      the digest the JAX dump recorded;
  (c) a JAX registry journal round-trips through the port's JobRegistry.

Also: lossy trainers dumped concurrently through the device codec stage
(the plain versions here) in one batch, their next wave encoding delta8
against the image each incarnation was restored from."""
import dataclasses
import json
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faultinject import FaultSchedule, FlakyTier  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro.core import remote as jremote  # noqa: E402
from repro.fleet import coordinator as jcoord  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core import remote as tremote  # noqa: E402
from repro_torch.core.remote import reset_tier_registry  # noqa: E402
from repro_torch.core.storage import (MemoryTier, Tier,  # noqa: E402
                                      registered_tiers)
from repro_torch.fleet import SimCluster, retarget_root  # noqa: E402
from repro_torch.fleet import coordinator as tcoord  # noqa: E402

DEV = "cpu"
SKIP = ("env", "created_at", "digest")


@pytest.fixture(autouse=True)
def _fresh_registry():
    # every scenario gets its own URI namespace: no network model or
    # chunk index inherited from a previous test's store (both packages)
    reset_tier_registry()
    jremote.reset_tier_registry()
    yield
    reset_tier_registry()
    jremote.reset_tier_registry()


def wire_frames_on_transports(cluster) -> int:
    return sum(t.frames_received for t in cluster.all_transports)


# ---------------------------------------------------------------- waves
def test_wave_dumps_every_job_and_speaks_only_wire():
    cl = SimCluster(hosts=4, seed=1, device=DEV)
    cl.submit_jobs(8, steps=4, arrival_rate=1.0)
    cl.tick(1.0)
    digests = {j: cl.job_digest(j) for j in cl.jobs}

    report = cl.coordinator.preemption_wave()
    assert report.complete and len(report.dumped) == 8
    reg = cl.coordinator.registry
    for job_id, image_id in report.dumped.items():
        rec = reg.get(job_id)
        assert rec.image_id == image_id and rec.phase == "dumped"
        assert rec.state_digest == digests[job_id]
    frames = wire_frames_on_transports(cl)
    heartbeats = cl.coordinator.stats["heartbeats"]
    assert frames > 0
    assert cl.coordinator.stats["wire_frames"] == frames + heartbeats


def _gate_migrations(cluster, width: int):
    """Hold each MigrateRequest at its transport until ``width`` of them
    (one dump batch) have arrived, so a batch's dumps start together
    however the host schedules the coordinator's threads: on a loaded
    machine a thread may otherwise finish its whole dump before the next
    one is started, and the naive wave would show no contention."""
    gate = threading.Barrier(width)
    for t in cluster.all_transports:
        def on_send(host, frame, send=t.on_send):
            if frame["kind"] == "MigrateRequest":
                gate.wait(timeout=60)
            send(host, frame)
        t.on_send = on_send


def test_wave_staggers_under_bandwidth_budget():
    def run(stagger):
        reset_tier_registry()
        cl = SimCluster(hosts=4, seed=2, realtime=True, agg_mbps=50,
                        knee=2, dump_concurrency=2, leaf_kb=8, leaves=2,
                        device=DEV)
        cl.submit_jobs(8, steps=2)
        _gate_migrations(cl, 2 if stagger else 8)
        r = cl.coordinator.preemption_wave(stagger=stagger,
                                           replace_lost=False)
        assert len(r.dumped) == 8
        return cl.store.network.peak_active

    assert run(stagger=True) <= 2      # the budget held
    assert run(stagger=False) > 2      # the baseline provably contends


def test_wave_report_is_plain_data():
    cl = SimCluster(hosts=2, seed=3, device=DEV)
    cl.submit_jobs(2, steps=2)
    report = cl.coordinator.preemption_wave()
    json.dumps({"dumped": report.dumped, "failed": report.failed,
                "lost": report.lost, "replaced": report.replaced})


# ------------------------------------------------------------ placement
def test_restore_placement_prefers_warm_peer():
    cl = SimCluster(hosts=4, seed=4, device=DEV)
    cl.submit_jobs(4, steps=3)
    cl.coordinator.preemption_wave()
    reg = cl.coordinator.registry
    rec = reg.get("j0")
    warm_host = rec.host

    decision = cl.coordinator.planner.plan(rec)
    assert decision.host == warm_host          # dump host has every chunk
    assert decision.overlap == 1.0
    ack = cl.coordinator.restore_job("j0")
    assert ack.host == warm_host
    assert ack.cache_hot_hits > 0 and ack.cache_cold_reads == 0
    assert ack.state_digest == rec.state_digest


def test_restore_placement_falls_back_to_cold_host():
    cl = SimCluster(hosts=3, seed=5, device=DEV)
    cl.submit_jobs(3, steps=3)
    cl.coordinator.preemption_wave()
    reg = cl.coordinator.registry
    rec = reg.get("j0")
    warm_host = rec.host
    digest = rec.state_digest
    cl.fail_host(warm_host)                    # the only warm peer dies

    ack = cl.coordinator.restore_job("j0")
    assert ack.host != warm_host
    assert ack.cache_cold_reads > 0            # pulled from the remote
    assert ack.state_digest == digest
    assert cl.job_digest("j0") == digest


def test_retarget_root_rewrites_front_only():
    cfg = {"root": "cache+remote://ck?front=h0&prefix=j1&agg_mbps=10",
           "kind": "SessionConfig"}
    out = retarget_root(cfg, "h7")
    assert "front=h7" in out["root"] and "front=h0" not in out["root"]
    assert "prefix=j1" in out["root"] and "agg_mbps=10" in out["root"]
    assert cfg["root"].count("front=") == 1    # input untouched


def test_topology_inventory_reads_live_tier_registrations():
    cl = SimCluster(hosts=2, seed=6, device=DEV)
    cl.submit_jobs(2, steps=2)
    cl.coordinator.preemption_wave()
    rec = cl.coordinator.registry.get("j0")
    inv = cl.topology.hot_inventory(rec.host)
    chunks = cl.coordinator.planner.image_chunks(rec)
    assert chunks and chunks <= inv
    fronts = [u for u in registered_tiers()
              if u.startswith("cache+remote://") and f"front={rec.host}" in u]
    assert fronts


# ------------------------------------------------------------- failures
def test_node_death_mid_wave_replaces_from_last_committed_image():
    cl = SimCluster(hosts=4, seed=7, device=DEV)
    cl.submit_jobs(8, steps=3)
    first = cl.coordinator.preemption_wave()
    assert len(first.dumped) == 8
    digests = {j: cl.coordinator.registry.get(j).state_digest
               for j in cl.jobs}
    for j in cl.jobs:
        cl.coordinator.restore_job(j)
    cl.tick(1.0, steps=0)                      # no steps: states unchanged

    # the 2nd MigrateRequest frame of the wave kills its target host
    cl.arm_failure(kind="MigrateRequest", nth=2)
    report = cl.coordinator.preemption_wave()
    assert cl.coordinator.stats["hosts_failed"] == 1
    assert report.lost and report.replaced
    alive = {h.host_id for h in cl.topology.hosts()}
    reg = cl.coordinator.registry
    for job_id, new_host in report.replaced.items():
        rec = reg.get(job_id)
        assert new_host in alive and rec.host == new_host
        assert rec.phase == "running"
        assert rec.image_id is not None
        assert cl.job_digest(job_id) in (digests[job_id],
                                         rec.state_digest)
    survivors = set(cl.jobs) - set(report.lost)
    assert survivors <= set(report.dumped)


def test_heartbeat_timeout_replaces_once_slow_job_untouched():
    cl = SimCluster(hosts=3, seed=8, heartbeat_timeout_s=10.0, device=DEV)
    cl.submit_jobs(3, steps=2)
    cl.coordinator.preemption_wave()
    for j in cl.jobs:
        cl.coordinator.restore_job(j)
    reg = cl.coordinator.registry
    j1_host = reg.get("j1").host

    for i in range(12):
        mute = ("j0",) if i == 4 else ("j0", "j1")
        cl.tick(1.0, steps=0, mute=mute)
    assert not reg.alive("j0") and reg.alive("j1")

    moved = cl.coordinator.check_heartbeats()
    assert set(moved) == {"j0"}
    assert reg.get("j1").host == j1_host       # never touched
    inc = reg.get("j0").incarnation
    assert cl.coordinator.check_heartbeats() == {}
    assert reg.get("j0").incarnation == inc    # no double restore


def test_restore_claim_is_single_winner():
    cl = SimCluster(hosts=2, seed=9, device=DEV)
    cl.submit_jobs(1, steps=2)
    cl.coordinator.preemption_wave()
    reg = cl.coordinator.registry
    assert reg.claim_restore("j0") is True
    assert reg.claim_restore("j0") is False
    assert cl.coordinator.restore_job("j0") is None


def test_fleet_policy_gates_replacement_of_lost_jobs():
    from repro_torch.training.fault_tolerance import (FleetPolicy,
                                                      RestartPolicy,
                                                      StragglerMonitor)
    policy = FleetPolicy(monitor=StragglerMonitor(num_hosts=3),
                         restart=RestartPolicy(max_retries=0))
    cl = SimCluster(hosts=3, seed=11, policy=policy, device=DEV)
    cl.submit_jobs(3, steps=2)
    cl.coordinator.preemption_wave()
    assert cl.coordinator.restore_job("j0") is not None
    reg = cl.coordinator.registry
    cl.fail_host(reg.get("j1").host)
    assert cl.coordinator.restore_job("j1") is None
    assert reg.get("j1").phase == "dead"


def test_wave_abort_on_transfer_error_leaves_jobs_dumped_or_untouched():
    cl = SimCluster(
        hosts=3, seed=10, leaf_kb=8, leaves=2, device=DEV,
        extra_uri_params="fail_rate=0.10&max_consecutive=6&attempts=2"
        "&seed=13&backoff_ms=0&backoff_max_ms=0")
    cl.submit_jobs(8, steps=3)
    first = cl.coordinator.preemption_wave(abort_on_error=True)
    reg = cl.coordinator.registry
    if not first.failed:
        pytest.skip("fault schedule injected no exhausting failure")
    assert first.aborted
    for job_id in cl.jobs:
        rec = reg.get(job_id)
        tier = cl.clients[job_id].session.tier
        try:
            images = set(tier.listdir("images"))
        except FileNotFoundError:
            images = set()
        if job_id in first.dumped:
            assert rec.image_id in images
            assert rec.state_digest == cl.job_digest(job_id)
        else:
            assert job_id in first.failed or job_id in first.skipped
            assert rec.image_id is None and images == set()
            assert rec.phase in ("running", "drained")


class PortFlakyTier(FlakyTier, Tier):
    """tests/faultinject.py's FlakyTier as an instance of the port's Tier,
    so the port's sessions take it."""


def test_flaky_tier_reset_replays_seeded_schedule():
    sched = FaultSchedule(seed=3, error_rate=1.0, error_budget=2)
    tier = PortFlakyTier(MemoryTier(), sched)
    for _ in range(3):
        try:
            tier.write_bytes("chunks/aa.bin", b"x")
            break
        except (TimeoutError, IOError):
            pass

    def pattern():
        out = []
        for _ in range(4):
            try:
                tier.read_bytes("chunks/aa.bin")
                out.append("ok")
            except (TimeoutError, IOError) as e:
                out.append(type(e).__name__)
        return out

    first = pattern()
    assert "ok" in first and first != ["ok"] * 4
    read_errors = sum(1 for x in first if x != "ok")
    before = tier.stats["errors_injected"]
    tier.reset()
    assert pattern() == first
    assert tier.stats["errors_injected"] == before + read_errors


# ----------------------------------------------------------- acceptance
def test_acceptance_20_jobs_full_wave_2_seeded_failures():
    cl = SimCluster(hosts=5, devices_per_host=8, seed=42,
                    dump_concurrency=4, leaf_kb=16, leaves=3, device=DEV)
    cl.submit_jobs(20, steps=4, arrival_rate=2.0)
    cl.tick(1.0)
    base = cl.coordinator.preemption_wave()
    assert len(base.dumped) == 20 and base.complete
    for j in cl.jobs:
        assert cl.coordinator.restore_job(j) is not None
    cl.tick(1.0, steps=2)

    picks = cl.seeded_failures(2, kind="MigrateRequest", span=20)
    assert len(picks) == 2
    report = cl.coordinator.preemption_wave()
    assert cl.coordinator.stats["hosts_failed"] == 2
    assert len([h for h in cl.topology.hosts()]) == 3

    reg = cl.coordinator.registry
    alive = {h.host_id for h in cl.topology.hosts()}
    for job_id, new_host in report.replaced.items():
        assert new_host in alive
        assert reg.get(job_id).phase == "running"
    for job_id in cl.jobs:
        rec = reg.get(job_id)
        assert rec.phase in ("dumped", "running"), (job_id, rec.phase)
        assert rec.image_id is not None

    for job_id in sorted(cl.jobs):
        rec = reg.get(job_id)
        if rec.phase != "dumped":
            continue
        decision = cl.coordinator.planner.plan(rec)
        ack = cl.coordinator.restore_job(job_id)
        assert ack is not None
        assert ack.host == decision.host
        assert ack.host in alive
        assert ack.digest_verified is not False
        assert ack.state_digest == rec.state_digest
        assert cl.job_digest(job_id) == rec.state_digest
    for job_id in cl.jobs:
        assert reg.get(job_id).phase == "running"

    frames = wire_frames_on_transports(cl)
    heartbeats = cl.coordinator.stats["heartbeats"]
    assert cl.coordinator.stats["wire_frames"] == frames + heartbeats
    assert cl.coordinator.stats["dumps"] >= 20
    assert cl.coordinator.stats["restores"] >= 20


# ------------------------------------------------- (a) package parity
class _InlineThread:
    """A coordinator's per-job thread run to its end at start(): the
    frames of a batch then cross in job order, in both packages alike."""

    def __init__(self, target=None, args=(), kwargs=None, daemon=None):
        self._run = lambda: target(*args, **(kwargs or {}))

    def start(self):
        self._run()

    def join(self, timeout=None):
        pass


def _acceptance_run(fleet, **kw):
    """tests/test_fleet.py's acceptance scenario through ``fleet`` ->
    (cluster, [wave reports], frame kinds in order, restore acks)."""
    cl = fleet.SimCluster(hosts=5, devices_per_host=8, seed=42,
                          dump_concurrency=4, leaf_kb=16, leaves=3,
                          store="parity-acceptance", **kw)
    kinds = []
    on_frame, deliver = cl._on_frame, cl.coordinator.deliver

    def frame_out(host, frame):
        kinds.append(frame["kind"])
        on_frame(host, frame)

    def frame_in(frame):
        kinds.append(frame["kind"])
        deliver(frame)

    cl._on_frame, cl.coordinator.deliver = frame_out, frame_in
    cl.submit_jobs(20, steps=4, arrival_rate=2.0)
    cl.tick(1.0)
    reports = [cl.coordinator.preemption_wave()]
    acks = [cl.coordinator.restore_job(j) for j in cl.jobs]
    cl.tick(1.0, steps=2)
    cl.seeded_failures(2, kind="MigrateRequest", span=20)
    reports.append(cl.coordinator.preemption_wave())
    reg = cl.coordinator.registry
    acks += [cl.coordinator.restore_job(j) for j in sorted(cl.jobs)
             if reg.get(j).phase == "dumped"]
    return cl, reports, kinds, acks


def _store_contents(store) -> dict:
    out = {}
    for key in sorted(store._objects):       # every object, at every depth
        data = bytes(store.get(key))
        if key.endswith("manifest.json"):
            man = json.loads(data)
            out[key] = {k: v for k, v in man.items() if k not in SKIP}
        else:
            out[key] = data
    return out


def test_acceptance_scenario_equal_in_both_packages(monkeypatch):
    inline = types.SimpleNamespace(Thread=_InlineThread, Lock=threading.Lock)
    monkeypatch.setattr(jcoord, "threading", inline)
    monkeypatch.setattr(tcoord, "threading", inline)
    jcl, jreports, jkinds, jacks = _acceptance_run(jfleet)
    tcl, treports, tkinds, tacks = _acceptance_run(tfleet, device=DEV)

    def plain(report):
        return {k: v for k, v in dataclasses.asdict(report).items()
                if k != "wall_s"}

    assert [plain(r) for r in treports] == [plain(r) for r in jreports]
    assert treports[1].lost and treports[1].replaced
    assert tcl.coordinator.stats["hosts_failed"] == 2
    assert tcl.coordinator.registry.to_wire() == \
        jcl.coordinator.registry.to_wire()
    assert tkinds == jkinds and "MigrateRequest" in tkinds
    assert tcl.coordinator.stats == jcl.coordinator.stats
    tstore = _store_contents(tremote.get_store("parity-acceptance"))
    jstore = _store_contents(jremote.get_store("parity-acceptance"))
    assert sorted(tstore) == sorted(jstore)
    assert any("/chunks/" in k for k in tstore)
    for key, want in jstore.items():
        assert tstore[key] == want, key
    assert [a.state_digest for a in tacks] == \
        [a.state_digest for a in jacks]
    for j in tcl.jobs:
        assert tcl.job_digest(j) == jcl.job_digest(j) == \
            tcl.coordinator.registry.get(j).state_digest


# ------------------------------------------------- (b) a mixed fleet
def test_port_coordinator_replaces_a_jax_job_onto_a_torch_incarnation(
        tmp_path):
    from repro.api.config import SessionConfig as JConfig
    from repro.core.dump import flatten_with_paths as jflatten
    from repro.core.integrity import tree_digest as jdigest
    from repro_torch.api import SessionConfig
    from repro_torch.core.dump import flatten_with_paths
    from repro_torch.core.integrity import tree_digest
    from repro_torch.fleet import (ClusterTopology, FleetClient,
                                   FleetCoordinator, LoopbackTransport)

    roots = {j: f"file://{tmp_path / j}" for j in ("jx", "tx")}
    topo = ClusterTopology()
    for h in ("h0", "h1"):
        topo.add_host(h)

    def client(pkg, job, cfg, host, **kw):
        def drain():
            job.paused = True
            return job.step
        return pkg.FleetClient(
            job.job_id, cfg, host=host, on_drain=drain,
            state_provider=lambda: (job.state(), job.step),
            on_restore=lambda res: job.adopt(res.state, res.step), **kw)

    jjob = jfleet.SimJob("jx", seed=5, leaves=2, leaf_kb=8)
    jjob.run(3)
    tjob = tfleet.SimJob("tx", seed=6, leaves=2, leaf_kb=8, device=DEV)
    tjob.run(2)
    jcfg = JConfig(root=roots["jx"], serial=True).to_wire()
    tcfg = SessionConfig(root=roots["tx"], serial=True).to_wire()
    spawned = {}

    def spawner(rec, host, config_wire):
        # a file:// root is one directory every host reaches: the
        # placement's front= pin does not apply to it
        cfg = dict(config_wire, root=roots[rec.job_id])
        job = tfleet.SimJob(rec.job_id, seed=5, leaves=2, leaf_kb=8,
                            device=DEV)
        spawned[rec.job_id] = job
        return LoopbackTransport(client(tfleet, job, cfg, host, device=DEV),
                                 host=host)

    coord = FleetCoordinator(topology=topo, spawner=spawner)
    jt = LoopbackTransport(client(jfleet, jjob, jcfg, "h0"), host="h0")
    tt = LoopbackTransport(client(tfleet, tjob, tcfg, "h1", device=DEV),
                           host="h1")
    assert isinstance(jt.client, jfleet.FleetClient)
    assert isinstance(tt.client, FleetClient)
    coord.attach("jx", jt, host="h0", config_wire=jcfg)
    coord.attach("tx", tt, host="h1", config_wire=tcfg)
    report = coord.preemption_wave()
    assert report.complete and set(report.dumped) == {"jx", "tx"}
    rec = coord.registry.get("jx")
    assert rec.state_digest == jdigest(jflatten(jjob.state()))
    assert coord.registry.get("tx").state_digest == \
        tree_digest(flatten_with_paths(tjob.state()))

    assert coord.host_failed("h0") == {"jx": "h1"}
    job = spawned["jx"]
    assert job.step == 3
    assert tree_digest(flatten_with_paths(job.state())) == rec.state_digest
    for k, w in jjob.params.items():
        assert np.array_equal(job.params[k].numpy(), w)
    assert coord.registry.get("jx").phase == "running"
    assert coord.stats["wire_frames"] == sum(
        t.frames_received for t in (jt, tt, coord.transports["jx"]))


# ------------------------------------------- (c) the registry journal
def test_jax_registry_journal_round_trips_through_port_registry():
    from repro.api.config import SessionConfig as JConfig
    from repro.fleet import JobRegistry as JRegistry
    from repro_torch.api import SessionConfig
    from repro_torch.fleet import JobRegistry

    assert SessionConfig(root="mem://x").to_wire() == \
        JConfig(root="mem://x").to_wire()
    jreg = JRegistry(clock=lambda: 5.0, heartbeat_timeout_s=12.0)
    jreg.register("j0", JConfig(root="mem://a").to_wire(), host="h0")
    jreg.register("j1", JConfig(root="mem://b").to_wire(), host="h1",
                  kind="serve", topology={"host_count": 1})
    jreg.heartbeat("j0", 7)
    jreg.record_dump("j1", image_id="step_0000000003", step=3,
                     state_digest="ab" * 32)
    assert jreg.claim_restore("j1")
    journal = json.loads(json.dumps(jreg.to_wire()))

    reg = JobRegistry.from_wire(journal, clock=lambda: 9.0)
    out = reg.to_wire()
    assert out == {**journal, "jobs": [{**j, "last_heartbeat": 9.0}
                                       for j in journal["jobs"]]}
    assert reg.claim_restore("j1") is False    # the claim survived
    assert reg.get("j1").kind == "serve" and reg.get("j0").step == 7
    back = JRegistry.from_wire(json.loads(json.dumps(out)),
                               clock=lambda: 9.0)
    assert back.to_wire() == out


# ----------------------------------- lossy trainers, concurrent dumps
class _LossyJob:
    """A trainer-shaped job: params and two moments, all fp32 leaves of
    64 KiB or more, so the device codec stage takes the moments."""

    def __init__(self, job_id, seed):
        self.job_id = job_id
        rng = np.random.default_rng(seed)
        n = 1 << 15
        self.tree = {k: torch.from_numpy(
            rng.standard_normal(n).astype(np.float32))
            for k in ("params/w", "opt/m/w", "opt/v/w")}
        self.step = 0
        self.paused = False

    def state(self):
        return {"params": {"w": self.tree["params/w"]},
                "opt": {"m": {"w": self.tree["opt/m/w"]},
                        "v": {"w": self.tree["opt/v/w"]}},
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def run(self, steps=1):
        for _ in range(steps):
            for t in self.tree.values():
                t.mul_(1.0 + 1e-3)
            self.step += 1

    def adopt(self, state, step):
        self.tree = {"params/w": state["params"]["w"],
                     "opt/m/w": state["opt"]["m"]["w"],
                     "opt/v/w": state["opt"]["v"]["w"]}
        self.step = int(step)
        self.paused = False


def test_concurrent_lossy_dumps_encode_against_the_restored_image():
    """Four lossy trainers dump in ONE batch (four threads, the shared
    executor, the device codec stage forced on), are restored, step, and
    dump again: every incarnation took its restored tree as its delta8
    baseline, so the second wave's moments are device-encoded delta8
    leaves whose parent is the first wave's image; restores decode them
    within each block's scale/2 and params come back bit for bit."""
    from repro_torch.api import CodecPolicy, SessionConfig
    from repro_torch.fleet import (FleetClient, FleetCoordinator,
                                   LoopbackTransport)
    from repro_torch.kernels.ckpt_codec import ops, ref

    jobs = {f"t{i}": _LossyJob(f"t{i}", i) for i in range(4)}
    codec = CodecPolicy(optimizer="delta8", device="on")

    def transport(job, host):
        cfg = SessionConfig(root=f"mem://lossy-{job.job_id}", codec=codec)

        def drain():
            job.paused = True
            return job.step
        return LoopbackTransport(FleetClient(
            job.job_id, cfg.to_wire(), host=host, on_drain=drain,
            state_provider=lambda: (job.state(), job.step),
            on_restore=lambda res: job.adopt(res.state, res.step),
            device=DEV), host=host)

    coord = FleetCoordinator(
        dump_concurrency=4,
        spawner=lambda rec, host, cfg: transport(jobs[rec.job_id], host))
    for jid, job in jobs.items():
        job.run(2)
        coord.attach(jid, transport(job, "h0"), host="h0",
                     config_wire=SessionConfig(
                         root=f"mem://lossy-{jid}", codec=codec).to_wire())
    first = coord.preemption_wave()
    assert first.complete and first.batches == 1
    for jid in jobs:
        coord.restore_job(jid, host="h0")
    base = {jid: {p: t.clone() for p, t in job.tree.items()}
            for jid, job in jobs.items()}
    for job in jobs.values():
        job.run(1)
    live = {jid: {p: t.clone() for p, t in job.tree.items()}
            for jid, job in jobs.items()}
    second = coord.preemption_wave()
    assert second.complete and second.batches == 1
    for jid, job in jobs.items():
        session = coord.transports[jid].client.session
        man = json.loads(bytes(session.tier.read_bytes(
            f"images/{second.dumped[jid]}/manifest.json")))
        assert man["parent"] == first.dumped[jid]
        meta = {r["path"]: r["codec_meta"] for r in man["leaves"]}
        for p in ("opt/m/w", "opt/v/w"):
            assert meta[p]["applied"] and meta[p]["encoder"] == "device"
        assert "encoder" not in meta["params/w"]
        coord.restore_job(jid, host="h0")
        assert torch.equal(job.tree["params/w"], live[jid]["params/w"])
        for p in ("opt/m/w", "opt/v/w"):
            xb, _ = ops._blocked(live[jid][p], ops.BLOCK)
            pb, _ = ops._blocked(base[jid][p], ops.BLOCK)
            _, scale, _ = ref.delta_encode_ref(xb, pb)
            half = torch.repeat_interleave(scale / 2, ops.BLOCK)
            err = (job.tree[p] - live[jid][p]).abs()
            assert bool((err <= half[:err.numel()] * (1 + 2 ** -12)
                         + 1e-7).all()), p
