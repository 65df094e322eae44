"""Fleet preemption wave over REAL worker subprocesses on a UDS, through
the PyTorch port (repro_torch).

The multi-process proof of the port's socket transport: a coordinator
listens on a Unix-domain socket, N worker subprocesses each own a seeded
SimJob (its leaves on ``--device``) and a CheckpointSession and dial in
as WorkerAgents, and a full preemption wave (drain -> staggered dumps ->
restores) runs entirely over framed wire — every digest ack checked
bit-identical against the digest recorded at dump time. The frames are
the JAX package's, byte for byte: a worker of examples/fleet_multiprocess.py
can dial this coordinator, and the reverse.

Roles (one script, three entry points):

  (default / --smoke)   parent: serve, spawn workers, run the wave,
                        restore every job, verify, exit 0
  --worker              child: one job's endpoint (spawned by the
                        parent; also usable by hand against --serve)
  --serve               coordinator only (journaled registry), used to
                        SIGKILL/restart a coordinator under live
                        external workers; --die-after-dumps N
                        self-SIGKILLs after the Nth committed dump
                        record — mid-wave, by construction

Every worker is a fresh interpreter (subprocess.Popen), never a fork: a
process that has touched CUDA cannot be forked. ``--device`` is where the
workers' jobs and sessions live: "cuda" by default (a worker raises
without a card), "cpu" when asked. The coordinator touches no device.

Run:  PYTHONPATH=src python examples/fleet_multiprocess_torch.py --smoke
      (add --device cpu on a machine without a card)
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "src")))

ENV = dict(os.environ)
ENV["PYTHONPATH"] = sys.path[0]
ENV["PYTHONUNBUFFERED"] = "1"


def job_config(root: str, job_id: str):
    from repro_torch.api.config import MigrationPolicy, SessionConfig
    return SessionConfig(root=f"file://{root}/{job_id}", serial=True,
                         migration=MigrationPolicy(arch="simjob"))


def hard_timeout(seconds: float, what: str):
    """A watchdog that cannot be argued with: past the deadline the
    process exits 2 no matter which thread is stuck where."""
    def boom():
        print(f"!! hard timeout after {seconds:.0f}s in {what}",
              flush=True)
        os._exit(2)
    t = threading.Timer(seconds, boom)
    t.daemon = True
    t.start()
    return t


def worker_cmd(args, job_id: str, seed: int, sock: str, root: str) -> list:
    """The command line of one worker subprocess."""
    return [sys.executable, os.path.abspath(__file__), "--worker",
            "--job", job_id, "--seed", str(seed), "--steps", str(args.steps),
            "--leaves", str(args.leaves), "--leaf-kb", str(args.leaf_kb),
            "--device", args.device, "--socket", sock, "--root", root,
            "--timeout", str(args.timeout)]


# ------------------------------------------------------------------ worker
def run_worker(args) -> int:
    from repro_torch.fleet import FleetClient, HandshakeError, \
        ReconnectPolicy
    from repro_torch.fleet.simcluster import SimJob

    job = SimJob(args.job, seed=args.seed, leaves=args.leaves,
                 leaf_kb=args.leaf_kb, device=args.device)
    job.run(args.steps)

    def drain():
        job.paused = True
        return job.step

    client = FleetClient(
        args.job, job_config(args.root, args.job).to_wire(),
        host=f"worker-{os.getpid()}",
        state_provider=lambda: (job.state(), job.step),
        on_drain=drain,
        on_restore=lambda res: job.adopt(res.state, res.step),
        device=args.device)
    try:
        agent = client.connect(
            args.socket, incarnation=args.incarnation,
            heartbeat_every_s=0.2,
            reconnect=ReconnectPolicy(attempts=240, backoff_s=0.05,
                                      backoff_max_s=0.25))
    except HandshakeError as e:
        print(f"worker {args.job}: refused: {e}", flush=True)
        return 1
    print(f"worker {args.job}: serving (pid {os.getpid()}, "
          f"seed {args.seed}, step {job.step}, {args.leaves} leaves of "
          f"{args.leaf_kb} KiB on {job.device})", flush=True)
    # serve until the coordinator says bye (or the reconnect budget
    # runs out against a coordinator that is not coming back)
    while agent.alive():
        time.sleep(0.1)
    code = 1 if agent.failed.is_set() else 0
    on = sorted({str(t.device) for t in job.params.values()})
    print(f"worker {args.job}: done (commands={agent.stats['commands']}, "
          f"reconnects={agent.stats['reconnects']}, "
          f"dedup_hits={agent.stats['dedup_hits']}, leaves on {on}, "
          f"exit {code})", flush=True)
    client.close()
    return code


# ------------------------------------------------------- coordinator only
def run_serve(args) -> int:
    from repro_torch.fleet import coordinator_serve

    server = coordinator_serve(
        args.socket, registry_tier=args.journal,
        heartbeat_timeout_s=args.heartbeat_timeout,
        dump_concurrency=1, resume_timeout_s=args.resume_timeout)
    listen_at = time.time()
    jobs = [j for j in args.jobs.split(",") if j]
    for job_id in jobs:
        server.attach(job_id, job_config(args.root, job_id).to_wire())

    if args.die_after_dumps:
        base = server.registry.on_change

        def journal_then_maybe_die():
            # the dump record is durable FIRST; counted in the snapshot
            # written, not the live table, which a dump on another thread
            # may have moved on since
            snap = base()
            dumped = sum(1 for r in snap["jobs"] if r["phase"] == "dumped")
            if dumped >= args.die_after_dumps:
                print(f"serve: SIGKILL self after {dumped} dumps",
                      flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
        server.registry.on_change = journal_then_maybe_die

    if not server.wait_connected(jobs, timeout=args.connect_timeout):
        print("serve: workers never connected", flush=True)
        return 1
    connected_at = time.time()
    print(f"serve: {len(jobs)} workers connected (epoch "
          f"{server.epoch}) {connected_at - listen_at:.3f} s after "
          f"listening", flush=True)
    report = server.coordinator.preemption_wave(replace_lost=False)
    out = {"dumped": report.dumped, "failed": report.failed,
           "digests": {r.job_id: r.state_digest
                       for r in server.registry.jobs()},
           "phases": {r.job_id: r.phase
                      for r in server.registry.jobs()},
           "epoch": server.epoch, "listen_at": listen_at,
           "connected_at": connected_at,
           "wave_s": time.time() - connected_at,
           "frames": server.coordinator.stats["wire_frames"],
           "server": dict(server.stats)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"serve: wave dumped {len(report.dumped)}/{len(jobs)}",
          flush=True)
    server.close()
    return 0 if report.complete else 1


# ------------------------------------------------------------------ parent
def run_demo(args) -> int:
    from repro_torch.fleet import coordinator_serve

    root = args.root or tempfile.mkdtemp(prefix="repro-torch-fleetdemo-")
    sock = args.socket or f"unix://{root}/coord.sock"
    journal = args.journal or f"file://{root}/journal"
    jobs = [f"j{i}" for i in range(args.workers)]

    server = coordinator_serve(sock, registry_tier=journal,
                               resume_timeout_s=args.resume_timeout,
                               dump_concurrency=2)
    procs = []
    try:
        for i, job_id in enumerate(jobs):
            server.attach(job_id, job_config(root, job_id).to_wire())
            procs.append(subprocess.Popen(
                worker_cmd(args, job_id, args.seed + i, sock, root),
                env=ENV))
        if not server.wait_connected(jobs, timeout=args.connect_timeout):
            raise RuntimeError("workers never connected")
        print(f">>> {len(jobs)} worker subprocesses connected over "
              f"{sock} (jobs on {args.device})", flush=True)

        report = server.coordinator.preemption_wave(replace_lost=False)
        assert report.complete and len(report.dumped) == len(jobs), report
        digests = {j: server.registry.get(j).state_digest for j in jobs}
        assert all(digests.values()), digests
        print(f">>> wave complete: {len(report.dumped)} dumps in "
              f"{report.batches} staggered batches", flush=True)

        for job_id in jobs:
            ack = server.coordinator.restore_job(job_id)
            assert ack is not None, f"{job_id}: restore claim lost"
            assert ack.state_digest == digests[job_id], (
                f"{job_id}: restore NOT bit-identical: "
                f"{ack.state_digest[:12]} != {digests[job_id][:12]}")
            print(f">>> {job_id}: restored at step {ack.step}, digest "
                  f"{ack.state_digest[:12]} == recorded (bit-identical)",
                  flush=True)

        # beacons keep crossing the live wire (0.2 s apart per worker)
        hb0 = server.coordinator.stats["heartbeats"]
        deadline = time.monotonic() + 10.0
        while server.coordinator.stats["heartbeats"] <= hb0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.coordinator.stats["heartbeats"] > hb0
    finally:
        server.close(bye=True)          # workers exit on the bye
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=30))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait(timeout=30))
    assert codes == [0] * len(jobs), f"worker exit codes: {codes}"
    print(f"fleet_multiprocess_torch OK: {len(jobs)} workers on "
          f"{args.device}, {len(jobs)} bit-identical restores, worker "
          f"exits {codes}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (identical path, small jobs)")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the workers' jobs live (default cuda; "
                         "raises without a card)")
    ap.add_argument("--job", default="j0")
    ap.add_argument("--jobs", default="j0,j1,j2",
                    help="--serve: comma-separated job ids to attach")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--leaves", type=int, default=2)
    ap.add_argument("--leaf-kb", type=int, default=4)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--incarnation", type=int, default=0)
    ap.add_argument("--socket", default="")
    ap.add_argument("--root", default="")
    ap.add_argument("--journal", default="")
    ap.add_argument("--out", default="",
                    help="--serve: write the wave summary JSON here")
    ap.add_argument("--die-after-dumps", type=int, default=0)
    ap.add_argument("--resume-timeout", type=float, default=10.0)
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    ap.add_argument("--connect-timeout", type=float, default=60.0)
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="hard watchdog; the process exits 2 past it")
    args = ap.parse_args(argv)

    if args.worker:
        hard_timeout(args.timeout, f"worker {args.job}")
        return run_worker(args)
    if args.serve:
        hard_timeout(args.timeout, "serve")
        return run_serve(args)
    hard_timeout(args.timeout, "demo")
    return run_demo(args)


if __name__ == "__main__":
    sys.exit(main())
