#!/usr/bin/env python3
"""Run the port's coordinator-restart chaos case in a loop and say, for
every run, what the workers and the restarted coordinator did.

    PYTHONPATH=src python scripts/torch_chaos_restart_loop.py [--seconds 600]

Each run is ``tests/test_torch_transport_chaos.py``'s
``test_coordinator_restart_readopts_and_cas_holds`` in a fresh temporary
directory. One line a run: ok or the failure; the seconds from the kill
to the restarted coordinator's return; each agent's dials after the kill
(count, last outcome); each agent's ``failed``/``connected`` events and
connects; the restarted coordinator's accept, HELLO and refusal counts.
The last line counts the runs and the failures. Run it beside a load (the
port's tests with ``-n 6``) to find what a loaded host does to the case.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=600.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import test_torch_transport_chaos as case
    from repro_torch.fleet import transport

    dials, marks, servers, agents = [], {}, [], []
    real_connect = transport._connect_once

    def connect(url, timeout):
        name = threading.current_thread().name
        try:
            sock = real_connect(url, timeout)
        except OSError as e:
            dials.append((time.monotonic(), name, type(e).__name__))
            raise
        dials.append((time.monotonic(), name, "ok"))
        return sock
    transport._connect_once = connect
    real_serve = case.coordinator_serve

    def serve(*a, **kw):
        server = real_serve(*a, **kw)
        marks["served"] = time.monotonic()
        servers.append(server)
        return server
    case.coordinator_serve = serve
    real_kill = transport.CoordinatorServer.kill

    def kill(self):
        marks["kill"] = time.monotonic()
        return real_kill(self)
    transport.CoordinatorServer.kill = kill

    class Agent(case.WorkerAgent):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            agents.append(self)
    case.WorkerAgent = Agent

    runs = fails = 0
    end = time.monotonic() + args.seconds
    while time.monotonic() < end:
        for seen in (dials, marks, servers, agents):
            seen.clear()
        with tempfile.TemporaryDirectory() as d:
            try:
                case.test_coordinator_restart_readopts_and_cas_holds(
                    pathlib.Path(d))
                what = "ok"
            except AssertionError as e:
                fails += 1
                what = f"FAIL {e!r}"[:120]
        k = marks.get("kill", 0.0)
        after = {}
        for t, name, res in dials:
            if t > k:
                after.setdefault(name.rsplit("-", 1)[-1], []).append(res)
        state = [(a.failed.is_set(), a.connected.is_set(),
                  a.stats["connects"]) for a in agents]
        used = {j: (len(v), v[-1]) for j, v in after.items()}
        print(f"{runs} {what} restart {marks.get('served', k) - k:.3f} s "
              f"dials {used} agents (failed, connected, connects) {state} "
              f"coordinator {servers[-1].stats if len(servers) > 1 else None}",
              flush=True)
        runs += 1
    print(f"runs {runs} fails {fails}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
