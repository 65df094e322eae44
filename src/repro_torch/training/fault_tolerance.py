"""Fleet-health policies for 1000+-node runs: straggler detection and
restart/backoff. Pure-python policy objects (unit-tested with synthetic
timings); the launcher consumes their advice. A copy of the JAX package's
training/fault_tolerance.py, which imports no framework.

Straggler mitigation at scale: a persistently slow host delays every
synchronous step (the collective waits for the last arrival). The monitor
tracks per-host step-time EWMAs and flags hosts whose EWMA exceeds
``threshold`` x the fleet median; the advised actions are (1) proactive
checkpoint (cheap, async), then (2) drop/replace the host and elastically
restore — an *executable* path: core.migration.MigrationOrchestrator
.observe_step() feeds this monitor and escalates checkpoint_and_replace
advice into a preemption request whose migration record pre-plans the
suggested_host_count fleet, so the default restart already runs without
the slow hosts (same global batch, remapped cursors).

Launchers consume all of this through the service façade: configure the
monitor via repro_torch.api.MigrationPolicy(monitor=...), drive it with
CheckpointSession.observe_step (or FleetPolicy.on_step), and translate
exit codes with FleetPolicy.on_exit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    num_hosts: int
    alpha: float = 0.2            # EWMA smoothing
    threshold: float = 1.5        # x fleet median
    warmup_steps: int = 5
    ewma: list = field(default_factory=list)
    steps: int = 0

    def __post_init__(self):
        if not self.ewma:
            self.ewma = [float("nan")] * self.num_hosts

    def observe(self, host_times: list[float]):
        assert len(host_times) == self.num_hosts
        for i, t in enumerate(host_times):
            e = self.ewma[i]
            self.ewma[i] = t if math.isnan(e) else \
                (1 - self.alpha) * e + self.alpha * t
        self.steps += 1

    def _median(self) -> float:
        s = sorted(self.ewma)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def stragglers(self) -> list[int]:
        if self.steps < self.warmup_steps:
            return []
        med = self._median()
        return [i for i, e in enumerate(self.ewma) if e > self.threshold * med]

    def advice(self) -> dict:
        s = self.stragglers()
        if not s:
            return {"action": "none", "hosts": []}
        # escalate: first a proactive checkpoint, then drop persistently slow
        return {"action": "checkpoint_and_replace", "hosts": s,
                "suggested_host_count": max(1, self.num_hosts - len(s)),
                "expected_step_gain": max(0.0, max(self.ewma[i] for i in s)
                                          - self._median())}


@dataclass
class FleetPolicy:
    """Bundle of fleet-health policies wired to the service façade: a
    launcher hands the monitor to SessionConfig (via
    MigrationPolicy(monitor=...)), calls ``on_step`` at every boundary, and
    consults ``on_exit`` between incarnations.

    on_step feeds timings through CheckpointSession.observe_step (straggler
    advice escalates into a preemption request whose migration record
    pre-plans the shrunken fleet); on_exit maps a process exit code to the
    scheduler action — a MigrationTicket exit (85) always reschedules
    immediately, a crash consults the RestartPolicy backoff."""
    monitor: "StragglerMonitor"
    restart: "RestartPolicy"
    checkpointed_exit_code: int = 85   # EXIT_CHECKPOINTED / PreemptionPolicy

    def on_step(self, session, host_times: list[float]) -> dict:
        return session.observe_step(host_times)

    def on_exit(self, exit_code: int, *, step: int) -> dict:
        if exit_code == 0:
            return {"action": "done"}
        if exit_code == self.checkpointed_exit_code:
            # the job checkpointed itself (preemption/straggler/migration):
            # not a failure — reschedule anywhere, no backoff
            return {"action": "restart", "backoff_s": 0.0,
                    "reason": "checkpointed"}
        return self.restart.on_failure(step)


@dataclass
class RestartPolicy:
    """Bounded-retry with exponential backoff; resets after stable progress."""
    max_retries: int = 5
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0
    stable_steps: int = 100
    failures: int = 0
    last_failure_step: int = -1

    def on_failure(self, step: int) -> dict:
        if (self.last_failure_step >= 0
                and step - self.last_failure_step >= self.stable_steps):
            self.failures = 0  # made real progress since last crash
        self.failures += 1
        self.last_failure_step = step
        if self.failures > self.max_retries:
            return {"action": "abort",
                    "reason": f"{self.failures} failures without "
                              f"{self.stable_steps} stable steps"}
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * 2 ** (self.failures - 1))
        return {"action": "restart", "backoff_s": delay,
                "attempt": self.failures}
