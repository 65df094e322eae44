"""Scheduler-driven preemption — the OSPool/HTCondor scenario from the paper
(a copy of the JAX package's core/preempt.py, which imports no framework).

The batch system signals the job (SIGTERM); the runtime finishes the current
step, dumps at the boundary, and exits with code 85 — HTCondor's
self-checkpointing convention ("the job checkpointed; reschedule it
anywhere"). This is the paper's central workflow, implemented at the level
where it actually works for accelerator jobs: inside the runtime (no outside
dumper agent, hence no container-runtime restriction — rows 4/5).

The handler only ever *flags*: the dump happens at the next step boundary
(the quiesce point — no collective is captured mid-flight), driven by the
MigrationOrchestrator in core/migration.py. Besides the flag it records the
*reason* (which signal, or a programmatic trigger such as straggler-policy
escalation) and a monotonic timestamp, so the migration manifest can say why
the image exists and benchmarks can measure signal->exit latency."""
from __future__ import annotations

import signal
import threading
import time

EXIT_CHECKPOINTED = 85  # HTCondor self-checkpoint exit code


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR2)):
        self.signals = signals
        self._flag = threading.Event()
        self._orig = {}
        self.reason: str | None = None      # first trigger wins
        self.requested_at: float | None = None  # time.monotonic() of it
        self.trigger_count = 0

    def install(self):
        for s in self.signals:
            self._orig[s] = signal.signal(s, self._on_signal)
        return self

    def _record(self, reason: str):
        # async-signal-safe: NO locks here. CPython runs signal handlers in
        # the main thread between bytecodes, so a lock shared with request()
        # or clear() could be acquired by the very frame the handler
        # interrupted — an unbreakable self-deadlock exactly when the
        # scheduler wants us gone. Plain attribute writes are atomic under
        # the GIL; a concurrent programmatic trigger can at worst undercount
        # trigger_count or race the first-reason choice, both benign.
        if self.reason is None:
            self.reason = reason
            self.requested_at = time.monotonic()
        self.trigger_count += 1
        self._flag.set()

    def _on_signal(self, signum, frame):
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = f"signal_{signum}"
        self._record(name)

    def preempt_requested(self) -> bool:
        return self._flag.is_set()

    def request(self, reason: str = "request"):
        """Programmatic trigger (tests / straggler-policy escalation)."""
        self._record(reason)

    def clear(self):
        """Reset after a handled (or cancelled) preemption — a reused
        handler must not re-fire on the stale flag."""
        self._flag.clear()
        self.reason = None
        self.requested_at = None

    def uninstall(self):
        for s, h in self._orig.items():
            signal.signal(s, h)
        self._orig.clear()

    def __enter__(self):
        return self.install()

    def __exit__(self, *a):
        self.uninstall()
