"""Fleet-level wire messages: what travels that the session API doesn't.

The session requests (DumpRequest/MigrateRequest/RestoreRequest and
their receipts) already ARE wire messages — the coordinator ships them
verbatim. This module adds the control-plane vocabulary around them,
DMTCP-coordinator style:

  Heartbeat     job -> coordinator   liveness + current step
  DrainCommand  coordinator -> job   run to the next step boundary, pause
  DrainAck      job -> coordinator   paused at ``step``
  RestoreAck    job -> coordinator   a restore landed; carries the
                                     RECOMPUTED logical-state digest so
                                     the coordinator can verify
                                     bit-identity across hosts from wire
                                     data alone (RestoreResult itself
                                     holds the live pytree and cannot
                                     travel)
  ErrorReply    job -> coordinator   a command failed job-side; typed as
                                     data so a TransferError crosses the
                                     wire instead of killing the
                                     transport

Every message is a ``repro_torch.api.wire.WireRecord``: versioned envelope,
loss-free round trip, future-major rejection, unknown-field tolerance."""
from __future__ import annotations

import dataclasses

from repro_torch.api.wire import WireRecord


@dataclasses.dataclass(frozen=True)
class Heartbeat(WireRecord):
    """Periodic liveness beacon. ``sent_at`` is the CLUSTER clock (the
    coordinator's ``clock()`` domain) so staleness math never mixes
    per-host clocks.

    Example::

        coord.deliver(Heartbeat(job_id="j3", step=120,
                                sent_at=clock()).to_wire())
    """
    job_id: str
    step: int
    sent_at: float
    sessions: int = 0      # live serving sessions (0 for trainers)


@dataclasses.dataclass(frozen=True)
class DrainCommand(WireRecord):
    """Ask a job to run to its next step boundary and pause there —
    phase one of a preemption wave (flag, never dump, exactly like the
    session's signal handler).

    Example::

        ack = transport.send(DrainCommand(job_id="j3").to_wire())
    """
    job_id: str
    reason: str = "preemption_wave"
    boundary: str = "step"      # "step" (trainer) | "decode" (serving)


@dataclasses.dataclass(frozen=True)
class DrainAck(WireRecord):
    """The job is paused at ``step``; its state will not change until it
    is dumped (or resumed).

    Example::

        ack = wire.decode(transport.send(DrainCommand(...).to_wire()))
        assert isinstance(ack, DrainAck)
    """
    job_id: str
    step: int


@dataclasses.dataclass(frozen=True)
class RestoreAck(WireRecord):
    """A restore landed on ``host``. ``state_digest`` is recomputed from
    the restored leaves (integrity.tree_digest), so coordinator-side
    bit-identity verification needs only wire data; ``digest_verified``
    echoes the session's own manifest check.

    Example::

        assert ack.state_digest == registry.get(ack.job_id).state_digest
    """
    job_id: str
    image_id: str
    step: int
    host: str
    digest_verified: bool | None = None
    state_digest: str | None = None
    cache_hot_hits: int = 0
    cache_cold_reads: int = 0


@dataclasses.dataclass(frozen=True)
class ErrorReply(WireRecord):
    """A command failed on the job side. ``error`` is the exception
    class name (e.g. "TransferError"); the coordinator maps it back to
    wave semantics (abort / retry / mark failed) without a live
    exception object crossing the transport.

    Example::

        if isinstance(reply, ErrorReply) and reply.error == "TransferError":
            report.failed[reply.job_id] = reply.detail
    """
    job_id: str
    error: str
    detail: str = ""
    command: str = ""
