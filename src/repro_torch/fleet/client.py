"""FleetClient: the job-side endpoint of the coordinator protocol.

The coordinator never holds a CheckpointSession — it holds transports.
A FleetClient is what sits at the other end: it owns the session (built
FROM the wire-level config), owns the live runtime objects the wire
refuses to carry (the state pytree, the data iterator), and executes
wire commands by filling those objects in. The division of labor is
CRIU's dump/restore split wearing DMTCP's coordinator hat:

  coordinator        sends DumpRequest(state=None) / MigrateRequest /
                     RestoreRequest / DrainCommand as wire dicts
  FleetClient        decodes, substitutes its live state, runs the
                     session call, encodes the receipt back

``LoopbackTransport`` is the in-process stand-in for the socket: every
frame in BOTH directions passes through ``json.dumps``/``json.loads``,
so anything non-serializable fails loudly at the boundary — the tests'
proof that the coordinator really speaks only the wire contract. A
transport whose host has died raises ``HostDownError`` instead of
delivering (the coordinator's cue to fail the host and re-place).

Port differences from the JAX package's client.py: the session is opened
on an explicit ``device`` ("cuda" by default), outside the wire config, as
``CheckpointSession`` takes it; the restore ack's digest hashes one leaf
at a time from where it lies (a trainer's state is never copied to the
host whole); an eager restore hands the restored tree to the session as
its delta8 baseline (``CheckpointSession.adopt_baseline``), so a lossy
trainer's next wave dump encodes against the image it came from instead
of in full."""
from __future__ import annotations

import dataclasses

from repro_torch.api import wire
from repro_torch.api.config import SessionConfig
from repro_torch.api.requests import (DumpRequest, MigrateRequest,
                                      RestoreRequest)
from repro_torch.api.session import CheckpointSession
from repro_torch.core.dump import flatten_with_paths
from repro_torch.core.integrity import tree_digest
from repro_torch.core.remote import TransferError
from repro_torch.fleet.messages import (DrainAck, DrainCommand, ErrorReply,
                                        Heartbeat, RestoreAck)


class HostDownError(ConnectionError):
    """The transport's host is dead: the frame was never delivered (and
    the command it carried did not run). Raised by the transport itself
    — a job-side failure that DID run arrives as an ErrorReply
    instead."""


def dispatch_command(client, frame: dict) -> dict:
    """THE client-side command dispatch, shared by every transport.

    Both legs pass through ``wire.to_json_bytes``/``from_json_bytes`` —
    the exact serialization the socket framing uses — so LoopbackTransport
    and the socket worker loop execute commands identically: a frame that
    serializes on loopback can never fail only on the socket path (and
    vice versa).

    Example::

        reply = dispatch_command(client, DrainCommand(job_id="j0").to_wire())
        assert reply["kind"] == "DrainAck"
    """
    delivered = wire.from_json_bytes(wire.to_json_bytes(frame))
    reply = client.execute(delivered)
    return wire.from_json_bytes(wire.to_json_bytes(reply))


class FleetClient:
    """Execute wire commands against one owned CheckpointSession.

    ``state_provider`` is a zero-arg callable returning ``(state, step)``
    — the live pytree the wire cannot carry. ``on_drain`` pauses the
    job at a step boundary and returns the paused step; ``on_restore``
    receives the RestoreResult so the job can adopt the restored state.

    ``device`` is where the session's codecs run and restored leaves land
    ("cuda" by default; raises without a card).

    Example::

        client = FleetClient("j0", cfg.to_wire(), host="h0",
                             state_provider=lambda: (job.state(), job.step),
                             device="cuda")
        reply = client.execute(MigrateRequest(state=None).to_wire())
    """

    def __init__(self, job_id: str, config_wire: dict, *, host: str = "",
                 state_provider=None, on_drain=None, on_restore=None,
                 iterator_provider=None, meta_provider=None,
                 sessions_provider=None, device="cuda"):
        self.job_id = job_id
        self.host = host
        self.config = SessionConfig.from_wire(config_wire)
        self.session = CheckpointSession(self.config, device=device)
        self.state_provider = state_provider \
            or (lambda: (None, 0))
        self.on_drain = on_drain
        self.on_restore = on_restore
        self.iterator_provider = iterator_provider
        # job-side metadata the wire cannot know: a serving plane's
        # session table rides every dump/migrate as meta so the next
        # incarnation can rebuild the plane from the image alone
        self.meta_provider = meta_provider
        self.sessions_provider = sessions_provider
        self.last_restore = None           # RestoreResult of the last ack
        self.commands_executed = 0

    # ------------------------------------------------------------ protocol
    def execute(self, frame: dict) -> dict:
        """One wire command in, one wire reply out (both plain dicts).
        Session-level TransferErrors become ErrorReply frames — the
        protocol stays request/reply even when storage does not."""
        msg = wire.decode(frame)
        self.commands_executed += 1
        try:
            return self._dispatch(msg).to_wire()
        except TransferError as e:
            return ErrorReply(job_id=self.job_id, error="TransferError",
                              detail=str(e),
                              command=type(msg).__name__).to_wire()

    def _dispatch(self, msg):
        if isinstance(msg, DrainCommand):
            step = self.on_drain() if self.on_drain \
                else self.state_provider()[1]
            return DrainAck(job_id=self.job_id, step=int(step))
        if isinstance(msg, DumpRequest):
            state, step = self.state_provider()
            meta = msg.meta
            if self.meta_provider:
                meta = {**(msg.meta or {}), **self.meta_provider()}
            req = dataclasses.replace(
                msg, state=state, meta=meta,
                step=step if msg.step < 0 else msg.step)
            return self.session.dump(req)
        if isinstance(msg, MigrateRequest):
            state, step = self.state_provider()
            it = self.iterator_provider() if self.iterator_provider \
                else None
            extra = msg.meta_extra
            if self.meta_provider:
                extra = {**(msg.meta_extra or {}), **self.meta_provider()}
            req = dataclasses.replace(
                msg, state=state, iterator=it, meta_extra=extra,
                step=msg.step if msg.step is not None else int(step))
            return self.session.migrate(req)
        if isinstance(msg, RestoreRequest):
            return self._restore(msg)
        raise TypeError(f"FleetClient cannot execute "
                        f"{type(msg).__name__} frames")

    def _restore(self, msg: RestoreRequest) -> RestoreAck:
        tier = self.session.tier
        before = dict(getattr(tier, "stats", {}))
        res = self.session.restore(msg)
        self.last_restore = res
        if not res.lazy:
            self.session.adopt_baseline(res.state, image_id=res.image_id,
                                        step=res.step)
        if self.on_restore:
            self.on_restore(res)
        after = dict(getattr(tier, "stats", {}))
        # tree_digest copies one leaf at a time to the host and hashes it;
        # a wire RestoreRequest carries no shardings, so no DTensor here
        digest = tree_digest(flatten_with_paths(res.state))
        return RestoreAck(
            job_id=self.job_id, image_id=res.image_id, step=res.step,
            host=self.host, digest_verified=res.digest_verified,
            state_digest=digest,
            cache_hot_hits=after.get("hot_hits", 0)
            - before.get("hot_hits", 0),
            cache_cold_reads=after.get("cold_reads", 0)
            - before.get("cold_reads", 0))

    def heartbeat(self, now: float) -> dict:
        """The job's outbound beacon, already in wire form."""
        return Heartbeat(job_id=self.job_id,
                         step=int(self.state_provider()[1]),
                         sent_at=float(now),
                         sessions=int(self.sessions_provider())
                         if self.sessions_provider else 0).to_wire()

    def connect(self, url: str, **agent_kw):
        """Dial a socket coordinator and serve its commands: returns a
        started ``repro_torch.fleet.transport.WorkerAgent``. This is the
        socket counterpart of handing a LoopbackTransport to the
        coordinator — the same client works behind either, and the
        coordinator may be the JAX package's.

        Example::

            agent = client.connect("unix:///tmp/coord.sock",
                                   heartbeat_every_s=1.0)
            ...
            agent.stop()
        """
        from repro_torch.fleet.transport import WorkerAgent
        agent = WorkerAgent(self, url, **agent_kw)
        agent.start()
        return agent

    def close(self):
        self.session.close()


class LoopbackTransport:
    """In-process wire: JSON-round-trips every frame both ways, so a
    frame that would not survive a real socket does not survive here.

    ``on_send`` (optional) fires before delivery with (host, frame) —
    the simulated cluster uses it to trigger seeded node failures at
    exact protocol moments. A dead transport raises HostDownError.

    Example::

        t = LoopbackTransport(client, host="h0")
        ack = t.send(DrainCommand(job_id="j0").to_wire())
    """

    def __init__(self, client: FleetClient, *, host: str = "",
                 on_send=None):
        self.client = client
        self.host = host or client.host
        self.on_send = on_send
        self.dead = False
        self.frames_sent = 0
        self.frames_received = 0

    def send(self, frame: dict) -> dict:
        if self.on_send is not None:
            self.on_send(self.host, frame)
        if self.dead:
            raise HostDownError(f"host {self.host!r} is down; frame for "
                                f"{self.client.job_id!r} undeliverable")
        self.frames_sent += 1
        # both wire legs live inside dispatch_command — the SAME dispatch
        # the socket worker loop runs, so the two transports cannot drift
        reply = dispatch_command(self.client, frame)
        if self.dead:                       # died while the command ran:
            raise HostDownError(            # the reply is lost with it
                f"host {self.host!r} died mid-command")
        self.frames_received += 1
        return reply
