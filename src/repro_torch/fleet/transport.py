"""Socket transport for the fleet wire contract: framed TCP/UDS.

The loopback transport proves the coordinator speaks only wire data;
this module makes that wire REAL — a DMTCP-shaped socket protocol where
the coordinator listens and every worker dials in, so the failure modes
that matter at HPC scale (partial frames, dropped connections mid-dump,
coordinator loss) become reproducible protocol moments instead of
theory. Layering, bottom up:

  framing     MAGIC + uint32 big-endian length + compact UTF-8 JSON
              (``wire.to_json_bytes`` — the SAME serialization loopback
              round-trips through). ``FrameDecoder`` reassembles split /
              coalesced deliveries; anything malformed raises a typed
              ``FrameError``, never a crash.

  envelopes   every frame is ``{"ch": ..., "v": SCHEMA_VERSION, ...}``:
              hello / hello_ack (handshake), cmd / reply (sequenced
              commands), event (fire-and-forget heartbeats), bye
              (graceful close), err (typed refusals). A future-major
              ``v`` is rejected with the wire contract's own
              ``WireVersionError``.

  handshake   a worker's first frame is ``hello`` carrying
              ``(job_id, incarnation)`` plus its last executed sequence
              number; the coordinator answers ``hello_ack`` with its
              epoch. A stale incarnation or unknown job is refused with
              ``err`` — ``HandshakeError`` on the dialing side.

  resume      the coordinator assigns every command a per-job sequence
              number and keeps the last unacknowledged one; when the
              connection dies mid-command, the worker reconnects (bounded
              exponential backoff) and the command is REPLAYED on the
              resumed connection. The worker's dedup window (seq ->
              cached reply) makes execution at-most-once: a replay of an
              executed command returns the cached reply without running
              it again. Past ``resume_timeout_s`` the coordinator gives
              up with ``HostDownError`` — the existing re-place path.

  restart     ``coordinator_serve()`` journals ``registry.to_wire()`` to
              a tier on every mutation. A restarted coordinator reloads
              the table, bumps its epoch (workers then drop their dedup
              windows — the sequence space started over), re-adopts live
              jobs as they HELLO, and re-places jobs whose heartbeats
              never return via the ordinary ``check_heartbeats()`` sweep.
              The restore-claim CAS is journaled too, so a claim taken
              before the crash still has exactly one winner after it.

A copy of the JAX package's fleet/transport.py over the port's wire,
storage and fleet modules. The frames are the contract: for the same
payload both packages put the same bytes on the socket, so a JAX worker
dials this coordinator as readily as a torch one, a journal written by
either coordinator is re-adopted by the other, and the reverse. Nothing
here touches a device: a job's tensors stay where its FleetClient's
session (and its ``device``) put them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import threading
import time

from repro_torch.api import wire
from repro_torch.core import storage
from repro_torch.fleet.client import HostDownError, dispatch_command
from repro_torch.fleet.coordinator import FleetCoordinator
from repro_torch.fleet.messages import ErrorReply
from repro_torch.fleet.registry import JobRegistry

MAGIC = b"RW"                     # "repro wire"
_HEADER = struct.Struct(">2sI")   # MAGIC + payload length, big-endian
HEADER_BYTES = _HEADER.size
MAX_FRAME_BYTES = 16 * 1024 * 1024
REGISTRY_REL = "fleet/registry.json"     # the coordinator's journal key


class FrameError(ValueError):
    """A malformed byte stream at the framing layer: bad magic, an
    oversized length, or a payload that is not a JSON object. The
    decoder is poisoned after the first one — framing errors are not
    resumable mid-stream, the connection must be dropped.

    Example::

        try:
            FrameDecoder().feed(b"garbage from a port scanner")
        except FrameError:
            ...   # drop the connection; never a crash
    """


class HandshakeError(ConnectionError):
    """The HELLO exchange failed: the coordinator refused this worker
    (unknown job, stale incarnation, incompatible schema major) or the
    reconnect budget ran out before a coordinator answered.

    Example::

        try:
            agent = client.connect("tcp://coord:7777")
        except HandshakeError:
            ...   # this incarnation must not serve; exit
    """


# --------------------------------------------------------------- framing
def encode_frame(payload: dict) -> bytes:
    """One wire frame: header (magic + length) + canonical JSON bytes."""
    data = wire.to_json_bytes(payload)
    if len(data) > MAX_FRAME_BYTES:
        raise FrameError(f"frame of {len(data)} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte limit")
    return _HEADER.pack(MAGIC, len(data)) + data


class FrameDecoder:
    """Incremental reassembly of length-prefixed frames from an arbitrary
    byte stream. ``feed()`` accepts ANY split/coalescing the transport
    produced — byte-at-a-time, mid-header, many-frames-at-once — and
    returns complete payload dicts in order. Malformed input raises
    FrameError and poisons the decoder (the stream has lost sync).

    Example::

        dec = FrameDecoder()
        frames = dec.feed(encode_frame({"ch": "bye", "v": "1.0"}))
        assert frames[0]["ch"] == "bye"
    """

    def __init__(self, max_bytes: int = MAX_FRAME_BYTES):
        self.max_bytes = int(max_bytes)
        self._buf = bytearray()
        self._poisoned = False
        self.frames_decoded = 0

    def _poison(self, why: str):
        self._poisoned = True
        raise FrameError(why)

    def feed(self, data: bytes) -> list:
        """Bytes in, zero or more complete frames out (typed errors
        only — arbitrary input never crashes the framer)."""
        if self._poisoned:
            raise FrameError("decoder poisoned by an earlier framing "
                             "error — the stream has lost sync")
        self._buf.extend(data)
        out = []
        while True:
            if len(self._buf) < HEADER_BYTES:
                return out
            magic, length = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                self._poison(f"bad frame magic {bytes(magic)!r} "
                             f"(expected {MAGIC!r})")
            if length > self.max_bytes:
                self._poison(f"frame length {length} exceeds the "
                             f"{self.max_bytes}-byte limit")
            if len(self._buf) < HEADER_BYTES + length:
                return out
            payload = bytes(self._buf[HEADER_BYTES:HEADER_BYTES + length])
            del self._buf[:HEADER_BYTES + length]
            try:
                frame = wire.from_json_bytes(payload)
            except (ValueError, UnicodeDecodeError) as e:
                self._poison(f"frame payload is not a JSON object: {e}")
            self.frames_decoded += 1
            out.append(frame)


# ------------------------------------------------------------- envelopes
def _envelope(ch: str, **fields) -> dict:
    return {"ch": ch, "v": wire.SCHEMA_VERSION, **fields}


def check_envelope(env) -> str:
    """Validate a transport envelope, returning its channel. A missing
    ``ch`` is a FrameError; a future-major ``v`` is the wire contract's
    own WireVersionError (schema negotiation reuses it verbatim)."""
    if not isinstance(env, dict) or not isinstance(env.get("ch"), str):
        raise FrameError(f"not a transport envelope: {env!r}")
    major, _minor = wire.parse_version(env.get("v"))
    if major > wire.WIRE_MAJOR:
        raise wire.WireVersionError(
            f"peer speaks transport schema major {major}, this build "
            f"speaks {wire.WIRE_MAJOR} — refusing to guess")
    return env["ch"]


# ------------------------------------------------------------------ URLs
def parse_url(url: str) -> tuple:
    """``tcp://host:port`` -> ("tcp", (host, port));
    ``unix:///path`` -> ("unix", path). Anything else is a ValueError."""
    if url.startswith("tcp://"):
        host, _, port = url[len("tcp://"):].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp transport URL {url!r} "
                             f"(expected tcp://host:port)")
        return "tcp", (host, int(port))
    if url.startswith("unix://"):
        path = url[len("unix://"):]
        if not path:
            raise ValueError(f"bad unix transport URL {url!r} "
                             f"(expected unix:///path/to.sock)")
        return "unix", path
    raise ValueError(f"unsupported transport URL {url!r}: expected "
                     f"tcp://host:port or unix:///path")


def _listen(url: str) -> socket.socket:
    scheme, addr = parse_url(url)
    if scheme == "tcp":
        return socket.create_server(addr)
    if os.path.exists(addr):
        os.unlink(addr)                    # a stale socket from a crash
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(addr)
    s.listen(64)
    return s


def _connect_once(url: str, timeout: float) -> socket.socket:
    scheme, addr = parse_url(url)
    if scheme == "tcp":
        return socket.create_connection(addr, timeout=timeout)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect(addr)
    return s


class _Conn:
    """One live connection: a socket plus a write lock (frames from the
    replier and the heartbeat path must not interleave mid-frame)."""

    def __init__(self, sock):
        self.sock = sock
        self._wlock = threading.Lock()

    def send_payload(self, payload: dict):
        data = encode_frame(payload)
        with self._wlock:
            self.sock.sendall(data)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------ worker side
@dataclasses.dataclass(frozen=True)
class ReconnectPolicy:
    """Bounded reconnect-with-backoff: ``attempts`` dials, exponential
    delay from ``backoff_s`` capped at ``backoff_max_s``. When the budget
    runs out the agent fails for good (HandshakeError) — a worker does
    not spin forever against a coordinator that is not coming back.

    Example::

        rp = ReconnectPolicy(attempts=40, backoff_s=0.05, backoff_max_s=0.5)
    """
    attempts: int = 10
    backoff_s: float = 0.05
    backoff_max_s: float = 1.0
    connect_timeout_s: float = 5.0


class WorkerAgent:
    """The job-side endpoint of the socket protocol: dials the
    coordinator, HELLOs with ``(job_id, incarnation)``, then serves
    ``cmd`` envelopes through the SAME ``dispatch_command`` the loopback
    transport uses. Reconnects with bounded backoff when the connection
    dies; the dedup window (seq -> cached reply) turns the coordinator's
    replay of an executed command into a cache hit, never a re-execution.

    ``wrap_socket`` (tests) wraps each freshly connected socket — the
    chaos harness injects cuts/short-writes there.

    Example::

        agent = WorkerAgent(client, "unix:///tmp/coord.sock")
        agent.start()
        ...
        agent.stop()
    """

    def __init__(self, client, url: str, *, incarnation: int = 0,
                 reconnect: ReconnectPolicy | None = None,
                 dedup_window: int = 64, heartbeat_every_s: float = 0.0,
                 wrap_socket=None):
        self.client = client
        self.url = url
        self.incarnation = int(incarnation)
        self.reconnect = reconnect or ReconnectPolicy()
        self.dedup_window = max(1, int(dedup_window))
        self.heartbeat_every_s = float(heartbeat_every_s)
        self.wrap_socket = wrap_socket
        self.connected = threading.Event()
        self.failed = threading.Event()
        self.stats = {"connects": 0, "reconnects": 0, "commands": 0,
                      "dedup_hits": 0, "events_sent": 0}
        self._replies: dict = {}           # seq -> cached reply envelope
        self._last_seq = 0
        self._epoch = None
        # notified once a handshake has stored the coordinator's epoch
        self._epoch_cond = threading.Condition()
        self._conn = None
        self._conn_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------ control
    def start(self):
        """Launch the serve loop (daemon thread)."""
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"worker-agent-{self.client.job_id}")
        self._thread.start()
        return self

    def stop(self, *, bye: bool = True):
        """Stop serving. ``bye`` announces the close so the coordinator
        does not wait out ``resume_timeout_s`` for a reconnect."""
        self._stop.set()
        with self._conn_lock:
            conn = self._conn
        if conn is not None:
            if bye:
                try:
                    conn.send_payload(_envelope("bye"))
                except OSError:
                    pass
            conn.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def wait_epoch(self, epoch: int, timeout: float = 10.0) -> bool:
        """Block until a handshake has stored coordinator ``epoch`` (the
        coordinator counts a transport connected once it has SENT its
        hello_ack, before this side has read it), or the timeout passes."""
        with self._epoch_cond:
            return self._epoch_cond.wait_for(lambda: self._epoch == epoch,
                                             timeout=float(timeout))

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def heartbeat(self, now: float | None = None) -> bool:
        """Send one heartbeat event (fire-and-forget; no reply). Returns
        False when not currently connected — heartbeats are periodic,
        losing one is the design."""
        with self._conn_lock:
            conn = self._conn
        if conn is None:
            return False
        frame = self.client.heartbeat(time.time() if now is None else now)
        try:
            conn.send_payload(_envelope("event", frame=frame))
        except OSError:
            return False
        self.stats["events_sent"] += 1
        return True

    # --------------------------------------------------------- serve loop
    def _run(self):
        first = True
        while not self._stop.is_set():
            try:
                conn, dec, pending = self._connect()
            except (HandshakeError, wire.WireVersionError):
                self.failed.set()
                break
            if not first:
                self.stats["reconnects"] += 1
            first = False
            self.stats["connects"] += 1
            try:
                self._serve(conn, dec, pending)
            finally:
                self.connected.clear()
                with self._conn_lock:
                    self._conn = None
                conn.close()
        self.connected.clear()

    def _connect(self):
        """Dial + HELLO with bounded exponential backoff. A coordinator
        REFUSAL (err envelope) is fatal immediately; an unreachable or
        garbled coordinator burns an attempt."""
        rp = self.reconnect
        last_err = None
        for attempt in range(max(1, rp.attempts)):
            if self._stop.is_set():
                raise HandshakeError("agent stopped")
            if attempt:
                time.sleep(min(rp.backoff_s * (2 ** (attempt - 1)),
                               rp.backoff_max_s))
            try:
                sock = _connect_once(self.url, rp.connect_timeout_s)
            except OSError as e:
                last_err = e
                continue
            if self.wrap_socket is not None:
                sock = self.wrap_socket(sock) or sock
            conn = _Conn(sock)
            try:
                dec, pending = self._handshake(conn)
            except HandshakeError:
                conn.close()
                raise                       # refused: retrying is useless
            except (OSError, FrameError, wire.WireVersionError) as e:
                conn.close()
                last_err = e
                continue
            return conn, dec, pending
        raise HandshakeError(
            f"no coordinator at {self.url} after {rp.attempts} "
            f"attempts: {last_err!r}")

    def _handshake(self, conn):
        conn.send_payload(_envelope(
            "hello", job_id=self.client.job_id, host=self.client.host,
            incarnation=self.incarnation, epoch=self._epoch or 0,
            last_seq=self._last_seq,
            step=int(self.client.state_provider()[1])))
        conn.sock.settimeout(self.reconnect.connect_timeout_s)
        dec = FrameDecoder()
        frames: list = []
        while not frames:
            data = conn.sock.recv(65536)
            if not data:
                raise OSError("coordinator closed during handshake")
            frames = dec.feed(data)
        env, pending = frames[0], frames[1:]
        ch = check_envelope(env)
        if ch == "err":
            raise HandshakeError(
                f"coordinator refused {self.client.job_id!r}: "
                f"{env.get('error')}: {env.get('detail')}")
        if ch != "hello_ack":
            raise FrameError(f"expected hello_ack, got {ch!r}")
        epoch = env.get("epoch", 0)
        with self._epoch_cond:
            if epoch != self._epoch:
                # a different coordinator incarnation: its command sequence
                # space started over, so the old dedup window is meaningless
                self._replies.clear()
                self._last_seq = 0
                self._epoch = epoch
            self._epoch_cond.notify_all()
        return dec, pending

    def _serve(self, conn, dec, pending):
        with self._conn_lock:
            self._conn = conn
        self.connected.set()
        try:
            conn.sock.settimeout(0.25)
        except OSError:
            return              # died between handshake and serve: redial
        hb_last = time.monotonic()
        while not self._stop.is_set():
            try:
                for env in pending:
                    self._handle(conn, env)
            except (OSError, FrameError, wire.WireVersionError):
                return                      # connection is toast: redial
            pending = []
            if self.heartbeat_every_s \
                    and time.monotonic() - hb_last >= self.heartbeat_every_s:
                hb_last = time.monotonic()
                self.heartbeat()
            try:
                data = conn.sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            try:
                pending = dec.feed(data)
            except FrameError:
                return                      # lost sync: drop + redial

    def _handle(self, conn, env):
        ch = check_envelope(env)
        if ch == "cmd":
            seq = int(env.get("seq", 0))
            cached = self._replies.get(seq)
            if cached is not None:
                # the at-most-once guarantee: a replayed command is
                # answered from the window, never executed again
                self.stats["dedup_hits"] += 1
                conn.send_payload(cached)
                return
            if seq <= self._last_seq:
                conn.send_payload(_envelope(
                    "err", seq=seq, error="seq-expired",
                    detail=f"seq {seq} fell out of the dedup window"))
                return
            try:
                reply = dispatch_command(self.client, env.get("frame"))
            except Exception as e:          # noqa: BLE001 — any job-side
                # failure becomes a typed wire reply; the protocol stays
                # request/reply even when the job does not
                reply = ErrorReply(
                    job_id=self.client.job_id, error=type(e).__name__,
                    detail=str(e),
                    command=str((env.get("frame") or {}).get("kind"))
                ).to_wire()
            self.stats["commands"] += 1
            out = _envelope("reply", seq=seq, frame=reply)
            self._replies[seq] = out        # cache BEFORE the send: a cut
            self._last_seq = max(self._last_seq, seq)   # mid-reply replays
            while len(self._replies) > self.dedup_window:
                self._replies.pop(min(self._replies))
            conn.send_payload(out)
        elif ch == "bye":
            self._stop.set()
        # hello_ack duplicates and unknown same-major channels: tolerated


# ------------------------------------------------------- coordinator side
class SocketTransport:
    """The coordinator's handle on one job over the socket: the same
    ``send(frame) -> reply`` surface as LoopbackTransport, plus
    reconnect-and-resume. Commands get per-job sequence numbers; ONE
    command is in flight at a time; if the connection dies before the
    reply, the next connection that HELLOs for this job replays it.
    Past ``resume_timeout_s`` with no reply: HostDownError, the
    coordinator's ordinary lost-host path.

    Example::

        t = server.attach("j0", cfg.to_wire(), host="w0")
        ack = t.send(DrainCommand(job_id="j0").to_wire())
    """

    def __init__(self, job_id: str, *, host: str = "",
                 resume_timeout_s: float = 5.0, on_send=None,
                 incarnation: int = 0):
        self.job_id = job_id
        self.host = host
        self.resume_timeout_s = float(resume_timeout_s)
        self.on_send = on_send
        self.dead = False
        self.incarnation = int(incarnation)   # minimum accepted at HELLO
        self.frames_sent = 0
        self.frames_received = 0
        self._cond = threading.Condition()
        self._conn = None
        self._seq = 0
        self._pending = None               # (seq, envelope) awaiting reply
        self._reply = None                 # (seq, frame) when delivered
        self._send_lock = threading.Lock()

    @property
    def connected(self) -> bool:
        with self._cond:
            return self._conn is not None

    # ------------------------------------------------- server-side wiring
    def _bind(self, conn):
        """A (re)connected worker: current connection swaps in and the
        pending command, if any, is replayed on it."""
        with self._cond:
            old, self._conn = self._conn, conn
            pending = self._pending
            self._cond.notify_all()
        if old is not None and old is not conn:
            old.close()
        if pending is not None:
            try:
                conn.send_payload(pending[1])
            except OSError:
                pass                       # its reader will unbind; retry
                                           # on the next rebind
    def _unbind(self, conn):
        with self._cond:
            if self._conn is conn:
                self._conn = None

    def _deliver(self, seq: int, frame):
        with self._cond:
            if self._pending is not None and seq == self._pending[0]:
                self._reply = (seq, frame)
                self._cond.notify_all()

    # ------------------------------------------------------------- sending
    def send(self, frame: dict) -> dict:
        """One command round trip, surviving reconnects in between."""
        if self.on_send is not None:
            self.on_send(self.host, frame)
        if self.dead:
            raise HostDownError(f"host {self.host!r} is down; frame for "
                                f"{self.job_id!r} undeliverable")
        with self._send_lock:
            with self._cond:
                self._seq += 1
                seq = self._seq
                env = _envelope("cmd", seq=seq, frame=frame)
                self._pending = (seq, env)
                self._reply = None
                conn = self._conn
            self.frames_sent += 1
            if conn is not None:
                try:
                    conn.send_payload(env)
                except OSError:
                    pass                   # replayed when a conn rebinds
            deadline = time.monotonic() + self.resume_timeout_s
            try:
                with self._cond:
                    while True:
                        if self._reply is not None \
                                and self._reply[0] == seq:
                            reply = self._reply[1]
                            break
                        if self.dead:
                            raise HostDownError(
                                f"host {self.host!r} died mid-command")
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise HostDownError(
                                f"job {self.job_id!r} did not reconnect "
                                f"within {self.resume_timeout_s:.1f}s — "
                                f"command {frame.get('kind')!r} (seq "
                                f"{seq}) abandoned")
                        self._cond.wait(min(left, 0.05))
            finally:
                with self._cond:
                    self._pending = None
                    self._reply = None
            self.frames_received += 1
            return reply


class CoordinatorServer:
    """The socket listener wrapped around a FleetCoordinator: accepts
    worker connections, runs the HELLO handshake (schema + incarnation
    checks, registry re-adoption), routes ``reply`` envelopes to the
    per-job SocketTransport and ``event`` envelopes into
    ``coordinator.deliver`` (heartbeat timestamps are restamped into the
    coordinator's clock domain at ingress — worker clocks do not travel).

    Built directly around an existing coordinator (SimCluster's socket
    mode) or via ``coordinator_serve()`` for the journaled-registry
    stack.

    Example::

        server = coordinator_serve("unix:///tmp/coord.sock",
                                   registry_tier=f"file://{tmp}/journal")
        server.attach("j0", cfg.to_wire(), host="w0")
        server.wait_connected(["j0"], timeout=10)
        report = server.coordinator.preemption_wave()
    """

    def __init__(self, url: str, *, coordinator: FleetCoordinator,
                 registry_tier=None, resume_timeout_s: float = 5.0,
                 epoch: int = 1, handshake_timeout_s: float = 5.0,
                 serve: bool = True):
        self.coordinator = coordinator
        self.registry = coordinator.registry
        self.registry_tier = storage.as_tier(registry_tier) \
            if registry_tier is not None else None
        self.resume_timeout_s = float(resume_timeout_s)
        self.handshake_timeout_s = float(handshake_timeout_s)
        self.epoch = int(epoch)
        self.stats = {"accepted": 0, "hellos": 0, "rejected": 0,
                      "events": 0, "bad_events": 0}
        self._transports: dict = {}
        self._conns: set = set()
        self._lock = threading.Lock()
        self._journal_lock = threading.Lock()
        self._closing = threading.Event()
        # connections wait in the listen backlog until this is set:
        # ``serve=False`` defers it to ``open()``
        self._serving = threading.Event()
        if serve:
            self._serving.set()
        self._listener = _listen(url)
        scheme, _addr = parse_url(url)
        if scheme == "tcp":
            host, port = self._listener.getsockname()[:2]
            self.url = f"tcp://{host}:{port}"   # port 0 resolved
        else:
            self.url = url
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="coord-accept")
        self._accept_thread.start()

    def open(self):
        """Start accepting workers (a server made with ``serve=False``).
        coordinator_serve opens once every journaled job has its
        transport: a worker that redials a restarted coordinator while
        the journal loads waits in the backlog, where it would otherwise
        be refused as an unknown job and fail for good."""
        self._serving.set()

    # ---------------------------------------------------------- transports
    def attach(self, job_id: str, config_wire: dict, *, host: str = "",
               topology: dict | None = None,
               kind: str = "train") -> SocketTransport:
        """Admit a job (same contract as FleetCoordinator.attach); its
        worker dials in whenever it likes — commands queue against the
        transport until the HELLO binds a connection."""
        t = self._transports.get(job_id) \
            or self._make_transport(job_id, host=host)
        try:
            self.registry.get(job_id)
        except KeyError:
            self.coordinator.attach(job_id, t, host=host,
                                    config_wire=config_wire,
                                    topology=topology, kind=kind)
        else:
            self.coordinator.transports[job_id] = t   # journaled job
        return t

    def transport(self, job_id: str) -> SocketTransport:
        return self._transports[job_id]

    def _make_transport(self, job_id: str, *, host: str = "",
                        min_incarnation: int = 0) -> SocketTransport:
        t = SocketTransport(job_id, host=host,
                            resume_timeout_s=self.resume_timeout_s,
                            incarnation=min_incarnation)
        with self._lock:
            self._transports[job_id] = t
        self.coordinator.transports[job_id] = t
        return t

    def _ensure_transports(self):
        """Restart path: every journaled job gets a transport up front so
        its reconnecting worker has something to bind to."""
        for rec in self.registry.jobs():
            if rec.job_id not in self._transports:
                self._make_transport(rec.job_id, host=rec.host or "",
                                     min_incarnation=rec.incarnation)

    def new_incarnation(self, job_id: str, *, host: str = "") -> SocketTransport:
        """Replace a job's transport for its NEXT incarnation: the new
        transport only accepts HELLOs with a strictly higher incarnation,
        so the dead incarnation's late reconnects are refused."""
        old = self._transports[job_id]
        return self._make_transport(job_id, host=host or old.host,
                                    min_incarnation=old.incarnation + 1
                                    if old.incarnation else
                                    self.registry.get(job_id).incarnation + 1)

    def reuse_spawner(self, rec, host, config_wire) -> SocketTransport:
        """Default spawner for socket fleets: the job's (relaunched)
        worker reuses its socket identity — the RestoreRequest rides the
        same transport, executed by whichever incarnation HELLOs next."""
        return self._transports[rec.job_id]

    def wait_connected(self, job_ids=None, timeout: float = 10.0) -> bool:
        """Block until every listed job (default: all attached) has a
        live bound connection, or the timeout passes."""
        deadline = time.monotonic() + float(timeout)
        while True:
            with self._lock:
                ids = list(job_ids) if job_ids is not None \
                    else list(self._transports)
                ts = [self._transports[j] for j in ids
                      if j in self._transports]
            if ids and all(t.connected for t in ts) and len(ts) == len(ids):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    # -------------------------------------------------------------- journal
    def journal(self):
        """Persist ``registry.to_wire()`` (plus this coordinator's epoch)
        atomically — the restart story is only as good as the last
        committed snapshot — and return it. Mutations on other threads
        (heartbeats beside a dump) journal one at a time, so the last
        snapshot written is the newest."""
        tier = self.registry_tier
        if tier is None:
            return None
        with self._journal_lock:
            snap = self.registry.to_wire()
            snap["epoch"] = self.epoch
            tier.write_bytes(REGISTRY_REL,
                             json.dumps(snap, indent=1).encode("utf-8"),
                             atomic=True)
        return snap

    # ------------------------------------------------------------ accepting
    def _accept_loop(self):
        self._listener.settimeout(0.25)
        while not self._closing.is_set():
            if not self._serving.wait(0.25):
                continue
            try:
                sock, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self.stats["accepted"] += 1
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True).start()

    def _reject(self, conn, error: str, detail: str):
        self.stats["rejected"] += 1
        try:
            conn.send_payload(_envelope("err", error=error, detail=detail))
        except OSError:
            pass

    def _serve_conn(self, sock):
        conn = _Conn(sock)
        with self._lock:
            self._conns.add(conn)
        transport = None
        try:
            sock.settimeout(self.handshake_timeout_s)
            dec = FrameDecoder()
            frames: list = []
            while not frames:
                data = sock.recv(65536)
                if not data:
                    return
                frames = dec.feed(data)
            env, pending = frames[0], frames[1:]
            try:
                ch = check_envelope(env)
            except (FrameError, wire.WireVersionError) as e:
                self._reject(conn, "version", str(e))
                return
            if ch != "hello":
                self._reject(conn, "protocol",
                             f"expected hello, got {ch!r}")
                return
            job_id = env.get("job_id")
            with self._lock:
                transport = self._transports.get(job_id)
            if transport is None:
                self._reject(conn, "unknown-job",
                             f"job {job_id!r} is not attached to this "
                             f"coordinator")
                return
            inc = int(env.get("incarnation", 0))
            if inc < transport.incarnation:
                t, transport = transport, None   # do not unbind the live one
                self._reject(conn, "stale-incarnation",
                             f"job {job_id!r} incarnation {inc} < "
                             f"expected {t.incarnation}")
                return
            self.registry.adopt(job_id, host=env.get("host") or None,
                                incarnation=inc,
                                step=int(env.get("step", 0)))
            self.stats["hellos"] += 1
            conn.send_payload(_envelope(
                "hello_ack", epoch=self.epoch,
                resume_seq=transport._pending[0]
                if transport._pending else 0))
            transport._bind(conn)
            sock.settimeout(0.25)
            while not self._closing.is_set():
                for f in pending:
                    self._route(transport, f)
                pending = []
                try:
                    data = sock.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                try:
                    pending = dec.feed(data)
                except FrameError:
                    return                 # lost sync: drop, worker redials
        except OSError:
            pass
        finally:
            if transport is not None:
                transport._unbind(conn)
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    def _route(self, transport, env):
        try:
            ch = check_envelope(env)
        except (FrameError, wire.WireVersionError):
            self.stats["bad_events"] += 1
            return
        if ch == "reply":
            transport._deliver(int(env.get("seq", -1)), env.get("frame"))
        elif ch == "event":
            self._ingest(env.get("frame"))
        elif ch == "bye":
            raise OSError("worker said bye")
        # unknown same-major channels: tolerated

    def _ingest(self, frame):
        if not isinstance(frame, dict):
            self.stats["bad_events"] += 1
            return
        if frame.get("kind") == "Heartbeat":
            # liveness is judged in the COORDINATOR's clock domain; the
            # worker's sent_at died with its process boundary
            frame = dict(frame, sent_at=float(self.coordinator.clock()))
        try:
            self.coordinator.deliver(frame)
            self.stats["events"] += 1
        except Exception:                   # noqa: BLE001 — a bad event
            self.stats["bad_events"] += 1   # must not kill the reader

    # -------------------------------------------------------------- closing
    def close(self, *, bye: bool = True):
        """Graceful shutdown: ``bye`` to every worker (so agents stop
        instead of redialing), close everything, flush the journal."""
        self._closing.set()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            if bye:
                try:
                    c.send_payload(_envelope("bye"))
                except OSError:
                    pass
            c.close()
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        self.journal()

    def kill(self):
        """Abrupt coordinator death (tests): connections drop with no
        bye and nothing is flushed beyond what ``on_change`` already
        journaled — exactly what SIGKILL leaves behind."""
        self._closing.set()
        self.registry.on_change = None
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        self._accept_thread.join(timeout=5.0)


def coordinator_serve(url: str, *, registry_tier=None, clock=None,
                      heartbeat_timeout_s: float = 30.0,
                      dump_concurrency: int = 4, spawner="reuse",
                      policy=None, topology=None,
                      resume_timeout_s: float = 5.0) -> CoordinatorServer:
    """Run a FleetCoordinator behind a socket listener, with its registry
    journaled to ``registry_tier`` after every mutation. Starting over an
    EXISTING journal is the restart path: the table reloads, the epoch
    bumps (workers drop their dedup windows), live jobs re-adopt as they
    HELLO, and jobs whose heartbeats never return fall out of the
    liveness window and get re-placed by ``check_heartbeats()``.

    ``spawner="reuse"`` (default) restores a job over its existing
    socket identity — right for fleets where the batch system relaunches
    workers that dial back in. Pass a custom spawner (or None) for
    cluster-managed placement.

    Example::

        server = coordinator_serve(f"unix://{tmp}/coord.sock",
                                   registry_tier=f"file://{tmp}/journal")
        ...
        server.close()
    """
    clock = clock or time.monotonic
    tier = storage.as_tier(registry_tier) if registry_tier is not None \
        else None
    registry, epoch = None, 1
    if tier is not None and tier.exists(REGISTRY_REL):
        snap = json.loads(tier.read_bytes(REGISTRY_REL).decode("utf-8"))
        registry = JobRegistry.from_wire(
            snap, clock=clock, heartbeat_timeout_s=heartbeat_timeout_s)
        epoch = int(snap.get("epoch", 0)) + 1
    if registry is None:
        registry = JobRegistry(clock=clock,
                               heartbeat_timeout_s=heartbeat_timeout_s)
    coordinator = FleetCoordinator(
        topology=topology, registry=registry, clock=clock,
        heartbeat_timeout_s=heartbeat_timeout_s,
        dump_concurrency=dump_concurrency, policy=policy)
    server = CoordinatorServer(url, coordinator=coordinator,
                               registry_tier=tier, epoch=epoch,
                               resume_timeout_s=resume_timeout_s,
                               serve=False)
    coordinator.spawner = server.reuse_spawner if spawner == "reuse" \
        else spawner
    server._ensure_transports()
    registry.on_change = server.journal
    server.journal()        # the new epoch is durable before any HELLO
    server.open()
    return server
