"""Remote object-store tier + write-through caching composition.

The paper's migration story ("continue the computation on another compute
resource") assumes the image survives a trip through remote, slow, and
occasionally failing storage — OSPool jobs stage CRIU images through an
object store, not a shared POSIX directory. This module opens that path
for the engine while keeping every storage consumer (dump, restore,
pre-dump reuse, lazy faults, gc) unchanged:

  * ``SimulatedObjectStore`` — a deterministic object store with a
    configurable ``NetworkModel`` (per-request latency + per-connection
    bandwidth) and ``FaultPolicy`` (seeded, per-(op, key) consecutive
    transient failures). Time is a ``SimClock``: tests account virtual
    seconds and never sleep; benchmarks flip ``realtime=True`` and the
    same model costs real wall-clock, so parallel-vs-serial transfer
    comparisons measure genuine overlap.
  * ``RemoteTier`` — the full ``Tier`` contract over an object store.
    Large blobs (checkpoint chunks are 4 MiB by default) upload as
    parallel multipart parts on the executor's transfer lanes; every
    store op runs under a bounded ``RetryPolicy`` with exponential
    backoff. A part that exhausts its budget aborts the whole multipart
    upload — an object is either fully installed or absent, never torn.
  * ``CachingTier`` — write-through composition of a hot local front
    (``MemoryTier``/``LocalDirTier``) and a cold remote back: writes land
    in both layers, reads fill the front on a miss, dedup probes are
    answered from the in-memory cache indexes, and gc/retention forward
    to both layers. Invariant: the hot layer only ever holds content the
    cold layer has (writes go through, fills come from cold), so a
    hot-index hit is a sound dedup answer without a remote round trip.
  * ``remote://`` and ``cache+remote://`` URI schemes (see
    ``tier_from_uri``), process-registered like ``mem://`` — the same URI
    resolves to the same tier object, so a dumper session, its registry,
    and a second session share one chunk index and one write guard.

Failure semantics: a transient fault (TimeoutError/IOError from the
store) is retried with exponential backoff up to ``RetryPolicy.attempts``
tries; exhausting the budget raises ``TransferError`` — a typed, loud
failure. Because manifests commit last and multipart uploads are atomic,
a TransferError anywhere in a dump leaves no restorable-but-wrong image,
only unreferenced chunks for gc.

A copy of the JAX package's core/remote.py (framework-free) over the
port's tiers, so both packages' object stores hold the same keys and bytes
for the same image. Chunks from the device codec stage are memoryviews
over landed host buffers: ``write_bytes`` copies a blob before its parts
go to the transfer lanes, and ``upload_delta`` drains every lane before it
returns, so no buffer is read after the executor lets it go."""
from __future__ import annotations

import hashlib
import threading
import time
from contextlib import contextmanager
from urllib.parse import parse_qs

from repro_torch.core.storage import LocalDirTier, MemoryTier, RWGuard, Tier


class TransferError(RuntimeError):
    """A remote transfer exhausted its retry budget (typed, never a
    silent partial image: multipart uploads abort, manifests commit last).

    Attributes: ``op`` (store operation), ``key``, ``attempts`` (tries
    made), ``last`` (the final underlying exception)."""

    def __init__(self, op: str, key: str, attempts: int, last: BaseException):
        self.op = op
        self.key = key
        self.attempts = attempts
        self.last = last
        super().__init__(f"remote {op} {key!r} failed after {attempts} "
                         f"attempt(s): {last!r}")


class SimClock:
    """Deterministic transfer clock. ``advance(dt)`` accumulates simulated
    seconds; with ``realtime=True`` it also sleeps, so concurrent ops on
    different threads genuinely overlap (benchmarks). ``now`` is the total
    simulated time this clock has charged — with parallel transfers it is
    the serial-equivalent cost, not the wall clock."""

    def __init__(self, realtime: bool = False):
        self.realtime = realtime
        self.now = 0.0
        self._lock = threading.Lock()

    def advance(self, dt: float):
        if dt <= 0:
            return
        with self._lock:
            self.now += dt
        if self.realtime:
            time.sleep(dt)


class NetworkModel:
    """Per-request cost model: ``latency_s`` per operation plus
    ``nbytes / bandwidth_bps`` per transferred byte. Bandwidth is
    per-connection (like an object store's per-stream cap) — that is
    exactly why parallel multipart beats one serial stream.

    ``aggregate_bps`` adds the fleet-scale constraint the NERSC DMTCP
    study names as the dominant obstacle: the store's TOTAL ingress is
    capped, shared fluidly by the connections active at request time
    (per-connection share = aggregate / active, still capped by
    ``bandwidth_bps``). ``overload_conns``/``overload_penalty`` model
    saturation beyond fluid sharing: past the ``overload_conns`` knee the
    effective total degrades by ``(knee / active) ** penalty`` — request
    throttling, retry storms and FS contention make twenty concurrent
    checkpoint uploads move FEWER total bytes/sec than four. This is what
    makes a coordinator's staggered dump wave measurably beat all-at-once
    (the JAX package's repro.fleet); with the defaults
    (no aggregate cap) behavior is exactly the old per-connection model.

    ``active_connections``/``peak_active`` are maintained by the store
    around each operation — tests assert a bandwidth budget was respected
    via ``peak_active``."""

    def __init__(self, latency_s: float = 0.0,
                 bandwidth_bps: float | None = None,
                 aggregate_bps: float | None = None,
                 overload_conns: int = 0,
                 overload_penalty: float = 1.0):
        self.latency_s = float(latency_s)
        self.bandwidth_bps = float(bandwidth_bps) if bandwidth_bps else None
        self.aggregate_bps = float(aggregate_bps) if aggregate_bps else None
        self.overload_conns = int(overload_conns)
        self.overload_penalty = float(overload_penalty)
        self.active_connections = 0
        self.peak_active = 0
        self._conn_lock = threading.Lock()

    @contextmanager
    def connection(self):
        """Count one in-flight operation; yields the active-connection
        count at entry (the concurrency the op's cost is charged at)."""
        with self._conn_lock:
            self.active_connections += 1
            active = self.active_connections
            self.peak_active = max(self.peak_active, active)
        try:
            yield active
        finally:
            with self._conn_lock:
                self.active_connections -= 1

    def effective_total_bps(self, active: int) -> float | None:
        """Total store throughput at ``active`` concurrent connections:
        flat at ``aggregate_bps`` up to the overload knee, degrading as
        ``(knee / active) ** penalty`` past it (None = uncapped)."""
        if not self.aggregate_bps:
            return None
        total = self.aggregate_bps
        if self.overload_conns and active > self.overload_conns:
            total *= (self.overload_conns / active) ** self.overload_penalty
        return total

    def per_connection_bps(self, active: int = 1) -> float | None:
        rates = []
        if self.bandwidth_bps:
            rates.append(self.bandwidth_bps)
        total = self.effective_total_bps(active)
        if total:
            rates.append(total / max(1, active))
        return min(rates) if rates else None

    def cost_s(self, nbytes: int, active: int = 1) -> float:
        c = self.latency_s
        rate = self.per_connection_bps(active)
        if rate:
            c += nbytes / rate
        return c


class FaultPolicy:
    """Seeded, deterministic transient-failure schedule.

    Each (op, key) pair independently draws whether it fails and for how
    many consecutive attempts, from a hash of (seed, op, key) — the
    schedule does not depend on op order or thread interleaving, so
    concurrent tests stay reproducible. ``fixed_failures`` overrides the
    draw: every op fails exactly that many times (the property tests'
    budget-exhaustion lever). After its scheduled failures an op succeeds
    forever."""

    def __init__(self, seed: int = 0, fail_rate: float = 0.0,
                 max_consecutive: int = 1,
                 fixed_failures: int | None = None,
                 errors: tuple = (TimeoutError, IOError),
                 ops: tuple | None = None):
        self.seed = int(seed)
        self.fail_rate = float(fail_rate)
        self.max_consecutive = max(1, int(max_consecutive))
        self.fixed_failures = fixed_failures
        self.errors = tuple(errors)
        self.ops = tuple(ops) if ops is not None else None
        #   ^ restrict injection to these store ops (e.g. ("put_part",)
        #     to break only the part-upload leg); None = every op

    def failures_for(self, op: str, key: str) -> int:
        if self.ops is not None and op not in self.ops:
            return 0
        if self.fixed_failures is not None:
            return int(self.fixed_failures)
        if self.fail_rate <= 0.0:
            return 0
        h = hashlib.blake2b(f"{self.seed}:{op}:{key}".encode(),
                            digest_size=8).digest()
        draw = int.from_bytes(h[:4], "big") / 2**32
        if draw >= self.fail_rate:
            return 0
        return 1 + int.from_bytes(h[4:], "big") % self.max_consecutive

    def error_for(self, op: str, key: str, attempt: int) -> BaseException:
        err = self.errors[attempt % len(self.errors)]
        return err(f"injected {err.__name__} on {op} {key!r} "
                   f"(attempt {attempt + 1})")


class SimulatedObjectStore:
    """In-process object store with latency/bandwidth/failure modelling.

    API shape follows S3-style stores: whole-object put/get/head/list/
    delete, ranged get, and multipart upload (initiate -> put_part ->
    complete | abort). ``complete_multipart`` installs the object
    atomically; aborted or never-completed uploads are invisible to every
    read path. All mutation is lock-protected; the fault schedule is
    per-(op, key) so concurrent clients see deterministic injections."""

    def __init__(self, network: NetworkModel | None = None,
                 faults: FaultPolicy | None = None, name: str = ""):
        self.name = name
        self.network = network or NetworkModel()
        self.faults = faults or FaultPolicy()
        self.clock = SimClock(realtime=False)
        # one writers-vs-gc guard per STORE: every tier object over this
        # store (remote://, cache+remote://, hand-built RemoteTiers)
        # delegates its writer()/reaper() here
        self.rw_guard = RWGuard()
        # the global chunk index for shared_chunks tiers lives on the
        # STORE (like the guard): every job's tier alias reads and
        # repairs ONE set, so a delete through any alias is instantly
        # visible to every other alias's dedup probe
        self.shared_chunk_index: set | None = None
        self.shared_index_lock = threading.Lock()
        self._objects: dict = {}
        self._mtimes: dict = {}
        self._mp: dict = {}          # upload_id -> {"key", "parts"}
        self._attempts: dict = {}    # (op, key) -> tries so far
        self._lock = threading.Lock()
        self._mp_seq = 0
        self.stats = {"ops": 0, "puts": 0, "gets": 0, "bytes_in": 0,
                      "bytes_out": 0, "faults_injected": 0,
                      "mp_initiated": 0, "mp_completed": 0, "mp_aborted": 0}

    # ------------------------------------------------------------ plumbing
    def _op(self, op: str, key: str, nbytes: int = 0):
        """Charge one operation: count it, maybe inject a scheduled fault
        (raises), then pay the network cost."""
        with self._lock:
            self.stats["ops"] += 1
            tries = self._attempts[(op, key)] = \
                self._attempts.get((op, key), 0) + 1
        planned = self.faults.failures_for(op, key)
        if tries <= planned:
            with self._lock:
                self.stats["faults_injected"] += 1
            self.clock.advance(self.network.latency_s)   # failures aren't free
            raise self.faults.error_for(op, key, tries - 1)
        # charge the transfer at the concurrency it actually runs under:
        # in realtime mode the advance() sleeps while the connection is
        # counted, so overlapping ops genuinely contend for the shared
        # aggregate bandwidth (and exceed the overload knee together)
        with self.network.connection() as active:
            self.clock.advance(self.network.cost_s(nbytes, active))

    # ------------------------------------------------------- object verbs
    def put(self, key: str, data):
        data = bytes(data)
        self._op("put", key, len(data))
        with self._lock:
            self._objects[key] = data
            self._mtimes[key] = self.clock.now
            self.stats["puts"] += 1
            self.stats["bytes_in"] += len(data)

    def get(self, key: str) -> bytes:
        with self._lock:
            present = key in self._objects
            size = len(self._objects[key]) if present else 0
        self._op("get", key, size)
        with self._lock:
            if key not in self._objects:
                raise FileNotFoundError(key)
            data = self._objects[key]
            self.stats["gets"] += 1
            self.stats["bytes_out"] += len(data)
            return data

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        self._op("get", key, max(0, length))
        with self._lock:
            if key not in self._objects:
                raise FileNotFoundError(key)
            self.stats["gets"] += 1
            out = self._objects[key][offset:offset + length]
            self.stats["bytes_out"] += len(out)
            return out

    def head(self, key: str) -> bool:
        self._op("head", key)
        with self._lock:
            return key in self._objects

    def list(self, prefix: str) -> list:
        self._op("list", prefix)
        prefix = prefix.rstrip("/") + "/"
        names = set()
        with self._lock:
            keys = list(self._objects)
        for k in keys:
            if k.startswith(prefix):
                names.add(k[len(prefix):].split("/")[0])
        return sorted(names)

    def delete(self, key: str):
        self._op("delete", key)
        with self._lock:
            for k in [k for k in self._objects
                      if k == key or k.startswith(key.rstrip("/") + "/")]:
                del self._objects[k]
                self._mtimes.pop(k, None)

    def mtime(self, key: str) -> float | None:
        with self._lock:
            return self._mtimes.get(key)

    # --------------------------------------------------------- multipart
    def initiate_multipart(self, key: str) -> str:
        self._op("mp_init", key)
        with self._lock:
            self._mp_seq += 1
            uid = f"mp-{self._mp_seq}"
            self._mp[uid] = {"key": key, "parts": {}}
            self.stats["mp_initiated"] += 1
        return uid

    def put_part(self, key: str, upload_id: str, idx: int, data):
        data = bytes(data)
        self._op("put_part", f"{key}#{idx}", len(data))
        with self._lock:
            if upload_id not in self._mp:
                raise IOError(f"unknown multipart upload {upload_id!r}")
            self._mp[upload_id]["parts"][int(idx)] = data
            self.stats["bytes_in"] += len(data)

    def complete_multipart(self, key: str, upload_id: str, num_parts: int):
        self._op("mp_complete", key)
        with self._lock:
            mp = self._mp.get(upload_id)
            if mp is None or mp["key"] != key:
                raise IOError(f"unknown multipart upload {upload_id!r}")
            missing = [i for i in range(num_parts) if i not in mp["parts"]]
            if missing:
                raise IOError(f"multipart {key!r} missing parts {missing}")
            self._objects[key] = b"".join(mp["parts"][i]
                                          for i in range(num_parts))
            self._mtimes[key] = self.clock.now
            del self._mp[upload_id]
            self.stats["puts"] += 1
            self.stats["mp_completed"] += 1

    def abort_multipart(self, key: str, upload_id: str):
        with self._lock:      # best-effort cleanup: never injected, free
            self._mp.pop(upload_id, None)
            self.stats["mp_aborted"] += 1

    @property
    def pending_multiparts(self) -> int:
        with self._lock:
            return len(self._mp)


class RetryPolicy:
    """Bounded retry with exponential backoff for transient store faults.

    ``attempts`` is the TOTAL number of tries; backoff between try k and
    k+1 is ``backoff_base_s * 2**k`` capped at ``backoff_max_s``, charged
    to the store's clock (virtual in tests, real wall-time only when the
    store runs ``realtime=True``). Only ``retry_on`` exceptions are
    retried; anything else (FileNotFoundError, programming errors)
    propagates immediately. Exhaustion raises ``TransferError``."""

    def __init__(self, attempts: int = 4, backoff_base_s: float = 0.01,
                 backoff_max_s: float = 1.0,
                 retry_on: tuple = (TimeoutError, IOError)):
        self.attempts = max(1, int(attempts))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        # FileNotFoundError is an OSError: a missing object is an answer,
        # not a transient fault — never retry it
        self.retry_on = tuple(retry_on)

    def call(self, op: str, key: str, fn, *, sleep, on_retry=None):
        last: BaseException | None = None
        for k in range(self.attempts):
            try:
                return fn()
            except FileNotFoundError:
                raise
            except self.retry_on as e:
                last = e
                if on_retry is not None:
                    on_retry()
                if k + 1 < self.attempts:
                    sleep(min(self.backoff_max_s,
                              self.backoff_base_s * (2 ** k)))
        raise TransferError(op, key, self.attempts, last)


class RemoteTier(Tier):
    """``Tier`` over an object store: retried ops, multipart chunk upload.

    Blobs larger than ``multipart_threshold`` upload as ``part_bytes``
    parts fanned out on the executor's transfer lanes (a pool separate
    from the chunk-I/O pool, so a chunk write that fans out its own parts
    can never deadlock the pool it runs on); smaller blobs are a single
    retried put. ``read_chunk_range`` maps to a ranged GET — lazy
    restore's byte faults cost ``length`` bytes of simulated transfer,
    not the whole chunk."""

    # shadows Tier._chunk_index via the property pair below so the index
    # can live per-tier (default) or per-STORE (shared_chunks)
    _local_chunk_index: set | None = None

    def __init__(self, store: SimulatedObjectStore, *, prefix: str = "",
                 retry: RetryPolicy | None = None,
                 part_bytes: int = 1 << 20,
                 multipart_threshold: int | None = None,
                 executor=None, shared_chunks: bool = False):
        self.store = store
        self.prefix = prefix.strip("/")
        self.shared_chunks = bool(shared_chunks)
        self.retry = retry or RetryPolicy()
        self.part_bytes = int(part_bytes)
        self.multipart_threshold = int(multipart_threshold
                                       if multipart_threshold is not None
                                       else part_bytes)
        self._executor = executor
        self.stats = {"retries": 0, "parts_uploaded": 0,
                      "multipart_uploads": 0, "singlepart_uploads": 0,
                      "delta_batches": 0, "delta_chunks": 0,
                      "delta_bytes": 0}
        self._stats_lock = threading.Lock()

    def _k(self, rel: str) -> str:
        """Store key for ``rel``. With ``shared_chunks`` the chunk pool
        and the cross-job index (``chunks/``, ``index/``) are GLOBAL —
        content addressing makes per-job copies pure waste — while
        manifests and everything else stay under the job's prefix."""
        if self.prefix and not (self.shared_chunks and (
                rel == "chunks" or rel.startswith("chunks/")
                or rel == "index" or rel.startswith("index/"))):
            return f"{self.prefix}/{rel}"
        return rel

    # ---- chunk index storage: per-store when the pool is shared, so a
    # delete_chunk through job A's alias is visible to job B's probe
    @property
    def _chunk_index(self):
        if self.shared_chunks:
            return self.store.shared_chunk_index
        return self._local_chunk_index

    @_chunk_index.setter
    def _chunk_index(self, value):
        if self.shared_chunks:
            self.store.shared_chunk_index = value
        else:
            self._local_chunk_index = value

    @property
    def _index_lock(self):
        if self.shared_chunks:
            return self.store.shared_index_lock
        return Tier._index_lock.fget(self)

    def _count(self, key: str, n: int = 1):
        with self._stats_lock:
            self.stats[key] += n

    def _call(self, op: str, rel: str, fn):
        return self.retry.call(op, rel, fn, sleep=self.store.clock.advance,
                               on_retry=lambda: self._count("retries"))

    def _lanes(self):
        if self._executor is None:
            from repro_torch.core.executor import get_default_executor
            self._executor = get_default_executor()
        return self._executor

    # ------------------------------------------------------------- writes
    def write_bytes(self, rel: str, data, atomic: bool = False):
        # object-store puts are atomic by construction (an object appears
        # whole or not at all) — the ``atomic`` commit hint costs nothing
        data = bytes(data)
        if len(data) > self.multipart_threshold:
            self._put_multipart(rel, data)
        else:
            self._call("put", rel, lambda: self.store.put(self._k(rel),
                                                          data))
            self._count("singlepart_uploads")

    def _put_multipart(self, rel: str, data: bytes):
        key = self._k(rel)
        uid = self._call("mp_init", rel,
                         lambda: self.store.initiate_multipart(key))
        view = memoryview(data)
        parts = [(i, view[off:off + self.part_bytes])
                 for i, off in enumerate(range(0, len(data),
                                               self.part_bytes))]

        def upload(part):
            i, v = part
            self._call("put_part", f"{rel}#{i}",
                       lambda: self.store.put_part(key, uid, i, v))

        try:
            futs = [self._lanes().submit_transfer(upload, p) for p in parts]
            if futs[0] is None:               # serial engine: inline
                for p in parts:
                    upload(p)
            else:
                errs = []
                for f in futs:                # drain ALL before raising —
                    try:                      # never abort under a part
                        f.result()            # still in flight
                    except BaseException as e:
                        errs.append(e)
                if errs:
                    raise errs[0]
            self._call("mp_complete", rel,
                       lambda: self.store.complete_multipart(
                           key, uid, len(parts)))
        except BaseException:
            self.store.abort_multipart(key, uid)   # atomic: all or nothing
            raise
        self._count("parts_uploaded", len(parts))
        self._count("multipart_uploads")

    def upload_delta(self, items):
        """Batched delta upload: only the chunks the dedup probe proved
        absent from the (possibly cross-job) cold index travel. Small
        chunks fan out as parallel single puts on the executor's transfer
        lanes — the same lanes multipart parts ride, under the same
        retry/backoff — while chunks above the multipart threshold run
        their own (internally parallel) multipart upload. Items already
        present (a benign race with a peer's concurrent dump) are
        skipped. Raises the first TransferError after draining in-flight
        puts — never abandons a lane mid-upload."""
        items = [(h, v) for h, v in items]
        if not items:
            return
        self._count("delta_batches")

        def put_one(h, v):
            if self.has_chunk(h):
                return
            rel = self.chunk_path(h)
            if len(v) > self.multipart_threshold:
                self._put_multipart(rel, bytes(v))
            else:
                self._call("put", rel,
                           lambda: self.store.put(self._k(rel), v))
                self._count("singlepart_uploads")
            self.note_chunk_present(h)
            self._count("delta_chunks")
            self._count("delta_bytes", len(v))

        small = [(h, v) for h, v in items
                 if len(v) <= self.multipart_threshold]
        large = [(h, v) for h, v in items
                 if len(v) > self.multipart_threshold]
        futs = [self._lanes().submit_transfer(put_one, h, v)
                for h, v in small]
        errs: list = []
        if futs and futs[0] is None:        # serial engine: inline
            for h, v in small:
                put_one(h, v)
        else:
            for f in futs:                  # drain ALL before raising
                try:
                    f.result()
                except BaseException as e:
                    errs.append(e)
        if errs:
            raise errs[0]
        for h, v in large:                  # each fans its own parts
            put_one(h, v)

    def verify_chunks(self, hashes) -> set:
        """Authoritative cross-job recheck: ONE retried list of the
        (global) pool instead of a HEAD per hash, repairing the shared
        index on the way. This is what the executor calls before
        trusting an index hit on a shared pool (TOCTOU close: probe says
        present -> a peer process's gc reaps -> restore would 404)."""
        hashes = set(hashes)
        if not hashes:
            return set()
        try:
            names = self.listdir("chunks")
        except FileNotFoundError:
            names = []
        pool = {n.removesuffix(".bin") for n in names if n.endswith(".bin")}
        present = hashes & pool
        if self._chunk_index is not None:
            with self._index_lock:
                self._chunk_index.difference_update(hashes - present)
                self._chunk_index.update(present)
        return present

    def ref_journal(self):
        # a shared pool REQUIRES refcounted gc — no opt-in to forget
        if self._ref_journal is None and self.shared_chunks:
            self.enable_ref_journal()
        return self._ref_journal

    # -------------------------------------------------------------- reads
    def read_bytes(self, rel: str) -> bytes:
        return self._call("get", rel, lambda: self.store.get(self._k(rel)))

    def read_chunk_range(self, h: str, offset: int, length: int) -> bytes:
        rel = self.chunk_path(h)
        return self._call("get", rel,
                          lambda: self.store.get_range(self._k(rel),
                                                       offset, length))

    # ----------------------------------------------------------- metadata
    def exists(self, rel: str) -> bool:
        return self._call("head", rel, lambda: self.store.head(self._k(rel)))

    def listdir(self, rel: str) -> list:
        names = self._call("list", rel,
                           lambda: self.store.list(self._k(rel)))
        if not names:
            raise FileNotFoundError(rel)
        return names

    def delete(self, rel: str):
        self._call("delete", rel, lambda: self.store.delete(self._k(rel)))

    def age_s(self, rel: str) -> float | None:
        """Age on the store's transfer clock (simulated seconds unless the
        store runs realtime). Virtual ages are tiny, so gc's wall-clock
        grace windows err on the side of keeping — the safe direction."""
        mt = self.store.mtime(self._k(rel))
        if mt is None:
            return None
        return max(0.0, self.store.clock.now - mt)

    def _guard_obj(self) -> RWGuard:
        return self.store.rw_guard      # per-store, not per-wrapper


class CachingTier(Tier):
    """Write-through cache: a hot local front over a cold (remote) back.

    * writes go to the cold layer first (durability), then the hot layer;
    * reads try hot and fill it from cold on a miss (read-through);
    * dedup probes are answered from the layers' in-memory chunk indexes
      — hot content is always a subset of cold content (writes go
      through, fills come FROM cold), so a hot hit never needs remote
      confirmation;
    * gc/retention (delete/delete_chunk) forward to both layers, and the
      write guard / chunk index live on THIS object — share one
      CachingTier between dumper, registry and peer sessions (the
      ``cache+remote://`` registry does exactly that).

    ``read_chunk_range`` serves ranges from the hot front when the chunk
    is present; the FIRST miss on a chunk stays a cheap range read (the
    latency path lazy restore exists for), and any repeat miss promotes
    the whole chunk hot — repeated faults on one chunk cost at most two
    cold reads, not one per fault.

    ``peers`` (set via ``set_peers``, ordered nearest first) are other
    hosts' HOT fronts over the same cold pool: chunk reads try hot, then
    each peer (whole-chunk fetches are verified against the content
    address; a corrupt or racing peer is skipped), then cold. The fleet
    topology wires these from its hot-inventory snapshots
    (``ClusterTopology.wire_peer_fetch``)."""

    def __init__(self, hot: Tier, cold: Tier, peers=()):
        self.hot = hot
        self.cold = cold
        self.peers = list(peers)
        self.stats = {"hot_hits": 0, "cold_reads": 0, "fills": 0,
                      "range_misses": 0, "promotions": 0,
                      "peer_hits": 0, "peer_rejects": 0}
        self._range_miss: dict = {}     # chunk hash -> ranged misses seen
        self._stats_lock = threading.Lock()

    def _count(self, key: str):
        with self._stats_lock:
            self.stats[key] += 1

    def set_peers(self, peers):
        """Replace the nearest-first peer hot-front list (tiers over the
        SAME cold pool — peer data is hash-verified, so a stale peer
        degrades to a cold read, never to wrong bytes)."""
        self.peers = list(peers)

    def _read_chunk_from_peers(self, h: str) -> bytes | None:
        """Whole-chunk fetch from the nearest peer holding ``h``, verified
        against the content address. None when no peer can serve it."""
        for peer in self.peers:
            try:
                if not peer.has_chunk(h):
                    continue
                data = peer.read_chunk(h)
            except (FileNotFoundError, OSError, KeyError):
                continue            # peer raced an eviction: next peer
            if hashlib.sha256(data).hexdigest() == h:
                self._count("peer_hits")
                return data
            self._count("peer_rejects")
        return None

    # ------------------------------------------------------------- writes
    def write_bytes(self, rel: str, data, atomic: bool = False):
        data = bytes(data)
        self.cold.write_bytes(rel, data, atomic=atomic)
        self.hot.write_bytes(rel, data, atomic=atomic)

    # -------------------------------------------------------------- reads
    def read_bytes(self, rel: str) -> bytes:
        try:
            out = self.hot.read_bytes(rel)
            self._count("hot_hits")
            return out
        except FileNotFoundError:
            pass
        h = self._as_chunk(rel)
        data = self._read_chunk_from_peers(h) if h and self.peers else None
        if data is None:
            data = self.cold.read_bytes(rel)
            self._count("cold_reads")
        self.hot.write_bytes(rel, data)          # read-through fill
        if h:                                    # keep the hot index true
            self.hot.note_chunk_present(h)
        self._count("fills")
        return data

    @staticmethod
    def _as_chunk(rel: str) -> str:
        return rel.removeprefix("chunks/").removesuffix(".bin") \
            if rel.startswith("chunks/") and rel.endswith(".bin") else ""

    def read_chunk_range(self, h: str, offset: int, length: int) -> bytes:
        if self.hot.has_chunk(h):
            self._count("hot_hits")
            return self.hot.read_chunk_range(h, offset, length)
        with self._stats_lock:
            self.stats["range_misses"] += 1
            misses = self._range_miss[h] = self._range_miss.get(h, 0) + 1
        if misses > 1:
            # repeat fault on the same chunk: promote it hot (nearest
            # peer first, else one last cold read) so every further
            # fault is a local range — a chunk costs at most two cold
            # reads under any fault pattern, never one per fault
            data = self._read_chunk_from_peers(h) if self.peers else None
            if data is None:
                data = self.cold.read_chunk(h)
                self._count("cold_reads")
            self.hot.write_chunk(h, data)
            self._count("promotions")
            return bytes(data[offset:offset + length])
        # first fault: stay on the cheap ranged path (transferring the
        # whole chunk here is exactly what lazy restore exists to avoid)
        for peer in self.peers:
            try:
                if peer.has_chunk(h):
                    out = peer.read_chunk_range(h, offset, length)
                    self._count("peer_hits")
                    return out
            except (FileNotFoundError, OSError, KeyError):
                continue
        self._count("cold_reads")
        return self.cold.read_chunk_range(h, offset, length)

    # ----------------------------------------------------------- metadata
    def exists(self, rel: str) -> bool:
        return self.hot.exists(rel) or self.cold.exists(rel)

    def listdir(self, rel: str) -> list:
        names, hits = set(), 0
        for layer in (self.hot, self.cold):
            try:
                names.update(layer.listdir(rel))
                hits += 1
            except FileNotFoundError:
                pass
        if not hits:
            raise FileNotFoundError(rel)
        return sorted(names)

    def delete(self, rel: str):
        self.hot.delete(rel)
        self.cold.delete(rel)

    def age_s(self, rel: str) -> float | None:
        age = self.cold.age_s(rel)
        return age if age is not None else self.hot.age_s(rel)

    # -------------------------------------------------------- chunk index
    def enable_chunk_index(self):
        self.hot.enable_chunk_index()
        self.cold.enable_chunk_index()
        return self

    def chunk_index_enabled(self) -> bool:
        return (self.hot.chunk_index_enabled()
                and self.cold.chunk_index_enabled())

    def chunk_index_snapshot(self) -> frozenset | None:
        # what makes this host WARM is the hot front — that is the
        # inventory restore placement wants, not the cold pool (which
        # every host can reach at remote cost)
        return self.hot.chunk_index_snapshot()

    def has_chunk(self, h: str) -> bool:
        if self.cold.chunk_index_enabled():
            return self.cold.has_chunk(h)
        return self.hot.has_chunk(h) or self.cold.has_chunk(h)

    def has_chunks(self, hashes) -> set:
        """Dedup probe without remote round trips. When the cold layer
        has its in-memory index loaded it is the authoritative answer (a
        set lookup — and immune to a peer alias of the same store having
        gc'd a chunk this cache's hot front still holds); otherwise a hot
        hit is sound by the hot-subset-of-cold invariant and saves a
        remote HEAD per chunk."""
        if self.cold.chunk_index_enabled():
            return self.cold.has_chunks(hashes)
        present = self.hot.has_chunks(hashes)
        rest = set(hashes) - present
        if rest:
            present = present | self.cold.has_chunks(rest)
        return present

    def note_chunk_present(self, h: str):
        if h:
            self.hot.note_chunk_present(h)
            self.cold.note_chunk_present(h)

    def write_chunk(self, h: str, data):
        # per-layer dedup: a chunk already cold but evicted from hot is
        # re-pinned hot without a second remote upload
        self.cold.write_chunk(h, data)
        self.hot.write_chunk(h, data)

    def upload_delta(self, items):
        """Batched absent-chunk upload through the cold layer's delta
        path (transfer-lane fan-out when it has one), write-through to
        the hot front."""
        items = list(items)
        up = getattr(self.cold, "upload_delta", None)
        if up is not None:
            up(items)
        else:
            self.cold.write_chunks(items)
        self.hot.write_chunks(items)

    def delete_chunk(self, h: str):
        self.hot.delete_chunk(h)
        self.cold.delete_chunk(h)

    # ---------------------------------------------- cross-job delegation
    @property
    def shared_chunks(self) -> bool:
        return bool(getattr(self.cold, "shared_chunks", False))

    def verify_chunks(self, hashes) -> set:
        """Cold is authoritative; a chunk the recheck disproves is also
        dropped from the hot front (keeps hot-subset-of-cold true after
        a foreign gc)."""
        present = self.cold.verify_chunks(hashes)
        for h in set(hashes) - present:
            if self.hot.has_chunk(h):
                self.hot.delete_chunk(h)
        return present

    def ref_journal(self):
        return self.cold.ref_journal()

    def enable_ref_journal(self):
        return self.cold.enable_ref_journal()

    def _guard_obj(self):
        # gc through this cache and gc/dump through any other alias of
        # the cold pool must exclude each other — the guard lives with
        # the cold (authoritative) layer
        return self.cold._guard_obj()


# --------------------------------------------------------------------- URIs
# process-local registries, mem://-style: the same URI names the SAME
# store/tier object on every resolution, so sessions, registries and gc
# share one chunk index and one write guard (see storage.Tier.writer)
_STORES: dict = {}
_TIERS: dict = {}
_REG_LOCK = threading.Lock()


def _q(params: dict, key: str, cast, default):
    if key not in params:
        return default
    return cast(params[key][-1])


def get_store(name: str, *, network: NetworkModel | None = None,
              faults: FaultPolicy | None = None,
              realtime: bool = False) -> SimulatedObjectStore:
    """The named process-local object store (created on first use —
    network/fault/clock models apply only at creation; later callers get
    the existing store unchanged, so a late ``realtime=`` can never flip
    an in-use virtual clock into wall-clock sleeps)."""
    with _REG_LOCK:
        if name not in _STORES:
            store = SimulatedObjectStore(network=network, faults=faults,
                                         name=name)
            store.clock.realtime = bool(realtime)
            _STORES[name] = store
        return _STORES[name]


def registered_tiers() -> dict:
    """Public snapshot of the live remote-tier registrations:
    ``"remote://name"`` / ``"cache+remote://name?front=host3"`` -> Tier.
    The fleet topology model enumerates a process's tier registrations
    through ``storage.registered_tiers()`` (which merges this with the
    mem:// registry) instead of poking the private dicts."""
    out = {}
    with _REG_LOCK:
        items = list(_TIERS.items())
    for (scheme, name, front, prefix, shared), tier in items:
        qs = [f"{k}={v}" for k, v in (("front", front), ("prefix", prefix),
                                      ("shared", int(shared) or ""))
              if v]
        uri = f"{scheme}://{name}" + ("?" + "&".join(qs) if qs else "")
        out[uri] = tier
    return out


def tier_from_uri(scheme: str, rest: str) -> Tier:
    """Resolve ``remote://`` / ``cache+remote://`` URIs (called by
    ``storage.as_tier``). Query parameters configure the simulation and
    the transfer path, applied on FIRST resolution of a given
    (scheme, store name):

      latency_ms=, bw_mbps=        NetworkModel (per request / connection)
      agg_mbps=, knee=, penalty=   shared aggregate bandwidth cap +
                                   overload knee/penalty (fleet-scale
                                   saturation; see NetworkModel)
      fail_rate=, max_consecutive=, fixed_failures=, seed=   FaultPolicy
      realtime=1                   clock sleeps (benchmarks only)
      attempts=, backoff_ms=, backoff_max_ms=                RetryPolicy
      part_kb=, threshold_kb=      multipart geometry
      cache=<path>                 cache+remote only: LocalDirTier front
                                   at <path> (default: in-memory front)
      front=<name>                 cache+remote only: NAMED hot front —
                                   distinct fronts over one shared cold
                                   store, so every fleet host gets its
                                   own hot cache while dedup/gc stay
                                   coordinated on the store's guard
      prefix=<ns>                  key namespace inside the store: many
                                   jobs share ONE store (one network, one
                                   aggregate-bandwidth pool) without
                                   image-id collisions — a fleet's whole
                                   point of contention
      shared=1                     content-addressed CROSS-JOB pool: the
                                   chunk namespace (and the refcount
                                   journal under index/) is global even
                                   under prefix= — every job dedups
                                   against every other job's chunks, gc
                                   goes through the refcount journal
                                   (core/chunkindex.py), and the chunk
                                   index lives on the store so all
                                   aliases share one truth

    The registry key is (scheme, store name, front, prefix, shared) — NOT the
    full URI — so ``remote://ck`` and ``remote://ck?attempts=6`` are the
    SAME tier object (later params are ignored, like get_store's models),
    and ``cache+remote://ck`` wraps the very RemoteTier ``remote://ck``
    resolves to: all aliases of one store share one chunk index and one
    writer/reaper guard, which is what keeps a peer's gc out from under
    an in-flight dump. ``front=`` variants are distinct CachingTier
    objects (their OWN hot cache) over that one shared cold tier."""
    name, _, query = rest.partition("?")
    name = name.strip("/")
    params = parse_qs(query) if query else {}
    front = _q(params, "front", str, "") if scheme == "cache+remote" else ""
    prefix = _q(params, "prefix", str, "")
    shared = bool(_q(params, "shared", int, 0))
    key = (scheme, name, front, prefix, shared)
    with _REG_LOCK:
        if key in _TIERS:
            return _TIERS[key]
    if scheme == "cache+remote":
        remote = tier_from_uri("remote", rest)
        cache = _q(params, "cache", str, "")
        hot = LocalDirTier(cache, fsync=False) if cache else MemoryTier()
        tier: Tier = CachingTier(hot, remote)
    else:
        network = NetworkModel(
            latency_s=_q(params, "latency_ms", float, 0.0) / 1e3,
            bandwidth_bps=_q(params, "bw_mbps", float, 0.0) * 1e6 or None,
            aggregate_bps=_q(params, "agg_mbps", float, 0.0) * 1e6 or None,
            overload_conns=_q(params, "knee", int, 0),
            overload_penalty=_q(params, "penalty", float, 1.0))
        faults = FaultPolicy(
            seed=_q(params, "seed", int, 0),
            fail_rate=_q(params, "fail_rate", float, 0.0),
            max_consecutive=_q(params, "max_consecutive", int, 1),
            fixed_failures=_q(params, "fixed_failures", int, None))
        store = get_store(name, network=network, faults=faults,
                          realtime=bool(_q(params, "realtime", int, 0)))
        retry = RetryPolicy(
            attempts=_q(params, "attempts", int, 4),
            backoff_base_s=_q(params, "backoff_ms", float, 10.0) / 1e3,
            backoff_max_s=_q(params, "backoff_max_ms", float, 1000.0) / 1e3)
        part_kb = _q(params, "part_kb", int, 1024)
        thresh_kb = _q(params, "threshold_kb", int, part_kb)
        tier = RemoteTier(store, prefix=prefix, retry=retry,
                          part_bytes=part_kb << 10,
                          multipart_threshold=thresh_kb << 10,
                          shared_chunks=shared)
    with _REG_LOCK:
        return _TIERS.setdefault(key, tier)


def reset_tier_registry():
    """TESTING ONLY: forget every registered store/tier so a fresh
    scenario can reuse URI names without inheriting a prior network or
    fault model. Live references to the old tiers keep working — only
    the name->object mapping is cleared."""
    with _REG_LOCK:
        _STORES.clear()
        _TIERS.clear()
