"""Storage tiers for checkpoint images.

Layout (content-addressed, CRIU page-server/parent-image analogue):

  <root>/chunks/<sha256>.bin        shared deduplicated chunk pool
  <root>/images/<image_id>/manifest.json

Chunk writes are idempotent (content addressing); the manifest is committed
last via tmp+fsync+rename — a crash mid-dump leaves only unreferenced chunks
(collected by registry.gc()), never a torn image.

Dedup probes: every tier supports batched membership tests (``has_chunks``)
and an opt-in in-memory chunk index (``enable_chunk_index``) loaded with one
``listdir`` so incremental dumps stop paying one ``exists`` stat per chunk.
The index is a cache owned by the writer: it stays correct as long as all
chunk deletions on this tier instance go through ``delete_chunk`` (which is
what ``Registry.gc`` does) — share one tier object between the dumper and
its registry rather than constructing two over the same root. In-process
sharers of one tier OBJECT (mem://, remote://, cache+remote:// URIs all
resolve to one object per process) are further protected by the
writer/reaper guard below: gc waits out in-flight dumps instead of racing
them. Running gc from a *different* tier instance or another process over
the same root remains unsafe (the same gc-vs-dedup race existed in the
per-chunk-stat engine, just with a narrower window; see DESIGN.md §4/§8)."""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

_LOCK_INIT = threading.Lock()


class RWGuard:
    """Writers-vs-reaper lock for a storage namespace. Dumps hold the
    shared ``writing`` side across their probe->write->commit window; gc
    holds the exclusive ``reap`` side. One guard per backing STORE, not
    per tier wrapper — every tier object addressing the same pool must
    coordinate on the same guard (see Tier._guard_obj)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.writers = 0
        self.reaping = False

    @contextmanager
    def writing(self):
        with self.cond:
            while self.reaping:
                self.cond.wait()
            self.writers += 1
        try:
            yield self
        finally:
            with self.cond:
                self.writers -= 1
                self.cond.notify_all()

    @contextmanager
    def reap(self):
        with self.cond:
            while self.writers > 0 or self.reaping:
                self.cond.wait()
            self.reaping = True
        try:
            yield self
        finally:
            with self.cond:
                self.reaping = False
                self.cond.notify_all()


class Tier:
    """Abstract tier. rel paths use '/'. Subclasses are not required to
    call super().__init__() — index state defaults live on the class and
    the lock is created lazily."""

    _chunk_index: set | None = None
    _chunk_index_lock: threading.Lock | None = None
    _rw_guard: RWGuard | None = None
    _ref_journal = None
    # True on tiers whose chunk pool is shared ACROSS jobs (the
    # content-addressed cross-job store: remote://...?shared=1). The
    # executor treats a shared pool's index hits as claims to recheck,
    # not facts — see verify_chunks and core/executor.py.
    shared_chunks: bool = False

    @property
    def _index_lock(self) -> threading.Lock:
        if self._chunk_index_lock is None:
            with _LOCK_INIT:
                if self._chunk_index_lock is None:
                    self._chunk_index_lock = threading.Lock()
        return self._chunk_index_lock

    # ---- write guard (in-process shared-tier coordination)
    # A dump writes chunks BEFORE the manifest that references them, so a
    # concurrent gc on the same pool cannot tell an in-flight dump's
    # chunks from garbage. In-process sharers (mem://, remote://,
    # cache+remote:// URIs resolve to one tier object per process, and
    # tiers that WRAP another namespace delegate _guard_obj to it, so
    # every alias of one pool shares one guard) coordinate here: dump()
    # holds the shared side for its whole probe->write->commit window,
    # Registry.gc() takes the exclusive side. Cross-process writers on a
    # shared filesystem remain the documented caveat above.
    def _guard_obj(self) -> RWGuard:
        """The RWGuard for this tier's backing pool. Default: one per
        tier object (lazy). RemoteTier delegates to its store's guard,
        CachingTier to its cold layer's, so remote://ck and
        cache+remote://ck — distinct tier objects over one store —
        cannot run gc under each other's in-flight dumps."""
        if self._rw_guard is None:
            with _LOCK_INIT:
                if self._rw_guard is None:
                    self._rw_guard = RWGuard()
        return self._rw_guard

    def writer(self):
        """Shared lock for a dump's probe->write->commit window."""
        return self._guard_obj().writing()

    def reaper(self):
        """Exclusive lock for gc: waits out in-flight dumps, blocks new
        ones while chunks are being reaped."""
        return self._guard_obj().reap()

    def write_bytes(self, rel: str, data, atomic: bool = False):
        raise NotImplementedError

    def read_bytes(self, rel: str) -> bytes:
        raise NotImplementedError

    def exists(self, rel: str) -> bool:
        raise NotImplementedError

    def listdir(self, rel: str) -> list:
        raise NotImplementedError

    def delete(self, rel: str):
        raise NotImplementedError

    def age_s(self, rel: str) -> float | None:
        """Seconds since ``rel`` was last modified, or None when the tier
        can't tell (gc then errs on the side of keeping the entry)."""
        return None

    # ---- layout helpers
    def chunk_path(self, h: str) -> str:
        return f"chunks/{h}.bin"

    def manifest_path(self, image_id: str) -> str:
        return f"images/{image_id}/manifest.json"

    # ---- chunk index cache
    def enable_chunk_index(self):
        """Load (once) an in-memory set of pool hashes; afterwards
        has_chunk/has_chunks are set lookups instead of stat probes."""
        with self._index_lock:
            if self._chunk_index is None:
                try:
                    names = self.listdir("chunks")
                except FileNotFoundError:
                    names = []
                self._chunk_index = {n.removesuffix(".bin") for n in names}
        return self

    def chunk_index_enabled(self) -> bool:
        return self._chunk_index is not None

    def chunk_index_snapshot(self) -> frozenset | None:
        """Point-in-time copy of the in-memory chunk index, or None until
        ``enable_chunk_index`` has run. The fleet placement planner scores
        hosts by these snapshots (hot-front inventory) without issuing a
        single storage op."""
        if self._chunk_index is None:
            return None
        with self._index_lock:
            return frozenset(self._chunk_index)

    def has_chunk(self, h: str) -> bool:
        if self._chunk_index is not None:
            with self._index_lock:
                return h in self._chunk_index
        return self.exists(self.chunk_path(h))

    def has_chunks(self, hashes) -> set:
        """Batched membership probe -> subset of ``hashes`` present."""
        if self._chunk_index is not None:
            with self._index_lock:
                return self._chunk_index.intersection(hashes)
        return {h for h in hashes if self.exists(self.chunk_path(h))}

    def verify_chunks(self, hashes) -> set:
        """Authoritative presence recheck: bypass the in-memory index and
        ask the backing storage which of ``hashes`` actually exist,
        repairing the index on the way (stale entries dropped, confirmed
        ones kept). This is the executor's cheap existence recheck before
        trusting a cross-job dedup hit — on a shared pool a peer's gc in
        another process may have reaped a chunk the index still lists."""
        present = {h for h in hashes
                   if self.exists(self.chunk_path(h))}
        if self._chunk_index is not None:
            with self._index_lock:
                self._chunk_index.difference_update(set(hashes) - present)
                self._chunk_index.update(present)
        return present

    # ---- cross-job refcount journal (the JAX package's core/chunkindex.py)
    def ref_journal(self):
        """The RefJournal for this tier's pool: always None until
        core/chunkindex.py is ported."""
        return self._ref_journal

    def enable_ref_journal(self):
        """Cross-job refcount journals are not ported yet."""
        raise NotImplementedError(
            "cross-job refcount journals (core/chunkindex.py) are not "
            "ported to repro_torch yet")

    def write_chunk(self, h: str, data):
        if not self.has_chunk(h):  # dedup
            self.write_bytes(self.chunk_path(h), data)
            self.note_chunk_present(h)

    def write_chunks(self, items):
        """Batched chunk write: iterable of (hash, bytes-like)."""
        for h, data in items:
            self.write_chunk(h, data)

    def delete_chunk(self, h: str):
        self.delete(self.chunk_path(h))
        if self._chunk_index is not None:
            with self._index_lock:
                self._chunk_index.discard(h)

    def note_chunk_present(self, h: str):
        """Record that chunk ``h`` now exists in the pool (index upkeep for
        out-of-band writes, e.g. replica repair)."""
        if self._chunk_index is not None:
            with self._index_lock:
                self._chunk_index.add(h)

    def read_chunk(self, h: str) -> bytes:
        return self.read_bytes(self.chunk_path(h))

    def read_chunk_range(self, h: str, offset: int, length: int) -> bytes:
        """Read ``length`` bytes of chunk ``h`` starting at ``offset`` —
        the page-server primitive behind lazy leaf-range reads. Base
        implementation reads the whole chunk and slices; tiers with
        seekable storage override (LocalDirTier uses pread-style seeks, so
        serving the first KB of a 4 MiB chunk costs a KB of I/O, not
        4 MiB). NOTE: a range of a chunk cannot be hash-verified against
        the chunk's content address — range reads trade verification for
        latency; LeafServer.get() (whole-leaf faults) stays verified."""
        return self.read_chunk(h)[offset:offset + length]

    def image_ids(self) -> list:
        try:
            return sorted(self.listdir("images"))
        except FileNotFoundError:
            return []


class LocalDirTier(Tier):
    """POSIX directory tier (local disk or a mounted network FS).

    fsync modes: True (every file — strongest), "commit" (only commit-point
    writes, i.e. manifests; chunk durability relies on FS write-back
    ordering/journal barriers — the usual production trade), False (none;
    tests / throwaway tiers)."""

    def __init__(self, root: str, fsync=True, write_latency_s: float = 0.0):
        self.root = root
        self.fsync = fsync
        self.write_latency_s = write_latency_s  # remote-FS emulation knob
        self.stat_calls = 0  # exists() probes (dedup-cost observability)
        os.makedirs(root, exist_ok=True)

    def _p(self, rel: str) -> str:
        return os.path.join(self.root, *rel.split("/"))

    def write_bytes(self, rel: str, data, atomic: bool = False):
        if self.write_latency_s:
            time.sleep(self.write_latency_s)
        p = self._p(rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + f".tmp.{os.getpid()}.{threading.get_ident()}"
        do_sync = self.fsync is True or (self.fsync == "commit" and atomic)
        with open(tmp, "wb") as f:
            f.write(data)
            if do_sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, p)  # atomic on POSIX

    def read_bytes(self, rel: str) -> bytes:
        with open(self._p(rel), "rb") as f:
            return f.read()

    def exists(self, rel: str) -> bool:
        self.stat_calls += 1
        return os.path.exists(self._p(rel))

    def age_s(self, rel: str) -> float | None:
        try:
            return max(0.0, time.time() - os.path.getmtime(self._p(rel)))
        except OSError:
            return None

    def read_chunk_range(self, h: str, offset: int, length: int) -> bytes:
        with open(self._p(self.chunk_path(h)), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def listdir(self, rel: str) -> list:
        return os.listdir(self._p(rel))

    def delete(self, rel: str):
        p = self._p(rel)
        if os.path.isdir(p):
            import shutil
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


class MemoryTier(Tier):
    """In-process tier — the CRIU 'page server' analogue. Used as the fast
    first hop for async dumps and as a test double."""

    def __init__(self):
        self.blobs: dict = {}
        self._blobs_lock = threading.Lock()

    def write_bytes(self, rel: str, data, atomic: bool = False):
        with self._blobs_lock:
            self.blobs[rel] = bytes(data)

    def read_bytes(self, rel: str) -> bytes:
        with self._blobs_lock:
            if rel not in self.blobs:
                raise FileNotFoundError(rel)
            return self.blobs[rel]

    def exists(self, rel: str) -> bool:
        with self._blobs_lock:
            return rel in self.blobs

    def listdir(self, rel: str) -> list:
        rel = rel.rstrip("/") + "/"
        names = set()
        with self._blobs_lock:
            keys = list(self.blobs)
        for k in keys:
            if k.startswith(rel):
                names.add(k[len(rel):].split("/")[0])
        if not names:
            raise FileNotFoundError(rel)
        return sorted(names)

    def read_chunk_range(self, h: str, offset: int, length: int) -> bytes:
        """Sliced range read off the stored blob. The base implementation
        routes through read_chunk() and slices a copy of the whole chunk;
        here a lazy byte fault over mem:// copies ``length`` bytes, not
        the chunk (4 MiB default) it lives in."""
        rel = self.chunk_path(h)
        with self._blobs_lock:
            blob = self.blobs.get(rel)
        if blob is None:
            raise FileNotFoundError(rel)
        return blob[offset:offset + length]

    def delete(self, rel: str):
        with self._blobs_lock:
            for k in [k for k in self.blobs
                      if k == rel or k.startswith(rel.rstrip("/") + "/")]:
                del self.blobs[k]


# process-local registry of named in-memory tiers: "mem://scratch" names
# the SAME tier object on every resolution, so a dump through one session
# round-trips through a restore in another (the CRIU page-server analogue
# addressed like any other storage location)
_MEM_TIERS: dict = {}
_MEM_TIERS_LOCK = threading.Lock()

TIER_SCHEMES = ("file", "mem", "remote", "cache+remote")


def as_tier(t) -> Tier:
    """Resolve a tier reference: a Tier instance passes through; a string
    (or PathLike) is interpreted as

      file:///abs/path | file://rel/path   explicit local-directory tier
      mem://<name>                         process-local in-memory tier
                                           (same name -> same tier object)
      plain path                           local-directory tier (back-compat)

    remote:// and cache+remote:// (the JAX package's core/remote.py) are
    not ported yet and raise NotImplementedError.

    An unknown ``scheme://`` is an error — previously a typo'd URI such as
    ``s3://bucket/ck`` silently became a LocalDirTier at ``./s3:/bucket/ck``
    under the cwd, and the job "checkpointed" into a directory nobody would
    ever restore from."""
    if isinstance(t, Tier):
        return t
    s = os.fspath(t) if hasattr(t, "__fspath__") else str(t)
    if "://" in s:
        scheme, _, rest = s.partition("://")
        if scheme == "file":
            return LocalDirTier(rest or ".")
        if scheme == "mem":
            name = rest.strip("/")
            with _MEM_TIERS_LOCK:
                if name not in _MEM_TIERS:
                    _MEM_TIERS[name] = MemoryTier()
                return _MEM_TIERS[name]
        if scheme in ("remote", "cache+remote"):
            raise NotImplementedError(
                f"{scheme}:// tiers (core/remote.py) are not ported to "
                f"repro_torch yet; use file:// or mem://")
        raise ValueError(
            f"unknown tier URI scheme {scheme!r} in {s!r}; supported "
            f"schemes: {', '.join(f'{x}://' for x in TIER_SCHEMES)} "
            f"(or a plain filesystem path)")
    return LocalDirTier(s)
