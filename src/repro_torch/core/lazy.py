"""Lazy (post-copy) restore: CRIU lazy-pages at leaf granularity.

Ported from the JAX package's core/lazy.py. Eager restore pays the whole
image transfer before the job touches a single weight. CRIU's `lazy-pages`
daemon inverts that: the process resumes immediately and faulting pages
are served over the page-server protocol on first access. This module is
that inversion for checkpoints of nested dicts of tensors:

  * ``LeafServer`` — the page-server analogue: serves decoded leaves (and
    raw leaf byte ranges, via ``Tier.read_chunk_range``) from the
    content-addressed chunk pool on demand, memoized, with chunk hashes
    verified and replica repair exactly like the eager path (it shares the
    executor's leaf resolver). A served leaf is placed the way the eager
    restore places it: a tensor on the session's device (delta8 leaves
    stay where K3 decoded them).
  * ``LazyState`` — a dict-shaped view of the checkpoint: the *skeleton*
    (tree structure, dtypes, shapes) exists immediately; indexing into a
    leaf faults its bytes in; ``materialize()`` forces the rest and
    returns a plain nested dict of tensors.
  * background prefetch in ``prefetch_order`` (defaults to the restore
    plan's hint: params before optimizer moments), so first-access faults
    usually hit leaves the prefetcher already landed.

The trade is explicit: per-leaf chunk reads are still hash-verified, but
the whole-tree digest check (migration's bit-identity proof) only happens
once everything has materialized — a lazily restored job starts fast and
finishes verifying late, exactly like CRIU's post-copy migration. The
check hashes the decoded leaves as the resolver produced them (host
arrays), the bytes the eager path checks, not a read-back from the card.

Prefetch workers upload on the executor's cpu pool. Each upload records a
CUDA event on the worker's stream, and ``get`` makes the caller's current
stream wait on it, so a prefetched tensor is complete before the caller's
next kernel reads it, whatever stream that kernel runs on."""
from __future__ import annotations

import threading
from collections.abc import Mapping
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core.chunking import chunk_offsets
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.plan import plan_restore
from repro_torch.core.restore import latest_image_id
from repro_torch.core.storage import as_tier
from repro_torch.device import resolve_device, to_device, to_host


class LeafServer:
    """Serve one image's leaves on demand from the chunk pool.

    Wraps the CheckpointExecutor's memoized leaf resolver (same chunk
    verification, replica repair, and delta8 parent-chain handling as an
    eager restore), places each leaf on ``device`` once, adds background
    prefetch and byte-range reads, and counts what was faulted vs
    prefetched.

    Example::

        plan = plan_restore(tier, image_id)
        srv = LeafServer(tier, plan, device="cuda")
        srv.prefetch()                      # background, plan's hint order
        w = srv.get("params/w")             # block only for this leaf
    """

    def __init__(self, tier, plan, *, replicas=(),
                 executor: CheckpointExecutor | None = None,
                 expected_digest: str | None = None, device="cuda"):
        self.tier = as_tier(tier)
        self.replicas = [as_tier(r) for r in replicas]
        self.plan = plan
        self.device = resolve_device(device)
        self.executor = executor or get_default_executor()
        self._resolve = self.executor.make_leaf_resolver(
            plan, self.tier, self.replicas, self.device)
        self._records = plan.records[plan.image_id]
        self._lock = threading.Lock()
        self._placed: dict = {}        # path -> Future of (tensor, event)
        self._served: set = set()      # paths resolved (fault or prefetch)
        self._prefetching: dict = {}   # path -> Future (in flight)
        # whole-tree digest the image's migration record promised (None:
        # none recorded / verification waived); checked by
        # verify_tree_digest() and automatically by a full materialize()
        self.expected_digest = expected_digest
        self._verified = None          # the expected digest last proven
        self.stats = {"faults": 0, "prefetched": 0, "bytes_served": 0}

    # ------------------------------------------------------------- inventory
    def paths(self) -> list:
        """Every leaf path this server can produce, in manifest order."""
        return [r["path"] for r in self.plan.manifest["leaves"]]

    def record(self, path: str) -> dict:
        """The manifest leaf record (dtype/shape/chunks/codec) — the
        skeleton entry, available without touching chunk data."""
        return self._records[path]

    def logical_struct(self, path: str) -> tuple:
        """(dtype_str, shape) of the DECODED leaf — codec-aware (a bf16 or
        delta8 record stores transformed bytes, but decodes to this)."""
        rec = self._records[path]
        if rec["codec"] != "none" and rec["codec_meta"].get("applied"):
            return (rec.get("orig_dtype", rec["dtype"]),
                    tuple(rec["codec_meta"].get("orig_shape",
                                                rec.get("orig_shape",
                                                        rec["shape"]))))
        return rec["dtype"], tuple(rec["shape"])

    # ----------------------------------------------------------------- serve
    def _place(self, path: str) -> tuple:
        """Resolve + place one leaf, once per path (the first caller does
        the work, later ones wait on its future) -> (tensor, event): the
        event marks the upload on the placing thread's stream (None off
        the card)."""
        with self._lock:
            fut = self._placed.get(path)
            mine = fut is None
            if mine:
                fut = self._placed[path] = Future()
        if not mine:
            return fut.result()
        try:
            t = to_device(self._resolve(self.plan.image_id, path),
                          self.device)
            if t.device.type == "cpu":
                # from_numpy aliases the resolver's memo, which the
                # deferred digest hashes: a job that updates its state in
                # place must not change those bytes
                t = t.clone()
            ev = None
            if t.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
        except BaseException as e:
            fut.set_exception(e)
            raise
        fut.set_result((t, ev))
        return t, ev

    def _note(self, path: str, t: torch.Tensor, key: str):
        with self._lock:
            if path not in self._served:
                self._served.add(path)
                self.stats[key] += 1
                self.stats["bytes_served"] += t.numel() * t.element_size()

    def get(self, path: str) -> torch.Tensor:
        """Fault one leaf in (blocking): verified chunk reads -> decode ->
        placement on the device, memoized. A second get() of the same path
        is a cache hit. The caller's current stream waits for the upload."""
        if path not in self._records:
            raise KeyError(path)
        t, ev = self._place(path)
        if ev is not None:
            torch.cuda.current_stream(t.device).wait_event(ev)
        self._note(path, t, "faults")
        return t

    def read_range(self, path: str, offset: int = 0,
                   length: int | None = None) -> bytes:
        """Bytes [offset, offset+length) of the decoded leaf buffer.

        For raw ("none"-codec) leaves this reads ONLY the chunks that
        overlap the range — true page-server behavior: the first KB of a
        huge frozen embedding table costs a KB of I/O (``read_chunk_range``
        seeks within the chunk file), not the whole leaf. Codec-applied
        leaves can't be partially decoded, so they fault fully and slice
        (range reads of raw chunk windows also skip per-chunk hash
        verification — use get() when integrity matters more than
        latency)."""
        rec = self._records[path]
        if rec["codec"] != "none" and rec["codec_meta"].get("applied"):
            data = np.ascontiguousarray(to_host(self.get(path)))
            view = memoryview(data).cast("B")
            end = len(view) if length is None else offset + length
            return bytes(view[offset:end])
        total = int(rec["nbytes"])
        end = total if length is None else min(total, offset + length)
        if offset >= end:
            return b""
        out = []
        # chunk_offsets handles both geometries: the fixed chunk_bytes
        # grid and cdc records' explicit per-chunk sizes
        for h, (c0, c1) in zip(rec["chunks"], chunk_offsets(rec)):
            if c1 <= offset:
                continue
            if c0 >= end:
                break
            lo = max(offset, c0)
            out.append(self.tier.read_chunk_range(h, lo - c0,
                                                  min(end, c1) - lo))
        return b"".join(out)

    # -------------------------------------------------------------- prefetch
    def prefetch(self, order=None) -> int:
        """Start background fetches (cpu-pool fan-out; inline on a serial
        engine) for ``order`` — path names or prefixes — falling back to
        the restore plan's hint. Returns how many leaves were enqueued.
        Already-served / already-enqueued leaves are skipped."""
        want = self._expand(order)
        n = 0
        for path in want:
            with self._lock:
                if path in self._served or path in self._prefetching:
                    continue
                # submit under the lock so drain() can never observe a
                # claimed-but-futureless entry (the worker's own stats
                # update blocks on this lock until we release — fine, we
                # never wait on the future while holding it)
                fut = self.executor.submit_cpu(self._prefetch_one, path)
                if fut is not None:
                    self._prefetching[path] = fut
            n += 1
            if fut is None:            # serial engine: fetch inline now
                self._prefetch_one(path)
        return n

    def _prefetch_one(self, path):
        t, _ = self._place(path)
        self._note(path, t, "prefetched")

    def _expand(self, order) -> list:
        if order is None:
            return list(self.plan.prefetch_order)
        out, seen = [], set()
        for hint in order:
            for p in self.paths():
                if (p == hint or p.startswith(hint.rstrip("/") + "/")) \
                        and p not in seen:
                    seen.add(p)
                    out.append(p)
        return out

    def drain(self):
        """Block until every in-flight prefetch has landed (errors from
        prefetched leaves surface here or on the leaf's own get())."""
        while True:
            with self._lock:
                futs = list(self._prefetching.values())
                self._prefetching = {}
            if not futs:
                return
            for f in futs:
                f.result()

    @property
    def remaining(self) -> int:
        """Leaves not yet served — 0 means fully materialized."""
        with self._lock:
            return len(self._records) - len(self._served)

    # ------------------------------------------------------------ integrity
    def verify_tree_digest(self) -> bool | None:
        """The deferred half of the post-copy trade: resolve every leaf
        (if not already resolved) and check the whole-tree digest against
        ``expected_digest`` (the migration record's bit-identity promise).
        It hashes the decoded leaves as the resolver returns them — the
        bytes the eager path checks before placement. Returns None when no
        digest was recorded, True on match, and raises CorruptionError on
        mismatch — same outcome the eager restore path produces before
        device placement, just later. The decoded leaves are private to
        the server (served CPU tensors are copies), so a digest once
        proven is not hashed again."""
        if not self.expected_digest:
            return None
        if self._verified == self.expected_digest:
            return True
        from repro_torch.core.integrity import CorruptionError, tree_digest
        got = tree_digest((p, self._resolve(self.plan.image_id, p))
                          for p in self._records)
        if got != self.expected_digest:
            raise CorruptionError(
                self.plan.image_id,
                [f"state digest {got[:12]} != recorded "
                 f"{self.expected_digest[:12]}"])
        self._verified = got
        return True


class LazyState(Mapping):
    """Dict-shaped lazy view over a LeafServer.

    The structure (keys, nesting) is built from manifest paths alone, so
    it exists before any chunk is read; indexing down to a leaf faults
    that leaf in. It is a Mapping — iteration and ``len`` work without
    materializing: call ``materialize()`` to get a plain nested dict of
    tensors.

    Example::

        state = lazy_restore(tier, device="cuda").state
        state["params"]["w"]        # faults exactly this leaf
        full = state.materialize()  # plain dict, every leaf resolved
    """

    def __init__(self, server: LeafServer, _node: dict | None = None,
                 _prefix: str = ""):
        self._server = server
        self._prefix = _prefix
        if _node is None:
            _node = {}
            for path in server.paths():
                parts = path.split("/")
                cur = _node
                for p in parts[:-1]:
                    cur = cur.setdefault(p, {})
                cur[parts[-1]] = path
        self._node = _node

    @property
    def server(self) -> LeafServer:
        """The LeafServer behind this view — public access to paths(),
        remaining, stats and prefetch() for progress reporting."""
        return self._server

    def __getitem__(self, key):
        v = self._node[key]
        if isinstance(v, dict):
            return LazyState(self._server, _node=v,
                             _prefix=f"{self._prefix}{key}/")
        return self._server.get(v)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)

    def __repr__(self):
        return (f"LazyState({self._prefix or '/'!r}, "
                f"{len(self._node)} children, "
                f"{self._server.remaining} leaves unmaterialized)")

    def peek(self, key):
        """Skeleton inspection without faulting: a nested LazyState for
        subtrees, or (dtype, shape) for a leaf."""
        v = self._node[key]
        if isinstance(v, dict):
            return LazyState(self._server, _node=v,
                             _prefix=f"{self._prefix}{key}/")
        return self._server.logical_struct(v)

    def materialize(self) -> dict:
        """Fault every remaining leaf under this node (prefetch-order
        batched on the engine's pools) and return a plain nested dict of
        tensors on the server's device. Blocks only on THIS subtree's
        leaves — leaves elsewhere in the image keep streaming in the
        background.

        A full (root) materialize also runs the deferred whole-tree
        digest check when the image's migration record carries one
        (LeafServer.verify_tree_digest) — so every lazy consumer gets the
        eager path's bit-identity guarantee at the moment the whole tree
        exists."""
        todo = [p for p in self._server.plan.prefetch_order
                if p.startswith(self._prefix)] if self._prefix else None
        self._server.prefetch(todo)

        def walk(node):
            return {k: walk(v) if isinstance(v, dict)
                    else self._server.get(v) for k, v in node.items()}
        out = walk(self._node)
        if not self._prefix:
            self._server.verify_tree_digest()
        return out


def lazy_restore(root, image_id: str | None = None, *, replicas=(),
                 executor: CheckpointExecutor | None = None,
                 prefetch_order=None, prefetch: bool = True,
                 allow_env_mismatch: bool = True, device="cuda"):
    """criu-restore --lazy-pages: return a (LazyState, manifest, LeafServer)
    triple where the state skeleton is available immediately and leaf
    bytes stream in behind first access, onto ``device``.

    prefetch_order: iterable of leaf paths or path prefixes to stream
    first (None -> the restore plan's params-first hint); prefetch=False
    disables background streaming entirely (pure fault-driven).

    Example::

        state, man, srv = lazy_restore("file:///ckpts/run17", device="cuda")
        state["params"]["w"]       # ready as soon as this leaf lands
        srv.stats                  # {"faults": ..., "prefetched": ...}
    """
    from repro_torch.core.restore import check_env
    dev = resolve_device(device)
    tier = as_tier(root)
    image_id = image_id or latest_image_id(tier)
    if image_id is None:
        raise FileNotFoundError("no checkpoint images found")
    plan = plan_restore(tier, image_id)
    check_env(plan.manifest, allow_env_mismatch, dev)
    server = LeafServer(tier, plan, replicas=replicas, executor=executor,
                        device=dev)
    if prefetch:
        server.prefetch(prefetch_order)
    return LazyState(server), plan.manifest, server
