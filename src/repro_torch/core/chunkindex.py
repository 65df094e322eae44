"""Cross-job chunk accounting: the refcount journal on the shared store.

With ``shared_chunks`` remote tiers (``remote://ck?prefix=<job>&shared=1``)
many jobs deduplicate into ONE content-addressed pool (``chunks/``), so no
single registry can answer "is this chunk garbage?" from its own manifests
— a chunk is live while ANY job's manifest chain references it. The
journal is that answer made durable on the store itself:

  index/refs/<ns>--<image_id>.json     one record per committed image:
                                       the namespace (job prefix), the
                                       image id, and the sorted chunk
                                       hashes its manifest references

``dump()`` publishes the record immediately BEFORE the manifest commit
(both inside the writer guard): a crash between the two leaves an orphan
ref — a bounded leak swept by ``sweep()`` after a grace window — never a
committed manifest whose chunks a peer's gc may reap. ``Registry``
retracts the record after deleting an image (delete first: a retracted
ref on a still-present manifest would expose its chunks to a peer's gc).

Recovery is trivial by construction: the journal IS the store state.
A restarted coordinator (or any fresh process) calls ``recover()`` /
``referenced(reload=True)`` and gets the fleet-wide reference set back
with one list + one read per record — no replay, no sidecar database.
"""
from __future__ import annotations

import json
import re
import threading

# a published ref whose manifest never committed is only provably a
# crashed dump once it has sat quiet past this window (mirrors the
# registry's tmp-file grace)
REF_ORPHAN_GRACE_S = 15 * 60

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def _safe(s: str) -> str:
    return _SAFE.sub("_", s) or "root"


class RefJournal:
    """Journaled per-image chunk references over one tier.

    Each tier alias (one job's view of the shared store) holds its own
    RefJournal; correctness never depends on sharing the in-memory cache
    because every gc decision re-reads the store (``reload=True``). The
    namespace defaults to the tier's key prefix, so two jobs publishing
    the same image id cannot clobber each other's records."""

    def __init__(self, tier, ns: str | None = None):
        self.tier = tier
        self.ns = ns if ns is not None else getattr(tier, "prefix", "")
        self._cache: dict = {}      # filename -> record dict
        self._loaded = False
        self._lock = threading.Lock()
        self.stats = {"published": 0, "retracted": 0, "swept": 0}

    # ------------------------------------------------------------ layout
    REF_DIR = "index/refs"

    def _rel(self, image_id: str, ns: str | None = None) -> str:
        ns = self.ns if ns is None else ns
        return f"{self.REF_DIR}/{_safe(ns or 'root')}--{_safe(image_id)}.json"

    # ------------------------------------------------------------ writes
    def publish(self, image_id: str, chunks, *, manifest_rel: str = ""):
        """Record that ``image_id`` (in this journal's namespace)
        references ``chunks``. Idempotent: re-publishing overwrites."""
        rec = {"schema": 1, "ns": self.ns, "image_id": str(image_id),
               "manifest": manifest_rel,
               "chunks": sorted(set(chunks))}
        rel = self._rel(image_id)
        self.tier.write_bytes(rel, json.dumps(rec).encode(), atomic=True)
        with self._lock:
            self._cache[rel.rsplit("/", 1)[-1]] = rec
            self.stats["published"] += 1

    def retract(self, image_id: str):
        """Drop the record for ``image_id`` (call AFTER deleting the
        image's manifest — the reverse order would let a peer's gc reap
        chunks a still-present manifest references)."""
        rel = self._rel(image_id)
        try:
            self.tier.delete(rel)
        except FileNotFoundError:
            pass
        with self._lock:
            self._cache.pop(rel.rsplit("/", 1)[-1], None)
            self.stats["retracted"] += 1

    # ------------------------------------------------------------- reads
    def _load(self):
        try:
            names = self.tier.listdir(self.REF_DIR)
        except FileNotFoundError:
            names = []
        cache = {}
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                rec = json.loads(bytes(
                    self.tier.read_bytes(f"{self.REF_DIR}/{name}")))
                rec["chunks"]  # shape check
            except (FileNotFoundError, ValueError, KeyError, TypeError):
                continue        # torn/foreign record: keep-safe, skip
            cache[name] = rec
        with self._lock:
            self._cache = cache
            self._loaded = True

    def recover(self) -> int:
        """Rebuild the in-memory view from the store (what a restarted
        coordinator does on boot). Returns the number of live records."""
        self._load()
        with self._lock:
            return len(self._cache)

    def records(self, *, reload: bool = False) -> list:
        if reload or not self._loaded:
            self._load()
        with self._lock:
            return list(self._cache.values())

    def referenced(self, *, reload: bool = False) -> set:
        """Union of every record's chunks — the fleet-wide live set. gc
        callers pass ``reload=True`` so the answer is the STORE's, not a
        stale process-local cache."""
        out: set = set()
        for rec in self.records(reload=reload):
            out.update(rec.get("chunks", ()))
        return out

    def refcount(self, h: str, *, reload: bool = False) -> int:
        return sum(1 for rec in self.records(reload=reload)
                   if h in rec.get("chunks", ()))

    # ----------------------------------------------------------- hygiene
    def sweep(self, *, grace_s: float = REF_ORPHAN_GRACE_S) -> int:
        """Drop OWN-namespace records whose manifest does not exist and
        that have been quiet past ``grace_s`` (a dump that published its
        ref and crashed before the manifest commit). Records from other
        namespaces are never touched — their manifests live under key
        prefixes this tier cannot see, so "missing" would be an artifact
        of the viewpoint, not a fact."""
        swept = 0
        for rec in self.records(reload=True):
            if rec.get("ns", "") != self.ns:
                continue
            man_rel = rec.get("manifest") or \
                f"images/{rec['image_id']}/manifest.json"
            if self.tier.exists(man_rel):
                continue
            age = self.tier.age_s(self._rel(rec["image_id"]))
            if age is None or age <= grace_s:
                continue        # err toward keeping (leak, never loss)
            self.retract(rec["image_id"])
            swept += 1
        with self._lock:
            self.stats["swept"] += swept
        return swept
