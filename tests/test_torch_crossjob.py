"""Cross-job content-addressed chunk store on the port: the twin of
tests/test_crossjob.py (all 14 tests), on torch state with device="cpu"
and the virtual clock only.

  * a second job dumping the same content moves no chunk bytes — the
    global index answers the dedup probe;
  * gc run by ONE job never reaps a chunk ANY job's manifest references
    (the refcount journal of core/chunkindex.py lives on the store);
  * a dedup hit from the cross-job index is rechecked against the store
    before the manifest commits — a stale entry costs a re-upload;
  * a restore next to a warm peer pulls chunks from the peer's hot
    front (hash-verified) before the cold remote, and a lying peer is
    rejected.

The fleet layer (ClusterTopology, PlacementDecision) is not ported: the
two tests that use it in the JAX package wire peers and read hot
inventories through the port's own tier registry instead, which is what
the fleet layer calls.
"""
import hashlib
from urllib.parse import parse_qs

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.chunkindex import RefJournal  # noqa: E402
from repro_torch.core.dump import dump  # noqa: E402
from repro_torch.core.registry import Registry  # noqa: E402
from repro_torch.core.remote import (CachingTier, RemoteTier,  # noqa: E402
                                     RetryPolicy, SimulatedObjectStore,
                                     reset_tier_registry)
from repro_torch.core.restore import (latest_image_id,  # noqa: E402
                                      read_manifest, restore)
from repro_torch.core.storage import (MemoryTier, as_tier,  # noqa: E402
                                      registered_tiers)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_tier_registry()
    yield
    reset_tier_registry()


def _tree(seed=0, nleaves=5, n=1500):
    rng = np.random.default_rng(seed)
    return {"params": {f"l{i}": torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)) for i in range(nleaves)},
        "step": torch.tensor(seed, dtype=torch.int32)}


def _trees_equal(a, b):
    return all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"]) and torch.equal(a["step"], b["step"])


def _alias(store, prefix):
    """One job's view of the shared store: prefixed manifests, global
    chunk pool."""
    return RemoteTier(store, prefix=prefix, shared_chunks=True,
                      retry=RetryPolicy(backoff_base_s=1e-4))


def _dump(tree, tier, step=1):
    return dump(tree, tier, step=step, chunk_bytes=4096, device=CPU)


def _restore(tier):
    return restore(tier, device=CPU)


# ------------------------------------------------------------ dedup
def test_cross_job_dedup_moves_no_chunk_bytes():
    store = SimulatedObjectStore()
    tree = _tree(1)
    job_a, job_b = _alias(store, "jobA"), _alias(store, "jobB")
    out_a = _dump(tree, job_a)
    bytes_after_a = store.stats["bytes_in"]
    out_b = _dump(tree, job_b)
    delta = store.stats["bytes_in"] - bytes_after_a
    total = sum(len(r["chunks"]) for r in out_b["records"])
    assert out_b["stats"]["chunks_deduped"] == total > 0
    assert delta < bytes_after_a / 4
    for alias in (job_a, job_b):
        got, _ = _restore(alias)
        assert _trees_equal(tree, got)
    assert out_a["image_id"] == out_b["image_id"]   # same step, same id


def test_upload_delta_counts_only_absent_chunks():
    store = SimulatedObjectStore()
    job_a, job_b = _alias(store, "jobA"), _alias(store, "jobB")
    _dump(_tree(2), job_a)
    assert job_a.stats["delta_chunks"] > 0          # cold pool: all travel
    moved_a = job_a.stats["delta_bytes"]
    _dump(_tree(2), job_b)
    assert job_b.stats["delta_chunks"] == 0
    assert job_b.stats["delta_bytes"] == 0 < moved_a


# ------------------------------------------------------ refcounted gc
def test_gc_of_one_job_keeps_chunks_the_other_references():
    store = SimulatedObjectStore()
    tree = _tree(3)
    job_a, job_b = _alias(store, "jobA"), _alias(store, "jobB")
    _dump(tree, job_a)
    _dump(tree, job_b)
    reg_a = Registry(job_a)
    assert reg_a.truncate_from(0)               # A's manifests all gone
    out = reg_a.gc()
    assert out["removed"] == 0 and out["kept"] > 0
    got, _ = _restore(job_b)
    assert _trees_equal(tree, got)
    assert Registry(job_b).truncate_from(0)
    out = Registry(job_a).gc()
    assert out["removed"] > 0 and out["kept"] == 0


def test_refcount_journal_recovers_after_restart():
    store = SimulatedObjectStore()
    tree = _tree(4)
    job_a = _alias(store, "jobA")
    _dump(tree, job_a)
    fresh = _alias(store, "jobB")
    journal = fresh.ref_journal()
    assert isinstance(journal, RefJournal)
    assert journal.recover() == 1
    assert journal.referenced()
    out = Registry(fresh).gc()
    assert out["removed"] == 0 and out["kept"] > 0
    got, _ = _restore(job_a)
    assert _trees_equal(tree, got)


def test_orphan_refs_sweep_only_when_manifest_is_gone():
    store = SimulatedObjectStore()
    job_a = _alias(store, "jobA")
    _dump(_tree(5), job_a)
    journal = job_a.ref_journal()
    journal.publish("img-torn", {"deadbeef" * 8},
                    manifest_rel=job_a.manifest_path("img-torn"))
    assert "deadbeef" * 8 in journal.referenced(reload=True)
    assert journal.sweep(grace_s=0.0) == 0      # inside grace: kept
    store.clock.advance(1.0)                    # virtual time passes
    assert journal.sweep(grace_s=0.5) == 1
    assert journal.records(reload=True)
    assert "deadbeef" * 8 not in journal.referenced(reload=True)


# ------------------------------------------------------------- TOCTOU
def test_stale_index_entry_is_recaught_and_reuploaded():
    store = SimulatedObjectStore()
    tree = _tree(6)
    job_a = _alias(store, "jobA")
    _dump(tree, job_a)
    all_chunks = sorted(
        n.removesuffix(".bin") for n in store.list("chunks/")
        if n.endswith(".bin"))
    victims = all_chunks[:2]
    for h in victims:
        store.delete(f"chunks/{h}.bin")
        with store.shared_index_lock:
            store.shared_chunk_index.add(h)      # index still claims it
    job_b = _alias(store, "jobB")
    out = _dump(tree, job_b)
    assert out["stats"]["chunks_reuploaded"] >= len(victims)
    got, _ = _restore(job_b)
    assert _trees_equal(tree, got)
    for h in victims:
        assert store.head(f"chunks/{h}.bin")


def test_verify_chunks_repairs_the_shared_index():
    store = SimulatedObjectStore()
    job_a = _alias(store, "jobA")
    _dump(_tree(7), job_a)
    real = {n.removesuffix(".bin") for n in store.list("chunks/")
            if n.endswith(".bin")}
    with store.shared_index_lock:
        store.shared_chunk_index.add("f00d" * 16)
    present = job_a.verify_chunks(real | {"f00d" * 16})
    assert present == real
    with store.shared_index_lock:
        assert "f00d" * 16 not in store.shared_chunk_index


# ------------------------------------------------- ranged-read caching
def test_repeated_ranged_faults_cost_at_most_two_cold_reads():
    store = SimulatedObjectStore()
    cold = RemoteTier(store, retry=RetryPolicy(backoff_base_s=1e-4))
    tier = CachingTier(MemoryTier(), cold)
    blob = np.arange(8192, dtype=np.uint8).tobytes()
    h = hashlib.sha256(blob).hexdigest()
    cold.write_chunk(h, blob)
    gets_before = store.stats["gets"]
    for i in range(6):                          # repeated page faults
        off = (i * 512) % 4096
        assert tier.read_chunk_range(h, off, 256) == blob[off:off + 256]
    assert store.stats["gets"] - gets_before <= 2
    assert tier.stats["promotions"] == 1
    assert tier.stats["hot_hits"] >= 4
    assert bytes(tier.hot.read_chunk(h)) == blob


def test_full_read_after_ranged_miss_serves_from_hot():
    store = SimulatedObjectStore()
    cold = RemoteTier(store, retry=RetryPolicy(backoff_base_s=1e-4))
    tier = CachingTier(MemoryTier(), cold)
    blob = b"q" * 4096
    h = hashlib.sha256(blob).hexdigest()
    cold.write_chunk(h, blob)
    tier.read_chunk_range(h, 0, 64)             # miss 1: ranged GET
    tier.read_chunk_range(h, 64, 64)            # miss 2: promotion
    gets = store.stats["gets"]
    assert bytes(tier.read_chunk(h)) == blob    # no further cold GET
    assert store.stats["gets"] == gets


# ------------------------------------------------------- peer fetching
def _warm_host(store, prefix="jobA"):
    tier = CachingTier(MemoryTier(), _alias(store, prefix))
    tree = _tree(8)
    _dump(tree, tier)
    return tier, tree


def test_restore_prefers_peer_hot_cache_over_cold():
    store = SimulatedObjectStore()
    host_a, tree = _warm_host(store)
    host_b = CachingTier(MemoryTier(), _alias(store, "jobA"),
                         peers=[host_a.hot])
    gets_before = store.stats["gets"]
    got, _ = _restore(host_b)
    assert _trees_equal(tree, got)
    assert host_b.stats["peer_hits"] > 0
    assert store.stats["gets"] - gets_before <= 2


def test_corrupt_peer_is_rejected_and_cold_serves_truth():
    store = SimulatedObjectStore()
    host_a, tree = _warm_host(store)
    for name in host_a.hot.listdir("chunks"):
        h = name.removesuffix(".bin")
        real = bytes(host_a.hot.read_chunk(h))
        host_a.hot.delete_chunk(h)
        host_a.hot.write_chunk(h, bytes(b ^ 0xFF for b in real))
    host_b = CachingTier(MemoryTier(), _alias(store, "jobA"),
                         peers=[host_a.hot])
    got, _ = _restore(host_b)
    assert _trees_equal(tree, got)              # cold truth wins
    assert host_b.stats["peer_rejects"] > 0
    assert host_b.stats["peer_hits"] == 0


def _fronts(host):
    """The registered cache+remote fronts pinned to ``host`` — what the
    JAX package's ClusterTopology.host_fronts reads."""
    return [t for uri, t in registered_tiers().items()
            if uri.startswith("cache+remote://") and parse_qs(
                uri.partition("?")[2]).get("front", [""])[0] == host]


def test_topology_wires_nearest_peer_fronts():
    uri = "cache+remote://xjob-topo?front={h}&prefix=jobA&shared=1"
    a, b, c = (as_tier(uri.format(h=h)) for h in ("hA", "hB", "hC"))
    tree = _tree(9)
    _dump(tree, a)                              # only A is warm
    assert [_fronts(h) for h in ("hA", "hB", "hC")] == [[a], [b], [c]]
    # B's peers nearest first (A at link cost 0.1, C at 5.0)
    links = {"hA": 0.1, "hC": 5.0}
    peers = [f.hot for h in sorted(links, key=links.get) for f in _fronts(h)]
    for front in _fronts("hB"):
        front.set_peers(peers)
    assert b.peers == [a.hot, c.hot]
    got, _ = _restore(b)
    assert _trees_equal(tree, got)
    assert b.stats["peer_hits"] > 0
    got, _ = _restore(c)                        # unwired: straight to cold
    assert _trees_equal(tree, got)
    assert c.stats["peer_hits"] == 0


def test_placement_reports_peer_covered_chunks():
    """The placement planner's inputs: a host's hot inventory
    (chunk_index_snapshot) covers an image's chunks after a dump through
    it, a cold host's covers none, and the image's chunk set splits into
    peer-covered and cold exactly."""
    store = SimulatedObjectStore()
    host_a, _ = _warm_host(store)
    host_b = CachingTier(MemoryTier(), _alias(store, "jobA"))
    host_a.hot.enable_chunk_index()
    host_b.hot.enable_chunk_index()
    iid = latest_image_id(host_a)
    chunks = {h for r in read_manifest(host_a, iid)["leaves"]
              for h in r["chunks"]}
    warm, cold = host_a.chunk_index_snapshot(), host_b.chunk_index_snapshot()
    assert chunks and chunks <= warm and not (chunks & cold)
    peer_covered = chunks & warm
    assert len(peer_covered) == len(chunks) and not (chunks - peer_covered)


# --------------------------------------------------- URI plumbing
def test_shared_flag_is_part_of_tier_identity():
    shared = as_tier("remote://xjob-id?prefix=j1&shared=1")
    plain = as_tier("remote://xjob-id?prefix=j1")
    assert shared is not plain
    assert shared.shared_chunks and not plain.shared_chunks
    assert shared.store is plain.store
    assert shared._k("chunks/ab.bin") == "chunks/ab.bin"
    assert plain._k("chunks/ab.bin") == "j1/chunks/ab.bin"
    assert shared._k("images/i/manifest.json") \
        == "j1/images/i/manifest.json"
    assert set(registered_tiers()) >= {
        "remote://xjob-id?prefix=j1&shared=1", "remote://xjob-id?prefix=j1"}
