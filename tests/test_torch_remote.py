"""Remote object-store tier + write-through cache on the port: the twin of
tests/test_remote_tier.py (all 28 tests), tests/test_remote_properties.py
(all 9 properties) and the two remote cases of tests/test_cdc.py, on
torch state with device="cpu" and the virtual clock only (no test
sleeps), plus the cross-package contract over the object store: an image
one package writes through its SimulatedObjectStore restores bit for bit
in the other once the store's objects are copied across, with manifests
equal apart from ``env``, ``created_at`` and ``digest``.

Trees are compared in the port's sorted-key flatten order (the JAX
package's order too)."""
import threading
import time
import uuid

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline image: seeded fixed-example fallback
    from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.api import (CheckpointSession, CodecPolicy,  # noqa: E402
                             RestoreRequest, RetentionPolicy, SessionConfig)
from repro_torch.core import Registry, restore  # noqa: E402
from repro_torch.core import remote as tremote  # noqa: E402
from repro_torch.core.dump import dump, flatten_with_paths  # noqa: E402
from repro_torch.core.integrity import CorruptionError  # noqa: E402
from repro_torch.core.lazy import lazy_restore  # noqa: E402
from repro_torch.core.remote import (CachingTier, FaultPolicy,  # noqa: E402
                                     NetworkModel, RemoteTier, RetryPolicy,
                                     SimulatedObjectStore, TransferError,
                                     get_store)
from repro_torch.core.restore import latest_image_id, read_manifest  # noqa: E402
from repro_torch.core.storage import MemoryTier, as_tier  # noqa: E402
from repro_torch.device import to_host  # noqa: E402

settings.register_profile("ci", max_examples=15, deadline=None)
settings.load_profile("ci")

CPU = "cpu"
ATTEMPTS = 4        # retry budget under test; schedules draw around it
SKIP = ("env", "created_at", "digest")


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def tree_of(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return to_torch({"params": {"w": rng.standard_normal(n).astype(
        np.float32), "frozen": np.zeros(n, np.float32)},
        "step": np.int32(seed)})


def host_pairs(tree):
    return [(p, to_host(v)) for p, v in flatten_with_paths(tree)]


def trees_equal(a, b):
    pa, pb = host_pairs(a), host_pairs(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and np.array_equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


def fresh_uri(scheme="remote", params=""):
    return f"{scheme}://t_{uuid.uuid4().hex[:10]}{params}"


def session(root, **kw):
    return CheckpointSession(root, device=CPU, **kw)


# ------------------------------------------------------------ URI schemes
def test_remote_uri_resolves_memoized():
    uri = fresh_uri()
    t = as_tier(uri)
    assert isinstance(t, RemoteTier)
    assert as_tier(uri) is t                    # same URI -> same object


def test_cache_remote_uri_resolves_memoized_and_shares_store():
    name = f"s_{uuid.uuid4().hex[:10]}"
    c = as_tier(f"cache+remote://{name}")
    r = as_tier(f"remote://{name}")
    assert isinstance(c, CachingTier) and isinstance(r, RemoteTier)
    assert c.cold.store is r.store              # one backing store
    assert as_tier(f"cache+remote://{name}") is c


def test_uri_aliases_share_tier_guard_and_clock_config():
    """Every alias of one store coordinates on ONE writer/reaper guard,
    and a late ?realtime=1 variant never flips an in-use virtual clock
    into wall sleeps."""
    name = f"alias_{uuid.uuid4().hex[:10]}"
    r = as_tier(f"remote://{name}")
    assert as_tier(f"remote://{name}?attempts=9") is r      # params ignored
    c = as_tier(f"cache+remote://{name}")
    assert c.cold is r                                      # one cold tier
    assert c._guard_obj() is r._guard_obj() is r.store.rw_guard
    assert as_tier(f"remote://{name}?realtime=1") is r
    assert not r.store.clock.realtime                       # unchanged
    with c.writer():
        got = []
        th = threading.Thread(
            target=lambda: (r.reaper().__enter__(), got.append("reaped")))
        th.start()
        th.join(timeout=0.2)
        assert not got                                      # still waiting
    th.join(timeout=2.0)
    assert got == ["reaped"]                                # released


def test_unknown_scheme_still_rejected():
    with pytest.raises(ValueError, match="unknown tier URI scheme"):
        as_tier("s3://bucket/ck")


def test_uri_params_configure_simulation():
    uri = fresh_uri(params="?latency_ms=2&fail_rate=0.5&attempts=7"
                           "&part_kb=64&seed=9")
    t = as_tier(uri)
    assert t.retry.attempts == 7
    assert t.part_bytes == 64 << 10
    assert t.store.network.latency_s == pytest.approx(0.002)
    assert t.store.faults.fail_rate == pytest.approx(0.5)
    assert not t.store.clock.realtime           # tests never sleep...
    t2 = as_tier(fresh_uri(params="?realtime=1"))
    assert t2.store.clock.realtime              # ...benchmarks opt in


def test_session_config_accepts_remote_uris():
    sess = CheckpointSession(SessionConfig(root=fresh_uri("cache+remote")),
                             device=CPU)
    tree = tree_of(1)
    sess.save(tree, step=1)
    got, _ = sess.load_latest()
    assert trees_equal(tree, got)


# -------------------------------------------------------------- multipart
def test_multipart_geometry_and_roundtrip():
    store = SimulatedObjectStore()
    t = RemoteTier(store, part_bytes=1 << 10)
    data = np.arange(3000, dtype=np.uint8).tobytes() * 4   # ~12 KB
    t.write_bytes("chunks/big.bin", data)
    assert t.read_bytes("chunks/big.bin") == data
    nparts = -(-len(data) // (1 << 10))
    assert t.stats == {"retries": 0, "parts_uploaded": nparts,
                       "multipart_uploads": 1, "singlepart_uploads": 0,
                       "delta_batches": 0, "delta_chunks": 0,
                       "delta_bytes": 0}
    assert store.stats["mp_completed"] == 1
    t.write_bytes("images/i/manifest.json", b"{}")      # small: single put
    assert t.stats["singlepart_uploads"] == 1


def test_incomplete_multipart_is_invisible():
    store = SimulatedObjectStore()
    uid = store.initiate_multipart("k")
    store.put_part("k", uid, 0, b"half")
    with pytest.raises(FileNotFoundError):
        store.get("k")
    assert not store.head("k")


def test_multipart_serial_engine_uploads_inline():
    from repro_torch.core.executor import CheckpointExecutor
    store = SimulatedObjectStore()
    t = RemoteTier(store, part_bytes=1 << 10,
                   executor=CheckpointExecutor(serial=True))
    data = bytes(5 << 10)
    t.write_bytes("k", data)                    # no transfer lanes: inline
    assert t.read_bytes("k") == data
    assert t.stats["parts_uploaded"] == 5


def test_part_upload_failure_aborts_whole_multipart():
    """Break ONLY the part-upload leg: the upload must abort (no leaked
    multipart state, no object) and surface as TransferError."""
    store = SimulatedObjectStore(
        faults=FaultPolicy(fixed_failures=99, ops=("put_part",)))
    t = RemoteTier(store, retry=RetryPolicy(attempts=2,
                                            backoff_base_s=1e-4),
                   part_bytes=1 << 10)
    with pytest.raises(TransferError) as ei:
        t.write_bytes("big", bytes(4 << 10))
    assert ei.value.op == "put_part"
    assert store.pending_multiparts == 0
    assert store.stats["mp_aborted"] == 1
    assert not store.head("big")


def test_store_multipart_misuse_is_an_error():
    store = SimulatedObjectStore()
    with pytest.raises(IOError, match="unknown multipart"):
        store.put_part("k", "mp-404", 0, b"x")
    with pytest.raises(IOError, match="unknown multipart"):
        store.complete_multipart("k", "mp-404", 1)
    uid = store.initiate_multipart("k")
    store.put_part("k", uid, 1, b"x")           # part 0 never arrives
    with pytest.raises(IOError, match="missing parts"):
        store.complete_multipart("k", uid, 2)


def test_remote_age_s_runs_on_store_clock():
    store = SimulatedObjectStore(network=NetworkModel(latency_s=0.5))
    t = RemoteTier(store)
    t.write_bytes("a", b"x")
    assert t.age_s("a") == 0.0                  # just written
    store.clock.advance(3.0)                    # virtual: no sleep
    assert t.age_s("a") == pytest.approx(3.0)
    assert t.age_s("never-written") is None
    with pytest.raises(FileNotFoundError):
        store.get_range("never-written", 0, 1)


def test_network_model_charges_latency_and_bandwidth(monkeypatch):
    """The cost model, and a realtime clock that still advances its
    account (the sleep itself is stubbed: no test sleeps)."""
    m = NetworkModel(latency_s=0.01, bandwidth_bps=1e6)
    assert m.cost_s(0) == pytest.approx(0.01)
    assert m.cost_s(500_000) == pytest.approx(0.51)
    clock = SimulatedObjectStore().clock
    clock.realtime = True
    slept = []
    monkeypatch.setattr(tremote.time, "sleep", slept.append)
    clock.advance(0.02)                         # realtime: asks to sleep
    assert slept == [0.02]
    assert clock.now == pytest.approx(0.02)


# ---------------------------------------------------------- retry/backoff
def test_transient_faults_retried_on_virtual_clock():
    store = SimulatedObjectStore(
        faults=FaultPolicy(seed=1, fail_rate=1.0, max_consecutive=2))
    t = RemoteTier(store, retry=RetryPolicy(attempts=4, backoff_base_s=0.5))
    wall = time.monotonic()
    t.write_bytes("x", b"payload")
    assert time.monotonic() - wall < 0.4        # backoff never wall-slept
    assert t.stats["retries"] > 0
    assert store.clock.now >= 0.5               # ...but WAS charged
    assert t.read_bytes("x") == b"payload"


def test_backoff_is_exponential_and_capped():
    calls = []
    p = RetryPolicy(attempts=4, backoff_base_s=0.1, backoff_max_s=0.25)
    boom = [3]

    def fn():
        if boom[0]:
            boom[0] -= 1
            raise TimeoutError("x")
        return "ok"
    assert p.call("put", "k", fn, sleep=calls.append) == "ok"
    assert calls == [0.1, 0.2, 0.25]            # 2**k, capped


def test_budget_exhausted_raises_typed_error_no_partial_object():
    store = SimulatedObjectStore(faults=FaultPolicy(fixed_failures=99))
    t = RemoteTier(store, retry=RetryPolicy(attempts=3,
                                            backoff_base_s=0.001),
                   part_bytes=1 << 10)
    with pytest.raises(TransferError) as ei:
        t.write_bytes("small", b"x")
    assert ei.value.attempts == 3
    with pytest.raises(TransferError):
        t.write_bytes("big", bytes(8 << 10))    # multipart path
    assert store.pending_multiparts == 0        # aborted, not leaked
    assert not store._objects                   # nothing ever installed


def test_missing_object_is_not_retried():
    store = SimulatedObjectStore()
    t = RemoteTier(store)
    with pytest.raises(FileNotFoundError):
        t.read_bytes("nope")
    assert t.stats["retries"] == 0


# ------------------------------------------------------------ cache layer
def test_write_through_and_read_through_fill():
    store = SimulatedObjectStore()
    remote = RemoteTier(store)
    hot = MemoryTier()
    c = CachingTier(hot, remote)
    c.write_bytes("chunks/aa.bin", b"data")
    assert hot.read_bytes("chunks/aa.bin") == b"data"       # both layers
    assert remote.read_bytes("chunks/aa.bin") == b"data"
    c2 = CachingTier(MemoryTier(), remote)                  # cold front
    gets = store.stats["gets"]
    assert c2.read_bytes("chunks/aa.bin") == b"data"        # fills...
    assert c2.read_bytes("chunks/aa.bin") == b"data"
    assert store.stats["gets"] == gets + 1                  # ...once
    assert c2.stats == {"hot_hits": 1, "cold_reads": 1, "fills": 1,
                        "range_misses": 0, "promotions": 0,
                        "peer_hits": 0, "peer_rejects": 0}


def test_dedup_probe_answered_from_cache_index():
    c = as_tier(fresh_uri("cache+remote"))
    sess = session(c)
    sess.save(tree_of(2), step=1)
    store = c.cold.store
    ops = store.stats["ops"]
    tree2 = tree_of(2, n=4096)
    tree2["step"] = torch.tensor(2, dtype=torch.int32)
    out = sess.save(tree2, step=2)
    assert out["stats"]["chunks_deduped"] > 0
    # the dedup decision added no per-chunk remote round trips: probes
    # were answered by the in-memory indexes
    assert store.stats["ops"] - ops <= 8


def test_gc_and_retention_forward_to_both_layers():
    c = as_tier(fresh_uri("cache+remote"))
    sess = session(c, retention=RetentionPolicy(keep_last=1))
    sess.save(tree_of(1), step=1)
    sess.save(tree_of(2), step=2)       # distinct content: step-1 chunks die
    reg = Registry(c)
    assert [m["step"] for m in reg.images()] == [2]
    hot_chunks = set(c.hot.listdir("chunks"))
    cold_chunks = set(c.cold.listdir("chunks"))
    assert hot_chunks == cold_chunks    # reaped (and kept) in lock-step
    man_chunks = set()
    for rec in read_manifest(c, reg.images()[0]["image_id"])["leaves"]:
        man_chunks.update(rec["chunks"])
    assert {n.removesuffix(".bin") for n in cold_chunks} == man_chunks


def test_cache_dedup_probe_without_index_prefers_hot():
    store = SimulatedObjectStore()
    remote = RemoteTier(store)
    c = CachingTier(MemoryTier(), remote)
    assert not c.chunk_index_enabled()
    hh, hc = "aa" * 32, "bb" * 32
    c.write_chunk(hh, b"hot+cold")
    remote.write_chunk(hc, b"cold-only")
    heads = store.stats["ops"]
    assert c.has_chunk(hh)                      # hot hit: no remote op
    assert store.stats["ops"] == heads
    assert c.has_chunk(hc)                      # hot miss -> cold HEAD
    assert store.stats["ops"] == heads + 1
    assert c.has_chunks({hh, hc, "cc" * 32}) == {hh, hc}


def test_cache_chunk_surface_forwards_to_both_layers():
    store = SimulatedObjectStore()
    remote = RemoteTier(store)
    hot = MemoryTier()
    c = CachingTier(hot, remote)
    h = "aa" * 32
    blob = bytes(range(200))
    c.enable_chunk_index()
    assert c.chunk_index_enabled()
    c.write_chunk(h, blob)
    assert hot.has_chunk(h) and remote.has_chunk(h) and c.has_chunk(h)
    assert c.read_chunk_range(h, 10, 5) == blob[10:15]
    assert c.stats["hot_hits"] == 1
    hot.delete_chunk(h)
    assert c.read_chunk_range(h, 10, 5) == blob[10:15]
    assert c.stats["cold_reads"] == 1
    assert not hot.has_chunk(h)                 # range read did NOT fill
    assert c.has_chunks({h}) == {h}
    c.note_chunk_present(h)                     # repair-path index upkeep
    c.delete_chunk(h)
    assert not c.has_chunk(h)
    c.write_bytes("x", b"1")
    assert c.age_s("x") == 0.0                  # remote virtual clock
    assert c.age_s("never") is None


# ----------------------------------------------- engine paths over remote
def test_predump_reuse_over_cache_remote():
    sess = session(fresh_uri("cache+remote"))
    tree = tree_of(3)
    sess.pre_dump(tree, step=1)
    tree2 = {"params": dict(tree["params"]),
             "step": torch.tensor(2, dtype=torch.int32)}
    tree2["params"]["w"] = tree["params"]["w"] + 1.0        # frozen stays
    out = sess.save(tree2, step=2)
    assert out["stats"]["leaves_reused"] >= 1               # reuse path OK
    got, _ = sess.load_latest()
    assert trees_equal(tree2, got)


def test_migration_resume_on_new_host_over_remote():
    """Dump on host A through its cache; resume on host B = a fresh cache
    over the same object store, through the typed restore path."""
    name = f"mig_{uuid.uuid4().hex[:8]}"
    store = get_store(name)
    host_a = CachingTier(MemoryTier(), RemoteTier(store))
    tree = tree_of(5)
    session(host_a).save(tree, step=7)
    host_b = CachingTier(MemoryTier(), RemoteTier(store))
    res = session(host_b).restore(RestoreRequest())
    assert res.step == 7
    assert trees_equal(tree, res.state)
    assert host_b.stats["cold_reads"] > 0       # genuinely came remote


def test_lazy_restore_faults_ranged_reads_over_remote():
    t = as_tier(fresh_uri())
    tree = tree_of(6, n=8192)
    dump(tree, t, step=1, chunk_bytes=8 << 10, device=CPU)
    state, man, srv = lazy_restore(t, prefetch=False, device=CPU)
    assert srv.remaining == len(srv.paths())
    got = state["params"]["w"]                  # fault one leaf
    assert torch.equal(got, tree["params"]["w"])
    assert srv.stats["faults"] == 1
    out_before = t.store.stats["bytes_out"]
    first_kb = srv.read_range("params/frozen", 0, 1024)
    assert first_kb == tree["params"]["frozen"].numpy().tobytes()[:1024]
    assert t.store.stats["bytes_out"] - out_before <= 2048
    assert trees_equal(tree, state.materialize())


# ------------------------------------------- MemoryTier.read_chunk_range
def test_memory_tier_range_read_is_sliced_not_whole_chunk():
    t = MemoryTier()
    blob = bytes(range(256)) * 16
    h = "ab" * 32
    t.write_bytes(t.chunk_path(h), blob)
    assert t.read_chunk_range(h, 100, 7) == blob[100:107]
    assert t.read_chunk_range(h, 0, 10**9) == blob          # clamped
    with pytest.raises(FileNotFoundError):
        t.read_chunk_range("cd" * 32, 0, 1)
    t.read_chunk = None                                     # would TypeError
    assert t.read_chunk_range(h, 5, 5) == blob[5:10]


def test_lazy_range_reads_over_mem_uri():
    t = as_tier(f"mem://rr_{uuid.uuid4().hex[:8]}")
    tree = tree_of(7, n=8192)
    dump(tree, t, step=1, chunk_bytes=4 << 10, device=CPU)
    state, _, srv = lazy_restore(t, prefetch=False, device=CPU)
    want = tree["params"]["w"].numpy().tobytes()
    assert srv.read_range("params/w", 64, 128) == want[64:192]
    assert srv.stats["faults"] == 0             # range read, no leaf fault


# ------------------------------------------------------- concurrency: gc
def test_two_writers_one_gc_shared_cache_remote_tier():
    """Two sessions stream pre-dump rounds through ONE cache+remote tier
    while a third thread runs gc in a loop: every committed image restores
    bit-identically and both layers' chunk indexes match their pools."""
    uri = fresh_uri("cache+remote")
    tier = as_tier(uri)
    written: dict = {}
    errors: list = []
    stop = threading.Event()

    def writer(wid):
        try:
            sess = session(uri, retention=RetentionPolicy(keep_last=100))
            for i in range(5):
                step = wid * 1000 + i
                tree = tree_of(seed=step, n=2048)
                out = sess.pre_dump(tree, step=step)
                written[(wid, out["image_id"])] = tree
        except BaseException as e:   # pragma: no cover - failure reporting
            errors.append(e)

    def reaper():
        reg = Registry(tier)
        while not stop.is_set():
            reg.gc()

    threads = [threading.Thread(target=writer, args=(w,)) for w in (1, 2)]
    gc_thread = threading.Thread(target=reaper)
    gc_thread.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stop.set()
    gc_thread.join()
    assert not errors, errors
    assert len(written) == 10
    for (_, image_id), tree in written.items():
        got, _ = restore(tier, image_id, device=CPU)
        assert trees_equal(tree, got), image_id
    for layer in (tier.hot, tier.cold):
        if layer._chunk_index is not None:      # index == reality
            names = {n.removesuffix(".bin")
                     for n in layer.listdir("chunks")}
            assert layer._chunk_index == names
    zeros = np.zeros(2048, np.float32)
    from repro_torch.core.chunking import chunk_views, leaf_to_bytes
    zh = [h for h, _ in chunk_views(leaf_to_bytes(zeros), 4 << 20)]
    assert tier.has_chunks(set(zh)) == set(zh)


# ---------------------- tests/test_remote_properties.py twin (properties)
def _tree(seed, nleaves, n):
    rng = np.random.default_rng(seed)
    t = {"params": {}, "step": np.int32(seed % 1000)}
    for i in range(nleaves):
        t["params"][f"l{i}"] = rng.standard_normal(n).astype(np.float32)
    return to_torch(t)


def _params_equal(got, tree):
    for p, leaf in tree["params"].items():
        assert torch.equal(got["params"][p], leaf), p


def _remote(fail_seed, fail_rate, max_consecutive, part_kb=2,
            fixed=None, cached=False):
    store = SimulatedObjectStore(
        faults=FaultPolicy(seed=fail_seed, fail_rate=fail_rate,
                           max_consecutive=max_consecutive,
                           fixed_failures=fixed))
    tier = RemoteTier(store, retry=RetryPolicy(attempts=ATTEMPTS,
                                               backoff_base_s=1e-4),
                      part_bytes=part_kb << 10)
    if cached:
        return CachingTier(MemoryTier(), tier), store
    return tier, store


@given(st.integers(min_value=0, max_value=2**31 - 1),   # tree seed
       st.integers(min_value=0, max_value=2**31 - 1),   # fault seed
       st.floats(min_value=0.0, max_value=1.0),         # fault rate
       st.integers(min_value=1, max_value=ATTEMPTS - 1),  # consecutive
       st.integers(min_value=1, max_value=4),            # leaves
       st.sampled_from([1, 2, 8]))                       # part KiB
def test_survivable_fault_schedules_are_invisible(
        tree_seed, fault_seed, rate, consec, nleaves, part_kb):
    tree = _tree(tree_seed, nleaves, 1500)
    tier, store = _remote(fault_seed, rate, consec, part_kb=part_kb)
    dump(tree, tier, step=1, chunk_bytes=4 << 10, device=CPU)
    got, _ = restore(tier, device=CPU)
    _params_equal(got, tree)
    assert torch.equal(got["step"], tree["step"])
    assert store.pending_multiparts == 0
    assert tier.stats["retries"] == store.stats["faults_injected"]


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=ATTEMPTS, max_value=ATTEMPTS + 3))
def test_budget_exceeded_is_typed_never_partial(tree_seed, failures):
    tree = _tree(tree_seed, 3, 1500)
    tier, store = _remote(0, 1.0, 1, fixed=failures)
    with pytest.raises(TransferError) as ei:
        dump(tree, tier, step=1, chunk_bytes=2 << 10, device=CPU)
    assert ei.value.attempts == ATTEMPTS
    assert isinstance(ei.value.last, (TimeoutError, IOError))
    assert store.pending_multiparts == 0
    clean = RemoteTier(store)       # fresh tier: no fault schedule state
    store.faults = FaultPolicy()
    assert latest_image_id(clean) is None
    with pytest.raises(FileNotFoundError):
        restore(clean, device=CPU)


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.0, max_value=1.0),
       st.integers(min_value=1, max_value=ATTEMPTS - 1))
def test_cached_tier_inherits_fault_transparency(tree_seed, rate, consec):
    tree = _tree(tree_seed, 2, 1500)
    tier, store = _remote(tree_seed % 97, rate, consec, cached=True)
    dump(tree, tier, step=1, chunk_bytes=4 << 10, device=CPU)
    cold = CachingTier(MemoryTier(), tier.cold)
    got, _ = restore(cold, device=CPU)
    _params_equal(got, tree)


@given(st.binary(min_size=0, max_size=9000),
       st.integers(min_value=1, max_value=8))
def test_multipart_split_reassembles_any_blob(data, part_kb):
    store = SimulatedObjectStore()
    t = RemoteTier(store, part_bytes=part_kb << 10)
    rel = f"b/{uuid.uuid4().hex[:8]}"
    t.write_bytes(rel, memoryview(data))        # a view, as the stage hands
    assert t.read_bytes(rel) == data
    for off in (0, len(data) // 2):
        ln = max(1, len(data) // 3)
        assert store.get_range(rel, off, ln) == data[off:off + ln]


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.0, max_value=1.0))
def test_corruption_remains_typed_under_fault_storms(seed, rate):
    tree = _tree(seed, 2, 1200)
    tier, store = _remote(seed % 89, rate, ATTEMPTS - 1)
    out = dump(tree, tier, step=1, chunk_bytes=2 << 10, device=CPU)
    victim = next(iter(
        r["chunks"][0] for r in out["records"] if r["chunks"]))
    key = tier._k(tier.chunk_path(victim))
    store._objects[key] = b"bitrot" + store._objects[key][6:]
    with pytest.raises(CorruptionError):
        restore(tier, device=CPU)


def _shared_pair(fail_seed, rate, consec):
    store = SimulatedObjectStore(
        faults=FaultPolicy(seed=fail_seed, fail_rate=rate,
                           max_consecutive=consec))

    def mk(p):
        return RemoteTier(store, prefix=p, shared_chunks=True,
                          retry=RetryPolicy(attempts=ATTEMPTS,
                                            backoff_base_s=1e-4))
    return mk("jobA"), mk("jobB"), store


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.0, max_value=1.0),
       st.integers(min_value=1, max_value=ATTEMPTS - 1))
def test_cross_job_dedup_survives_fault_storms(
        tree_seed, fault_seed, rate, consec):
    tree = _tree(tree_seed, 2, 1500)
    job_a, job_b, store = _shared_pair(fault_seed, rate, consec)
    dump(tree, job_a, step=1, chunk_bytes=4 << 10, device=CPU)
    out_b = dump(tree, job_b, step=1, chunk_bytes=4 << 10, device=CPU)
    total = sum(len(r["chunks"]) for r in out_b["records"])
    assert out_b["stats"]["chunks_deduped"] + \
        out_b["stats"]["chunks_reuploaded"] >= total - \
        out_b["stats"]["chunks"]
    for alias in (job_a, job_b):
        got, _ = restore(alias, device=CPU)
        _params_equal(got, tree)
    assert store.pending_multiparts == 0


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.0, max_value=1.0),
       st.integers(min_value=1, max_value=ATTEMPTS - 1))
def test_gc_under_fault_storm_never_reaps_referenced(
        tree_seed, fault_seed, rate, consec):
    tree = _tree(tree_seed, 2, 1500)
    job_a, job_b, store = _shared_pair(fault_seed, rate, consec)
    dump(tree, job_a, step=1, chunk_bytes=4 << 10, device=CPU)
    dump(tree, job_b, step=2, chunk_bytes=4 << 10, device=CPU)
    reg = Registry(job_a)
    reg.truncate_from(0)
    reg.gc()
    got, _ = restore(job_b, device=CPU)
    _params_equal(got, tree)


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.0, max_value=1.0),
       st.integers(min_value=1, max_value=ATTEMPTS - 1))
def test_peer_fetch_survives_fault_storms(
        tree_seed, fault_seed, rate, consec):
    tree = _tree(tree_seed, 2, 1500)
    job_a, _, store = _shared_pair(fault_seed, rate, consec)
    warm = CachingTier(MemoryTier(), job_a)
    dump(tree, warm, step=1, chunk_bytes=4 << 10, device=CPU)
    cold_front = CachingTier(MemoryTier(), job_a, peers=[warm.hot])
    got, _ = restore(cold_front, device=CPU)
    _params_equal(got, tree)


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=ATTEMPTS, max_value=ATTEMPTS + 3))
def test_cross_job_budget_exhaustion_is_typed(tree_seed, failures):
    tree_a = _tree(tree_seed, 2, 1500)
    tree_b = _tree(tree_seed + 1, 2, 1500)      # different content:
    job_a, job_b, store = _shared_pair(0, 0.0, 1)  # B must upload
    dump(tree_a, job_a, step=1, chunk_bytes=2 << 10, device=CPU)
    store.faults = FaultPolicy(seed=1, fail_rate=1.0,
                               fixed_failures=failures)
    with pytest.raises(TransferError):
        dump(tree_b, job_b, step=1, chunk_bytes=2 << 10, device=CPU)
    store.faults = FaultPolicy()
    assert store.pending_multiparts == 0
    assert latest_image_id(job_b) is None       # no torn B image
    got, _ = restore(job_a, device=CPU)         # A untouched
    _params_equal(got, tree_a)


# --------------------- tests/test_cdc.py twin: pre-dump reuse over remote
@pytest.mark.parametrize("scheme", ["remote", "cache+remote"])
def test_predump_leaf_reuse_over_remote_with_cdc(scheme):
    uri = f"{scheme}://cdc_{uuid.uuid4().hex[:10]}"
    sess = CheckpointSession(SessionConfig(
        root=uri, chunk_bytes=1 << 14,
        codec=CodecPolicy(chunking="cdc")), device=CPU)
    rng = np.random.default_rng(6)
    tree = to_torch({"params": {
        "w": rng.standard_normal(200_000).astype(np.float32),
        "frozen": rng.standard_normal(200_000).astype(np.float32)},
        "step": np.int32(1)})
    sess.pre_dump(tree, step=1)
    tree2 = {"params": dict(tree["params"]),
             "step": torch.tensor(2, dtype=torch.int32)}
    tree2["params"]["w"] = tree["params"]["w"] + 1.0   # frozen stays clean
    out = sess.save(tree2, step=2)
    assert out["stats"]["leaves_reused"] >= 1
    got, _ = sess.load_latest()
    assert trees_equal(tree2, got)


# ------------------------- cross-package: the image over the object store
def _policy_b(path):
    if path.startswith("opt/m/"):
        return "delta8"
    return "bf16" if path.startswith("opt/v/") else "none"


def _np_states():
    rng = np.random.default_rng(11)
    shapes = {"embed": (64, 32), "w": (2, 32, 48), "norm": (32,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: np.abs(rng.standard_normal(s) * 1e-4).astype(np.float32)
         for k, s in shapes.items()}
    a = {"params": p, "opt": {"m": m, "v": v}, "step": np.int32(3)}
    b = {"params": {k: x * np.float32(0.999) for k, x in p.items()},
         "opt": {"m": {k: x + (rng.standard_normal(x.shape) * 1e-4).astype(
             np.float32) for k, x in m.items()},
             "v": {k: x * np.float32(1.01) for k, x in v.items()}},
         "step": np.int32(4)}
    return a, b


def _chain(kind, tier, a, b):
    """Image A (lossless) and image B (opt/m delta8 against A, opt/v
    bf16, parent A) through ``tier`` by the given package."""
    if kind == "jax":
        from repro.core.dump import dump as jdump
        ra = jdump(a, tier, step=3, chunk_bytes=4 << 10)
        prev = dict(flatten_with_paths(a))
        rb = jdump(b, tier, step=4, parent=ra["image_id"],
                   codec_policy=_policy_b, prev_host_tree=prev,
                   chunk_bytes=4 << 10)
    else:
        ta, tb = to_torch(a), to_torch(b)
        ra = dump(ta, tier, step=3, chunk_bytes=4 << 10, device=CPU)
        prev = {p: to_host(v) for p, v in flatten_with_paths(ta)}
        rb = dump(tb, tier, step=4, parent=ra["image_id"],
                  codec_policy=_policy_b, prev_host_tree=prev,
                  chunk_bytes=4 << 10, device=CPU)
    return ra["image_id"], rb["image_id"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_image_crosses_packages_through_the_object_store(writer):
    """One package dumps a delta8 + bf16 chain through its own faulty
    object store (multipart parts, retried faults); the store's objects
    are copied into the other package's store; the other package restores
    through a fresh cache+remote front bit for bit, and both packages'
    chains have the same objects and manifests apart from SKIP."""
    from repro.core import remote as jremote
    from repro.core.restore import read_manifest as jread_manifest
    from repro.core.restore import restore as jrestore
    from repro.core.storage import MemoryTier as JMemoryTier

    def faulty(mod):
        store = mod.SimulatedObjectStore(faults=mod.FaultPolicy(
            seed=5, fail_rate=0.3, max_consecutive=1))
        return store, mod.RemoteTier(store, part_bytes=1 << 10,
                                     retry=mod.RetryPolicy(
                                         backoff_base_s=1e-4))
    a, b = _np_states()
    jstore, jtier = faulty(jremote)
    tstore, ttier = faulty(tremote)
    ids_j = _chain("jax", jtier, a, b)
    ids_t = _chain("torch", ttier, a, b)
    assert ids_j == ids_t
    for st_, t in ((jstore, jtier), (tstore, ttier)):
        assert t.stats["retries"] > 0 and t.stats["parts_uploaded"] > 1
        assert st_.pending_multiparts == 0
    chunks = {k: v for k, v in jstore._objects.items()
              if k.startswith("chunks/")}
    assert chunks == {k: v for k, v in tstore._objects.items()
                      if k.startswith("chunks/")}
    for iid in ids_t:
        mj, mt = jread_manifest(jtier, iid), read_manifest(ttier, iid)
        assert {k: v for k, v in mj.items() if k not in SKIP} == \
            {k: v for k, v in mt.items() if k not in SKIP}

    # copy the writer's objects into a clean store of the reader's package
    src = jstore if writer == "jax" else tstore
    if writer == "jax":
        dst = SimulatedObjectStore()
        front = CachingTier(MemoryTier(), RemoteTier(dst))
    else:
        dst = jremote.SimulatedObjectStore()
        front = jremote.CachingTier(JMemoryTier(), jremote.RemoteTier(dst))
    dst._objects.update(src._objects)
    dst._mtimes.update(src._mtimes)
    if writer == "jax":
        got, man = restore(front, ids_j[1], device=CPU)
        got = {p: to_host(v) for p, v in flatten_with_paths(got)}
        want, _ = jrestore(jtier, ids_j[1])
    else:
        got, man = jrestore(front, ids_t[1])
        got = {p: np.asarray(v) for p, v in flatten_with_paths(got)}
        want, _ = restore(ttier, ids_t[1], device=CPU)
    want = {p: np.asarray(to_host(v)) for p, v in flatten_with_paths(want)}
    assert set(got) == set(want)
    for p in want:
        g, w = np.asarray(got[p]), want[p]
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), p
    assert front.stats["cold_reads"] > 0        # came from the copied store
    for p, v in flatten_with_paths(b):
        if not p.startswith("opt/"):            # lossless: exactly as dumped
            assert got[p].tobytes() == np.asarray(v).tobytes(), p
