"""The port's plan/execute engine: the twin of
tests/test_checkpoint_pipeline.py (all 30 tests, 32 cases: serial vs
pipelined equivalence, replica repair, multi-process merge under the
executor, crash-mid-dump atomicity, chunk-index consistency across gc,
manifest-chain caching, the async lane, rollback and cyclic chains, gc of
temporary files), on seeded torch trees with ``device="cpu"`` at every
entry point. tests/faultinject.py's FlakyTier wraps the port's tiers as
an instance of the port's Tier (``PortFlakyTier``). Plus one
cross-package case: ``plan_dump`` of the same tree gives the same leaf
records in both packages (the port flattens in sorted key order, ROADMAP
§3)."""
import glob
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faultinject import FlakyTier as _FaultTier  # noqa: E402
from repro_torch.core import (Checkpointer, CheckpointExecutor,  # noqa: E402
                              CorruptionError, MemoryTier, Registry,
                              plan_dump, plan_restore, restore)
from repro_torch.core.compression import default_policy  # noqa: E402
from repro_torch.core.dump import (dump, flatten_with_paths,  # noqa: E402
                                   merge_parts)
from repro_torch.core.integrity import read_chunk_verified, sha256  # noqa: E402
from repro_torch.core.storage import LocalDirTier, Tier, as_tier  # noqa: E402
from repro_torch.device import to_host  # noqa: E402

CPU = "cpu"


class PortFlakyTier(_FaultTier, Tier):
    """tests/faultinject.py's FlakyTier as an instance of the port's Tier,
    so the port's engine takes it."""


@pytest.fixture
def flaky_tier():
    """conftest.py's ``flaky_tier`` over the port's tiers."""
    def make(inner, **schedule_kw):
        return PortFlakyTier(as_tier(inner), **schedule_kw)
    return make


def normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


def meta_struct(tree):
    """Shapes and dtypes as ``meta`` tensors: the port's
    ``jax.eval_shape``."""
    return tmap(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device="meta"), tree)


def med_tree(seed=0, leaves=6, n=3000):
    return {"params": {f"l{i}": normal(seed * 1000 + i, (n,))
                       for i in range(leaves)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def trees_equal(a, b):
    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for (_, x), (_, y) in zip(la, lb))


# --------------------------------------------------- engine equivalence
def test_serial_and_pipelined_produce_identical_images(tmp_path):
    tree = med_tree()
    outs, trees = {}, {}
    for name in ("serial", "pipelined"):
        ck = Checkpointer(str(tmp_path / name), chunk_bytes=4096,
                          serial=name == "serial", device=CPU)
        outs[name] = ck.save(tree, step=1)["stats"]
        trees[name], _ = ck.load_latest()
    assert outs["serial"] == outs["pipelined"]
    assert trees_equal(trees["serial"], trees["pipelined"])
    assert trees_equal(trees["pipelined"], tree)


def test_plan_is_pure_and_matches_abstract(tmp_path):
    tree = med_tree()
    leaves = flatten_with_paths(tree)
    abstract = flatten_with_paths(meta_struct(tree))
    p1 = plan_dump(leaves, step=7, chunk_bytes=4096)
    p2 = plan_dump(abstract, step=7, chunk_bytes=4096)
    assert p1 == p2                       # abstract planning == concrete
    assert p1.image_id == "step_0000000007"
    assert p1.total_bytes == sum(a.numel() * a.element_size() for _, a in leaves)
    with pytest.raises(Exception):        # frozen: plans are immutable
        p1.step = 9


def test_plan_resolves_codec_applicability_up_front():
    tree = {"opt": {"m": torch.ones(64)},
            "params": {"w": torch.ones(64)}}
    leaves = flatten_with_paths(tree)
    policy = default_policy(lossy_optimizer=True)
    # no parent baseline -> delta8 falls back to raw at PLAN time
    p = plan_dump(leaves, step=1, codec_policy=policy)
    assert all(lp.codec == "none" and not lp.use_prev for lp in p.leaves)
    prev = {pth: to_host(a) for pth, a in leaves}
    p2 = plan_dump(leaves, step=2, codec_policy=policy, prev_host_tree=prev)
    by_path = {lp.path: lp for lp in p2.leaves}
    assert by_path["opt/m"].codec == "delta8" and by_path["opt/m"].use_prev
    assert by_path["params/w"].codec == "none"


# --------------------------------------------------------- replica repair
def test_read_chunk_verified_repairs_primary(tmp_ckpt):
    mem = MemoryTier()
    ck = Checkpointer(tmp_ckpt, replicas=[mem], device=CPU)
    ck.save(med_tree(), step=1)
    victim = glob.glob(os.path.join(tmp_ckpt, "chunks", "*.bin"))[0]
    h = os.path.basename(victim).removesuffix(".bin")
    with open(victim, "wb") as f:
        f.write(b"junk")
    data = read_chunk_verified(ck.tier, [mem], h, "step_0000000001")
    assert sha256(data) == h
    with open(victim, "rb") as f:         # repaired in place
        assert f.read() == data


def test_read_chunk_verified_missing_everywhere_raises(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, device=CPU)
    ck.save(med_tree(), step=1)
    with pytest.raises(KeyError):
        read_chunk_verified(ck.tier, [MemoryTier()], "ab" * 32, "img")


def test_pipelined_restore_repairs_from_replica(tmp_ckpt):
    mem = MemoryTier()
    ck = Checkpointer(tmp_ckpt, replicas=[mem], chunk_bytes=4096, device=CPU)
    tree = med_tree()
    ck.save(tree, step=1)
    for victim in glob.glob(os.path.join(tmp_ckpt, "chunks", "*.bin"))[:3]:
        os.remove(victim)                 # missing, not just corrupt
    got, _ = ck.load_latest()
    assert trees_equal(tree, got)
    got2, _ = restore(tmp_ckpt, device=CPU)           # primary fully repaired
    assert trees_equal(tree, got2)


def test_pipelined_corruption_without_replica_raises(tmp_ckpt, flaky_tier):
    ck = Checkpointer(tmp_ckpt, chunk_bytes=4096, device=CPU)
    ck.save(med_tree(), step=1)
    # every chunk READ returns flipped bytes (manifests spared) — the
    # integrity layer must refuse, not hand back wrong numbers
    bad = flaky_tier(tmp_ckpt, corrupt_read_rate=1.0, only="chunks/")
    with pytest.raises(CorruptionError):
        restore(bad, device=CPU)
    assert bad.stats["reads_corrupted"] > 0


def test_restore_repairs_through_flaky_primary(tmp_ckpt, flaky_tier):
    """Bitrot at read time on the primary, clean replica: every leaf must
    come back bit-identical via hash-verified replica reads (the shared
    fault-injection fixture replaces per-test hand corruption)."""
    mem = MemoryTier()
    tree = med_tree()
    Checkpointer(tmp_ckpt, replicas=[mem], chunk_bytes=4096, device=CPU).save(
        tree, step=1)
    bad = flaky_tier(tmp_ckpt, corrupt_read_rate=0.7, seed=11,
                     only="chunks/")
    got, _ = Checkpointer(bad, replicas=[mem], device=CPU).load_latest()
    assert trees_equal(tree, got)
    assert bad.stats["reads_corrupted"] > 0


def test_dropped_chunk_writes_covered_by_replica(tmp_ckpt, flaky_tier):
    """A primary that ACKS chunk writes and loses them (lying write-back
    cache): the dump still commits, and restore self-heals from the
    replica — the paper's network-file-system row under a harsher fault
    than CRIU ever tested."""
    mem = MemoryTier()
    bad = flaky_tier(tmp_ckpt, drop_write_rate=0.6, seed=7, only="chunks/")
    tree = med_tree()
    Checkpointer(bad, replicas=[mem], chunk_bytes=4096, device=CPU).save(tree, step=1)
    assert bad.stats["writes_dropped"] > 0
    got, _ = Checkpointer(tmp_ckpt, replicas=[mem], device=CPU).load_latest()
    assert trees_equal(tree, got)


def test_transient_errors_storm_then_settle(tmp_ckpt, flaky_tier):
    """Injected TimeoutError/IOError with a per-op budget: a one-shot
    engine call fails loudly mid-storm; once the schedule's budget is
    spent (transient fault passed), the SAME tier completes a clean dump
    and a bit-identical restore — no torn image survives the storm."""
    bad = flaky_tier(tmp_ckpt, error_rate=0.5, seed=3, error_budget=1)
    tree = med_tree()
    ck = Checkpointer(bad, chunk_bytes=4096, serial=True, device=CPU)
    out = None
    for _ in range(50):                 # each retry spends >=1 budget
        try:
            out = ck.save(tree, step=1)
            break
        except (TimeoutError, IOError):
            continue
    assert out is not None, "fault budget never drained"
    assert bad.stats["errors_injected"] > 0
    got = None
    for _ in range(50):                 # reads spend their own budgets
        try:
            got, _ = ck.load(out["image_id"])
            break
        except (TimeoutError, IOError):
            continue
    assert got is not None and trees_equal(tree, got)


# ------------------------------------------------- multi-process merge
@pytest.mark.parametrize("serial", [True, False])
def test_merge_parts_multiprocess_under_executor(tmp_ckpt, serial):
    tree = med_tree(leaves=5)
    ex = CheckpointExecutor(serial=serial)
    # worker processes dump their partitions first; process 0 merges last
    dump(tree, tmp_ckpt, step=1, process_index=1, num_processes=2,
         executor=ex, device=CPU)
    out = dump(tree, tmp_ckpt, step=1, process_index=0, num_processes=2,
               executor=ex, device=CPU)
    got, man = restore(tmp_ckpt, device=CPU)
    assert trees_equal(tree, got)
    paths = [r["path"] for r in man["leaves"]]
    assert paths == sorted(paths)         # merge sorts leaves by path
    assert len(paths) == len(flatten_with_paths(tree))
    assert out["stats"]["chunks"] < len(paths) + 1  # partition, not all
    if not serial:
        ex.close()


def test_merge_parts_rewrites_manifest_only(tmp_ckpt):
    tree = med_tree(leaves=4)
    for pi in (1, 0):
        dump(tree, tmp_ckpt, step=1, process_index=pi, num_processes=2,
             device=CPU)
    tier = LocalDirTier(tmp_ckpt)
    merge_parts(tier, "step_0000000001", 2)   # idempotent re-merge
    got, _ = restore(tmp_ckpt, device=CPU)
    assert trees_equal(tree, got)


# ---------------------------------------------------- crash mid-dump
class FlakyTier(LocalDirTier):
    """Fails every chunk write after the first ``allow`` (crash injection)."""

    def __init__(self, root, allow=3):
        super().__init__(root, fsync=False)
        self.allow = allow
        self.chunk_writes = 0

    def write_bytes(self, rel, data, atomic=False):
        if rel.startswith("chunks/"):
            self.chunk_writes += 1
            if self.chunk_writes > self.allow:
                raise IOError(f"injected crash at chunk {self.chunk_writes}")
        super().write_bytes(rel, data, atomic)


@pytest.mark.parametrize("serial", [True, False])
def test_crash_mid_dump_leaves_only_unreferenced_chunks(tmp_path, serial):
    root = str(tmp_path / "ck")
    tier = FlakyTier(root, allow=10 ** 9)
    ck = Checkpointer(tier, serial=serial, chunk_bytes=4096, device=CPU)
    tree = med_tree(0)
    ck.save(tree, step=1)
    tier.allow = tier.chunk_writes + 2    # next dump dies mid-write
    with pytest.raises(IOError, match="injected crash"):
        ck.save(med_tree(1), step=2)
    # no manifest was committed: previous image intact, orphans collectable
    got, man = restore(root, device=CPU)
    assert man["image_id"] == "step_0000000001"
    assert trees_equal(tree, got)
    # gc through the OWNING registry: it shares the dumper's tier, so the
    # in-memory chunk index stays truthful after eviction
    stats = ck.registry.gc()
    assert stats["removed"] >= 1          # the orphaned partial chunks
    got2, _ = restore(root, device=CPU)               # image still valid after gc
    assert trees_equal(tree, got2)
    # and the engine recovers: a later dump on the same tier succeeds
    tier.allow = 10 ** 9
    ck.save(med_tree(1), step=3)
    got3, _ = ck.load_latest()
    assert trees_equal(med_tree(1), got3)


# ------------------------------------------------- chunk index caching
def test_chunk_index_eliminates_per_chunk_probes(tmp_path):
    tier = LocalDirTier(str(tmp_path / "ck"), fsync=False)
    ck = Checkpointer(tier, chunk_bytes=4096, device=CPU)
    tree = med_tree()
    out1 = ck.save(tree, step=1)
    tier.stat_calls = 0
    out2 = ck.save(tree, step=2)          # identical -> all dedup
    assert out2["stats"]["chunks_deduped"] == out2["stats"]["chunks"]
    assert out2["stats"]["bytes_stored"] == 0
    # cached index: probes don't scale with chunk count
    assert tier.stat_calls < out1["stats"]["chunks"] // 2


def test_chunk_index_survives_gc_eviction(tmp_path):
    """gc must evict deleted chunks from the in-memory index, or a later
    dump would dedup against a chunk that no longer exists."""
    tier = LocalDirTier(str(tmp_path / "ck"), fsync=False)
    ck = Checkpointer(tier, keep_last=1, incremental=False,
                      chunk_bytes=4096, device=CPU)
    t1, t2 = med_tree(1), med_tree(2)
    ck.save(t1, step=1)
    ck.save(t2, step=2)                   # retention evicts image 1,
    #                                       gc removes t1's chunks
    ck.save(t1, step=3)                   # t1's content again: must rewrite
    got, _ = ck.load_latest()
    assert trees_equal(t1, got)


# --------------------------------------------- manifest / parent caching
class CountingTier(LocalDirTier):
    def __init__(self, root):
        super().__init__(root, fsync=False)
        self.manifest_reads = 0

    def read_bytes(self, rel):
        if rel.endswith("manifest.json"):
            self.manifest_reads += 1
        return super().read_bytes(rel)


def test_delta8_chain_restore_parses_each_manifest_once(tmp_path):
    tier = CountingTier(str(tmp_path / "ck"))
    ck = Checkpointer(tier, keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    base = {"opt": {"m": {f"l{i}": normal(i, (512,)) for i in range(8)}}}
    ck.save(base, step=1)
    cur = base
    for s in (2, 3):                      # chain: 3 -> 2 -> 1
        cur = tmap(lambda x: x + 0.001, cur)
        ck.save(cur, step=s)
    tier.manifest_reads = 0
    plan = plan_restore(tier, "step_0000000003")
    assert plan.chain_depth == 3
    ex = CheckpointExecutor(serial=True)
    pairs = ex.run_restore(plan, tier, [], device=CPU)
    # O(chain) manifest parses, NOT O(leaves x chain)
    assert tier.manifest_reads == 3
    assert len(pairs) == 8
    got, _ = ck.load_latest()
    err = max(float((got["opt"]["m"][f"l{i}"]
                     - cur["opt"]["m"][f"l{i}"]).abs().max())
              for i in range(8))
    assert err < 1e-4                     # delta8 bounded error


# ------------------------------------------------------------- async
def test_async_shared_executor_ordering_and_errors(tmp_path):
    ck = Checkpointer(str(tmp_path / "ok"), keep_last=10, device=CPU)
    trees = [med_tree(s) for s in range(3)]
    for s, t in enumerate(trees):
        ck.save_async(t, step=s + 1)
    ck.wait()
    reg = Registry(str(tmp_path / "ok"))
    assert [m["step"] for m in reg.images()] == [1, 2, 3]
    assert [m["parent"] for m in reg.images()] == \
        [None, "step_0000000001", "step_0000000002"]  # causal chain
    got, _ = ck.load_latest()
    assert trees_equal(got, trees[-1])

    bad = FlakyTier(str(tmp_path / "bad"), allow=2)
    ck2 = Checkpointer(bad, device=CPU)
    ck2.save_async(med_tree(), step=1)
    with pytest.raises(IOError, match="injected crash"):
        ck2.wait()


def opt_tree(seed=0, shift=0.0):
    base = {"opt": {"m": {f"l{i}": normal(seed + i, (512,))
                          for i in range(4)}}}
    return tmap(lambda x: x + shift, base) if shift else base


def max_err(a, b):
    return max(float((torch.as_tensor(x) - torch.as_tensor(y)).abs().max())
               for (_, x), (_, y) in zip(flatten_with_paths(a),
                                         flatten_with_paths(b)))


def test_async_delta8_baseline_tracks_runtime_parent(tmp_path):
    """save(t1); save_async(t2); save_async(t3): each async delta must be
    encoded against the tree of the image it resolves as parent at run
    time, not a stale sync-save baseline (silent-corruption regression)."""
    bump = 0.5
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    t1 = opt_tree()
    t2 = tmap(lambda x: x + bump, t1)
    t3 = tmap(lambda x: x + bump, t2)
    ck.save(t1, step=1)
    ck.save_async(t2, step=2)
    ck.save_async(t3, step=3)
    ck.wait()
    reg = Registry(str(tmp_path / "ck"))
    assert [m["parent"] for m in reg.images()] == \
        [None, "step_0000000001", "step_0000000002"]
    got, _ = ck.load_latest()
    assert max_err(got, t3) <= bump / 254 + 1e-6  # documented delta8 bound


def test_sync_save_drains_pending_async(tmp_path):
    """save() after save_async(): the sync dump must see the async images
    committed (causal parent chain) and gc must not run while they are
    still writing."""
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=10, device=CPU)
    ck.save_async(med_tree(0), step=1)
    ck.save_async(med_tree(1), step=2)
    ck.save(med_tree(2), step=3)
    reg = ck.registry
    assert [m["step"] for m in reg.images()] == [1, 2, 3]
    assert [m["parent"] for m in reg.images()] == \
        [None, "step_0000000001", "step_0000000002"]
    for s in (1, 2, 3):
        got, _ = ck.load(f"step_{s:010d}")
        assert trees_equal(got, med_tree(s - 1))


def test_delta_baseline_dropped_when_parent_image_lost(tmp_path):
    """If the image the cached baseline belongs to is gone by dump time,
    the delta must be dropped (full encode), never applied against a
    different parent."""
    tier = LocalDirTier(str(tmp_path / "ck"), fsync=False)
    ck = Checkpointer(tier, keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    t1 = opt_tree()
    ck.save(t1, step=1)
    tier.delete("images/step_0000000001")   # parent lost out-of-band
    ck.registry.gc()
    t2 = tmap(lambda x: x + 1.0, t1)
    ck.save(t2, step=2)
    got, man = ck.load_latest()
    assert man["parent"] is None
    assert trees_equal(got, t2)             # full encode: bit-exact


def test_python_scalar_leaves_roundtrip(tmp_path):
    """Plain int/float pytree leaves checkpointed fine in the serial
    seed engine; plan_dump must coerce them too."""
    ck = Checkpointer(str(tmp_path / "ck"), device=CPU)
    tree = {"params": normal(0, (128,)),
            "epoch": 3, "lr": 0.125}
    ck.save(tree, step=1)
    got, _ = ck.load_latest()
    assert trees_equal(got, tree)


def test_retention_prunes_full_encode_incremental_images(tmp_path):
    """Parent links are plain bookkeeping on full-encode images; only
    applied delta8 leaves pin the parent. keep_last must actually
    delete (was: every ancestor kept transitively -> retention no-op)."""
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=2, device=CPU)
    for s in range(1, 7):
        ck.save(med_tree(s), step=s)
    assert [m["step"] for m in ck.registry.images()] == [5, 6]
    for s in (5, 6):                      # both survivors restorable
        got, _ = ck.load(f"step_{s:010d}")
        assert trees_equal(got, med_tree(s))


def test_step_reuse_does_not_write_self_parent(tmp_path):
    """Re-dumping an existing step overwrites that image; linking the
    new image to it would be a self-parent cycle whose restore never
    terminates."""
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    t1 = opt_tree()
    t2 = tmap(lambda x: x + 1.0, t1)
    ck.save(t1, step=5)
    ck.save(t2, step=5)                   # same image id, fresh chain
    got, man = ck.load_latest()
    assert man["parent"] is None
    assert trees_equal(got, t2)


def test_rollback_redump_truncates_divergent_future(tmp_path):
    """Re-dumping an OLDER step rewrites history: the future images
    delta-depend on (or would cycle with) the image being overwritten,
    so they are deleted and the chain restarts."""
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    t1 = opt_tree()
    t2 = tmap(lambda x: x + 1.0, t1)
    t1b = tmap(lambda x: x - 1.0, t1)
    ck.save(t1, step=1)
    ck.save(t2, step=2)
    ck.save(t1b, step=1)                  # rollback re-dump
    imgs = ck.registry.images()
    assert [m["step"] for m in imgs] == [1]
    got, man = ck.load_latest()
    assert man["parent"] is None          # fresh chain, no cycle
    assert trees_equal(got, t1b)          # full encode: bit-exact


def test_cyclic_parent_chain_raises_not_hangs(tmp_path):
    """A corrupt A<->B parent cycle must raise CorruptionError at plan
    time, not deadlock the executor on its own memo future."""
    from repro.core import manifest as manifest_mod
    tier = LocalDirTier(str(tmp_path / "ck"), fsync=False)
    ck = Checkpointer(tier, keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    t1 = opt_tree()
    ck.save(t1, step=1)
    ck.save(tmap(lambda x: x + 0.5, t1), step=2)
    man2 = plan_restore(tier, "step_0000000002").manifest
    assert man2["parent"] == "step_0000000001"
    # forge image 1 as a delta image whose parent is image 2 (valid digest)
    forged = manifest_mod.build("step_0000000001", step=1,
                                leaves=list(man2["leaves"]),
                                meta={}, parent="step_0000000002",
                                env=man2["env"], topology=man2["topology"])
    tier.write_bytes(tier.manifest_path("step_0000000001"),
                     manifest_mod.to_json(forged), atomic=True)
    with pytest.raises(CorruptionError, match="cyclic parent chain"):
        plan_restore(tier, "step_0000000002")


def test_sync_drain_preserves_async_results_for_wait(tmp_path):
    """save() drains the async lane; the drained results still belong to
    the next wait() caller."""
    ck = Checkpointer(str(tmp_path / "ck"), keep_last=10, device=CPU)
    ck.save_async(med_tree(0), step=1)
    ck.save(med_tree(1), step=2)          # drains the async dump
    ck.save_async(med_tree(2), step=3)
    out = ck.wait()
    assert [o["image_id"] for o in out] == \
        ["step_0000000001", "step_0000000003"]
    assert ck.wait() == []                # barrier semantics: consumed


def test_failed_barrier_preserves_committed_results(tmp_path):
    """A barrier holding one committed and one failed dump raises, but
    the committed dump's record is durable and owed to the next wait()."""
    probe = FlakyTier(str(tmp_path / "probe"), allow=10 ** 9)
    Checkpointer(probe, device=CPU).save(med_tree(0), step=1)
    n = probe.chunk_writes                # writes one identical dump needs
    bad = FlakyTier(str(tmp_path / "bad"), allow=n)
    ck = Checkpointer(bad, keep_last=10, device=CPU)
    ck.save_async(med_tree(0), step=1)    # exactly n writes: commits
    ck.save_async(med_tree(1), step=2)    # dies on its first new chunk
    with pytest.raises(IOError, match="injected crash"):
        ck.wait()
    out = ck.wait()
    assert [o["image_id"] for o in out] == ["step_0000000001"]


def test_wait_barriers_are_independent(tmp_path):
    """A failure surfaced by one wait() must not resurface on a later,
    healthy barrier, and results are per-barrier."""
    bad = FlakyTier(str(tmp_path / "bad"), allow=2)
    ck = Checkpointer(bad, device=CPU)
    ck.save_async(med_tree(0), step=1)
    with pytest.raises(IOError, match="injected crash"):
        ck.wait()
    bad.allow = 10 ** 9                   # tier recovers
    ck.save_async(med_tree(1), step=2)
    out = ck.wait()                       # no stale error, fresh results
    assert len(out) == 1
    got, _ = ck.load_latest()
    assert trees_equal(got, med_tree(1))


def test_non_incremental_delta_policy_stays_restorable(tmp_path):
    """incremental=False never writes a parent link, so a delta8 policy
    must fall back to full encodes — an applied delta with parent=None is
    unrestorable."""
    ck = Checkpointer(str(tmp_path / "ck"), incremental=False, keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True), device=CPU)
    t1 = opt_tree()
    t2 = tmap(lambda x: x + 1.0, t1)
    ck.save(t1, step=1)
    ck.save(t2, step=2)
    got, man = ck.load_latest()
    assert man["parent"] is None
    assert trees_equal(got, t2)           # full encode: bit-exact
    t3 = tmap(lambda x: x + 2.0, t1)
    ck.save_async(t3, step=3)             # async path: same rule
    ck.wait()
    got3, man3 = ck.load_latest()
    assert man3["parent"] is None
    assert trees_equal(got3, t3)


def test_gc_spares_live_tmp_reaps_stray_tmp(tmp_path):
    tier = LocalDirTier(str(tmp_path / "ck"), fsync=False)
    ck = Checkpointer(tier, chunk_bytes=4096, device=CPU)
    ck.save(med_tree(), step=1)
    cdir = os.path.join(tier.root, "chunks")
    live = os.path.join(
        cdir, f"aa.bin.tmp.{os.getpid()}.{threading.get_ident()}")
    fresh_dead = os.path.join(cdir, "bb.bin.tmp.999999999.1")
    quiet_dead = os.path.join(cdir, "dd.bin.tmp.999999999.2")
    aged = os.path.join(cdir, "cc.bin.partial")   # no parseable pid
    for p in (live, fresh_dead, quiet_dead, aged):
        with open(p, "wb") as f:
            f.write(b"x")
    old = time.time() - 3600
    os.utime(aged, (old, old))
    quiet = time.time() - 120
    os.utime(quiet_dead, (quiet, quiet))
    ck.registry.gc()
    assert os.path.exists(live)        # live writer's tmp: untouched
    # dead-looking pid but written seconds ago: could be a live writer on
    # another host of a shared tier — kept
    assert os.path.exists(fresh_dead)
    assert not os.path.exists(quiet_dead)  # dead pid + quiet: reaped
    assert not os.path.exists(aged)    # pid unknown + long-aged: reaped
    os.utime(live, (old, old))         # a LIVE pid vetoes reaping outright
    ck.registry.gc()                   # (hung-FS write must keep its tmp)
    assert os.path.exists(live)
    os.remove(live)                    # leave the pool clean
    os.remove(fresh_dead)


# ------------------------------------------------ cross-package: the plan
def test_plan_dump_equals_jax_plan():
    """The same tree, keys inserted out of order, planned by both packages
    under a mixed codec policy with a delta8 baseline, for each process
    of two: every field of the plan is equal, the leaf records (paths,
    codecs, dtypes, shapes, nbytes, use_prev) in the same order. The
    port flattens in sorted key order, as JAX does (ROADMAP §3)."""
    import dataclasses

    import jax.numpy as jnp

    from repro.core.dump import flatten_with_paths as jflatten
    from repro.core.plan import plan_dump as jplan_dump

    rng = np.random.default_rng(11)
    host = {"step": np.asarray(4, np.int32),
            "params": {"wz": rng.standard_normal((40, 8)).astype(np.float32),
                       "emb": rng.standard_normal(999).astype(np.float32)},
            "opt": {"v": {"wz": np.abs(rng.standard_normal((40, 8))).astype(
                np.float32)},
                    "m": {"wz": rng.standard_normal((40, 8)).astype(
                        np.float32),
                          "tiny": np.ones(3, np.float32)}},
            "count": np.arange(7, dtype=np.int32)}
    policy = default_policy(lossy_optimizer=True)
    prev = {"opt/m/wz": host["opt"]["m"]["wz"] * np.float32(0.5)}
    jleaves = jflatten(tmap(jnp.asarray, host))
    tleaves = flatten_with_paths(tmap(lambda a: torch.from_numpy(a.copy()),
                                      host))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for pi in (0, 1):
        kw = dict(step=4, parent="step_0000000003", codec_policy=policy,
                  prev_host_tree=prev, chunk_bytes=4096, process_index=pi,
                  num_processes=2)
        pj, pt = jplan_dump(jleaves, **kw), plan_dump(tleaves, **kw)
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
        assert pt.leaves                  # the partition is not empty
    full = plan_dump(tleaves, step=4, codec_policy=policy,
                     prev_host_tree=prev)
    assert {lp.codec for lp in full.leaves} == {"none", "delta8"}
