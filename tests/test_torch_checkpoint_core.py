"""The port's C/R engine: the twin of tests/test_checkpoint_core.py (all 11
tests: chunking, manifests, incremental dedup, retention/gc, corruption
repair, async ordering, atomic commit, delta8), on seeded torch trees with
``device="cpu"`` at every entry point; plus the image-format contract
across packages: the same seeded tree gives the same chunk digests and
the same manifest (apart from ``env``, ``created_at`` and ``digest``) in
both, and an image a SIGKILLed port trainer left on a ``file://`` tier is
read by the JAX package's registry and restores bit-identically there."""
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import subprocess_env  # noqa: E402
from repro_torch.core import (Checkpointer, CorruptionError,  # noqa: E402
                              MemoryTier, Registry, restore, train_meta)
from repro_torch.core import chunking  # noqa: E402
from repro_torch.core.compression import default_policy  # noqa: E402
from repro_torch.core.dump import dump, flatten_with_paths  # noqa: E402
from repro_torch.core.storage import LocalDirTier  # noqa: E402

CPU = "cpu"
SKIP = ("env", "created_at", "digest")


def small_tree(seed=0, delta=0.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    return {
        "params": {"w": torch.from_numpy(w) + delta,
                   "b": torch.zeros(32)},
        "opt": {"m": {"w": torch.zeros(64, 32), "b": torch.zeros(32)}},
        "step": torch.tensor(3, dtype=torch.int32),
    }


def copy_tree(tree):
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    return tree.clone()


def meta_struct(tree):
    """The tree's shapes and dtypes as ``meta`` tensors (no memory): the
    port's counterpart of ``jax.eval_shape``."""
    if isinstance(tree, dict):
        return {k: meta_struct(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def trees_equal(a, b):
    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for (_, x), (_, y) in zip(la, lb))


# ----------------------------------------------------------------- chunking
def test_chunk_roundtrip_exact():
    arr = np.random.default_rng(0).standard_normal((1000, 7)).astype(np.float32)
    rec = chunking.leaf_record("x", arr, chunk_bytes=4096)
    # streaming path: records carry hashes only; payloads are zero-copy
    # views over the serialized leaf
    blobs = {h: bytes(v) for h, v in
             chunking.chunk_views(chunking.leaf_to_bytes(arr), 4096)}
    assert list(blobs) == rec["chunks"][:len(blobs)]
    out = chunking.assemble_leaf(rec, blobs.__getitem__)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    assert np.array_equal(out, arr)


def test_chunk_granularity_drives_dedup(tmp_ckpt):
    arr = np.zeros(1 << 16, np.float32)
    t1 = {"x": torch.from_numpy(arr)}
    ck = Checkpointer(tmp_ckpt, chunk_bytes=4096, device=CPU)
    ck.save(t1, step=1)
    arr2 = arr.copy()
    arr2[0] = 1.0  # touch one chunk only
    out = ck.save({"x": torch.from_numpy(arr2)}, step=2)
    s = out["stats"]
    assert s["chunks_deduped"] > 0
    assert s["bytes_stored"] < s["bytes_raw"] / 4


# ----------------------------------------------------------------- manifest
def test_manifest_digest_tamper_detected(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, device=CPU)
    out = ck.save(small_tree(), step=1)
    tier = LocalDirTier(tmp_ckpt)
    p = tier.manifest_path(out["image_id"])
    blob = tier.read_bytes(p).replace(b'"step": 1', b'"step": 2')
    tier.write_bytes(p, blob)
    with pytest.raises(ValueError, match="digest"):
        restore(tmp_ckpt, device=CPU)


def test_roundtrip_bitwise_and_meta(tmp_ckpt):
    """``env`` names the dumping framework: the port records ``torch``
    where the JAX package records ``jax`` (ROADMAP, "The contract is the
    image format": ``env`` is one of the three fields allowed to differ)."""
    tree = small_tree()
    ck = Checkpointer(tmp_ckpt, device=CPU)
    ck.save(tree, step=3, meta=train_meta(
        arch="qwen3-8b", step=3, data_state={"step": 3, "global_batch": 8,
                                             "seq_len": 16, "dataset": {}}))
    got, man = ck.load_latest(target_struct=meta_struct(tree))
    assert trees_equal(tree, got)
    assert man["meta"]["arch"] == "qwen3-8b"
    assert man["env"]["torch"]  # fingerprint recorded


# -------------------------------------------------------------- incremental
def test_incremental_parent_chain_and_savings(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, keep_last=10, device=CPU)
    ck.save(small_tree(0), step=1)
    out2 = ck.save(small_tree(0, delta=0.0), step=2)  # identical content
    assert out2["stats"]["bytes_stored"] == 0
    assert out2["stats"]["chunks_deduped"] == out2["stats"]["chunks"]
    man = restore(tmp_ckpt, device=CPU)[1]
    assert man["parent"] == "step_0000000001"


def test_retention_and_gc(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, keep_last=2, incremental=False, device=CPU)
    for s in range(1, 6):
        ck.save(small_tree(s), step=s)
    reg = Registry(tmp_ckpt)
    ids = [m["image_id"] for m in reg.images()]
    assert ids == ["step_0000000004", "step_0000000005"]
    # gc removed chunks of deleted images
    stats = reg.gc()
    assert stats["removed"] == 0  # retain() already gc'ed via Checkpointer
    got, _ = ck.load_latest()
    assert trees_equal(got, small_tree(5))


# -------------------------------------------------------------- corruption
def test_corruption_without_replica_raises(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, device=CPU)
    ck.save(small_tree(), step=1)
    for chunk in glob.glob(os.path.join(tmp_ckpt, "chunks", "*.bin")):
        with open(chunk, "wb") as f:
            f.write(b"junk")
    with pytest.raises(CorruptionError):
        restore(tmp_ckpt, device=CPU)


def test_corruption_repaired_from_replica(tmp_ckpt):
    mem = MemoryTier()
    ck = Checkpointer(tmp_ckpt, replicas=[mem], device=CPU)
    tree = small_tree()
    ck.save(tree, step=1)
    victim = glob.glob(os.path.join(tmp_ckpt, "chunks", "*.bin"))[0]
    with open(victim, "wb") as f:
        f.write(b"junk")
    got, _ = ck.load_latest()
    assert trees_equal(tree, got)
    # and the primary was repaired in place
    got2, _ = restore(tmp_ckpt, device=CPU)  # no replica this time
    assert trees_equal(tree, got2)


# ------------------------------------------------------------ atomic commit
def test_crash_mid_dump_leaves_previous_image_valid(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, device=CPU)
    tree = small_tree()
    ck.save(tree, step=1)
    # simulate a crash after chunk writes but before manifest commit:
    # write orphan chunks only
    tier = LocalDirTier(tmp_ckpt)
    tier.write_chunk("deadbeef" * 8, b"orphan-data")
    os.makedirs(os.path.join(tmp_ckpt, "images", "step_0000000002"),
                exist_ok=True)  # partial dir, no manifest
    got, man = restore(tmp_ckpt, device=CPU)
    assert man["image_id"] == "step_0000000001"
    assert trees_equal(tree, got)
    assert Registry(tmp_ckpt).gc()["removed"] == 1  # orphan collected


# -------------------------------------------------------------------- async
def test_async_ordering_and_durability(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, keep_last=10, device=CPU)
    trees = [small_tree(s) for s in range(3)]
    for s, t in enumerate(trees):
        ck.save_async(t, step=s + 1)
    ck.wait()
    reg = Registry(tmp_ckpt)
    assert [m["step"] for m in reg.images()] == [1, 2, 3]
    got, _ = ck.load_latest()
    assert trees_equal(got, trees[-1])


# --------------------------------------------------------------- delta8
def test_delta8_bounded_error_and_parent_chain(tmp_ckpt):
    ck = Checkpointer(tmp_ckpt, keep_last=10,
                      codec_policy=default_policy(lossy_optimizer=True),
                      device=CPU)
    t1 = small_tree(0)
    ck.save(t1, step=1)
    t2 = copy_tree(t1)
    bump = 0.01 * torch.from_numpy(np.random.default_rng(9).standard_normal(
        (64, 32)).astype(np.float32))
    t2["opt"]["m"]["w"] = t1["opt"]["m"]["w"] + bump
    ck.save(t2, step=2)
    got, _ = ck.load_latest()
    err = float((got["opt"]["m"]["w"] - t2["opt"]["m"]["w"]).abs().max())
    assert err <= float(bump.abs().max()) / 254 + 1e-7
    assert trees_equal(got["params"], t2["params"])  # params lossless


# ------------------------------------------------ cross-package: the format
def test_same_tree_same_chunks_and_manifest_as_jax():
    """One seeded tree at chunk_bytes=4096 through both packages' dump:
    every leaf's chunk digests are equal, and the manifests are equal
    apart from env, created_at and digest (compared exactly)."""
    import jax.numpy as jnp

    from repro.core.dump import dump as jdump
    from repro.core.storage import MemoryTier as JMemoryTier

    rng = np.random.default_rng(5)
    host = {"params": {"w": rng.standard_normal((300, 17)).astype(np.float32),
                       "b": rng.standard_normal(4099).astype(np.float32)},
            "opt": {"m": {"w": np.zeros((300, 17), np.float32)}},
            "step": np.asarray(7, np.int32)}

    def tmap(fn, t):
        return {k: tmap(fn, v) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    jt, tt = JMemoryTier(), MemoryTier()
    oj = jdump(tmap(jnp.asarray, host), jt, step=7, chunk_bytes=4096)
    ot = dump(tmap(lambda a: torch.from_numpy(a.copy()), host), tt, step=7,
              chunk_bytes=4096, device=CPU)
    assert oj["image_id"] == ot["image_id"]
    mj = json.loads(jt.read_bytes(jt.manifest_path(oj["image_id"])))
    mt = json.loads(tt.read_bytes(tt.manifest_path(ot["image_id"])))
    assert [r["chunks"] for r in mj["leaves"]] == \
        [r["chunks"] for r in mt["leaves"]]
    assert sum(len(r["chunks"]) for r in mt["leaves"]) > 4
    assert {k: v for k, v in mj.items() if k not in SKIP} == \
        {k: v for k, v in mt.items() if k not in SKIP}
    assert sorted(jt.listdir("chunks")) == sorted(tt.listdir("chunks"))


# ------------------------------------- cross-package: a SIGKILLed writer
def _names(root):
    try:
        return set(os.listdir(os.path.join(root, "chunks")))
    except FileNotFoundError:
        return set()


def _bytes_of(root, names):
    n = 0
    for name in names:
        try:
            n += os.path.getsize(os.path.join(root, "chunks", name))
        except FileNotFoundError:   # a tmp file renamed under the scan
            pass
    return n


def kill_during_dump(proc, root, before: int, victim: int, timeout=300.0,
                     poll_s=0.002):
    """SIGKILL ``proc`` once the dump of step ``victim`` has put chunk or
    temporary files into ``root``'s pool beyond the step-``before``
    image's set, before that dump's manifest exists. -> (the dump's files
    left in the pool, their bytes). Fails when the kill cannot land
    mid-dump."""
    man = os.path.join(root, "images", "step_%010d" % before,
                       "manifest.json")
    late = os.path.join(root, "images", "step_%010d" % victim,
                        "manifest.json")
    t0 = time.time()
    while not os.path.exists(man):
        assert proc.poll() is None, f"trainer exited {proc.returncode} " \
                                    f"before its step-{before} image"
        assert time.time() - t0 < timeout, f"no step-{before} image"
        time.sleep(0.01)
    base = _names(root)
    while True:
        new = _names(root) - base
        if new and not os.path.exists(late):
            proc.send_signal(signal.SIGKILL)
            break
        assert not os.path.exists(late), \
            f"the step-{victim} manifest was committed before a new chunk " \
            f"showed up: the poll missed the dump"
        assert proc.poll() is None, f"trainer exited {proc.returncode}"
        assert time.time() - t0 < timeout, f"no step-{victim} dump"
        time.sleep(poll_s)
    proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    assert not os.path.exists(late), \
        f"the kill landed after the step-{victim} manifest was committed"
    left = _names(root) - base
    return left, _bytes_of(root, left)


def test_sigkilled_port_writer_image_reads_in_jax(tmp_path):
    """A port trainer (CPU subprocess, the normal entry point) SIGKILLed
    in the middle of its step-8 dump to a file:// tier: the JAX package's
    Registry sees the same latest image (step 4) as the port's, and the
    JAX restore of it equals the port's byte for byte."""
    from repro.core.registry import Registry as JRegistry
    from repro.core.restore import restore as jrestore

    root = str(tmp_path / "ck")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "gemma2-2b", "--tiny", "--d-model", "256",
            "--vocab", "32768", "--steps", "10", "--global-batch", "2",
            "--seq-len", "32", "--ckpt-every", "4", "--log-every", "1",
            "--data-dir", str(tmp_path / "data"), "--ckpt-dir",
            "file://" + root, "--step-delay", "0.05"]
    with open(tmp_path / "victim.log", "w") as log:
        proc = subprocess.Popen(args, env=subprocess_env(), stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            left, _ = kill_during_dump(proc, root, before=4, victim=8)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert left                 # the step-8 dump had begun
    latest_t = Registry(root).latest()
    latest_j = JRegistry(root).latest()
    assert latest_t["image_id"] == latest_j["image_id"] == "step_0000000004"
    _, man_t, pairs_t = restore(root, device=CPU, with_pairs=True)
    _, man_j, pairs_j = jrestore(root, with_pairs=True)
    assert man_t["image_id"] == man_j["image_id"] == "step_0000000004"
    assert man_t["digest"] == man_j["digest"]
    assert sorted(pairs_t) == sorted(pairs_j)
    for p in pairs_t:
        a, b = np.asarray(pairs_t[p]), np.asarray(pairs_j[p])
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes(), p
