"""Pre-copy (iterative pre-dump) and post-copy (lazy restore) on the port:
the twin of tests/test_predump_lazy.py on torch state with device="cpu",
plus the cross-package contracts.

The invariants that make the latency features safe to use:

  * a residual dump after pre-dump rounds restores BIT-IDENTICAL to a
    monolithic dump of the same state — the freeze window shrinks, the
    image does not change; a residual dump never copies a reused leaf to
    the host;
  * lazy restore, fully faulted, equals the eager restore bit-for-bit, and
    every leaf it serves is a tensor on the session's device;
  * pre-dump rounds interleaved with delta8 chains never corrupt parent
    links (rounds are parent-free by construction; the final dump deltas
    against the last round's image);
  * reuse degrades to a full encode — never to a wrong image — when the
    cached chunks are gone;
  * across packages: the same mutation sequence gives the same
    dirty/clean/reused split per round and the same manifests apart from
    ``env``, ``created_at`` and ``digest``, and a pre-dumped chain written
    by either package restores in the other, eagerly and lazily.

Every comparison is exact (bitwise). The port classifies float tensors by
their K5 lanes (here the plain version), the JAX package by blake2b over
host bytes; the splits must agree all the same.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro_torch.api import (CheckpointSession, CodecPolicy,  # noqa: E402
                             DumpRequest, RestoreRequest, SessionConfig)
from repro_torch.core import (CorruptionError, MigrationManifest,  # noqa: E402
                              as_tier, flatten_with_paths, read_manifest,
                              tree_digest)
from repro_torch.core.migration import MIGRATION_META_KEY  # noqa: E402
from repro_torch.core.plan import plan_restore  # noqa: E402
from repro_torch.core.predump import (DirtyLeafTracker,  # noqa: E402
                                      leaf_digest, record_is_portable)
from repro_torch.device import to_host  # noqa: E402

SKIP = ("env", "created_at", "digest")


def np_tree0():
    rng = np.random.RandomState(0)
    return {
        "params": {"w": rng.randn(512).astype(np.float32),
                   "b": rng.randn(64).astype(np.float32),
                   "frozen": np.ones(256, np.float32)},
        "opt": {"m": {"w": np.zeros(512, np.float32)},
                "v": {"w": np.full(512, 0.01, np.float32)}},
        "step": np.int32(1),
    }


def np_bump(tree, *paths, step=None):
    """Copy ``tree`` with +1.0 on the named leaves (and step if given)."""
    out = {"params": dict(tree["params"]),
           "opt": {"m": dict(tree["opt"]["m"]), "v": dict(tree["opt"]["v"])},
           "step": tree["step"] if step is None else np.int32(step)}
    for p in paths:
        node, parts = out, p.split("/")
        for k in parts[:-1]:
            node = node[k]
        node[parts[-1]] = node[parts[-1]] + np.float32(1.0)
    return out


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def tree0():
    return to_torch(np_tree0())


def bump(tree, *paths, step=None):
    out = {"params": dict(tree["params"]),
           "opt": {"m": dict(tree["opt"]["m"]), "v": dict(tree["opt"]["v"])},
           "step": tree["step"] if step is None
           else torch.tensor(step, dtype=torch.int32)}
    for p in paths:
        node, parts = out, p.split("/")
        for k in parts[:-1]:
            node = node[k]
        node[parts[-1]] = node[parts[-1]] + 1.0
    return out


def _flat(tree):
    if hasattr(tree, "materialize") and not isinstance(tree, dict):
        tree = tree.materialize()
    return {p: np.asarray(to_host(a)) for p, a in flatten_with_paths(tree)}


def assert_tree_equal(got, want, msg=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), msg
    for p in w:
        assert g[p].dtype == w[p].dtype and g[p].shape == w[p].shape, \
            f"{msg}: {p}"
        assert g[p].tobytes() == w[p].tobytes(), f"{msg}: {p}"


@pytest.fixture(params=["none", "delta8"])
def codec(request):
    return request.param


def session(tmp, codec=None, **kw):
    return CheckpointSession(SessionConfig(
        root=str(tmp), codec=CodecPolicy(optimizer=codec or "none"), **kw),
        device="cpu")


def jsession(tmp, codec=None):
    return japi.CheckpointSession(japi.SessionConfig(
        root=str(tmp), codec=japi.CodecPolicy(optimizer=codec or "none")))


# ------------------------------------------------------------ pre-dump core
def test_residual_restore_bit_identical_to_monolithic(tmp_path, codec):
    t1 = tree0()
    t2 = bump(t1, "params/w", "opt/m/w", step=2)
    pre = session(tmp_path / "pre", codec)
    pre.pre_dump(t1, step=1)
    out = pre.save(t2, step=2)
    assert out["stats"]["leaves_reused"] >= 2   # frozen, b, v/w stayed
    mono = session(tmp_path / "mono", codec)
    mono.save(t1, step=1)
    mono.save(t2, step=2)
    got_p = pre.restore(RestoreRequest(verify_digest=False)).state
    got_m = mono.restore(RestoreRequest(verify_digest=False)).state
    assert_tree_equal(got_p, got_m, "residual vs monolithic")
    assert torch.equal(got_p["params"]["frozen"], t2["params"]["frozen"])


def test_residual_dump_writes_only_dirty(tmp_path):
    sess = session(tmp_path)
    t1 = tree0()
    r0 = sess.pre_dump(t1, step=1)
    assert r0["stats"]["leaves_dirty"] == 6 and r0["stats"]["leaves_clean"] == 0
    t2 = bump(t1, "params/w", step=2)
    out = sess.save(t2, step=2)
    s = out["stats"]
    assert s["leaves_reused"] == 4          # all but params/w and step
    assert s["bytes_stored"] < r0["stats"]["bytes_stored"]
    assert s["bytes_reused"] > 0


def test_residual_dump_never_captures_reused_leaves(tmp_path, monkeypatch):
    """The leaves whose records a residual dump re-emits stay where they
    are: only the dirty leaves go through the host capture."""
    import importlib
    dump_mod = importlib.import_module("repro_torch.core.dump")
    sess = session(tmp_path)
    t1 = tree0()
    sess.pre_dump(t1, step=1)
    t2 = bump(t1, "params/w", step=2)
    seen = []
    real = dump_mod.to_host

    def spy(a):
        seen.append(id(a))
        return real(a)
    monkeypatch.setattr(dump_mod, "to_host", spy)
    out = sess.save(t2, step=2)
    assert out["stats"]["leaves_reused"] == 4
    assert sorted(seen) == sorted([id(t2["params"]["w"]), id(t2["step"])])
    assert_tree_equal(sess.load_latest()[0], t2)


def test_predump_images_are_complete_and_restorable(tmp_path):
    sess = session(tmp_path)
    t1 = tree0()
    r = sess.pre_dump(t1, step=1)
    got = sess.load(r["image_id"])[0]
    assert_tree_equal(got, t1, "pre-dump image restore")
    assert r["image_id"] == "step_0000000001p00"


def test_second_round_skips_unchanged(tmp_path):
    sess = session(tmp_path)
    t1 = tree0()
    sess.pre_dump(t1, step=1)
    t2 = bump(t1, "opt/m/w", step=2)
    r1 = sess.pre_dump(t2, step=2)
    assert r1["stats"]["leaves_clean"] == 4
    assert r1["stats"]["leaves_dirty"] == 2    # opt/m/w + step
    assert r1["image_id"] == "step_0000000002p01"


def test_dump_request_pre_dump_mode(tmp_path):
    sess = session(tmp_path)
    rec = sess.dump(DumpRequest(state=tree0(), step=1, mode="pre_dump"))
    assert rec.mode == "pre_dump" and rec.committed
    assert rec.stats["predump_round"] == 0
    meta = read_manifest(sess.tier, rec.image_id)["meta"]
    assert meta["pre_dump"] == {"round": 0, "dirty": 6, "clean": 0}
    with pytest.raises(ValueError):
        DumpRequest(state=None, step=0, mode="predump")


# -------------------------------------------------- registry interactions
def test_round_after_same_step_final_survives_and_chains(tmp_path):
    """Preempt-at-checkpoint-boundary: a periodic save lands at step N,
    then a pre-copy round starts at that same step. The round must not be
    reaped at birth, must become latest (write order wins same-step
    ties), and the next dump must delta8 against it."""
    sess = session(tmp_path, "delta8")
    t = tree0()
    sess.save(t, step=10)
    r = sess.pre_dump(t, step=10)
    imgs = sess.registry.images()
    assert r["image_id"] in [m["image_id"] for m in imgs], imgs
    assert sess.registry.latest()["image_id"] == r["image_id"]
    t2 = bump(t, "opt/m/w", step=11)
    out = sess.save(t2, step=11)
    rec = [x for x in out["records"] if x["path"] == "opt/m/w"][0]
    assert rec["codec"] == "delta8" and rec["codec_meta"]["applied"], rec
    got = sess.restore(RestoreRequest(verify_digest=False)).state
    mono = session(tmp_path / "mono", "delta8")
    mono.save(t, step=10)
    mono.save(t2, step=11)
    assert_tree_equal(got, mono.restore(
        RestoreRequest(verify_digest=False)).state,
        "boundary-preempt chain vs monolithic")


def test_final_outranks_same_step_predump(tmp_path):
    sess = session(tmp_path)
    t = tree0()
    sess.pre_dump(t, step=5)
    sess.save(t, step=5)        # canonical: boundary dump at round's step
    latest = sess.registry.latest()
    assert latest["image_id"] == "step_0000000005"
    assert not latest["pre_dump"]


def test_superseded_rounds_reaped_active_chain_kept(tmp_path):
    sess = session(tmp_path)
    t1 = tree0()
    sess.save(t1, step=1)
    t2 = bump(t1, "params/w", step=2)
    sess.pre_dump(t2, step=2)          # active chain: newer than final@1
    ids = [m["image_id"] for m in sess.registry.images()]
    assert any(m["pre_dump"] for m in sess.registry.images()), ids
    t3 = bump(t2, "params/b", step=3)
    sess.save(t3, step=3)              # supersedes the round
    imgs = sess.registry.images()
    assert not any(m["pre_dump"] for m in imgs), imgs
    assert_tree_equal(sess.load_latest()[0], t3)


def test_predump_interleaved_with_delta8_chain(tmp_path):
    """save -> round -> round -> final under delta8: parent links must stay
    acyclic and every image decodable; the final tree restores exactly."""
    sess = session(tmp_path, "delta8")
    t1 = tree0()
    sess.save(t1, step=1)
    t2 = bump(t1, "opt/m/w", step=2)
    sess.pre_dump(t2, step=2)
    t3 = bump(t2, "opt/v/w", step=3)
    sess.pre_dump(t3, step=3)
    t4 = bump(t3, "opt/m/w", "params/w", step=4)
    out = sess.save(t4, step=4)
    assert out["stats"]["leaves_reused"] > 0
    plan = plan_restore(sess.tier, out["image_id"])
    assert plan.chain_depth <= 3
    got = sess.restore(RestoreRequest(verify_digest=False)).state
    mono = session(tmp_path / "mono", "delta8")
    for i, t in enumerate((t1, t2, t3, t4), start=1):
        mono.save(t, step=i)
    assert_tree_equal(got, mono.restore(
        RestoreRequest(verify_digest=False)).state, "delta8 interleave")
    assert torch.equal(got["params"]["w"], t4["params"]["w"])


def test_reuse_falls_back_when_chunks_vanish(tmp_path):
    sess = session(tmp_path)
    t1 = tree0()
    r = sess.pre_dump(t1, step=1)
    # simulate a foreign gc: remove every pooled chunk (and keep the
    # tier's index truthful via delete_chunk)
    for name in sess.tier.listdir("chunks"):
        sess.tier.delete_chunk(name.removesuffix(".bin"))
    sess.tier.delete(f"images/{r['image_id']}")
    t2 = bump(t1, "params/w", step=2)
    out = sess.save(t2, step=2)         # tracker is warm but pool is empty
    assert out["stats"]["leaves_reused"] == 0   # fell back, didn't lie
    assert_tree_equal(sess.load_latest()[0], t2)


# ------------------------------------------------------------- lazy restore
def test_lazy_fully_faulted_equals_eager(tmp_path, codec):
    sess = session(tmp_path, codec)
    t1 = tree0()
    sess.save(t1, step=1)
    t2 = bump(t1, "opt/m/w", step=2)
    sess.save(t2, step=2)
    eager = sess.restore(RestoreRequest(verify_digest=False)).state
    res = sess.restore(RestoreRequest(lazy=True))
    assert res.lazy and res.digest_verified is None
    full = res.state.materialize()
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for _, a in flatten_with_paths(full))
    assert_tree_equal(full, eager, "lazy vs eager")


def test_lazy_skeleton_and_single_fault(tmp_path):
    sess = session(tmp_path)
    t = tree0()
    sess.save(t, step=1)
    res = sess.restore(RestoreRequest(lazy=True, prefetch_order=()))
    srv = res.state.server
    assert srv.remaining == 6                  # nothing read yet
    assert res.state.peek("params").peek("w") == ("float32", (512,))
    assert set(res.state) == {"params", "opt", "step"}
    w = res.state["params"]["w"]
    assert isinstance(w, torch.Tensor) and torch.equal(w, t["params"]["w"])
    assert srv.stats["faults"] == 1 and srv.remaining == 5
    assert res.state["params"]["w"] is w       # memoized, not re-placed


def test_lazy_prefetch_order_params_first(tmp_path):
    sess = session(tmp_path)
    sess.save(tree0(), step=1)
    plan = plan_restore(sess.tier, "step_0000000001")
    order = list(plan.prefetch_order)
    assert order[0].startswith("params/")
    assert order[-1].startswith("opt/")


def test_lazy_range_reads(tmp_path):
    sess = CheckpointSession(SessionConfig(
        root=str(tmp_path), codec=CodecPolicy(optimizer="bf16")),
        device="cpu")
    t = tree0()
    sess.save(t, step=1)
    res = sess.restore(RestoreRequest(lazy=True, prefetch_order=()))
    srv = res.state.server
    raw = srv.read_range("params/w", 8, 40)
    assert raw == t["params"]["w"].numpy().tobytes()[8:48]
    # codec-applied leaf: decodes fully, slices the decoded buffer
    dec = srv.get("opt/v/w").numpy()
    assert srv.read_range("opt/v/w", 0, 12) == dec.tobytes()[:12]


def test_lazy_rejects_struct_and_shardings(tmp_path):
    sess = session(tmp_path)
    sess.save(tree0(), step=1)
    with pytest.raises(ValueError, match="materialize"):
        sess.restore(RestoreRequest(lazy=True, target_struct={"x": None}))


def _save_with_migration_record(sess, t, step):
    """A lossless dump whose meta carries the migration record with the
    tree digest of the state, as ServeEngine.checkpoint writes it (the
    port has no MigrationOrchestrator yet)."""
    rec = MigrationManifest(step=step, arch="t", reason="test",
                            state_digest=tree_digest(flatten_with_paths(t)))
    return sess.save(t, step=step,
                     meta={MIGRATION_META_KEY: rec.to_meta()})


def test_lazy_materialize_runs_deferred_digest_check(tmp_path):
    """The post-copy trade's deferred half: full materialization verifies
    the whole-tree digest from the migration record automatically, and a
    mismatch raises exactly like the eager path would."""
    sess = session(tmp_path)
    t = tree0()
    _save_with_migration_record(sess, t, 1)
    res = sess.restore(RestoreRequest(lazy=True))
    assert res.digest_verified is None          # deferred, not skipped
    srv = res.state.server
    assert srv.expected_digest == res.migration.state_digest
    assert srv.expected_digest                  # lossless policy: recorded
    host = res.state.materialize()              # runs the check itself
    assert_tree_equal(host, t, "lazy materialize vs migrated state")
    assert srv.verify_tree_digest() is True
    # a job that updates its restored state in place leaves the digest's
    # bytes alone
    host["params"]["w"].add_(1.0)
    assert srv.verify_tree_digest() is True
    res2 = sess.restore(RestoreRequest(lazy=True))
    res2.state.server.expected_digest = "0" * 64
    with pytest.raises(CorruptionError):
        res2.state.materialize()
    res3 = sess.restore(RestoreRequest(lazy=True, verify_digest=False))
    assert res3.state.server.expected_digest is None
    res3.state.materialize()


def test_leaf_server_drain_blocks_until_prefetch_lands(tmp_path):
    sess = session(tmp_path)
    t = tree0()
    sess.save(t, step=1)
    res = sess.restore(RestoreRequest(lazy=True, prefetch_order=()))
    srv = res.state.server
    n = srv.prefetch(("params",))
    assert n == 3
    srv.drain()
    assert srv.stats["prefetched"] == 3
    assert srv.remaining == 3                   # opt/* and step untouched


def test_lazy_prefetch_then_fault_is_one_placement(tmp_path):
    """A leaf the prefetcher placed is the one a later fault returns; the
    serial engine prefetches inline."""
    from repro_torch.core.executor import CheckpointExecutor
    for serial in (False, True):
        sess = session(tmp_path / str(serial), executor=CheckpointExecutor(
            serial=serial))
        t = tree0()
        sess.save(t, step=1)
        res = sess.restore(RestoreRequest(lazy=True,
                                          prefetch_order=("params",)))
        srv = res.state.server
        srv.drain()
        w = res.state["params"]["w"]
        assert torch.equal(w, t["params"]["w"])
        assert srv.stats["prefetched"] == 3 and srv.stats["faults"] == 0
        assert res.state.materialize()["params"]["w"] is w


# ------------------------------------------------------------ unit pieces
def test_leaf_digest_covers_dtype_shape_content():
    a = np.arange(8, dtype=np.float32)
    assert leaf_digest(a) == leaf_digest(a.copy())
    assert leaf_digest(a) != leaf_digest(a.astype(np.float64))
    assert leaf_digest(a) != leaf_digest(a.reshape(2, 4))
    b = a.copy()
    b[3] += 1
    assert leaf_digest(a) != leaf_digest(b)
    assert leaf_digest(np.zeros(0, np.int8)) != leaf_digest(
        np.zeros(0, np.uint8))
    bits = np.arange(4, dtype=np.uint16)
    assert leaf_digest(bits) != leaf_digest(
        to_host(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)))


def test_tracker_refuses_delta_applied_records():
    tr = DirtyLeafTracker()
    recs = [
        {"path": "a", "codec": "none", "codec_meta": {}},
        {"path": "b", "codec": "delta8", "codec_meta": {"applied": True}},
        {"path": "c", "codec": "delta8", "codec_meta": {"applied": False}},
        {"path": "d", "codec": "bf16", "codec_meta": {"applied": True}},
    ]
    assert [record_is_portable(r) for r in recs] == [True, False, True, True]
    tr.update({r["path"]: "dig" for r in recs}, recs, "img", pre_dump=True)
    reuse = tr.reuse_for({r["path"]: "dig" for r in recs})
    assert set(reuse) == {"a", "c", "d"}
    assert set(tr.reuse_for({"a": "other"})) == set()


# ----------------------------------------------------------- cross-package
def _sequence():
    """Seeded mutation sequence: (kind, step, dirtied paths)."""
    rng = np.random.default_rng(7)
    paths = ["params/w", "params/b", "params/frozen", "opt/m/w", "opt/v/w"]
    seq = []
    for step, kind in ((1, "pre_dump"), (2, "pre_dump"), (3, "pre_dump"),
                       (4, "save")):
        k = int(rng.integers(1, 3))
        seq.append((kind, step, sorted(rng.choice(paths, k, replace=False))))
    return seq


def _strip(man):
    return {k: v for k, v in man.items() if k not in SKIP}


def test_same_mutation_sequence_same_splits_and_manifests(tmp_path, codec):
    js, ts = jsession(tmp_path / "jax", codec), session(tmp_path / "pt", codec)
    jt, tt = np_tree0(), tree0()
    ids = []
    for kind, step, dirty in _sequence():
        jt = np_bump(jt, *dirty, step=step)
        tt = bump(tt, *dirty, step=step)
        jout = getattr(js, kind)(jt, step=step)
        tout = getattr(ts, kind)(tt, step=step)
        assert jout["image_id"] == tout["image_id"]
        for key in ("leaves_dirty", "leaves_clean", "leaves_reused",
                    "bytes_stored", "chunks_deduped"):
            assert jout["stats"].get(key) == tout["stats"].get(key), \
                (step, key)
        ids.append(tout["image_id"])
    assert ids[-1] == "step_0000000004"
    assert sorted(js.tier.image_ids()) == sorted(ts.tier.image_ids())
    for iid in ts.tier.image_ids():
        assert _strip(read_manifest(js.tier, iid)) == \
            _strip(read_manifest(ts.tier, iid)), iid
    assert sorted(js.tier.listdir("chunks")) == \
        sorted(ts.tier.listdir("chunks"))


@pytest.mark.parametrize("lazy", [False, True])
def test_jax_predumped_chain_restores_in_port(tmp_path, lazy):
    js = jsession(tmp_path)
    t1 = np_tree0()
    js.pre_dump(t1, step=1)
    t2 = np_bump(t1, "params/w", step=2)
    js.pre_dump(t2, step=2)
    rnd = session(tmp_path).restore(RestoreRequest(lazy=lazy,
                                                   verify_digest=False))
    assert rnd.image_id == "step_0000000002p01"
    assert_tree_equal(rnd.state, to_torch(t2), "JAX round in the port")
    t3 = np_bump(t2, "opt/m/w", step=3)
    js.save(t3, step=3)
    res = session(tmp_path).restore(RestoreRequest(lazy=lazy,
                                                   verify_digest=False))
    assert res.image_id == "step_0000000003"
    assert_tree_equal(res.state, to_torch(t3), "JAX chain in the port")


@pytest.mark.parametrize("lazy", [False, True])
def test_port_predumped_chain_restores_in_jax(tmp_path, lazy):
    ts = session(tmp_path)
    t1 = tree0()
    ts.pre_dump(t1, step=1)
    t2 = bump(t1, "params/w", step=2)
    ts.pre_dump(t2, step=2)
    t3 = bump(t2, "opt/m/w", step=3)
    _save_with_migration_record(ts, t3, 3)
    res = jsession(tmp_path).restore(japi.RestoreRequest(lazy=lazy))
    assert res.image_id == "step_0000000003"
    state = res.state.materialize() if lazy else res.state
    assert_tree_equal(to_torch({p: np.asarray(a) for p, a in
                                flatten_with_paths(state)}),
                      to_torch({p: np.asarray(to_host(a)) for p, a in
                                flatten_with_paths(t3)}),
                      "port chain in JAX")
    if lazy:
        assert res.state.server.verify_tree_digest() is True
    else:
        assert res.digest_verified is True
    assert as_tier(str(tmp_path)).image_ids()
