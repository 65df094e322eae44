"""repro_torch.api and the restore side of migration: the sync parts of
tests/test_api_session.py and tests/test_migration.py's resume digest
checks, on the port, with the tier URIs and the async receipts and policy;
restore onto a mesh over several devices raises; and the wire contract,
which must be the JAX package's frame for frame (the same dicts encode
and decode in both packages). Exact comparisons throughout: restores are
bit-identical, digests and wire dicts equal."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.core.integrity import tree_digest as jtree_digest  # noqa: E402
from repro_torch.api import (AsyncPolicy, CheckpointSession,  # noqa: E402
                             CodecPolicy, DumpReceipt, DumpRequest,
                             MigrateRequest,
                             MigrationTicket,
                             RestoreRequest, RetentionPolicy, SessionConfig,
                             WireCodingError, WireVersionError)
from repro_torch.api import wire  # noqa: E402
from repro_torch.core import (CorruptionError, MigrationManifest,  # noqa: E402
                              as_tier, read_manifest, resume, train_meta,
                              tree_digest)
from repro_torch.core.storage import MemoryTier  # noqa: E402


def small_tree(seed=0, delta=0.0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((32, 16)).astype(np.float32)) + delta,
                       "b": torch.zeros(16)},
            "opt": {"m": {"w": torch.zeros((32, 16))}},
            "step": torch.tensor(1, dtype=torch.int32)}


def leaves(tree):
    from repro_torch.core import flatten_with_paths
    return flatten_with_paths(tree)


def trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def cpu_session(root, **kw):
    return CheckpointSession(root, device="cpu", **kw)


# ----------------------------------------------------------- URI tier layer
def test_as_tier_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="unknown tier URI scheme 's3'"):
        as_tier("s3://bucket/ckpts")
    with pytest.raises(ValueError, match="gs"):
        cpu_session("gs://bucket/x")


def test_file_uri_and_plain_path_agree(tmp_path):
    t1 = as_tier(f"file://{tmp_path}/ck")
    t2 = as_tier(str(tmp_path / "ck"))
    assert t1.root == t2.root


def test_mem_uri_names_one_tier_per_process():
    a = as_tier("mem://test-roundtrip-name")
    b = as_tier("mem://test-roundtrip-name")
    c = as_tier("mem://other")
    assert a is b and a is not c
    assert isinstance(a, MemoryTier)


def test_mem_tier_dump_restore_round_trip():
    """A dump through one session restores bit-identically through
    another session addressing the same mem:// URI."""
    tree = small_tree(3)
    receipt = cpu_session("mem://torch-rt-test").dump(
        DumpRequest(state=tree, step=7))
    assert receipt.committed and receipt.image_id
    got, man = cpu_session("mem://torch-rt-test").load_latest()
    assert man["image_id"] == receipt.image_id
    assert trees_equal(tree, got)
    assert isinstance(as_tier("mem://torch-rt-test"), MemoryTier)
    as_tier("mem://torch-rt-test").delete("images")   # isolate repeated runs
    as_tier("mem://torch-rt-test").delete("chunks")


# ------------------------------------------------------- typed request flow
def test_dump_request_validates_mode():
    with pytest.raises(ValueError, match="mode"):
        DumpRequest(state={}, step=1, mode="later")


def test_typed_methods_reject_untyped_arguments(tmp_path):
    sess = cpu_session(str(tmp_path / "ck"))
    with pytest.raises(TypeError, match="DumpRequest"):
        sess.dump({"state": small_tree(), "step": 1})
    with pytest.raises(TypeError, match="RestoreRequest"):
        sess.restore("latest")


def test_async_dump_receipts_arrive_on_wait(tmp_path):
    sess = cpu_session(str(tmp_path / "ck"))
    pending = sess.dump(DumpRequest(state=small_tree(1), step=1,
                                    mode="async"))
    assert not pending.committed and pending.image_id is None
    sess.dump(DumpRequest(state=small_tree(2), step=2, mode="async"))
    done = sess.wait()
    assert [d.step for d in done] == [1, 2]
    assert all(d.committed and d.image_id and d.stats for d in done)
    assert sess.wait() == []                       # barrier drained


def test_async_disabled_by_policy(tmp_path):
    sess = CheckpointSession(SessionConfig(
        root=str(tmp_path / "ck"), async_dumps=AsyncPolicy(enabled=False)),
        device="cpu")
    with pytest.raises(RuntimeError, match="AsyncPolicy"):
        sess.dump(DumpRequest(state=small_tree(), step=1, mode="async"))


def test_sync_dump_receipt_and_restore_result(tmp_path):
    tree = small_tree(1)
    sess = CheckpointSession(SessionConfig(root=str(tmp_path / "ck")),
                             device="cpu")
    r = sess.dump(DumpRequest(state=tree, step=4))
    assert isinstance(r, DumpReceipt)
    assert r.committed and r.mode == "sync" and r.step == 4
    assert r.stats["chunks"] > 0 and r.duration_s > 0

    res = cpu_session(str(tmp_path / "ck")).restore(RestoreRequest())
    assert res.image_id == r.image_id and res.step == 4
    assert res.digest_verified is None          # nothing recorded to verify
    assert trees_equal(tree, res.state)
    spec = {"params": {"w": torch.empty((32, 16), device="meta")}}
    res = cpu_session(str(tmp_path / "ck")).restore(
        RestoreRequest(target_struct=spec))
    assert set(res.state) == {"params"} and set(res.state["params"]) == {"w"}


@pytest.mark.parametrize("what", ["lazy", "mesh", "load", "load_latest"])
def test_unported_parts_raise(tmp_path, what):
    """What raises: placement onto a mesh over several devices without a
    process group that spans it, by the typed request (``mesh=``) or by
    ``load``/``load_latest(shardings=...)``; a lazy restore takes no
    shardings (they apply after materialize(), as in the JAX package).
    One-device meshes restore (tests/test_torch_distributed.py), meshes
    over a group's ranks too (tests/test_torch_spmd.py). (Async dumps,
    the orchestrator's rounds, migrate and signal handlers are ported and
    tested in tests/test_torch_migration.py.)"""
    from repro_torch.distributed.sharding import (Mesh, PartitionSpec,
                                                  named)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import tree_map
    root = str(tmp_path / "ck")
    sess = cpu_session(root)
    tree = small_tree()
    sess.dump(DumpRequest(state=tree, step=1))
    devs = np.empty(2, dtype=object)
    devs[0], devs[1] = torch.device("cuda", 0), torch.device("cuda", 1)
    two = Mesh(devs.reshape(1, 2), ("data", "model"))

    def specs(mesh):
        return named(mesh, tree_map(lambda _, v: PartitionSpec(), tree))
    calls = {
        "lazy": lambda: sess.restore(RestoreRequest(
            lazy=True, shardings=specs(make_test_mesh((1, 1),
                                                      device="cpu")))),
        "mesh": lambda: sess.restore(RestoreRequest(mesh=two)),
        "load": lambda: sess.load(sess.registry.images()[-1]["image_id"],
                                  shardings=specs(two)),
        "load_latest": lambda: sess.load_latest(shardings=specs(two)),
    }
    if what == "lazy":
        with pytest.raises(ValueError, match="materialize"):
            calls[what]()
    else:
        with pytest.raises(RuntimeError, match="needs a process group of 2 "
                                               "ranks.*none is initialised"):
            calls[what]()


def test_session_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointSession("mem://torch-no-card")


def test_shorthand_constructor_and_overrides(tmp_path):
    sess = cpu_session(str(tmp_path / "ck"),
                       retention=RetentionPolicy(keep_last=7))
    assert sess.keep_last == 7
    base = SessionConfig(root=str(tmp_path / "ck2"))
    sess2 = CheckpointSession(base, device="cpu", serial=True)
    assert sess2.executor.serial and base.serial is False


def test_retention_and_gc_after_each_dump(tmp_path):
    sess = cpu_session(str(tmp_path / "ck"),
                       retention=RetentionPolicy(keep_last=2))
    for s in range(1, 5):
        sess.dump(DumpRequest(state=small_tree(s), step=s))
    assert [m["step"] for m in sess.registry.images()] == [3, 4]
    live = {h for m in sess.registry.images()
            for r in read_manifest(sess.tier, m["image_id"])["leaves"]
            for h in r["chunks"]}
    assert {n.removesuffix(".bin") for n in sess.tier.listdir("chunks")} \
        == live


def test_plan_is_a_dry_run_on_meta_tensors():
    sess = cpu_session("mem://torch-plan",
                       codec=CodecPolicy(optimizer="bf16"))
    abstract = {"w": torch.empty((64, 64), device="meta"),
                "opt": {"m": torch.empty((64, 64), device="meta")}}
    plan = sess.plan(abstract, step=3)
    got = {lp.path: (lp.codec, lp.nbytes) for lp in plan.leaves}
    assert got == {"w": ("none", 64 * 64 * 4), "opt/m": ("bf16", 64 * 64 * 4)}
    assert not as_tier("mem://torch-plan").exists("images")


# ------------------------------------------------------------ codec policy
def test_codec_policy_compiles_and_rejects_unknown():
    assert CodecPolicy().to_leaf_policy() is None
    pol = CodecPolicy(optimizer="delta8").to_leaf_policy()
    assert pol("opt/m/w") == "delta8" and pol("params/w") == "none"
    with pytest.raises(ValueError, match="unknown codec"):
        CodecPolicy(optimizer="zstd")


def test_codec_policy_delta8_round_trip(tmp_path):
    sess = CheckpointSession(SessionConfig(
        root=str(tmp_path / "ck"), codec=CodecPolicy(optimizer="delta8"),
        retention=RetentionPolicy(keep_last=10)), device="cpu")
    t1 = small_tree(1)
    sess.dump(DumpRequest(state=t1, step=1))
    t2 = {"params": {k: v + 0.01 for k, v in t1["params"].items()},
          "opt": {"m": {"w": t1["opt"]["m"]["w"] + 0.01}},
          "step": torch.tensor(2, dtype=torch.int32)}
    r2 = sess.dump(DumpRequest(state=t2, step=2))
    got, _ = sess.load_latest()
    # delta8 on optimizer moments is lossy-bounded; params stay bitwise
    assert trees_equal(t2["params"], got["params"])
    assert float((got["opt"]["m"]["w"] - t2["opt"]["m"]["w"]).abs().max()) \
        < 1e-2
    recs = read_manifest(sess.tier, r2.image_id)["leaves"]
    applied = {r["path"] for r in recs if r["codec"] == "delta8"
               and r["codec_meta"].get("applied")}
    assert applied == {"opt/m/w"}
    assert read_manifest(sess.tier, r2.image_id)["parent"] is not None


# --------------------------------------------------------- resume + digest
def _save_with_record(root, tree, digest, **meta_kw):
    rec = MigrationManifest(step=1, arch="tiny", host_count=1, dp_degree=1,
                            state_digest=digest)
    meta = train_meta(arch="tiny", step=1, data_state={}, **meta_kw)
    meta["migration"] = rec.to_meta()
    cpu_session(root).save(tree, step=1, meta=meta)


def test_resume_verifies_the_recorded_digest(tmp_path):
    tree = small_tree(2)
    root = str(tmp_path / "ck")
    _save_with_record(root, tree, tree_digest(leaves(tree)))
    rep = resume(root, device="cpu")
    assert rep.digest_verified is True and trees_equal(rep.state, tree)
    assert rep.migration.arch == "tiny" and not rep.topology_changed


def test_resume_digest_mismatch_raises(tmp_path):
    """The integrity layer must refuse a restore whose logical bytes do not
    match what the dump recorded (here: a deliberately wrong digest)."""
    root = str(tmp_path / "ck")
    _save_with_record(root, small_tree(2), "0" * 64)
    with pytest.raises(CorruptionError, match="state digest"):
        resume(root, device="cpu")
    with pytest.raises(CorruptionError, match="state digest"):
        cpu_session(root).restore(RestoreRequest())
    # verification is opt-out-able for forensics
    rep = resume(root, device="cpu", verify_digest=False)
    assert rep.digest_verified is None


def test_resume_digest_catches_a_changed_leaf(tmp_path):
    """A record whose digest was taken of other values (one leaf one ulp
    off) fails, so the check reads the decoded bytes, not the record."""
    tree = small_tree(2)
    other = small_tree(2)
    other["params"]["w"][0, 0] = torch.nextafter(other["params"]["w"][0, 0],
                                                 torch.tensor(np.inf))
    root = str(tmp_path / "ck")
    _save_with_record(root, tree, tree_digest(leaves(other)))
    with pytest.raises(CorruptionError):
        resume(root, device="cpu")


def test_resume_adopts_pre_migration_images(tmp_path):
    root = str(tmp_path / "ck")
    cpu_session(root).save(small_tree(4), step=1,
                           meta=train_meta(arch="tiny", step=1,
                                           data_state={"step": 1,
                                                       "global_batch": 4}),
                           topology={"host_count": 2, "dp_degree": 2})
    rep = resume(root, device="cpu", host_count=1, dp_degree=1)
    assert rep.digest_verified is None      # nothing recorded to verify
    assert rep.migration.host_count == 2    # synthesized from topology
    assert rep.changes["host_count"] == [2, 1]
    assert trees_equal(rep.state, small_tree(4))


def test_resume_image_without_data_pipeline(tmp_path):
    root = str(tmp_path / "ck")
    cpu_session(root).save(small_tree(5), step=0,
                           meta={"job_kind": "serve", "arch": "tiny"})
    rep = resume(root, device="cpu")
    assert rep.data["global_batch"] is None
    assert trees_equal(rep.state, small_tree(5))


def test_migration_manifest_roundtrip():
    rec = MigrationManifest(step=7, arch="qwen3-8b", host_count=4,
                            dp_degree=4, mesh_axes=[["data", 4]],
                            global_batch=8,
                            data={"step": 7, "global_batch": 8},
                            rng=[0, 1], state_digest="ab" * 32,
                            reason="SIGTERM", planned_host_count=3,
                            hosts_dropped=[2])
    meta = rec.to_meta()
    assert meta["version"] == 1
    assert json.loads(json.dumps(meta)) == meta     # JSON-able
    assert MigrationManifest.from_meta(meta) == rec
    meta["future_field"] = True
    assert MigrationManifest.from_meta(meta) == rec
    from repro.core.migration import MigrationManifest as JRecord
    assert JRecord.from_meta(meta).to_meta() == rec.to_meta()


def test_tree_digest_matches_jax_and_is_sensitive():
    """The same logical tree digests the same in both packages — bf16
    leaves included (the port's uint16 host arrays carry "bfloat16") — and
    the digest changes with a value or a dtype."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    kv = rng.standard_normal((4, 8)).astype(np.float32)
    port = {"w": torch.from_numpy(w), "step": torch.tensor(3, dtype=torch.int32),
            "kv": torch.from_numpy(kv).to(torch.bfloat16)}
    jx = {"w": w, "step": np.int32(3),
          "kv": np.asarray(jnp.asarray(kv).astype(jnp.bfloat16))}
    d1 = tree_digest(leaves(port))
    assert d1 == jtree_digest(jx)
    assert tree_digest(reversed(leaves(port))) == d1
    bumped = port["w"].clone()
    bumped[0, 0] += 1e-6
    assert tree_digest(leaves(dict(port, w=bumped))) != d1
    assert tree_digest(leaves(dict(port, w=port["w"].double()))) != d1


# ------------------------------------------------------------ wire contract
def _port_messages():
    return [
        DumpRequest(state=None, step=7, meta={"job_kind": "serve"},
                    mode="sync"),
        DumpReceipt(step=7, mode="sync", committed=True, image_id="step_7",
                    stats={"chunks": 3}, duration_s=0.5),
        RestoreRequest(image_id="step_7", host_count=2, dp_degree=2,
                       prefetch_order=("params",)),
        MigrateRequest(state=None, step=9, reason="SIGTERM",
                       data_state={"step": 9}),
        MigrationTicket(exit_code=85, image_id="step_9", step=9,
                        reason="SIGTERM", latency_s=1.5,
                        record=MigrationManifest(step=9, state_digest="ab")),
        SessionConfig(root="mem://x", replicas=("file:///tmp/r",),
                      retention=RetentionPolicy(keep_last=5),
                      codec=CodecPolicy(optimizer="delta8")),
    ]


@pytest.mark.parametrize("i", range(6))
def test_wire_round_trip_and_cross_package(i):
    msg = _port_messages()[i]
    d = json.loads(json.dumps(msg.to_wire()))
    assert d["kind"] == type(msg).__name__
    assert d["schema_version"] == wire.SCHEMA_VERSION == "1.0"
    assert type(msg).from_wire(d) == msg
    assert wire.decode(d) == msg
    # the JAX package decodes the port's frame and encodes the same frame
    jmsg = getattr(japi, type(msg).__name__).from_wire(d)
    assert json.loads(json.dumps(jmsg.to_wire())) == d
    assert type(msg).wire_fields() == \
        getattr(japi, type(msg).__name__).wire_fields()


def test_wire_refuses_future_major_and_runtime_fields():
    d = DumpRequest(state=None, step=1).to_wire()
    d["schema_version"] = "2.0"
    with pytest.raises(WireVersionError):
        DumpRequest.from_wire(d)
    d["schema_version"] = "1.7"
    d["field_from_the_future"] = 1
    assert DumpRequest.from_wire(d) == DumpRequest(state=None, step=1)
    with pytest.raises(WireCodingError):
        DumpRequest(state=small_tree(), step=1).to_wire()
