"""repro_torch's checkpoint modes on a sharded state, over real process
groups: pre-dump rounds, the residual dump, async dumps, the lossless
migration and its tree digest of DTensor leaves, each run by 8 CPU ranks
over gloo with tests/test_torch_spmd.py's harness (``run_ranks``: a
``FileStore``, a deadline of its own per multi-process case, a hung rank
fails only its case). A rank imports torch and repro_torch only.

The state is granite-moe tiny's train state as the JAX package
initialises it (``PRNGKey(1)``), placed on a (4, 2) mesh by
``train_state_pspecs``, plus one uneven leaf, ``extra/uneven`` (7 x 5 x 3
split [Shard(0), Shard(1)]; the JAX side holds it replicated, as JAX
refuses an uneven split). Every image of the sharded state is compared,
chunk for chunk and manifest leaf for manifest leaf (bitwise), with the
unsharded port's image of the same values (this process, on the CPU) and
the JAX package's image of its (4, 2) sharded state (8 forced host
devices, one subprocess); the stats too.

  (i) F12: a lossless ``migrate``: the record's ``state_digest`` equals
      the unsharded port's and JAX's; the image restores onto (2, 4)
      bitwise with ``digest_verified``.
  (ii) F13: a pre-dump round (step 1), the leaves ``DIRTY_A`` changed in
      place, a second round (step 2), ``DIRTY_B`` changed, the residual
      ``save()`` (step 3), lossless and with delta8 moments: every image
      and the dirty / clean / reused counts equal; the residual gathers
      only ``DIRTY_B``'s leaves; rank 0 holds at most one full-size split
      leaf at a time and no other rank one (``_FullLeaves``).
  (iii) The orchestrator on the mesh: SIGTERM's request, two
      ``pre_dump_round``s with leaves changed between, ``migrate``: exit
      code 85 and an image that restores onto (2, 4) bitwise.
  (iv) ``dump(mode="async")``, then every float leaf changed in place,
      then ``wait()``: the image of the values at capture; a delta8 chain
      of two async dumps; every rank's ``wait()`` returns the same
      receipts; a write job made to fail on rank 0 raises on every rank's
      ``wait()``.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (WORLD, _env, _FullLeaves,  # noqa: E402
                             _leaves, _rank_main, _sum_over_ranks, _unflat,
                             run_ranks)

DIRTY_A = ["extra/uneven", "opt/m/stack/b0/moe/w_up", "params/embed/tok"]
DIRTY_B = ["opt/v/stack/b0/attn/wq", "params/final_norm"]
N_LEAVES = 38               # the train state's 37 and extra/uneven
ONE_RANK, ONE_LEAF = 5, "params/embed/tok"   # a change on one shard alone
STEP_BY = 2.0 ** -10         # a moment update: exact in fp32 either side
STATS = ("leaves_dirty", "leaves_clean", "leaves_reused", "bytes_stored",
         "chunks_deduped", "predump_round")

# ----------------------------------------------------------- the JAX side
_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro import configs
    from repro.api import (CheckpointSession, CodecPolicy, DumpRequest,
                           MigrateRequest, SessionConfig)
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_test_mesh
    from repro.models.model import LM
    from repro.training.train_loop import init_train_state, train_state_pspecs
    d, A, B, by = sys.argv[1], json.loads(sys.argv[2]), \\
        json.loads(sys.argv[3]), float(sys.argv[4])
    cfg = configs.get_tiny("granite-moe-3b-a800m")
    lm = LM(cfg)
    mesh = make_test_mesh((4, 2), ("data", "model"))
    state = init_train_state(lm, jax.random.PRNGKey(1))
    state["extra"] = {"uneven": jnp.arange(105, dtype=jnp.float32)
                      .reshape(7, 5, 3) * 0.25}
    specs = train_state_pspecs(lm, shd.make_rules(cfg, mesh))
    specs["extra"] = {"uneven": P()}

    def paths(t, path=""):
        if isinstance(t, dict):
            o = {}
            for k in t:
                o.update(paths(t[k], f"{path}/{k}" if path else k))
            return o
        return {path: t}
    np.savez(d + "/state.npz",
             **{p: np.asarray(a) for p, a in paths(state).items()})
    state = jax.tree.map(lambda a, ps: jax.device_put(
        a, NamedSharding(mesh, ps)), state, specs,
        is_leaf=lambda x: isinstance(x, P))

    def bump(t, which, by, path=""):
        if isinstance(t, dict):
            return {k: bump(v, which, by, f"{path}/{k}" if path else k)
                    for k, v in t.items()}
        return jax.device_put(t + by, t.sharding) if path in which else t
    floats = [p for p, a in paths(state).items()
              if a.dtype == jnp.float32]
    out = {}
    s = CheckpointSession(SessionConfig(root=d + "/jax_mig"))
    out["mig_digest"] = s.migrate(MigrateRequest(
        state=state, step=5, reason="test")).record.state_digest
    for name, codec in (("pre", CodecPolicy()),
                        ("pre8", CodecPolicy(optimizer="delta8"))):
        s = CheckpointSession(SessionConfig(root=f"{d}/jax_{name}",
                                            codec=codec))
        st = state
        out[name] = [s.pre_dump(st, step=1)["stats"]]
        st = bump(st, A, 1.0)
        out[name].append(s.pre_dump(st, step=2)["stats"])
        st = bump(st, B, 1.0)
        out[name].append(s.save(st, step=3)["stats"])
    s = CheckpointSession(SessionConfig(root=d + "/jax_async"))
    s.dump(DumpRequest(state=state, step=7, mode="async"))
    out["async"] = [r.stats for r in s.wait()]
    s = CheckpointSession(SessionConfig(
        root=d + "/jax_async8", codec=CodecPolicy(optimizer="delta8")))
    s.dump(DumpRequest(state=state, step=1, mode="async"))
    st = bump(state, [p for p in floats if p.startswith("opt/")], by)
    s.dump(DumpRequest(state=st, step=2, mode="async"))
    out["async8"] = [r.stats for r in s.wait()]
    print(json.dumps(out, default=int))
""")


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory(prefix="spmd_modes_") as d:
        env = _env()
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run([sys.executable, "-c", _JAX_SIDE, d,
                            json.dumps(DIRTY_A), json.dumps(DIRTY_B),
                            repr(STEP_BY)], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-4000:]
        yield d, json.loads(r.stdout.strip().splitlines()[-1])


# ------------------------------------------------- the sequences, any side
def _state(d):
    """The JAX side's values as a tree of CPU tensors (a fresh copy)."""
    return _unflat({p: torch.from_numpy(np.array(a)) for p, a in
                    np.load(os.path.join(d, "state.npz")).items()})


def _bump(tree, paths, by=1.0):
    """``by`` added in place to the named leaves (a DTensor's local
    shard), as a train step updates its state."""
    from repro_torch.distributed import sharding as shd
    for p, t in _leaves(tree).items():
        if p in paths:
            (t.to_local() if shd.is_dtensor(t) else t).add_(by)


def _floats(tree):
    return [p for p, t in _leaves(tree).items()
            if t.dtype == torch.float32]


def _session(root, codec=None, **kw):
    from repro_torch.api import CheckpointSession, CodecPolicy, SessionConfig
    return CheckpointSession(SessionConfig(
        root=root, codec=codec or CodecPolicy(), **kw), device="cpu")


def _migrate(tree, root):
    """(i) -> (state_digest, exit code)."""
    from repro_torch.api import MigrateRequest
    t = _session(root).migrate(MigrateRequest(state=tree, step=5,
                                              reason="test"))
    return t.record.state_digest, t.exit_code


def _predump(tree, root, codec=None, residual=None):
    """(ii) -> (the stats of round 1, round 2 and the residual dump, the
    session). ``residual``: a context manager around the residual
    dump."""
    import contextlib
    sess = _session(root, codec)
    stats = [sess.pre_dump(tree, step=1)["stats"]]
    _bump(tree, DIRTY_A)
    stats.append(sess.pre_dump(tree, step=2)["stats"])
    _bump(tree, DIRTY_B)
    with residual or contextlib.nullcontext():
        stats.append(sess.save(tree, step=3)["stats"])
    return stats, sess


def _async(tree, root):
    """(iv): the async dump, then every float leaf changed before wait()
    -> the receipts' (image id, stats)."""
    from repro_torch.api import DumpRequest
    sess = _session(root)
    r = sess.dump(DumpRequest(state=tree, step=7, mode="async"))
    assert not r.committed
    _bump(tree, _floats(tree))
    return [(w.image_id, w.stats) for w in sess.wait()]


def _async_chain(tree, root):
    """(iv): two async dumps under delta8 moments, the moments updated
    between -> the receipts' (image id, stats)."""
    from repro_torch.api import CodecPolicy, DumpRequest
    sess = _session(root, CodecPolicy(optimizer="delta8"))
    sess.dump(DumpRequest(state=tree, step=1, mode="async"))
    _bump(tree, [p for p in _floats(tree) if p.startswith("opt/")],
          STEP_BY)
    sess.dump(DumpRequest(state=tree, step=2, mode="async"))
    return [(w.image_id, w.stats) for w in sess.wait()]


def _image(root):
    """-> (sorted [(chunk, bytes)], {image id: manifest leaves})."""
    from repro_torch.core import as_tier, read_manifest
    tier = as_tier(root)
    base = os.path.join(root, "chunks")
    chunks = sorted((n, open(os.path.join(dp, n), "rb").read())
                    for dp, _, ns in os.walk(base) for n in ns)
    return chunks, {i: read_manifest(tier, i)["leaves"]
                    for i in sorted(tier.image_ids())}


# ------------------------------------------------ the unsharded port side
@pytest.fixture(scope="module")
def plain(work):
    """Every sequence on the unsharded tree, in this process."""
    from repro_torch.core import flatten_with_paths, tree_digest
    d = work[0]
    out = {"digest": tree_digest(flatten_with_paths(_state(d))),
           "mig": _migrate(_state(d), os.path.join(d, "plain_mig")),
           "pre": _predump(_state(d), os.path.join(d, "plain_pre"))[0],
           "async": _async(_state(d), os.path.join(d, "plain_async")),
           "async8": _async_chain(_state(d),
                                  os.path.join(d, "plain_async8"))}
    from repro_torch.api import CodecPolicy
    out["pre8"] = _predump(_state(d), os.path.join(d, "plain_pre8"),
                           CodecPolicy(optimizer="delta8"))[0]
    for name in ("mig", "pre", "pre8", "async", "async8"):
        out[f"image_{name}"] = _image(os.path.join(d, f"plain_{name}"))
    return out


# ----------------------------------------------------- the sharded side
def _placed(d):
    """-> (the state as DTensors on (4, 2), its unsharded values)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.distributed import sharding as shd
    want = _state(d)
    tree = _state(d)
    extra = tree.pop("extra")
    sps = _shardings((4, 2))
    sps.pop("extra")
    tree = shd.place(tree, sps)
    dm = shd.device_mesh(_mesh((4, 2)))
    tree["extra"] = {"uneven": distribute_tensor(
        extra["uneven"], dm, [Shard(0), Shard(1)])}
    return tree, want


def _mesh(shape):
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(shape, device="cpu")


def _shardings(shape):
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import LM
    from repro_torch.training import train_state_pspecs
    cfg = configs.get_tiny("granite-moe-3b-a800m")
    mesh = _mesh(shape)
    sps = shd.named(mesh, train_state_pspecs(LM(cfg),
                                             shd.make_rules(cfg, mesh)))
    sps["extra"] = {"uneven": shd.NamedSharding(mesh, shd.PartitionSpec())}
    return sps


def _restored_equal(root, want) -> tuple:
    """The latest image restored onto (2, 4) -> (leaves, leaves whose
    local shard is bitwise its slice of ``want``, split leaves,
    digest_verified), the counts summed over the ranks."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.api import RestoreRequest
    res = _session(root).restore(RestoreRequest(
        shardings=_shardings((2, 4))))
    want = _leaves(want)
    n = eq = split = 0
    for p, t in _leaves(res.state).items():
        shp, off = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        local = t.to_local()
        full = want[p][tuple(slice(o, o + s) for o, s in zip(off, shp))]
        n += 1
        eq += bool(torch.equal(local.reshape(-1).view(torch.uint8),
                               full.reshape(-1).view(torch.uint8)))
        split += tuple(local.shape) != tuple(t.shape)
    return _sum_over_ranks((n, eq, split)) + (res.digest_verified,)


def _mig_part(rank, d):
    from repro_torch.core import flatten_with_paths, tree_digest
    tree, want = _placed(d)
    out = {"digest": tree_digest(flatten_with_paths(tree))}
    out["mig"] = _migrate(tree, os.path.join(d, "sharded_mig"))
    out["restored"] = _restored_equal(os.path.join(d, "sharded_mig"), want)
    if rank == 0:
        out["image"] = _image(os.path.join(d, "sharded_mig"))
    return out


class _Gathers:
    """Counts ``sharding.gather_leaf``'s calls by leaf path in a block
    (every rank takes part in each gather)."""

    def __init__(self, tree):
        self.names = {id(t): p for p, t in _leaves(tree).items()}
        self.paths = []

    def __enter__(self):
        from repro_torch.distributed import sharding as shd
        self.orig = shd.gather_leaf

        def counted(t):
            self.paths.append(self.names.get(id(t), "?"))
            return self.orig(t)
        shd.gather_leaf = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import sharding as shd
        shd.gather_leaf = self.orig


def _pre_part(rank, d):
    import torch.distributed as dist
    from repro_torch.api import CodecPolicy
    tree, _ = _placed(d)
    split = {tuple(t.shape) for t in _leaves(tree).values()
             if tuple(t.to_local().shape) != tuple(t.shape)}
    gathers = _Gathers(tree)
    with _FullLeaves(split) as watch:
        stats, sess = _predump(tree, os.path.join(d, "sharded_pre"),
                               residual=gathers)
    out = {"pre": stats}
    if rank == 0:
        out["image_pre"] = _image(os.path.join(d, "sharded_pre"))
    # a change to one rank's shard alone dirties the leaf on every rank
    if rank == ONE_RANK:
        _bump(tree, [ONE_LEAF])
    out["one_rank"] = sess.pre_dump(tree, step=4)["stats"]
    both = [None] * WORLD
    dist.all_gather_object(both, (watch.peak, sorted(gathers.paths)))
    out["full_leaves_peak"] = [b[0] for b in both]
    out["residual_gathers"] = [b[1] for b in both]
    out["split_leaves"] = len(split)
    tree, _ = _placed(d)
    out["pre8"] = _predump(tree, os.path.join(d, "sharded_pre8"),
                           CodecPolicy(optimizer="delta8"))[0]
    if rank == 0:
        out["image_pre8"] = _image(os.path.join(d, "sharded_pre8"))
    return out


def _orch_part(rank, d):
    from repro_torch.api import MigrateRequest, MigrationPolicy
    tree, _ = _placed(d)
    root = os.path.join(d, "sharded_orch")
    sess = _session(root, migration=MigrationPolicy(predump_rounds=2))
    sess.handler.request("SIGTERM")
    rounds, dirty = [], [DIRTY_A, DIRTY_B]
    while sess.should_predump():
        rounds.append(sess.pre_dump_round(tree)["stats"]["leaves_dirty"])
        _bump(tree, dirty[len(rounds) - 1])
    assert sess.should_migrate()
    t = sess.migrate(MigrateRequest(state=tree))
    from repro_torch.core import flatten_with_paths
    want = {p: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            for p, v in flatten_with_paths(tree)}
    return {"rounds": rounds, "exit": t.exit_code, "image": t.image_id,
            "restored": _restored_equal(root, _unflat(want))}


def _async_part(rank, d):
    import torch.distributed as dist
    from repro_torch.api import DumpRequest
    from repro_torch.core import async_engine
    tree, _ = _placed(d)
    split = {tuple(t.shape) for t in _leaves(tree).values()
             if tuple(t.to_local().shape) != tuple(t.shape)}
    with _FullLeaves(split) as watch:
        receipts = _async(tree, os.path.join(d, "sharded_async"))
    tree, _ = _placed(d)
    chain = _async_chain(tree, os.path.join(d, "sharded_async8"))
    # a write job that fails on rank 0: every rank's wait() raises
    tree, _ = _placed(d)
    sess = _session(os.path.join(d, "sharded_fail"))
    if rank == 0:
        real = async_engine._dump_fn

        def broken(*a, **k):
            raise OSError("injected write failure")
        async_engine._dump_fn = broken
    sess.dump(DumpRequest(state=tree, step=9, mode="async"))
    try:
        sess.wait()
        raised = ""
    except Exception as e:
        raised = f"{type(e).__name__}: {e}"
    if rank == 0:
        async_engine._dump_fn = real
    # a sync dump that fails on rank 0 after two of its leaves: rank 0
    # finishes the gathers the others are in, and every rank raises
    sess = _session(os.path.join(d, "sharded_sync_fail"))
    if rank == 0:
        run_dump, calls = sess.executor.run_dump, []

        def failing(*a, **k):
            calls.append(1)
            if len(calls) > 2:
                raise OSError("injected chunk write failure")
            return run_dump(*a, **k)
        sess.executor.run_dump = failing
    try:
        sess.dump(DumpRequest(state=tree, step=9))
        sync_raised = ""
    except Exception as e:
        sync_raised = f"{type(e).__name__}: {e}"
    if rank == 0:
        del sess.executor.run_dump
    every = [None] * WORLD
    dist.all_gather_object(every, (receipts, chain, raised, watch.peak,
                                   sync_raised))
    out = {"async": receipts, "async8": chain,
           "receipts_by_rank": [e[:2] for e in every],
           "raised_by_rank": [e[2] for e in every],
           "full_leaves_peak": [e[3] for e in every],
           "sync_raised_by_rank": [e[4] for e in every]}
    if rank == 0:
        for name in ("async", "async8"):
            out[f"image_{name}"] = _image(os.path.join(d,
                                                       f"sharded_{name}"))
    return out


PARTS = {"mig": _mig_part, "pre": _pre_part, "orch": _orch_part,
         "async": _async_part}


@pytest.fixture(scope="module")
def runs(work):
    """Each part's 8 ranks, run when a test first asks for it; a part
    that fails or hangs fails its other tests without a second run."""
    cache = {}

    def get(part):
        if part not in cache:
            try:
                cache[part] = run_ranks(part, work[0], script=__file__)
            except AssertionError as e:
                cache[part] = e
        if isinstance(cache[part], AssertionError):
            raise cache[part]
        return cache[part]
    return get


def _jax_image(work, name):
    return _image(os.path.join(work[0], f"jax_{name}"))


def _same_stats(got, jax_stats):
    for g, j in zip(got, jax_stats, strict=True):
        assert {k: g.get(k) for k in STATS} == {k: j.get(k) for k in STATS}


# ------------------------------------------------------------------ (i)
def test_sharded_migrate_digest_equals_unsharded_and_jax(runs, plain,
                                                         work):
    """(i) F12: the lossless migration of the sharded state records the
    tree digest of the unsharded state and of JAX's sharded state, and
    its image is the unsharded port's and JAX's."""
    r = runs("mig")
    assert r["digest"] == plain["digest"] == work[1]["mig_digest"]
    assert r["mig"] == plain["mig"] == (work[1]["mig_digest"], 85)
    assert r["image"] == plain["image_mig"] == _jax_image(work, "mig")
    assert r["image"][0]


def test_sharded_migration_restores_onto_another_mesh(runs):
    """(i) the migration image onto (2, 4): every local shard bitwise
    its slice, the recorded digest verified."""
    n, eq, split, verified = runs("mig")["restored"]
    assert n == eq > 0 and split > 0
    assert verified is True


# ----------------------------------------------------------------- (ii)
@pytest.mark.parametrize("codec", ["pre", "pre8"])
def test_sharded_rounds_and_residual_equal_unsharded_and_jax(runs, plain,
                                                             work, codec):
    """(ii) F13: two pre-dump rounds then the residual dump of the
    sharded state write the unsharded port's images and JAX's, with the
    same dirty / clean / reused counts (lossless, and delta8 moments)."""
    r = runs("pre")
    assert r[codec] == plain[codec]
    _same_stats(r[codec], work[1][codec])
    n = r[codec][0]["leaves_dirty"]
    assert n == N_LEAVES and r[codec][0]["leaves_clean"] == 0
    assert r[codec][1]["leaves_dirty"] == len(DIRTY_A)
    assert r[codec][2]["leaves_reused"] == n - len(DIRTY_B)
    assert r[f"image_{codec}"] == plain[f"image_{codec}"] == \
        _jax_image(work, codec)


def test_sharded_residual_gathers_only_the_dirty_leaves(runs):
    """(ii) the residual dump gathers the leaves changed since the last
    round and no other, on every rank; no rank holds more than one
    full-size split leaf through the rounds and the residual, and only
    rank 0 one. A change to one rank's shard of a leaf alone makes that
    leaf dirty in the next round."""
    r = runs("pre")
    assert r["residual_gathers"] == [sorted(DIRTY_B)] * WORLD
    assert r["split_leaves"] > 1
    assert (r["one_rank"]["leaves_dirty"], r["one_rank"]["leaves_clean"]) \
        == (1, N_LEAVES - 1)
    assert r["full_leaves_peak"][0] == 1
    assert r["full_leaves_peak"][1:] == [0] * (WORLD - 1)


# ---------------------------------------------------------------- (iii)
def test_orchestrator_rounds_then_migrate_on_a_mesh(runs):
    """(iii) SIGTERM -> two pre-dump rounds -> the residual migration ->
    exit 85 -> a bitwise restore onto (2, 4)."""
    r = runs("orch")
    assert r["exit"] == 85
    assert r["rounds"][1] == len(DIRTY_A)
    n, eq, split, verified = r["restored"]
    assert n == eq > 0 and split > 0 and verified is True


# ----------------------------------------------------------------- (iv)
@pytest.mark.parametrize("name", ["async", "async8"])
def test_sharded_async_dump_equals_unsharded_and_jax(runs, plain, work,
                                                     name):
    """(iv) an async dump of the sharded state is the image of its values
    at capture, whatever the state does before wait() (and a delta8 chain
    of two): equal to the unsharded port's and JAX's."""
    r = runs("async")
    assert r[name] == plain[name]
    _same_stats([s for _, s in r[name]], work[1][name])
    assert r[f"image_{name}"] == plain[f"image_{name}"] == \
        _jax_image(work, name)


def test_sharded_async_wait_is_collective(runs):
    """(iv) every rank's wait() returns rank 0's receipts; a write job
    that fails on rank 0 raises on every rank's wait(); the capture is
    rank 0's alone: no other rank ever holds a full-size split leaf."""
    r = runs("async")
    assert all(x == r["receipts_by_rank"][0] for x in r["receipts_by_rank"])
    assert all("injected write failure" in m for m in r["raised_by_rank"])
    assert r["full_leaves_peak"][1:] == [0] * (WORLD - 1)
    assert r["full_leaves_peak"][0] >= 1


def test_sharded_dump_failing_on_rank_0_raises_on_every_rank(runs):
    """A sharded sync dump whose chunk writes fail on rank 0 mid-way:
    rank 0 finishes the gathers the other ranks are in, every rank
    raises rank 0's error, and no rank hangs."""
    got = runs("async")["sync_raised_by_rank"]
    assert all("injected chunk write failure" in m for m in got), got


if __name__ == "__main__":
    _rank_main(*sys.argv[1:], parts=PARTS)
