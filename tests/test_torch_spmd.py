"""repro_torch on a mesh of many devices, over real process groups: the
twins of tests/test_distributed.py's sharded train step and cross-mesh
restore, and K6's sharding rule, each run by 8 CPU ranks over gloo.

Every multi-process case starts its 8 ranks as subprocesses of this file
(``python tests/test_torch_spmd.py <part> <rank> ...``), joined by a
``FileStore``, with a deadline of its own (``RANK_TIMEOUT``): a hung rank
fails its case and never blocks the suite. A rank imports torch and
repro_torch only. The JAX side (8 forced host devices) runs in one
subprocess, as tests/test_distributed.py's does; the JAX weights reach the
port through ``params.from_jax``.

  (a) qwen3-8b tiny (d_model 64, heads 4/4, d_ff 128) on a (2, 4) mesh,
      one train step: ``w_up``'s local shard is its (data, model) slice;
      under fp32 compute the loss and every updated leaf equal the
      one-device step within ``STEP_ATOL``; under bf16 the loss equals
      JAX's sharded loss within the model-parity tolerance (1e-2,
      tests/test_torch_model.py).
  (b) the same step with ``cast_params_once`` (fp32: the cast is the
      identity, so bitwise (a)'s) and with the residual stream sharded
      over the sequence (``act_sharding`` P(data, model, None): the same
      sums in another order, within ``STEP_ATOL``); in bf16 cast-once
      within ``BF16_LOSS`` of (a)'s loss.
  (c) granite-moe tiny placed on (4, 2) and dumped from its DTensors:
      the image's chunks and manifest leaves equal an unsharded dump of
      the same values; during that dump no rank holds more than one
      full-size tensor of a split leaf at a time and ranks other than 0
      hold none (``_FullLeaves`` watches every op of the local program);
      restored onto (2, 4) and (8, 1), every local shard
      is bitwise its slice; an image the JAX package dumped on its (4, 2)
      mesh restores onto the port's (2, 4) bitwise.
  (x) xlstm-tiny (2 heads, d_inner 128) on (2, 4), where 2 heads meet 4
      model ranks: ``F.logsigmoid``'s sharding rule and the local head
      split (``sharding.local_rows``) give bitwise the one-device ops,
      forward and gradient; the fp32 train step, prefill and a decode step
      equal one device's within ``STEP_ATOL``.
  (g) K6's op on DTensors with 4 query heads split 4 ways and 2 KV heads
      (not divisible): equal to the op on the full tensors; a tiny
      qwen3-8b prefill (H 4, KV 2) on (2, 4) gives the one-device logits
      and cache; granite-moe's shard-local dispatch gives the one-device
      loss where no group drops a token.
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 8
RANK_TIMEOUT = 120          # seconds, per multi-process case
STEP_ATOL = 2e-5            # fp32 sharded step vs one device
BF16_LOSS = 1e-2            # the model-parity tolerance for bf16 losses
SEQ, BATCH = 32, 8


def _tiny_qwen():
    from repro_torch import configs
    return configs.get_tiny("qwen3-8b").replace(
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128)


def _tokens(vocab):
    return np.random.default_rng(0).integers(0, vocab, (BATCH, SEQ))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    return env


def run_ranks(part: str, workdir: str, world: int = WORLD,
              timeout: float = RANK_TIMEOUT, script: str = __file__):
    """Start ``world`` ranks of ``part`` (of ``script``'s PARTS); wait at
    most ``timeout`` s for all of them; -> rank 0's results
    (``<workdir>/<part>.pt``)."""
    store = os.path.join(workdir, f"store_{part}")
    logs = [open(os.path.join(workdir, f"{part}_{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), part, str(r),
         str(world), store, workdir], env=_env(), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    def tail(r):
        logs[r].seek(0)
        return logs[r].read()[-3000:]
    assert not hung, f"ranks {hung} of {part} hung past {timeout} s:\n" \
        + tail(hung[0])
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"{part}: rank {bad[0]} failed:\n" + tail(bad[0])
    return torch.load(os.path.join(workdir, f"{part}.pt"))


# ----------------------------------------------------------- the JAX side
_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro import configs
    from repro.core import Checkpointer
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_test_mesh
    from repro.models.model import LM
    from repro.optim import OptConfig
    from repro.training.train_loop import (init_train_state,
        make_train_step, train_state_pspecs)
    out_dir, toks = sys.argv[1], np.load(sys.argv[2])

    def flat(t, path=""):
        if isinstance(t, dict):
            o = {}
            for k in t:
                o.update(flat(t[k], f"{path}/{k}" if path else k))
            return o
        return {path: np.asarray(t)}

    def named(mesh, lm, cfg):
        return jax.tree.map(lambda ps: NamedSharding(mesh, ps),
                            train_state_pspecs(lm, shd.make_rules(cfg, mesh)),
                            is_leaf=lambda x: isinstance(x, P))

    # (a): the twin's step, its weights saved for the port
    mesh = make_test_mesh((2, 4), ("data", "model"))
    cfg = configs.get_tiny("qwen3-8b").replace(
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128)
    lm = LM(cfg, act_sharding=NamedSharding(mesh, P("data", None, None)))
    state = init_train_state(lm, jax.random.PRNGKey(0))
    np.savez(out_dir + "/params.npz", **flat(state["params"]))
    sps = named(mesh, lm, cfg)
    state = jax.tree.map(jax.device_put, state, sps)
    step = jax.jit(make_train_step(lm, OptConfig()),
                   in_shardings=(sps, NamedSharding(mesh, P("data", None))),
                   out_shardings=(sps, None))
    t = jax.device_put(jnp.asarray(toks, jnp.int32),
                       NamedSharding(mesh, P("data", None)))
    _, m = step(state, {"tokens": t})
    # (c): granite-moe tiny dumped from its (4, 2) mesh
    gcfg = configs.get_tiny("granite-moe-3b-a800m")
    glm = LM(gcfg)
    mesh_a = make_test_mesh((4, 2), ("data", "model"))
    gstate = jax.tree.map(jax.device_put,
                          init_train_state(glm, jax.random.PRNGKey(1)),
                          named(mesh_a, glm, gcfg))
    Checkpointer(out_dir + "/jax_image").save(gstate, step=5)
    print(json.dumps({"loss": float(m["loss"])}))
""")


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory(prefix="spmd_") as d:
        np.save(os.path.join(d, "tokens.npy"),
                _tokens(_tiny_qwen().vocab_size))
        env = _env()
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run([sys.executable, "-c", _JAX_SIDE, d,
                            os.path.join(d, "tokens.npy")], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-4000:]
        jax_out = json.loads(r.stdout.strip().splitlines()[-1])
        yield d, jax_out


@pytest.fixture(scope="module")
def train_runs(work):
    return run_ranks("train", work[0])


@pytest.fixture(scope="module")
def restore_runs(work):
    return run_ranks("restore", work[0])


@pytest.fixture(scope="module")
def prefill_runs(work):
    return run_ranks("prefill", work[0])


def _one_device_step(d, **lm_kw):
    """The one-device fp32 step on the JAX weights and tokens."""
    import functools
    from repro_torch.models.model import LM
    from repro_torch.models.params import from_jax
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_step
    lm = LM(_tiny_qwen(), **lm_kw)
    lm.loss = functools.partial(lm.loss, compute_dtype=torch.float32)
    params = from_jax(_unflat(dict(np.load(os.path.join(d,
                                                        "params.npz")))),
                      "cpu")
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32)}
    toks = torch.from_numpy(np.load(os.path.join(d, "tokens.npy")))
    return make_train_step(lm, OptConfig())(state, {"tokens": toks})


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{path}/{k}" if path else k))
        return out
    return {path: tree}


# -------------------------------------------------------------- (a), (b)
def test_sharded_step_shards_w_up_by_data_and_model(train_runs):
    """(a) every rank's ``w_up`` shard is its (data, model) slice of the
    full leaf, before and after the step."""
    got = train_runs["w_up"]
    assert len(got) == WORLD
    full = train_runs["a"]["state"]["params/stack/b0/mlp/w_up"]
    G, D, F = full.shape
    for rank, (coord, before, after) in got.items():
        i, j = coord
        sl = (slice(None), slice(i * D // 2, (i + 1) * D // 2),
              slice(j * F // 4, (j + 1) * F // 4))
        assert before.shape == (G, D // 2, F // 4), rank
        assert torch.equal(after, full[sl]), rank


def test_sharded_step_equals_one_device_step(train_runs, work):
    """(a) fp32: the loss and every updated leaf of the 8-rank step equal
    the one-device step within STEP_ATOL."""
    state, m = _one_device_step(work[0])
    ref = _leaves(state)
    got = train_runs["a"]
    assert abs(got["loss"] - float(m["loss"])) < STEP_ATOL
    assert sorted(got["state"]) == sorted(ref)
    worst = max(float((got["state"][p].float() - ref[p].float())
                      .abs().max()) for p in ref)
    print(f"sharded vs one-device fp32 step: worst leaf error {worst:.3e}")
    assert worst < STEP_ATOL


def test_sharded_loss_equals_jax_sharded_loss(train_runs, work):
    """(a) bf16: the port's sharded loss against JAX's on 8 forced host
    devices, the same weights and tokens."""
    mine, jax_loss = train_runs["bf16"]["loss"], work[1]["loss"]
    print(f"sharded bf16 loss: port {mine:.6f}, JAX {jax_loss:.6f}")
    assert abs(mine - jax_loss) < BF16_LOSS
    assert np.isfinite(mine)


@pytest.mark.parametrize("variant", ["cast", "seq"])
def test_cast_once_and_sequence_sharding_keep_the_step(train_runs, variant):
    """(b) cast-once is bitwise (a)'s in fp32 (the cast is the identity);
    the sequence-sharded residual stream sums in another order, within
    STEP_ATOL; in bf16 cast-once keeps the loss within BF16_LOSS."""
    a, b = train_runs["a"], train_runs[variant]
    worst = max(float((a["state"][p].float() - b["state"][p].float())
                      .abs().max()) for p in a["state"])
    print(f"{variant} vs (a): loss {a['loss']:.7f} {b['loss']:.7f}, "
          f"worst leaf {worst:.3e}")
    if variant == "cast":
        assert b["loss"] == a["loss"] and worst == 0.0
        assert abs(train_runs["cast_bf16"]["loss"]
                   - train_runs["bf16"]["loss"]) < BF16_LOSS
    else:
        assert abs(b["loss"] - a["loss"]) < STEP_ATOL
        assert worst < STEP_ATOL
        assert train_runs["seq_local"] == [BATCH // 2, SEQ // 4, 64]


# ------------------------------------------------------------------ (c)
def test_dump_from_dtensors_equals_unsharded_dump(restore_runs):
    """(c) the sharded dump writes the chunks and manifest leaves of an
    unsharded dump of the same values."""
    r = restore_runs
    assert r["chunks_sharded"] == r["chunks_plain"] and r["chunks_plain"]
    assert r["leaves_sharded"] == r["leaves_plain"]


def test_sharded_delta8_chain_equals_unsharded_chain(restore_runs):
    """(c) a delta8 chain's second image, its moments encoded on the
    device stage against the baseline rank 0 copied as the first sharded
    dump passed, equals the unsharded chain's: chunks, manifest leaves
    and stats."""
    (c_s, l_s, st_s), (c_p, l_p, st_p) = restore_runs["delta"]
    assert c_s == c_p and l_s == l_p
    assert st_s == st_p and st_s["leaves_device"] > 0
    assert any(leaf["codec"] == "delta8" and
               leaf["codec_meta"].get("applied") for leaf in l_s)


def test_sharded_dump_holds_one_gathered_leaf_on_rank_0(restore_runs):
    """(c) the sharded dump streams its leaves to rank 0 one at a time:
    rank 0 never holds two full-size tensors of split leaves at once, and
    no other rank ever holds one. Uneven shards (7 x 5 x 3 on (4, 2))
    lie where DTensor lays them and gather back whole."""
    peaks = restore_runs["full_leaves_peak"]
    n_split = restore_runs["split_leaves"]
    print(f"full-size split leaves live at once, by rank: {peaks} "
          f"({n_split} split leaves)")
    assert n_split > 1
    assert peaks[0] == 1 and peaks[1:] == [0] * (WORLD - 1)
    assert restore_runs["uneven_bad"] == 0


@pytest.mark.parametrize("shape", ["2x4", "8x1"])
def test_cross_mesh_restore_preserves_values(restore_runs, shape):
    """(c) the (4, 2) image restored onto another mesh: every rank's
    every local shard is bitwise its slice."""
    n_leaves, n_equal, n_sharded = restore_runs[shape]
    assert n_leaves == n_equal > 0
    assert n_sharded > 0                 # some leaves really split


def test_jax_image_restores_onto_port_mesh(restore_runs):
    """(c) the JAX package's (4, 2) image onto the port's (2, 4)."""
    n_leaves, n_equal, n_sharded = restore_runs["jax_2x4"]
    assert n_leaves == n_equal > 0 and n_sharded > 0


# ------------------------------------------------------------------ (x)
@pytest.fixture(scope="module")
def xlstm_runs(work):
    return run_ranks("xlstm", work[0])


def test_log_sigmoid_rule_is_bitwise_the_one_device_op(xlstm_runs):
    """``F.logsigmoid`` on a DTensor split over (data, model), through the
    port's rule for its forward and backward ops: the values and the
    gradient are the one-device op's, bitwise."""
    assert xlstm_runs["logsig"] == [True, True]


@pytest.mark.parametrize("scan", ["mlstm", "slstm"])
def test_local_head_split_is_bitwise_the_one_device_scan(xlstm_runs, scan):
    """The chunked mLSTM scan and the sLSTM steps through ``local_rows``
    (2 heads whole on each rank's rows): every output, and the sLSTM
    inputs' gradient, bitwise the one-device call's; its recurrent
    weights' gradient, a sum over rows the two data shards add in another
    order, within STEP_ATOL."""
    assert xlstm_runs[scan] and all(xlstm_runs[scan]), xlstm_runs[scan]
    if scan == "slstm":
        assert xlstm_runs["slstm_wgrad"] < STEP_ATOL


def test_sharded_xlstm_step_equals_one_device_step(xlstm_runs):
    """The fp32 train step of xlstm-tiny on (2, 4): its loss and every
    updated leaf equal the one-device step within STEP_ATOL."""
    loss_err, worst = xlstm_runs["train"]
    print(f"xlstm sharded vs one-device step: loss {loss_err:.3e}, worst "
          f"leaf {worst:.3e}")
    assert loss_err < STEP_ATOL and worst < STEP_ATOL


def test_sharded_xlstm_decode_equals_one_device(xlstm_runs):
    """xlstm-tiny's fp32 prefill and one decode step on (2, 4): the
    logits of both and every recurrent cache leaf equal one device's
    within STEP_ATOL of the leaf's largest magnitude (at least 1: the
    mLSTM memory C sums 33 tokens' outer products)."""
    errs = xlstm_runs["decode"]
    print(f"xlstm sharded vs one-device prefill, decode, cache: {errs}")
    assert max(errs) < STEP_ATOL


# ------------------------------------------------------------------ (g)
def test_flash_op_rule_on_gqa_heads_split_four_ways(prefill_runs):
    """(g) the op on DTensors (4 query heads over 4 ranks, 2 KV heads)
    equals the op on the full tensors."""
    assert prefill_runs["op_err"] == 0.0
    assert prefill_runs["op_local_heads"] == 1


def test_sharded_moe_loss_equals_one_device(prefill_runs):
    """The MoE's shard-local dispatch (one token group a data shard, as
    the JAX package's): with a capacity that drops nothing, its CE and
    aux loss over 8 ranks are the one-device step's, fp32."""
    assert prefill_runs["moe_err"] < STEP_ATOL


def test_sharded_prefill_equals_one_device(prefill_runs):
    """(g) a tiny qwen3-8b prefill (H 4, KV 2) on (2, 4): the logits and
    the cache of the one-device prefill, in fp32."""
    assert prefill_runs["logits_err"] < STEP_ATOL
    assert prefill_runs["cache_err"] < STEP_ATOL


# ================================================================= ranks
def _train_part(rank, d):
    import functools
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import LM
    from repro_torch.models.params import from_jax
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_step, train_state_pspecs
    mesh = make_test_mesh((2, 4), device="cpu")
    cfg = _tiny_qwen()
    rules = shd.make_rules(cfg, mesh)
    toks = torch.from_numpy(np.load(os.path.join(d, "tokens.npy")))
    jparams = _unflat(dict(np.load(os.path.join(d, "params.npz"))))
    P = shd.PartitionSpec
    toks = shd.distribute(toks, shd.NamedSharding(mesh, P("data", None)))
    out = {}

    def run(name, seq=False, dtype=torch.float32, **kw):
        act = shd.NamedSharding(mesh, P("data", "model" if seq else None,
                                        None))
        lm = LM(cfg, act_sharding=act, **kw)
        lm.loss = functools.partial(lm.loss, compute_dtype=dtype)
        params = from_jax(jparams, "cpu")
        state = {"params": params, "opt": init_opt_state(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        state = shd.place(state, shd.named(mesh,
                                           train_state_pspecs(lm, rules)))
        w = state["params"]["stack"]["b0"]["mlp"]["w_up"]
        before = w.to_local().clone()
        if seq:
            seen = []
            real = lm._cs

            def spy(x):
                x = real(x)
                seen.append(list(x.to_local().shape))
                return x
            lm._cs = spy
        state, m = make_train_step(lm, OptConfig())(state, {"tokens": toks})
        full = {p: t.detach() for p, t in
                _leaves(shd.gather_tree(state)).items()}
        out[name] = {"loss": float(m["loss"].full_tensor()), "state": full}
        if name == "a":
            coord = mesh.ranks.tolist()
            at = [(i, j) for i in range(2) for j in range(4)
                  if coord[i][j] == rank][0]
            got = [None] * WORLD
            dist.all_gather_object(got, (at, before, w.to_local().clone()))
            out["w_up"] = dict(enumerate(got))
        if seq:
            out["seq_local"] = seen[0]
    run("a")
    run("bf16", dtype=torch.bfloat16)
    run("cast", cast_params_once=True)
    run("cast_bf16", dtype=torch.bfloat16, cast_params_once=True)
    run("seq", seq=True)
    return out


def _restore_part(rank, d):
    import shutil
    from repro_torch import configs
    from repro_torch.api import CheckpointSession, DumpRequest
    from repro_torch.core import read_manifest
    from repro_torch.core.storage import as_tier
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import LM
    from repro_torch.training import init_train_state, train_state_pspecs
    cfg = configs.get_tiny("granite-moe-3b-a800m")
    lm = LM(cfg)
    state = init_train_state(lm, torch.Generator().manual_seed(1),
                             device="cpu")

    def sps(shape):
        mesh = make_test_mesh(shape, device="cpu")
        return shd.named(mesh, train_state_pspecs(
            lm, shd.make_rules(cfg, mesh)))
    root = os.path.join(d, "sharded_image")
    plain = os.path.join(d, "plain_image")
    placed = shd.place(state, sps((4, 2)))
    split = {tuple(t.shape) for t in _leaves(placed).values()
             if tuple(t.to_local().shape) != tuple(t.shape)}
    with _FullLeaves(split) as watch:
        CheckpointSession(root, device="cpu").dump(DumpRequest(
            state=placed, step=5))
    import torch.distributed as dist
    peaks = [None] * WORLD
    dist.all_gather_object(peaks, watch.peak)
    out = {"full_leaves_peak": peaks, "split_leaves": sum(
        tuple(t.to_local().shape) != tuple(t.shape)
        for t in _leaves(placed).values())}
    # uneven shards: shard_box is DTensor's layout at this rank's
    # coordinate, and gather_leaf puts every shard back in its place
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dm = shd.device_mesh(make_test_mesh((4, 2), device="cpu"))
    x = torch.arange(7 * 5 * 3, dtype=torch.float32).reshape(7, 5, 3)
    bad = 0
    for pl in ([Shard(0), Shard(0)], [Shard(1), Shard(0)],
               [Replicate(), Shard(2)], [Shard(0), Replicate()],
               [Replicate(), Replicate()]):
        t = distribute_tensor(x, dm, pl)
        want = compute_local_shape_and_global_offset(t.shape, dm, pl)
        bad += tuple(map(tuple, want)) != shd.shard_box(
            t.shape, tuple(dm.shape), pl, dm.get_coordinate())
        got = shd.gather_leaf(t)
        bad += (not torch.equal(got, x)) if rank == 0 else got is not None
    out["uneven_bad"] = _sum_over_ranks((bad,))[0]
    # a delta8 chain: rank 0's baseline, copied leaf by leaf as the first
    # dump passes, encodes the second dump as the unsharded session's does
    from repro_torch.api import CodecPolicy, SessionConfig
    chain = {}

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}
    for name in ("sharded", "plain"):
        if name == "plain" and rank:
            break
        tree = copy(state)
        if name == "sharded":
            tree = shd.place(tree, sps((4, 2)))
        cfgd = SessionConfig(root=os.path.join(d, f"delta_{name}"),
                             codec=CodecPolicy(optimizer="delta8",
                                               device="on"))
        sess = CheckpointSession(cfgd, device="cpu")
        sess.dump(DumpRequest(state=tree, step=5))
        for t in _leaves(tree["opt"]).values():
            (t.to_local() if shd.is_dtensor(t) else t).add_(1e-3)
        chain[name] = sess.dump(DumpRequest(state=tree, step=6)).stats
    if rank == 0:
        CheckpointSession(plain, device="cpu").dump(DumpRequest(
            state=state, step=5))

        def chunks(r):
            base = os.path.join(r, "chunks")
            return sorted((n, open(os.path.join(dp, n), "rb").read())
                          for dp, _, ns in os.walk(base) for n in ns)
        out["chunks_sharded"], out["chunks_plain"] = chunks(root), \
            chunks(plain)
        out["leaves_sharded"], out["leaves_plain"] = (
            read_manifest(as_tier(r), "step_0000000005")["leaves"]
            for r in (root, plain))
        out["delta"] = [(chunks(os.path.join(d, f"delta_{n}")),
                         read_manifest(as_tier(os.path.join(
                             d, f"delta_{n}")), "step_0000000006")["leaves"],
                         chain[n]) for n in ("sharded", "plain")]

    def compare(tree, want):
        n = eq = split = 0
        for p, t in _leaves(tree).items():
            full = want[p]
            spec = t.placements
            local = t.to_local()
            from torch.distributed.tensor._utils import \
                compute_local_shape_and_global_offset
            shp, off = compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, spec)
            sl = tuple(slice(o, o + s) for o, s in zip(off, shp))
            n += 1
            eq += bool(torch.equal(local.view(-1).view(torch.uint8),
                                   full[sl].reshape(-1).view(torch.uint8)))
            split += tuple(local.shape) != tuple(full.shape)
        return n, eq, split
    want = _leaves(state)
    for shape in ((2, 4), (8, 1)):
        tree, _ = CheckpointSession(root, device="cpu").load_latest(
            shardings=sps(shape))
        out["x".join(map(str, shape))] = _sum_over_ranks(compare(tree,
                                                                 want))
    jroot = os.path.join(d, "jax_image")
    jwant = _leaves(CheckpointSession(jroot, device="cpu").load_latest()[0])
    tree, _ = CheckpointSession(jroot, device="cpu").load_latest(
        shardings=sps((2, 4)))
    out["jax_2x4"] = _sum_over_ranks(compare(tree, jwant))
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


class _FullLeaves:
    """A dispatch mode over a block: the most storages of ``shapes`` (the
    full shapes of a tree's split leaves) that this rank's local program
    held at once. Every op's non-view outputs are seen (DTensor ops as
    the local ops DTensor runs), each such storage live until torch frees
    it (``weakref.finalize``)."""

    def __init__(self, shapes):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.distributed.tensor import DTensor
        watch = self
        self.shapes, self.live, self.peak = set(shapes), {}, 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if not func.is_view:
                    for t in (out if isinstance(out, (tuple, list))
                              else [out]):
                        if isinstance(t, torch.Tensor) and \
                                tuple(t.shape) in watch.shapes:
                            watch._hold(t.untyped_storage())
                return out
        self.mode = Mode()

    def _hold(self, st):
        import weakref
        if id(st) not in self.live:
            self.live[id(st)] = weakref.finalize(st, self.live.pop, id(st),
                                                 None)
            self.peak = max(self.peak, len(self.live))

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for fin in list(self.live.values()):
            fin.detach()


def _sum_over_ranks(counts):
    import torch.distributed as dist
    t = torch.tensor(counts, dtype=torch.int64)
    dist.all_reduce(t)
    return tuple(int(x) for x in t)


def _prefill_part(rank, d):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import kvcache
    from repro_torch.models.model import LM
    P = shd.PartitionSpec
    out = {}
    # the op alone: q heads 4 over model 4, KV 2 heads whole
    mesh = make_test_mesh((2, 4), device="cpu")
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 16, 4, 16, generator=g)
    k = torch.randn(4, 16, 2, 16, generator=g)
    v = torch.randn(4, 16, 2, 16, generator=g)
    want = flash_attention(q, k, v, causal=True)
    put = lambda t, spec: shd.distribute(t, shd.NamedSharding(mesh, spec))
    got = flash_attention(put(q, P("data", None, "model", None)),
                          put(k, P("data", None, None, None)),
                          put(v, P("data", None, None, None)), causal=True)
    out["op_local_heads"] = got.to_local().shape[2]
    out["op_err"] = float((got.full_tensor() - want).abs().max())
    # a tiny qwen3-8b prefill (H 4, KV 2) against one device, fp32
    cfg = configs.get_tiny("qwen3-8b")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(2), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    ref_logits, ref_cache = lm.prefill(params, tokens=toks,
                                       compute_dtype=torch.float32)
    rules = shd.make_rules(cfg, mesh)
    shape = ShapeConfig("t", "prefill", SEQ, BATCH)
    crules = shd.cache_rules(cfg, mesh, shape)
    crules["batch"] = shd.batch_axes(mesh, BATCH)
    logits, cache = lm.prefill(
        shd.place(params, shd.named(mesh, lm.pspecs(rules))),
        tokens=put(toks, P("data", None)), compute_dtype=torch.float32,
        cache_shardings=shd.named(mesh, kvcache.cache_pspecs(cfg, crules)))
    out["logits_err"] = float((logits.full_tensor() - ref_logits)
                              .abs().max())
    got = _leaves(shd.gather_tree({k: v for k, v in cache.items()
                                   if k != "pos"}))
    ref = _leaves({k: v for k, v in ref_cache.items() if k != "pos"})
    out["cache_err"] = max(float((got[p].float() - ref[p].float())
                                 .abs().max()) for p in ref)
    # granite-moe tiny, a capacity no group overflows: the shard-local
    # dispatch's loss and aux are the one-device step's
    cfg = configs.get_tiny("granite-moe-3b-a800m").replace(
        capacity_factor=8.0)
    lm = LM(cfg, act_sharding=shd.NamedSharding(mesh, P("data", None,
                                                        None)))
    params = lm.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    ref, ref_m = lm.loss(params, {"tokens": toks},
                         compute_dtype=torch.float32)
    got, got_m = lm.loss(
        shd.place(params, shd.named(mesh, lm.pspecs(shd.make_rules(
            cfg, mesh)))), {"tokens": put(toks, P("data", None))},
        compute_dtype=torch.float32)
    out["moe_err"] = max(abs(float(shd.reduce_partial(got_m[k])
                                   .full_tensor()) - float(ref_m[k]))
                         for k in ("ce", "aux"))
    return out


def _xlstm_part(rank, d):
    import functools

    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import kvcache, ssm
    from repro_torch.models.model import LM
    from repro_torch.models.params import tree_map
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_step, train_state_pspecs
    P = shd.PartitionSpec
    mesh = make_test_mesh((2, 4), device="cpu")

    def put(t, spec):
        return shd.distribute(t, shd.NamedSharding(mesh, spec))
    cfg = configs.get_tiny("xlstm-350m")
    H, di = cfg.num_heads, cfg.d_inner
    g = torch.Generator().manual_seed(5)
    out = {}
    # the rule alone: values and gradient, bitwise
    x, w = torch.randn(8, 16, 12, generator=g), torch.randn(8, 16, 12,
                                                            generator=g)
    spec = P("data", None, "model")
    xs = put(x, spec).requires_grad_()
    x1 = x.clone().requires_grad_()
    ys = F.logsigmoid(xs)
    (ys * put(w, spec)).sum().backward()
    (F.logsigmoid(x1) * w).sum().backward()
    out["logsig"] = [torch.equal(ys.detach().full_tensor(),
                                 F.logsigmoid(x)),
                     torch.equal(xs.grad.full_tensor(), x1.grad)]
    # the head split alone: 2 heads whole on each rank's rows
    B, S = BATCH, SEQ
    q, k, v = (torch.randn(B, S, di, generator=g) for _ in range(3))
    li = torch.randn(B, S, H, generator=g)
    lf = F.logsigmoid(torch.randn(B, S, H, generator=g))
    want = ssm._mlstm_scan(q, k, v, li, lf, H, 8)
    got = shd.local_rows(lambda *a: ssm._mlstm_scan(*a, H, 8),
                         tuple(put(t, spec) for t in (q, k, v))
                         + tuple(put(t, P("data")) for t in (li, lf)))
    out["mlstm"] = [torch.equal(a.full_tensor(), b)
                    for a, b in zip(got, want)]
    gx = torch.randn(B, S, 4, di, generator=g)
    r = {n: (torch.randn(H, di // H, di // H, generator=g) * 0.1)
         for n in ssm._GATES}
    init = ssm.slstm_init_state(cfg, B, torch.float32, "cpu")
    r1 = {n: t.clone().requires_grad_() for n, t in r.items()}
    gx1 = gx.clone().requires_grad_()
    want = ssm._slstm_steps(gx1, init, r1, H, S)
    want[0].sum().backward()
    rs = [put(r[n], P()).requires_grad_() for n in ssm._GATES]
    gxs = put(gx, P("data", None, None, "model")).requires_grad_()

    def steps(gx, *rr):
        st = ssm.slstm_init_state(cfg, gx.shape[0], torch.float32, "cpu")
        return ssm._slstm_steps(gx, st, dict(zip(ssm._GATES, rr)), H, S)
    got = shd.local_rows(steps, (gxs,), tuple(rs))
    got[0].sum().backward()
    out["slstm"] = [torch.equal(a.detach().full_tensor(), b.detach())
                    for a, b in zip(got, want)] + \
        [torch.equal(gxs.grad.full_tensor(), gx1.grad)]
    # a weight's gradient sums the rows of two data shards: another order
    out["slstm_wgrad"] = max(float((t.grad.full_tensor() - r1[n].grad)
                                   .abs().max())
                             for n, t in zip(ssm._GATES, rs))
    # the model: the fp32 train step, prefill and decode against one device
    lm1 = LM(cfg)
    lm1.loss = functools.partial(lm1.loss, compute_dtype=torch.float32)
    params = lm1.init(torch.Generator().manual_seed(4), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()

    def fresh():
        p = tree_map(lambda _, t: t.clone(), params)
        return {"params": p, "opt": init_opt_state(p),
                "step": torch.zeros((), dtype=torch.int32)}
    ref, ref_m = make_train_step(lm1, OptConfig())(fresh(), {"tokens": toks})
    lm = LM(cfg, act_sharding=shd.NamedSharding(mesh, P("data", None, None)))
    lm.loss = functools.partial(lm.loss, compute_dtype=torch.float32)
    rules = shd.make_rules(cfg, mesh)
    state = shd.place(fresh(), shd.named(mesh, train_state_pspecs(lm,
                                                                  rules)))
    st, m = make_train_step(lm, OptConfig())(
        state, {"tokens": put(toks, P("data", None))})
    got, want = _leaves(shd.gather_tree(st)), _leaves(ref)
    out["train"] = (abs(float(m["loss"].full_tensor())
                        - float(ref_m["loss"])),
                    max(float((got[p].float() - want[p].float()).abs().max())
                        for p in want))
    f32 = torch.float32
    ref_l, ref_c = lm1.prefill(params, tokens=toks, S_max=SEQ + 1,
                               compute_dtype=f32)
    nxt = ref_l.argmax(-1)[:, None]
    ref_l2, ref_c = lm1.decode_step(params, ref_c, nxt, compute_dtype=f32)
    crules = shd.cache_rules(cfg, mesh, ShapeConfig("t", "decode", SEQ + 1,
                                                    BATCH))
    crules["batch"] = shd.batch_axes(mesh, BATCH)
    sp = shd.place(params, shd.named(mesh, lm.pspecs(rules)))
    logits, cache = lm.prefill(
        sp, tokens=put(toks, P("data", None)), S_max=SEQ + 1,
        compute_dtype=f32,
        cache_shardings=shd.named(mesh, kvcache.cache_pspecs(cfg, crules)))
    l2, cache = lm.decode_step(sp, cache, put(nxt, P("data", None)),
                               compute_dtype=f32)
    gc = _leaves(shd.gather_tree({k: v for k, v in cache.items()
                                  if k != "pos"}))
    rc = _leaves({k: v for k, v in ref_c.items() if k != "pos"})
    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1.0))
    out["decode"] = (rel(logits.full_tensor(), ref_l),
                     rel(l2.full_tensor(), ref_l2),
                     max(rel(gc[p], rc[p]) for p in rc))
    return out


PARTS = {"train": _train_part, "restore": _restore_part,
         "prefill": _prefill_part, "xlstm": _xlstm_part}


def _rank_main(part, rank, world, store, workdir, parts=None):
    import torch.distributed as dist
    sys.path.insert(0, os.path.abspath(SRC))
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=RANK_TIMEOUT))
    try:
        out = (parts or PARTS)[part](rank, workdir)
        if rank == 0:
            torch.save(out, os.path.join(workdir, f"{part}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
