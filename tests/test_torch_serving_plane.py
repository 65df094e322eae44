"""The port's live serving plane: the twin of tests/test_serving_plane.py
on gemma2-2b ``tiny()`` with ``device="cpu"``, and parity with the JAX
package's plane.

The SessionManager multiplexes Poisson traffic over one model via a
shared KV slot pool; the whole plane (params + pool + session leaves +
side-table) dumps through the CheckpointSession façade and restores
eagerly (zero drops, the same tokens) or lazily (params-first
autoscale-from-image). gemma2's tiny config has a 16-token window on its
even layers and both softcaps, and the page (16 slots of KV) lets decode
run to the window's edge. ``test_fleet_wave_migrates_serving_plane``
rides the plane through the port's fleet coordinator (SimCluster's
SimServeJob on the same tiny gemma2, page 24 as in the JAX twin).

Parity with the JAX package (weights carried across by ``from_jax``):

  * ``slot_take``/``slot_put`` on a seeded pool give bit-equal leaves;
  * the traffic module is the JAX package's file, and its streams are
    equal request for request;
  * a plane run in fp32 compute emits the JAX plane's tokens (greedy
    argmax over the same math in float32, summed in another order);
  * plane images cross packages both ways (eager and lazy into the port,
    eager into JAX), and the two packages' manifests of the same plane
    are equal apart from ``env``, ``created_at`` and ``digest``.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.api import CheckpointSession as JSession  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serving import SessionManager as JManager  # noqa: E402
from repro.serving import TrafficGenerator as JTraffic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import CheckpointSession  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import (Request, ServeEngine,  # noqa: E402
                                 SessionManager, TrafficGenerator)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SLOTS, PAGE = 4, 16
DEV = "cpu"


@pytest.fixture(scope="module")
def lm_params():
    lm = LM(configs.get_tiny("gemma2-2b"))
    return lm, lm.init(torch.Generator().manual_seed(0), device=DEV)


@pytest.fixture(scope="module")
def jpair():
    """The JAX package's tiny gemma2 and its weights carried into the
    port."""
    jlm = JLM(jconfigs.get_tiny("gemma2-2b"))
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = LM(configs.get_tiny("gemma2-2b"))
    return jlm, jparams, lm, from_jax(jax.tree.map(np.asarray, jparams), DEV)


def _mgr(lm, params, **kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("page_len", PAGE)
    return SessionManager(lm, params, device=DEV, **kw)


def _traffic(vocab, *, seed=7, rate=2.0):
    return TrafficGenerator(seed=seed, vocab_size=vocab, rate=rate,
                            prompt_support=(4,), target_max=6)


def _outputs(mgr):
    return {sid: s.output().tolist() for sid, s in mgr.sessions.items()
            if s.status != "rejected"}


def _session(name):
    return CheckpointSession(f"mem://{name}", device=DEV)


# ------------------------------------------------------------------ traffic
def test_traffic_stream_is_seeded_and_replayable():
    a = TrafficGenerator(seed=3, vocab_size=100, rate=2.0)
    b = TrafficGenerator(seed=3, vocab_size=100, rate=2.0)
    ra, rb = a.take(10), b.take(10)
    assert [r.sid for r in ra] == [r.sid for r in rb]
    assert all(np.array_equal(x.prompt, y.prompt)
               for x, y in zip(ra, rb))
    assert [r.target for r in ra] == [r.target for r in rb]
    c = TrafficGenerator(seed=3, vocab_size=100, rate=2.0)
    c.fast_forward(6)
    assert c.emitted == 6
    tail = c.take(4)
    assert [r.sid for r in tail] == [r.sid for r in ra[6:]]
    assert all(np.array_equal(x.prompt, y.prompt)
               for x, y in zip(tail, ra[6:]))
    with pytest.raises(RuntimeError):
        a.fast_forward(2)               # only valid before any draw
    st = a.state()
    assert st["seed"] == 3 and st["emitted"] == 10


def test_traffic_state_carries_distribution_and_rebuilds():
    g = TrafficGenerator(seed=11, vocab_size=50, rate=2.5,
                         prompt_support=(3, 9), prompt_zipf_s=2.0,
                         target_alpha=1.5, target_scale=2.0, target_max=9)
    head = g.take(7)
    assert len(head) == 7
    cut = g.state()
    assert tuple(cut["prompt_support"]) == (3, 9)
    assert cut["target_max"] == 9 and cut["prompt_zipf_s"] == 2.0
    g2 = TrafficGenerator.from_state(cut)
    assert g2.emitted == 7
    a, b = g.take(5), g2.take(5)
    assert [r.sid for r in a] == [r.sid for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.target for r in a] == [r.target for r in b]
    assert [r.arrival for r in a] == [r.arrival for r in b]


def test_traffic_shapes_are_heavy_tailed_but_bounded():
    g = TrafficGenerator(seed=5, vocab_size=64, rate=3.0,
                         prompt_support=(4, 6, 8), target_max=12)
    reqs = g.take(50)
    arrivals = [r.arrival for r in reqs]
    assert arrivals == sorted(arrivals)
    assert {len(r.prompt) for r in reqs} <= {4, 6, 8}
    assert all(1 <= r.target <= 12 for r in reqs)
    assert all(0 <= int(r.prompt.max()) < 64 for r in reqs)
    assert len({r.target for r in reqs}) > 1


def test_traffic_module_is_the_jax_packages_file():
    """Numpy only, so the port keeps the JAX package's file as it is."""
    src = ROOT / "src"
    assert (src / "repro_torch/serving/traffic.py").read_bytes() == \
        (src / "repro/serving/traffic.py").read_bytes()


@pytest.mark.parametrize("kw", [
    dict(seed=0, vocab_size=256000, rate=0.5,
         prompt_support=(256, 512, 1024, 2048), target_max=32),
    dict(seed=11, vocab_size=50, rate=2.5, prompt_support=(3, 9),
         prompt_zipf_s=2.0, target_alpha=1.5, target_scale=2.0,
         target_max=9),
])
def test_traffic_stream_equals_jax_request_for_request(kw):
    a, b = TrafficGenerator(**kw), JTraffic(**kw)
    got = a.due(6.0) + a.take(20)
    want = b.due(6.0) + b.take(20)
    assert len(got) == len(want) > 20
    for x, y in zip(got, want):
        assert (x.sid, x.arrival, x.target, x.rng_seed) == \
            (y.sid, y.arrival, y.target, y.rng_seed)
        assert x.prompt.dtype == y.prompt.dtype
        assert np.array_equal(x.prompt, y.prompt)
    assert a.state() == b.state()


# ------------------------------------------------------------ the slot pool
def _seeded_pool(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim else np.asarray(5, np.int32),
        jax.tree.map(np.asarray, jkv.init_cache(cfg, SLOTS, 8, jnp.float32)))


def _as_port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _eq(port, jtree):
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    for path, want in flat:
        node = port
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.from_numpy(np.array(want)).dtype
        assert np.array_equal(node.numpy(), np.asarray(want)), path


def test_slot_axes_match_jax():
    cfg = configs.get_tiny("gemma2-2b")
    assert kvcache.slot_axes(cfg) == jkv.slot_axes(
        jconfigs.get_tiny("gemma2-2b"))


def test_slot_take_and_put_are_bit_equal_to_jax():
    jcfg = jconfigs.get_tiny("gemma2-2b")
    cfg = configs.get_tiny("gemma2-2b")
    pool = _seeded_pool(jcfg)
    idx = [3, 0, 2]
    jcoh = jkv.slot_take(jax.tree.map(jnp.asarray, pool), jcfg,
                         jnp.asarray(idx, jnp.int32), pos=6)
    tpool = _as_port(pool)
    coh = kvcache.slot_take(tpool, cfg, idx, pos=6)
    _eq(coh, jcoh)
    assert int(coh["pos"]) == 6 and coh["pos"].dtype == torch.int32
    # a copy, never a view into the pool: decode writes cohorts in place
    coh["stack"]["b0"]["k"].zero_()
    assert not torch.equal(tpool["stack"]["b0"]["k"][:, 3],
                           coh["stack"]["b0"]["k"][:, 0])
    # scatter a fresh cohort back; the pool keeps its own pos
    new = _seeded_pool(jcfg, seed=1)
    jnew = jkv.slot_take(jax.tree.map(jnp.asarray, new), jcfg,
                         jnp.asarray([0, 1, 2], jnp.int32), pos=9)
    want = jkv.slot_put(jax.tree.map(jnp.asarray, pool), jnew, jcfg,
                        jnp.asarray(idx, jnp.int32))
    got = kvcache.slot_put(tpool, kvcache.slot_take(
        _as_port(new), cfg, [0, 1, 2], pos=9), cfg, idx)
    assert got is tpool                     # in place
    _eq(got, want)
    assert int(got["pos"]) == 5


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_slot_pool_of_recurrent_caches_matches_jax(arch):
    """A pool of recurrent entries (mlstm C/n/m and conv tail, slstm
    c/n/m/h; zamba2's mamba2 h and conv tails, its tail layer and the
    shared block's stacked K/V): slot axes equal to JAX's, take and put
    bit-equal to JAX's."""
    jcfg, cfg = jconfigs.get_tiny(arch), configs.get_tiny(arch)
    assert kvcache.slot_axes(cfg) == jkv.slot_axes(jcfg)
    pool, new = _seeded_pool(jcfg), _seeded_pool(jcfg, seed=1)
    idx = [3, 0, 2]
    tpool = _as_port(pool)
    _eq(kvcache.slot_take(tpool, cfg, idx, pos=6),
        jkv.slot_take(jax.tree.map(jnp.asarray, pool), jcfg,
                      jnp.asarray(idx, jnp.int32), pos=6))
    jnew = jkv.slot_take(jax.tree.map(jnp.asarray, new), jcfg,
                         jnp.asarray([0, 1, 2], jnp.int32), pos=9)
    want = jkv.slot_put(jax.tree.map(jnp.asarray, pool), jnew, jcfg,
                        jnp.asarray(idx, jnp.int32))
    got = kvcache.slot_put(tpool, kvcache.slot_take(
        _as_port(new), cfg, [0, 1, 2], pos=9), cfg, idx)
    assert got is tpool
    _eq(got, want)


# ---------------------------------------------------------------- admission
def test_byte_budget_admission_control(lm_params):
    lm, params = lm_params
    slot_bytes = kvcache.cache_bytes(lm.cfg, 1, PAGE, torch.bfloat16)
    assert slot_bytes == jkv.cache_bytes(jconfigs.get_tiny("gemma2-2b"), 1,
                                         PAGE, jnp.bfloat16)
    mgr = _mgr(lm, params, pool_bytes=2 * slot_bytes)
    reqs = _traffic(lm.cfg.vocab_size).take(5)
    for r in reqs:
        mgr.submit(r)
    assert mgr.used_slots <= 2 and mgr.queue
    peak = 0
    for _ in range(40):
        mgr.step()
        peak = max(peak, mgr.used_slots)
        if all(mgr.sessions[r.sid].status == "done" for r in reqs):
            break
    assert peak <= 2
    assert all(mgr.sessions[r.sid].status == "done" for r in reqs)
    assert mgr.stats["rejected"] == 0
    assert mgr.live_bytes == 0


def test_pool_bytes_zero_admits_nothing(lm_params):
    lm, params = lm_params
    mgr = _mgr(lm, params, pool_bytes=0)
    assert mgr.pool_bytes == 0
    s = mgr.submit(Request("z", 0.0, np.zeros(4, np.int32), 2, 1))
    mgr.step()
    assert s.status == "queued" and mgr.used_slots == 0
    assert mgr.queue == ["z"] and s.n == 0


def test_oversized_request_rejected_up_front(lm_params):
    lm, params = lm_params
    mgr = _mgr(lm, params)
    s = mgr.submit(Request("big", 0.0, np.zeros(12, np.int32), 8, 1))
    assert s.status == "rejected"
    assert "big" not in mgr.queue and s.slot is None
    assert mgr.stats["rejected"] == 1
    mgr.step()
    assert mgr.sessions["big"].n == 0


def test_duplicate_sid_is_an_error(lm_params):
    lm, params = lm_params
    mgr = _mgr(lm, params)
    mgr.submit(Request("s", 0.0, np.zeros(4, np.int32), 2, 1))
    with pytest.raises(ValueError, match="already submitted"):
        mgr.submit(Request("s", 1.0, np.zeros(4, np.int32), 2, 1))


def test_plane_needs_a_card_unless_cpu_is_asked(lm_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    lm, params = lm_params
    with pytest.raises(RuntimeError, match="cuda"):
        SessionManager(lm, params, slots=SLOTS, page_len=PAGE)


# ---------------------------------------------------------------- migration
def test_eager_migration_zero_drop_bit_identical(lm_params):
    lm, params = lm_params
    vocab = lm.cfg.vocab_size
    WARM, POST = 5, 10

    ref = _mgr(lm, params)
    ref.run(WARM + POST, traffic=_traffic(vocab))
    o_ref = _outputs(ref)

    src = _mgr(lm, params)
    gen = _traffic(vocab)
    src.run(WARM, traffic=gen)
    src.drain()
    with _session("serve-plane-eager") as sess:
        src.checkpoint(sess, traffic=gen.state())
        in_flight = set(src.live_sids())
        assert in_flight

        mgr, res = SessionManager.restore_from(sess, lm)
    assert res.digest_verified is True
    assert in_flight <= set(mgr.sessions)
    assert mgr.clock == src.clock
    gen2 = _traffic(vocab)
    gen2.fast_forward(
        res.manifest["meta"]["serve_plane"]["traffic"]["emitted"])
    mgr.run(POST, traffic=gen2)
    done_before = set(
        res.manifest["meta"]["serve_plane"].get("completed", []))
    o_mig = _outputs(mgr)
    check = in_flight | {sid for sid in o_mig if sid not in done_before}
    assert check and all(o_ref.get(sid) == o_mig.get(sid)
                         for sid in check), \
        [sid for sid in sorted(check) if o_ref.get(sid) != o_mig.get(sid)]


def test_lazy_autoscale_serves_new_before_old_pages_land(lm_params):
    lm, params = lm_params
    vocab = lm.cfg.vocab_size
    WARM, POST = 4, 12
    RATE = 1.5

    ref = _mgr(lm, params)
    ref.run(WARM + POST, traffic=_traffic(vocab, rate=RATE))
    o_ref = _outputs(ref)

    src = _mgr(lm, params)
    gen = _traffic(vocab, rate=RATE)
    src.run(WARM, traffic=gen)
    src.drain()
    with _session("serve-plane-lazy") as sess:
        src.checkpoint(sess, traffic=gen.state())
        in_flight = set(src.live_sids())

        mgr, res = SessionManager.restore_from(sess, lm, lazy=True)
        assert res.lazy and mgr._lazy is not None
        held = [s for s in mgr.sessions.values() if s.status == "restoring"]
        assert held
        assert all(s.slot is not None for s in held)

        nov = mgr.submit(Request("nov0", float(mgr.clock),
                                 np.zeros(4, np.int32), 3, 99))
        assert nov.status == "active" and nov.n >= 1
        assert all(s.status == "restoring" for s in held)

        mgr.complete_restore()
        assert mgr._lazy is None
        assert res.state.server.verify_tree_digest() is True
        assert all(s.status == "active" or s.status == "done"
                   for s in held)
        mgr.complete_restore()

        gen2 = _traffic(vocab, rate=RATE)
        gen2.fast_forward(
            res.manifest["meta"]["serve_plane"]["traffic"]["emitted"])
        mgr.run(POST, traffic=gen2)
    o_mig = _outputs(mgr)
    assert in_flight <= set(mgr.sessions)
    bad = [sid for sid in sorted(in_flight)
           if o_ref.get(sid) != o_mig.get(sid)]
    assert not bad, f"lazy continuations diverged: {bad}"
    assert mgr.sessions["nov0"].status == "done"


def test_restoring_sessions_hold_their_slots(lm_params):
    lm, params = lm_params
    src = _mgr(lm, params)
    gen = _traffic(lm.cfg.vocab_size, rate=5.0)
    src.run(3, traffic=gen)
    src.drain()
    with _session("serve-plane-slots") as sess:
        src.checkpoint(sess, traffic=gen.state())
        mgr, _res = SessionManager.restore_from(sess, lm, lazy=True)
        held = {s.slot for s in mgr.sessions.values()
                if s.status == "restoring"}
        assert held and not held & set(mgr.free)
        assert len(held) + len(mgr.free) == SLOTS
        mgr.complete_restore()


def test_lazy_restore_hydrates_queued_sessions(lm_params):
    lm, params = lm_params

    def plane():
        m = _mgr(lm, params, slots=1)
        m.submit(Request("a", 0.0, np.arange(4, dtype=np.int32), 3, 1))
        m.submit(Request("b", 0.0, np.arange(4, dtype=np.int32) + 1, 2, 2))
        return m

    ref = plane()
    for _ in range(8):
        ref.step()
    o_ref = _outputs(ref)
    assert ref.sessions["b"].status == "done"

    src = plane()
    src.step()
    src.drain()
    assert src.sessions["a"].status == "active"
    assert src.sessions["b"].status == "queued" and src.queue == ["b"]
    with _session("serve-plane-queued") as sess:
        src.checkpoint(sess)
        mgr, _res = SessionManager.restore_from(sess, lm, lazy=True)
        assert mgr.queue == ["b"] and mgr.sessions["b"].prompt is None
        mgr.complete_restore()
        assert mgr._lazy is None
        assert mgr.sessions["b"].prompt is not None
        for _ in range(8):
            mgr.step()
    assert mgr.sessions["b"].status == "done"
    assert _outputs(mgr) == o_ref


def test_checkpoint_during_lazy_restore_completes_first(lm_params):
    lm, params = lm_params
    src = _mgr(lm, params)
    gen = _traffic(lm.cfg.vocab_size, rate=4.0)
    src.run(3, traffic=gen)
    src.drain()
    in_flight = set(src.live_sids())
    assert in_flight
    with _session("serve-plane-redump") as sess:
        src.checkpoint(sess, traffic=gen.state())
        mgr, _ = SessionManager.restore_from(sess, lm, lazy=True)
        assert any(s.status == "restoring" for s in mgr.sessions.values())
        r2 = mgr.checkpoint(sess, step=mgr.clock + 1, traffic=gen.state())
        assert mgr._lazy is None

        mgr2, res2 = SessionManager.restore_from(sess, lm,
                                                 image_id=r2.image_id)
    assert res2.digest_verified is True
    table = res2.manifest["meta"]["serve_plane"]
    assert all(rec["status"] != "restoring"
               for rec in table["sessions"].values())
    assert all(rec["n"] > 0 for rec in table["sessions"].values()
               if rec["status"] == "active")
    assert in_flight <= set(mgr2.sessions)
    for _ in range(40):
        mgr2.step()
        if all(mgr2.sessions[sid].status == "done" for sid in in_flight):
            break
    src.draining = False
    src.run(40)
    o_src, o_mig = _outputs(src), _outputs(mgr2)
    assert all(o_src[sid] == o_mig[sid] for sid in in_flight)


# ------------------------------------------------------------ fault injection
@pytest.fixture
def port_flaky_tier():
    """tests/faultinject.py's FlakyTier over a port tier: the same seeded
    schedule, and an instance of the port's Tier so its sessions take
    it."""
    from faultinject import FaultSchedule, FlakyTier
    from repro_torch.core.storage import Tier, as_tier

    class PortFlakyTier(FlakyTier, Tier):
        pass

    def make(inner, **schedule_kw):
        return PortFlakyTier(as_tier(inner), FaultSchedule(**schedule_kw))
    return make


def test_dump_fault_no_partial_image_then_retry_bitwise(lm_params,
                                                        port_flaky_tier):
    from repro_torch.api import SessionConfig
    from repro_torch.core.storage import as_tier
    lm, params = lm_params
    inner = as_tier("remote://torch-serve-plane-fault?seed=0")
    tier = port_flaky_tier(inner, error_rate=1.0, error_budget=1,
                           only="images/")

    src = _mgr(lm, params)
    gen = _traffic(lm.cfg.vocab_size)
    src.run(4, traffic=gen)
    src.drain()
    in_flight = set(src.live_sids())
    cut = gen.state()

    def committed():
        return [i for i in inner.image_ids()
                if inner.exists(inner.manifest_path(i))]

    attempts = 0
    while not committed():
        attempts += 1
        assert attempts <= 8, "retried dump never converged"
        try:
            with CheckpointSession(SessionConfig(root=tier),
                                   device=DEV) as s:
                src.checkpoint(s, traffic=cut)
        except (TimeoutError, IOError):
            if attempts == 1:
                assert not committed()
    assert attempts > 1
    assert tier.stats["errors_injected"] >= 1

    src.draining = False
    with CheckpointSession(SessionConfig(root=inner), device=DEV) as s3:
        mgr, res = SessionManager.restore_from(s3, lm)
    assert res.digest_verified is True
    assert in_flight <= set(mgr.sessions)
    gen2 = _traffic(lm.cfg.vocab_size)
    gen2.fast_forward(cut["emitted"])
    mgr.run(10, traffic=gen2)
    src.run(10, traffic=gen)
    o_src, o_mig = _outputs(src), _outputs(mgr)
    assert all(o_src[sid] == o_mig[sid] for sid in in_flight)


# ------------------------------------------------------------- prefetch hint
def test_prefetch_hint_orders_lazy_stream(lm_params):
    from repro_torch.core.plan import plan_restore
    from repro_torch.core.storage import as_tier
    lm, params = lm_params
    mgr = _mgr(lm, params)
    mgr.run(4, traffic=_traffic(lm.cfg.vocab_size, rate=4.0))
    hint = mgr.prefetch_hint()
    assert hint[0] == "params" and hint[-1] == "pool"
    with _session("torch-serve-plane-hint") as sess:
        receipt = mgr.checkpoint(sess)
    plan = plan_restore(as_tier("mem://torch-serve-plane-hint"),
                        receipt.image_id)
    order = plan.prefetch_order

    def hint_rank(path):
        for i, pre in enumerate(hint):
            if path == pre or path.startswith(pre + "/"):
                return i
        return len(hint)
    ranks = [hint_rank(p) for p in order]
    assert ranks == sorted(ranks)
    assert order[0].startswith("params")


# ---------------------------------------------------------------- fleet
def test_fleet_wave_migrates_serving_plane():
    """A SimServeJob rides a coordinator preemption wave like a trainer:
    drained at a DECODE boundary, dumped with the serve-plane side-table
    in meta, restored elsewhere with its digest checked and zero dropped
    sessions."""
    from repro_torch.fleet import SimCluster
    cl = SimCluster(hosts=2, seed=6, device=DEV)
    (jid,) = cl.submit_serve_jobs(1, ticks=3, slots=4, page_len=24,
                                  rate=3.0)
    job = cl.jobs[jid]
    assert cl.coordinator.registry.get(jid).kind == "serve"
    live = set(job.mgr.live_sids())
    assert live                                     # wave catches real work
    clock = job.mgr.clock

    report = cl.coordinator.preemption_wave()
    assert report.drained[jid] == clock             # decode-boundary drain
    assert jid in report.dumped

    ack = cl.coordinator.restore_job(jid)           # digest checked inside
    assert ack is not None and ack.step == clock
    assert live <= set(job.mgr.sessions)            # adopted, zero drops
    job.run(8)                                      # and it keeps serving
    assert all(job.mgr.sessions[sid].status == "done" for sid in live)


# ----------------------------------------------------------------- wire
def test_serve_wire_fields_roundtrip():
    """The serving fields of the fleet's frames, through the port's wire
    (repro_torch.fleet.messages, a copy of the JAX package's), and a JAX
    frame decoded by the port."""
    from repro.fleet.messages import DrainCommand as JDrain
    from repro_torch.api import wire
    from repro_torch.fleet.messages import DrainCommand, Heartbeat
    d = wire.decode(DrainCommand(job_id="j1", boundary="decode").to_wire())
    assert d.boundary == "decode"
    assert wire.decode(DrainCommand(job_id="j1").to_wire()).boundary \
        == "step"
    h = wire.decode(Heartbeat(job_id="j1", step=4, sent_at=1.0,
                              sessions=7).to_wire())
    assert h.sessions == 7
    j = wire.decode(JDrain(job_id="j2", boundary="decode").to_wire())
    assert isinstance(j, DrainCommand) and j.boundary == "decode"


# ------------------------------------------------- ServeEngine satellites
def test_engine_generated_buffer_is_incremental(lm_params, monkeypatch):
    lm, params = lm_params
    eng = ServeEngine(lm, params, max_len=32)
    eng.submit(np.zeros((2, 4), np.int32))
    eng.generate(5)
    out = eng.generated()
    assert out.shape == (2, 5) and out.base is eng._gen
    assert len(eng.out_tokens) == 5
    assert np.array_equal(np.stack(eng.out_tokens, 1), out)

    def boom(*a, **k):
        raise AssertionError("token hot path restacked history")
    monkeypatch.setattr(np, "stack", boom)
    buf_before = eng._gen
    eng.generate(8)
    assert eng._gen is buf_before
    eng.generate(20)
    monkeypatch.undo()
    assert eng.generated().shape == (2, 20)
    assert eng._gen.shape[1] >= 20


def test_engine_restore_session_no_per_token_split(lm_params):
    from repro_torch.device import to_host
    lm, params = lm_params
    eng = ServeEngine(lm, params, max_len=32)
    eng.submit(np.zeros((1, 4), np.int32))
    eng.generate(6)
    state = eng.session_state()
    state = {"cache": state["cache"], "generated": to_host(
        state["generated"]), "prompt_len": to_host(state["prompt_len"])}
    eng2 = ServeEngine(lm, params, max_len=32)
    eng2.restore_session(state)
    assert np.array_equal(eng2.generated(), eng.generated())
    assert eng2._gen.flags["C_CONTIGUOUS"]


def test_engine_resume_from_lazy_defers_digest(lm_params):
    lm, params = lm_params
    CUT, GEN = 6, 14
    ref = ServeEngine(lm, params, max_len=32)
    ref.submit(np.zeros((2, 4), np.int32))
    full = ref.generate(GEN).copy()

    eng = ServeEngine(lm, params, max_len=32)
    eng.submit(np.zeros((2, 4), np.int32))
    eng.generate(CUT)
    with _session("torch-serve-engine-lazy") as sess:
        eng.checkpoint(sess, arch=lm.cfg.name)

        lz = ServeEngine(lm, params, max_len=32)
        res = lz.resume_from(sess, lazy=True)
        assert res.lazy is True
        srv = res.state.server
        assert srv.expected_digest
        assert srv.verify_tree_digest() is True
        assert np.array_equal(lz.generate(GEN), full)

        eg = ServeEngine(lm, params, max_len=32)
        res2 = eg.resume_from(sess)
        assert res2.lazy is False and res2.digest_verified is True
        assert np.array_equal(eg.generate(GEN), full)


# -------------------------------------------------- parity with JAX's plane
def _jtraffic(vocab, rate=2.0):
    return JTraffic(seed=7, vocab_size=vocab, rate=rate,
                    prompt_support=(4,), target_max=6)


def _jmgr(jlm, jparams):
    return JManager(jlm, jparams, slots=SLOTS, page_len=PAGE,
                    compute_dtype=jnp.float32)


def _tmgr(jpair):
    return _mgr(jpair[2], jpair[3], compute_dtype=torch.float32)


def test_plane_tokens_equal_jax_plane_fp32(jpair):
    """The same traffic through both packages' planes, fp32 compute, past
    gemma2's 16-token window: every session's tokens are the JAX
    plane's, and the cohorts formed are the same."""
    jlm, jparams = jpair[:2]
    vocab = jlm.cfg.vocab_size
    j = _jmgr(jlm, jparams)
    j.run(14, traffic=_jtraffic(vocab))
    t = _tmgr(jpair)
    t.run(14, traffic=_traffic(vocab))
    assert _outputs(t) == _outputs(j) and len(_outputs(t)) > 8
    assert t.stats == j.stats
    assert max(s.pos for s in t.sessions.values()) >= 4 + 6 - 1
    assert any(s.n == s.target for s in t.sessions.values())


def _cut_plane(mgr, gen, warm=5):
    mgr.run(warm, traffic=gen)
    mgr.drain()
    return gen.state()


def test_jax_plane_image_restores_in_port(jpair, tmp_path):
    """A JAX plane image adopted by the port's manager, eagerly and
    lazily, continues with the JAX plane's tokens (digest verified)."""
    jlm, jparams, lm, _ = jpair
    vocab = jlm.cfg.vocab_size
    ref = _jmgr(jlm, jparams)
    ref.run(12, traffic=_jtraffic(vocab))
    want = _outputs(ref)

    src = _jmgr(jlm, jparams)
    cut = _cut_plane(src, _jtraffic(vocab))
    in_flight = set(src.live_sids())
    root = str(tmp_path / "jax-plane")
    src.checkpoint(JSession(root), traffic=cut)
    for lazy in (False, True):
        mgr, res = SessionManager.restore_from(
            CheckpointSession(root, device=DEV), lm, lazy=lazy,
            compute_dtype=torch.float32)
        assert mgr.pool["stack"]["b0"]["k"].dtype == torch.float32
        if lazy:
            mgr.complete_restore()
            assert res.state.server.verify_tree_digest() is True
        else:
            assert res.digest_verified is True
        gen = _traffic(vocab)
        gen.fast_forward(cut["emitted"])
        mgr.run(7, traffic=gen)
        got = _outputs(mgr)
        assert in_flight and all(got[sid] == want[sid] for sid in in_flight)
        assert all(got[sid] == want[sid] for sid in got
                   if sid not in res.manifest["meta"]["serve_plane"][
                       "completed"])


def test_port_plane_image_restores_in_jax(jpair, tmp_path):
    jlm, jparams, _, _ = jpair
    vocab = jlm.cfg.vocab_size
    ref = _tmgr(jpair)
    ref.run(12, traffic=_traffic(vocab))
    want = _outputs(ref)

    src = _tmgr(jpair)
    cut = _cut_plane(src, _traffic(vocab))
    in_flight = set(src.live_sids())
    root = str(tmp_path / "torch-plane")
    src.checkpoint(CheckpointSession(root, device=DEV), traffic=cut)
    mgr, res = JManager.restore_from(JSession(root), jlm,
                                     compute_dtype=jnp.float32)
    assert res.digest_verified is True
    gen = _jtraffic(vocab)
    gen.fast_forward(cut["emitted"])
    mgr.run(7, traffic=gen)
    got = _outputs(mgr)
    assert in_flight and all(got[sid] == want[sid] for sid in in_flight)


def test_plane_manifests_equal_across_packages(jpair, tmp_path):
    """One JAX plane image adopted by each package and dumped again at
    once: the two re-dumps hold the same state bit for bit, and their
    manifests are equal apart from env, created_at and digest (the same
    leaf records and chunks, the same serve_plane side-table, prefetch
    hint and migration record)."""
    from repro.core.restore import read_manifest as jread
    from repro.core.storage import as_tier as jtier
    from repro_torch.core.restore import read_manifest
    from repro_torch.core.storage import as_tier
    jlm, jparams, lm, _ = jpair
    vocab = jlm.cfg.vocab_size
    src = _jmgr(jlm, jparams)
    cut = _cut_plane(src, _jtraffic(vocab))
    root = str(tmp_path / "src")
    src.checkpoint(JSession(root), traffic=cut)
    jm_, _ = JManager.restore_from(JSession(root), jlm,
                                   compute_dtype=jnp.float32)
    tm_, _ = SessionManager.restore_from(CheckpointSession(root, device=DEV),
                                         lm, compute_dtype=torch.float32)
    jr = jm_.checkpoint(JSession(str(tmp_path / "j")), traffic=cut)
    tr = tm_.checkpoint(CheckpointSession(str(tmp_path / "t"), device=DEV),
                        traffic=cut)
    assert jr.image_id == tr.image_id
    jm = jread(jtier(str(tmp_path / "j")), jr.image_id)
    tm = read_manifest(as_tier(str(tmp_path / "t")), tr.image_id)
    drop = ("env", "created_at", "digest")
    assert {k: v for k, v in tm.items() if k not in drop} == \
        {k: v for k, v in jm.items() if k not in drop}
    assert set(tm["meta"]) >= {"serve_plane", "prefetch_hint", "migration"}
    assert len(tm["meta"]["serve_plane"]["sessions"]) > 0


# ----------------------------------------------------------------- the CLI
def test_serve_cli_defaults_to_gemma2_and_resumes(tmp_path, capsys,
                                                 monkeypatch):
    """launch/serve.py's default arch is the JAX CLI's, gemma2-2b; its
    tiny config serves past the 16-token window, and a session dumped at
    token 11 resumes in a fresh run with the same tokens."""
    from repro_torch.launch import serve
    asked = []
    get_tiny = serve.configs.get_tiny
    monkeypatch.setattr(serve.configs, "get_tiny",
                        lambda arch: asked.append(arch) or get_tiny(arch))
    flags = ["--device", "cpu", "--gen", "24", "--batch", "2",
             "--prompt-len", "8"]
    serve.main(flags)
    ref = capsys.readouterr().out.split("generated tokens:")[1]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-at", "11"]
    with pytest.raises(SystemExit), pytest.warns(DeprecationWarning):
        serve.main(flags + ck + ["--stop-after-ckpt"])
    assert "dumped at token 11" in capsys.readouterr().out
    with pytest.warns(DeprecationWarning):
        serve.main(flags + ck + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed session at token 11" in out
    assert out.split("generated tokens:")[1] == ref
    assert asked == ["gemma2-2b"] * 3
