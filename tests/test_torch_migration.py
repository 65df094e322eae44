"""Preempt-to-migrate on the port: the twin of tests/test_migration.py case
for case on ``device="cpu"`` at the tiny qwen3 config, plus the parity and
cross-framework contracts of the lifecycle.

The bit-identity contract uses the port's deterministic elastic-DP harness
(training/elastic_dp.py): per-example programs + global-order aggregation
make the continuation independent of the host partitioning, so a run
preempted mid-training and resumed on fewer hosts must equal the
unpreempted run EXACTLY on the CPU — not just to tolerance.

Across packages (the JAX package is the reference):

  * the data pipeline is a copy: the same ``--data-dir`` and seed give the
    same shard bytes and the same token stream, exactly;
  * per-example grads + apply and ``microbatches=2`` from shared weights
    (``params.from_jax``) agree with repro.training.train_loop within the
    tolerances of tests/test_torch_model.py (bf16 loss within 1e-2, per-leaf
    relative error of the parameter change, m and v within STEP_REL = 0.3);
  * a migration image either package writes is read by the other, and
    both write the same image of the same state apart from ``env``,
    ``created_at`` and ``digest`` when the record carries no rng;
  * the CLIs: the JAX launcher SIGTERMed to exit 85 is continued by the
    port's ``--resume --device cpu`` with the losses of the uninterrupted
    JAX run within the bf16 loss tolerance (1e-2), and the reverse.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import subprocess_env  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import (CheckpointSession, CodecPolicy,  # noqa: E402
                             DumpRequest, MigrateRequest, MigrationPolicy,
                             PreemptionPolicy, RestoreRequest, SessionConfig)
from repro_torch.core import (EXIT_CHECKPOINTED, Checkpointer,  # noqa: E402
                              CorruptionError, MigrationManifest,
                              MigrationOrchestrator, PreemptionHandler,
                              flatten_with_paths, read_manifest, resume,
                              train_meta, tree_digest)
from repro_torch.data import DataIterator, TokenDataset  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.training import (abstract_train_state,  # noqa: E402
                                  init_train_state, make_train_step)
from repro_torch.training.elastic_dp import (ElasticDPTrainer,  # noqa: E402
                                             fleet_topology)
from repro_torch.training.fault_tolerance import (  # noqa: E402
    FleetPolicy, RestartPolicy, StragglerMonitor)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

STEP_REL = 0.3          # tests/test_torch_model.py: a bf16 train step
LOSS_ABS = 1e-2         # tests/test_torch_model.py: a bf16 loss


@pytest.fixture(scope="module")
def tiny():
    cfg = configs.get_tiny("qwen3-8b")
    return cfg, LM(cfg), OptConfig(warmup_steps=2, total_steps=100)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, tiny):
    cfg, _, _ = tiny
    root = tmp_path_factory.mktemp("tokens")
    return TokenDataset(str(root), vocab_size=cfg.vocab_size, seed=0)


def trainer(tiny, dataset, *, hosts, global_batch=4, **kw):
    _, lm, opt = tiny
    return ElasticDPTrainer(lm, opt, dataset, global_batch=global_batch,
                            seq_len=16, hosts=hosts, device="cpu", **kw)


def ckpt(path, **kw):
    return Checkpointer(str(path), device="cpu", **kw)


def bitwise_equal(a, b) -> bool:
    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def state_struct(lm):
    return abstract_train_state(lm)


def orchestrator(ck, t, **kw):
    return MigrationOrchestrator(ck, arch="qwen3-8b-tiny",
                                 topology=t.topology(), **kw)


# ---------------------------------------------------------------- lifecycle
def test_preempt_migrate_shrink_fleet_bit_identical(tiny, dataset, tmp_path):
    """The acceptance contract: preempt a 4-host run mid-training, resume
    on 2 hosts (different host count AND DP degree), reach bit-identical
    state versus the unpreempted 4-host run at the same step."""
    cfg, lm, opt = tiny
    ref = trainer(tiny, dataset, hosts=4)
    ref.run(4)

    t = trainer(tiny, dataset, hosts=4)
    t.run(2)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t).install()
    try:
        orch.handler.request("test")
        assert orch.should_migrate()
        code = orch.migrate(t.state, t.iters[0], opt_cfg=opt)
    finally:
        orch.uninstall()
    assert code == EXIT_CHECKPOINTED
    assert orch.last_migration.state_digest
    assert orch.last_migration.host_count == 4

    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", host_count=2, dp_degree=2)
    assert rep.topology_changed
    assert rep.changes == {"host_count": [4, 2], "dp_degree": [4, 2]}
    assert rep.digest_verified is True
    assert rep.data["local_batch"] == 2

    t2 = ElasticDPTrainer.from_resume(lm, opt, dataset, rep, seq_len=16)
    assert t2.hosts == 2
    t2.run(2)
    assert t2.step_count == ref.step_count
    assert bitwise_equal(ref.state, t2.state)


def test_resume_grow_fleet_and_unchanged(tiny, dataset, tmp_path):
    """Elasticity is symmetric (N+k hosts) and the no-change path reports
    no topology change."""
    cfg, lm, opt = tiny
    ref = trainer(tiny, dataset, hosts=2)
    ref.run(3)
    t = trainer(tiny, dataset, hosts=2)
    t.run(1)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t)
    orch.handler.request("test")
    orch.migrate(t.state, t.iters[0])

    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", host_count=4, dp_degree=4)
    assert rep.changes == {"host_count": [2, 4], "dp_degree": [2, 4]}
    t_up = ElasticDPTrainer.from_resume(lm, opt, dataset, rep, seq_len=16)
    t_up.run(2)
    assert bitwise_equal(ref.state, t_up.state)

    rep_same = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                      device="cpu")
    assert not rep_same.topology_changed and rep_same.dp_degree == 2


def test_resume_rejects_indivisible_dp(tiny, dataset, tmp_path):
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=2)
    t.run(1)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t)
    orch.handler.request("test")
    orch.migrate(t.state, t.iters[0])
    with pytest.raises(ValueError, match="not divisible"):
        resume(str(tmp_path / "ck"), expected=state_struct(lm),
               device="cpu", dp_degree=3)


def test_migrate_drains_inflight_async_dumps(tiny, dataset, tmp_path):
    """A preemption arriving while async dumps are in flight must commit
    them (they are the incremental ancestors) before the final image."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=2)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t)
    t.run(1)
    ck.save_async(t.state, step=t.step_count,
                  meta=train_meta(arch=cfg.name, step=t.step_count,
                                  data_state=t.data_state()))
    t.run(1)
    orch.handler.request("test")
    orch.migrate(t.state, t.iters[0])
    imgs = ck.registry.images()
    assert [m["step"] for m in imgs] == [1, 2]
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu")
    assert rep.data["step"] == 2
    assert bitwise_equal(rep.state, t.state)


def test_async_dump_captures_before_the_state_moves_on(tiny, dataset,
                                                       tmp_path):
    """The port's step updates params, m and v in place: an async dump must
    hold a finished copy when dump() returns, so steps taken before the
    job writes do not leak into its image."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=1)
    t.run(1)
    want = {p: a.clone() for p, a in flatten_with_paths(t.state)}
    sess = CheckpointSession(str(tmp_path / "ck"), device="cpu")
    r = sess.dump(DumpRequest(state=t.state, step=1, mode="async"))
    assert r.mode == "async" and not r.committed and r.image_id is None
    t.run(2)                                  # in place, while it writes
    assert not torch.equal(t.state["params"]["embed"]["tok"],
                           want["params/embed/tok"])
    done = sess.wait()
    assert [(d.step, d.committed) for d in done] == [(1, True)]
    assert sess.wait() == []                  # drained per barrier
    got, _ = sess.load(done[0].image_id)
    assert all(torch.equal(a, want[p]) for p, a in flatten_with_paths(got))


def test_resume_digest_mismatch_raises(tiny, dataset, tmp_path):
    """The integrity layer must refuse a restore whose logical bytes do not
    match what the dump recorded (here: a deliberately wrong digest)."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=1)
    t.run(1)
    ck = ckpt(tmp_path / "ck")
    rec = MigrationManifest(step=1, arch=cfg.name, host_count=1, dp_degree=1,
                            data=t.data_state(), state_digest="0" * 64)
    meta = train_meta(arch=cfg.name, step=1, data_state=t.data_state())
    meta["migration"] = rec.to_meta()
    ck.save(t.state, step=1, meta=meta)
    with pytest.raises(CorruptionError, match="state digest"):
        resume(str(tmp_path / "ck"), expected=state_struct(lm), device="cpu")
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", verify_digest=False)
    assert rep.digest_verified is None


def test_resume_adopts_pre_migration_images(tiny, dataset, tmp_path):
    """Images dumped before the migration layer existed (no migration
    record) resume fine: the record is synthesized from topology/meta."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=2)
    t.run(1)
    ck = ckpt(tmp_path / "ck")
    ck.save(t.state, step=1,
            meta=train_meta(arch=cfg.name, step=1, data_state=t.data_state()),
            topology=fleet_topology(2))
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", host_count=1, dp_degree=1)
    assert rep.digest_verified is None      # nothing recorded to verify
    assert rep.migration.host_count == 2    # synthesized from topology
    assert rep.changes["host_count"] == [2, 1]
    t1 = ElasticDPTrainer.from_resume(lm, opt, dataset, rep, seq_len=16)
    assert bitwise_equal(t1.state, t.state)


def test_cursor_remap_replays_identical_global_stream(dataset):
    """Same global batch, different DP partitioning -> same global tokens
    (the data half of elastic restore)."""
    its4 = [DataIterator(dataset, global_batch=8, seq_len=16, dp_rank=r,
                         dp_size=4, step=3) for r in range(4)]
    its2 = [DataIterator(dataset, global_batch=8, seq_len=16, dp_rank=r,
                         dp_size=2, step=3) for r in range(2)]
    g4 = np.concatenate([it.next() for it in its4])
    g2 = np.concatenate([it.next() for it in its2])
    assert np.array_equal(g4, g2)


def test_resume_with_new_global_batch_keeps_token_offset(tiny, dataset,
                                                         tmp_path):
    """Changing the global batch on resume must remap the step-addressed
    cursor so the run continues at the same token offset — not replay or
    skip data — and must refuse offsets that don't align."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=2)
    t.run(2)                                    # 8 sequences consumed
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t)
    orch.handler.request("test")
    orch.migrate(t.state, t.iters[0])

    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", dp_degree=1, global_batch=8)
    assert rep.data["step"] == 1                # 8 consumed / new gb 8
    it = rep.make_iterator(dataset)
    want = np.concatenate([DataIterator(dataset, global_batch=4, seq_len=16,
                                        dp_rank=r, dp_size=2,
                                        step=2).next() for r in range(2)])
    got = it.next()[:4]                         # first half of the gb=8 batch
    assert np.array_equal(got, want)            # same token offset

    with pytest.raises(ValueError, match="token offset"):
        resume(str(tmp_path / "ck"), expected=state_struct(lm),
               device="cpu", dp_degree=1, global_batch=3)


def test_make_iterator_defaults_to_full_global_batch(tiny, dataset,
                                                     tmp_path):
    """A single-process resume must feed the FULL global batch even when
    the new fleet has dp_degree > 1 — dp_rank/dp_size describe the
    data-feeding processes, not the DP degree."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=4, global_batch=8)
    t.run(1)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t)
    orch.handler.request("test")
    orch.migrate(t.state, t.iters[0])
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", host_count=2, dp_degree=2)
    assert rep.make_iterator(dataset).next().shape[0] == 8   # full batch
    assert rep.make_iterator(dataset, dp_rank=1,
                             dp_size=2).next().shape[0] == 4  # explicit slice


def test_migrate_with_lossy_codec_resumes_without_digest(tiny, dataset,
                                                         tmp_path):
    """A lossy codec policy breaks dump-bytes == restore-bytes by design;
    the migration must omit the digest rather than fail every resume."""
    from repro_torch.core.compression import default_policy
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=2)
    t.run(1)
    ck = ckpt(tmp_path / "ck",
              codec_policy=default_policy(lossy_optimizer=True))
    ck.save(t.state, step=1,
            meta=train_meta(arch=cfg.name, step=1,
                            data_state=t.data_state()))   # delta8 parent
    t.run(1)
    orch = orchestrator(ck, t)
    orch.handler.request("test")
    assert orch.migrate(t.state, t.iters[0]) == EXIT_CHECKPOINTED
    assert orch.last_migration.state_digest is None
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu", host_count=1, dp_degree=1)
    assert rep.digest_verified is None          # nothing recorded to verify
    assert rep.data["step"] == 2
    applied = {r["codec"] for r in rep.manifest["leaves"]
               if r["codec_meta"].get("applied")}
    assert applied == {"delta8"}                # the lossy codec did run


def test_straggler_plan_preserves_model_parallel_factor(tiny, tmp_path):
    """planned_dp_degree scales the dumped dp with the surviving devices,
    never folding the model-parallel factor into DP."""
    ck = ckpt(tmp_path / "ck")
    mon = StragglerMonitor(num_hosts=4, warmup_steps=1, threshold=1.5)
    # 4 hosts x 2 devices = 8 devices as dp=4 x mp=2
    topo = {"axes": [["data", 4], ["model", 2]], "dp_degree": 4,
            "device_count": 8, "host_count": 4}
    orch = MigrationOrchestrator(ck, monitor=mon, topology=topo)
    for _ in range(2):
        orch.observe_step([0.1, 0.1, 0.1, 0.9])
    assert orch.planned_host_count == 3
    assert orch.planned_dp_degree == 3          # 6 devices / mp=2

    # an mp factor that cannot divide the surviving devices -> no plan
    ck2 = ckpt(tmp_path / "ck2")
    mon2 = StragglerMonitor(num_hosts=4, warmup_steps=1, threshold=1.5)
    topo2 = {"axes": [["data", 2], ["model", 2]], "dp_degree": 2,
             "device_count": 4, "host_count": 4}
    orch2 = MigrationOrchestrator(ck2, monitor=mon2, topology=topo2)
    for _ in range(2):
        orch2.observe_step([0.1, 0.1, 0.1, 0.9])
    assert orch2.planned_host_count == 3
    assert orch2.planned_dp_degree is None      # 3 devices % mp=2 != 0


def test_resume_image_without_data_pipeline(tiny, tmp_path):
    """Images with no data cursor (serving sessions, bare state dumps)
    still resume: there is nothing to remap, only the step carries."""
    cfg, lm, opt = tiny
    state = init_train_state(lm, torch.Generator().manual_seed(0),
                             device="cpu")
    ck = ckpt(tmp_path / "ck")
    ck.save(state, step=0, meta={"job_kind": "serve", "arch": cfg.name})
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu")
    assert rep.data["global_batch"] is None
    assert bitwise_equal(rep.state, state)


# ------------------------------------------------------- PreemptionHandler
def test_signal_mid_step_defers_dump_to_boundary(tiny, dataset, tmp_path):
    """A signal landing mid-step must only set the flag; the dump happens
    at the next boundary — never from inside the signal handler."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=1)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t).install()
    try:
        t.run(1)
        os.kill(os.getpid(), signal.SIGUSR2)      # "mid-step"
        t.run(1)                                  # step completes untouched
        assert ck.registry.images() == []         # no dump yet
        assert orch.should_migrate()
        assert orch.handler.reason == "SIGUSR2"
        code = orch.migrate(t.state, t.iters[0])  # boundary: now it dumps
    finally:
        orch.uninstall()
    assert code == EXIT_CHECKPOINTED
    imgs = ck.registry.images()
    assert len(imgs) == 1 and imgs[0]["step"] == 2
    _, rec = ck.registry.latest_migration()
    assert rec.reason == "SIGUSR2" and rec.data["step"] == 2


def test_straggler_advice_escalates_to_preemption(tiny, dataset, tmp_path):
    """StragglerMonitor advice becomes an executable path: observe_step
    escalates checkpoint_and_replace into handler.request('straggler') and
    the migration record pre-plans the shrunken fleet, which resume() then
    uses as the default topology."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=4)
    ck = ckpt(tmp_path / "ck")
    mon = StragglerMonitor(num_hosts=4, warmup_steps=2, threshold=1.5)
    orch = orchestrator(ck, t, monitor=mon)
    advice = {"action": "none"}
    for _ in range(4):
        t.run(1)
        advice = orch.observe_step([0.1, 0.1, 0.1, 0.5])  # host 3 is slow
    assert advice["action"] == "checkpoint_and_replace"
    assert advice["hosts"] == [3]
    assert advice["suggested_host_count"] == 3
    assert orch.handler.preempt_requested()
    assert orch.handler.reason == "straggler"
    orch.migrate(t.state, t.iters[0])
    rec = orch.last_migration
    assert rec.planned_host_count == 3 and rec.hosts_dropped == [3]
    # global_batch=4 is not divisible by 3 -> no dp plan recorded, resume
    # keeps the dumped dp degree but restarts on the planned host count
    assert rec.planned_dp_degree is None
    rep = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                 device="cpu")
    assert rep.host_count == 3 and rep.dp_degree == 4
    assert rep.changes["host_count"] == [4, 3]

    # a divisible fleet records the dp plan too
    t2 = trainer(tiny, dataset, hosts=4)
    ck2 = ckpt(tmp_path / "ck2")
    mon2 = StragglerMonitor(num_hosts=4, warmup_steps=2, threshold=1.5)
    orch2 = orchestrator(ck2, t2, monitor=mon2)
    for _ in range(4):
        t2.run(1)
        orch2.observe_step([0.1, 0.1, 0.5, 0.5])  # two slow hosts
    orch2.migrate(t2.state, t2.iters[0])
    assert orch2.last_migration.planned_host_count == 2
    assert orch2.last_migration.planned_dp_degree == 2
    rep2 = resume(str(tmp_path / "ck2"), expected=state_struct(lm),
                  device="cpu")
    assert rep2.host_count == 2 and rep2.dp_degree == 2
    t3 = ElasticDPTrainer.from_resume(lm, opt, dataset, rep2, seq_len=16)
    assert t3.hosts == 2


def test_escalation_fires_once(tmp_path):
    ck = ckpt(tmp_path / "ck")
    mon = StragglerMonitor(num_hosts=2, warmup_steps=1, threshold=1.2)
    orch = MigrationOrchestrator(ck, monitor=mon, topology=fleet_topology(2))
    for _ in range(3):
        orch.observe_step([0.1, 1.0])
    assert orch.handler.trigger_count == 1      # no re-request spam


def test_uninstall_restores_original_dispositions():
    seen = []

    def custom(signum, frame):
        seen.append(signum)

    old_usr2 = signal.signal(signal.SIGUSR2, custom)
    try:
        h = PreemptionHandler(signals=(signal.SIGUSR2,)).install()
        assert signal.getsignal(signal.SIGUSR2) == h._on_signal
        os.kill(os.getpid(), signal.SIGUSR2)
        assert h.preempt_requested() and seen == []
        h.uninstall()
        assert signal.getsignal(signal.SIGUSR2) is custom
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.01)
        assert seen == [signal.SIGUSR2]         # original handler back live
        assert h.trigger_count == 1
    finally:
        signal.signal(signal.SIGUSR2, old_usr2)


def test_handler_clear_and_first_reason_wins():
    h = PreemptionHandler(signals=())
    h.request("straggler")
    h.request("manual")
    assert h.reason == "straggler" and h.trigger_count == 2
    assert h.requested_at is not None
    h.clear()
    assert not h.preempt_requested() and h.reason is None
    h.request("manual")
    assert h.reason == "manual"


# ----------------------------------------------------------- record format
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
    back = MigrationManifest.from_meta(meta)
    assert back == rec
    # unknown fields from future versions are ignored, not fatal
    meta["future_field"] = True
    assert MigrationManifest.from_meta(meta) == rec


def test_tree_digest_is_topology_free_and_sensitive():
    a = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
         "step": np.int32(3)}
    pairs = [("w", a["w"]), ("step", a["step"])]
    d1 = tree_digest(dict(pairs))
    d2 = tree_digest(reversed(pairs))           # order-insensitive input
    assert d1 == d2
    b = {"w": a["w"].copy(), "step": np.int32(3)}
    b["w"][0, 0] += 1e-7
    assert tree_digest(b) != d1                 # value-sensitive
    c = {"w": a["w"].astype(np.float64), "step": np.int32(3)}
    assert tree_digest(c) != d1                 # dtype-sensitive


def test_rng_record_is_framework_tagged_and_foreign_reseeds(tmp_path):
    """A torch.Generator's state travels under a framework tag and comes
    back exactly; the JAX package's raw key words are reported foreign and
    the generator re-seeded; no rng leaves the record's field None."""
    from repro_torch.core import generator_from_record, rng_record
    gen = torch.Generator().manual_seed(123)
    torch.rand(5, generator=gen)                # advance it
    rec = rng_record(gen)
    assert rec["framework"] == "torch" and rec["device"] == "cpu"
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    want = torch.rand(8, generator=twin)
    state = {"w": torch.zeros(4), "step": torch.tensor(1, dtype=torch.int32)}
    sess = CheckpointSession(str(tmp_path / "ck"), device="cpu")
    sess.migrate(MigrateRequest(state=state, rng=gen, reason="test"))
    res = sess.restore(RestoreRequest())
    back, how = res.report.generator(seed=7)
    assert how == "restored"
    assert torch.equal(torch.rand(8, generator=back), want)
    # the JAX package reads the record (it does not reproduce the state)
    from repro.core.migration import MigrationManifest as JRecord
    assert JRecord.from_image(res.manifest).rng == rec

    key_words = [int(w) for w in np.asarray(jax.random.PRNGKey(3))]
    g, how = generator_from_record(key_words, seed=7)
    assert how == "foreign"
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(7)))
    assert generator_from_record(None, seed=7)[1] == "seeded"
    assert rng_record(jax.random.PRNGKey(3)) == key_words
    assert rng_record(None) is None


# --------------------------------------------- session: lifecycle surface
def test_session_installs_signals_and_migrates_on_them(tmp_path):
    cfg = SessionConfig(root=str(tmp_path / "ck"),
                        preemption=PreemptionPolicy(
                            install_signals=True, signals=(signal.SIGUSR2,)))
    before = signal.getsignal(signal.SIGUSR2)
    state = {"w": torch.arange(8.0), "step": torch.tensor(3,
                                                         dtype=torch.int32)}
    with CheckpointSession(cfg, device="cpu") as sess:
        assert signal.getsignal(signal.SIGUSR2) == sess.handler._on_signal
        assert not sess.should_migrate()
        os.kill(os.getpid(), signal.SIGUSR2)
        assert sess.should_migrate() and not sess.should_predump()
        ticket = sess.migrate(MigrateRequest(state=state))
    assert signal.getsignal(signal.SIGUSR2) == before
    assert ticket.exit_code == EXIT_CHECKPOINTED == 85
    assert ticket.step == 3 and ticket.reason == "SIGUSR2"
    assert ticket.record.state_digest == tree_digest(
        flatten_with_paths(state))
    res = CheckpointSession(str(tmp_path / "ck"),
                            device="cpu").restore(RestoreRequest())
    assert res.digest_verified is True and res.image_id == ticket.image_id


def test_migrate_hands_the_live_tensors_to_the_dump(tmp_path):
    """migrate gives save() the caller's tensors (so K5 classifies them
    where they lie after pre-dump rounds) and takes the host copy only for
    the digest, only under a lossless policy; pre_dump_round reads the
    step off the tree."""
    state = {"w": torch.randn(64, generator=torch.Generator().manual_seed(1)),
             "step": torch.tensor(5, dtype=torch.int32)}
    for policy in (None, lambda p: "bf16" if p == "w" else "none"):
        sess = CheckpointSession(SessionConfig(
            root=str(tmp_path / f"ck{policy is None}"),
            codec=CodecPolicy(custom=policy)), device="cpu")
        seen = []
        save = sess.save
        sess.save = lambda tree, **kw: seen.append(tree) or save(tree, **kw)
        out = sess.pre_dump_round(state)
        assert out["image_id"] == "step_0000000005p00"
        ticket = sess.migrate(MigrateRequest(state=state))
        assert len(seen) == 1 and seen[0] is state
        assert ticket.step == 5
        assert (ticket.record.state_digest is None) == (policy is not None)


def test_orchestrated_predump_rounds_then_migrate(tmp_path):
    """The twin of tests/test_predump_lazy.py's orchestrated case: the
    session's pre-copy budget, then the migration, whose residual dump
    reuses what the rounds wrote."""
    sess = CheckpointSession(SessionConfig(
        root=str(tmp_path / "ck"),
        migration=MigrationPolicy(arch="t", predump_rounds=2,
                                  topology={"host_count": 1,
                                            "dp_degree": 1, "axes": []})),
        device="cpu")
    rng = np.random.RandomState(0)
    t = {"params": {"w": torch.from_numpy(rng.randn(512).astype(np.float32)),
                    "frozen": torch.ones(256)},
         "step": torch.tensor(1, dtype=torch.int32)}
    assert not sess.should_predump()           # no preemption yet
    sess.handler.request("test")
    assert sess.should_predump()
    r0 = sess.pre_dump_round(t, step=1)
    assert r0["stats"]["leaves_clean"] == 0
    t2 = {"params": {"w": t["params"]["w"] + 1.0,
                     "frozen": t["params"]["frozen"]},
          "step": torch.tensor(2, dtype=torch.int32)}
    assert sess.should_predump()
    r1 = sess.pre_dump_round(t2, step=2)
    assert r1["stats"]["leaves_clean"] == 1    # frozen
    assert not sess.should_predump()           # budget spent
    assert sess.should_migrate()
    ticket = sess.migrate(MigrateRequest(state=t2, step=2))
    assert ticket.exit_code == 85
    orch = sess._orchestrator()
    assert orch.predump_rounds_run == 0        # reset for a later cycle
    recs = read_manifest(sess.tier, ticket.image_id)["leaves"]
    r1_recs = {r["path"]: r for r in r1["records"]}
    assert all(r["chunks"] == r1_recs[r["path"]]["chunks"] for r in recs)
    got = sess.restore(RestoreRequest())
    assert got.digest_verified is True
    assert bitwise_equal(got.state, t2)


def test_async_facade_warns_and_checks_the_device(tmp_path):
    from repro_torch.core import AsyncCheckpointer
    with pytest.warns(DeprecationWarning, match="AsyncCheckpointer"):
        ac = AsyncCheckpointer(str(tmp_path / "ck"), device="cpu")
    state = {"w": torch.ones(16)}
    ac.dump_async(state, step=1)
    state["w"].add_(1.0)
    (out,) = ac.wait()
    got, _ = ckpt(tmp_path / "ck").load(out["image_id"])
    assert torch.equal(got["w"], torch.ones(16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            AsyncCheckpointer(str(tmp_path / "ck2"))


def test_fleet_policy_maps_exit_85_to_immediate_restart(tmp_path):
    pol = FleetPolicy(monitor=StragglerMonitor(num_hosts=1),
                      restart=RestartPolicy(max_retries=1))
    assert pol.on_exit(EXIT_CHECKPOINTED, step=3) == {
        "action": "restart", "backoff_s": 0.0, "reason": "checkpointed"}
    assert pol.on_exit(0, step=3) == {"action": "done"}
    assert pol.on_exit(1, step=3)["action"] == "restart"
    assert pol.on_exit(1, step=4)["action"] == "abort"
    sess = CheckpointSession(str(tmp_path / "ck"), device="cpu")
    assert pol.on_step(sess, [0.1]) == {"action": "none", "hosts": []}


# ------------------------------------------------- parity with the package
def test_data_stream_matches_the_jax_pipeline(tmp_path):
    """The copied pipeline writes the same shards and yields the same
    batches, prefetched or not, for any DP layout and after a restore."""
    from repro.data import DataIterator as JIter
    from repro.data import TokenDataset as JData
    kw = dict(vocab_size=512, seed=3, num_shards=3, tokens_per_shard=1000)
    tds = TokenDataset(str(tmp_path / "t"), **kw)
    jds = JData(str(tmp_path / "j"), **kw)
    for i in range(3):
        name = f"shard_{i:05d}.tokens.npy"
        assert np.array_equal(np.load(tmp_path / "t" / name),
                              np.load(tmp_path / "j" / name))
    for dp in (1, 2):
        t = [DataIterator(tds, global_batch=4, seq_len=33, dp_rank=r,
                          dp_size=dp, step=5) for r in range(dp)]
        j = [JIter(jds, global_batch=4, seq_len=33, dp_rank=r, dp_size=dp,
                   step=5) for r in range(dp)]
        t[0].start_prefetch()
        for _ in range(12):                     # wraps the 3000-token corpus
            for a, b in zip(t, j):
                got = a.next_prefetched() if a is t[0] else a.next()
                assert np.array_equal(got, b.next())
        t[0].stop_prefetch()
        assert t[0].state() == j[0].state()
        back = DataIterator.restore(tds, j[0].state())
        assert np.array_equal(back.next(), JIter.restore(
            jds, j[0].state()).next())


@pytest.fixture(scope="module")
def shared():
    """The JAX package's tiny train state and its weights on the port."""
    from repro.configs import get_tiny
    from repro.models.model import LM as JLM
    from repro.training.train_loop import init_train_state as jinit
    from repro_torch.models.params import from_jax
    jlm = JLM(get_tiny("qwen3-8b"))
    jstate = jinit(jlm, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jstate)
    tlm = LM(configs.get_tiny("qwen3-8b"))

    def port_state():
        return {"params": from_jax(host["params"], "cpu"),
                "opt": from_jax(host["opt"], "cpu"),
                "step": torch.zeros((), dtype=torch.int32)}
    return jlm, jstate, host, tlm, port_state


def _step_errors(tstate, jstate, before):
    from repro.core.dump import flatten_with_paths as jflatten
    want = dict(jflatten(jax.tree.map(np.asarray, jstate)))
    got = {p: t.numpy() for p, t in flatten_with_paths(tstate)}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return {p: (rel(got[p] - before[p], want[p] - before[p])
                if p.startswith("params/") else rel(got[p], want[p]))
            for p in want if p != "step"}


FAST = dict(lr=1e-2, warmup_steps=0)


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def test_per_example_step_fns_match_jax(shared):
    """grad_fn per example, grads summed in order, then apply: the losses
    and the updated state agree with the JAX package's pair."""
    from repro.core.dump import flatten_with_paths as jflatten
    from repro.optim import OptConfig as JOpt
    from repro.training.train_loop import make_per_example_step_fns as jpe
    from repro_torch.training import make_per_example_step_fns
    jlm, jstate, host, tlm, port_state = shared
    toks = _toks(0, (2, 33))
    jg, ja = jpe(jlm, JOpt(**FAST))
    tg, ta = make_per_example_step_fns(tlm, OptConfig(**FAST))
    st = port_state()
    jsum = tsum = None
    jl = tl = 0.0
    for i in range(2):
        lj, gj = jg(jstate["params"], jnp.asarray(toks[i]))
        lt, gt = tg(st["params"], torch.from_numpy(toks[i]).long())
        assert abs(float(lj) - float(lt)) < LOSS_ABS
        jl, tl = jl + lj, tl + lt
        jsum = gj if jsum is None else jax.tree.map(jnp.add, jsum, gj)
        if tsum is None:
            tsum = gt
        else:
            for a, b in zip(flatten_with_paths(tsum), flatten_with_paths(gt)):
                a[1].add_(b[1])
    js, jm = ja(jstate, jsum, jl, jnp.float32(2))
    ts, tm = ta(st, tsum, tl, torch.tensor(2.0))
    assert ts["params"] is st["params"]        # updated in place
    assert abs(float(jm["loss"]) - float(tm["loss"])) < LOSS_ABS
    assert float(jm["lr"]) == float(tm["lr"])
    assert int(ts["step"]) == 1 and ts["step"].dtype == torch.int32
    errs = _step_errors(ts, js, dict(jflatten(host)))
    assert max(errs.values()) < STEP_REL, max(errs.items(),
                                              key=lambda e: e[1])


def test_microbatched_step_matches_jax(shared):
    """microbatches=2 accumulates over batch halves like the JAX scan: the
    reported loss is the last microbatch's (in both), the state agrees
    with the JAX step within STEP_REL, and the grads agree with the
    unsplit step's."""
    from repro.core.dump import flatten_with_paths as jflatten
    from repro.optim import OptConfig as JOpt
    from repro.training.train_loop import make_train_step as jmake
    jlm, jstate, host, tlm, port_state = shared
    toks = _toks(1, (4, 33))
    js, jm = jax.jit(jmake(jlm, JOpt(**FAST), microbatches=2))(
        jstate, {"tokens": jnp.asarray(toks)})
    st = port_state()
    last, _ = tlm.loss(st["params"], {"tokens": torch.from_numpy(
        toks[2:]).long()})
    ts, tm = make_train_step(tlm, OptConfig(**FAST), microbatches=2)(
        st, {"tokens": torch.from_numpy(toks).long()})
    assert abs(float(jm["loss"]) - float(tm["loss"])) < LOSS_ABS
    assert float(tm["loss"]) == pytest.approx(float(last), rel=1e-6)
    assert float(jm["lr"]) == float(tm["lr"])
    errs = _step_errors(ts, js, dict(jflatten(host)))
    assert max(errs.values()) < STEP_REL, max(errs.items(),
                                              key=lambda e: e[1])
    # the same batch unsplit: the same grad norm up to summation order
    _, tm1 = make_train_step(tlm, OptConfig(**FAST))(
        port_state(), {"tokens": torch.from_numpy(toks).long()})
    assert float(tm["grad_norm"]) == pytest.approx(float(tm1["grad_norm"]),
                                                   rel=1e-2)


def _np_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(2048).astype(np.float32),
                       "b": rng.randn(64).astype(np.float32)},
            "opt": {"m": {"w": rng.randn(2048).astype(np.float32)}},
            "step": np.int32(4)}


def test_migration_images_match_and_cross_read(tmp_path):
    """The same state migrated by both packages: the manifests differ only
    in env, created_at and digest (rng None keeps the record key for key
    the JAX package's), and each package resumes the other's image with
    its digest verified."""
    import repro.core as jcore
    from repro.optim import OptConfig as JOpt
    st = _np_state()
    topo = {"axes": [], "dp_degree": 1, "device_count": 1, "host_count": 1}
    data = {"step": 4, "global_batch": 8}
    to_t = lambda t: {k: to_t(v) for k, v in t.items()} if isinstance(
        t, dict) else torch.from_numpy(np.array(t))
    with pytest.warns(DeprecationWarning):
        jck = jcore.Checkpointer(str(tmp_path / "jax"))
    jorch = jcore.MigrationOrchestrator(jck, arch="a", topology=topo)
    jorch.handler.request("SIGTERM")
    jorch.migrate(jax.tree.map(jnp.asarray, st), data_state=data,
                  opt_cfg=JOpt())
    torch_ck = ckpt(tmp_path / "torch")
    torch_orch = MigrationOrchestrator(torch_ck, arch="a", topology=topo)
    torch_orch.handler.request("SIGTERM")
    torch_orch.migrate(to_t(st), data_state=data, opt_cfg=OptConfig())
    from repro.core.restore import read_manifest as jread
    jm = jread(jck.tier, "step_0000000004")
    tm = read_manifest(torch_ck.tier, "step_0000000004")
    skip = ("env", "created_at", "digest")
    assert {k: v for k, v in jm.items() if k not in skip} == \
        {k: v for k, v in tm.items() if k not in skip}
    assert tm["meta"]["migration"]["rng"] is None

    rep = resume(str(tmp_path / "jax"), device="cpu")
    assert rep.digest_verified is True and rep.migration.reason == "SIGTERM"
    assert bitwise_equal(rep.state, to_t(st))
    jrep = jcore.resume(str(tmp_path / "torch"))
    assert jrep.digest_verified is True and jrep.data["step"] == 4
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree.leaves(jrep.state), jax.tree.leaves(st)))


def test_resumed_leaves_are_owned_and_contiguous(tiny, dataset, tmp_path):
    """The restored state feeds an in-place optimizer: no two leaves share
    storage, each is contiguous, the step an int32 0-d tensor — eagerly
    and after a lazy materialize."""
    cfg, lm, opt = tiny
    t = trainer(tiny, dataset, hosts=1)
    t.run(1)
    ck = ckpt(tmp_path / "ck")
    orch = orchestrator(ck, t)
    orch.handler.request("test")
    orch.migrate(t.state, t.iters[0])
    eager = resume(str(tmp_path / "ck"), expected=state_struct(lm),
                   device="cpu").state
    lazy = resume(str(tmp_path / "ck"), device="cpu",
                  lazy=True).state.materialize()
    for state in (eager, lazy):
        leaves = [a for _, a in flatten_with_paths(state)]
        assert all(a.is_contiguous() for a in leaves)
        ptrs = [a.untyped_storage().data_ptr() for a in leaves if a.numel()]
        assert len(set(ptrs)) == len(ptrs)
        assert state["step"].shape == () and \
            state["step"].dtype == torch.int32
        assert bitwise_equal(state, t.state)


# ------------------------------------------------------- exit-85 contract
STEPS = 8


def _cli(pkg, tmp_path, *extra):
    mod = "repro.launch.train" if pkg == "jax" else "repro_torch.launch.train"
    args = [sys.executable, "-m", mod, "--steps", str(STEPS),
            "--global-batch", "4", "--seq-len", "32", "--log-every", "1",
            "--data-dir", str(tmp_path / "data"), *extra]
    return args + (["--device", "cpu"] if pkg == "torch" else [])


def _preempt(args, env):
    """Run the launcher, SIGTERM it after its first step line; -> stdout."""
    p = subprocess.Popen(args, env=env, stdout=subprocess.PIPE, text=True)
    saw_step = False
    head = []
    deadline = time.time() + 120
    for line in p.stdout:
        head.append(line)
        if '"step"' in line:
            saw_step = True
            break
        if time.time() > deadline:
            break
    assert saw_step, "launcher never reached a training step"
    p.send_signal(signal.SIGTERM)
    out = "".join(head) + p.stdout.read()
    p.wait(timeout=120)
    assert p.returncode == EXIT_CHECKPOINTED, out
    assert "preemption (SIGTERM)" in out and "migration image durable" in out
    return out


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in json.load(f)}


@pytest.mark.slow
def test_launcher_sigterm_exits_85_and_resumes(tmp_path):
    """End-to-end on the port's launcher: SIGTERM mid-run -> a pre-dump round,
    the migration image and exit 85; --resume continues in a fresh process
    with the digest verified and the losses of an uninterrupted run,
    within 1e-5 relative (the chip path's rule); --lazy-resume too."""
    env = subprocess_env()
    TokenDataset(str(tmp_path / "data"), vocab_size=512, seed=0)
    ref = subprocess.Popen(_cli("torch", tmp_path, "--metrics-file",
                                str(tmp_path / "ref.json")), env=env,
                           stdout=subprocess.DEVNULL)
    ck = ["--ckpt-dir", str(tmp_path / "ck")]
    out = _preempt(_cli("torch", tmp_path, *ck, "--predump-rounds", "1",
                        "--step-delay", "0.2"), env)
    assert "[train] ckpt plan: 43 leaves" in out
    assert out.index("pre-dump round -> step_") < out.index("preemption")
    for extra, name in ((), "res"), (("--lazy-resume",), "lazy"):
        r = subprocess.run(_cli("torch", tmp_path, *ck, "--resume", *extra,
                                "--metrics-file", str(tmp_path / name)),
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "resumed from" in r.stdout and "migrated: SIGTERM" in r.stdout
        if extra:
            assert "lazy resume: skeleton of 43 leaves" in r.stdout
            assert "digest verified" in r.stdout
    assert ref.wait(timeout=300) == 0
    want = _losses(tmp_path / "ref.json")
    for name in ("res", "lazy"):
        got = _losses(tmp_path / name)
        assert got and max(got) == STEPS
        assert all(abs(got[s] - want[s]) <= 1e-5 * abs(want[s])
                   for s in got), (got, want)


@pytest.mark.slow
@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_cross_framework_migration(tmp_path, first, then):
    """One package's launcher is SIGTERMed to exit 85; the other's --resume
    continues the image. Its losses match the uninterrupted run of the
    first package within the bf16 loss tolerance: the same weights (from
    the image), the same token stream (the copied pipeline), the same LR
    schedule."""
    env = subprocess_env()
    TokenDataset(str(tmp_path / "data"), vocab_size=512, seed=0)
    ref = subprocess.Popen(_cli(first, tmp_path, "--metrics-file",
                                str(tmp_path / "ref.json")), env=env,
                           stdout=subprocess.DEVNULL)
    ck = ["--ckpt-dir", str(tmp_path / "ck")]
    _preempt(_cli(first, tmp_path, *ck, "--step-delay", "0.2"), env)
    r = subprocess.run(_cli(then, tmp_path, *ck, "--resume",
                            "--metrics-file", str(tmp_path / "res.json")),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumed from" in r.stdout and "migrated: SIGTERM" in r.stdout
    assert ref.wait(timeout=300) == 0
    want, got = _losses(tmp_path / "ref.json"), _losses(tmp_path / "res.json")
    assert got and max(got) == STEPS and min(got) > 1
    assert all(abs(got[s] - want[s]) < LOSS_ABS for s in got), (got, want)


def test_launcher_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--steps", "1", "--data-dir", str(tmp_path / "d")])
