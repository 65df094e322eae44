"""End-to-end training launcher with the CRIU-style lifecycle — the JAX
package's launch/train.py on the port, with the same flags and the same
``[train]`` lines, plus ``--device``:

  * deterministic restartable data pipeline (the same token stream as the
    JAX launcher from the same ``--data-dir`` and ``--seed``),
  * periodic (optionally async) incremental checkpoints,
  * SIGTERM-driven preemption -> ``--predump-rounds`` pre-copy rounds ->
    migration dump -> exit 85 (HTCondor's "checkpointed, reschedule me"),
  * ``--resume`` restores the latest image (eagerly, or lazily with
    ``--lazy-resume``) — an image either package wrote,
  * straggler monitor wired for fleet use.

Everything checkpoint-shaped goes through ONE door: a
repro_torch.api.CheckpointSession opened from a typed SessionConfig.

``--tiny`` (the default) runs the reduced config of the same family;
``--full`` the published one. ``--device`` is cuda by default and raises
without a card; ``--device cpu`` runs the plain torch path. Example:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 50 --global-batch 8 --seq-len 128 --ckpt-dir /tmp/ck \\
      --ckpt-every 20 [--resume]

Initial weights come from a torch.Generator seeded with ``--seed``; they
differ from the JAX launcher's (another generator), but a resumed run takes
its weights from the image, whichever package wrote it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.api import (CheckpointSession, DumpRequest, MigrateRequest,
                             MigrationPolicy, PreemptionPolicy,
                             RestoreRequest, SessionConfig)
from repro_torch.core import EXIT_CHECKPOINTED, PreemptionHandler, train_meta
from repro_torch.data import DataIterator, TokenDataset
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.models.params import tree_map
from repro_torch.optim import OptConfig
from repro_torch.training.fault_tolerance import StragglerMonitor
from repro_torch.training.train_loop import (abstract_train_state,
                                             init_train_state,
                                             make_train_step)


def build_cfg(args):
    cfg = (configs.get_tiny(args.arch) if args.tiny
           else configs.get_config(args.arch))
    over = {}
    for f, k in (("layers", "num_layers"), ("d_model", "d_model"),
                 ("d_ff", "d_ff"), ("vocab", "vocab_size")):
        v = getattr(args, f)
        if v:
            over[k] = v
    if over:
        cfg = cfg.replace(**over)
    return cfg


def build_session_config(args, cfg, monitor) -> SessionConfig:
    """The one typed description of this run's checkpoint behavior."""
    executor = None
    if args.ckpt_io_workers and not args.ckpt_serial:
        from repro_torch.core import CheckpointExecutor
        executor = CheckpointExecutor(io_workers=args.ckpt_io_workers)
    return SessionConfig(
        root=args.ckpt_dir, serial=args.ckpt_serial, executor=executor,
        preemption=PreemptionPolicy(install_signals=True),
        migration=MigrationPolicy(
            arch=cfg.name, monitor=monitor,
            predump_rounds=args.predump_rounds,
            topology={"axes": [], "dp_degree": 1, "device_count": 1,
                      "host_count": 1}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=configs.ARCH_NAMES)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_data"))
    ap.add_argument("--ckpt-dir", default="",
                    help="tier URI or path (file:///..., mem://name, or a "
                         "plain directory)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--ckpt-serial", action="store_true",
                    help="single-threaded dump engine (debug/baseline; "
                         "default is the pipelined plan/execute engine)")
    ap.add_argument("--ckpt-io-workers", type=int, default=0,
                    help="chunk-I/O threads for the pipelined engine "
                         "(0 = engine default)")
    ap.add_argument("--predump-rounds", type=int, default=0,
                    help="iterative pre-copy rounds between a preemption "
                         "signal and the final migration dump: each round "
                         "streams a restorable image while training "
                         "continues, so the final freeze writes only the "
                         "residual dirty set (0 = dump immediately)")
    ap.add_argument("--lazy-resume", action="store_true",
                    help="post-copy resume: print the image skeleton and "
                         "stream leaves in the plan's prefetch order, "
                         "then materialize for training (demonstrates "
                         "RestoreRequest(lazy=True))")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-file", default="")
    ap.add_argument("--final-ckpt", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--step-delay", type=float, default=0.0,
                    help="artificial per-step delay (fault-injection tests)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    lm = LM(cfg)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(lm, opt_cfg, microbatches=args.microbatches)

    ds = TokenDataset(args.data_dir, vocab_size=cfg.vocab_size,
                      seed=args.seed)
    monitor = StragglerMonitor(num_hosts=1)
    sess = None
    if args.ckpt_dir:
        sess = CheckpointSession(build_session_config(args, cfg, monitor),
                                 device=dev)
        plan = sess.plan(abstract_train_state(lm))
        print(f"[train] ckpt plan: {plan.num_leaves} leaves, "
              f"{plan.total_bytes / 1e6:.1f} MB/image, "
              f"chunk {plan.chunk_bytes >> 20} MiB, "
              f"engine={'serial' if args.ckpt_serial else 'pipelined'}")
        sess.__enter__()                       # install signal handlers
        preempt = sess.handler
    else:
        preempt = PreemptionHandler().install()

    state = None
    start_step = 0
    if args.resume and sess and sess.registry.latest():
        struct = abstract_train_state(lm)
        if args.lazy_resume:
            # post-copy: skeleton now, leaves stream behind first access;
            # training needs the whole tree, so materialize before the
            # first step (a serving job would start on params alone)
            res = sess.restore(RestoreRequest(lazy=True, host_count=1,
                                              dp_degree=1))
            srv = res.state.server
            print(f"[train] lazy resume: skeleton of "
                  f"{len(srv.paths())} leaves ready, "
                  f"{srv.remaining} still streaming")
            # materialize() runs the deferred whole-tree digest check
            # itself (CorruptionError on mismatch) when the migration
            # record carries one
            tree = res.state.materialize()
            state = tree_map(lambda p, want: _leaf(tree, p).to(want.dtype),
                             struct)
            print(f"[train] lazy resume materialized: "
                  f"{srv.stats['prefetched']} leaves prefetched, "
                  f"{srv.stats['faults']} faulted, digest "
                  f"{'verified' if srv.expected_digest else 'n/a'}")
        else:
            res = sess.restore(RestoreRequest(target_struct=struct,
                                              host_count=1, dp_degree=1))
            state = res.state
        # every leaf is its own contiguous tensor on ``dev`` (restore places
        # each from its own buffer): the in-place optimizer may update it
        start_step = res.data["step"]
        it = res.make_iterator(ds)
        note = (f" (migrated: {res.migration.reason}, topology change "
                f"{res.changes})" if res.topology_changed
                else (f" (migrated: {res.migration.reason})"
                      if res.migration.reason else ""))
        print(f"[train] resumed from {res.image_id} at step "
              f"{start_step}{note}")
    else:
        state = init_train_state(lm, torch.Generator().manual_seed(args.seed),
                                 device=dev)
        it = DataIterator(ds, global_batch=args.global_batch,
                          seq_len=args.seq_len)
    it.start_prefetch()

    def save(kind: str):
        if not sess:
            return
        step = int(state["step"].item())
        meta = train_meta(arch=cfg.name, step=step, data_state=it.state(),
                          opt_cfg=opt_cfg)
        mode = "async" if args.ckpt_async and kind == "periodic" else "sync"
        if mode == "sync":
            sess.wait()
        sess.dump(DumpRequest(state=state, step=step, meta=meta, mode=mode))

    metrics_log = []
    exit_code = 0
    m = {"loss": float("nan")}
    try:
        for s in range(start_step, args.steps):
            if preempt.preempt_requested():
                if sess and sess.should_predump() and s < args.steps - 1:
                    # pre-copy window: stream a restorable image now and
                    # keep training — the final migrate() below freezes
                    # only for what these steps dirty
                    out = sess.pre_dump_round(state)
                    print(f"[train] pre-dump round -> {out['image_id']} "
                          f"({out['stats']['leaves_dirty']} dirty / "
                          f"{out['stats']['leaves_clean']} clean leaves)")
                else:
                    print(f"[train] preemption ({preempt.reason}) at step "
                          f"{s}; checkpointing and exiting "
                          f"{EXIT_CHECKPOINTED}")
                    if sess:
                        ticket = sess.migrate(MigrateRequest(
                            state=state, iterator=it, opt_cfg=opt_cfg))
                        exit_code = ticket.exit_code
                        print(f"[train] migration image durable in "
                              f"{ticket.latency_s:.3f}s")
                    else:
                        it.stop_prefetch()
                        exit_code = EXIT_CHECKPOINTED
                    break
            t0 = time.time()
            batch = {"tokens": torch.from_numpy(it.next_prefetched()).to(
                dev, torch.int64)}
            state, m = step_fn(state, batch)
            loss = float(m["loss"])            # waits for the step
            if args.step_delay:
                time.sleep(args.step_delay)
            dt = time.time() - t0
            if sess:
                sess.observe_step([dt])   # straggler advice -> escalation
            else:
                monitor.observe([dt])
            if (s + 1) % args.log_every == 0 or s == start_step:
                rec = {"step": int(state["step"].item()), "loss": loss,
                       "grad_norm": float(m["grad_norm"]),
                       "lr": float(m["lr"]), "sec_per_step": round(dt, 4)}
                metrics_log.append(rec)
                print(f"[train] {json.dumps(rec)}")
            if args.ckpt_every and (s + 1) % args.ckpt_every == 0:
                save("periodic")
        else:
            if sess and (args.final_ckpt or args.ckpt_every) \
                    and start_step < args.steps:
                save("final")
                sess.wait()
    finally:
        it.stop_prefetch()
        if sess:
            # mirror CheckpointSession.__exit__: only drain async dumps on
            # a clean exit — after a crash/Ctrl-C the original exception
            # must surface, not a pending dump's error or a slow drain
            sess.close(drain=sys.exc_info()[0] is None)
        else:
            preempt.uninstall()
        if args.metrics_file:
            with open(args.metrics_file, "w") as f:
                json.dump(metrics_log, f, indent=1)
    if exit_code:
        sys.exit(exit_code)
    print(f"[train] done at step {int(state['step'].item())}, "
          f"final loss {float(m['loss']):.4f}")


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


if __name__ == "__main__":
    main()
