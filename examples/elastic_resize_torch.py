"""Elastic resize drill through the PyTorch port: dump a training job
placed on one mesh and continue it on another (the paper's unsolved
'parallel application' row).

The port places a tree on one device: each mesh here is a record of axis
names over one device repeated in every position (launch/mesh.py
make_test_mesh), with the sharding rules and topology record of a JAX mesh
of the same shape. The invariants, each at the strength the port can give:

  1. the image is topology-free: restoring the mesh-A (4 data, 2 model)
     dump onto mesh B (2, 4) and mesh C (8, 1) yields the BIT-IDENTICAL
     logical state, the integrity tree digest verified, the topology
     change (dp_degree) reported;
  2. the continuation on mesh B is deterministic: restore + 4 steps,
     twice, agree bitwise;
  3. in place of the JAX example's "continuation on B equals the
     never-resharded run to rounding" (XLA re-associates reductions per
     shard size there): every mesh record runs the same one-device
     program, so there is no per-shard re-association, and the
     continuation on B equals the uninterrupted 8-step run on A BITWISE;
  4. the deterministic elastic-DP harness (per-example programs +
     global-order aggregation): a 4-host run preempted at step 3 and
     migrated to 2 hosts equals the unpreempted 4-host run, bitwise.

``--device`` is the mesh's one device: "cuda" by default (it raises
without a card), "cpu" when asked. On a card the script turns on torch's
deterministic algorithms (the embedding backward sums with atomics
otherwise), so every invariant holds bit for bit there too.

Run:  PYTHONPATH=src python examples/elastic_resize_torch.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "src")))
# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)         # no card: raises, never the CPU
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)

    from repro_torch import configs
    from repro_torch.api import (CheckpointSession, MigrateRequest,
                                 MigrationPolicy, RestoreRequest,
                                 SessionConfig)
    from repro_torch.core import flatten_with_paths
    from repro_torch.data import DataIterator, TokenDataset
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import (abstract_train_state, init_train_state,
                                      make_train_step, train_state_pspecs)
    from repro_torch.training.elastic_dp import ElasticDPTrainer

    cfg = configs.get_tiny("qwen3-8b")
    lm = LM(cfg)
    tmp = tempfile.mkdtemp()
    ds = TokenDataset(f"{tmp}/d", vocab_size=cfg.vocab_size, seed=0)
    opt = OptConfig(warmup_steps=2, total_steps=100)
    step = make_train_step(lm, opt)
    struct = abstract_train_state(lm)

    def mesh_of(shape):
        mesh = make_test_mesh(shape, ("data", "model"), device=dev)
        return mesh, shd.named(mesh, train_state_pspecs(
            lm, shd.make_rules(cfg, mesh)))

    def run(state, it, n):
        for _ in range(n):
            toks = torch.from_numpy(it.next()).to(dev, torch.int64)
            state, m = step(state, {"tokens": toks})
        return state, m

    def bitwise(a, b):
        la, lb = flatten_with_paths(a), flatten_with_paths(b)
        return [p for p, _ in la] == [p for p, _ in lb] and all(
            x.dtype == y.dtype and torch.equal(x, y)
            for (_, x), (_, y) in zip(la, lb))

    def fresh():
        return init_train_state(lm, torch.Generator().manual_seed(0),
                                device=dev)

    # ---- reference: 8 uninterrupted steps on mesh A (4 data, 2 model)
    mesh_a, _ = mesh_of((4, 2))
    ref, _ = run(fresh(), DataIterator(ds, global_batch=8, seq_len=32), 8)

    # ---- elastic: 4 steps on A, dump via the migration lifecycle
    it1 = DataIterator(ds, global_batch=8, seq_len=32)
    st, _ = run(fresh(), it1, 4)
    sess = CheckpointSession(SessionConfig(
        root=f"file://{tmp}/ck",
        migration=MigrationPolicy(arch=cfg.name, mesh=mesh_a)), device=dev)
    ticket = sess.migrate(MigrateRequest(state=st, iterator=it1,
                                         reason="resize-drill"))
    assert ticket.exit_code == 85
    print("dumped on mesh (4 data, 2 model) with migration record")

    # ---- invariant 1: restore onto B and C is bit-identical to the dump
    mesh_b, sps_b = mesh_of((2, 4))
    rep = sess.restore(RestoreRequest(target_struct=struct, shardings=sps_b,
                                      mesh=mesh_b))
    assert rep.digest_verified, "integrity digest must prove bit-identity"
    assert rep.topology_changed and "dp_degree" in rep.changes, rep.changes
    assert bitwise(st, rep.state), "restored state != dumped state"
    print("restore onto (2 data, 4 model): bit-identical, digest verified")

    mesh_c, sps_c = mesh_of((8, 1))
    rep_c = sess.restore(RestoreRequest(target_struct=struct,
                                        shardings=sps_c, mesh=mesh_c))
    assert rep_c.digest_verified and bitwise(st, rep_c.state)
    print("restore onto (8 data, 1 model): bit-identical — topology is a "
          "restore-time choice")

    # ---- invariant 2: replay determinism of the B continuation
    st_b, _ = run(rep.state, rep.make_iterator(ds), 4)
    rep2 = sess.restore(RestoreRequest(target_struct=struct,
                                       shardings=sps_b, mesh=mesh_b))
    st_b2, _ = run(rep2.state, rep2.make_iterator(ds), 4)
    assert bitwise(st_b, st_b2), "replayed continuation must be bitwise equal"
    print("continued on mesh (2 data, 4 model): replay-deterministic")

    # ---- invariant 3: B continuation == uninterrupted A run, bitwise (one
    # device runs one program under every mesh record)
    assert bitwise(ref, st_b), \
        "cross-mesh continuation must equal the uninterrupted run bitwise"
    print("cross-mesh continuation equals uninterrupted run bitwise "
          "(one program on one device; no per-shard rounding)")

    # ---- invariant 4: deterministic elastic DP across host counts
    ds2 = TokenDataset(f"{tmp}/d2", vocab_size=cfg.vocab_size, seed=1)
    ref_dp = ElasticDPTrainer(lm, opt, ds2, global_batch=8, seq_len=32,
                              hosts=4, device=dev)
    ref_dp.run(6)
    t = ElasticDPTrainer(lm, opt, ds2, global_batch=8, seq_len=32, hosts=4,
                         device=dev)
    t.run(3)
    sess2 = CheckpointSession(SessionConfig(
        root=f"file://{tmp}/ck2",
        migration=MigrationPolicy(arch=cfg.name, topology=t.topology())),
        device=dev)
    ticket2 = sess2.migrate(MigrateRequest(state=t.state,
                                           iterator=t.iters[0],
                                           reason="resize-drill"))
    assert ticket2.exit_code == 85
    rep_dp = sess2.restore(RestoreRequest(target_struct=struct,
                                          host_count=2, dp_degree=2))
    t2 = ElasticDPTrainer.from_resume(lm, opt, ds2, rep_dp, seq_len=32)
    t2.run(3)
    assert bitwise(ref_dp.state, t2.state), \
        "deterministic elastic DP must be bit-identical across host counts"
    print("4-host -> 2-host migration, deterministic DP: bit-identical")
    print("elastic resize drill OK")


if __name__ == "__main__":
    main()
