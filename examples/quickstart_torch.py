"""Quickstart: the paper's workflow end to end in a minute, through the
PyTorch port's service façade (repro_torch.api, the libcriu analogue).

1. probe the environment (`criu check` -> capabilities())
2. train a tiny LM a few steps
3. criu-style dump at an arbitrary step (CheckpointSession + DumpRequest)
4. restore (fresh session — "another machine") via RestoreRequest
5. continue; verify the continuation is bitwise identical
6. migrate a serving session the same way

``--device`` is where the model, the state and the sessions live: "cuda"
by default (it raises without a card), "cpu" when asked. On a card the
script turns on torch's deterministic algorithms (the embedding backward
sums with atomics otherwise), so step 5 holds bit for bit there too.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
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

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)         # no card: raises, never the CPU

    from repro_torch import configs
    from repro_torch.api import (CheckpointSession, DumpRequest,
                                 RestoreRequest, SessionConfig, capabilities)
    from repro_torch.core import flatten_with_paths, train_meta
    from repro_torch.data import DataIterator, TokenDataset
    from repro_torch.models.model import LM
    from repro_torch.optim import OptConfig
    from repro_torch.serving import ServeEngine
    from repro_torch.training import (abstract_train_state, init_train_state,
                                      make_train_step)

    tmp = tempfile.mkdtemp()
    cfg = configs.get_tiny("qwen3-8b")
    lm = LM(cfg)
    step = make_train_step(lm, OptConfig(warmup_steps=2, total_steps=100))
    ds = TokenDataset(f"{tmp}/data", vocab_size=cfg.vocab_size, seed=0)

    def batch(it):
        return {"tokens": torch.from_numpy(it.next()).to(dev, torch.int64)}

    # --- 1. criu check ----------------------------------------------------
    caps = capabilities(device=args.device)
    assert caps.supported("serial_dump_restore")
    print(f"capabilities: {sum(c.supported for c in caps)}/"
          f"{len(tuple(caps.capabilities))} supported "
          f"(async lanes: {caps.supported('async_lanes')}, "
          f"delta8: {caps.supported('delta8_codec')}, "
          f"cross-topology: {caps.supported('cross_topology_restore')})")

    # --- 2. train 6 steps -------------------------------------------------
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
    state = init_train_state(lm, torch.Generator().manual_seed(0),
                             device=dev)
    it = DataIterator(ds, global_batch=4, seq_len=64)
    for _ in range(6):
        state, m = step(state, batch(it))
    print(f"step 6 loss {float(m['loss']):.4f}")

    # --- 3. dump ----------------------------------------------------------
    sess = CheckpointSession(SessionConfig(root=f"file://{tmp}/ckpt"),
                             device=dev)
    receipt = sess.dump(DumpRequest(
        state=state, step=6,
        meta=train_meta(arch=cfg.name, step=6, data_state=it.state())))
    print(f"dumped image {receipt.image_id} "
          f"({receipt.stats['bytes_raw'] >> 20} MiB, "
          f"{receipt.stats['chunks']} chunks, "
          f"{receipt.duration_s * 1e3:.0f}ms)")

    # --- 4+5. restore into fresh objects and continue ---------------------
    res = CheckpointSession(f"file://{tmp}/ckpt", device=dev).restore(
        RestoreRequest(target_struct=abstract_train_state(lm)))
    restored = res.state
    it2 = DataIterator.restore(ds, res.manifest["meta"]["data"])
    for _ in range(4):
        restored, m2 = step(restored, batch(it2))

    for _ in range(4):  # uninterrupted reference
        state, m1 = step(state, batch(it))
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten_with_paths(state), flatten_with_paths(restored)))
    print(f"continuation bitwise identical: {same} "
          f"(loss {float(m1['loss']):.4f} == {float(m2['loss']):.4f})")

    # --- 6. migrate a serving session -------------------------------------
    params = restored["params"]
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eng = ServeEngine(lm, params, max_len=32)
    eng.submit(prompts)
    ref = eng.generate(10)                 # uninterrupted reference
    serve_sess = CheckpointSession(f"file://{tmp}/serve", device=dev)

    eng_a = ServeEngine(lm, params, max_len=32)
    eng_a.submit(prompts)
    eng_a.generate(4)
    eng_a.checkpoint(serve_sess, arch=cfg.name)

    eng_b = ServeEngine(lm, params, max_len=32)
    eng_b.resume_from(serve_sess)
    out_b = eng_b.generate(10)
    print(f"migrated serving session identical: "
          f"{np.array_equal(out_b, ref)}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
