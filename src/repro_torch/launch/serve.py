"""Serving launcher: batched greedy generation with a migratable session —
the JAX package's launch/serve.py on the port.

Generate k tokens, dump the session (KV cache + output cursor), stop,
restore in a fresh process, continue: the output equals an uninterrupted
run's (tests/test_torch_serving.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --tiny --device cuda --prompt-len 16 --gen 32 --batch 4 \\
      --ckpt-dir /tmp/serve_ck --ckpt-at 10 [--stop-after-ckpt | --resume]

``--no-tiny`` serves the full published config. Weights and prompts come
from ``--seed`` (a torch.Generator and numpy's default_rng; they differ
from the JAX package's, whose generators differ).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import Checkpointer, serve_meta
from repro_torch.models.model import LM
from repro_torch.serving import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=configs.ARCH_NAMES)
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-at", type=int, default=0,
                    help="dump session after this many generated tokens")
    ap.add_argument("--stop-after-ckpt", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cfg = configs.get_tiny(args.arch) if args.tiny \
        else configs.get_config(args.arch)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(args.seed),
                     device=args.device)
    max_len = args.prompt_len + args.gen + 1
    eng = ServeEngine(lm, params, max_len=max_len)
    ckpt = Checkpointer(args.ckpt_dir, device=args.device) \
        if args.ckpt_dir else None

    if args.resume:
        assert ckpt and ckpt.registry.latest(), "nothing to resume"
        state, man = ckpt.load_latest()
        eng.restore_session(state)
        print(f"[serve] resumed session at token "
              f"{eng.generated().shape[1]} from {man['image_id']}")
    else:
        prompts = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
        eng.submit(prompts)

    def maybe_ckpt(e):
        n = e.generated().shape[1]
        if ckpt and args.ckpt_at and n == args.ckpt_at:
            ckpt.save(e.session_state(), step=n,
                      meta=serve_meta(arch=cfg.name, tokens_done=n))
            print(f"[serve] session dumped at token {n}")
            if args.stop_after_ckpt:
                raise SystemExit(0)

    out = eng.generate(args.gen, on_token=maybe_ckpt)
    print("[serve] generated tokens:")
    for b in range(out.shape[0]):
        print(" ", out[b].tolist())


if __name__ == "__main__":
    main()
