"""Train-step factory: loss -> grads -> clip -> AdamW over the TrainState.

TrainState = {"params", "opt": {"m", "v"}, "step": int32 0-d} — a plain
nested dict of tensors with the JAX package's leaf paths, shapes and dtypes
(``abstract_train_state`` matches ``repro.training.train_loop``'s), which
is exactly what repro_torch.core dumps and restores. The step updates the
state's tensors in place (see optim/adamw.py) and returns the state.
Microbatching is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import (OptConfig, adamw_update, clip_by_global_norm,
                               init_opt_state, warmup_cosine)


def init_train_state(lm: LM, generator: torch.Generator,
                     dtype=torch.float32, device="cuda"):
    params = lm.init(generator, dtype, device)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def abstract_train_state(lm: LM, dtype=torch.float32):
    """The train state's tree of ``meta`` tensors (no memory)."""
    params = lm.abstract(dtype)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def make_train_step(lm: LM, opt_cfg: OptConfig):
    """-> train_step(state, batch) -> (state, metrics)."""

    def train_step(state, batch):
        step1 = state["step"] + 1
        params = tree_map(lambda _, p: p.detach().requires_grad_(True),
                          state["params"])
        with torch.enable_grad():
            loss, metrics = lm.loss(params, batch)
            loss.backward()
        grads = tree_map(lambda _, p: p.grad, params)
        del params
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        lr = warmup_cosine(step1, opt_cfg.lr, opt_cfg.warmup_steps,
                           opt_cfg.total_steps).to(step1.device)
        adamw_update(grads, state["opt"], state["params"], step1, opt_cfg,
                     lr=lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr)
        state = {"params": state["params"], "opt": state["opt"],
                 "step": step1}
        return state, metrics
    return train_step
