"""Train-step factory: loss -> grads -> clip -> AdamW over the TrainState.

TrainState = {"params", "opt": {"m", "v"}, "step": int32 0-d} — a plain
nested dict of tensors with the JAX package's leaf paths, shapes and dtypes
(``abstract_train_state`` matches ``repro.training.train_loop``'s), which
is exactly what repro_torch.core dumps and restores. The step updates the
state's tensors in place (see optim/adamw.py) and returns the state.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.model import LM, spmd
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


def train_state_paths(lm: LM, dtype=torch.float32) -> list:
    """Leaf paths of the train-state tree — exactly what a checkpoint
    manifest will contain. Useful for authoring codec policies and for
    dry-run dump planning (CheckpointSession.plan) before any step has
    run."""
    from repro_torch.core.dump import leaf_paths_of
    return leaf_paths_of(abstract_train_state(lm, dtype))


def train_state_pspecs(lm: LM, rules: dict):
    """PartitionSpecs of the train state: m and v take the params' specs,
    the step is replicated."""
    from repro_torch.distributed.sharding import PartitionSpec
    p = lm.pspecs(rules)
    return {"params": p, "opt": {"m": p, "v": p},
            "step": PartitionSpec()}


def _grads(lm: LM, params, batch, *, accumulate_into=None):
    """(loss, metrics, grads) of ``lm.loss`` on one batch. With
    ``accumulate_into`` (a grads tree from an earlier call) the new grads
    are added to it in place, as autograd accumulates ``.grad``."""
    leaves = tree_map(lambda _, p: p.detach().requires_grad_(True), params)
    if accumulate_into is not None:
        for p, g in zip(tree_leaves(leaves), tree_leaves(accumulate_into)):
            p.grad = g
    with torch.enable_grad():
        loss, metrics = lm.loss(leaves, batch)
        loss.backward()
    # a leaf the loss never read (the embedding table under embeds=) has
    # no .grad: its gradient is zeros, as jax.grad gives
    grads = tree_map(lambda _, p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _apply(state, grads, opt_cfg: OptConfig, metrics: dict):
    """clip -> schedule -> AdamW in place; -> (state, metrics)."""
    step1 = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
    lr = warmup_cosine(step1, opt_cfg.lr, opt_cfg.warmup_steps,
                       opt_cfg.total_steps).to(step1.device)
    adamw_update(grads, state["opt"], state["params"], step1, opt_cfg, lr=lr)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return {"params": state["params"], "opt": state["opt"],
            "step": step1}, metrics


def make_per_example_step_fns(lm: LM, opt_cfg: OptConfig):
    """Topology-invariant training pair for elastic data parallelism
    (training/elastic_dp.py): a single-example grad function plus an
    update-apply function, as in the JAX package. Every example runs the
    same single-example program and the caller sums the grads in global
    example order, so neither the per-example compute nor the fold depends
    on how examples are split over hosts.

    grad_fn(params, tokens[S+1]) -> (loss, grads)
    apply_fn(state, grads_sum, loss_sum, n) -> (state, metrics); params,
    m and v are updated in place.
    """

    def per_example(params, tokens):
        loss, _, grads = _grads(lm, params, {"tokens": tokens[None]})
        return loss, grads

    @torch.no_grad()
    def apply(state, grads_sum, loss_sum, n):
        grads = tree_map(lambda _, g: g / n, grads_sum)
        return _apply(state, grads, opt_cfg, {"loss": loss_sum / n})

    return per_example, apply


def _batch_slice(x, i: int, n: int):
    """Microbatch i of n of a batch entry: its rows i*B/n:(i+1)*B/n; the
    batch dim is axis 0 for tokens, embeds and labels, axis 1 for M-RoPE
    positions [3, B, S]. A DTensor batch sharded over the data axes is
    split on every rank alike: microbatch i is each rank's own i-th slice
    of its rows (no communication; the summed gradient is the same, the
    last microbatch's metrics are over other rows than on one device)."""
    ax = 1 if x.ndim == 3 and x.shape[0] == 3 and x.dtype == torch.int32 \
        else 0
    if shd.is_dtensor(x):
        from torch.distributed.tensor import DTensor
        local = x.to_local()
        k = local.shape[ax] // n
        shape = list(x.shape)
        shape[ax] //= n
        return DTensor.from_local(
            local.narrow(ax, i * k, k).contiguous(), x.device_mesh,
            x.placements, shape=torch.Size(shape),
            stride=shd.contiguous_stride(shape))
    k = x.shape[ax] // n
    return x.narrow(ax, i * k, k)


def make_train_step(lm: LM, opt_cfg: OptConfig, microbatches: int = 1):
    """-> train_step(state, batch) -> (state, metrics). ``microbatches`` > 1
    accumulates grads over batch slices (axis 0), cutting activation memory
    by the microbatch factor; the summed grads are divided by the count, as
    the JAX package's scan does. As there, the metrics are the last
    microbatch's (``metrics["loss"]`` too), beside grad_norm and lr.

    On DTensor state (a multi-device mesh, distributed/sharding.place) the
    same step runs rank-local: DTensor gathers each group's weights and
    reduce-scatters their gradients (models/model.py), AdamW updates the
    local shards in place, the global norm sums every shard, and the
    metrics come back replicated. No op is forced to ``Replicate`` beyond
    what the JAX program replicates: the gold logit of the vocab-sharded
    CE and the metrics (sharding.take_last, sharding.reduce_partial)."""

    def train_step(state, batch):
        with spmd(state["params"]):
            return step(state, batch)

    def step(state, batch):
        if microbatches == 1:
            _, metrics, grads = _grads(lm, state["params"], batch)
        else:
            b = batch["tokens" if "tokens" in batch else "embeds"]
            if shd.is_dtensor(b):
                b = b.to_local()
            assert b.shape[0] % microbatches == 0, (b.shape, microbatches)
            grads = None
            for i in range(microbatches):
                mb = {n: _batch_slice(v, i, microbatches)
                      for n, v in batch.items()}
                _, metrics, grads = _grads(lm, state["params"], mb,
                                           accumulate_into=grads)
            with torch.no_grad():
                for g in tree_leaves(grads):
                    g.div_(microbatches)
        with torch.no_grad():
            state, metrics = _apply(state, grads, opt_cfg, metrics)
        # a loss over batch-sharded rows is a partial sum: all-reduced
        return state, {k: shd.reduce_partial(v) for k, v in metrics.items()}
    return train_step
