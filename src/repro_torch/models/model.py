"""The decoder LM: the JAX package's models/model.py on tensors.

  train   — full forward, chunked-CE loss (never materializes [B,S,V])
  prefill — forward + cache / recurrent state construction (serving)
  decode  — one token against the cache (serving)

Layers are stacked per repeating pattern group exactly as in the JAX
package (``params/stack/b0/...`` leaves with a leading ``num_groups``
axis), so the parameter tree — and with it the checkpoint image — is the
same. A Python loop indexes the stacked leaves where JAX scans; autograd
sends each group's gradient back into the stacked leaf. zamba2's
weight-shared attention block (``params/shared``) runs before every group
and once more before the tail layers (``params/tail/t<j>``), each
application with its own KV cache. Blocks dispatch by ``cfg.pattern``
(attention with an MLP or MoE, mamba2, mlstm, slstm); the MoE aux loss is
summed through the stack. Compute runs in bf16 on fp32 masters by default,
as in the JAX package.

Rematerialisation follows the JAX package: in train mode each group's body
(zamba2's shared application and the pattern's blocks) runs under
``torch.utils.checkpoint`` with ``cfg.remat_policy`` — ``none`` (no
checkpoint), ``dots`` (keep the outputs of matmuls without a batch
dimension, recompute the rest; the default) or ``full`` (keep only the
group's inputs). The tail layers stay outside, the final norm and every
cross-entropy chunk are checkpointed on their own, and so is every chunk
step of the training attention (models/attention.py): the backward pass
keeps no score tensor and no chunk's logits. ``saved_for_backward``
measures what a forward keeps for the backward pass.

On a multi-device mesh (params placed as DTensors,
distributed/sharding.py) the same code runs rank-local: each group's
weights are gathered over the data axes as the group starts
(``sharding.gather_fsdp``, inside the remat'd body, so a recompute
gathers again, as XLA's does), the embedding table and head once per
call, and plain tensors made inside (positions, masks, scalars) join the
DTensor program as replicated (``spmd``). ``act_sharding`` and
``cast_params_once`` are the JAX package's arguments.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import kvcache
from repro_torch.models import params as pm
from repro_torch.models.blocks import apply_block, block_specs
from repro_torch.models.layers import (checkpointed, embed_lookup,
                                       embed_specs, rms_norm, unembed)

_aten = torch.ops.aten
# the SavedForBackward record of the innermost ``saved_for_backward`` block
_RECORD = contextvars.ContextVar("saved_for_backward", default=None)


def _dots_with_no_batch_dims_saveable(ctx, func, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` on aten
    ops: keep the output of a matmul without a batch dimension — an ``mm``
    (``x @ w``: the MLP, the MoE router, the SSM projections) or a ``bmm``
    of batch 1, which is what ``torch.einsum`` makes of a weight product
    such as ``bsd,dhk->bshk`` (q, k, v and the output projection) — and
    recompute everything else: attention scores, expert and recurrent
    products (their batch is heads or experts), norms, rope, casts.
    A batched product whose batch happens to be 1 (B * heads = 1) is kept
    too; no configuration trains at that size."""
    if func is _aten.mm.default:
        a, b = args
        shape = (a.shape[0], b.shape[1])
    elif func is _aten.bmm.default and args[0].shape[0] == 1:
        a, b = args
        shape = (1, a.shape[1], b.shape[2])
    else:
        return CheckpointPolicy.PREFER_RECOMPUTE
    rec = _RECORD.get()
    if rec is not None and not ctx.is_recompute:
        rec.add_cached(func, shape, a.dtype)
    return CheckpointPolicy.MUST_SAVE


def _nothing_saveable(ctx, func, *args, **kwargs):
    """``jax.checkpoint_policies.nothing_saveable``: keep only the inputs."""
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {
    "none": None,
    "dots": _dots_with_no_batch_dims_saveable,
    "full": _nothing_saveable,
}


def _remat(fn, policy_name: str):
    """``fn`` checkpointed under the named policy, as the JAX package's
    ``_remat``: ``none`` returns it unchanged. The forward draws no random
    numbers, so no RNG state is stashed for the recompute."""
    if policy_name == "none":
        return fn
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _POLICIES[policy_name])
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, context_fn=context_fn)


class SavedForBackward:
    """What the backward pass keeps, recorded by ``saved_for_backward``:
    ``saved`` the tensors autograd saved outside any checkpoint (a
    checkpoint's inputs among them) as (shape, dtype, bytes), ``cached``
    the matmul outputs a selective checkpoint kept as (op, shape, dtype,
    bytes). ``nbytes`` counts each storage once and leaves out storages
    shared with the excluded tensors (the params)."""

    def __init__(self, exclude=()):
        self.saved, self.cached = [], []
        self.nbytes = 0
        self._seen = {t.untyped_storage().data_ptr() for t in exclude}

    def pack(self, t):
        st = t.untyped_storage()
        if st.data_ptr() not in self._seen:
            self._seen.add(st.data_ptr())
            self.saved.append((tuple(t.shape), t.dtype, st.nbytes()))
            self.nbytes += st.nbytes()
        return t

    def add_cached(self, func, shape, dtype):
        n = dtype.itemsize
        for s in shape:
            n *= s
        self.cached.append((func.__name__, tuple(shape), dtype, n))
        self.nbytes += n


@contextlib.contextmanager
def saved_for_backward(exclude=()):
    """Record what a forward run inside the block keeps for its backward
    pass (``SavedForBackward``): the tensors autograd saves, seen through
    ``torch.autograd.graph.saved_tensors_hooks`` (inside a checkpoint
    the checkpoint's own hooks take over and keep nothing), plus the
    outputs the ``dots`` policy caches, which no hook sees."""
    rec = SavedForBackward(exclude)
    token = _RECORD.set(rec)
    try:
        with torch.autograd.graph.saved_tensors_hooks(rec.pack, lambda t: t):
            yield rec
    finally:
        _RECORD.reset(token)


_SPMD_DEPTH = [0]


@contextlib.contextmanager
def spmd(*trees):
    """The context a step over DTensors runs in: plain tensors that meet a
    DTensor count as replicated (``implicit_replication``, entered once
    for the outermost block: torch's resets its flag on exit). A no-op
    without DTensors."""
    if _SPMD_DEPTH[0] or not any(
            shd.has_dtensor(t) if isinstance(t, dict) else shd.is_dtensor(t)
            for t in trees):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _SPMD_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SPMD_DEPTH[0] -= 1


def _gathered(tree):
    return pm.tree_map(lambda _, t: shd.gather_fsdp(t), tree)


def _head(embed: dict, cfg: ModelConfig) -> dict:
    """The embedding leaf the unembedding reads, gathered: ``head``, or
    the table itself when tied."""
    name = "tok" if cfg.tie_embeddings else "head"
    return {name: shd.gather_fsdp(embed[name])}


class LM:
    def __init__(self, cfg: ModelConfig, act_sharding=None,
                 cast_params_once: bool = False):
        """act_sharding: optional NamedSharding for the [B, S, d] residual
        stream, applied at group boundaries (``_cs``) as in JAX, and after
        every block's residual adds (``sharding.constrain_act``): batch
        over the data axes, and the sequence over ``model`` for sequence
        parallelism. It pins what DTensor's propagation would otherwise
        leave as it comes out of a block (an MLP's output is a partial
        sum over ``model``), and the gradient with it.

        cast_params_once: cast the fp32 ``stack``/``tail``/``shared``
        masters to the compute dtype once, before the group loop, so the
        all-gathers of the FSDP weights move bf16."""
        cfg.validate()
        self.cfg = cfg
        self.act_sharding = act_sharding
        self.cast_params_once = cast_params_once

    def _cs(self, x):
        if self.act_sharding is not None and x.ndim == 3:
            return shd.redistribute(x, self.act_sharding)
        return x

    # ------------------------------------------------------------------ specs
    def specs(self):
        cfg = self.cfg
        entry = {f"b{j}": block_specs(kind, cfg)
                 for j, kind in enumerate(cfg.pattern)}
        tree = {
            "embed": embed_specs(cfg),
            "stack": pm.stack_specs(entry, cfg.num_groups),
            "final_norm": pm.scale_ones(cfg.d_model),
        }
        if cfg.tail_layers:
            tree["tail"] = {f"t{j}": block_specs(cfg.pattern[j], cfg)
                            for j in range(cfg.tail_layers)}
        if cfg.shared_attn_every:
            tree["shared"] = block_specs("attn", cfg, shared=True)
        return tree

    def abstract(self, dtype=torch.float32):
        return pm.abstract(self.specs(), dtype)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        return pm.init(self.specs(), generator, dtype, device)

    def pspecs(self, rules: dict):
        """The params tree of PartitionSpecs under ``rules`` (logical axis
        -> mesh axis; distributed/sharding.make_rules)."""
        return pm.pspecs(self.specs(), rules)

    def n_params(self) -> int:
        return pm.count(self.specs())

    # ---------------------------------------------------------------- forward
    def forward(self, params, *, tokens=None, embeds=None, positions=None,
                mode="train", cache=None, compute_dtype=torch.bfloat16):
        """tokens [B,S] or embeds [B,S,d] (a frontend's output, cast to
        ``compute_dtype`` in place of the embedding lookup; exactly one of
        the two) -> (hidden [B,S,d] after the final norm, new_cache, aux).
        positions: [B,S], or [3,B,S] M-RoPE streams; default the cache
        cursor onward. prefill and decode take a cache
        (``kvcache.init_cache``) and update it in place; its ``pos`` cursor
        advances by S (prefill) or 1 (decode). train takes none and returns
        None for it. aux is the sum of the blocks' MoE load-balance losses
        (fp32 scalar, 0 without experts)."""
        if (tokens is None) == (embeds is None):
            raise ValueError("LM.forward takes exactly one of tokens= and "
                             "embeds=")
        with spmd(params):
            return self._forward(params, tokens, embeds, positions, mode,
                                 cache, compute_dtype)

    def _forward(self, params, tokens, embeds, positions, mode, cache,
                 compute_dtype):
        cfg = self.cfg
        if embeds is not None:
            x = embeds.to(compute_dtype)
        else:
            x = embed_lookup({"tok": shd.gather_fsdp(params["embed"]["tok"])},
                             tokens, cfg, compute_dtype)
        x = self._cs(x)
        B, S = x.shape[:2]
        # one host read of the cursor per decode: its cache write and mask
        # slice by it. Prefill fills a fresh cache from slot 0 and reads
        # none, so it also runs on the meta device (launch/dryrun.py),
        # whose tensors hold no value; a meta decode takes its cursor as a
        # CPU scalar (launch/specs.decode_specs)
        pos = int(cache["pos"]) if mode == "decode" else 0
        if positions is None:
            ar = torch.arange(S, dtype=torch.int32, device=x.device) + pos
            if shd.is_dtensor(x):
                # the batch's sharding: a rank makes its own rows only
                positions = torch.zeros_like(x[..., 0],
                                             dtype=torch.int32) + ar
            else:
                positions = ar[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def run(kind, p, x, window, c):
            # the context is entered here, inside the remat'd body, so a
            # recompute in the backward pass pins as the forward did
            with shd.activation_sharding(self.act_sharding):
                x, _, a = apply_block(kind, p, x, cfg, positions=positions,
                                      window=window, mode=mode, cache=c,
                                      pos=pos)
            return x, a

        def entry(name, g):
            """Group g's view of the stacked cache entry ``name`` (b<j>,
            or "shared": the shared block's application g)."""
            if cache is None:
                return None
            tree = cache["shared"] if name == "shared" \
                else cache["stack"][name]
            return {n: t[g] for n, t in tree.items()}

        if self.cast_params_once:
            # fp32 masters cast before the loop: the gathers move bf16
            params = dict(params)
            for k in ("stack", "tail", "shared"):
                if k in params:
                    params[k] = pm.tree_map(
                        lambda _, t: t.to(x.dtype)
                        if t.dtype == torch.float32 else t, params[k])
        shared = params.get("shared")
        # each stacked leaf unbound once: a group's slice is a view, and
        # the backward pass stacks the groups' gradients once (``t[g]`` in
        # every group would write a zero-filled gradient of the whole
        # stack per group, quadratic in depth)
        layers = pm.tree_map(lambda _, t: t.unbind(0), params["stack"])

        def group(x, aux, g):
            x = self._cs(x)
            if shared is not None:
                x, a = run("attn", _gathered(shared), x, 0,
                           entry("shared", g))
                aux = aux + a
            gp = pm.tree_map(lambda _, ts: shd.gather_fsdp(ts[g]), layers)
            for j, (kind, win) in enumerate(zip(cfg.pattern, cfg.windows)):
                x, a = run(kind, gp[f"b{j}"], x, win, entry(f"b{j}", g))
                aux = aux + a
            return x, aux

        body = _remat(group, cfg.remat_policy if mode == "train" else "none")
        for g in range(cfg.num_groups):
            x, aux = body(x, aux, g)
        # ---- tail layers (zamba2: 38 = 6*6 + 2) after one more shared
        # application, with the last shared cache
        if cfg.tail_layers:
            if shared is not None:
                x, a = run("attn", _gathered(shared), x, 0,
                           entry("shared", -1))
                aux = aux + a
            for j in range(cfg.tail_layers):
                x, a = run(cfg.pattern[j],
                           _gathered(params["tail"][f"t{j}"]), x,
                           cfg.windows[j],
                           None if cache is None else cache["tail"][f"t{j}"])
                aux = aux + a
        # checkpointed: the final norm sits outside the remat'd stack and
        # would keep fp32 [B,S,d] intermediates for the backward pass
        x = checkpointed(lambda h, s: rms_norm(h, s, cfg.norm_eps),
                         self._cs(x), shd.gather_fsdp(params["final_norm"]))
        new_cache = None
        if cache is not None and mode != "train":
            new_cache = dict(cache, pos=cache["pos"]
                             + (1 if mode == "decode" else S))
        return x, new_cache, aux

    # ------------------------------------------------------------------- loss
    def loss(self, params, batch, ce_chunk: int = 512,
             compute_dtype=torch.bfloat16):
        """batch: {"tokens": [B,S]} or {"embeds": [B,S,d], "labels": [B,S]}
        (+ optional "positions"). Returns (loss, {"ce", "aux", "loss"}):
        with experts the loss adds ``router_aux_coef`` times the mean of
        the layers' load-balance losses."""
        cfg = self.cfg
        tokens = batch.get("tokens")
        embeds = batch.get("embeds")
        labels = batch.get("labels", tokens)
        x, _, aux = self.forward(
            params, tokens=tokens if embeds is None else None, embeds=embeds,
            positions=batch.get("positions"), compute_dtype=compute_dtype)
        with spmd(params):
            ce = self._chunked_ce(params, x[:, :-1], labels[:, 1:], ce_chunk)
            aux_mean = aux / (cfg.num_layers if cfg.num_experts else 1)
            loss = ce + cfg.router_aux_coef * aux_mean if cfg.num_experts \
                else ce
        return loss, {"ce": ce, "aux": aux_mean, "loss": loss}

    def _chunked_ce(self, params, x, labels, chunk: int):
        """Streaming CE over seq chunks: one chunk's [B, c, V] logits at a
        time. Each chunk step is checkpointed, as in the JAX package, so
        the backward pass recomputes a chunk's logits instead of keeping
        every chunk's."""
        cfg = self.cfg
        B, T, d = x.shape
        c = min(chunk, T)
        while T % c:
            c -= 1
        head = _head(params["embed"], cfg)

        def step(xc, lc):
            logits = unembed(head, xc, cfg)                  # fp32 [B,c,V]
            lz = shd.logsumexp_last(logits)
            gold = shd.take_last(logits, lc[..., None].long())[..., 0]
            return (lz - gold).sum()

        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(T // c):
            tot = tot + checkpointed(step, x[:, i * c:(i + 1) * c],
                                     labels[:, i * c:(i + 1) * c])
        return tot / (B * T)

    # -------------------------------------------------------------- serving
    def prefill(self, params, *, tokens=None, embeds=None, positions=None,
                S_max=None, compute_dtype=torch.bfloat16,
                cache_shardings=None):
        """tokens [B,S] or embeds [B,S,d] -> (last-position logits [B,V]
        fp32, cache). The cache holds S_max (default S) positions, on the
        input's device; ``cache_shardings`` (NamedShardings over a
        multi-device mesh) makes it DTensors, each rank holding its
        shard."""
        src = tokens if embeds is None else embeds
        B, S = src.shape[:2]
        dev = src.to_local().device if shd.is_dtensor(src) else src.device
        cache = kvcache.init_cache(self.cfg, B, S_max or S,
                                   dtype=compute_dtype, device=dev,
                                   shardings=cache_shardings)
        x, cache, _ = self.forward(params, tokens=tokens, embeds=embeds,
                                   positions=positions, mode="prefill",
                                   cache=cache, compute_dtype=compute_dtype)
        with spmd(params):
            logits = unembed(_head(params["embed"], self.cfg), x[:, -1:],
                             self.cfg)[:, 0]
        return logits, cache

    def decode_step(self, params, cache, tokens,
                    compute_dtype=torch.bfloat16):
        """tokens [B,1] -> (logits [B,V] fp32, cache advanced by one)."""
        x, cache, _ = self.forward(params, tokens=tokens, mode="decode",
                                   cache=cache, compute_dtype=compute_dtype)
        with spmd(params):
            logits = unembed(_head(params["embed"], self.cfg), x[:, -1:],
                             self.cfg)[:, 0]
        return logits, cache
