"""Rematerialisation in repro_torch's train forward against the JAX
package's: ``cfg.remat_policy`` none / dots / full on each group's body,
the checkpointed final norm, cross-entropy chunks and attention chunk
steps (src/repro/models/model.py ``_remat``, attention.py's
``jax.checkpoint``).

On the ``tiny()`` configs of qwen3-8b, gemma2-2b (window and softcaps),
granite-moe-3b-a800m (MoE), xlstm-350m (mLSTM and sLSTM) and zamba2-1.2b
(mamba2, its shared block and tail), with the JAX package's weights
carried across by ``from_jax`` and seeded numpy tokens:

  (i)   the port's loss and every gradient under dots and full are bitwise
        those under none: a recompute repeats the same ops on the same
        inputs on the CPU;
  (ii)  the port's gradients under each policy match ``jax.grad`` of the
        JAX loss under the same policy, both in fp32 compute, within
        ``GRAD_ATOL`` of each leaf's largest magnitude: 1e-5, the fp32
        tolerance of tests/test_torch_model.py (the same math summed in
        another order), 3e-5 (its ``HIDDEN_ATOL``) for the two
        architectures with recurrent blocks. A leaf whose gradient is
        under a thousandth of the largest leaf's is held to that
        thousandth: its gradient is what cancels in the sum (xlstm's sLSTM
        input-gate bias gets 1e-9 from both packages, rounding noise);
  (iii) what a forward keeps for the backward pass
        (``models.model.saved_for_backward``) orders full < dots < none;
        no policy keeps a score tensor, and the bytes per token grow by at
        most 1.5x from 512 to 2048 tokens (the chunk steps still keep their
        O(S) carries, as JAX's scan does); the CE keeps less than one fp32
        copy of the logits, B * T * V * 4 bytes;
  (iv)  dots keeps exactly the outputs of the products without a batch
        dimension: q, k, v and the output projection, and the MLP's three.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_tiny  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import LM, saved_for_backward  # noqa: E402
from repro_torch.models.params import (from_jax, tree_leaves,  # noqa: E402
                                       tree_map)

ARCHS = ["qwen3-8b", "gemma2-2b", "granite-moe-3b-a800m", "xlstm-350m",
         "zamba2-1.2b"]
ATTN = ["qwen3-8b", "gemma2-2b"]
RECURRENT = ("xlstm-350m", "zamba2-1.2b")
POLICIES = ("none", "dots", "full")
GRAD_ATOL = {a: 3e-5 if a in RECURRENT else 1e-5 for a in ARCHS}

_PARAMS = {}


def _params(arch):
    """The JAX package's seeded tiny weights, as numpy."""
    if arch not in _PARAMS:
        jp = JLM(get_tiny(arch)).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = jax.tree.map(np.asarray, jp)
    return _PARAMS[arch]


def _tokens(cfg, S, B=2, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port(arch, policy, vocab=None):
    cfg = tconfigs.get_tiny(arch).replace(remat_policy=policy)
    if vocab:
        cfg = cfg.replace(vocab_size=vocab)
    return LM(cfg)


def _port_grads(lm, params, toks, compute_dtype=torch.bfloat16):
    """(loss, grads in leaf order, SavedForBackward) of the port's loss:
    ``LM.loss`` in bf16, or the same sum with ``compute_dtype``."""
    leaves = tree_map(lambda _, p: p.detach().requires_grad_(True), params)
    batch = torch.from_numpy(toks).long()
    with saved_for_backward(exclude=tree_leaves(leaves)) as rec:
        if compute_dtype == torch.bfloat16:
            loss, _ = lm.loss(leaves, {"tokens": batch})
        else:
            loss = _loss_in(lm, leaves, batch, compute_dtype)
    loss.backward()
    return loss.detach(), [p.grad for p in tree_leaves(leaves)], rec


def _loss_in(lm, params, tokens, compute_dtype):
    """LM.loss's sum with another compute dtype (both packages' loss
    computes in bf16)."""
    cfg = lm.cfg
    x, _, aux = lm.forward(params, tokens=tokens, compute_dtype=compute_dtype)
    ce = lm._chunked_ce(params, x[:, :-1], tokens[:, 1:], 512)
    if cfg.num_experts:
        return ce + cfg.router_aux_coef * aux / cfg.num_layers
    return ce


@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policies_give_bitwise_the_loss_and_grads_of_none(arch, policy):
    toks = _tokens(tconfigs.get_tiny(arch), 32)
    params = from_jax(_params(arch), "cpu")
    l0, g0, _ = _port_grads(_port(arch, "none"), params, toks)
    l1, g1, _ = _port_grads(_port(arch, policy), params, toks)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) and all(
        torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_under_the_same_policy(arch, policy):
    cfg = get_tiny(arch).replace(remat_policy=policy)
    jlm = JLM(cfg)
    toks = _tokens(cfg, 32)
    jt = jnp.asarray(toks)

    def jloss(p):
        x, _, aux = jlm.forward(p, tokens=jt, mode="train",
                                compute_dtype=jnp.float32)
        ce = jlm._chunked_ce(p, x[:, :-1], jt[:, 1:], 512)
        if cfg.num_experts:
            return ce + cfg.router_aux_coef * aux / cfg.num_layers
        return ce

    jp = jax.tree.map(jnp.asarray, _params(arch))
    jl, jg = jax.value_and_grad(jloss)(jp)
    want = tree_leaves(from_jax(jax.tree.map(np.asarray, jg), "cpu"))
    tl, got, _ = _port_grads(_port(arch, policy),
                             from_jax(_params(arch), "cpu"), toks,
                             compute_dtype=torch.float32)
    assert abs(float(tl) - float(jl)) < 1e-5 * max(1.0, abs(float(jl)))
    assert len(got) == len(want)
    largest = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-3 * largest)
        assert float((g - w).abs().max()) <= GRAD_ATOL[arch] * scale


def _saved(arch, policy, S):
    """What the port's bf16 loss on one S-token sequence keeps for its
    backward pass (the forward alone: the record is complete once the
    loss exists)."""
    params = tree_map(lambda _, p: p.requires_grad_(True),
                      from_jax(_params(arch), "cpu"))
    toks = torch.from_numpy(_tokens(tconfigs.get_tiny(arch), S, B=1)).long()
    with saved_for_backward(exclude=tree_leaves(params)) as rec:
        _port(arch, policy).loss(params, {"tokens": toks})
    return rec


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_bytes_order_full_dots_none(arch):
    recs = [_saved(arch, p, 64) for p in POLICIES]
    n = [r.nbytes for r in recs]
    assert n[2] < n[1] < n[0], dict(zip(POLICIES, n))
    assert recs[1].cached and not recs[0].cached and not recs[2].cached


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ATTN)
def test_no_score_tensor_and_bytes_per_token_flat_in_length(arch, policy):
    """At 512 and 2048 tokens (qwen3's and gemma2's tiny configs keep
    their published chunks, 512 queries x 1024 keys, and gemma2 its
    window): no saved tensor is a chunk's scores, none is as large as
    one, and the bytes per token at 2048 are at most 1.5x those at 512
    (3.3x before the chunk steps were checkpointed)."""
    cfg = tconfigs.get_tiny(arch)
    H = cfg.num_heads
    per_token = {}
    for S in (512, 2048):
        rec = _saved(arch, policy, S)
        T = S                                 # B = 1
        cq, ckv = min(cfg.attn_chunk_q, T), min(cfg.attn_chunk_kv, T)
        scores = {(1, T // cq, cq, H, ckv)}
        for W in set(cfg.windows) - {0}:
            scores.add((1, cq, H, W + cq))
        shapes = [s for s, _, _ in rec.saved] + [s for _, s, _, _ in
                                                 rec.cached]
        assert not scores & set(shapes), (S, scores & set(shapes))
        smallest_scores = min(int(np.prod(s)) for s in scores) * 4
        assert max(b for *_, b in rec.saved) < smallest_scores
        per_token[S] = rec.nbytes / T
    assert per_token[2048] <= 1.5 * per_token[512], per_token


def test_chunked_ce_keeps_less_than_the_logits():
    """The CE over a vocabulary of 8192 in 512-token chunks keeps less
    than one fp32 copy of the [B, T, V] logits: each chunk's are
    recomputed in the backward pass."""
    V, B, S = 8192, 2, 1024
    lm = _port("qwen3-8b", "dots", vocab=V)
    g = torch.Generator().manual_seed(0)
    params = lm.init(g, device="cpu")
    x = torch.randn(B, S, lm.cfg.d_model, generator=g).to(torch.bfloat16)
    x.requires_grad_(True)
    labels = torch.from_numpy(_tokens(lm.cfg, S, B))
    with saved_for_backward(exclude=tree_leaves(params)) as rec:
        ce = lm._chunked_ce(params, x[:, :-1], labels[:, 1:], 512)
    ce.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert 0 < rec.nbytes < B * (S - 1) * V * 4, rec.nbytes


@pytest.mark.parametrize("arch", ATTN)
def test_dots_keeps_exactly_the_unbatched_products(arch):
    """Per layer: q [1, B*S, H*hd], k and v [1, B*S, KV*hd] and the output
    projection [1, B*S, d] (einsum's batch-1 bmm), and the MLP's up and
    gate [B*S, d_ff] and down [B*S, d] (mm); nothing else, and nothing
    twice (the recompute reads them back)."""
    cfg = tconfigs.get_tiny(arch)
    B, S = 2, 64
    _, _, rec = _port_grads(_port(arch, "dots"),
                            from_jax(_params(arch), "cpu"),
                            _tokens(cfg, S, B=B))
    BS, d, hd = B * S, cfg.d_model, cfg.resolved_head_dim
    per_layer = [("bmm", (1, BS, cfg.num_heads * hd)),
                 ("bmm", (1, BS, cfg.num_kv_heads * hd)),
                 ("bmm", (1, BS, cfg.num_kv_heads * hd)),
                 ("bmm", (1, BS, d)),
                 ("mm", (BS, cfg.d_ff)), ("mm", (BS, cfg.d_ff)),
                 ("mm", (BS, d))]
    got = sorted((op.split(".")[0], s) for op, s, _, _ in rec.cached)
    assert got == sorted(per_layer * cfg.num_layers)
    assert all(dt == torch.bfloat16 for _, _, dt, _ in rec.cached)
