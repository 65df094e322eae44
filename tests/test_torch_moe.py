"""repro_torch's MoE dispatch (models/moe.py): the twins of tests/test_moe.py
on the port, and the port against the JAX package on the same weights
(``from_jax``) and the same numpy inputs. Tolerances:

  * fp32: ``F32_TOL`` = 1e-5 on outputs of magnitude ~1 (the same math in
    float32, the expert GEMMs summed in another order; measured worst
    ~1e-6) and 1e-6 on the aux loss;
  * routing (which expert each token goes to, and which tokens are dropped)
    is compared exactly: it decides which terms are summed at all.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jpm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

F32_TOL = 1e-5


def setup(cf=16.0, E=8, K=2, d=32, ff=16, seed=1):
    """(cfg, JAX params, port params, x as numpy [2, 24, d]); the JAX
    test's config with the weights carried across."""
    cfg = configs.get_tiny("granite-moe-3b-a800m").replace(
        d_model=d, d_ff=ff, num_experts=E, experts_per_token=K,
        capacity_factor=cf)
    jp = jpm.init(jmoe.moe_specs(cfg), jax.random.PRNGKey(0))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, d)).astype(np.float32)
    return cfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu"), x


def _t(x):
    return torch.from_numpy(x)


# ------------------------------------------------ twins of tests/test_moe.py
def test_scatter_matches_dense_in_nodrop_regime():
    cfg, _, p, x = setup(cf=16.0)
    y, aux = moe.moe_apply(p, _t(x), cfg)
    y_ref = moe.moe_dense_reference(p, _t(x), cfg)
    assert float((y - y_ref).abs().max()) < 1e-5
    assert torch.isfinite(aux)


def test_capacity_dropping_reduces_output_mass():
    cfg, _, p, x = setup(cf=16.0)
    y_full, _ = moe.moe_apply(p, _t(x), cfg)
    y_drop, _ = moe.moe_apply(p, _t(x), cfg.replace(capacity_factor=0.3))
    # dropped tokens contribute zero -> strictly less L2 mass, no NaNs
    assert float(torch.linalg.norm(y_drop)) < float(torch.linalg.norm(y_full))
    assert bool(torch.isfinite(y_drop).all())


def test_aux_loss_is_one_for_uniform_routing():
    cfg, _, p, x = setup()
    p = dict(p, router=torch.zeros_like(p["router"]))
    _, aux = moe.moe_apply(p, _t(x), cfg)
    assert abs(float(aux) - 1.0) < 0.15  # E * sum(f_e * p_e) ~= 1 balanced


def test_capacity_formula():
    cfg, _, _, _ = setup(cf=1.25, E=8, K=2)
    assert moe.capacity(cfg, 1024) == int(1024 * 2 * 1.25 // 8)
    for T in (1, 24, 48, 1024, 4096):
        assert moe.capacity(cfg, T) == jmoe.capacity(cfg, T)


def test_grad_flows_through_dispatch():
    cfg, _, p, x = setup(cf=4.0)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y, aux = moe.moe_apply(leaves, _t(x), cfg)
    (torch.sum(y * y) + 0.01 * aux).backward()
    gn = torch.sqrt(sum(torch.sum(v.grad ** 2) for v in leaves.values()))
    assert torch.isfinite(gn) and float(gn) > 0


# ----------------------------------------------------------- parity with JAX
def _jax_route(cfg, jp, x):
    """JAX's top-k experts per token ([T, K]) for x [B, S, d]."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1])


@pytest.mark.parametrize("cf", [16.0, 1.25, 0.3])
def test_moe_apply_matches_jax_fp32(cf):
    """Output and aux against the JAX package's moe_apply at a capacity
    that drops nothing (16), the configs' default (1.25) and a tight one
    (0.3), whose drops must be the same tokens."""
    cfg, jp, p, x = setup(cf=cf)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    y, aux = moe.moe_apply(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL)
    assert abs(float(aux) - float(jaux)) < 1e-6
    assert aux.dtype == torch.float32 and aux.shape == ()


def test_dense_reference_matches_jax_fp32():
    cfg, jp, p, x = setup(cf=1.25)
    want = np.asarray(jmoe.moe_dense_reference(jp, jnp.asarray(x), cfg))
    got = moe.moe_dense_reference(p, _t(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_moe_apply_matches_jax_bf16():
    """bf16 compute (the serving and training dtype): within 3e-2 of the
    largest |y| — the same expert choices (the routing softmax is fp32 on
    bf16 logits) and bf16 GEMMs rounded at different places."""
    cfg, jp, p, x = setup(cf=1.25)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), cfg)
    y, aux = moe.moe_apply(p, _t(x).to(torch.bfloat16), cfg)
    want = np.asarray(jy.astype(jnp.float32))
    assert y.dtype == torch.bfloat16
    assert np.abs(y.float().numpy() - want).max() < 3e-2 * np.abs(want).max()
    assert abs(float(aux) - float(jaux)) < 1e-3


@pytest.mark.parametrize("case", ["uniform", "duplicated_experts"])
def test_tied_probabilities_route_like_jax(case):
    """Ties in the router probabilities: a zero router ties every expert
    (each token must take experts 0..K-1, the lower index first, as
    jax.lax.top_k orders them), and an expert whose router column
    duplicates another's ties that pair for every token. Both at a
    capacity that drops (1.25): the same tokens are dropped in both
    packages, so the outputs and aux agree."""
    cfg, jp, _, x = setup(cf=1.25, E=8, K=3)
    router = np.asarray(jp["router"]).copy()
    if case == "uniform":
        router[:] = 0.0
    else:
        router[:, 5] = router[:, 2]
        router[:, 7] = router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    p = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    want_idx = _jax_route(cfg, jp, x)
    _, _, idx = moe._route(p, _t(x).reshape(-1, cfg.d_model), cfg)
    assert np.array_equal(idx.numpy(), want_idx)
    if case == "uniform":
        assert np.array_equal(want_idx, np.tile(np.arange(3), (48, 1)))
    else:   # every token that takes both of a tied pair lists 2 before 5
        both = [list(r) for r in want_idx if 2 in r and 5 in r]
        assert len(both) >= 3
        assert all(r.index(2) < r.index(5) for r in both)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    y, aux = moe.moe_apply(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL)
    assert abs(float(aux) - float(jaux)) < 1e-6


def test_capacity_overflow_drops_the_same_tokens_as_jax():
    """A capacity far under the load: a token's slot past an expert's
    capacity contributes zero, and the tokens dropped are the later ones
    in token order (the stable argsort), as in the JAX package."""
    cfg, jp, p, x = setup(cf=0.5)
    T, K, E = 48, cfg.experts_per_token, cfg.num_experts
    C = moe.capacity(cfg, T)
    disp, slot, w, counts, _ = moe._dispatch_group(
        p, _t(x).reshape(T, -1), cfg, C)
    assert int(counts.max()) > C                        # some expert overflows
    dropped = slot == E * C
    assert bool(dropped.any()) and bool((w[dropped] == 0).all())
    assert disp.shape == (E * C, cfg.d_model)
    # within each expert, the kept slots go to its earliest tokens
    idx = _jax_route(cfg, jp, x).reshape(T * K)
    for e in range(E):
        mine = np.flatnonzero(idx == e)
        kept = mine[:C]
        assert np.array_equal(np.sort(slot.numpy()[kept]),
                              e * C + np.arange(len(kept)))
        assert bool((slot.numpy()[mine[C:]] == E * C).all())
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    y, aux = moe.moe_apply(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL)
    assert abs(float(aux) - float(jaux)) < 1e-6
    # a dropped token's output is the sum over its kept experts only
    y_dense = moe.moe_dense_reference(p, _t(x), cfg)
    assert float((y - y_dense).abs().max()) > 1e-3


# ------------------------------------------------ expert counts (meta-able)
@pytest.mark.parametrize("case", ["random", "uniform", "duplicated_experts"])
def test_expert_counts_equal_bincount(case):
    """``expert_counts`` (an integer index_add_, which the meta device
    runs) gives bincount's int64 counts: over random expert ids with
    empty experts, and over the routing of tied router probabilities
    (every token on experts 0..K-1, and duplicated router columns)."""
    E = 8
    if case == "random":
        flat_e = torch.from_numpy(np.random.default_rng(3).integers(
            0, E - 2, size=97)).long()          # experts 6, 7 get none
    else:
        cfg, jp, _, x = setup(cf=1.25, E=E, K=3)
        router = np.asarray(jp["router"]).copy()
        if case == "uniform":
            router[:] = 0.0
        else:
            router[:, 5] = router[:, 2]
            router[:, 7] = router[:, 0]
        p = from_jax(jax.tree.map(np.asarray, dict(jp, router=router)),
                     "cpu")
        _, _, idx = moe._route(p, _t(x).reshape(-1, cfg.d_model), cfg)
        flat_e = idx.reshape(-1)
    got = moe.expert_counts(flat_e, E)
    want = torch.bincount(flat_e, minlength=E)
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    meta = moe.expert_counts(flat_e.to("meta"), E)
    assert meta.shape == want.shape and meta.dtype == torch.int64
