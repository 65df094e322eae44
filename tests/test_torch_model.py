"""repro_torch model, optimizer and train state vs the JAX package, on
qwen3-8b ``tiny()`` with the JAX package's weights carried across by
``from_jax``. Tolerances:

  * fp32 compute: 1e-5 — the same math in float32, summed in another order;
  * bf16 compute: loss within 1e-2 — XLA and torch round bf16 matmul outputs
    and elementwise results at different places (one bf16 ulp is 2^-8);
  * AdamW on shared fp32 grads: params, m and v within ``OPT_REL`` = 1e-6
    of each leaf's largest magnitude — the same formulas in the same fp32
    order, but the global norm is summed in another order, which moves the
    clip scale by an ulp, and m = b1 * m + (1 - b1) * g cancels where the
    two steps' grads differ in sign (measured worst: 2.5e-7);
  * AdamW inside a bf16 train step, at lr 1e-2 with no warmup so that each
    step moves every parameter by ~lr: per-leaf relative L2 error of the
    parameter change, m and v within ``STEP_REL`` = 0.3. The bf16 forwards
    give gradients that differ by a few percent, and an Adam step moves a
    parameter by ~lr * sign(grad), so a near-zero gradient whose sign
    differs moves it by up to 2 * lr (measured worst on this config: 0.175
    for ``embed/tok``'s change, 0.074 for m and v). An optimizer that does
    nothing scores 1.0 on every leaf; b2 = 0.999 in place of 0.95 scores
    0.98 on every leaf of v. Both are checked below."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, get_tiny  # noqa: E402
from repro.core.dump import flatten_with_paths as jflatten  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro.optim import adamw_update as jadamw  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import warmup_cosine as jcosine  # noqa: E402
from repro.training.train_loop import abstract_train_state as jabstract  # noqa: E402
from repro.training.train_loop import init_train_state as jinit  # noqa: E402
from repro.training.train_loop import make_train_step as jmake  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.dump import flatten_with_paths  # noqa: E402
from repro_torch.device import dtype_name  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.optim import (OptConfig, adamw_update,  # noqa: E402
                               clip_by_global_norm, warmup_cosine)
from repro_torch.training import (abstract_train_state,  # noqa: E402
                                  init_train_state, make_train_step)


@pytest.fixture(scope="module")
def pair():
    cfg = get_tiny("qwen3-8b")
    jlm = JLM(cfg)
    jstate = jinit(jlm, jax.random.PRNGKey(0))
    tlm = LM(tconfigs.get_tiny("qwen3-8b"))
    params = from_jax(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    return cfg, jlm, jstate, tlm, params


def _tokens(cfg, seed, shape=(2, 32)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_abstract_train_state_matches_jax_full_width():
    """The state layout is the image contract: same leaf paths, shapes and
    dtypes as repro's abstract_train_state for the full qwen3-8b config."""
    want = [(p, tuple(a.shape), str(np.dtype(a.dtype)))
            for p, a in jflatten(jabstract(JLM(get_config("qwen3-8b"))))]
    st = abstract_train_state(LM(tconfigs.get_config("qwen3-8b")))
    got = [(p, tuple(t.shape), dtype_name(t))
           for p, t in flatten_with_paths(st)]
    assert got == want
    assert all(t.device.type == "meta" for _, t in flatten_with_paths(st))


@pytest.mark.parametrize("arch_cfg", ["tiny", "full"])
def test_param_counts_match(arch_cfg):
    get = get_tiny if arch_cfg == "tiny" else get_config
    tget = tconfigs.get_tiny if arch_cfg == "tiny" else tconfigs.get_config
    assert LM(tget("qwen3-8b")).n_params() == JLM(get("qwen3-8b")).n_params()


def test_init_is_seeded_and_shaped(pair):
    cfg, _, jstate, tlm, _ = pair
    s1 = init_train_state(tlm, torch.Generator().manual_seed(5), device="cpu")
    s2 = init_train_state(tlm, torch.Generator().manual_seed(5), device="cpu")
    f1, f2 = flatten_with_paths(s1), flatten_with_paths(s2)
    want = jflatten(jax.tree.map(np.asarray, jstate))
    assert [(p, tuple(t.shape)) for p, t in f1] == \
        [(p, tuple(a.shape)) for p, a in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(f1, f2))
    tok = s1["params"]["embed"]["tok"]
    assert abs(float(tok.std()) - cfg.d_model ** -0.5) < 0.01
    assert s1["step"].dtype == torch.int32 and s1["step"].shape == ()


def test_layers_match_fp32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                           1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5)


@pytest.mark.parametrize("chunks", [(512, 1024), (8, 8), (16, 8)])
def test_flash_attention_matches_fp32(chunks):
    """GQA, causal, and online softmax across several kv chunks."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    cq, ckv = chunks
    got = tattn.xla_flash(*(torch.from_numpy(a) for a in (q, k, v)),
                          chunk_q=cq, chunk_kv=ckv).numpy()
    want = np.asarray(jattn.xla_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                      chunk_q=cq, chunk_kv=ckv))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_hidden_states_fp32(pair):
    cfg, jlm, jstate, tlm, params = pair
    toks = _tokens(cfg, 0)
    hj, _, _ = jlm.forward(jstate["params"], tokens=jnp.asarray(toks),
                           compute_dtype=jnp.float32)
    ht, _ = tlm.forward(params, tokens=torch.from_numpy(toks).long(),
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)


def test_loss_bf16(pair):
    cfg, jlm, jstate, tlm, params = pair
    toks = _tokens(cfg, 1)
    lj, _ = jlm.loss(jstate["params"], {"tokens": jnp.asarray(toks)})
    lt, _ = tlm.loss(params, {"tokens": torch.from_numpy(toks).long()})
    assert lt.dtype == torch.float32
    assert abs(float(lj) - float(lt)) < 1e-2


OPT_REL = 1e-6
STEP_REL = 0.3
FAST = dict(lr=1e-2, warmup_steps=0)


def _rel_err(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _opt_tree(seed):
    """A small nested params tree and two steps of grads, from numpy."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        def leaf(*shape):
            return rng.standard_normal(shape).astype(np.float32) * scale
        return {"a": leaf(64, 32), "b": {"c": leaf(16), "d": leaf(8, 4, 4)}}
    # the first step's grads have global norm ~48 (clipped to 1), the
    # second's ~0.5 (not clipped)
    return tree(0.02), [tree(1.0), tree(0.01)]


def _adamw_jax(params, grads_seq, cfg):
    p = jax.tree.map(jnp.asarray, params)
    opt = {"m": jax.tree.map(jnp.zeros_like, p),
           "v": jax.tree.map(jnp.zeros_like, p)}
    for i, g in enumerate(grads_seq):
        step = jnp.asarray(i + 1, jnp.int32)
        g, _ = jclip(jax.tree.map(jnp.asarray, g), cfg.clip_norm)
        lr = jcosine(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)
        p, opt = jadamw(g, opt, p, step, cfg, lr=lr)
    return dict(jflatten(jax.tree.map(np.asarray,
                                      {"params": p, "opt": opt})))


def test_adamw_update_matches_jax_fp32():
    """clip_by_global_norm + adamw_update + warmup_cosine on the same fp32
    grads, two steps: params, m and v agree with the JAX package's within
    OPT_REL. A no-op update and a wrong b2 both fail the same check."""
    params, grads_seq = _opt_tree(0)
    want = _adamw_jax(params, grads_seq, JOpt(**FAST))
    cfg = OptConfig(**FAST)
    p = from_jax(params, "cpu")
    opt = {"m": from_jax(jax.tree.map(np.zeros_like, params), "cpu"),
           "v": from_jax(jax.tree.map(np.zeros_like, params), "cpu")}
    for i, g in enumerate(grads_seq):
        step = torch.tensor(i + 1, dtype=torch.int32)
        g, _ = clip_by_global_norm(from_jax(g, "cpu"), cfg.clip_norm)
        lr = warmup_cosine(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)
        adamw_update(g, opt, p, step, cfg, lr=lr)
    got = {q: t.numpy() for q, t in
           flatten_with_paths({"params": p, "opt": opt})}

    def mismatched(tree):
        return [q for q in want if np.abs(tree[q] - want[q]).max()
                > OPT_REL * np.abs(want[q]).max()]
    assert mismatched(got) == []
    noop = dict(jflatten({"params": params,
                          "opt": {"m": jax.tree.map(np.zeros_like, params),
                                  "v": jax.tree.map(np.zeros_like, params)}}))
    assert len(mismatched(noop)) == len(want)
    wrong_b2 = _adamw_jax(params, grads_seq, JOpt(b2=0.999, **FAST))
    assert {q for q in want if q.startswith("opt/v/")} <= \
        set(mismatched(wrong_b2))


def test_params_after_two_adamw_steps(pair):
    """Two bf16 train steps at lr 1e-2, no warmup: the parameter change, m
    and v match the JAX package's within STEP_REL per leaf; a no-op
    optimizer and the port run with b2 = 0.999 do not."""
    cfg, jlm, jstate, tlm, _ = pair
    step_j = jax.jit(jmake(jlm, JOpt(**FAST)))
    host = jax.tree.map(np.asarray, jstate)
    before = dict(jflatten(host))

    def run_port(opt_cfg):
        step_t = make_train_step(tlm, opt_cfg)
        st = {"params": from_jax(host["params"], "cpu"),
              "opt": from_jax(host["opt"], "cpu"),
              "step": torch.zeros((), dtype=torch.int32)}
        out = []
        for i in range(2):
            st, tm = step_t(st, {"tokens": torch.from_numpy(
                _tokens(cfg, 10 + i)).long()})
            out.append(tm)
        return st, out

    tstate, tms = run_port(OptConfig(**FAST))
    js = jstate
    for i in range(2):
        js, jm = step_j(js, {"tokens": jnp.asarray(_tokens(cfg, 10 + i))})
        assert abs(float(jm["loss"]) - float(tms[i]["loss"])) < 1e-2
        assert float(jm["lr"]) == float(tms[i]["lr"]) > 0.0099
    assert int(tstate["step"]) == 2 and tstate["step"].dtype == torch.int32
    want = dict(jflatten(jax.tree.map(np.asarray, js)))

    def errors(st):
        got = {p: t.numpy() for p, t in flatten_with_paths(st)}
        return {p: (_rel_err(got[p] - before[p], want[p] - before[p])
                    if p.startswith("params/") else _rel_err(got[p], want[p]))
                for p in want if p != "step"}

    errs = errors(tstate)
    assert max(errs.values()) < STEP_REL, max(errs.items(), key=lambda e: e[1])
    noop = {"params": from_jax(host["params"], "cpu"),
            "opt": from_jax(host["opt"], "cpu")}
    assert all(e > 0.9 for e in errors(noop).values())
    wrong, _ = run_port(OptConfig(b2=0.999, **FAST))
    assert all(e > STEP_REL for p, e in errors(wrong).items()
               if p.startswith("opt/v/"))
