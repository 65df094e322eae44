"""repro_torch's recurrent blocks (models/ssm.py): the twins of
tests/test_ssm.py on the port (chunked forms against the sequential
oracles, prefill-state continuation, the long-decay and stabiliser cases),
and each ``*_apply``, ``*_apply_with_state`` and ``*_step`` against the JAX
package's on the same weights (``from_jax``) and the same numpy inputs.
Tolerances:

  * the twins keep tests/test_ssm.py's 5e-5;
  * fp32 against JAX: ``F32_RTOL`` = 1e-5 of the largest magnitude of each
    output or state leaf (the same math in float32, exponentials of
    cumulative sums and the chunk products summed in another order;
    measured worst ~5e-7 on the outputs; mLSTM's C and n grow to ~1e2);
  * bf16 against JAX: ``BF16_REL`` = 3e-2 of the largest |y| — the two
    packages round bf16 products and elementwise results at different
    places, and each is ~1-1.5% from its own fp32 output (measured worst
    between them 0.94%).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import params as jpm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

KINDS = ["mamba2", "mlstm", "slstm"]
F32_RTOL = 1e-5
BF16_REL = 3e-2


def _cfg(kind):
    if kind == "mamba2":
        return configs.get_tiny("zamba2-1.2b")
    return configs.get_tiny("xlstm-350m")


def _params_and_x(kind, S=64, B=2, seed=1):
    """(cfg, JAX params, port params, x as numpy [B, S, d] * 0.5)."""
    cfg = _cfg(kind)
    jp = jpm.init(getattr(jssm, f"{kind}_specs")(cfg), jax.random.PRNGKey(0))
    x = 0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu"), x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=F32_RTOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape, what
    tol = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _close_state(st, jst):
    assert set(st) == set(jst)
    for name, t in st.items():
        assert str(t.dtype).split(".")[-1] == str(jst[name].dtype), name
        _close(t, jst[name], what=name)


# ------------------------------------------------ twins of tests/test_ssm.py
@pytest.mark.parametrize("kind,chunk", [("mamba2", 16), ("mamba2", 64),
                                        ("mlstm", 16), ("mlstm", 32)])
def test_chunked_equals_sequential(kind, chunk):
    cfg, _, p, x = _params_and_x(kind)
    apply_fn = {"mamba2": ssm.mamba2_apply, "mlstm": ssm.mlstm_apply}[kind]
    ref_fn = {"mamba2": ssm.mamba2_ref, "mlstm": ssm.mlstm_ref}[kind]
    y = apply_fn(p, _t(x), cfg, chunk=chunk)
    y_ref = ref_fn(p, _t(x), cfg)
    assert float((y - y_ref).abs().max()) < 5e-5


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_state_continues_exactly(kind):
    """apply_with_state(prompt) then step(next) == apply(prompt+next)."""
    cfg, _, p, x = _params_and_x(kind, S=33)
    apply_ws = getattr(ssm, f"{kind}_apply_with_state")
    step = getattr(ssm, f"{kind}_step")
    full = {"mamba2": ssm.mamba2_ref, "mlstm": ssm.mlstm_ref,
            "slstm": ssm.slstm_apply}[kind](p, _t(x), cfg)
    y, state = apply_ws(p, _t(x[:, :-1]), cfg)
    y1, _ = step(p, _t(x[:, -1]), state, cfg)
    assert float((y1 - full[:, -1]).abs().max()) < 5e-5


def test_mamba2_decay_stability_long_sequence():
    cfg, _, p, x = _params_and_x("mamba2", S=256)
    y = ssm.mamba2_apply(p, _t(3.0 * x), cfg, chunk=64)
    assert bool(torch.isfinite(y).all())


def test_mlstm_gate_stabilizer_no_overflow():
    cfg, _, p, x = _params_and_x("mlstm", S=128)
    y = ssm.mlstm_apply(p, _t(5.0 * x), cfg, chunk=32)  # large gate pre-acts
    assert bool(torch.isfinite(y).all())


# ----------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("kind", KINDS)
def test_apply_matches_jax_fp32(kind):
    """The parallel form at S = 64 (mamba2 and mlstm in chunks of 16, so
    the state crosses 3 chunk boundaries) and at S = 37, a prime: chunks
    of one token, as ``_chunks`` picks them in both packages."""
    for S, chunk in ((64, 16), (37, 128)):
        cfg, jp, p, x = _params_and_x(kind, S=S)
        kw = {} if kind == "slstm" else {"chunk": chunk}
        want = getattr(jssm, f"{kind}_apply")(jp, jnp.asarray(x), cfg, **kw)
        got = getattr(ssm, f"{kind}_apply")(p, _t(x), cfg, **kw)
        _close(got, want, what=f"{kind} S={S}")
    assert ssm._chunks(37, 128) == jssm._chunks(37, 128) == 37
    assert ssm._chunks(37, 16) == jssm._chunks(37, 16) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_apply_with_state_matches_jax_fp32(kind):
    """Prefill: the output and every leaf of the final recurrent state
    (mamba2's h and conv tails, mlstm's C, n, m and conv tail, slstm's c,
    n, m, h), with their dtypes; a 2-token prompt pads the conv tails at
    the front in both."""
    for S in (33, 2):
        cfg, jp, p, x = _params_and_x(kind, S=S)
        jy, jst = getattr(jssm, f"{kind}_apply_with_state")(
            jp, jnp.asarray(x), cfg)
        y, st = getattr(ssm, f"{kind}_apply_with_state")(p, _t(x), cfg)
        _close(y, jy, what=f"{kind} y S={S}")
        _close_state(st, jax.tree.map(np.asarray, jst))


@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_jax_fp32(kind):
    """Decode: 4 steps from the JAX package's prefill state, each step's
    output and state against JAX's; and from the zero state
    (``*_init_state``: m at -1e30), which must equal JAX's init."""
    cfg, jp, p, x = _params_and_x(kind, S=24)
    jstep, step = getattr(jssm, f"{kind}_step"), getattr(ssm, f"{kind}_step")
    _, jst = getattr(jssm, f"{kind}_apply_with_state")(
        jp, jnp.asarray(x[:, :20]), cfg)
    st = {k: _t(np.array(v)) for k, v in jst.items()}
    for t in range(20, 24):
        jy, jst = jstep(jp, jnp.asarray(x[:, t]), jst, cfg)
        y, st = step(p, _t(x[:, t]), st, cfg)
        _close(y, jy, what=f"{kind} step {t}")
        _close_state(st, jax.tree.map(np.asarray, jst))
    jinit = jax.tree.map(np.asarray, getattr(jssm, f"{kind}_init_state")(
        cfg, 2, jnp.float32))
    init = getattr(ssm, f"{kind}_init_state")(cfg, 2, torch.float32, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in jinit.items()} == \
        {k: (tuple(v.shape), np.dtype(str(v.dtype).split(".")[-1]))
         for k, v in init.items()}
    for k, v in jinit.items():
        assert np.array_equal(init[k].numpy(), v), k
    jy, _ = jstep(jp, jnp.asarray(x[:, 0]), getattr(
        jssm, f"{kind}_init_state")(cfg, 2, jnp.float32), cfg)
    y, _ = step(p, _t(x[:, 0]), init, cfg)
    _close(y, jy, what=f"{kind} first step")


@pytest.mark.parametrize("kind", KINDS)
def test_apply_matches_jax_bf16(kind):
    """bf16 compute: the products JAX keeps in fp32
    (``preferred_element_type``) are fp32 here too, so the outputs agree
    to bf16 rounding; the state's fp32 leaves stay fp32."""
    cfg, jp, p, x = _params_and_x(kind, S=64)
    jy, jst = getattr(jssm, f"{kind}_apply_with_state")(
        jp, jnp.asarray(x, jnp.bfloat16), cfg)
    y, st = getattr(ssm, f"{kind}_apply_with_state")(
        p, _t(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    err = np.abs(y.float().numpy() - want).max()
    assert err < BF16_REL * np.abs(want).max(), err
    assert {k: str(v.dtype) for k, v in jst.items()} == \
        {k: str(v.dtype).split(".")[-1] for k, v in st.items()}


def test_mlstm_stabiliser_values_are_jax_s():
    """m starts at -1e30 (not -inf) in the chunked form's carry and the
    init state, so the first chunk's inter-chunk weight exp(F + m - m_row)
    is exactly 0, and exp(-m_row) may overflow to inf where a row's
    stabiliser is very negative: h is still finite and equals JAX's."""
    cfg, jp, p, x = _params_and_x("mlstm", S=32)
    init = ssm.mlstm_init_state(cfg, 2, torch.float32, "cpu")
    m0 = float(np.float32(-1e30))
    assert float(init["m"].max()) == float(init["m"].min()) == m0
    assert bool(ssm.slstm_init_state(cfg, 2)["m"].eq(m0).all())
    # a large negative input-gate bias drives m_row far below 0
    jp = dict(jp, b_i=jnp.full_like(jp["b_i"], -200.0))
    p = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    want = jssm.mlstm_apply(jp, jnp.asarray(x), cfg, chunk=8)
    got = ssm.mlstm_apply(p, _t(x), cfg, chunk=8)
    assert bool(torch.isfinite(got).all())
    _close(got, want, what="mlstm b_i=-200")
