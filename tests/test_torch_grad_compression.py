"""repro_torch's int8 error-feedback gradient compression
(``repro_torch.optim.compress``): the twins of
tests/test_grad_compression.py on tensors (inputs from seeded numpy), and
bitwise parity with the JAX package's codec.

The parity is with JAX *as it runs jitted* (``jax.jit(compress_leaf)``),
how a JAX train step runs it. XLA rewrites two operations of the jnp code
there, as it does in the checkpoint codec (tests/test_torch_ckpt_codec.py):
``amax / 127`` becomes ``amax * fl32(1/127)``, and the residual
``blocks - q * scale`` is contracted into one FMA, rounded once. The port
computes the rewritten forms; ``test_eager_jax_differs_only_by_the_two_
rewrites`` pins that the op-by-op JAX functions differ from them in these
two places and nowhere else."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compress as jc  # noqa: E402
from repro_torch.kernels.ckpt_codec.ref import _fma32  # noqa: E402
from repro_torch.optim.compress import (BLOCK, compress_leaf,  # noqa: E402
                                        compress_tree, decompress_leaf,
                                        decompress_tree, init_error_state,
                                        wire_bytes)

J_COMPRESS = jax.jit(jc.compress_leaf)
J_DECOMPRESS = jax.jit(jc.decompress_leaf, static_argnums=2)


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def test_roundtrip_error_bounded_and_fed_back():
    g = _normal(0, (1000,))
    err0 = torch.zeros_like(g)
    q, s, err = compress_leaf(g, err0)
    deq = decompress_leaf(q, s, g.shape)
    assert float((deq + err - g).abs().max()) < 1e-6  # exact decomposition
    assert float(err.abs().max()) <= float(s.max()) / 2 * 1.001


def test_error_feedback_reduces_accumulated_bias():
    """Averaging compressed grads over steps must converge to the true mean
    (unbiased to first order) — the signature property of error feedback."""
    g_true = _normal(1, (512,), 0.01)
    err = torch.zeros_like(g_true)
    acc_ef = torch.zeros_like(g_true)
    acc_plain = torch.zeros_like(g_true)
    n = 50
    for _ in range(n):
        q, s, err = compress_leaf(g_true, err)
        acc_ef += decompress_leaf(q, s, g_true.shape)
        q2, s2, _ = compress_leaf(g_true, torch.zeros_like(g_true))
        acc_plain += decompress_leaf(q2, s2, g_true.shape)
    bias_ef = float((acc_ef / n - g_true).abs().max())
    bias_plain = float((acc_plain / n - g_true).abs().max())
    assert bias_ef <= bias_plain + 1e-9
    assert bias_ef < float(s.max())  # residual bounded by one quantum


def test_tree_api_and_wire_ratio():
    # leaves >= one 4096 block (tiny leaves pay block-padding overhead)
    params = {"a": torch.zeros((300, 70)), "b": {"c": torch.zeros((8192,))}}
    grads = {"a": _normal(2, (300, 70)), "b": {"c": _normal(3, (8192,))}}
    err = init_error_state(params)
    comp, err2 = compress_tree(grads, err)
    out = decompress_tree(comp, params)
    raw = 4 * (300 * 70 + 8192)
    assert wire_bytes(comp) < raw / 3          # ~4x minus scale overhead
    for a, b in ((out["a"], grads["a"]), (out["b"]["c"], grads["b"]["c"])):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) < 0.1
    assert err2["a"].shape == (300, 70) and err2["b"]["c"].shape == (8192,)


def _case(seed, n):
    """Gradients over six decades (scales 1e-3..1e3 per element), a zero
    block (scale 0), an error state, as numpy fp32."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(
        np.float32)
    e = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    g[:min(n, BLOCK)] = 0.0
    e[:min(n, BLOCK)] = 0.0
    return g, e


@pytest.mark.parametrize("n", [BLOCK * 40 + 123, BLOCK * 3, 17],
                         ids=["ragged", "whole-blocks", "one-short-block"])
def test_bitwise_equal_to_jitted_jax(n):
    g, e = _case(n, n)
    qj, sj, ej = map(np.asarray, J_COMPRESS(jnp.asarray(g), jnp.asarray(e)))
    q, s, err = compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), qj)
    assert s.numpy().tobytes() == sj.tobytes()
    assert err.numpy().tobytes() == ej.tobytes()
    dj = np.asarray(J_DECOMPRESS(jnp.asarray(qj), jnp.asarray(sj), (n,)))
    assert decompress_leaf(q, s, (n,)).numpy().tobytes() == dj.tobytes()


def test_tree_error_state_bitwise_over_steps():
    """Three steps of error feedback on a two-leaf tree: the compressed
    pairs and the error state stay bitwise JAX's (jitted) at every step."""
    shapes = {"w": (130, 70), "b": {"c": (BLOCK + 5,)}}
    rng = np.random.default_rng(9)
    jerr = {"w": jnp.zeros(shapes["w"]), "b": {"c": jnp.zeros(shapes["b"]["c"])}}
    terr = init_error_state({"w": torch.zeros(shapes["w"]),
                             "b": {"c": torch.zeros(shapes["b"]["c"])}})
    for _ in range(3):
        gw = rng.standard_normal(shapes["w"]).astype(np.float32)
        gc = rng.standard_normal(shapes["b"]["c"]).astype(np.float32) * 1e-2
        jcomp, jerr = jax.jit(jc.compress_tree)(
            {"w": jnp.asarray(gw), "b": {"c": jnp.asarray(gc)}}, jerr)
        tcomp, terr = compress_tree({"w": torch.from_numpy(gw),
                                     "b": {"c": torch.from_numpy(gc)}}, terr)
        for (tq, ts), (jq, js) in ((tcomp["w"], jcomp["w"]),
                                   (tcomp["b"]["c"], jcomp["b"]["c"])):
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        for t, j in ((terr["w"], jerr["w"]), (terr["b"]["c"], jerr["b"]["c"])):
            assert t.numpy().tobytes() == np.asarray(j).tobytes()
        assert wire_bytes(tcomp) == jc.wire_bytes(jcomp)


def test_eager_jax_differs_only_by_the_two_rewrites():
    """Op by op, JAX divides by 127 and rounds the residual's product
    before subtracting. Its scales equal ``amax / 127`` and its residual
    ``blocks - fl(q * scale)``; the jitted form (the port's) differs from
    them, on this input in some scales and many residuals."""
    n = BLOCK * 40
    g, e = _case(5, n)
    qe, se, ee = map(np.asarray, jc.compress_leaf(jnp.asarray(g),
                                                  jnp.asarray(e)))
    q, s, err = compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    blocks = torch.from_numpy(g + e).reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1)
    div = torch.where(amax > 0, amax / 127.0, torch.zeros_like(amax))
    assert se.tobytes() == div.numpy().tobytes()
    assert (s.numpy() != se).any()                       # rewrite 1 shows
    qf = torch.from_numpy(qe.astype(np.float32))
    se_t = torch.from_numpy(se.copy())[:, None]
    plain = (blocks - qf * se_t).reshape(-1)
    assert ee.tobytes() == plain.numpy().tobytes()
    fused = _fma32(-qf, se_t.expand_as(qf), blocks).reshape(-1)
    assert (fused.numpy() != plain.numpy()).any()        # rewrite 2 shows
    # where both forms agree on the scale, the quantized values agree too
    same = s.numpy() == se
    np.testing.assert_array_equal(q.numpy()[same], qe[same])
