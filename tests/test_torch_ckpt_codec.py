"""repro_torch codec plain versions vs the JAX package's codec: bit-identical
outputs over the cases of tests/test_kernels_codec.py, ragged flat lengths,
clean blocks and folded digest strings.

The reference is ``repro.kernels.ckpt_codec.ref`` as the JAX package runs
it — jitted — and the Pallas kernels in interpret mode. Jitted, XLA turns
``amax / 127`` into ``amax * fl32(1/127)`` and contracts the decode
``prev + q*scale`` into one FMA; the op-by-op (eager) ref does neither.
The port follows the jitted form, which is what the JAX package's images
and restores contain; ``test_eager_ref_differs_only_by_xla_rewrites`` pins
down that this is the only difference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ckpt_codec import ops as jops  # noqa: E402
from repro.kernels.ckpt_codec import ref as jref  # noqa: E402
from repro.kernels.ckpt_codec.ckpt_codec import (  # noqa: E402
    bf16_encode_digest_pallas, delta_decode_pallas,
    delta_encode_digest_pallas, delta_encode_pallas)
from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref  # noqa: E402

CASES = [(3, 256), (1, 128), (8, 512)]
jit_encode = jax.jit(jref.delta_encode_ref)
jit_decode = jax.jit(jref.delta_decode_ref)
jit_encode_digest = jax.jit(jref.delta_encode_digest_ref)
jit_bf16_digest = jax.jit(jref.bf16_encode_digest_ref)


def _u8(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _bits(t):
    """torch tensor or jax/numpy array -> numpy bytes (bitwise compare)."""
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return _u8(t.numpy())
    a = np.asarray(t)
    if str(a.dtype) == "bfloat16":
        a = np.asarray(jax.lax.bitcast_convert_type(t, jnp.uint16))
    return _u8(a)


def _inputs(nblk, blk, seed, clean_rows=(0,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nblk, blk)).astype(np.float32)
    prev = (x + 0.01 * rng.standard_normal((nblk, blk))).astype(np.float32)
    for r in clean_rows:
        if r < nblk:
            prev[r] = x[r]
    return x, prev


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_weight_table_matches():
    for blk in (128, 16384):
        w = ops.digest_weights(blk).numpy().view(np.uint32)
        np.testing.assert_array_equal(w, np.asarray(jops.digest_weights(blk)))


@pytest.mark.parametrize("nblk,blk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_encode_decode_bit_identical(nblk, blk, dtype):
    x, prev = _inputs(nblk, blk, nblk * blk)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jp = jnp.asarray(x, jdt), jnp.asarray(prev, jdt)
    tx, tp = _t(x).to(tdt), _t(prev).to(tdt)
    got = ref.delta_encode_ref(tx, tp)
    for want in (jit_encode(jx, jp),
                 delta_encode_pallas(jx, jp, interpret=True)):
        for g, w in zip(got, want):
            assert _bits(g).tobytes() == _bits(w).tobytes()
    q, s, _ = got
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    dec = ref.delta_decode_ref(q, s, tp)
    for want in (jit_decode(jq, js, jp),
                 delta_decode_pallas(jq, js, jp, interpret=True)):
        assert _bits(dec).tobytes() == _bits(want).tobytes()
    if dtype == "float32":
        flat = jops.delta_decode(jq, js, jp.reshape(-1))
        assert _bits(dec.reshape(-1)).tobytes() == _bits(flat).tobytes()


@pytest.mark.parametrize("nblk,blk", CASES)
def test_eager_ref_differs_only_by_xla_rewrites(nblk, blk):
    """Run op by op, the JAX ref divides by 127 and rounds the decode twice.
    The port's formulas with exactly those two changes give its bits."""
    x, prev = _inputs(nblk, blk, 7 + nblk)
    jq, js, _ = jref.delta_encode_ref(jnp.asarray(x), jnp.asarray(prev))
    d = x - prev
    amax = np.abs(d).max(axis=1)
    np.testing.assert_array_equal(np.asarray(js), amax / np.float32(127))
    _, s, _ = ref.delta_encode_ref(_t(x), _t(prev))
    np.testing.assert_array_equal(s.numpy(),
                                  amax * (np.float32(1) / np.float32(127)))
    eager = np.asarray(jref.delta_decode_ref(jq, js, jnp.asarray(prev)))
    twice = prev + np.asarray(jq).astype(np.float32) * np.asarray(js)[:, None]
    np.testing.assert_array_equal(eager.view(np.uint32), twice.view(np.uint32))


def test_fma32_is_rounded_once():
    """ref._fma32 against long double, which holds these sums exactly,
    on products placed just around half an ulp of c: the float64 route
    alone rounds twice on some of them."""
    if np.finfo(np.longdouble).nmant < 63:
        pytest.skip("needs an 80-bit long double to hold the exact sums")
    qs, ss, cs = [], [], []
    for q in range(-127, 128, 3):
        for e in range(-2, 8):
            base = np.float32((2.0 ** e) / q)
            for s in (np.nextafter(base, np.float32(-np.inf)), base,
                      np.nextafter(base, np.float32(np.inf))):
                for c in (2.0 ** 30, -2.0 ** 30, 3 * 2.0 ** 29):
                    qs.append(q)
                    ss.append(s)
                    cs.append(c)
    q, s, c = (np.array(v, np.float32) for v in (qs, ss, cs))
    L = np.longdouble
    exact = (q.astype(L) * s.astype(L) + c.astype(L)).astype(np.float32)
    naive = (q.astype(np.float64) * s + c).astype(np.float32)
    assert (naive != exact).sum() > 0
    got = ref._fma32(_t(q), _t(s), _t(c)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), exact.view(np.uint32))


@pytest.mark.parametrize("nblk,blk", CASES)
def test_fused_delta_digest_bit_identical(nblk, blk):
    x, prev = _inputs(nblk, blk, 100 + nblk)
    w = ops.digest_weights(blk)
    got = ckpt_codec.delta_encode_digest(_t(x), _t(prev), w)
    jw = jops.digest_weights(blk)
    for want in (jit_encode_digest(jnp.asarray(x), jnp.asarray(prev), jw),
                 delta_encode_digest_pallas(jnp.asarray(x), jnp.asarray(prev), jw,
                                            interpret=True)):
        for g, wv in zip(got, want):
            assert _bits(g).tobytes() == _bits(wv).tobytes()
    q, s, d, h1, h2 = got
    assert not bool(d[0]) and int(h1[0]) == 0 and int(h2[0]) == 0


@pytest.mark.parametrize("nblk,blk", CASES)
def test_fused_bf16_digest_bit_identical(nblk, blk):
    x, _ = _inputs(nblk, blk, 200 + nblk)
    got = ckpt_codec.bf16_encode_digest(_t(x), ops.digest_weights(blk))
    jw = jops.digest_weights(blk)
    for want in (jit_bf16_digest(jnp.asarray(x), jw),
                 bf16_encode_digest_pallas(jnp.asarray(x), jw, interpret=True)):
        for g, wv in zip(got, want):
            assert _bits(g).tobytes() == _bits(wv).tobytes()


@pytest.mark.parametrize("n", [1, 100, 257, 1000, 16384, 20000])
def test_ragged_lengths_and_fold_digest(n):
    """Padded flat lengths: the port's ops give the JAX ops' bytes, and the
    folded leaf digest is the same hex string in both packages and is
    re-derived by payload_digest from the stored bytes alone."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    prev = x + rng.standard_normal(n).astype(np.float32) * 0.1
    got = ops.delta_encode_digest(_t(x), _t(prev))
    want = jops.delta_encode_digest(jnp.asarray(x), jnp.asarray(prev))
    for g, w in zip(got, want):
        assert _bits(g).tobytes() == _bits(w).tobytes()
    q, s, _d, h1, h2 = (g.numpy() for g in got)
    dig = ops.fold_digest(h1, h2, scale_bits=s, n=n)
    jq, js, _jd, jh1, jh2 = (np.asarray(a) for a in want)
    assert dig == jops.fold_digest(jh1, jh2, scale_bits=js, n=n)
    stored = np.concatenate([s.view(np.int8).reshape(-1), q.reshape(-1)])
    meta = {"block": ops.BLOCK, "nblk": int(q.shape[0]), "orig_shape": [n]}
    assert ops.payload_digest(stored, "delta8", meta) == dig
    assert jops.payload_digest(stored, "delta8", meta) == dig

    y, b1, b2 = ops.bf16_encode_digest(_t(x))
    jy, jb1, jb2 = jops.bf16_encode_digest(jnp.asarray(x))
    assert _bits(y).tobytes() == _bits(jy).tobytes()
    bdig = ops.fold_digest(b1.numpy(), b2.numpy(), n=n)
    assert bdig == jops.fold_digest(np.asarray(jb1), np.asarray(jb2), n=n)
    ybits = y.view(torch.int16).numpy().reshape(-1)[:n].view(np.uint16)
    assert ops.payload_digest(ybits, "bf16", {}) == bdig


def test_clean_blocks_exact_and_flagged():
    x = torch.ones((4, 64))
    prev = x.clone()
    prev[2] += 0.5
    q, s, d = ref.delta_encode_ref(x, prev)
    assert d.tolist() == [False, False, True, False]
    out = ref.delta_decode_ref(q, s, prev)
    assert bool((out[[0, 1, 3]] == 1.0).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_digest_strings_match(seed):
    rng = np.random.default_rng(seed)
    nblk = int(rng.integers(1, 40))
    h1 = rng.integers(0, 2 ** 32, nblk, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2 ** 32, nblk, dtype=np.uint64).astype(np.uint32)
    s = rng.standard_normal(nblk).astype(np.float32)
    n = int(rng.integers(1, 10 ** 6))
    assert ops.fold_digest(h1, h2, n=n) == jops.fold_digest(h1, h2, n=n)
    assert (ops.fold_digest(h1.view(np.int32), h2.view(np.int32),
                            scale_bits=s, n=n)
            == jops.fold_digest(h1, h2, scale_bits=s, n=n))


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ckpt_codec.reset_launches()
    x, prev = _inputs(2, 128, 3)
    ckpt_codec.delta_encode(_t(x), _t(prev))
    ckpt_codec.delta_decode(torch.zeros((2, 128), dtype=torch.int8),
                            torch.zeros(2), _t(prev))
    assert all(v == 0 for v in ckpt_codec.LAUNCHES.values())


def test_non_cpu_tensor_never_reaches_the_plain_version():
    x = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ckpt_codec.delta_encode(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        ckpt_codec.bf16_encode_digest(x, ops.digest_weights(128, "meta"))
