"""K5 (``digest_blocks``) and the pre-dump lane classifier on the CPU.

K5's plain version against the JAX package's digest-only sweep: the jitted
``repro.kernels.ckpt_codec.ops.digest_blocks`` (impl "jnp") and
``digest_blocks_pallas`` in interpret mode, at lengths 1, 16383, 16384,
16385 and 3 x 16384 + 7, in fp32 and bf16, with -0.0, denormals, +-inf and
NaN among the values. Bitwise throughout, folded digests included.

NaN payloads: fp32 payloads are covered (both packages digest the raw
bits). bf16 payloads are covered against numpy only: when XLA fuses the
zero padding with the bf16 -> fp32 widening it canonicalizes every bf16
NaN to 0x7FC0 (sign kept), so the JAX package digests a bf16 NaN's
payload away at ragged lengths; the port digests the raw bits, as the JAX
package does at whole-block lengths.

The classifier (core/predump.py): K5's two lanes plus the two mixed lanes
of the same pass, bound with dtype and shape. A one-element change at any
position changes the digest; so do changes uniform over a block, which
cancel in the raw lanes alone; equal content gives equal digests; and on a
mutation sequence its dirty/clean split equals blake2b's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ckpt_codec import ops as jops  # noqa: E402
from repro.kernels.ckpt_codec.ckpt_codec import \
    digest_blocks_pallas  # noqa: E402
from repro_torch.core.predump import (DirtyLeafTracker,  # noqa: E402
                                      digest_pairs, leaf_digest,
                                      tensor_digest)
from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref  # noqa: E402

B = ops.BLOCK
LENGTHS = [1, B - 1, B, B + 1, 3 * B + 7]
SPECIAL_F32 = [0x80000000, 0x00000001, 0x807FFFFF, 0x7F800000, 0xFF800000,
               0x7FC00000, 0x7F800001, 0xFFC00123]   # -0, denormals, inf, NaN
SPECIAL_BF16 = [0x8000, 0x0001, 0x807F, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0]


def _bits(n, dtype, seed):
    """Seeded bit patterns with the special values spread over the blocks
    (first, middle and last element of the leaf)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    if dtype == "float32":
        b = x.view(np.uint32).copy()
        specials = SPECIAL_F32
    else:
        b = (x.view(np.uint32) >> 16).astype(np.uint16)
        specials = SPECIAL_BF16
    pos = sorted({0, n // 2, n - 1} | set(range(1, min(n, len(specials)))))
    for k, p in enumerate(pos):
        b[p] = specials[k % len(specials)]
    return b


def _tensor(bits, dtype):
    if dtype == "float32":
        return torch.from_numpy(bits.view(np.float32).copy())
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _jax(bits, dtype):
    if dtype == "float32":
        return jnp.asarray(bits.view(np.float32))
    return jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)


def _u32(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t
                      ).view(np.uint32)


def _np_lanes(bits, dtype):
    """numpy oracle: lanes over the fp32 bit patterns, zero-padded."""
    u = bits.astype(np.uint32)
    if dtype == "bfloat16":
        u = u << np.uint32(16)
    nblk = max(1, -(-u.size // B))
    pad = np.zeros(nblk * B, np.uint32)
    pad[:u.size] = u
    w = np.asarray(jops.digest_weights(B))
    units = pad.reshape(nblk, B)
    return (np.sum(units * w[0], axis=1, dtype=np.uint32),
            np.sum(units * w[1], axis=1, dtype=np.uint32))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_digest_blocks_bit_identical_to_jax(n, dtype):
    bits = _bits(n, dtype, n)
    if dtype == "bfloat16":      # canonical NaNs only (see module doc)
        nan = (bits & 0x7F80) == 0x7F80
        nan &= (bits & 0x007F) != 0
        bits[nan] = (bits[nan] & 0x8000) | 0x7FC0
    h1, h2 = ops.digest_blocks(_tensor(bits, dtype))
    jx = _jax(bits, dtype)
    nblk = max(1, -(-n // B))
    assert h1.shape == (nblk,) and h1.dtype == torch.int32
    j1, j2 = jops.digest_blocks(jx, impl="jnp")
    xb = jnp.pad(jx, (0, nblk * B - n)).reshape(nblk, B)
    p1, p2 = digest_blocks_pallas(xb, jops.digest_weights(B), interpret=True)
    for want1, want2 in ((j1, j2), (p1, p2), _np_lanes(bits, dtype)):
        assert np.array_equal(_u32(h1), np.asarray(want1))
        assert np.array_equal(_u32(h2), np.asarray(want2))
    assert ops.fold_digest(h1.numpy(), h2.numpy(), n=n) == \
        jops.fold_digest(np.asarray(j1), np.asarray(j2), n=n)


@pytest.mark.parametrize("n", [B - 1, B])
def test_nan_payloads(n):
    """fp32 payloads: equal to the JAX package. bf16 payloads: the raw
    bits (numpy), which the JAX package matches at whole blocks only."""
    f = _bits(n, "float32", 3)
    f[5] = 0x7F800001
    f[6] = 0xFFC00123
    h1, _ = ops.digest_blocks(_tensor(f, "float32"))
    assert np.array_equal(_u32(h1), np.asarray(
        jops.digest_blocks(_jax(f, "float32"), impl="jnp")[0]))
    b = _bits(n, "bfloat16", 3)
    b[5] = 0x7F81
    b[6] = 0xFFC1
    h1, h2 = ops.digest_blocks(_tensor(b, "bfloat16"))
    n1, n2 = _np_lanes(b, "bfloat16")
    assert np.array_equal(_u32(h1), n1) and np.array_equal(_u32(h2), n2)
    j1 = np.asarray(jops.digest_blocks(_jax(b, "bfloat16"), impl="jnp")[0])
    assert np.array_equal(_u32(h1), j1) == (n % B == 0)


def test_mixed_lanes_match_numpy():
    """ref.mixed_lanes_ref against a numpy fmix32, on a ragged bf16 and an
    fp32 leaf."""
    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
    w = np.asarray(jops.digest_weights(B))
    for n, dtype in ((B + 5, "bfloat16"), (2 * B, "float32")):
        bits = _bits(n, dtype, 11)
        lanes = ops.classifier_lanes(_tensor(bits, dtype))
        u = bits.astype(np.uint32) << np.uint32(16 if dtype == "bfloat16"
                                                 else 0)
        nblk = -(-n // B)
        pad = np.zeros(nblk * B, np.uint32)
        pad[:n] = u
        m = fmix(pad.reshape(nblk, B) + w[0])
        assert lanes.shape == (4, nblk)
        assert np.array_equal(_u32(lanes[2]),
                              np.sum(m * w[0], axis=1, dtype=np.uint32))
        assert np.array_equal(_u32(lanes[3]),
                              np.sum(m * w[1], axis=1, dtype=np.uint32))
        h1, h2 = _np_lanes(bits, dtype)
        assert np.array_equal(_u32(lanes[0]), h1)
        assert np.array_equal(_u32(lanes[1]), h2)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ckpt_codec.reset_launches()
    ops.digest_blocks(torch.ones(100))
    ops.classifier_lanes(torch.ones(100, dtype=torch.bfloat16))
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 0
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.digest_blocks(torch.ones(10, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        ckpt_codec.digest_blocks(torch.empty(B, device="meta"),
                                 ops.digest_weights(B, "meta"))


# -------------------------------------------------------------- classifier
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_element_change_anywhere_is_caught(dtype):
    n = 3 * B + 7
    base = _tensor(_bits(n, dtype, 5), dtype)
    d0 = tensor_digest(base)
    assert tensor_digest(base.clone()) == d0
    for blk in range(4):
        lo, hi = blk * B, min(n, (blk + 1) * B) - 1
        for pos in (lo, (lo + hi) // 2, hi):
            t = base.clone()
            t[pos] = t[pos] + 1 if torch.isfinite(t[pos]) else 0.5
            assert tensor_digest(t) != d0, (blk, pos)


def test_sign_of_zero_dtype_and_shape_are_bound():
    z = torch.zeros(2 * B)
    m = z.clone()
    m[7] = -0.0
    assert tensor_digest(z) != tensor_digest(m)
    v = torch.randn(2 * B, generator=torch.Generator().manual_seed(0))
    vb = v.to(torch.bfloat16)
    assert tensor_digest(vb) != tensor_digest(vb.float())  # same fp32 bits
    assert np.array_equal(_u32(ops.digest_blocks(vb)[0]),
                          _u32(ops.digest_blocks(vb.float())[0]))
    assert tensor_digest(v) != tensor_digest(v.reshape(2, B))
    assert tensor_digest(v).startswith("pmac:")


@pytest.mark.parametrize("change", ["zeros->ones", "x->2x", "x->-x",
                                    "1.0->2.0", "two sign flips"])
def test_changes_uniform_over_a_block_are_caught(change):
    """The raw lanes alone miss these (shown): they are linear in the bits
    and the block's weight sums are divisible by 2^14, so a uniform bit
    change with >= 18 trailing zeros cancels. The mixed lanes catch them."""
    x = torch.randn(B, generator=torch.Generator().manual_seed(1))
    before, after = {
        "zeros->ones": (torch.zeros(B), torch.ones(B)),
        "x->2x": (x, 2 * x),
        "x->-x": (x, -x),
        "1.0->2.0": (torch.ones(B), torch.full((B,), 2.0)),
        "two sign flips": (x, x * torch.where(torch.arange(B) < 2, -1.0,
                                              1.0)),
    }[change]
    raw_b, raw_a = ops.digest_blocks(before), ops.digest_blocks(after)
    assert all(torch.equal(p, q) for p, q in zip(raw_b, raw_a))
    assert tensor_digest(before) != tensor_digest(after)


def _mutations(seed=3):
    rng = np.random.default_rng(seed)
    tree = {"a": torch.from_numpy(rng.standard_normal(B + 9)
                                  .astype(np.float32)),
            "b": torch.zeros(300, dtype=torch.bfloat16),
            "c": torch.ones(2 * B),
            "i": torch.arange(10, dtype=torch.int32)}
    yield tree
    for _ in range(8):
        tree = dict(tree)
        k = str(rng.choice(list(tree)))
        t = tree[k].clone()
        how = int(rng.integers(0, 4))
        if how == 0:
            t.view(-1)[int(rng.integers(0, t.numel()))] += 1
        elif how == 1:
            t = t * 2 if t.is_floating_point() else t + 1
        elif how == 2:
            t = -t
        tree[k] = t                 # how == 3: unchanged copy
        yield tree


def test_split_equals_blake2b_on_a_mutation_sequence():
    lanes, blake = DirtyLeafTracker(), DirtyLeafTracker()
    for i, tree in enumerate(_mutations()):
        pairs = sorted(tree.items())
        dl = digest_pairs(pairs)
        db = {p: leaf_digest(a) for p, a in pairs}
        assert lanes.split(dl) == blake.split(db), i
        recs = [{"path": p, "codec": "none", "codec_meta": {}}
                for p, _ in pairs]
        lanes.update(dl, recs, f"img{i}", pre_dump=True)
        blake.update(db, recs, f"img{i}", pre_dump=True)
    assert lanes.rounds == blake.rounds == 9


def test_digest_pairs_routes_leaves():
    pairs = [("f", torch.ones(4)), ("h", np.ones(4, np.float32)),
             ("i", torch.ones(4, dtype=torch.int64)),
             ("b", torch.ones(4, dtype=torch.bfloat16))]
    d = digest_pairs(pairs)
    assert list(d) == ["f", "h", "i", "b"]
    assert d["f"] == tensor_digest(pairs[0][1])
    assert d["b"] == tensor_digest(pairs[3][1])
    assert d["h"] == leaf_digest(pairs[1][1])
    assert d["i"] == leaf_digest(pairs[2][1])
    with pytest.raises(TypeError):
        tensor_digest(torch.ones(4, dtype=torch.int32))


def test_weights_are_the_jax_table():
    w = ops.digest_weights(B)
    assert np.array_equal(w.numpy().view(np.uint32),
                          np.asarray(jops.digest_weights(B)))
    assert torch.equal(torch.stack(ref.digest_blocks_ref(
        torch.zeros(1, B), w)), torch.zeros(2, 1, dtype=torch.int32))
