"""K5's grouped entry (``digest_blocks_many``) and its planning on the CPU.

The plan that lays a list of leaves out for one K5 launch (per-leaf block
counts, column offsets, the empty leaf's one zero block, the copy of a
misaligned view, the kernel's int64 leaf rows) is shared by both routes,
so it is tested here. The grouped lanes are held, leaf by leaf, to the JAX
package's digest-only sweep (``repro.kernels.ckpt_codec.ops.digest_blocks``,
jitted, impl "jnp") for h1/h2 and to the per-leaf plain
``ref.mixed_lanes_ref`` for g1/g2, bitwise; ``digest_pairs``, which now
makes one grouped call per device, gives the strings of the per-leaf
route character for character.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.ckpt_codec import ops as jops  # noqa: E402
from repro_torch.core.predump import (_lane_string, digest_pairs,  # noqa: E402
                                      lane_strings, tensor_digest)
from repro_torch.device import dtype_name  # noqa: E402
from repro_torch.kernels.ckpt_codec import ckpt_codec, ops, ref  # noqa: E402

B = ops.BLOCK


def _leaves(seed, sizes, bf16_every=3):
    """Seeded flat leaves from numpy; every third one bf16; a view that
    starts one element in (misaligned) at index 3 when there is one."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
        if i % bf16_every == bf16_every - 1:
            x = x.to(torch.bfloat16)
        out.append(x[1:] if i == 3 else x[:n].clone())
    return out


SIZES = [3 * B + 7, 0, 5, B, 4096, 2 * B + 9, 1000, B + 1]


def test_plan_lays_out_columns_and_blocks():
    leaves = _leaves(0, SIZES)
    plan = ckpt_codec.plan_digest(leaves, B)
    want_k = [max(1, -(-n // B)) for n in SIZES]
    assert [k for _, k in plan.cols] == want_k == [4, 1, 1, 1, 1, 3, 1, 2]
    assert [c for c, _ in plan.cols] == list(np.cumsum([0] + want_k[:-1]))
    assert plan.total == sum(want_k) and plan.blk == B
    for x, y in zip(leaves, plan.leaves):
        assert y.is_contiguous() and y.data_ptr() % 16 == 0
        assert y.dtype == x.dtype and torch.equal(y.reshape(-1),
                                                  x.reshape(-1))
    assert leaves[3].data_ptr() % 16            # the misaligned view ...
    assert plan.leaves[3].data_ptr() != leaves[3].data_ptr()   # ... copied
    assert plan.leaves[0].data_ptr() == leaves[0].data_ptr()   # others not


def test_plan_flattens_any_shape_and_refuses_other_dtypes():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    plan = ckpt_codec.plan_digest([x, x[:, 1]], B)
    assert plan.leaves[0] is x                   # contiguous: taken as is
    assert plan.leaves[1].is_contiguous()        # a strided view: copied
    assert torch.equal(plan.leaves[1], x[:, 1])
    assert [y.numel() for y in plan.leaves] == [24, 8]
    lanes = ckpt_codec.digest_blocks_many(plan, ops.digest_weights(B))
    assert torch.equal(lanes[:, 1:], ckpt_codec.digest_blocks(
        x[:, 1].reshape(-1).clone(), ops.digest_weights(B)))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ckpt_codec.plan_digest([x, x.double()], B)


def test_leaf_rows_hold_pointer_dtype_length_and_column():
    leaves = _leaves(1, SIZES)
    plan = ckpt_codec.plan_digest(leaves, B)
    rows = ckpt_codec.leaf_rows(plan)
    assert rows.dtype == np.int64 and rows.shape == (len(SIZES), 3)
    for (p, n, c), y, (c0, _) in zip(rows, plan.leaves, plan.cols):
        assert p & ~1 == y.data_ptr() and (p & 1) == (y.dtype ==
                                                      torch.bfloat16)
        assert n == y.numel() and c == c0


def _jax_h(x):
    """The JAX package's digest-only sweep of one flat torch leaf."""
    f32 = x.dtype == torch.float32
    bits = jnp.asarray(x.view(torch.int32 if f32 else torch.int16).numpy())
    jx = jax.lax.bitcast_convert_type(bits, jnp.float32 if f32
                                      else jnp.bfloat16)
    h1, h2 = jops.digest_blocks(jx, impl="jnp")
    return np.asarray(h1), np.asarray(h2)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed,sizes", [
    (2, SIZES),
    (3, [7] * 5 + [B - 1, 2 * B]),               # one-block leaves
    (4, [0]),                                    # a lone empty leaf
    (5, [B + 3, 9, 0, 2 * B, 17, 33, B - 1])])   # mixed, ragged
def test_grouped_lanes_equal_jax_and_the_plain_mixed_lanes(seed, sizes):
    leaves = _leaves(seed, sizes)
    w = ops.digest_weights(B)
    plan = ckpt_codec.plan_digest(leaves, B)
    lanes = ckpt_codec.digest_blocks_many(plan, w)
    assert lanes.shape == (4, plan.total) and lanes.dtype == torch.int32
    for x, (c, k) in zip(leaves, plan.cols):
        got = lanes[:, c:c + k]
        j1, j2 = _jax_h(x.reshape(-1))
        assert np.array_equal(_u32(got[0]), j1)
        assert np.array_equal(_u32(got[1]), j2)
        xb = F.pad(x.reshape(-1), (0, k * B - x.numel())).reshape(k, B)
        g1, g2 = ref.mixed_lanes_ref(xb, w)
        assert torch.equal(got[2], g1) and torch.equal(got[3], g2)
        assert torch.equal(got, ckpt_codec.digest_blocks(x, w))


def test_one_leaf_wrappers_are_the_grouped_case():
    x = _leaves(6, [2 * B + 9])[0]
    w = ops.digest_weights(B)
    many = ckpt_codec.digest_blocks_many([x], w)
    assert torch.equal(ckpt_codec.digest_blocks(x, w), many)
    assert torch.equal(ops.classifier_lanes(x), many)
    h1, h2 = ops.digest_blocks(x)
    assert torch.equal(h1, many[0]) and torch.equal(h2, many[1])
    lanes, cols = ops.classifier_lanes_many([x, x])
    assert cols == ((0, 3), (3, 3))
    assert torch.equal(lanes, torch.cat([many, many], dim=1))


def _per_leaf_route(pairs):
    """digest_pairs as it was: one classifier_lanes call a leaf, the lanes
    joined and cut back by length."""
    items = [(p, a, ops.classifier_lanes(a.detach().reshape(-1)))
             for p, a in pairs]
    flat = torch.cat([ln.reshape(-1) for _, _, ln in items]).numpy()
    out, off = {}, 0
    for p, a, ln in items:
        k = ln.numel()
        out[p] = _lane_string(dtype_name(a), tuple(a.shape),
                              flat[off:off + k])
        off += k
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_digest_pairs_equals_the_per_leaf_route(seed):
    leaves = _leaves(seed, SIZES)
    pairs = [(f"tree/l{i}", x.reshape(2, -1) if x.numel() % 2 == 0 else x)
             for i, x in enumerate(leaves)]
    pairs.insert(2, ("step", torch.tensor(5, dtype=torch.int32)))
    d = digest_pairs(pairs)
    lane_pairs = [(p, a) for p, a in pairs if a.dtype != torch.int32]
    assert {p: d[p] for p, _ in lane_pairs} == _per_leaf_route(lane_pairs)
    assert all(d[p] == tensor_digest(a) for p, a in lane_pairs)
    lanes, cols = ops.classifier_lanes_many([a for _, a in lane_pairs])
    assert lane_strings(lane_pairs, lanes.numpy(), cols) == \
        _per_leaf_route(lane_pairs)


def test_cpu_route_counts_nothing_and_refuses_what_the_card_would():
    ckpt_codec.reset_launches()
    w = ops.digest_weights(B)
    ckpt_codec.digest_blocks_many(_leaves(9, [5, B]), w)
    digest_pairs([("a", torch.ones(3)), ("b", torch.ones(4,
                                                         dtype=torch.bfloat16))])
    assert ckpt_codec.LAUNCHES["digest_blocks"] == 0
    assert ckpt_codec.LEAVES["digest_blocks"] == 0
    with pytest.raises(ValueError, match="no leaves"):
        ckpt_codec.digest_blocks_many([], w)
    with pytest.raises(ValueError, match="devices"):
        ckpt_codec.digest_blocks_many([torch.ones(3),
                                       torch.ones(3, device="meta")], w)
    with pytest.raises(ValueError, match="CUDA"):
        ckpt_codec.digest_blocks_many([torch.ones(3, device="meta")],
                                      ops.digest_weights(B, "meta"))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ckpt_codec.digest_blocks_many([torch.ones(3, dtype=torch.int32)], w)
