"""Property-based tests (hypothesis) of the port's C/R invariants: the
twin of tests/test_checkpoint_properties.py (all 4), on torch tensors with
``device="cpu"``. The codec property runs K4/K3's wrappers on CPU
tensors (their plain versions) and holds them, bit for bit, to the JAX
package's codec as it runs, jitted — not to ``ref.py`` run op by op,
whose scale and decode XLA rewrites once jitted (ROADMAP §3, "XLA
rewrites the codec's arithmetic")."""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline image: seeded fixed-example fallback
    from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core import chunking  # noqa: E402
from repro_torch.core.dump import dump  # noqa: E402
from repro_torch.core.restore import restore  # noqa: E402
from repro_torch.core.storage import MemoryTier  # noqa: E402
from repro_torch.kernels.ckpt_codec import ckpt_codec  # noqa: E402

settings.register_profile("ci", max_examples=25, deadline=None)
settings.load_profile("ci")

CPU = "cpu"


@given(st.binary(min_size=0, max_size=5000),
       st.integers(min_value=16, max_value=512))
def test_chunk_split_assemble_identity(data, chunk_bytes):
    chunks = chunking.split_chunks(data, chunk_bytes)
    assert b"".join(d for _, d in chunks) == data
    assert all(len(d) <= chunk_bytes for _, d in chunks)


_dtypes = st.sampled_from([np.float32, np.int32, np.uint8, np.float16])


@given(st.lists(st.tuples(
    st.text(alphabet="abcdefgh", min_size=1, max_size=4),
    st.integers(min_value=1, max_value=64),
    _dtypes), min_size=1, max_size=5, unique_by=lambda t: t[0]),
    st.integers(min_value=0, max_value=2**31 - 1))
def test_dump_restore_roundtrip_random_trees(spec, seed):
    rng = np.random.default_rng(seed)
    tree = {}
    for name, n, dt in spec:
        arr = (rng.standard_normal(n) * 100).astype(dt)
        tree[name] = torch.from_numpy(arr)
    tier = MemoryTier()
    dump(tree, tier, step=1, chunk_bytes=64, device=CPU)
    got, _ = restore(tier, device=CPU)
    for name in tree:
        a, b = tree[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


_jit = {}


def _jax_codec():
    """The JAX package's codec, jitted as every repro path runs it."""
    if not _jit:
        import jax

        from repro.kernels.ckpt_codec import ref as jref
        _jit["encode"] = jax.jit(jref.delta_encode_ref)
        _jit["decode"] = jax.jit(jref.delta_decode_ref)
    return _jit["encode"], _jit["decode"]


@given(st.integers(min_value=1, max_value=8),
       st.integers(min_value=8, max_value=128),
       st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.0, max_value=10.0))
def test_codec_roundtrip_error_bound(nblk, blk, seed, scale):
    rng = np.random.default_rng(seed)
    prev = torch.from_numpy(rng.standard_normal((nblk, blk)).astype(
        np.float32))
    delta = torch.from_numpy((scale * rng.standard_normal((nblk, blk)))
                             .astype(np.float32))
    # make block 0 clean
    delta[0] = 0.0
    x = prev + delta
    q, s, dirty = ckpt_codec.delta_encode(x, prev)
    out = ckpt_codec.delta_decode(q, s, prev)
    assert not bool(dirty[0])
    assert bool(torch.all(out[0] == x[0]))        # clean blocks exact
    err = (out - x).abs()
    bound = s[:, None] / 2 * 1.001 + 1e-7
    assert bool(torch.all(err <= bound))
    # bit for bit the JAX codec as it runs (jitted)
    import jax.numpy as jnp
    enc, dec = _jax_codec()
    jq, js, jd = enc(jnp.asarray(x.numpy()), jnp.asarray(prev.numpy()))
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert np.asarray(js).view(np.uint32).tobytes() == \
        s.numpy().view(np.uint32).tobytes()
    assert np.array_equal(np.asarray(jd), dirty.numpy())
    jout = dec(jq, js, jnp.asarray(prev.numpy()))
    assert np.asarray(jout).view(np.uint32).tobytes() == \
        out.numpy().view(np.uint32).tobytes()


@given(st.integers(min_value=0, max_value=40),
       st.sampled_from([1, 2, 4]), st.sampled_from([1, 2, 4]))
def test_data_stream_invariant_under_dp_relayout(resume_step, dp_a, dp_b):
    """Any interruption point + any DP relayout replays the same global
    token stream (the elastic-restore guarantee)."""
    from repro_torch.data import DataIterator, TokenDataset
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ds = TokenDataset(d, vocab_size=97, seed=3, num_shards=2,
                          tokens_per_shard=4096)
        gb, seq = 8, 16

        def stream(dp, start, n):
            ranks = [DataIterator(ds, global_batch=gb, seq_len=seq,
                                  dp_rank=r, dp_size=dp, step=start)
                     for r in range(dp)]
            return [np.concatenate([it.next() for it in ranks])
                    for _ in range(n)]

        a = stream(dp_a, resume_step, 2)
        b = stream(dp_b, resume_step, 2)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_data_stream_equals_jax_stream(tmp_path):
    """The same dataset arguments give the same shard bytes and the same
    batches, at a DP relayout, in both packages (compared exactly)."""
    from repro.data import DataIterator as JIterator
    from repro.data import TokenDataset as JDataset
    from repro_torch.data import DataIterator, TokenDataset

    kw = dict(vocab_size=97, seed=3, num_shards=2, tokens_per_shard=4096)
    ds_t = TokenDataset(str(tmp_path / "t"), **kw)
    ds_j = JDataset(str(tmp_path / "j"), **kw)
    for dp in (1, 2):
        for r in range(dp):
            it_t = DataIterator(ds_t, global_batch=8, seq_len=16, dp_rank=r,
                                dp_size=dp, step=5)
            it_j = JIterator(ds_j, global_batch=8, seq_len=16, dp_rank=r,
                             dp_size=dp, step=5)
            for _ in range(3):
                assert np.array_equal(it_t.next(), it_j.next())
