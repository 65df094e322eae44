"""Content-defined chunking in the port: the twin of tests/test_cdc.py's
six local tests (cut mechanics, boundary stability under a leaf split,
resync after an insertion, the dedup regression against fixed windows),
on torch trees with ``device="cpu"``. Its two remote cases
(``test_predump_leaf_reuse_over_remote_with_cdc`` over ``remote://`` and
``cache+remote://``) are twinned in tests/test_torch_remote.py. Plus the
cross-package case: the port's cut points and chunk digests equal the JAX
package's on the same 1 MiB of seeded bytes, for fixed windows and CDC."""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline image: seeded fixed-example fallback
    from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.api import (CheckpointSession, CodecPolicy,  # noqa: E402
                             DumpRequest, RestoreRequest, SessionConfig)
from repro_torch.core import chunking  # noqa: E402

settings.register_profile("ci", max_examples=15, deadline=None)
settings.load_profile("ci")

CPU = "cpu"

AVG = 4096


def rand_bytes(n, seed=0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


# ----------------------------------------------------------- cut mechanics
def test_cut_points_bounds_and_determinism():
    data = rand_bytes(1 << 20)
    cuts = chunking.cdc_cut_points(data, AVG)
    assert cuts == chunking.cdc_cut_points(data, AVG)   # deterministic
    assert cuts[-1] == len(data)
    assert cuts == sorted(set(cuts))
    sizes = np.diff([0] + cuts)
    min_b, max_b = max(64, AVG // 4), AVG * 4
    assert (sizes[:-1] >= min_b).all()       # final chunk may run short
    assert (sizes <= max_b).all()
    # sizes actually hover around the requested average
    assert AVG / 3 < sizes.mean() < AVG * 3


def test_tiny_and_empty_inputs_are_one_chunk():
    assert chunking.cdc_cut_points(b"", AVG) == [0]
    assert chunking.cdc_cut_points(b"xy", AVG) == [2]
    (h, v), = chunking.cdc_chunk_views(b"", AVG)
    assert len(v) == 0 and isinstance(h, str)


def test_chunk_stream_dispatch_and_unknown_chunker():
    data = rand_bytes(1 << 16, 1)
    fixed = chunking.chunk_stream(data, 4096, "fixed")
    assert all(len(v) == 4096 for _, v in fixed[:-1])
    cdc = chunking.chunk_stream(data, 4096, "cdc")
    assert b"".join(bytes(v) for _, v in cdc) == data
    with pytest.raises(ValueError, match="unknown chunker"):
        chunking.chunk_stream(data, 4096, "rolling")


def test_records_and_offsets_round_trip():
    arr = np.frombuffer(rand_bytes(1 << 17, 2), np.uint8)
    rec = chunking.leaf_record("w", arr, chunk_bytes=AVG, chunking="cdc")
    assert rec["chunking"] == "cdc"
    assert sum(rec["chunk_sizes"]) == rec["nbytes"]
    offs = chunking.chunk_offsets(rec)
    assert offs[0][0] == 0 and offs[-1][1] == rec["nbytes"]
    assert all(a2 == b1 for (_, b1), (a2, _) in zip(offs, offs[1:]))
    # fixed-mode records are byte-identical to the pre-cdc schema
    rec_f = chunking.leaf_record("w", arr, chunk_bytes=AVG)
    assert "chunking" not in rec_f and "chunk_sizes" not in rec_f


# ------------------------------------------------- stability under reshape
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.1, max_value=0.9))
def test_cdc_boundaries_survive_leaf_split(seed, frac):
    """Splitting one leaf's byte stream into two leaves (what a topology
    change / leaf reshape does to the serialized stream) must preserve
    most content-defined chunks; the fixed grid only preserves the
    aligned prefix."""
    data = rand_bytes(1 << 18, seed)
    k = int(len(data) * frac)
    whole = {h for h, _ in chunking.cdc_chunk_views(data, AVG)}
    parts = {h for h, _ in chunking.cdc_chunk_views(data[:k], AVG)} \
        | {h for h, _ in chunking.cdc_chunk_views(data[k:], AVG)}
    shared = len(whole & parts) / len(whole)
    assert shared >= 0.5, f"only {shared:.0%} of cdc chunks survived split"


def test_cdc_resyncs_after_prefix_insertion_fixed_does_not():
    data = rand_bytes(1 << 18, 3)
    shifted = rand_bytes(1337, 4) + data
    c0 = {h for h, _ in chunking.cdc_chunk_views(data, AVG)}
    c1 = {h for h, _ in chunking.cdc_chunk_views(shifted, AVG)}
    f0 = {h for h, _ in chunking.chunk_views(data, AVG)}
    f1 = {h for h, _ in chunking.chunk_views(shifted, AVG)}
    cdc_shared = len(c0 & c1) / len(c0)
    fixed_shared = len(f0 & f1) / len(f0)
    assert cdc_shared > 0.8
    assert fixed_shared < 0.1          # every window after the shift moved
    assert cdc_shared > fixed_shared


# ------------------------------------------------------ dedup regression
def test_reshaped_leaf_redump_cdc_dedup_strictly_beats_fixed(tmp_path):
    """The acceptance regression: re-dump the SAME parameter bytes after a
    leaf reshape (two layers merged into one, boundary not chunk-aligned).
    CDC's dedup hit rate must strictly exceed fixed-size chunking's."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(123_457).astype(np.float32)   # odd split point
    b = rng.standard_normal(400_000).astype(np.float32)
    t1 = {"params": {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
          "step": torch.tensor(1, dtype=torch.int32)}
    merged = np.concatenate([a, b])
    t2 = {"params": {"ab": torch.from_numpy(merged)},
          "step": torch.tensor(2, dtype=torch.int32)}

    rates = {}
    for mode in ("fixed", "cdc"):
        sess = CheckpointSession(SessionConfig(
            root=str(tmp_path / mode), chunk_bytes=1 << 14,
            codec=CodecPolicy(chunking=mode)), device=CPU)
        sess.dump(DumpRequest(state=t1, step=1))
        r2 = sess.dump(DumpRequest(state=t2, step=2))
        s = r2.stats
        rates[mode] = s["chunks_deduped"] / max(s["chunks"], 1)
        got = sess.restore(RestoreRequest()).state
        np.testing.assert_array_equal(got["params"]["ab"].numpy(),
                                      merged)
    assert rates["cdc"] > rates["fixed"], rates
    assert rates["cdc"] > 0.8          # nearly everything re-synchronized
    assert rates["fixed"] < 0.4        # only a's aligned prefix survived


# ------------------------------------------------- cross-package: the cuts
@pytest.mark.parametrize("mode", ["fixed", "cdc"])
def test_cut_points_and_digests_equal_jax(mode):
    """1 MiB of seeded bytes: the same cut points and the same chunk
    digests, in order, as the JAX package's chunker (compared exactly)."""
    from repro.core import chunking as jchunking

    data = rand_bytes(1 << 20, 7)
    if mode == "cdc":
        assert chunking.cdc_cut_points(data, AVG) == \
            jchunking.cdc_cut_points(data, AVG)
    got = [(h, len(v)) for h, v in chunking.chunk_stream(data, AVG, mode)]
    want = [(h, len(v)) for h, v in jchunking.chunk_stream(data, AVG, mode)]
    assert got == want
    assert len(got) > 64
