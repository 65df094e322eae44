"""The port's data pipeline: the twin of tests/test_data_pipeline.py (all
6: determinism, open-files restore semantics, the dataset identity check,
epoch wrap, prefetch equals sync, quiesce then resume). Plus the
cross-package case: the same dataset arguments give the same shard bytes,
batches and iterator state as the JAX package's pipeline, including
across a prefetch quiesce (compared exactly)."""

import numpy as np
import pytest

from repro_torch.data import DataIterator, TokenDataset


@pytest.fixture
def ds(tmp_path):
    return TokenDataset(str(tmp_path / "data"), vocab_size=101, seed=7,
                        num_shards=3, tokens_per_shard=2048)


def test_batches_deterministic_and_resumable(ds):
    it = DataIterator(ds, global_batch=4, seq_len=32)
    ref = [it.next() for _ in range(6)]
    # resume at arbitrary point from checkpointed state
    it2 = DataIterator(ds, global_batch=4, seq_len=32)
    for _ in range(3):
        it2.next()
    state = it2.state()
    it3 = DataIterator.restore(ds, state)
    for i in range(3, 6):
        assert np.array_equal(it3.next(), ref[i])


def test_restore_is_path_independent(ds, tmp_path):
    """Paper row 3: CRIU requires identical directory trees; our image is
    relocatable — restore against a dataset generated at a DIFFERENT path."""
    it = DataIterator(ds, global_batch=2, seq_len=16)
    it.next(); it.next()
    state = it.state()
    ds2 = TokenDataset(str(tmp_path / "elsewhere"), vocab_size=101, seed=7,
                       num_shards=3, tokens_per_shard=2048)
    it2 = DataIterator.restore(ds2, state)
    assert np.array_equal(it2.next(), DataIterator(
        ds, global_batch=2, seq_len=16, step=2).next())


def test_dataset_identity_mismatch_rejected(ds):
    state = DataIterator(ds, global_batch=2, seq_len=16).state()
    state["dataset"]["seed"] = 999
    with pytest.raises(AssertionError):
        DataIterator.restore(ds, state)


def test_epoch_wrap_reads_are_consistent(ds):
    total = ds.total_tokens
    a = ds.read(total - 10, 20)
    assert np.array_equal(a[:10], ds.read(total - 10, 10))
    assert np.array_equal(a[10:], ds.read(0, 10))


def test_prefetch_equals_sync(ds):
    it_a = DataIterator(ds, global_batch=2, seq_len=16)
    it_b = DataIterator(ds, global_batch=2, seq_len=16)
    it_b.start_prefetch()
    try:
        for _ in range(5):
            assert np.array_equal(it_a.next(), it_b.next_prefetched())
    finally:
        it_b.stop_prefetch()


def test_prefetch_quiesce_then_resume(ds):
    it = DataIterator(ds, global_batch=2, seq_len=16)
    it.start_prefetch()
    it.next_prefetched()
    it.stop_prefetch()           # checkpoint-time quiesce
    state = it.state()
    assert state["step"] == 1    # never mid-batch
    it2 = DataIterator.restore(ds, state)
    ref = DataIterator(ds, global_batch=2, seq_len=16, step=1)
    assert np.array_equal(it2.next(), ref.next())


def test_pipeline_equals_jax_pipeline(ds, tmp_path):
    from repro.data import DataIterator as JIterator
    from repro.data import TokenDataset as JDataset

    jds = JDataset(str(tmp_path / "jax"), vocab_size=101, seed=7,
                   num_shards=3, tokens_per_shard=2048)
    assert jds.total_tokens == ds.total_tokens
    for start, n in ((0, 2048), (ds.total_tokens - 10, 20), (3000, 777)):
        assert np.array_equal(ds.read(start, n), jds.read(start, n))
    it_t = DataIterator(ds, global_batch=2, seq_len=16)
    it_j = JIterator(jds, global_batch=2, seq_len=16)
    it_t.start_prefetch()
    try:
        for _ in range(3):
            assert np.array_equal(it_t.next_prefetched(), it_j.next())
    finally:
        it_t.stop_prefetch()
    state = it_t.state()
    assert state == it_j.state()
    a = DataIterator.restore(ds, state)
    b = JIterator.restore(jds, it_j.state())
    assert np.array_equal(a.next(), b.next())
