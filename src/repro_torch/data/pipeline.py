"""Deterministic, elastically-checkpointable data pipeline (a copy of the
JAX package's data/pipeline.py, which is numpy only: the same ``--data-dir``
and seed give both packages the same token stream).

The corpus is a set of on-disk token shard files (synthetic, generated
deterministically from a seed — the "scientific input files" of the paper's
open-files test). The iterator's position is a pure function of the global
step: sample ``i`` of the batch at step ``t`` reads global sequence index
``t * global_batch + i``. Consequences:

  * checkpoint = {step} (plus identity fields) — tiny, path-independent;
  * restore on a different host/dir re-opens shards and seeks (paper row 3,
    without CRIU's same-directory-tree restriction);
  * elastic restore with a different DP degree (same global batch) replays
    the exact same global token stream (tested);
  * node-failure replay is bitwise deterministic (tested).

A background prefetch thread overlaps host-side batch assembly with device
compute (the paper's pthreading row — dump quiesces it safely).
"""
from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np


class TokenDataset:
    """Sharded synthetic token corpus on disk."""

    def __init__(self, root: str, *, vocab_size: int, seed: int = 0,
                 num_shards: int = 4, tokens_per_shard: int = 1 << 16):
        self.root = root
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.num_shards = int(num_shards)
        self.tokens_per_shard = int(tokens_per_shard)
        os.makedirs(root, exist_ok=True)
        self._generate_missing()

    def _shard_path(self, i: int) -> str:
        return os.path.join(self.root, f"shard_{i:05d}.tokens.npy")

    def _generate_missing(self):
        meta_p = os.path.join(self.root, "dataset.json")
        meta = {"vocab_size": self.vocab_size, "seed": self.seed,
                "num_shards": self.num_shards,
                "tokens_per_shard": self.tokens_per_shard}
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                on_disk = json.load(f)
            if on_disk != meta:
                raise ValueError(f"dataset at {self.root} has different "
                                 f"identity: {on_disk} != {meta}")
        else:
            with open(meta_p, "w") as f:
                json.dump(meta, f)
        for i in range(self.num_shards):
            p = self._shard_path(i)
            if not os.path.exists(p):
                rng = np.random.default_rng(self.seed * 100003 + i)
                toks = rng.integers(0, self.vocab_size,
                                    size=self.tokens_per_shard,
                                    dtype=np.int32)
                np.save(p, toks)

    @property
    def total_tokens(self) -> int:
        return self.num_shards * self.tokens_per_shard

    def read(self, start: int, n: int) -> np.ndarray:
        """Read n tokens at global offset start (wraps across shards/epochs),
        via per-shard mmap (open files + seek, not whole-corpus residency)."""
        out = np.empty((n,), np.int32)
        got = 0
        pos = start % self.total_tokens
        while got < n:
            sh, off = divmod(pos, self.tokens_per_shard)
            arr = np.load(self._shard_path(sh), mmap_mode="r")
            take = min(n - got, self.tokens_per_shard - off)
            out[got:got + take] = arr[off:off + take]
            got += take
            pos = (pos + take) % self.total_tokens
        return out


class DataIterator:
    """Per-host iterator: yields [local_batch, seq+1] token blocks.

    State is {"step"} — global-step addressed, so any (dp_rank, dp_size)
    layout with the same global batch replays the same global stream.
    """

    def __init__(self, ds: TokenDataset, *, global_batch: int, seq_len: int,
                 dp_rank: int = 0, dp_size: int = 1, step: int = 0,
                 prefetch: int = 2):
        assert global_batch % dp_size == 0
        self.ds = ds
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = step
        self.local_batch = global_batch // dp_size
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._worker = None
        self._stop = threading.Event()

    # ----------------------------------------------------------- addressing
    def _sequence(self, global_idx: int) -> np.ndarray:
        start = global_idx * (self.seq_len + 1)
        return self.ds.read(start, self.seq_len + 1)

    def batch_at(self, step: int) -> np.ndarray:
        base = step * self.global_batch + self.dp_rank * self.local_batch
        return np.stack([self._sequence(base + i)
                         for i in range(self.local_batch)])

    # ------------------------------------------------------------- iterator
    def next(self) -> np.ndarray:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # ------------------------------------------------------------- prefetch
    def _prefetch_loop(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start_prefetch(self):
        if self._worker is None:
            self._stop.clear()
            self._worker = threading.Thread(target=self._prefetch_loop,
                                            daemon=True)
            self._worker.start()

    def next_prefetched(self) -> np.ndarray:
        if self._worker is None:
            return self.next()
        step, batch = self._q.get()
        assert step == self.step, (step, self.step)
        self.step += 1
        return batch

    def stop_prefetch(self):
        """Quiesce the worker thread (checkpoint-safe: state is just
        ``step``, never mid-batch)."""
        if self._worker is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._worker.join(timeout=5)
            self._worker = None

    # ----------------------------------------------------------- checkpoint
    def state(self) -> dict:
        return {"step": self.step, "global_batch": self.global_batch,
                "seq_len": self.seq_len,
                "dataset": {"vocab_size": self.ds.vocab_size,
                            "seed": self.ds.seed,
                            "num_shards": self.ds.num_shards,
                            "tokens_per_shard": self.ds.tokens_per_shard}}

    @classmethod
    def restore(cls, ds: TokenDataset, state: dict, *, dp_rank: int = 0,
                dp_size: int = 1, prefetch: int = 2) -> "DataIterator":
        for k, v in state["dataset"].items():
            assert getattr(ds, k) == v, (k, getattr(ds, k), v)
        return cls(ds, global_batch=state["global_batch"],
                   seq_len=state["seq_len"], dp_rank=dp_rank,
                   dp_size=dp_size, step=state["step"], prefetch=prefetch)
