"""Integrity: content hashing, verification, replica repair.

Every chunk is content-addressed by SHA-256; the manifest carries the hash
list per leaf plus its own digest. Restore verifies every chunk it reads;
on mismatch/missing it repairs from a replica tier (the paper's network-
file-system row, plus protection CRIU does not attempt)."""
from __future__ import annotations

import hashlib
import json
import logging

log = logging.getLogger(__name__)


def sha256(data) -> str:
    return hashlib.sha256(data).hexdigest()


def read_chunk_verified(tier, replicas, h: str, image_id: str) -> bytes:
    """Content-addressed read with verification + replica repair."""
    sources = [tier] + list(replicas)
    for k, src in enumerate(sources):
        try:
            data = src.read_chunk(h)
        except FileNotFoundError:
            continue
        if sha256(data) == h:
            if k > 0:  # repair the primary from the replica (overwrite the
                # corrupt file — bypass the content-addressed dedup check)
                tier.write_bytes(tier.chunk_path(h), data)
                tier.note_chunk_present(h)
                log.warning("repaired chunk %s from replica %d", h[:12], k)
            return data
        log.warning("chunk %s corrupt in source %d", h[:12], k)
    raise KeyError(h)


def manifest_digest(manifest_dict: dict) -> str:
    body = {k: v for k, v in manifest_dict.items() if k != "digest"}
    return sha256(json.dumps(body, sort_keys=True).encode())


def tree_digest(pairs) -> str:
    """Logical-state digest: hash of (path, dtype, shape, bytes) over the
    leaves in path order. Topology-free by construction — the same logical
    values give the same digest no matter what mesh the tree lives on (or
    lived on), which is exactly the invariant a cross-topology migration
    must preserve. ``pairs`` is {path: array} or an iterable of
    (path, array).

    A tree with DTensor leaves (a mesh over the ranks of a process group)
    is digested collectively: every rank calls it, each leaf is gathered
    to rank 0 alone in path order (``sharding.gather_leaf``), hashed
    there and dropped before the next, and every rank returns rank 0's
    digest, that of the unsharded tree."""
    from repro_torch.distributed import sharding as shd
    if isinstance(pairs, dict):
        pairs = pairs.items()
    pairs = sorted(pairs, key=lambda kv: kv[0])
    h = hashlib.sha256()
    if any(shd.is_dtensor(a) for _, a in pairs):
        def body(pull):
            for path, t in pairs:
                # a gathered leaf is the digest's own: no second copy
                _hash_leaf(h, path, pull(path, t), copy=False)
            return h.hexdigest()
        return shd.gathered_on_rank0(pairs, body)
    for path, arr in pairs:
        _hash_leaf(h, path, arr)
    return h.hexdigest()


def _hash_leaf(h, path: str, arr, copy: bool = True) -> None:
    import numpy as np

    from repro_torch.device import dtype_name, to_host
    a = to_host(arr, copy=copy)
    h.update(path.encode())
    h.update(dtype_name(a).encode())
    h.update(repr(a.shape).encode())
    # the array's own buffer, not a tobytes() copy of it
    h.update(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


class CorruptionError(RuntimeError):
    def __init__(self, image_id: str, bad_chunks: list):
        self.image_id = image_id
        self.bad_chunks = bad_chunks
        super().__init__(f"image {image_id}: {len(bad_chunks)} corrupt/missing "
                         f"chunks: {bad_chunks[:5]}{'...' if len(bad_chunks) > 5 else ''}")
