"""Iterative pre-dump: CRIU's dirty-page tracking at leaf granularity.

CRIU shrinks the stop-the-world window with `criu pre-dump`: while the
process keeps running, memory is streamed to images and a soft-dirty bitmap
tracks what changed; the final `criu dump` freezes the process only for the
residual dirty set. This module is that mechanism for checkpoints of
nested dicts of tensors, copied from the JAX package's core/predump.py:

  * a content digest per leaf, the userspace stand-in for the kernel's
    soft-dirty page bitmap. Two classifiers (``digest_pairs`` routes each
    leaf): the lane digest (``tensor_digest``) for fp32 and bf16 tensors,
    from the digest-only codec sweep (K5, ``kernels/ckpt_codec``
    ``classifier_lanes_many``: one launch for all of a device's leaves)
    where the tensors lie — on the card only 16 bytes per 64 KiB block
    come back to the host — and ``leaf_digest``
    (blake2b over the raw bytes, the JAX package's classifier) for host
    arrays and every other dtype;
  * ``DirtyLeafTracker`` — remembers, per leaf path, the digest *and the
    manifest record* of the last image that stored this exact content.
    ``reuse_for(digests)`` returns the records whose leaves are provably
    unchanged; the dump plan emits them verbatim — no capture, no encode,
    no hash, no chunk write (the chunks are already in the
    content-addressed pool, referenced by the pre-dump image's manifest,
    so gc keeps them).

Port difference: the JAX package classifies every leaf with blake2b-160
after copying the whole tree to the host. The port classifies fp32/bf16
tensors by four uint32 lanes per 16384-element block, from one K5 pass:

  * h1, h2 — the JAX package's own digest-only sweep (``ops.digest_blocks``,
    "digest-only sweep (classification)"), bit for bit. A change to any
    single element always shows (the weights are powers of odd numbers,
    so ``d * w != 0 mod 2^32`` for any non-zero bit difference ``d``). But
    the lanes are linear in the bits, so a change that is the same in every
    element of a block cancels when the block's weight sum holds enough
    factors of two: over a whole block the sums are divisible by 2^15 and
    2^14, so any uniform bit change ``d`` with 18 or more trailing zero
    bits is invisible — 0.0 -> 1.0, x -> 2x, x -> -x of a whole block;
  * g1, g2 — the same sums over ``fmix32(bits + w_1[i])``: a bijective,
    position-keyed mix, so a single-element change still always shows and
    a uniform change in the bits is no longer uniform in what is summed.

A leaf is clean only if all four lanes of every block match. A migration
image still carries the tree digest of the live state, and resume refuses
an image whose bytes do not match it.

A pre-dump round is an ordinary *committed* image (complete and restorable
— stronger than CRIU's parent images, which are not restorable alone),
marked with ``meta["pre_dump"]``. The final dump at the step boundary then
pays only for leaves dirtied since the last round.

Reuse is only sound for *portable* records — ones that decode without a
parent image (codec "none"/"bf16", or a lossy codec that fell back). A
delta8-applied record encodes against a specific parent's values; re-
pointing it at a different parent image would decode silently wrong
numbers, so pre-dump rounds always encode with ``prev_host_tree=None``
(delta8 degrades to full encodes inside rounds) and the tracker refuses to
cache delta-applied records. The *final* dump still gets its delta8 chain:
the session's baseline advances to the pre-dump tree, so residual dirty
leaves delta-encode against the last round's image as parent.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from repro_torch.device import dtype_name

# manifest meta key marking an image as a pre-dump round:
#   meta["pre_dump"] = {"round": k, "dirty": n_dirty, "clean": n_reused}
PRE_DUMP_META_KEY = "pre_dump"

# dtypes the lane classifier takes (K5 reads fp32 and bf16 bit patterns)
LANE_DTYPES = (torch.float32, torch.bfloat16)


def leaf_digest(arr) -> str:
    """Content digest of one host leaf: dtype + shape + raw bytes.

    blake2b rather than sha256: this runs over every host leaf each
    classification pass, so it sits directly in the freeze window and must
    be cheaper than the encode+hash+write it saves. A torch tensor is
    copied to the host first (only non-float tensors come here from
    ``digest_pairs``). The dtype is bound by name, so a bf16 host array
    (uint16 bits, see repro_torch.device) differs from a uint16 one."""
    from repro_torch.device import to_host
    a = np.ascontiguousarray(to_host(arr))
    h = hashlib.blake2b(digest_size=20)
    h.update(dtype_name(a).encode())
    h.update(repr(a.shape).encode())
    flat = a.reshape(-1)
    if flat.size:
        h.update(flat.view(np.uint8))
    return h.hexdigest()


def uses_lanes(leaf) -> bool:
    """True for a leaf the lane classifier takes: an fp32 or bf16 tensor
    (on the card or on the CPU)."""
    return isinstance(leaf, torch.Tensor) and leaf.dtype in LANE_DTYPES


def _lane_string(dtype: str, shape: tuple, lanes: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(dtype.encode())
    h.update(repr(shape).encode())
    h.update(np.ascontiguousarray(lanes).view(np.uint8))
    return "pmac:" + h.hexdigest()


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """[4, nblk] int32 lanes of a tensor, where it lies (K5 on the card)."""
    from repro_torch.kernels.ckpt_codec import ops
    return ops.classifier_lanes(t.detach().reshape(-1))


def tensor_digest(t: torch.Tensor) -> str:
    """Content digest of one fp32 or bf16 tensor from its per-block lanes
    (``"pmac:" + blake2b(dtype, shape, h1, h2, g1, g2)``). On the card the
    lanes
    come from K5 and only they travel to the host; a failed launch
    raises — there is no host fallback."""
    if not uses_lanes(t):
        raise TypeError(f"tensor_digest takes fp32 or bf16 tensors, got "
                        f"{getattr(t, 'dtype', type(t))}")
    lanes = _lanes(t).cpu().numpy()
    return _lane_string(dtype_name(t), tuple(t.shape), lanes)


def lane_strings(items, lanes: np.ndarray, cols) -> dict:
    """{path: digest} of [(path, tensor)] from their lanes on the host:
    ``lanes`` int32 [4, total], tensor i's in columns ``cols[i]`` (first
    column, blocks), as ``ops.classifier_lanes_many`` returns them."""
    return {p: _lane_string(dtype_name(a), tuple(a.shape),
                            lanes[:, c:c + k])
            for (p, a), (c, k) in zip(items, cols)}


def digest_pairs(pairs, executor=None) -> dict:
    """{path: digest} over [(path, leaf)]. fp32/bf16 tensors take the lane
    classifier: one K5 launch per device digests all of that device's
    leaves (``ops.classifier_lanes_many``, asynchronous on the card) and
    their lanes come to the host in one copy. Every other leaf takes
    ``leaf_digest``, fanned out on the executor's cpu pool when one is
    given (classification parallelizes exactly like encode does).

    With DTensor leaves (a mesh over the ranks of a process group) it is
    collective: every rank calls it, digests its local shards as above
    (``_shard_digests``) and every rank returns the same dict."""
    from repro_torch.distributed import sharding as shd
    pairs = list(pairs)
    if any(shd.is_dtensor(a) for _, a in pairs):
        return _shard_digests(pairs, executor)
    return _local_digests(pairs, executor)


def _shard_digests(pairs, executor) -> dict:
    """digest_pairs of a tree with DTensor leaves. Each rank that holds a
    distinct shard of a leaf (``sharding.shard_holders``) digests that
    local shard, all of them in one K5 launch per device; rank 0 alone
    digests the plain leaves (the same on every rank). One
    ``all_gather_object`` of those digest strings, never lanes, then
    gives every rank every part, and a DTensor leaf's digest is one
    string over its holders' shard digests in rank order, its dtype,
    global shape and placements. No leaf is gathered. A rank whose
    digests fail sends its error instead, and every rank raises."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    rank = dist.get_rank()
    mine = [(p, a.to_local().detach().contiguous())
            for p, a in pairs if shd.is_dtensor(a)
            and rank in shd.shard_holders(a)]
    if rank == 0:
        mine += [(p, a) for p, a in pairs if not shd.is_dtensor(a)]
    try:
        part = {"ok": _local_digests(mine, executor)}
    except Exception as e:
        part, err = {"error": f"rank {rank}: {type(e).__name__}: {e}"}, e
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, part)
    bad = [p["error"] for p in parts if "error" in p]
    if bad:
        if "error" in part:
            raise err
        raise RuntimeError(f"classification failed on {bad[0]}")
    out = {}
    for p, a in pairs:
        if not shd.is_dtensor(a):
            out[p] = parts[0]["ok"][p]
            continue
        h = hashlib.blake2b(digest_size=20)
        h.update(f"{dtype_name(a)}{tuple(a.shape)}{tuple(a.placements)}"
                 f"{tuple(a.device_mesh.shape)}".encode())
        for r in shd.shard_holders(a):
            h.update(parts[r]["ok"][p].encode())
        out[p] = "shards:" + h.hexdigest()
    return out


def _local_digests(pairs, executor) -> dict:
    """digest_pairs of leaves that all lie on this process's devices."""
    from repro_torch.kernels.ckpt_codec import ops
    lane_pairs = [(p, a) for p, a in pairs if uses_lanes(a)]
    host_pairs = [(p, a) for p, a in pairs if not uses_lanes(a)]
    by_device: dict = {}
    for p, a in lane_pairs:
        by_device.setdefault(a.device, []).append((p, a))
    launched = [(items, ops.classifier_lanes_many([a for _, a in items]))
                for items in by_device.values()]
    out = {}
    for items, (lanes, cols) in launched:
        out.update(lane_strings(items, lanes.cpu().numpy(), cols))
    if executor is not None:
        digs = executor.map_cpu(lambda pa: leaf_digest(pa[1]), host_pairs)
    else:
        digs = [leaf_digest(a) for _, a in host_pairs]
    out.update({p: d for (p, _), d in zip(host_pairs, digs)})
    return {p: out[p] for p, _ in pairs}


def record_is_portable(rec: dict) -> bool:
    """True when ``rec`` decodes with no parent image: safe to re-emit
    under a different image / different parent link."""
    codec = rec.get("codec", "none")
    if codec == "none":
        return True
    if not rec.get("codec_meta", {}).get("applied", False):
        return True          # lossy codec fell back to raw storage
    return codec == "bf16"   # content-deterministic, parent-free decode


class DirtyLeafTracker:
    """Per-leaf dirty tracking across pre-dump rounds (one per session).

    Thread-safe for the session's single-writer discipline; all state
    transitions go through ``update``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._digests: dict = {}     # path -> content digest at last image
        self._records: dict = {}     # path -> portable manifest record
        self.rounds = 0              # pre-dump rounds completed
        self.source_image: str | None = None

    def __repr__(self):
        return (f"DirtyLeafTracker(rounds={self.rounds}, "
                f"tracked={len(self._digests)}, "
                f"source={self.source_image!r})")

    @property
    def warm(self) -> bool:
        return bool(self._records)

    def reuse_for(self, digests: dict) -> dict:
        """{path: cached record} for every leaf whose current digest
        matches the tracked one — the 'clean pages'. Everything else is
        the dirty set the next dump must actually write."""
        with self._lock:
            return {p: self._records[p] for p, d in digests.items()
                    if p in self._records and self._digests.get(p) == d}

    def split(self, digests: dict) -> tuple:
        """(dirty_paths, clean_paths) under the tracked digests."""
        clean = set(self.reuse_for(digests))
        return ([p for p in digests if p not in clean], sorted(clean))

    def update(self, digests: dict, records, image_id: str, *,
               pre_dump: bool):
        """Adopt image ``image_id`` as the new reuse source: its records
        (portable ones only) become reusable wherever the digest still
        matches. ``records`` is an iterable of manifest leaf records."""
        portable = {r["path"]: r for r in records if record_is_portable(r)}
        with self._lock:
            self._digests = {p: d for p, d in digests.items()
                             if p in portable}
            self._records = portable
            self.source_image = image_id
            if pre_dump:
                self.rounds += 1
