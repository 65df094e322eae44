"""Leaf <-> chunk-stream conversion ("memory pages" of the dump).

A leaf (host numpy array) is serialized to raw bytes and split into
fixed-size chunks; each chunk is SHA-256 content-addressed. Chunk
granularity is what makes incremental dumps work: an unchanged chunk of an
updated leaf hashes identically and is deduplicated against the pool /
parent image — CRIU's dirty-page tracking at VMEM-block granularity.

Chunks are zero-copy memoryviews over the leaf's single serialized buffer:
``chunk_views`` hashes each window in place (hashlib accepts buffers) and
the executor writes the views straight to the tier, so a dump never holds a
second, chunk-granular copy of a leaf in memory.

Two chunkers share that contract:

  fixed  — windows every ``chunk_bytes`` (the default; boundary positions
           depend on leaf serialization offsets, so reshaping a leaf or
           splitting it across paths mis-aligns every later chunk).
  cdc    — content-defined boundaries from a rolling hash over a 16-byte
           window (``cdc_cut_points``): a boundary is cut where the window
           hash masks to zero, so boundaries re-synchronize after any
           insertion/shift and dedup survives leaf reshaping and topology
           changes. Sizes are bounded to [avg/4, 4*avg] around the
           requested average (= ``chunk_bytes``). Restore needs no chunker
           knowledge — records carry explicit ``chunk_sizes``.
"""
from __future__ import annotations

import bisect

import numpy as np

from repro_torch.core.integrity import sha256
from repro_torch.device import dtype_name, np_dtype

CHUNK_BYTES = 4 << 20  # 4 MiB

CHUNKERS = ("fixed", "cdc")

# --- cdc rolling-hash constants: all deterministic, seeded once. The gear
# table is part of the dedup behavior (not correctness): changing it only
# changes where boundaries fall.
_CDC_WINDOW = 16
_CDC_R = np.uint64(0x100000001B3)            # FNV-1a 64 prime
_CDC_GEAR = np.random.default_rng(0x9E3779B9).integers(
    0, 1 << 63, size=256, dtype=np.uint64)
_CDC_POW = np.cumprod(
    np.full(_CDC_WINDOW, _CDC_R, np.uint64), dtype=np.uint64)


def leaf_to_bytes(arr: np.ndarray) -> np.ndarray:
    """The leaf's raw bytes as a flat uint8 view (no copy when the array is
    already contiguous) — a multi-GB leaf is hashed and written in place."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def bytes_to_leaf(data: bytes, dtype: str, shape) -> np.ndarray:
    """Raw bytes -> array. ``dtype`` is the recorded numpy name;
    "bfloat16" maps to the port's uint16 bit-pattern dtype (BF16)."""
    return np.frombuffer(data, dtype=np_dtype(dtype)).reshape(shape).copy()


def chunk_views(data, chunk_bytes: int = CHUNK_BYTES):
    """-> list of (hash, memoryview) windows over ``data`` (no copies).

    Empty input still yields one (empty) chunk so every leaf has at least
    one addressable chunk."""
    mv = memoryview(data)
    out = []
    for off in range(0, max(len(mv), 1), chunk_bytes):
        part = mv[off:off + chunk_bytes]
        out.append((sha256(part), part))
    return out


def split_chunks(data: bytes, chunk_bytes: int = CHUNK_BYTES):
    """-> list of (hash, bytes). Copying variant of chunk_views for callers
    that need detached chunk payloads (tests, small blobs)."""
    return [(h, bytes(v)) for h, v in chunk_views(data, chunk_bytes)]


def cdc_cut_points(data, avg_bytes: int = CHUNK_BYTES) -> list:
    """Content-defined cut offsets (ascending, last == len(data)).

    Rolling hash: for each 16-byte window, H = sum(gear[b_j] * r^j) over
    the window bytes in uint64 wraparound — computed for every position at
    once with 16 shifted vector mult-adds (no per-byte python loop). A cut
    falls after a window whose hash masks to zero; min/max size bounds
    [avg/4, 4*avg] are enforced by walking the candidate list (forced cut
    at max when a run has no candidate)."""
    n = len(memoryview(data))
    min_b = max(_CDC_WINDOW * 4, avg_bytes // 4)
    max_b = avg_bytes * 4
    if n <= min_b:
        return [n]
    d = np.frombuffer(data, np.uint8)
    t = _CDC_GEAR[d]
    m = n - _CDC_WINDOW + 1
    acc = np.zeros(m, np.uint64)
    for j in range(_CDC_WINDOW):
        acc += t[j:j + m] * _CDC_POW[j]
    # boundary probability ~ 1/2^b -> expected run ~ min_b + 2^b ~ avg
    span = max(avg_bytes - min_b, 2)
    mask = np.uint64((1 << max(1, int(span).bit_length() - 1)) - 1)
    cand = (np.nonzero((acc & mask) == 0)[0] + _CDC_WINDOW).tolist()
    cuts, last = [], 0
    while n - last > min_b:
        lo, hi = last + min_b, min(last + max_b, n)
        i = bisect.bisect_left(cand, lo)
        if i < len(cand) and cand[i] <= hi:
            cut = cand[i]
        elif n - last > max_b:
            cut = hi                    # no candidate in a full run: force
        else:
            break                       # remainder (<= max) is final chunk
        if cut >= n:
            break
        cuts.append(cut)
        last = cut
    cuts.append(n)
    return cuts


def cdc_chunk_views(data, avg_bytes: int = CHUNK_BYTES):
    """Content-defined variant of chunk_views: (hash, memoryview) windows
    at rolling-hash boundaries. Zero-copy, same contract (empty input
    yields one empty chunk)."""
    mv = memoryview(data)
    if len(mv) == 0:
        return [(sha256(mv), mv)]
    out, last = [], 0
    for cut in cdc_cut_points(mv, avg_bytes):
        part = mv[last:cut]
        out.append((sha256(part), part))
        last = cut
    return out


def chunk_stream(data, chunk_bytes: int = CHUNK_BYTES,
                 chunking: str = "fixed"):
    """Chunker dispatch for the executor: 'fixed' -> chunk_views, 'cdc' ->
    cdc_chunk_views (chunk_bytes becomes the target average)."""
    if chunking == "cdc":
        return cdc_chunk_views(data, chunk_bytes)
    if chunking == "fixed":
        return chunk_views(data, chunk_bytes)
    raise ValueError(f"unknown chunker {chunking!r}; "
                     f"choose from {CHUNKERS}")


def leaf_record(path: str, arr: np.ndarray, chunk_bytes: int = CHUNK_BYTES,
                codec: str = "none", codec_meta: dict | None = None,
                chunk_hashes: list | None = None, nbytes: int | None = None,
                chunking: str = "fixed", chunk_sizes: list | None = None,
                ) -> dict:
    """Manifest record for one stored leaf. When the caller already chunked
    the serialized buffer (the streaming executor path), pass chunk_hashes +
    nbytes to avoid re-serializing. Content-defined records additionally
    carry ``chunking: "cdc"`` + explicit ``chunk_sizes`` so readers never
    need the chunker (fixed-mode records are byte-identical to before)."""
    if chunk_hashes is None:
        data = leaf_to_bytes(arr)
        nbytes = len(data)
        views = chunk_stream(data, chunk_bytes, chunking)
        chunk_hashes = [h for h, _ in views]
        if chunking != "fixed":
            chunk_sizes = [len(v) for _, v in views]
    rec = {
        "path": path,
        "dtype": dtype_name(arr),
        "shape": list(arr.shape),
        "nbytes": int(nbytes),
        "chunk_bytes": chunk_bytes,
        "chunks": list(chunk_hashes),
        "codec": codec,
        "codec_meta": codec_meta or {},
    }
    if chunking != "fixed":
        rec["chunking"] = chunking
        rec["chunk_sizes"] = [int(s) for s in (chunk_sizes or [])]
    return rec


def chunk_offsets(record: dict) -> list:
    """[(start, end)] byte ranges of each chunk of a record, for range
    readers (lazy read_range): explicit ``chunk_sizes`` when present (cdc),
    otherwise the fixed ``chunk_bytes`` grid."""
    total = int(record["nbytes"])
    sizes = record.get("chunk_sizes")
    if sizes:
        out, off = [], 0
        for s in sizes:
            out.append((off, off + int(s)))
            off += int(s)
        return out
    cb = int(record["chunk_bytes"])
    return [(i * cb, min(i * cb + cb, total))
            for i in range(len(record["chunks"]))]


def assemble_leaf(record: dict, read_chunk) -> np.ndarray:
    """read_chunk: hash -> bytes (verification done by caller). Chunks are
    copied once, straight into the leaf's own buffer. A length that does
    not add up to ``nbytes`` raises AssertionError (the executor's
    corrupt-leaf signal)."""
    nbytes = int(record["nbytes"])
    buf = np.empty(nbytes, np.uint8)
    off = 0
    for h in record["chunks"]:
        part = np.frombuffer(read_chunk(h), np.uint8)
        if off + part.size > nbytes:
            raise AssertionError((record["path"], off + part.size))
        buf[off:off + part.size] = part
        off += part.size
    if off != nbytes:
        raise AssertionError((record["path"], off))
    return buf.view(np_dtype(record["dtype"])).reshape(record["shape"])
