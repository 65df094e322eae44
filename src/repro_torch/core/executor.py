"""Plan execution: bounded thread pools that pipeline the checkpoint path.

Dump pipeline (per process):

  device->host capture        one .cpu() per leaf (caller / dump())
  CPU encode + hash           leaf tasks on the cpu pool: codec encode,
                              serialize, SHA-256 every chunk window in place
  dedup decision              one batched ``has_chunks`` probe per leaf
                              against the tier's in-memory chunk index,
                              plus an intra-dump claim set (so two leaves
                              producing the same chunk store it once)
  tier I/O                    chunk writes fan out on the io pool; chunks
                              are zero-copy memoryviews of the leaf buffer —
                              nothing is materialized per chunk

A leaf task blocks until its own chunk writes land, so at most cpu_workers
leaf buffers are alive at once (bounded memory), while other cpu workers
keep encoding — encode of leaf k+1 overlaps the writes of leaf k.

Restore pipeline: leaf tasks on the cpu pool, chunk reads fanned out on the
io pool, with a (image_id, path) memo so delta8 parent leaves are fetched +
decoded once per chain instead of once per referencing leaf.

``serial=True`` runs the identical plan inline on the calling thread with
per-chunk existence probes — the seed engine's behavior, kept as the
baseline for benchmarks/ckpt_throughput.py --compare and as a debugging
fallback."""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from repro_torch.core import chunking
from repro_torch.core.compression import decode_leaf, encode_leaf
from repro_torch.core.integrity import CorruptionError, read_chunk_verified
from repro_torch.device import dtype_name


class CheckpointExecutor:
    """Shared, bounded execution engine for Dump/Restore plans."""

    def __init__(self, *, cpu_workers: int | None = None,
                 io_workers: int | None = None, serial: bool = False,
                 use_chunk_index: bool | None = None,
                 transfer_workers: int | None = None):
        self.serial = serial
        self.use_chunk_index = (not serial) if use_chunk_index is None \
            else use_chunk_index
        self._cpu = self._io = None
        if not serial:
            ncpu = os.cpu_count() or 4
            self._cpu = ThreadPoolExecutor(
                cpu_workers or min(8, ncpu), thread_name_prefix="ckpt-cpu")
            self._io = ThreadPoolExecutor(
                io_workers or 8, thread_name_prefix="ckpt-io")
        self._coord = None          # lazy: ordered async submission lane
        self._coord_lock = threading.Lock()
        self._xfer = None           # lazy: remote transfer lanes
        self._xfer_workers = transfer_workers or 8
        self._xfer_lock = threading.Lock()

    # ------------------------------------------------------------------ dump
    def run_dump(self, plan, arrays: dict, tier, replicas=(),
                 prev_host_tree: dict | None = None,
                 encoded: dict | None = None, device="cuda") -> dict:
        """Execute a DumpPlan. arrays: {path: host np.ndarray}. Returns
        {"records": [manifest leaf records in plan order], "stats": {...}}.

        ``encoded``: {path: Future -> (stored, codec_meta)} from the device
        codec stage (core/device_codec.py) — those leaves skip the host
        encode and consume the landed device result instead; the device
        transfer of leaf i+1 overlaps this leaf's chunk writes. Host-codec
        leaves encode on ``device``."""
        if self.use_chunk_index:
            tier.enable_chunk_index()
            for r in replicas:
                r.enable_chunk_index()
        stats = {"bytes_raw": 0, "bytes_stored": 0, "bytes_deduped": 0,
                 "chunks": 0, "chunks_deduped": 0,
                 "leaves_reused": 0, "bytes_reused": 0,
                 "leaves_device": 0, "chunks_reuploaded": 0}
        crossjob = bool(getattr(tier, "shared_chunks", False))
        upload_delta = getattr(tier, "upload_delta", None)
        encoded = encoded or {}
        stats_lock = threading.Lock()
        claimed: set = set()        # intra-dump first-writer-wins
        claim_lock = threading.Lock()
        prev_host_tree = prev_host_tree or {}

        def reuse_leaf(lp):
            """Pre-dump fast path: the planner proved this leaf's content
            unchanged since the cached record's image — re-emit the record
            if every chunk is still pooled (they are referenced by that
            image's manifest, so only a foreign gc could have raced them;
            on a miss we fall back to the full encode below). Replicas are
            healed from the primary: a reused chunk was already mirrored
            when first written, so misses are rare repair work, not the
            steady-state dump path."""
            rec = lp.reuse
            uniq = set(rec["chunks"])
            try:
                if len(tier.has_chunks(uniq)) != len(uniq):
                    return None
                if crossjob and len(tier.verify_chunks(uniq)) != len(uniq):
                    # a cross-job index hit is a claim, not a fact: a
                    # peer job's gc (another process over the shared
                    # store) may have reaped between probe and now —
                    # full encode instead of a manifest that 404s
                    return None
                for r in replicas:
                    rpresent = r.has_chunks(uniq)
                    for h in uniq - rpresent:
                        r.write_chunk(h, tier.read_chunk(h))
            except (FileNotFoundError, KeyError, OSError):
                return None    # chunk vanished between probe and heal (a
                #                foreign gc) — re-encode, don't fail the dump
            with stats_lock:
                stats["bytes_raw"] += lp.nbytes
                stats["chunks"] += len(rec["chunks"])
                stats["chunks_deduped"] += len(rec["chunks"])
                stats["bytes_deduped"] += int(rec["nbytes"])
                stats["leaves_reused"] += 1
                stats["bytes_reused"] += int(rec["nbytes"])
            return dict(rec)

        def do_leaf(lp):
            if lp.reuse is not None:
                rec = reuse_leaf(lp)
                if rec is not None:
                    return rec
            fut = encoded.get(lp.path)
            if fut is not None:
                # device stage: block on this leaf's landed result (the
                # stage keeps the NEXT leaf's encode + transfer in flight
                # while we chunk/write this one); a kernel failure
                # re-raises here and fails the dump
                stored, codec_meta = fut.result()
                raw_nbytes, orig_dtype, orig_shape = (
                    lp.nbytes, lp.dtype, list(lp.shape))
                with stats_lock:
                    stats["leaves_device"] += 1
            else:
                arr = np.asarray(arrays[lp.path])
                prev = prev_host_tree.get(lp.path) if lp.use_prev else None
                stored, codec_meta = encode_leaf(arr, lp.codec, prev,
                                                 device=device)
                raw_nbytes, orig_dtype, orig_shape = (
                    arr.nbytes, dtype_name(arr), list(arr.shape))
            data = chunking.leaf_to_bytes(np.asarray(stored))
            views = chunking.chunk_stream(data, plan.chunk_bytes,
                                          plan.chunking)
            rec = chunking.leaf_record(
                lp.path, np.asarray(stored), plan.chunk_bytes,
                codec=lp.codec, codec_meta=codec_meta,
                chunk_hashes=[h for h, _ in views], nbytes=len(data),
                chunking=plan.chunking,
                chunk_sizes=[len(v) for _, v in views])
            rec["orig_dtype"] = orig_dtype
            rec["orig_shape"] = orig_shape

            present = tier.has_chunks({h for h, _ in views})
            if crossjob and present:
                # TOCTOU close (cheap existence recheck): entries a
                # foreign gc invalidated fall out of ``present`` here and
                # are re-uploaded below instead of silently skipped
                confirmed = tier.verify_chunks(present)
                if len(confirmed) != len(present):
                    with stats_lock:
                        stats["chunks_reuploaded"] += \
                            len(present) - len(confirmed)
                present = confirmed
            to_write, deduped_bytes = [], 0
            with claim_lock:
                for h, v in views:
                    if h in present or h in claimed:
                        deduped_bytes += len(v)
                    else:
                        claimed.add(h)
                        to_write.append((h, v))

            if self._io is None:
                if upload_delta is not None:
                    upload_delta(to_write)
                else:
                    tier.write_chunks(to_write)
                for r in replicas:
                    r.write_chunks(views)
            else:
                if upload_delta is not None and to_write:
                    # one delta batch per leaf: absent chunks travel as
                    # batched parts on the transfer lanes (the io slot
                    # just shepherds the batch)
                    futs = [self._io.submit(upload_delta, to_write)]
                else:
                    futs = [self._io.submit(tier.write_chunk, h, v)
                            for h, v in to_write]
                for r in replicas:
                    # batched probe per replica too: don't fan out a
                    # no-op io task for every already-mirrored chunk
                    # (write_chunk still dedups the benign race where
                    # two leaves submit the same absent chunk)
                    rpresent = r.has_chunks({h for h, _ in views})
                    futs += [self._io.submit(r.write_chunk, h, v)
                             for h, v in views if h not in rpresent]
                for f in futs:
                    f.result()   # propagate the first write error

            with stats_lock:
                stats["bytes_raw"] += raw_nbytes
                stats["chunks"] += len(views)
                stats["chunks_deduped"] += len(views) - len(to_write)
                stats["bytes_deduped"] += deduped_bytes
                stats["bytes_stored"] += sum(len(v) for _, v in to_write)
            return rec

        if self._cpu is None:
            records = [do_leaf(lp) for lp in plan.leaves]
        else:
            futs = [self._cpu.submit(do_leaf, lp) for lp in plan.leaves]
            records = [f.result() for f in futs]
        return {"records": records, "stats": stats}

    # --------------------------------------------------------------- restore
    def make_leaf_resolver(self, plan, tier, replicas=(), device="cuda"):
        """resolve(image_id, path) -> decoded np.ndarray, with a shared
        (image_id, path) memo so delta8 parent leaves are fetched + decoded
        once per chain. This is the engine behind both run_restore (eager:
        resolve every top-image leaf) and the lazy LeafServer (post-copy:
        resolve on first access). Raises CorruptionError on unrepairable
        chunks."""
        memo: dict = {}             # (image_id, path) -> Future
        memo_lock = threading.Lock()

        def compute(iid, path):
            rec = plan.records[iid][path]
            bad = []
            uniq = list(dict.fromkeys(rec["chunks"]))
            if self._io is not None and len(uniq) > 1:
                pref = {h: self._io.submit(read_chunk_verified, tier,
                                           replicas, h, iid) for h in uniq}

                def fetch(h):
                    return pref[h].result()
            else:
                def fetch(h):
                    return read_chunk_verified(tier, replicas, h, iid)

            def read(h):
                try:
                    return fetch(h)
                except KeyError:
                    bad.append(h)
                    return b""

            stored = None
            try:
                stored = chunking.assemble_leaf(rec, read)
            except AssertionError:
                pass
            if bad or stored is None:
                raise CorruptionError(iid, bad or [path])

            prev = None
            if rec["codec"] == "delta8" and rec["codec_meta"].get("applied"):
                pid = plan.manifests[iid]["parent"]
                assert pid, f"delta8 leaf {path} without parent image"
                # a corrupt self-parent manifest must error, not block
                # forever on its own memo future
                assert pid != iid, f"cyclic parent chain at {iid}"
                prev = resolve(pid, path)
            return decode_leaf(stored, rec["codec"], rec["codec_meta"], prev,
                               device=device)

        def resolve(iid, path):
            key = (iid, path)
            with memo_lock:
                fut = memo.get(key)
                mine = fut is None
                if mine:
                    fut = memo[key] = Future()
            if not mine:
                return fut.result()
            try:
                out = compute(iid, path)
            except BaseException as e:
                fut.set_exception(e)
                raise
            fut.set_result(out)
            return out

        return resolve

    def run_restore(self, plan, tier, replicas=(), device="cuda") -> dict:
        """Execute a RestorePlan -> {path: decoded np.ndarray} for the
        plan's top image. Raises CorruptionError on unrepairable chunks."""
        resolve = self.make_leaf_resolver(plan, tier, replicas, device)
        top = plan.manifests[plan.image_id]["leaves"]
        if self._cpu is None:
            return {r["path"]: resolve(plan.image_id, r["path"])
                    for r in top}
        futs = {r["path"]: self._cpu.submit(resolve, plan.image_id,
                                            r["path"]) for r in top}
        return {p: f.result() for p, f in futs.items()}

    # ------------------------------------------------------------- utility
    def map_cpu(self, fn, items) -> list:
        """Run fn over items on the cpu pool (inline when serial), in
        order. Used by the pre-dump dirty classifier and lazy prefetch —
        anything that parallelizes like leaf encode does."""
        items = list(items)
        if self._cpu is None:
            return [fn(x) for x in items]
        return [f.result() for f in [self._cpu.submit(fn, x)
                                     for x in items]]

    def submit_cpu(self, fn, *args) -> Future | None:
        """Non-blocking cpu-pool submit; returns None on a serial engine
        (no pools — the caller runs ``fn`` inline at a point of its
        choosing). The sanctioned entry point for background leaf work
        (lazy prefetch), so callers never touch the private pools."""
        if self._cpu is None:
            return None
        return self._cpu.submit(fn, *args)

    # ------------------------------------------------------- transfer lanes
    def submit_transfer(self, fn, *args) -> Future | None:
        """Non-blocking submit onto the remote-transfer lanes — a pool
        SEPARATE from the chunk io pool, because multipart part-uploads
        fan out from INSIDE io-pool chunk writes: routing parts back onto
        the io pool would deadlock once every io worker is a chunk write
        blocked on its own parts. Returns None on a serial engine (the
        caller runs parts inline). Used by RemoteTier; see core/remote.py."""
        if self.serial:
            return None
        with self._xfer_lock:
            if self._xfer is None:
                self._xfer = ThreadPoolExecutor(
                    self._xfer_workers, thread_name_prefix="ckpt-xfer")
        return self._xfer.submit(fn, *args)

    # ----------------------------------------------------------- async lane
    def submit(self, fn) -> Future:
        """Enqueue fn on the single-threaded coordinator lane: jobs run
        strictly in submission order (commit ordering for async dumps), and
        each job fans its own leaf/chunk work onto the cpu/io pools."""
        with self._coord_lock:
            if self._coord is None:
                self._coord = ThreadPoolExecutor(
                    1, thread_name_prefix="ckpt-coord")
        return self._coord.submit(fn)

    def close(self):
        for pool in (self._coord, self._cpu, self._io, self._xfer):
            if pool is not None:
                pool.shutdown(wait=True)
        self._coord = self._cpu = self._io = self._xfer = None


_default: CheckpointExecutor | None = None
_default_lock = threading.Lock()


def get_default_executor() -> CheckpointExecutor:
    """Process-wide shared executor (one set of pools however many
    Checkpointers exist)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CheckpointExecutor()
        return _default
