"""Async checkpointing: keep dump I/O off the training critical path (the
JAX package's core/async_engine.py on tensors).

dump_async() captures the state synchronously and submits the dump as a job
on the shared CheckpointExecutor's ordered coordinator lane: jobs commit
strictly in submission order (the incremental parent chain stays causal)
while each job's leaf encode/hash and chunk I/O fan out on the executor's
cpu/io pools. wait() surfaces job errors and enforces ordering; max_pending
bounds how many captured host trees can be alive at once (memory
backpressure).

The capture. The JAX package's ``device_get`` is a copy by construction;
the port's train step and AdamW update params, m and v in place, so the
job must never read a live tensor. ``dump_async`` copies every leaf to the
host (a blocking ``.cpu()`` per leaf on the card, a clone on the CPU: see
device.to_host) and the copy is complete before it returns. The job then
encodes that copy with the host codec (``device="cpu"``, device codec
stage off): it never touches the card, so it cannot race the steps that
run meanwhile, and it uses no stream of theirs. That is the rule for every
async dump, not a fallback: a sync dump still encodes on the card. A
sharded state is captured by gathering each leaf to rank 0 and copying it
to rank 0's host (api/session.py), the port's ``device_get``."""
from __future__ import annotations

import threading

from repro_torch.core.dump import dump as _dump_fn
from repro_torch.core.dump import host_tree_by_path
from repro_torch.core.executor import CheckpointExecutor, get_default_executor
from repro_torch.core.restore import _unflatten_paths


class AsyncCheckpointer:
    def __init__(self, root, *, replicas=(), max_pending: int = 2,
                 executor: CheckpointExecutor | None = None):
        self.root = root
        self.replicas = replicas
        self.max_pending = max_pending
        self._ex = executor or get_default_executor()
        self._pending: list = []    # futures, submission order
        self._results: list = []
        self._errors: list = []
        self._lock = threading.Lock()
        # hard memory-backpressure bound: one permit per captured host
        # tree, released when its job finishes (a check-then-append on
        # the pending list would let concurrent callers overshoot)
        self._slots = threading.Semaphore(max_pending)

    def dump_async(self, tree, *, resolve_parent: bool = False,
                   baseline_step: int | None = None,
                   baseline_image: str | None = None,
                   capture=host_tree_by_path, **kw) -> dict:
        """Captures (a finished host copy of every leaf: ``capture(tree)``
        -> {path: array}) then submits the write job; returns the capture
        (read-only: the job encodes it). Blocks only if max_pending dumps
        are already in flight, before it captures.

        resolve_parent: re-resolve the incremental parent link when the job
        RUNS (the previous ordered dump has committed by then) instead of
        at submit time — submit-time resolution would miss still-in-flight
        parents and break the chain.

        baseline_step/baseline_image: the step (and, when the caller
        tracked one, the image id) whose image kw's ``prev_host_tree`` is
        the content of. A delta8 leaf is only valid if it is decoded
        against the same values it was encoded against, so if the run-time
        parent is a different image (the baseline's dump failed or its
        image was reaped) the delta baseline is dropped — full encode
        beats silent corruption."""
        self._slots.acquire()   # blocks while max_pending trees are alive
        kw.update(device="cpu", device_codec="off", device_source=None)

        def job():
            try:
                try:
                    if resolve_parent and kw.get("parent") is None:
                        from repro_torch.core.registry import Registry
                        kw["parent"], kw["prev_host_tree"] = \
                            Registry(self.root).resolve_parent_baseline(
                                baseline_step, kw.get("prev_host_tree"),
                                kw["step"], baseline_image=baseline_image)
                    out = _dump_fn(_unflatten_paths(host_tree), self.root,
                                   replicas=self.replicas,
                                   executor=self._ex, **kw)
                    with self._lock:
                        self._results.append(out)
                except Exception as e:     # surfaced on wait()
                    with self._lock:
                        self._errors.append(e)
            finally:
                self._slots.release()

        try:
            host_tree = capture(tree)   # finished copies
            with self._lock:
                self._pending = [f for f in self._pending if not f.done()]
                self._pending.append(self._ex.submit(job))
        except BaseException:
            self._slots.release()
            raise
        return host_tree

    def wait(self):
        """Barrier: all dumps enqueued since the last barrier durable (or
        raise). Errors are drained per barrier — a failure surfaced here
        must not resurface on a later, healthy barrier — but the results
        of dumps that DID commit survive an error and are returned by the
        next wait(): they are durable on disk and the caller is owed the
        record."""
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            errors, self._errors = self._errors, []
            if errors:
                raise errors[0]
            results, self._results = self._results, []
            return results

    def close(self):
        self.wait()
