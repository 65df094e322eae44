"""Deprecation shims: the pre-api facades as thin wrappers over a
CheckpointSession and its async engine, as in the JAX package's
core/facade.py. New code should open a session (repro_torch.api).
Constructing either facade emits a DeprecationWarning; importing this
module does not."""
from __future__ import annotations

import warnings

from repro_torch.api import (CheckpointSession, CodecPolicy, RetentionPolicy,
                             SessionConfig)
from repro_torch.core.async_engine import AsyncCheckpointer as _AsyncEngine
from repro_torch.device import resolve_device


def _deprecated(old: str, new: str):
    warnings.warn(f"repro_torch.core.{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


class Checkpointer(CheckpointSession):
    """Legacy facade == a CheckpointSession opened from loose kwargs, on
    ``device`` ("cuda" by default). ``wait()`` returns raw result dicts
    and ``root`` aliases the resolved tier."""

    def __init__(self, root, *, replicas=(), keep_last: int = 3,
                 keep_every: int = 0, codec_policy=None,
                 incremental: bool = True, chunk_bytes: int | None = None,
                 serial: bool = False, executor=None, device="cuda"):
        _deprecated("Checkpointer", "repro_torch.api.CheckpointSession")
        super().__init__(SessionConfig(
            root=root, replicas=tuple(replicas),
            retention=RetentionPolicy(keep_last=keep_last,
                                      keep_every=keep_every),
            codec=CodecPolicy(custom=codec_policy, incremental=incremental),
            chunk_bytes=chunk_bytes, serial=serial, executor=executor),
            device=device)
        self.root = self.tier

    def wait(self):
        return self._wait_raw()


class AsyncCheckpointer(_AsyncEngine):
    """Legacy standalone async facade. The engine itself lives in
    core/async_engine.py (sessions submit to it without a shim); this
    subclass adds the deprecation signal and the entry point's ``device``
    check ("cuda" by default; raises without a card unless "cpu" is asked
    for). Its dumps encode their host capture with the host codec, as
    every async dump does."""

    def __init__(self, root, *, replicas=(), max_pending: int = 2,
                 executor=None, device="cuda"):
        _deprecated("AsyncCheckpointer",
                    "repro_torch.api.CheckpointSession with "
                    "DumpRequest(mode='async') / AsyncPolicy")
        self.device = resolve_device(device)
        super().__init__(root, replicas=replicas, max_pending=max_pending,
                         executor=executor)
