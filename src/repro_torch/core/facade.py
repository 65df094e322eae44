"""Deprecation shim: the pre-api ``Checkpointer`` facade as a thin wrapper
over a CheckpointSession, as in the JAX package's core/facade.py. New code
should open a session (repro_torch.api). Constructing it emits a
DeprecationWarning; importing this module does not. The async facade
(AsyncCheckpointer) is not ported yet."""
from __future__ import annotations

import warnings

from repro_torch.api import (CheckpointSession, CodecPolicy, RetentionPolicy,
                             SessionConfig)


class Checkpointer(CheckpointSession):
    """Legacy facade == a CheckpointSession opened from loose kwargs, on
    ``device`` ("cuda" by default). ``wait()`` returns raw result dicts
    and ``root`` aliases the resolved tier."""

    def __init__(self, root, *, replicas=(), keep_last: int = 3,
                 keep_every: int = 0, codec_policy=None,
                 incremental: bool = True, chunk_bytes: int | None = None,
                 serial: bool = False, executor=None, device="cuda"):
        warnings.warn("repro_torch.core.Checkpointer is deprecated; use "
                      "repro_torch.api.CheckpointSession",
                      DeprecationWarning, stacklevel=2)
        super().__init__(SessionConfig(
            root=root, replicas=tuple(replicas),
            retention=RetentionPolicy(keep_last=keep_last,
                                      keep_every=keep_every),
            codec=CodecPolicy(custom=codec_policy, incremental=incremental),
            chunk_bytes=chunk_bytes, serial=serial, executor=executor),
            device=device)
        self.root = self.tier
