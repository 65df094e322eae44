"""repro_torch.api — the public surface of the port's checkpoint/restore
stack, mirroring the JAX package's repro.api:

    from repro_torch.api import (CheckpointSession, SessionConfig,
                                 DumpRequest, RestoreRequest)

    sess = CheckpointSession(SessionConfig(root="file:///ckpts/run17"),
                             device="cuda")
    sess.dump(DumpRequest(state=state, step=s, meta=meta))
    res = sess.restore(RestoreRequest())      # latest image, digest-checked
    state = res.state

The configuration, request and receipt types are copies of the JAX
package's (same fields, same wire schema ``WIRE_SCHEMA_VERSION``), so a
request built by either package decodes in the other. Async and pre-dump
modes, ``migrate``, lazy restore and ``capabilities`` are not ported yet.
"""
from __future__ import annotations

from repro_torch.api.config import (AsyncPolicy, CodecPolicy, MigrationPolicy,
                                    PreemptionPolicy, RetentionPolicy,
                                    SessionConfig)
from repro_torch.api.requests import (DumpReceipt, DumpRequest, MigrateRequest,
                                      MigrationTicket, RestoreRequest,
                                      RestoreResult)
from repro_torch.api.session import CheckpointSession
from repro_torch.api.wire import SCHEMA_VERSION as WIRE_SCHEMA_VERSION
from repro_torch.api.wire import WireCodingError, WireVersionError

API_VERSION = 1

__all__ = [
    "API_VERSION",
    # session
    "CheckpointSession",
    # configuration
    "SessionConfig", "RetentionPolicy", "CodecPolicy", "AsyncPolicy",
    "PreemptionPolicy", "MigrationPolicy",
    # typed requests / responses
    "DumpRequest", "DumpReceipt",
    "RestoreRequest", "RestoreResult",
    "MigrateRequest", "MigrationTicket",
    # wire contract (to_wire/from_wire on every type above)
    "WIRE_SCHEMA_VERSION", "WireVersionError", "WireCodingError",
]
