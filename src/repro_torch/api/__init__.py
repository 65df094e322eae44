"""repro_torch.api — the public surface of the port's checkpoint/restore
stack, mirroring the JAX package's repro.api:

    from repro_torch.api import (CheckpointSession, SessionConfig,
                                 DumpRequest, MigrateRequest, RestoreRequest)

    with CheckpointSession(SessionConfig(root="file:///ckpts/run17"),
                           device="cuda") as sess:
        sess.dump(DumpRequest(state=state, step=s, meta=meta))
        if sess.should_migrate():             # SIGTERM flagged at a step
            sys.exit(sess.migrate(MigrateRequest(state=state)).exit_code)
    res = sess.restore(RestoreRequest())      # latest image, digest-checked
    state = res.state

The configuration, request and receipt types are copies of the JAX
package's (same fields, same wire schema ``WIRE_SCHEMA_VERSION``), so a
request built by either package decodes in the other. Sync, async and
pre-dump modes, ``migrate`` and its polls (``should_migrate``,
``should_predump``, ``pre_dump_round``, ``observe_step``), signal
handlers and eager and lazy restore are ported, and so is the `criu check`
probe ``capabilities`` (``capabilities(device="cpu")`` probes the plain
versions; its names and ``TABLE1``, the paper's Table-1 row registry, are
the JAX package's). ``API_VERSION`` is the JAX package's too, and
tests/test_torch_capabilities.py holds the names, fields, signatures and
wire schema to its snapshot. Tiers are URI-addressed: file://, mem://, remote://
and cache+remote:// (a simulated object store with retried multipart
transfers, and a write-through hot front over it).
"""
from __future__ import annotations

from repro_torch.api.capabilities import (TABLE1, Capability,
                                          CapabilityReport, capabilities)
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
    # `criu check`: environment probe + the paper's Table-1 registry
    "capabilities", "Capability", "CapabilityReport", "TABLE1",
]
