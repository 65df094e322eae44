"""repro_torch.fleet — the JAX package's DMTCP-style control plane, in
part. Only ``messages`` (the control-plane vocabulary: Heartbeat,
DrainCommand/DrainAck, RestoreAck, ErrorReply, a copy of the JAX
package's framework-free module) is ported, so the port's wire decodes
the fleet's frames. The registry, topology, placement, coordinator,
client, transport and simcluster are not ported yet."""
from repro_torch.fleet.messages import (DrainAck, DrainCommand, ErrorReply,
                                        Heartbeat, RestoreAck)

__all__ = ["DrainAck", "DrainCommand", "ErrorReply", "Heartbeat",
           "RestoreAck"]
