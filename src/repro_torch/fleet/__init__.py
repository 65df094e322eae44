"""repro_torch.fleet — the JAX package's DMTCP-style control plane over
the port's CheckpointSessions, over the in-process loopback wire or real
sockets.

CRIU checkpoints one process tree; DMTCP adds the piece HPC fleets
actually operate: a COORDINATOR that speaks a wire protocol to many
jobs and orchestrates global checkpoint/restart without ever touching
their memory. Each module is a copy of the JAX package's, over the
port's wire, storage and remote tiers:

  registry      JobRegistry — job id -> wire-level config, placement,
                last committed image, heartbeat liveness (with a CAS
                restore claim: no double restores, ever)
  topology      ClusterTopology — hosts, device capacity, and hot-cache
                inventory read from the port's live tier registrations
  placement     PlacementPlanner — score hosts by hot-chunk overlap
                with the image manifest; warm peers first, cold remote
                as the fallback
  coordinator   FleetCoordinator — global preemption waves (concurrent
                drain, then dumps STAGGERED under a bandwidth budget so
                the shared store stays below its overload knee),
                node-failure re-placement, heartbeat sweeps
  client        FleetClient + LoopbackTransport — the job-side endpoint
                that owns the session (on an explicit device) and the
                live tensors; every coordinator<->job interaction is a
                JSON-round-tripped wire frame (repro_torch.api.wire)
  messages      the control-plane vocabulary: Heartbeat, DrainCommand/
                DrainAck, RestoreAck, ErrorReply
  transport     the REAL wire — framed TCP/UDS sockets under the same
                contract: HELLO handshake with (job_id, incarnation),
                sequence numbers + dedup window (reconnect-and-resume,
                at-most-once execution), coordinator_serve() with a
                journaled registry that survives coordinator restarts
  simcluster    SimCluster/SimJob/SimServeJob — a deterministic
                fleet-in-a-process (seeded arrivals, seeded mid-wave
                node failures, live serving planes as jobs) whose jobs
                hold their leaves on the cluster's device

The wire is the JAX package's, frames byte for byte, so this coordinator
drives a JAX job's FleetClient as readily as a torch one, over loopback
or a socket, and the reverse; a journal either coordinator writes, the
other re-adopts."""
from repro_torch.fleet.client import FleetClient, HostDownError, \
    LoopbackTransport
from repro_torch.fleet.coordinator import FleetCoordinator, WaveReport
from repro_torch.fleet.messages import (DrainAck, DrainCommand, ErrorReply,
                                        Heartbeat, RestoreAck)
from repro_torch.fleet.placement import PlacementDecision, PlacementPlanner
from repro_torch.fleet.registry import JobRecord, JobRegistry
from repro_torch.fleet.simcluster import SimCluster, SimJob, SimServeJob
from repro_torch.fleet.topology import ClusterTopology, HostInfo, \
    retarget_root
from repro_torch.fleet.transport import (CoordinatorServer, FrameDecoder,
                                         FrameError, HandshakeError,
                                         ReconnectPolicy, SocketTransport,
                                         WorkerAgent, coordinator_serve,
                                         encode_frame, parse_url)

__all__ = [
    "ClusterTopology", "CoordinatorServer", "DrainAck", "DrainCommand",
    "ErrorReply", "FleetClient", "FleetCoordinator", "FrameDecoder",
    "FrameError", "HandshakeError", "Heartbeat", "HostDownError",
    "HostInfo", "JobRecord", "JobRegistry", "LoopbackTransport",
    "PlacementDecision", "PlacementPlanner", "ReconnectPolicy",
    "RestoreAck", "SimCluster", "SimJob", "SimServeJob",
    "SocketTransport", "WaveReport", "WorkerAgent", "coordinator_serve",
    "encode_frame", "parse_url", "retarget_root",
]
