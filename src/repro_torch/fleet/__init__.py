"""repro_torch.fleet — the JAX package's DMTCP-style control plane over
the port's CheckpointSessions, on the in-process loopback wire.

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
  simcluster    SimCluster/SimJob/SimServeJob — a deterministic
                fleet-in-a-process (seeded arrivals, seeded mid-wave
                node failures, live serving planes as jobs) whose jobs
                hold their leaves on the cluster's device

The wire is the JAX package's, so this coordinator drives a JAX job's
FleetClient as readily as a torch one, and the reverse.

Not ported yet: fleet/transport.py, the real socket wire
(CoordinatorServer, FrameDecoder, FrameError, HandshakeError,
ReconnectPolicy, SocketTransport, WorkerAgent, coordinator_serve,
encode_frame, parse_url). ``FleetClient.connect`` and
``SimCluster(transport="socket")`` raise until it is."""
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

__all__ = [
    "ClusterTopology", "DrainAck", "DrainCommand", "ErrorReply",
    "FleetClient", "FleetCoordinator", "Heartbeat", "HostDownError",
    "HostInfo", "JobRecord", "JobRegistry", "LoopbackTransport",
    "PlacementDecision", "PlacementPlanner", "RestoreAck", "SimCluster",
    "SimJob", "SimServeJob", "WaveReport", "retarget_root",
]
