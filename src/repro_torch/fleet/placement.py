"""Restore placement: score hosts by hot-cache overlap with the image.

The image manifest already names every chunk the restore will read
(leaf ``chunks`` lists, plus the parent chain for delta/incremental
images). A host whose hot front holds those chunks serves the restore
at cache speed; everyone else pays the cold remote. The planner is
nothing but that observation made into a score:

    overlap(host) = |image chunks ∩ host hot inventory| / |image chunks|

Prefer the warmest host with free device capacity; break ties toward
the least-loaded host, then lexical host id (determinism). A fleet
with no warm peer falls back to the least-loaded cold host — restores
always place somewhere."""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core import storage


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """Where a restore should land and why — kept as plain data so wave
    reports and benchmarks can record the planner's reasoning."""
    job_id: str
    host: str
    overlap: float                 # fraction of image chunks already hot
    chunks_total: int
    chunks_warm: int
    scores: dict                   # host_id -> overlap fraction considered
    chunks_peer: int = 0           # chunks cold here but hot on a peer —
    #                                what peer-aware fetch saves from the
    #                                cold remote after wire_peer_fetch
    peer_hosts: tuple = ()         # peers (nearest first) contributing them


def image_chunk_set(tier, image_id: str) -> frozenset:
    """Every chunk hash a restore of ``image_id`` may read: the image's
    own leaves plus its parent chain (delta8 leaves decode against
    parent leaves, incremental leaves reference parent chunks
    directly)."""
    chunks: set = set()
    seen: set = set()
    while image_id and image_id not in seen:
        seen.add(image_id)
        man = json.loads(bytes(
            tier.read_bytes(f"images/{image_id}/manifest.json")))
        for leaf in man.get("leaves", ()):
            chunks.update(leaf.get("chunks", ()))
        image_id = man.get("parent")
    return frozenset(chunks)


class PlacementPlanner:
    """Score-and-choose over a ClusterTopology + JobRegistry."""

    def __init__(self, topology, registry):
        self.topology = topology
        self.registry = registry

    def image_chunks(self, job) -> frozenset:
        tier = storage.as_tier(job.root_uri)
        if job.image_id is None:
            return frozenset()
        return image_chunk_set(tier, job.image_id)

    def plan(self, job, *, exclude: tuple = (),
             devices_needed: int = 1) -> PlacementDecision:
        """Choose a host for ``job``'s next incarnation. ``exclude``
        removes hosts beyond the dead ones (e.g. "anywhere but where it
        just died", even if that host claims to be back)."""
        chunks = self.image_chunks(job)
        load = self.topology.device_load(self.registry)
        candidates = [h for h in self.topology.hosts()
                      if h.host_id not in exclude
                      and load.get(h.host_id, 0) + devices_needed
                      <= h.devices]
        if not candidates:
            raise RuntimeError(
                f"no live host with {devices_needed} free device(s) for "
                f"job {job.job_id!r} (excluded: {list(exclude)})")
        scores = {}
        for h in candidates:
            inv = self.topology.hot_inventory(h.host_id)
            scores[h.host_id] = (len(chunks & inv) / len(chunks)) \
                if chunks else 0.0
        best = max(candidates,
                   key=lambda h: (scores[h.host_id],
                                  -load.get(h.host_id, 0),
                                  # lexical id LAST and negated-ordinal
                                  # free: sort by id descending is fine
                                  # as long as it is deterministic
                                  h.host_id))
        # what the chosen host can still avoid pulling from cold: chunks
        # not warm locally but hot on some peer (nearest-first credit,
        # each chunk counted once) — the coordinator wires this via
        # topology.wire_peer_fetch before the restore runs
        missing = chunks - self.topology.hot_inventory(best.host_id)
        peer_hosts, covered = [], set()
        for peer in self.topology.nearest_peers(best.host_id):
            gain = (missing - covered) \
                & self.topology.hot_inventory(peer)
            if gain:
                peer_hosts.append(peer)
                covered |= gain
        return PlacementDecision(
            job_id=job.job_id, host=best.host_id,
            overlap=scores[best.host_id], chunks_total=len(chunks),
            chunks_warm=int(round(scores[best.host_id] * len(chunks))),
            scores=scores, chunks_peer=len(covered),
            peer_hosts=tuple(peer_hosts))

    def plan_random(self, job, *, exclude: tuple = (), rng=None,
                    devices_needed: int = 1) -> PlacementDecision:
        """Cache-blind baseline: uniform choice over feasible hosts —
        what the placement benchmark compares the planner against."""
        load = self.topology.device_load(self.registry)
        candidates = [h for h in self.topology.hosts()
                      if h.host_id not in exclude
                      and load.get(h.host_id, 0) + devices_needed
                      <= h.devices]
        if not candidates:
            raise RuntimeError(f"no live host for job {job.job_id!r}")
        idx = 0 if rng is None else int(rng.integers(len(candidates)))
        host = sorted(candidates, key=lambda h: h.host_id)[idx]
        chunks = self.image_chunks(job)
        inv = self.topology.hot_inventory(host.host_id)
        overlap = (len(chunks & inv) / len(chunks)) if chunks else 0.0
        return PlacementDecision(
            job_id=job.job_id, host=host.host_id, overlap=overlap,
            chunks_total=len(chunks),
            chunks_warm=len(chunks & inv), scores={host.host_id: overlap})
