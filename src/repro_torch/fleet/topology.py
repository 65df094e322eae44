"""Cluster topology: hosts, device capacity, and hot-cache inventory.

A host is a device count plus whatever its tiers already know: every
``cache+remote://...?front=<host>`` registration IS that host's hot
cache, and its chunk index IS the inventory. The topology model
therefore owns no second bookkeeping — ``hot_inventory`` enumerates the
live tier registrations (``storage.registered_tiers()``, the public
introspection door) and unions the chunk-index snapshots of the fronts
pinned to the host. Warm is not declared; it is observed.

``retarget_root`` is the placement planner's output made concrete: the
same wire-level session config, with the ``front=`` query parameter
rewritten to the chosen host — the coordinator edits job descriptions
as data, never as objects."""
from __future__ import annotations

import dataclasses
import threading
from urllib.parse import parse_qs

from repro_torch.core import storage


@dataclasses.dataclass
class HostInfo:
    """One schedulable host: identity, capacity, liveness."""
    host_id: str
    devices: int = 8
    alive: bool = True


def front_of(uri: str) -> str:
    """The ``front=`` host pin of a tier URI ("" when unpinned)."""
    _, _, query = uri.partition("?")
    if not query:
        return ""
    vals = parse_qs(query).get("front", [])
    return vals[-1] if vals else ""


def retarget_root(config_wire: dict, host_id: str) -> dict:
    """Rewrite a wire-level SessionConfig's root tier onto ``host_id``'s
    hot front (the ``front=`` query parameter). Pure data -> data: this
    is how a placement decision becomes the next incarnation's config.

    Example::

        cfg = retarget_root(job.config_wire, "h3")
        # "cache+remote://ck?front=h0&prefix=j1" ->
        # "cache+remote://ck?front=h3&prefix=j1"
    """
    root = config_wire["root"]
    if not isinstance(root, str) or "://" not in root:
        return dict(config_wire)
    base, _, query = root.partition("?")
    parts = [p for p in query.split("&")
             if p and not p.startswith("front=")]
    parts.append(f"front={host_id}")
    out = dict(config_wire)
    out["root"] = base + "?" + "&".join(parts)
    return out


class ClusterTopology:
    """Hosts + live inventory. All mutation is lock-protected; inventory
    reads go straight to the tier registry (no copy to go stale)."""

    def __init__(self):
        self._hosts: dict = {}
        self._links: dict = {}      # frozenset({a, b}) -> cost
        self._lock = threading.Lock()

    # -------------------------------------------------------------- hosts
    def add_host(self, host_id: str, *, devices: int = 8) -> HostInfo:
        with self._lock:
            if host_id in self._hosts:
                raise ValueError(f"host {host_id!r} already in topology")
            info = HostInfo(host_id=host_id, devices=int(devices))
            self._hosts[host_id] = info
            return info

    def get(self, host_id: str) -> HostInfo:
        with self._lock:
            return self._hosts[host_id]

    def hosts(self, *, alive_only: bool = True) -> list:
        with self._lock:
            infos = list(self._hosts.values())
        return [h for h in infos if h.alive or not alive_only]

    def fail_host(self, host_id: str):
        """Mark a host dead: it stops being a placement candidate and its
        hot fronts stop counting as warm. The COLD store is unaffected —
        that is the whole point of write-through dumps."""
        with self._lock:
            self._hosts[host_id].alive = False

    def alive(self, host_id: str) -> bool:
        with self._lock:
            h = self._hosts.get(host_id)
            return bool(h and h.alive)

    # -------------------------------------------------------------- links
    def set_link(self, a: str, b: str, cost: float):
        """Relative transfer cost between two hosts (symmetric; rack
        locality, zone crossings — any monotone distance). Unset pairs
        default to 1.0, self-distance is 0.0."""
        with self._lock:
            self._links[frozenset((a, b))] = float(cost)

    def link_cost(self, a: str, b: str) -> float:
        if a == b:
            return 0.0
        with self._lock:
            return self._links.get(frozenset((a, b)), 1.0)

    def nearest_peers(self, host_id: str) -> list:
        """Alive hosts other than ``host_id``, nearest first (link cost,
        then host id for determinism) — the order peer-fetch tries them."""
        return [h.host_id for h in sorted(
            (h for h in self.hosts() if h.host_id != host_id),
            key=lambda h: (self.link_cost(host_id, h.host_id), h.host_id))]

    def wire_peer_fetch(self, host_id: str) -> int:
        """Point every hot front pinned to ``host_id`` at its peers' hot
        fronts, nearest first: a restore placed on ``host_id`` then
        fetches each chunk from the closest peer's hot cache (LAN-speed,
        hash-verified) before falling back to the cold remote. Returns
        the number of peer fronts wired (0 when the host has no fronts
        or the fleet no warm peers)."""
        peer_fronts = []
        for peer in self.nearest_peers(host_id):
            for tier in self.host_fronts(peer):
                hot = getattr(tier, "hot", None)
                if hot is not None:
                    peer_fronts.append(hot)
        wired = 0
        for tier in self.host_fronts(host_id):
            if hasattr(tier, "set_peers"):
                tier.set_peers(peer_fronts)
                wired = len(peer_fronts)
        return wired

    # ---------------------------------------------------------- inventory
    def host_fronts(self, host_id: str) -> list:
        """The live cache tiers pinned to this host: every registered
        ``cache+remote://`` URI whose ``front=`` names it."""
        return [tier for uri, tier in storage.registered_tiers().items()
                if uri.startswith("cache+remote://")
                and front_of(uri) == host_id]

    def hot_inventory(self, host_id: str) -> frozenset:
        """Union of the host's hot-front chunk indexes — the set of chunk
        hashes a restore placed here would NOT pull from cold. Fronts
        without an index yet get one enabled on their (in-memory) hot
        layer; afterwards normal writes/fills keep it current."""
        if not self.alive(host_id):
            return frozenset()
        chunks: set = set()
        for tier in self.host_fronts(host_id):
            snap = tier.chunk_index_snapshot()
            if snap is None:
                tier.hot.enable_chunk_index()
                snap = tier.chunk_index_snapshot() or frozenset()
            chunks |= snap
        return frozenset(chunks)

    def device_load(self, registry) -> dict:
        """host_id -> jobs currently placed there (capacity accounting
        for the planner; a restoring job still occupies its claim)."""
        load: dict = {h.host_id: 0 for h in self.hosts(alive_only=False)}
        for rec in registry.jobs():
            if rec.host in load and rec.phase not in ("dead", "lost"):
                load[rec.host] += 1
        return load
