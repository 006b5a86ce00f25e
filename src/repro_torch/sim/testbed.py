"""The paper's heterogeneous edge testbed (§V-A), simulated: the sim
clock, the peers and their anchor.

Port of ``repro.sim.testbed`` (the ``Testbed`` class only, copied
verbatim). The reference's paper/scaling testbed builders and its churn,
partition and Byzantine drivers join the port with the sync plane and the
sharded registries.

The testbed provides fault-injection controls for the robustness experiments:
``crash_peers`` (heartbeats stop → TTL expiry) and ``partition`` (a subset
becomes unreachable for a time window).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import AnchorRegistry
from repro_torch.sim.peers import SimPeer


@dataclass
class Testbed:
    cfg: GTRACConfig
    total_layers: int
    peers: Dict[int, SimPeer]
    anchor: AnchorRegistry   # sharded registries join with core/sharding
    rng: np.random.Generator
    now: float = 0.0
    partitioned: set = field(default_factory=set)

    # -- time & liveness -----------------------------------------------------

    def advance(self, dt_s: float) -> None:
        """Advance sim clock; live peers heartbeat on the T_hb cadence.

        Heartbeats are applied as one batched stamp at the end of the window
        (every reachable peer would have heartbeated within T_hb ≪ T_ttl of
        it, so TTL liveness semantics are unchanged); crashed or partitioned
        peers keep their stale timestamp and expire naturally."""
        self.now += dt_s
        hb = self.now if dt_s >= self.cfg.heartbeat_s else None
        for p in self.peers.values():
            if p.alive and p.peer_id not in self.partitioned:
                self.anchor.heartbeat(p.peer_id, hb if hb is not None
                                      else self.now)

    # -- fault injection ------------------------------------------------------

    def crash_peers(self, peer_ids: Sequence[int]) -> None:
        for pid in peer_ids:
            if pid in self.peers:
                self.peers[pid].alive = False

    def recover_peers(self, peer_ids: Sequence[int]) -> None:
        for pid in peer_ids:
            if pid in self.peers:
                self.peers[pid].alive = True

    def partition(self, peer_ids: Sequence[int]) -> None:
        """Network partition: peers keep running but can't reach the anchor
        (heartbeats lost) nor serve hops."""
        self.partitioned |= set(peer_ids)

    def heal_partition(self) -> None:
        self.partitioned.clear()

    def reachable(self, peer_id: int) -> bool:
        p = self.peers.get(peer_id)
        return bool(p and p.alive and peer_id not in self.partitioned)

    # -- views -----------------------------------------------------------------

    def peers_by_profile(self, name: str) -> List[SimPeer]:
        return [p for p in self.peers.values() if p.profile.name == name]
