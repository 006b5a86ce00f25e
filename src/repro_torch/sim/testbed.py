"""The paper's 336-peer heterogeneous testbed (§V-A), simulated.

GPT-2-Large (36 layers) partitioned into contiguous shards of 3, 6, or 9
layers; multiple virtual replicas per shard slot with software-defined
performance–reliability profiles (honeypot / turtle / golden). The default
mix gives every slot replicas of each profile so that every algorithm has a
feasible chain, and honeypots dominate the low-latency frontier — the trap
that breaks latency-greedy routing (§VI-A).

Port of ``repro.sim.testbed``, copied verbatim for the monolithic anchor:
``Testbed``, ``ChurnStats`` / ``run_churn``, ``build_paper_testbed`` and
``build_scaling_testbed``. ``Testbed.crash_anchor_shard`` and the
partition and Byzantine drivers belong to the sharded registries and the
sync plane and join the port with them (``make_registry`` raises for
``shards > 1``).

The testbed provides fault-injection controls for the robustness experiments:
``crash_peers`` (heartbeats stop → TTL expiry) and ``partition`` (a subset
becomes unreachable for a time window).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.registry import AnchorRegistry
from repro_torch.core.sharding import make_registry
from repro_torch.sim.peers import PROFILES, SimPeer, make_peer

GPT2_LARGE_LAYERS = 36
SHARD_SIZES = (3, 6, 9)


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


@dataclass
class ChurnStats:
    """Outcome of ``run_churn``: what membership churn did to the anchor."""

    joined: int = 0
    crashed: int = 0
    expired: int = 0              # TTL-swept by per-window sweeps
    windows: int = 0
    snapshots_rebuilt: int = 0    # composed/zero-copy snapshot rebuilds
    final_peers: int = 0


def run_churn(bed: Testbed, windows: int = 10, window_s: float = 2.0,
              joins_per_window: int = 2, crashes_per_window: int = 2,
              expire_after_s: Optional[float] = None,
              profile: str = "golden") -> ChurnStats:
    """Membership churn driver (shard-aware when the anchor is sharded).

    Each window: crash a few random live peers (heartbeats stop), register
    a few fresh replicas on random shard slots (the registry routes them to
    their owning anchor shard by stable peer-id hash), advance the clock,
    sweep (TTL-expiring peers dead longer than ``expire_after_s``, default
    2 x node_ttl_s), and take a composed snapshot. Only shards whose
    membership actually moved rebuild their snapshot columns; the stats
    count how many windows rebuilt at all."""
    cfg = bed.cfg
    if expire_after_s is None:
        expire_after_s = 2.0 * cfg.node_ttl_s
    slots = []
    for size in SHARD_SIZES:
        for s in range(0, bed.total_layers, size):
            slots.append((s, s + size))
    stats = ChurnStats()
    next_pid = max(bed.peers) + 1 if bed.peers else 0
    prev = bed.anchor.snapshot(bed.now)
    for _ in range(windows):
        live = [pid for pid, p in bed.peers.items() if p.alive]
        k = min(crashes_per_window, max(0, len(live) - 1))
        if k:
            idx = bed.rng.choice(len(live), size=k, replace=False)
            bed.crash_peers([live[i] for i in idx])
            stats.crashed += k
        for _ in range(joins_per_window):
            s, e = slots[int(bed.rng.integers(len(slots)))]
            peer = make_peer(next_pid, s, e, PROFILES[profile], bed.rng)
            bed.peers[next_pid] = peer
            bed.anchor.register(next_pid, s, e, now=bed.now, profile=profile)
            bed.anchor.heartbeat(next_pid, bed.now)
            next_pid += 1
            stats.joined += 1
        bed.advance(window_s)
        stats.expired += bed.anchor.sweep(bed.now,
                                          expire_after_s=expire_after_s)
        table = bed.anchor.snapshot(bed.now)
        stats.snapshots_rebuilt += int(table is not prev)
        prev = table
        stats.windows += 1
    stats.final_peers = len(bed.anchor.snapshot(bed.now))
    return stats


def build_paper_testbed(cfg: Optional[GTRACConfig] = None,
                        seed: int = 0,
                        total_layers: int = GPT2_LARGE_LAYERS,
                        replicas_per_slot: Dict[str, int] = None,
                        shards: int = 1,
                        ) -> Testbed:
    """336 concurrent peers spanning all pipeline stages (§V-A).

    Slots: 36/3 + 36/6 + 36/9 = 12 + 6 + 4 = 22 shard slots.
    Default replicas per slot: 5 honeypot + 5 turtle + 5 golden = 15
    → 22 × 15 = 330, topped up to 336 with extra honeypots on the first
    slots of each granularity (the paper's honey-pot-rich search space).
    """
    cfg = cfg or GTRACConfig()
    rng = np.random.default_rng(seed)
    anchor = make_registry(cfg, shards=shards, shard_by=cfg.shard_by)
    # profile proportions are not published; this mix reproduces the paper's
    # Fig. 3 ordering and magnitudes (see EXPERIMENTS.md §Reproduction)
    replicas = replicas_per_slot or {"honeypot": 4, "turtle": 5, "golden": 6}

    peers: Dict[int, SimPeer] = {}
    pid = 0

    def add(start: int, end: int, profile_name: str):
        nonlocal pid
        peer = make_peer(pid, start, end, PROFILES[profile_name], rng)
        peers[pid] = peer
        anchor.register(pid, start, end, now=0.0, profile=profile_name,
                        latency_ms=cfg.init_latency_ms)
        anchor.heartbeat(pid, 0.0)
        pid += 1

    slots = []
    for size in SHARD_SIZES:
        for s in range(0, total_layers, size):
            slots.append((s, s + size))
    for (s, e) in slots:
        for name, n in replicas.items():
            for _ in range(n):
                add(s, e, name)
    # top up to 336 with honeypots (the adversarial frontier)
    i = 0
    while pid < 336:
        s, e = slots[i % len(slots)]
        add(s, e, "honeypot")
        i += 1
    return Testbed(cfg=cfg, total_layers=total_layers, peers=peers,
                   anchor=anchor, rng=rng)


def build_scaling_testbed(n_peers: int, cfg: Optional[GTRACConfig] = None,
                          seed: int = 0,
                          total_layers: int = GPT2_LARGE_LAYERS,
                          shards: int = 1) -> Testbed:
    """Uniform-random testbed for the decision-overhead experiment (§VI-E):
    N peers spread across shard slots with mixed profiles."""
    cfg = cfg or GTRACConfig()
    rng = np.random.default_rng(seed)
    anchor = make_registry(cfg, shards=shards, shard_by=cfg.shard_by)
    peers: Dict[int, SimPeer] = {}
    slots = []
    for size in SHARD_SIZES:
        for s in range(0, total_layers, size):
            slots.append((s, s + size))
    names = list(PROFILES)
    for pid in range(n_peers):
        s, e = slots[pid % len(slots)]
        name = names[int(rng.integers(len(names)))]
        peer = make_peer(pid, s, e, PROFILES[name], rng)
        peers[pid] = peer
        anchor.register(pid, s, e, now=0.0, profile=name,
                        trust=float(rng.uniform(0.5, 1.0)),
                        latency_ms=float(rng.uniform(20, 400)))
        anchor.heartbeat(pid, 0.0)
    return Testbed(cfg=cfg, total_layers=total_layers, peers=peers,
                   anchor=anchor, rng=rng)
