"""Core data types for the G-TRAC control plane (paper §III).

Port of ``repro.core.types``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class PeerRecord:
    """Anchor-side registry entry: (p, c_p, r_p, l̂_p) of Σ_t (§IV-A)."""

    peer_id: int
    layer_start: int            # hosts model layers [layer_start, layer_end)
    layer_end: int
    trust: float                # r_p(t) ∈ [0, 1]
    latency_est_ms: float       # l̂_p(t), EWMA-smoothed
    last_heartbeat: float = 0.0
    # bookkeeping (not used by routing; useful for analysis)
    successes: int = 0
    failures: int = 0
    profile: str = ""           # sim label: honeypot | turtle | golden | ...

    @property
    def num_layers(self) -> int:
        return self.layer_end - self.layer_start

    def segment(self):
        return (self.layer_start, self.layer_end)


@dataclass
class PeerTable:
    """Columnar snapshot of the registry — what routing actually consumes.

    The seeker's cached view Σ̃_t is a (possibly stale) PeerTable.

    ``version`` is the emitting registry's snapshot generation (a new
    number whenever the table *content* changed); ``topo_version`` bumps
    only on membership (register/deregister) changes so the route planner
    can reuse its compiled CSR graph across trust/latency updates;
    ``source_id`` disambiguates registries sharing a process. All three
    are -1 for tables built outside a registry (``from_records``).
    """

    peer_ids: np.ndarray        # (P,) int64
    layer_start: np.ndarray     # (P,) int32
    layer_end: np.ndarray       # (P,) int32
    trust: np.ndarray           # (P,) float64
    latency_ms: np.ndarray      # (P,) float64
    alive: np.ndarray           # (P,) bool
    snapshot_time: float = 0.0
    version: int = -1
    topo_version: int = -1
    source_id: int = -1

    def __len__(self) -> int:
        return len(self.peer_ids)

    @staticmethod
    def from_records(records: Sequence[PeerRecord], now: float,
                     ttl_s: float) -> "PeerTable":
        n = len(records)
        t = PeerTable(
            peer_ids=np.empty(n, np.int64),
            layer_start=np.empty(n, np.int32),
            layer_end=np.empty(n, np.int32),
            trust=np.empty(n, np.float64),
            latency_ms=np.empty(n, np.float64),
            alive=np.empty(n, bool),
            snapshot_time=now,
        )
        for i, r in enumerate(records):
            t.peer_ids[i] = r.peer_id
            t.layer_start[i] = r.layer_start
            t.layer_end[i] = r.layer_end
            t.trust[i] = r.trust
            t.latency_ms[i] = r.latency_est_ms
            t.alive[i] = (now - r.last_heartbeat) <= ttl_s
        return t

    def index_of(self, peer_id: int) -> int:
        idx = np.nonzero(self.peer_ids == peer_id)[0]
        if len(idx) == 0:
            raise KeyError(peer_id)
        return int(idx[0])


@dataclass
class RegistryState:
    """Columnar registry replication payload (anchor failover).

    The full per-peer state of an ``AnchorRegistry`` as a handful of
    column arrays — what primary→backup replication ships instead of a
    ``copy.deepcopy`` of the records dict. Arrays are shared zero-copy
    with the exporting registry's mirror except ``last_heartbeat`` (the
    only column mutated in place); adopters materialise records lazily.
    """

    peer_ids: np.ndarray        # (P,) int64
    layer_start: np.ndarray     # (P,) int32
    layer_end: np.ndarray       # (P,) int32
    trust: np.ndarray           # (P,) float64
    latency_ms: np.ndarray      # (P,) float64
    last_heartbeat: np.ndarray  # (P,) float64
    successes: np.ndarray       # (P,) int64
    failures: np.ndarray        # (P,) int64
    profiles: List[str] = field(default_factory=list)
    # global registration sequence numbers (core/sharding.py): lets a
    # replicated shard reconstruct the sharded registry's composed-snapshot
    # row order, so a promoted backup stays bit-identical to the primary.
    # None for monolithic registries (row order IS registration order).
    seq: Optional[np.ndarray] = None   # (P,) int64 or None

    def __len__(self) -> int:
        return len(self.peer_ids)


@dataclass
class RouteResult:
    """Output of a routing decision."""

    chain: List[int]            # peer ids, stage order (empty => infeasible)
    total_cost: float           # Σ C_p (algorithm-specific weight)
    reliability: float          # Π r_p under current estimates
    feasible: bool
    algorithm: str
    decision_time_ms: float = 0.0

    @property
    def hops(self) -> int:
        return len(self.chain)


@dataclass
class HopReport:
    peer_id: int
    latency_ms: float
    success: bool


@dataclass
class ExecReport:
    """Execution trace reported back to the Anchor (Alg. 1 line 16)."""

    success: bool
    chain: List[int]
    hops: List[HopReport] = field(default_factory=list)
    failed_peer: Optional[int] = None
    repaired: bool = False
    repair_peer: Optional[int] = None
    total_latency_ms: float = 0.0
