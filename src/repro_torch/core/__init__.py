"""G-TRAC core: trust protocol + risk-bounded routing (port of
``repro.core``).

Public surface, as the reference's:
    from repro_torch.core import (AnchorRegistry, SeekerCache, ChainExecutor,
                                  gtrac_route, ALGORITHMS, trust_floor_for, ...)
"""
from repro_torch.core.executor import ChainExecutor, find_replacement, split_reports
from repro_torch.core.planner import CompiledGraph, RoutePlan, RoutePlanner, get_planner, plan_route
from repro_torch.core.registry import AnchorRegistry, SeekerCache
from repro_torch.core.risk import (
    chain_reliability,
    chain_risk,
    k_max,
    risk_bound,
    trust_floor_for,
    verify_design_guarantee,
)
from repro_torch.core.routing import (
    ALGORITHMS,
    brute_force_route,
    gtrac_route,
    heap_dijkstra_route,
    larac_route,
    mr_route,
    naive_route,
    sp_route,
)
from repro_torch.core.sharding import Registry, ShardedAnchorRegistry, make_registry, stable_peer_hash
from repro_torch.core.types import (
    ExecReport,
    HopReport,
    PeerRecord,
    PeerTable,
    RegistryState,
    RouteResult,
)

__all__ = [
    "AnchorRegistry", "SeekerCache", "ChainExecutor", "find_replacement",
    "split_reports", "chain_reliability", "chain_risk", "k_max", "risk_bound",
    "trust_floor_for", "verify_design_guarantee", "ALGORITHMS",
    "brute_force_route", "gtrac_route", "heap_dijkstra_route", "larac_route",
    "mr_route", "naive_route", "sp_route", "ExecReport", "HopReport",
    "PeerRecord", "PeerTable", "RegistryState", "RouteResult",
    "CompiledGraph", "RoutePlan", "RoutePlanner", "get_planner",
    "plan_route", "Registry", "ShardedAnchorRegistry", "make_registry",
    "stable_peer_hash",
]
