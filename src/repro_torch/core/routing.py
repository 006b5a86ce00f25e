"""Routing algorithms (paper §IV + §V-B baselines).

Port of ``repro.core.routing``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.

All algorithms consume a ``PeerTable`` snapshot (the seeker's cached view)
and the model's layer count, and return a ``RouteResult``. The routing graph
is the layered DAG of §III-A: peer p_i → p_j is a feasible handover iff
``layer_end(i) == layer_start(j)``; a valid chain covers [0, L).

Implemented:
  * ``gtrac_route``  — trust-floor pruning + shortest path on C_p (Alg. 1, lines 1–3)
  * ``sp_route``     — latency-only shortest path, no trust (τ=0)
  * ``mr_route``     — max-reliability (shortest path on -log r_p)
  * ``naive_route``  — DFS enumeration + uniform sample (capped)
  * ``larac_route``  — Lagrangian relaxation for the constrained problem
  * ``brute_force_route`` — exact RBSP by enumeration (test oracle only)

All shortest-path algorithms run on the snapshot-compiled CSR planner
(core/planner.py): the layered DAG is compiled once per registry snapshot
and each query is a vectorized numpy forward DP — the per-request heap
Dijkstra of the seed survives as ``heap_dijkstra_route`` / the private
``_dijkstra_layered`` strictly as a reference baseline for equivalence
tests and before/after benchmarks.
"""
from __future__ import annotations

import heapq
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.planner import RoutePlanner, get_planner
from repro_torch.core.trust import effective_cost_vec
from repro_torch.core.types import PeerTable, RouteResult

_INF = float("inf")


# ---------------------------------------------------------------------------
# Shared machinery
# ---------------------------------------------------------------------------


def _dijkstra_layered(table: PeerTable, mask: np.ndarray, weights: np.ndarray,
                      total_layers: int) -> Tuple[List[int], float]:
    """SEED REFERENCE PATH — per-request heap Dijkstra over the layered DAG.

    Nodes are *layer boundaries* 0..L; taking peer p moves from boundary
    ``layer_start[p]`` to ``layer_end[p]`` at cost ``weights[p]``. Returns
    (chain peer indices, total cost) or ([], inf).

    This boundary-graph formulation is exactly the pruned-subgraph search of
    Alg. 1 line 3: a path source→sink visits one peer per hop. Kept (not on
    the hot path) as the oracle for planner equivalence tests and the
    before/after baseline in ``benchmarks/bench_scaling.py``; production
    routing goes through ``RoutePlanner.solve``.
    """
    starts = table.layer_start
    ends = table.layer_end
    # bucket live peers by their start boundary for O(1) expansion
    by_start: Dict[int, List[int]] = {}
    for p in np.nonzero(mask)[0]:
        by_start.setdefault(int(starts[p]), []).append(int(p))

    dist = {0: 0.0}
    prev: Dict[int, Tuple[int, int]] = {}  # boundary -> (prev boundary, peer)
    heap = [(0.0, 0)]
    visited = set()
    while heap:
        d, b = heapq.heappop(heap)
        if b in visited:
            continue
        visited.add(b)
        if b == total_layers:
            break
        for p in by_start.get(b, ()):
            nb = int(ends[p])
            nd = d + float(weights[p])
            if nd < dist.get(nb, _INF):
                dist[nb] = nd
                prev[nb] = (b, p)
                heapq.heappush(heap, (nd, nb))
    if total_layers not in dist:
        return [], _INF
    # backtrack
    chain: List[int] = []
    b = total_layers
    while b != 0:
        pb, p = prev[b]
        chain.append(p)
        b = pb
    chain.reverse()
    return chain, dist[total_layers]


def _result(table: PeerTable, chain_idx: List[int], cost: float,
            algorithm: str, t0: float) -> RouteResult:
    feasible = bool(chain_idx)
    rel = float(np.prod(table.trust[chain_idx])) if feasible else 0.0
    return RouteResult(
        chain=[int(table.peer_ids[i]) for i in chain_idx],
        total_cost=cost if feasible else _INF,
        reliability=rel,
        feasible=feasible,
        algorithm=algorithm,
        decision_time_ms=(time.perf_counter() - t0) * 1e3,
    )


# ---------------------------------------------------------------------------
# G-TRAC (Alg. 1, lines 1–3)
# ---------------------------------------------------------------------------


def gtrac_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                tau: Optional[float] = None,
                planner: Optional[RoutePlanner] = None) -> RouteResult:
    t0 = time.perf_counter()
    planner = planner or get_planner(total_layers)
    tau = cfg.trust_floor if tau is None else tau
    mask = table.alive & (table.trust >= tau)          # line 1: V'
    costs = effective_cost_vec(table.latency_ms, table.trust,
                               cfg.request_timeout_ms)  # Eq. (4)
    chain, cost = planner.solve(table, costs, mask)
    return _result(table, chain, cost, "gtrac", t0)


def heap_dijkstra_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                        tau: Optional[float] = None) -> RouteResult:
    """The seed's per-request heap-Dijkstra G-TRAC path, unamortized.

    Benchmark baseline only — same pruning and weights as ``gtrac_route``
    but rebuilding dict buckets and running the heap loop on every call."""
    t0 = time.perf_counter()
    tau = cfg.trust_floor if tau is None else tau
    mask = table.alive & (table.trust >= tau)
    costs = effective_cost_vec(table.latency_ms, table.trust,
                               cfg.request_timeout_ms)
    chain, cost = _dijkstra_layered(table, mask, costs, total_layers)
    return _result(table, chain, cost, "gtrac-heap", t0)


# ---------------------------------------------------------------------------
# Baselines (§V-B)
# ---------------------------------------------------------------------------


def sp_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
             planner: Optional[RoutePlanner] = None) -> RouteResult:
    """Shortest Path: minimise Σ l̂_p, τ = 0 (no trust)."""
    t0 = time.perf_counter()
    planner = planner or get_planner(total_layers)
    chain, cost = planner.solve(table, table.latency_ms, table.alive)
    return _result(table, chain, cost, "sp", t0)


def mr_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
             planner: Optional[RoutePlanner] = None) -> RouteResult:
    """Max-Reliability: maximise Π r_p ⇔ shortest path on -log r_p."""
    t0 = time.perf_counter()
    planner = planner or get_planner(total_layers)
    w = -np.log(np.clip(table.trust, 1e-12, 1.0))
    chain, cost = planner.solve(table, w, table.alive)
    return _result(table, chain, cost, "mr", t0)


def enumerate_chains(table: PeerTable, mask: np.ndarray, total_layers: int,
                     limit: Optional[int] = None,
                     deadline_s: Optional[float] = None) -> List[List[int]]:
    """DFS enumeration of complete chains (Naive's search core).

    ``deadline_s`` bounds wall time for the *unbounded* scalability
    experiment (§VI-E): at dense network sizes the DFS combinatorially
    explodes — the paper reports it as "> 2 s (timeout)"."""
    starts = table.layer_start
    ends = table.layer_end
    by_start: Dict[int, List[int]] = {}
    for p in np.nonzero(mask)[0]:
        by_start.setdefault(int(starts[p]), []).append(int(p))
    chains: List[List[int]] = []
    stack: List[Tuple[int, List[int]]] = [(0, [])]
    t0 = time.perf_counter()
    steps = 0
    while stack:
        b, path = stack.pop()
        steps += 1
        if deadline_s is not None and steps % 4096 == 0 and \
                time.perf_counter() - t0 > deadline_s:
            break
        if b == total_layers:
            chains.append(path)
            if limit is not None and len(chains) >= limit:
                break
            continue
        for p in by_start.get(b, ()):
            stack.append((int(ends[p]), path + [p]))
    return chains


def naive_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                rng: Optional[np.random.Generator] = None,
                limit: Optional[int] = 1000,
                deadline_s: Optional[float] = None) -> RouteResult:
    """Naive: DFS-enumerate feasible chains, uniform-sample one (§V-B)."""
    t0 = time.perf_counter()
    # seeded fallback: an unseeded default_rng() draws OS entropy, which
    # breaks run-to-run reproducibility of the uniform chain sample
    rng = rng or np.random.default_rng(0)
    chains = enumerate_chains(table, table.alive, total_layers, limit=limit,
                              deadline_s=deadline_s)
    if not chains:
        return _result(table, [], _INF, "naive", t0)
    chain = chains[int(rng.integers(len(chains)))]
    cost = float(np.sum(table.latency_ms[chain]))
    return _result(table, chain, cost, "naive", t0)


def larac_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                epsilon: Optional[float] = None, max_iter: int = 32,
                planner: Optional[RoutePlanner] = None)\
        -> RouteResult:
    """LARAC (Juttner et al. 2001) for the constrained shortest path.

    cost  c_p = C_p (effective latency, Eq. 4)
    delay d_p = -log r_p, constraint Σ d_p ≤ -log(1 - ε).
    Iterates λ via the standard closed-form update. Every ``solve`` (up to
    ~34 per request) is one vectorized DP sweep over the cached CSR graph.
    """
    t0 = time.perf_counter()
    planner = planner or get_planner(total_layers)
    eps = epsilon if epsilon is not None else \
        (cfg.risk_tolerance if cfg.risk_tolerance > 0 else 0.10)
    bound = -math.log(max(1e-12, 1.0 - eps))
    c = effective_cost_vec(table.latency_ms, table.trust,
                           cfg.request_timeout_ms)
    d = -np.log(np.clip(table.trust, 1e-12, 1.0))
    alive = table.alive

    def solve(w):
        return planner.solve(table, w, alive)

    def dsum(chain):
        return float(np.sum(d[chain]))

    def csum(chain):
        return float(np.sum(c[chain]))

    pc, _ = solve(c)                      # min-cost path
    if not pc:
        return _result(table, [], _INF, "larac", t0)
    if dsum(pc) <= bound:
        return _result(table, pc, csum(pc), "larac", t0)
    pd, _ = solve(d)                      # min-delay path
    if not pd or dsum(pd) > bound:
        return _result(table, [], _INF, "larac", t0)  # infeasible
    for _ in range(max_iter):
        denom = dsum(pc) - dsum(pd)
        if abs(denom) < 1e-15:
            break
        lam = (csum(pd) - csum(pc)) / denom
        pr, _ = solve(c + lam * d)
        agg_r = csum(pr) + lam * dsum(pr)
        agg_c = csum(pc) + lam * dsum(pc)
        if abs(agg_r - agg_c) < 1e-12:
            break
        if dsum(pr) <= bound:
            pd = pr
        else:
            pc = pr
    return _result(table, pd, csum(pd), "larac", t0)


def brute_force_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                      epsilon: float) -> RouteResult:
    """Exact RBSP by enumeration — exponential; TEST ORACLE ONLY."""
    t0 = time.perf_counter()
    chains = enumerate_chains(table, table.alive, total_layers, limit=None)
    costs = effective_cost_vec(table.latency_ms, table.trust,
                               cfg.request_timeout_ms)
    best, best_cost = [], _INF
    for ch in chains:
        rel = float(np.prod(table.trust[ch]))
        if rel < 1.0 - epsilon:
            continue
        cc = float(np.sum(costs[ch]))
        if cc < best_cost:
            best, best_cost = ch, cc
    return _result(table, best, best_cost, "brute", t0)


ALGORITHMS: Dict[str, Callable] = {
    "gtrac": gtrac_route,
    "sp": sp_route,
    "mr": mr_route,
    "naive": naive_route,
    "larac": larac_route,
}
