"""Snapshot-versioned CSR route planner — the amortized routing hot path.

The seed implementation re-paid three per-request costs that dominate
decision time at N=1000: ``_dijkstra_layered`` rebuilt Python dict buckets
and ran a heap loop per call, ``AnchorRegistry.snapshot()`` reconstructed
the full ``PeerTable`` even when nothing changed, and LARAC re-ran the
search up to 34x per request. This module amortizes all of it:

* ``AnchorRegistry`` (registry.py) now carries a monotonic ``version`` /
  ``topo_version`` pair, bumped on register / deregister / apply_report /
  heartbeat-expiry. ``snapshot()`` is zero-copy: it returns the *same*
  ``PeerTable`` object while the registry is unmutated and the liveness
  vector is unchanged, and shares column arrays otherwise.

* ``RoutePlanner.compile`` turns a snapshot into a ``CompiledGraph`` — a
  CSR structure-of-arrays layered DAG (peers sorted by end boundary,
  ``indptr`` bucketing them per boundary) — cached by
  ``(source_id, topo_version)`` so the graph is rebuilt only when registry
  *membership* actually changed, and reused across every request (and every
  LARAC iteration) in between.

* The per-request search is a single vectorized numpy forward DP over the
  L+1 layer boundaries (the same min-plus recurrence as
  ``routing_torch.layered_dp_kbest``): one fancy-gather + add + argmin per
  boundary, no Python heap. ``solve`` is the 1-best path;
  ``solve_kbest`` retains the top-K (distance, predecessor-edge,
  predecessor-rank) per boundary and emits K distinct chains in
  nondecreasing cost order.

K-best failover flow
--------------------
``plan_route`` returns a ``RoutePlan`` carrying the best chain plus K-1
alternates (ties broken toward chains sharing *fewer* peers with the
primary — "edge-disjoint-preferring"). On a mid-chain peer failure at hop
k, the executor calls ``plan.resume_suffix(boundary, exclude)``: the plan
scans its alternates for the cheapest chain that passes through the failed
hop's start boundary and avoids the failed peer, and splices that chain's
suffix onto the already-executed prefix — no fresh graph search on the
failure path. ``failover``/``hedging`` consume the same plan object.

The compiled snapshot is also the entry point for the device backends:
``CompiledGraph.device_topology(device)`` caches the torch ``starts``/
``ends`` tensors consumed by the ``routing_torch`` DPs and the
``kernels/tropical_route`` CUDA kernels (with ``device_route_csr``, the
end-boundary bucketing kernel K2 scans), so batched device routing reuses
the same compile-once-per-snapshot contract.

Port of ``repro.core.planner``, copied verbatim except for the device
cache (``CompiledGraph.device_topology`` / ``device_route_csr`` /
``device_state``), which holds torch tensors on the port's device instead
of jnp arrays. The cache stays keyed by registry version.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.trust import effective_cost_vec
from repro_torch.core.types import PeerTable, RouteResult
from repro_torch.kernels.tropical_route import route_csr

_INF = float("inf")


# ---------------------------------------------------------------------------
# Compiled snapshot (CSR structure-of-arrays layered DAG)
# ---------------------------------------------------------------------------


@dataclass
class CompiledGraph:
    """CSR view of one registry snapshot's layered DAG.

    Peers are sorted by their *end* boundary (``order``); peers relaxing
    boundary b occupy ``order[indptr[b]:indptr[b+1]]``. ``starts_sorted``
    is ``layer_start[order]`` so the forward DP's gather is contiguous.
    Only topology lives here — trust/latency/liveness are read from the
    ``PeerTable`` at solve time, so one graph serves every trust update
    that does not change membership.
    """

    total_layers: int
    n_peers: int
    order: np.ndarray          # (E,) peer row indices, sorted by layer_end
    starts_sorted: np.ndarray  # (E,) int64 layer_start[order]
    indptr: np.ndarray         # (L+2,) int64 CSR offsets by end boundary
    segs: List[Tuple[int, int, int]]   # (boundary, lo, hi) non-empty buckets
    valid: Optional[np.ndarray] = None  # (P,) topology-validity mask
    key: Tuple = ()            # cache key this graph was compiled under
    source_table: Optional[PeerTable] = None
    _device: dict = field(default_factory=dict, repr=False)

    def device_topology(self, device):
        """torch (starts, ends) int32 on ``device`` in original peer order,
        converted once per compiled snapshot and device and reused by
        ``routing_torch.layered_dp_kbest`` / the CUDA routing kernel."""
        key = ("topo", str(device))
        if key not in self._device:
            t = self.source_table
            self._device[key] = (
                torch.as_tensor(np.asarray(t.layer_start, np.int32),
                                device=device),
                torch.as_tensor(np.asarray(t.layer_end, np.int32),
                                device=device),
            )
        return self._device[key]

    def device_route_csr(self, device):
        """Kernel K2's end-boundary bucketing of ``device_topology``
        (``kernels.tropical_route.route_csr``), built once per compiled
        snapshot and device."""
        key = ("csr", str(device))
        if key not in self._device:
            starts, ends = self.device_topology(device)
            self._device[key] = route_csr(starts, ends, self.total_layers)
        return self._device[key]

    def device_state(self, table: PeerTable, device):
        """torch (latency f32, trust f32, alive∧valid bool) on ``device``
        for ``table``, cached by the registry snapshot ``version`` so
        repeated device batches against an unchanged registry skip the
        host->device upload entirely. ``alive`` folds in the
        topology-validity mask (the CSR compile filters degenerate
        segments; the dense device path masks them). The f64 table
        columns are rounded to f32 on the host, as the reference does."""
        key = (getattr(table, "version", -1), id(table), str(device))
        hit = self._device.get("state")
        if hit is not None and hit[0] == key:
            return hit[1]
        arrs = (torch.as_tensor(np.asarray(table.latency_ms, np.float32),
                                device=device),
                torch.as_tensor(np.asarray(table.trust, np.float32),
                                device=device),
                torch.as_tensor(np.asarray(table.alive & self.valid),
                                device=device))
        self._device["state"] = (key, arrs)
        return arrs


def compile_table(table: PeerTable, total_layers: int) -> CompiledGraph:
    """Build the CSR layered DAG for one snapshot (no caching)."""
    starts = np.asarray(table.layer_start, np.int64)
    ends = np.asarray(table.layer_end, np.int64)
    L = int(total_layers)
    valid = (starts >= 0) & (starts < ends) & (ends <= L)
    rows = np.nonzero(valid)[0]
    order = rows[np.argsort(ends[rows], kind="stable")]
    counts = np.bincount(ends[order], minlength=L + 2)[:L + 2]
    indptr = np.zeros(L + 2, np.int64)
    np.cumsum(counts[:L + 1], out=indptr[1:])
    segs = [(b, int(indptr[b]), int(indptr[b + 1]))
            for b in range(1, L + 1) if indptr[b + 1] > indptr[b]]
    return CompiledGraph(
        total_layers=L,
        n_peers=len(table),
        order=order,
        starts_sorted=starts[order],
        indptr=indptr,
        segs=segs,
        valid=valid,
        source_table=table,
    )


def _edge_disjoint_order(chains: List[List[int]], costs: List[float])\
        -> Tuple[List[List[int]], List[float]]:
    """Order alternates edge-disjoint-preferring: among equal-cost
    alternates, chains sharing fewer peers with the primary come first.
    Shared by the numpy DP and the device (batched) plan builder so plans
    from either backend are identical."""
    if len(chains) <= 2:
        return chains, costs
    primary = set(chains[0])
    alts = sorted(
        zip(chains[1:], costs[1:]),
        key=lambda cc: (cc[1], len(primary.intersection(cc[0]))))
    return (chains[:1] + [c for c, _ in alts],
            costs[:1] + [c for _, c in alts])


# ---------------------------------------------------------------------------
# Route plans (primary + K-best alternates)
# ---------------------------------------------------------------------------


@dataclass
class RoutePlan:
    """Primary chain plus K-1 precomputed failover alternates.

    ``chain_rows`` are *row indices* into ``table``; the public accessors
    translate to peer ids. Chains are distinct and in nondecreasing cost
    order; within equal cost, alternates sharing fewer peers with the
    primary come first.
    """

    table: PeerTable
    total_layers: int
    chain_rows: List[List[int]]
    costs: List[float]
    algorithm: str = "gtrac"

    @property
    def feasible(self) -> bool:
        return bool(self.chain_rows)

    @property
    def n_chains(self) -> int:
        return len(self.chain_rows)

    def chain_ids(self, i: int = 0) -> List[int]:
        return [int(self.table.peer_ids[r]) for r in self.chain_rows[i]]

    def alternates(self) -> List[Tuple[List[int], float]]:
        return [(self.chain_ids(i), self.costs[i])
                for i in range(1, len(self.chain_rows))]

    def result(self, t0: Optional[float] = None) -> RouteResult:
        t0 = time.perf_counter() if t0 is None else t0
        if not self.feasible:
            return RouteResult([], _INF, 0.0, False, self.algorithm,
                               (time.perf_counter() - t0) * 1e3)
        rows = self.chain_rows[0]
        rel = float(np.prod(self.table.trust[rows]))
        return RouteResult(self.chain_ids(0), self.costs[0], rel, True,
                           self.algorithm,
                           (time.perf_counter() - t0) * 1e3)

    # -- failover consumption (no fresh search) ------------------------------

    def resume_suffix(self, boundary: int,
                      exclude: Optional[Set[int]] = None)\
            -> Optional[List[int]]:
        """Cheapest alternate suffix covering [boundary, L) that avoids
        ``exclude`` (peer ids). Used on mid-chain failure: the executed
        prefix already reached ``boundary``; the suffix splices on top."""
        exclude = exclude or set()
        ls = self.table.layer_start
        ids = self.table.peer_ids
        for rows in self.chain_rows:
            for j, r in enumerate(rows):
                if int(ls[r]) == boundary:
                    suffix = [int(ids[q]) for q in rows[j:]]
                    if not exclude.intersection(suffix):
                        return suffix
                    break
                if int(ls[r]) > boundary:
                    break
        return None

    def full_alternate(self, exclude: Optional[Set[int]] = None)\
            -> Optional[List[int]]:
        """Cheapest whole chain avoiding ``exclude`` (peer ids)."""
        exclude = exclude or set()
        for i in range(len(self.chain_rows)):
            ids = self.chain_ids(i)
            if not exclude.intersection(ids):
                return ids
        return None


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


class RoutePlanner:
    """Compile-once-per-snapshot route planner with a bounded graph cache.

    Graphs are keyed by the snapshot's ``(source_id, topo_version)`` (see
    registry.py): trust/latency/liveness updates reuse the compiled
    topology; only membership changes recompile. Snapshots built directly
    via ``PeerTable.from_records`` (no registry) fall back to per-object
    identity caching.
    """

    def __init__(self, total_layers: int, k_best: int = 4,
                 cache_size: int = 8):
        self.total_layers = int(total_layers)
        self.k_best = int(k_best)
        self.cache_size = int(cache_size)
        self._graphs: "OrderedDict[Tuple, CompiledGraph]" = OrderedDict()
        self._plans: "OrderedDict[Tuple, Tuple[PeerTable, RoutePlan]]" = \
            OrderedDict()
        self.stats: Dict[str, int] = {
            "graph_compiles": 0, "graph_hits": 0,
            "solves": 0, "plan_hits": 0, "batched_solves": 0,
        }

    # -- compilation ---------------------------------------------------------

    def _graph_key(self, table: PeerTable) -> Tuple:
        if getattr(table, "source_id", -1) >= 0 and \
                getattr(table, "topo_version", -1) >= 0:
            return ("v", table.source_id, table.topo_version)
        return ("id", id(table))

    def compile(self, table: PeerTable) -> CompiledGraph:
        key = self._graph_key(table)
        g = self._graphs.get(key)
        if g is not None and (key[0] == "v" or g.source_table is table):
            self._graphs.move_to_end(key)
            self.stats["graph_hits"] += 1
            return g
        g = compile_table(table, self.total_layers)
        g.key = key
        self._graphs[key] = g
        self._graphs.move_to_end(key)
        while len(self._graphs) > self.cache_size:
            self._graphs.popitem(last=False)
        self.stats["graph_compiles"] += 1
        return g

    # -- vectorized forward DP ----------------------------------------------

    def solve(self, table: PeerTable, weights: np.ndarray,
              mask: np.ndarray) -> Tuple[List[int], float]:
        """1-best chain: vectorized min-plus DP over the compiled CSR.

        Returns (chain row indices, total cost) or ([], inf). This is the
        inner loop LARAC calls up to ~34x per request — each call is L
        numpy segment reductions over the cached graph, no rebucketing."""
        self.stats["solves"] += 1
        g = self.compile(table)
        L = g.total_layers
        w = np.where(mask, weights, _INF)[g.order]
        dist = np.full(L + 1, _INF)
        dist[0] = 0.0
        pred = np.full(L + 1, -1, np.int64)
        ss = g.starts_sorted
        for b, lo, hi in g.segs:
            cand = dist[ss[lo:hi]] + w[lo:hi]
            j = int(np.argmin(cand))
            c = cand[j]
            if c < _INF:
                dist[b] = c
                pred[b] = lo + j
        if not dist[L] < _INF:
            return [], _INF
        chain: List[int] = []
        b = L
        while b > 0:
            e = int(pred[b])
            chain.append(int(g.order[e]))
            b = int(ss[e])
        chain.reverse()
        return chain, float(dist[L])

    def solve_kbest(self, table: PeerTable, weights: np.ndarray,
                    mask: np.ndarray, k: Optional[int] = None,
                    reorder: bool = True)\
            -> Tuple[List[List[int]], List[float]]:
        """Top-K distinct chains in nondecreasing cost order.

        The DP carries the K best (distance, predecessor edge, predecessor
        rank) per boundary; candidates per boundary are the (m, K) matrix
        of bucket-edge extensions, reduced with one stable argsort — ties
        broken by (value, bucket edge, rank), the exact order the device
        backends (``routing_torch.layered_dp_kbest`` / the CUDA kernel)
        produce, so plans are backend-independent. ``reorder=False`` skips
        the edge-disjoint-preferring alternate reordering (raw DP rank
        order, used by the parity tests)."""
        self.stats["solves"] += 1
        k = self.k_best if k is None else int(k)
        if k <= 1:
            chain, cost = self.solve(table, weights, mask)
            return ([chain], [cost]) if chain else ([], [])
        g = self.compile(table)
        L = g.total_layers
        w = np.where(mask, weights, _INF)[g.order]
        distK = np.full((L + 1, k), _INF)
        distK[0, 0] = 0.0
        pedge = np.full((L + 1, k), -1, np.int64)
        prank = np.full((L + 1, k), -1, np.int64)
        ss = g.starts_sorted
        for b, lo, hi in g.segs:
            cand = distK[ss[lo:hi]] + w[lo:hi, None]   # (m, k)
            flat = cand.ravel()
            sel = np.argsort(flat, kind="stable")[:k]
            vals = flat[sel]
            nf = int(np.searchsorted(vals, _INF))
            if nf:
                distK[b, :nf] = vals[:nf]
                pedge[b, :nf] = lo + sel[:nf] // k
                prank[b, :nf] = sel[:nf] % k
        chains: List[List[int]] = []
        costs: List[float] = []
        for r in range(k):
            if not distK[L, r] < _INF:
                break
            rows: List[int] = []
            b, rank = L, r
            while b > 0:
                e = int(pedge[b, rank])
                rows.append(int(g.order[e]))
                rank = int(prank[b, rank])
                b = int(ss[e])
            rows.reverse()
            chains.append(rows)
            costs.append(float(distK[L, r]))
        if reorder:
            chains, costs = _edge_disjoint_order(chains, costs)
        return chains, costs

    def solve_kbest_batched(self, table: PeerTable, weights: np.ndarray,
                            masks: np.ndarray, k: Optional[int] = None,
                            reorder: bool = True)\
            -> Tuple[List[List[List[int]]], List[List[float]]]:
        """R requests' K-best chains from ONE vectorized DP sweep.

        ``weights`` (P,) shared costs, or (R, P) per-request costs (the
        KV-reuse bonus discounts a stream's warm peers — every other
        request still shares the base cost row); ``masks`` (R, P)
        per-request pruning (each row its own trust floor). The DP carries an
        (R, L+1, K) state and reduces every boundary bucket for all
        requests at once — the host-side twin of the device backends
        (``routing_torch.layered_dp_kbest`` / the CUDA kernel), with the
        identical stable (value, edge, rank) tie-break, so each request's
        chains are bit-identical to a per-request ``solve_kbest``. This
        is the serving window router's CPU backend: O(L) numpy segment
        reductions amortized over the whole window instead of R Python
        DP loops. Returns (chains_per_request, costs_per_request)."""
        self.stats["batched_solves"] += 1
        k = self.k_best if k is None else int(k)
        g = self.compile(table)
        L = g.total_layers
        R = masks.shape[0]
        wrows = weights if weights.ndim == 2 else weights[None, :]
        w = np.where(masks, wrows, _INF)[:, g.order]              # (R, E)
        distK = np.full((R, L + 1, k), _INF)
        distK[:, 0, 0] = 0.0
        pedge = np.full((R, L + 1, k), -1, np.int64)
        prank = np.full((R, L + 1, k), -1, np.int64)
        ss = g.starts_sorted
        for b, lo, hi in g.segs:
            cand = distK[:, ss[lo:hi], :] + w[:, lo:hi, None]  # (R, m, k)
            flat = cand.reshape(R, -1)
            sel = np.argsort(flat, axis=1, kind="stable")[:, :k]
            vals = np.take_along_axis(flat, sel, axis=1)
            ok = vals < _INF
            distK[:, b, :] = np.where(ok, vals, _INF)
            pedge[:, b, :] = np.where(ok, lo + sel // k, -1)
            prank[:, b, :] = np.where(ok, sel % k, -1)
        chains_all: List[List[List[int]]] = []
        costs_all: List[List[float]] = []
        order = g.order
        for r in range(R):
            chains: List[List[int]] = []
            costs: List[float] = []
            for j in range(k):
                if not distK[r, L, j] < _INF:
                    break
                rows: List[int] = []
                b, rank = L, j
                while b > 0:
                    e = int(pedge[r, b, rank])
                    rows.append(int(order[e]))
                    rank = int(prank[r, b, rank])
                    b = int(ss[e])
                rows.reverse()
                chains.append(rows)
                costs.append(float(distK[r, L, j]))
            if reorder:
                chains, costs = _edge_disjoint_order(chains, costs)
            chains_all.append(chains)
            costs_all.append(costs)
        return chains_all, costs_all

    # -- plans ---------------------------------------------------------------

    def plan(self, table: PeerTable, weights: np.ndarray, mask: np.ndarray,
             k: Optional[int] = None, algorithm: str = "gtrac") -> RoutePlan:
        chains, costs = self.solve_kbest(table, weights, mask, k=k)
        return RoutePlan(table=table, total_layers=self.total_layers,
                         chain_rows=chains, costs=costs, algorithm=algorithm)

    def plan_cached(self, table: PeerTable, cfg: GTRACConfig,
                    tau: float, k: Optional[int] = None,
                    algorithm: str = "gtrac") -> RoutePlan:
        """Version-keyed plan cache: while the seeker's table object is
        unchanged (same registry version) and (tau, k) match, the serving
        loop gets the previous RoutePlan back without re-running the DP."""
        version = getattr(table, "version", -1)
        source = getattr(table, "source_id", -1)
        key = None
        if version >= 0 and source >= 0:
            key = (source, version, round(float(tau), 12), k, algorithm)
            hit = self._plans.get(key)
            if hit is not None and hit[0] is table:
                self._plans.move_to_end(key)
                self.stats["plan_hits"] += 1
                return hit[1]
        w = effective_cost_vec(table.latency_ms, table.trust,
                               cfg.request_timeout_ms)
        mask = table.alive & (table.trust >= tau)
        plan = self.plan(table, w, mask, k=k, algorithm=algorithm)
        if key is not None:
            self._plans[key] = (table, plan)
            while len(self._plans) > self.cache_size:
                self._plans.popitem(last=False)
        return plan


# ---------------------------------------------------------------------------
# Shared planners + the serving-facing entry point
# ---------------------------------------------------------------------------


_SHARED: Dict[int, RoutePlanner] = {}


def get_planner(total_layers: int) -> RoutePlanner:
    """Process-wide planner per layer count (bounded snapshot cache)."""
    p = _SHARED.get(total_layers)
    if p is None:
        p = _SHARED[total_layers] = RoutePlanner(total_layers)
    return p


def plan_route(table: PeerTable, total_layers: int, cfg: GTRACConfig,
               tau: Optional[float] = None, k: Optional[int] = None,
               planner: Optional[RoutePlanner] = None)\
        -> Tuple[RouteResult, RoutePlan]:
    """G-TRAC route + K-best failover plan from one DP sweep."""
    t0 = time.perf_counter()
    planner = planner or get_planner(total_layers)
    tau = cfg.trust_floor if tau is None else tau
    k = cfg.k_best_routes if k is None else k
    plan = planner.plan_cached(table, cfg, tau, k=k, algorithm="gtrac")
    return plan.result(t0), plan
