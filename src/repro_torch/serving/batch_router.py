"""Window-batched trust-aware routing for the serving layer.

The per-token serving loop pays one route planner DP per request per token
(`plan_route`). At scale the regime flips: many concurrent decode streams
share one gossip window — the registry snapshot is identical for all of
them — so their routing problems differ only in the (R,) per-request trust
floor vector. ``BatchRouter`` exploits exactly that: requests submitted
within a window are solved in ONE batched DP call against the planner's
compiled snapshot, and every request gets back a full ``planner.RoutePlan``
with K failover alternates.

Backends: ``kernel`` routes the window through ``kernels.ops`` — on a
CUDA device one launch of the fused window kernel (effective costs, K1's
DP and the backtrack) between one upload and one download, on the CPU its
plain composition; ``torch`` forces the plain PyTorch
``routing_torch.layered_dp_kbest`` on the router's device; ``numpy`` runs
the vectorized host DP (``RoutePlanner.solve_kbest_batched``). ``auto``
resolves to ``kernel`` on a CUDA device and to ``numpy`` elsewhere, as
the reference's ``auto`` picks its Pallas kernel on a TPU and numpy
elsewhere. All
carry the same top-K (dist, pred, rank) state with the same stable
(value, edge, rank) tie-break and share ``_edge_disjoint_order``, so plans
are bit-identical regardless of which backend routed the window —
``ChainExecutor`` splices failover suffixes with zero fresh searches
either way.

Port of ``repro.serving.batch_router``: the same router with the torch
backends in place of ``jnp``/``pallas`` and an explicit ``device``.

Routing cost per window is O(1 batched DP) instead of O(R per-request
DPs): serving converts from O(tokens × DP) to O(windows × batched-DP).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GTRACConfig
from repro_torch.core.planner import RoutePlan, RoutePlanner, _edge_disjoint_order
from repro_torch.core.routing_torch import route_batched_kbest
from repro_torch.core.trust import effective_cost_vec
from repro_torch.core.types import PeerTable
from repro_torch.obs.trace import NOOP_TRACER

_INF_THRESH = 1.0e38

BACKENDS = ("auto", "numpy", "torch", "kernel")


def _resolve_backend(backend: str, device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        dev = resolve_device() if device is None else torch.device(device)
        return "kernel" if dev.type == "cuda" else "numpy"
    return backend


def plan_batched(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                 taus: np.ndarray, *, planner: RoutePlanner,
                 k_best: Optional[int] = None,
                 backend: str = "auto",
                 device=None,
                 warm_masks: Optional[np.ndarray] = None,
                 kv_bonus: float = 0.0) -> List[RoutePlan]:
    """One batched K-best DP -> one ``RoutePlan`` per request.

    ``taus`` is the (R,) per-request trust floor vector. Chains longer
    than ``total_layers`` hops are impossible (every peer spans >= 1
    layer), so ``k_max = total_layers`` never truncates a backtrack.
    Infeasible requests get an empty (infeasible) plan.

    ``warm_masks`` (R, P) marks peers holding each request's warm KV
    (serving/kv_cache.KVLocalityTracker); with ``kv_bonus`` > 0 a warm
    peer's effective edge cost is scaled by ``1 - kv_bonus`` in that
    request's DP row only — routing *prefers* the warm chain but the
    trust-floor mask still prunes degraded peers, so a collapsed warm
    chain falls back to the K-best alternates with no special casing.
    The bonus rides the host (numpy) DP: the device backends derive
    shared costs from the table on device, so a window carrying warm
    discounts routes on the numpy path regardless of ``backend``
    (``kv_bonus=0`` or an empty warm set keeps backend dispatch — and
    plans — bit-identical to the bonus-free path). Plan ``costs`` are
    then the *discounted* objective: correct for ranking alternates,
    not a latency estimate.

    ``device`` is where the torch / kernel DP runs: ``cuda`` unless the
    caller passes another; the numpy backend never touches it.
    """
    k = planner.k_best if k_best is None else int(k_best)
    taus = np.asarray(taus, np.float64)
    bonus_live = (warm_masks is not None and kv_bonus > 0.0
                  and bool(np.any(warm_masks)))
    backend = _resolve_backend(backend, device)
    if backend == "numpy" or bonus_live:
        w = effective_cost_vec(table.latency_ms, table.trust,
                               cfg.request_timeout_ms)
        masks = table.alive[None, :] & \
            (table.trust[None, :] >= taus[:, None])
        if bonus_live:
            w = np.where(warm_masks, w[None, :] * (1.0 - float(kv_bonus)),
                         w[None, :])
        chains_all, costs_all = planner.solve_kbest_batched(
            table, w, masks, k=k)
        return [RoutePlan(table=table, total_layers=total_layers,
                          chain_rows=chains, costs=costs,
                          algorithm="gtrac")
                for chains, costs in zip(chains_all, costs_all)]
    hops, costs = route_batched_kbest(
        table, total_layers, cfg, taus, k_max=total_layers, k_best=k,
        use_kernel=(backend == "kernel"), planner=planner, device=device)
    plans: List[RoutePlan] = []
    hops, costs = hops.tolist(), costs.tolist()   # Python ints and floats
    for r in range(taus.shape[0]):
        chains: List[List[int]] = []
        ccosts: List[float] = []
        for j in range(k):
            c = costs[r][j]
            if not c < _INF_THRESH:
                break                      # nondecreasing: rest infeasible
            chains.append([x for x in hops[r][j] if x >= 0])
            ccosts.append(c)
        chains, ccosts = _edge_disjoint_order(chains, ccosts)
        plans.append(RoutePlan(table=table, total_layers=total_layers,
                               chain_rows=chains, costs=ccosts,
                               algorithm="gtrac"))
    return plans


@dataclass
class RouterStats:
    windows: int = 0            # flushed windows (>= 1 pending request)
    requests: int = 0           # requests routed in total
    device_calls: int = 0       # batched DP launches
    unique_floors: int = 0      # DP rows actually solved after tau dedupe
    window_cache_hits: int = 0  # windows served from the previous solve


@dataclass
class BatchRouter:
    """Accumulate route requests per serving window; solve them in one
    batched device DP against the planner's compiled snapshot.

    ``submit`` is O(1); ``route_window(table)`` drains the pending set,
    dedupes identical trust floors (requests sharing a floor share the
    same routing problem under one snapshot, hence the same plan object —
    plans are read-only to executors), runs ONE batched DP, and returns
    {request_id: RoutePlan}. Consecutive windows against the identical
    table object (zero-copy snapshot, unchanged registry version) with
    the same deduped floor set reuse the previous window's plans without
    any DP — the window-level twin of ``RoutePlanner.plan_cached``.
    """

    planner: RoutePlanner
    cfg: GTRACConfig
    total_layers: int
    backend: str = "auto"       # auto | numpy | torch | kernel
    device: object = None       # where the torch / kernel DP runs (cuda)
    k_best: Optional[int] = None
    stats: RouterStats = field(default_factory=RouterStats)
    # sim-domain tracer: plan cost is HOST work that advances no sim
    # time, so it ships as a zero-duration event carrying wall_us
    tracer: object = NOOP_TRACER
    _pending: List[Tuple[int, float, Tuple[int, ...]]] = \
        field(default_factory=list)
    _cache: Optional[Tuple[PeerTable, Tuple, List[RoutePlan]]] = None

    def submit(self, request_id: int, tau: Optional[float] = None,
               warm_ids=None) -> None:
        """Queue a routing request for the current window.

        ``warm_ids`` are the peers holding this stream's warm KV
        (serving/kv_cache.KVLocalityTracker.warm_ids). With
        ``cfg.kv_reuse_bonus`` > 0 they earn a per-request edge-cost
        discount in the batched DP; at bonus 0 they are discarded here,
        so routing stays bit-identical to the bonus-free path."""
        tau = self.cfg.trust_floor if tau is None else float(tau)
        warm: Tuple[int, ...] = ()
        if warm_ids and self.cfg.kv_reuse_bonus > 0.0:
            warm = tuple(sorted(int(p) for p in warm_ids))
        self._pending.append((int(request_id), tau, warm))

    @property
    def pending(self) -> int:
        return len(self._pending)

    def route_window(self, table: PeerTable) -> Dict[int, RoutePlan]:
        """Solve every pending request against ``table`` in one DP call
        (or zero, when the snapshot, floor set, and warm sets are all
        unchanged). Requests sharing (tau, warm set) share one DP row —
        with empty warm sets this degenerates to the classic tau dedupe."""
        pending, self._pending = self._pending, []
        if not pending:
            return {}
        traced = self.tracer.enabled
        wall0 = _time.perf_counter() if traced else 0.0
        group_of: Dict[Tuple[float, Tuple[int, ...]], int] = {}
        for _, tau, warm in pending:
            group_of.setdefault((tau, warm), 0)
        skeys = sorted(group_of)
        for i, k in enumerate(skeys):
            group_of[k] = i
        taus = np.array([k[0] for k in skeys], np.float64)
        warm_sets = tuple(k[1] for k in skeys)
        any_warm = any(warm_sets)
        warm_masks = None
        if any_warm:
            id2row = {int(p): i for i, p in enumerate(table.peer_ids)}
            warm_masks = np.zeros((len(skeys), len(table)), bool)
            for i, warm in enumerate(warm_sets):
                rows = [id2row[p] for p in warm if p in id2row]
                warm_masks[i, rows] = True
        key = (getattr(table, "version", -1), taus.tobytes(), warm_sets,
               self.k_best)
        self.stats.windows += 1
        self.stats.requests += len(pending)
        cache_hit = True
        if self._cache is not None and self._cache[0] is table \
                and self._cache[1] == key:
            plans = self._cache[2]
            self.stats.window_cache_hits += 1
        else:
            plans = plan_batched(table, self.total_layers, self.cfg,
                                 taus, planner=self.planner,
                                 k_best=self.k_best, backend=self.backend,
                                 device=self.device,
                                 warm_masks=warm_masks,
                                 kv_bonus=self.cfg.kv_reuse_bonus)
            self._cache = (table, key, plans)
            self.stats.device_calls += 1
            self.stats.unique_floors += len(taus)
            cache_hit = False
        if traced:
            self.tracer.event(
                "route.plan", cat="routing", requests=len(pending),
                rows=len(taus), cache_hit=cache_hit,
                wall_us=(_time.perf_counter() - wall0) * 1e6)
        return {rid: plans[group_of[(tau, warm)]]
                for rid, tau, warm in pending}
