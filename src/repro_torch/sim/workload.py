"""Token-generation workload driver (§V-A, §VI).

A request generates ``l_tok`` tokens; every token traverses the full
pipeline chain. The seeker re-routes from its *cached* registry view before
each token (control plane stays off the critical path: sync happens on the
gossip cadence as sim time advances), executes via ``ChainExecutor`` with
Bounded One-Shot Repair, and reports the trace to the Anchor.

Metrics mirror the paper: SSR with Wilson CIs, per-token latency over
successful requests, chain-length distribution, and the trust–latency
selection landscape.

Port of ``repro.sim.workload``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference. The routing
policies are the port's own (``repro_torch.core.routing``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.executor import ChainExecutor, split_reports
from repro_torch.core.planner import RoutePlanner, plan_route
from repro_torch.core.registry import SeekerCache
from repro_torch.core.routing import ALGORITHMS
from repro_torch.serving.api import SubmitSpec
from repro_torch.sim.peers import FAILURE_DETECT_FRACTION
from repro_torch.sim.testbed import Testbed


@dataclass
class RequestResult:
    success: bool
    tokens_done: int
    token_latencies_ms: List[float]
    chains: List[List[int]]
    repairs: int = 0
    infeasible: bool = False


@dataclass
class WorkloadStats:
    algorithm: str
    l_tok: int
    results: List[RequestResult] = field(default_factory=list)

    @property
    def ssr(self) -> float:
        if not self.results:
            return 0.0
        return sum(r.success for r in self.results) / len(self.results)

    def wilson_ci(self, z: float = 1.96) -> Tuple[float, float]:
        """95% Wilson score interval (§VI-A, [42])."""
        n = len(self.results)
        if n == 0:
            return (0.0, 0.0)
        p = self.ssr
        denom = 1 + z * z / n
        centre = (p + z * z / (2 * n)) / denom
        half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
        return (max(0.0, centre - half), min(1.0, centre + half))

    def token_latencies(self) -> np.ndarray:
        lats = [l for r in self.results if r.success
                for l in r.token_latencies_ms]
        return np.asarray(lats) if lats else np.zeros(0)

    def chain_lengths(self) -> np.ndarray:
        return np.asarray([len(c) for r in self.results for c in r.chains])

    def selected_peers(self) -> List[int]:
        return [p for r in self.results for c in r.chains for p in c]


def serving_workload(rng: np.random.Generator, n_requests: int, *,
                     vocab_size: int, short_len: int = 8,
                     long_len: int = 96, long_fraction: float = 0.25,
                     max_new_tokens: int = 8, burst_every_s: float = 0.0,
                     burst_size: int = 4) -> List[SubmitSpec]:
    """Mixed-length serving workload as ``SubmitSpec`` streams.

    ``long_fraction`` of the requests carry a ``long_len``-token prompt
    (the prefill-heavy tail that motivates disaggregation); the rest are
    ``short_len`` interactive streams. With ``burst_every_s`` > 0 the
    requests arrive in bursts of ``burst_size`` spaced that many sim
    seconds apart (admission defers them via ``SubmitSpec.arrival_time``);
    0 keeps the classic everything-already-queued open loop."""
    specs: List[SubmitSpec] = []
    for i in range(n_requests):
        n = long_len if rng.random() < long_fraction else short_len
        arrival = ((i // max(1, burst_size)) * burst_every_s
                   if burst_every_s > 0 else 0.0)
        specs.append(SubmitSpec(
            prompt=rng.integers(1, vocab_size, size=n),
            max_new_tokens=max_new_tokens, arrival_time=arrival))
    return specs


def _make_hop_fn(bed: Testbed, request_id: int):
    """ChainExecutor hop function over simulated peers."""
    cfg = bed.cfg

    def hop_fn(peer_id: int, stage: int, payload):
        peer = bed.peers.get(peer_id)
        if peer is None or not bed.reachable(peer_id):
            # unreachable: detection costs a share of T_timeout
            return payload, cfg.request_timeout_ms * FAILURE_DETECT_FRACTION, False
        if peer.fails_in_request(request_id, bed.rng):
            return payload, cfg.request_timeout_ms * FAILURE_DETECT_FRACTION, False
        return payload, peer.hop_latency_ms(bed.rng), True

    return hop_fn


def run_workload(bed: Testbed, algorithm: str, n_requests: int, l_tok: int,
                 seeker: Optional[SeekerCache] = None,
                 epsilon: Optional[float] = None,
                 request_id_base: int = 0,
                 inter_request_s: float = 0.5) -> WorkloadStats:
    """Run ``n_requests`` generation requests under one routing policy."""
    cfg = bed.cfg
    route_fn = ALGORITHMS[algorithm]
    seeker = seeker or SeekerCache(bed.anchor, cfg, now=bed.now)
    stats = WorkloadStats(algorithm=algorithm, l_tok=l_tok)
    # snapshot-compiled planner: gtrac tokens share one CSR graph + K-best
    # failover plan per registry snapshot instead of re-searching per token
    planner = RoutePlanner(bed.total_layers, k_best=cfg.k_best_routes,
                           cache_size=cfg.planner_cache_size)

    for rid_off in range(n_requests):
        rid = request_id_base + rid_off
        hop_fn = _make_hop_fn(bed, rid)
        executor = ChainExecutor(cfg, hop_fn)
        token_lat: List[float] = []
        chains: List[List[int]] = []
        repairs = 0
        success = True
        infeasible = False

        for _tok in range(l_tok):
            # background gossip tick (off the routing critical path)
            seeker.maybe_sync(bed.now)
            table = seeker.view()
            plan = None
            if algorithm == "gtrac":
                route, plan = plan_route(table, bed.total_layers, cfg,
                                         planner=planner)
            else:
                kwargs = {}
                if algorithm == "larac" and epsilon is not None:
                    kwargs["epsilon"] = epsilon
                if algorithm == "naive":
                    kwargs["rng"] = bed.rng
                route = route_fn(table, bed.total_layers, cfg, **kwargs)
            if not route.feasible:
                success = False
                infeasible = True
                break
            report, _ = executor.execute(route.chain, table, plan=plan)
            chains.append(report.chain)
            for rep in split_reports(report):
                bed.anchor.apply_report(rep)
            repairs += int(report.repaired)
            bed.advance(report.total_latency_ms / 1e3)
            if not report.success:
                success = False
                break
            token_lat.append(report.total_latency_ms)

        for p in bed.peers.values():        # request-scoped failure draws
            p.forget_request(rid)
        stats.results.append(RequestResult(
            success=success, tokens_done=len(token_lat),
            token_latencies_ms=token_lat, chains=chains, repairs=repairs,
            infeasible=infeasible))
        bed.advance(inter_request_s)
    return stats


def selection_landscape(bed: Testbed, stats: WorkloadStats)\
        -> Dict[str, np.ndarray]:
    """(trust, latency) of selected peers — paper Fig. 6."""
    table = bed.anchor.snapshot(bed.now)
    idx = {int(pid): i for i, pid in enumerate(table.peer_ids)}
    sel = [idx[p] for p in stats.selected_peers() if p in idx]
    return {
        "trust": table.trust[sel],
        "latency_ms": table.latency_ms[sel],
        "profile": np.asarray([bed.peers[int(table.peer_ids[i])].profile.name
                               for i in sel]),
    }
