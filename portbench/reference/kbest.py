"""The plain reference of the window router: the K cheapest chains of
peers from layer 0 to the last layer, under a trust floor.

It imports nothing of the program, and follows the routing semantics of
``src/repro_torch/core/planner.py`` and ``core/trust.py`` at commit
0da9266, written out again: a peer may serve a hop when it is alive, its
layer span is valid and its trust is at least the request's floor; a hop
costs latency + (1 - trust) x request_timeout_ms; a chain's cost is the
sum of its hops, each peer covering layers [layer_start, layer_end) and
the next hop starting where it ends. A plain K-best dynamic programme over
the layer boundaries in ascending order keeps, at every boundary, the K
cheapest partial chains.

``plan_mismatch`` holds one of the program's plans against it: the plan's
chains are distinct, each is a valid chain whose cost is the reference's
cost of that chain, and the sorted costs are the reference's K cheapest
(relative tolerance ``RTOL``: the device DP sums in float32). Where a
peer's trust lies within ``FLOOR_EPS`` of the floor the float32 and the
float64 comparisons can disagree, so the plan may match either.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

RTOL = 1e-5
FLOOR_EPS = 1e-6


def kbest(table: Dict[str, np.ndarray], total_layers: int, tau: float,
          timeout_ms: float, k: int,
          usable: np.ndarray = None) -> List[Tuple[float, Tuple[int, ...]]]:
    """The ``k`` cheapest (cost, chain of row indices), cheapest first."""
    ls, le = table["layer_start"], table["layer_end"]
    if usable is None:
        usable = table["alive"] & (table["trust"] >= tau)
    usable = usable & (ls >= 0) & (ls < le) & (le <= total_layers)
    cost = table["latency_ms"] + (1.0 - table["trust"]) * timeout_ms
    best: Dict[int, List[Tuple[float, Tuple[int, ...]]]] = {0: [(0.0, ())]}
    for b in range(total_layers):
        for c0, chain in best.get(b, []):
            for r in np.nonzero(usable & (ls == b))[0]:
                e = int(le[r])
                best.setdefault(e, []).append((c0 + float(cost[r]),
                                               chain + (int(r),)))
        for e in list(best):
            if e > b:
                best[e] = sorted(best[e])[:k]
    return sorted(best.get(total_layers, []))[:k]


def _matches(plan_chains, plan_costs, ref, table, timeout_ms) -> bool:
    if len(plan_chains) != len(ref):
        return False
    if len({tuple(c) for c in plan_chains}) != len(plan_chains):
        return False
    cost = table["latency_ms"] + (1.0 - table["trust"]) * timeout_ms
    ref_cost = {chain: c for c, chain in ref}
    for chain, c in zip(plan_chains, plan_costs):
        own = float(np.sum(cost[list(chain)]))
        if not np.isclose(c, own, rtol=RTOL, atol=0.0):
            return False
        if tuple(chain) not in ref_cost and not any(
                np.isclose(own, rc, rtol=RTOL, atol=0.0)
                for rc, _ in ref):
            return False
    return np.allclose(sorted(plan_costs), [c for c, _ in ref], rtol=RTOL,
                       atol=0.0)


def plan_mismatch(table: Dict[str, np.ndarray], total_layers: int,
                  tau: float, timeout_ms: float, k: int,
                  plan_chains: List[List[int]],
                  plan_costs: List[float]) -> bool:
    """True when the plan is not one the reference allows."""
    strict = table["alive"] & (table["trust"] >= tau)
    rounded = table["alive"] & (table["trust"].astype(np.float32)
                                >= np.float32(tau))
    ambiguous = np.abs(table["trust"] - tau) < FLOOR_EPS
    choices = [strict] + ([rounded] if ambiguous.any() else [])
    for usable in choices:
        ref = kbest(table, total_layers, tau, timeout_ms, k, usable=usable)
        if _matches(plan_chains, plan_costs, ref, table, timeout_ms):
            return False
    return True
