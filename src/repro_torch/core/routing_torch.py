"""Batched, device-resident G-TRAC routing.

Port of ``repro.core.routing_jax``: ``effective_costs``, ``layered_dp`` and
``layered_dp_kbest``, ``backtrack`` and ``backtrack_kbest``,
``_device_inputs``, ``route_batched`` and ``route_batched_kbest``. After
trust-floor pruning the routing graph is a *layered* DAG — every edge goes
from boundary ``layer_start`` to the strictly larger ``layer_end`` — so
the cheapest chain (or the K cheapest) is one min-plus (tropical)
relaxation per boundary, processed in ascending order, for a whole batch
of requests (each with its own trust floor) at once.

``layered_dp`` / ``layered_dp_kbest`` are the plain PyTorch DPs (the plain
versions of kernels K2 and K1); they, ``effective_costs`` and the
backtracks (k_max steps of small gathers; no Pallas kernel in the
reference either) live in ``kernels/tropical_route.py``, the plain pieces
of the fused window entries, and are re-exported here.
``route_batched(use_kernel=True)`` / ``route_batched_kbest(use_kernel=True)``
go through ``kernels.ops.route_window[_kbest]``: on the card ONE launch
computes the costs, the DP and the backtrack, after ONE host-to-device
copy of the state and the trust floors and before ONE device-to-host copy
of hops and costs; on the CPU the same entry composes the plain pieces.
Without ``use_kernel`` the plain pieces run one by one on ``device``. All
give bit-identical outputs. The routing entry points run on ``cuda``
unless the caller passes another ``device``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GTRACConfig
from repro_torch.core.types import PeerTable
from repro_torch.kernels import ops
from repro_torch.kernels.tropical_route import (INF, backtrack,
                                                backtrack_kbest,
                                                effective_costs, route_csr,
                                                tropical_route_kbest_plain,
                                                tropical_route_plain,
                                                upload_window_state,
                                                window_to_host)
from repro_torch.obs.trace import NOOP_SPAN, wall

#: the plain single-best DP (one masked min/argmin per boundary)
layered_dp = tropical_route_plain
#: the plain K-best DP (K rounds of min/argmin/mask per boundary)
layered_dp_kbest = tropical_route_kbest_plain

def _device_inputs(table: PeerTable, total_layers: int, tau: np.ndarray,
                   planner, device):
    """(starts, ends, (latency, trust, alive∧valid, tau)) on ``device``,
    snapshot-cached via the planner; the state and tau arrive in one
    host-to-device copy.

    With a ``planner`` the topology AND the per-snapshot state tensors
    come from the ``CompiledGraph``'s device cache, keyed by the registry
    ``version`` — repeated batches against an unchanged registry upload
    only the (R,) tau vector.
    """
    if planner is not None:
        g = planner.compile(table)
        starts, ends = g.device_topology(device)
        state = g.device_state(table, device, tau)
    else:
        ls = np.asarray(table.layer_start)
        le = np.asarray(table.layer_end)
        starts = torch.as_tensor(ls.astype(np.int32), device=device)
        ends = torch.as_tensor(le.astype(np.int32), device=device)
        # planner.compile_table's validity predicate (no compiled graph
        # to read it from on this branch)
        valid = (ls >= 0) & (ls < le) & (le <= total_layers)
        state = upload_window_state(table.latency_ms, table.trust,
                                    table.alive & valid, tau, device)
    return starts, ends, state


def _route_csr(table, starts, ends, total_layers: int, planner, device):
    """The kernels' end-boundary CSR: the planner's cached copy, else built
    for this call."""
    if planner is not None:
        return planner.compile(table).device_route_csr(device)
    return route_csr(starts, ends, total_layers)


def route_batched(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                  tau: np.ndarray, k_max: int,
                  use_kernel: bool = False,
                  planner=None,
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Route a batch of requests against one cached snapshot.

    tau: (R,) per-request trust floors. Returns (chains (R, k_max) peer IDS
    (-1 padded), total costs (R,) float32). Infeasible requests get cost
    >= INF.

    ``planner`` (a ``core.planner.RoutePlanner``) routes the topology
    through the same compiled snapshot as the numpy path: the torch
    starts/ends, the kernels' end-boundary CSR and the
    latency/trust/alive tensors are converted once per registry snapshot
    (see ``_device_inputs``). ``use_kernel`` routes the whole call through
    ``kernels.ops.route_window`` (on a CUDA ``device`` one launch of the
    fused kernel, K2's DP). ``device`` defaults to ``cuda``.
    """
    tau = np.asarray(tau)
    if tau.shape[0] == 0:                  # degenerate: nothing to route
        return (np.full((0, k_max), -1, np.int64),
                np.full((0,), INF, np.float32))
    device = resolve_device(device)
    starts, ends, state = _device_inputs(table, total_layers, tau, planner,
                                         device)
    if use_kernel:
        csr = _route_csr(table, starts, ends, total_layers, planner, device)
        hops, cost = window_to_host(*ops.route_window(
            csr, starts, *state, timeout_ms=cfg.request_timeout_ms,
            total_layers=total_layers, k_max=k_max))
    else:
        costs = effective_costs(*state, cfg.request_timeout_ms)
        dist, pred = layered_dp(starts, ends, costs,
                                total_layers=total_layers)
        hops = backtrack(starts, pred, total_layers=total_layers,
                         k_max=k_max)
        tr = wall()
        with tr.span("route.readback") if tr.enabled else NOOP_SPAN:
            hops = hops.cpu().numpy()
            cost = dist[:, total_layers].cpu().numpy()
    ids = np.where(hops >= 0, table.peer_ids[np.clip(hops, 0, None)], -1)
    return ids, cost


def route_batched_kbest(table: PeerTable, total_layers: int,
                        cfg: GTRACConfig, tau: np.ndarray, k_max: int,
                        k_best: int,
                        use_kernel: bool = False,
                        planner=None,
                        device=None) -> Tuple[np.ndarray, np.ndarray]:
    """K-best batched routing: one device DP for R requests × K alternates.

    Returns (hops (R, K, k_max) int64 peer ROW indices into ``table`` (-1
    padded), costs (R, K) float32, nondecreasing along K; infeasible slots
    get cost >= INF). Row indices (not peer ids) so callers can build
    ``planner.RoutePlan`` objects — the same failover contract as the
    numpy path — without a reverse id lookup. ``use_kernel`` routes the
    whole call through ``kernels.ops.route_window_kbest`` (on a CUDA
    ``device`` one launch of the fused kernel, K1's DP). ``device``
    defaults to ``cuda``.
    """
    tau = np.asarray(tau)
    if tau.shape[0] == 0:
        return (np.full((0, k_best, k_max), -1, np.int64),
                np.full((0, k_best), INF, np.float32))
    device = resolve_device(device)
    starts, ends, state = _device_inputs(table, total_layers, tau, planner,
                                         device)
    if use_kernel:
        csr = _route_csr(table, starts, ends, total_layers, planner, device)
        hops, costs = window_to_host(*ops.route_window_kbest(
            csr, starts, *state, timeout_ms=cfg.request_timeout_ms,
            total_layers=total_layers, k_best=k_best, k_max=k_max))
        return hops.astype(np.int64), costs
    costs = effective_costs(*state, cfg.request_timeout_ms)
    distK, pedge, prank = layered_dp_kbest(
        starts, ends, costs, total_layers=total_layers, k_best=k_best)
    hops = backtrack_kbest(starts, pedge, prank, total_layers=total_layers,
                           k_max=k_max)
    tr = wall()
    with tr.span("route.readback") if tr.enabled else NOOP_SPAN:
        return hops.cpu().numpy(), distK[:, total_layers, :].cpu().numpy()
