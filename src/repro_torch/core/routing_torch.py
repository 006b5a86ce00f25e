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
versions of kernels K2 and K1, ``kernels/tropical_route.py``);
``route_batched(use_kernel=True)`` / ``route_batched_kbest(use_kernel=True)``
go through ``kernels.ops``, which launches the CUDA kernel for tensors on
the card. Both give bit-identical outputs. The backtracks are plain torch
(no Pallas kernel in the reference either): k_max steps of small gathers.
The routing entry points run on ``cuda`` unless the caller passes another
``device``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GTRACConfig
from repro_torch.core.types import PeerTable
from repro_torch.kernels import ops
from repro_torch.kernels.tropical_route import (INF,
                                                tropical_route_kbest_plain,
                                                tropical_route_plain)

#: the plain single-best DP (one masked min/argmin per boundary)
layered_dp = tropical_route_plain
#: the plain K-best DP (K rounds of min/argmin/mask per boundary)
layered_dp_kbest = tropical_route_kbest_plain


def effective_costs(latency_ms: torch.Tensor, trust: torch.Tensor,
                    alive: torch.Tensor, tau: torch.Tensor,
                    timeout_ms: float) -> torch.Tensor:
    """(R,) tau against (P,) peers -> (R, P) pruned effective costs (f32)."""
    c = latency_ms + (1.0 - trust) * timeout_ms          # Eq. (4)
    ok = alive & (trust[None, :] >= tau[:, None])        # line 1 pruning
    inf = torch.tensor(INF, dtype=torch.float32, device=c.device)
    return torch.where(ok, c[None, :], inf)


def backtrack(starts: torch.Tensor, pred: torch.Tensor, *,
              total_layers: int, k_max: int) -> torch.Tensor:
    """Reconstruct chains: (R, k_max) int64 peer indices, -1 padded, stage
    order. pred: (R, L+1) from ``layered_dp`` (or the CUDA kernel)."""
    R = pred.shape[0]
    dev = pred.device
    pr = pred.long()
    st = starts.long()
    b = torch.full((R,), int(total_layers), dtype=torch.long, device=dev)
    hops = []
    for _ in range(int(k_max)):
        p = torch.gather(pr, 1, b[:, None])[:, 0]
        valid = (b > 0) & (p >= 0)
        nb = torch.where(valid, st[p.clamp(min=0)], b)
        hops.append(torch.where(valid, p, -1))
        b = nb
    if not hops:
        return torch.full((R, 0), -1, dtype=torch.long, device=dev)
    out = torch.stack(hops, dim=1)                   # (R, k_max), sink-first
    return out.flip(1)                               # stage order, -1 padded


def backtrack_kbest(starts: torch.Tensor, pedge: torch.Tensor,
                    prank: torch.Tensor, *, total_layers: int,
                    k_max: int) -> torch.Tensor:
    """Batched K-best backtrack: all R×K chains reconstructed in lockstep.

    pedge/prank: (R, L+1, K) from ``layered_dp_kbest`` (or the CUDA
    kernel). Returns (R, K, k_max) int64 peer indices in stage order, -1
    padded; row (r, j) is request r's j-th cheapest chain.
    """
    R, Lp1, K = pedge.shape
    dev = pedge.device
    pe = pedge.reshape(R, Lp1 * K).long()
    pr = prank.reshape(R, Lp1 * K).long()
    st = starts.long()
    b = torch.full((R, K), int(total_layers), dtype=torch.long, device=dev)
    rank = torch.arange(K, device=dev)[None, :].expand(R, K)
    hops = []
    for _ in range(int(k_max)):
        idx = (b * K + rank).clamp(0, Lp1 * K - 1)
        e = torch.gather(pe, 1, idx)
        nr = torch.gather(pr, 1, idx)
        valid = (b > 0) & (rank >= 0) & (e >= 0)
        nb = torch.where(valid, st[e.clamp(min=0)], b)
        rank = torch.where(valid, nr, rank)
        b = nb
        hops.append(torch.where(valid, e, -1))
    if not hops:
        return torch.full((R, K, 0), -1, dtype=torch.long, device=dev)
    out = torch.stack(hops, dim=2)                   # (R, K, k_max), sink-first
    return out.flip(2)                               # stage order, -1 padded


def _device_inputs(table: PeerTable, total_layers: int, cfg: GTRACConfig,
                   tau: np.ndarray, planner, device):
    """(starts, ends, costs (R, P)) on ``device``, snapshot-cached via the
    planner.

    With a ``planner`` the topology AND the per-snapshot state tensors
    (latency / trust / alive∧valid) come from the ``CompiledGraph``'s
    device cache, keyed by the registry ``version`` — repeated batches
    against an unchanged registry re-upload only the (R,) tau vector.
    """
    if planner is not None:
        g = planner.compile(table)
        starts, ends = g.device_topology(device)
        lat, trust, alive = g.device_state(table, device)
    else:
        ls = np.asarray(table.layer_start)
        le = np.asarray(table.layer_end)
        starts = torch.as_tensor(ls.astype(np.int32), device=device)
        ends = torch.as_tensor(le.astype(np.int32), device=device)
        # planner.compile_table's validity predicate (no compiled graph
        # to read it from on this branch)
        valid = (ls >= 0) & (ls < le) & (le <= total_layers)
        lat = torch.as_tensor(np.asarray(table.latency_ms, np.float32),
                              device=device)
        trust = torch.as_tensor(np.asarray(table.trust, np.float32),
                                device=device)
        alive = torch.as_tensor(np.asarray(table.alive & valid),
                                device=device)
    tau_t = torch.as_tensor(np.asarray(tau, np.float32), device=device)
    costs = effective_costs(lat, trust, alive, tau_t, cfg.request_timeout_ms)
    return starts, ends, costs


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
    starts/ends, kernel K2's end-boundary CSR and the
    latency/trust/alive tensors are converted once per registry snapshot
    (see ``_device_inputs``). ``use_kernel`` routes the DP through
    ``kernels.ops`` (kernel K2 on a CUDA ``device``). ``device`` defaults
    to ``cuda``.
    """
    tau = np.asarray(tau)
    if tau.shape[0] == 0:                  # degenerate: nothing to route
        return (np.full((0, k_max), -1, np.int64),
                np.full((0,), INF, np.float32))
    device = resolve_device(device)
    starts, ends, costs = _device_inputs(table, total_layers, cfg, tau,
                                         planner, device)
    if use_kernel:
        csr = (planner.compile(table).device_route_csr(device)
               if planner is not None and device.type == "cuda" else None)
        dist, pred = ops.tropical_route(starts, ends, costs,
                                        total_layers=total_layers, csr=csr)
    else:
        dist, pred = layered_dp(starts, ends, costs,
                                total_layers=total_layers)
    hops = backtrack(starts, pred, total_layers=total_layers, k_max=k_max)
    hops_np = hops.cpu().numpy()
    ids = np.where(hops_np >= 0, table.peer_ids[np.clip(hops_np, 0, None)],
                   -1)
    return ids, dist[:, total_layers].cpu().numpy()


def route_batched_kbest(table: PeerTable, total_layers: int,
                        cfg: GTRACConfig, tau: np.ndarray, k_max: int,
                        k_best: int,
                        use_kernel: bool = False,
                        planner=None,
                        device=None) -> Tuple[np.ndarray, np.ndarray]:
    """K-best batched routing: one device DP for R requests × K alternates.

    Returns (hops (R, K, k_max) peer ROW indices into ``table`` (-1
    padded), costs (R, K) float32, nondecreasing along K; infeasible slots
    get cost >= INF). Row indices (not peer ids) so callers can build
    ``planner.RoutePlan`` objects — the same failover contract as the
    numpy path — without a reverse id lookup. ``use_kernel`` routes the DP
    through ``kernels.ops`` (the CUDA kernel for a CUDA ``device``).
    ``device`` defaults to ``cuda``.
    """
    tau = np.asarray(tau)
    if tau.shape[0] == 0:
        return (np.full((0, k_best, k_max), -1, np.int64),
                np.full((0, k_best), INF, np.float32))
    device = resolve_device(device)
    starts, ends, costs = _device_inputs(table, total_layers, cfg, tau,
                                         planner, device)
    if use_kernel:
        distK, pedge, prank = ops.tropical_route_kbest(
            starts, ends, costs, total_layers=total_layers, k_best=k_best)
    else:
        distK, pedge, prank = layered_dp_kbest(
            starts, ends, costs, total_layers=total_layers, k_best=k_best)
    hops = backtrack_kbest(starts, pedge, prank, total_layers=total_layers,
                           k_max=k_max)
    return hops.cpu().numpy(), distK[:, total_layers, :].cpu().numpy()
