"""Batched, device-resident G-TRAC K-best routing.

Port of ``repro.core.routing_jax`` (the K-best half: ``effective_costs``,
``layered_dp_kbest``, ``backtrack_kbest``, ``_device_inputs`` and
``route_batched_kbest``). After trust-floor pruning the routing graph is a
*layered* DAG — every edge goes from boundary ``layer_start`` to the
strictly larger ``layer_end`` — so the K cheapest chains are one min-plus
(tropical) relaxation per boundary, processed in ascending order, for a
whole batch of requests (each with its own trust floor) at once.

``layered_dp_kbest`` is the plain PyTorch DP (the plain version of kernel
K1, ``kernels/tropical_route.py``); ``route_batched_kbest(use_kernel=True)``
goes through ``kernels.ops``, which launches the CUDA kernel for tensors on
the card. Both give bit-identical outputs. The single-best ``layered_dp`` /
``backtrack`` / ``route_batched`` of the reference go with kernel K2 in a
later slice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import GTRACConfig
from repro_torch.core.types import PeerTable
from repro_torch.kernels import ops
from repro_torch.kernels.tropical_route import (INF,
                                                tropical_route_kbest_plain)

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


def route_batched_kbest(table: PeerTable, total_layers: int,
                        cfg: GTRACConfig, tau: np.ndarray, k_max: int,
                        k_best: int,
                        use_kernel: bool = False,
                        planner=None,
                        device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """K-best batched routing: one device DP for R requests × K alternates.

    Returns (hops (R, K, k_max) peer ROW indices into ``table`` (-1
    padded), costs (R, K) float32, nondecreasing along K; infeasible slots
    get cost >= INF). Row indices (not peer ids) so callers can build
    ``planner.RoutePlan`` objects — the same failover contract as the
    numpy path — without a reverse id lookup. ``use_kernel`` routes the DP
    through ``kernels.ops`` (the CUDA kernel for a CUDA ``device``).
    """
    tau = np.asarray(tau)
    if tau.shape[0] == 0:
        return (np.full((0, k_best, k_max), -1, np.int64),
                np.full((0, k_best), INF, np.float32))
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
