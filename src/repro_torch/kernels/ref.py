"""Plain PyTorch oracles: ports of the reference's ground truth.

Port of ``repro.kernels.ref`` for the kernels ported so far:
``attention_ref`` (naive full-softmax GQA attention),
``tropical_route_ref`` (the single-best layered DP) and
``tropical_route_kbest_ref`` (the K-best layered DP with one stable sort
per boundary). The tests hold them against the reference oracles, and the
kernels and their plain versions against these.
"""
from __future__ import annotations

import math

import torch

INF = 3.0e38


def attention_ref(q, k, v, *, causal: bool = True):
    """Naive full-softmax GQA attention. q (B,S,Hq,D); k,v (B,S,Hkv,D)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    kf = k.float()
    vf = v.float()
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    if causal:
        mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def tropical_route_ref(starts, ends, costs, total_layers: int):
    """Layered-DAG min-plus DP, the plain oracle.

    starts/ends (P,), costs (R, P) with INF-pruned entries. A boundary that
    no peer ends at keeps INF. Returns (dist (R, L+1) f32, pred (R, L+1)
    int32)."""
    starts = torch.as_tensor(starts)
    ends = torch.as_tensor(ends)
    costs = torch.as_tensor(costs, dtype=torch.float32)
    R, P = costs.shape
    L = total_layers
    dev = costs.device
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    dist = torch.full((R, L + 1), INF, dtype=torch.float32, device=dev)
    pred = torch.full((R, L + 1), -1, dtype=torch.int32, device=dev)
    dist[:, 0] = 0.0
    for b in range(1, L + 1):
        mask = ends.long() == b
        if not bool(mask.any()):
            continue
        cand = torch.where(mask[None, :], dist[:, starts.long()] + costs, inf)
        best, arg = cand.min(dim=1)
        dist[:, b] = best
        pred[:, b] = torch.where(best < inf, arg, -1).to(torch.int32)
    return dist, pred


def tropical_route_kbest_ref(starts, ends, costs, total_layers: int,
                             k_best: int):
    """K-best layered-DAG min-plus DP with a stable sort per boundary.

    Per boundary the (P, K) extension candidates are ordered by a stable
    sort of (value, peer index, rank) and the first K kept. Returns
    (distK (R, L+1, K) f32, pedge, prank (R, L+1, K) int32)."""
    starts = torch.as_tensor(starts)
    ends = torch.as_tensor(ends)
    costs = torch.as_tensor(costs, dtype=torch.float32)
    R, P = costs.shape
    L, K = total_layers, k_best
    dev = costs.device
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    distK = torch.full((R, L + 1, K), INF, dtype=torch.float32, device=dev)
    pedge = torch.full((R, L + 1, K), -1, dtype=torch.int32, device=dev)
    prank = torch.full((R, L + 1, K), -1, dtype=torch.int32, device=dev)
    distK[:, 0, 0] = 0.0
    sidx = starts.long().clamp(0, L)
    for b in range(1, L + 1):
        mask = ends.long() == b
        cand = torch.where(mask[None, :, None],
                           distK[:, sidx, :] + costs[:, :, None], inf)
        flat = cand.reshape(R, P * K)
        sel = torch.sort(flat, dim=1, stable=True).indices[:, :K]
        vals = torch.gather(flat, 1, sel)
        ok = vals < inf
        distK[:, b, :] = torch.where(ok, vals, inf)
        pedge[:, b, :] = torch.where(ok, sel // K, -1).to(torch.int32)
        prank[:, b, :] = torch.where(ok, sel % K, -1).to(torch.int32)
    return distK, pedge, prank
