"""K-best batched min-plus (tropical) routing DP — kernel K1.

Port of ``repro.kernels.tropical_route.tropical_route_kbest`` (the Pallas
TPU kernel). On the trust-pruned *layered* DAG the K cheapest chains are
one min-plus relaxation per layer boundary,

    distK[b] = K smallest of { distK[start_p, k] + C_p : end_p == b, k < K },

kept in (value, peer, rank) order, for a batch of R request rows at once.

Two versions of the same function live here:

* ``tropical_route_kbest_plain`` — plain PyTorch on any device: K rounds of
  (min, argmin, mask) per boundary, the reference ``layered_dp_kbest``
  (``repro.core.routing_jax``) line for line. ``routing_torch`` uses it as
  its ``layered_dp_kbest``; the CPU tests hold it against the reference.
* ``tropical_route_kbest_cuda`` — the hand-written CUDA kernel
  (``csrc/tropical_route.cu``): one block per request row, the row's DP in
  shared memory. Its outputs equal the plain version's bit for bit.

``kernels.ops.tropical_route_kbest`` picks between them by the device of
the tensors it is given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

INF = 3.0e38   # f32-rounded where it meets a tensor, as jnp.float32(3e38)

_LIB = CudaLibrary("tropical_route.cu", {
    "tropical_route_kbest_launch": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
})


def tropical_route_kbest_plain(starts: torch.Tensor, ends: torch.Tensor,
                               costs: torch.Tensor, *, total_layers: int,
                               k_best: int):
    """K-best min-plus DP: top-K (dist, pred-edge, pred-rank) per boundary.

    starts, ends: (P,) int boundaries; costs: (R, P) float32 (INF = pruned).
    Per boundary the (P, K) extension candidates are reduced to the K
    smallest by K rounds of (min, argmin, mask) — ``torch.argmin`` returns
    the first minimum, so ties go to the lowest flat index p*K+k, the
    stable (value, peer, rank) order of the reference.

    Returns (distK (R, L+1, K) f32, pedge (R, L+1, K) int32 peer index or
    -1, prank (R, L+1, K) int32 predecessor rank or -1), nondecreasing
    along K.
    """
    R, P = costs.shape
    L, K = int(total_layers), int(k_best)
    dev = costs.device
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    distK = torch.full((R, L + 1, K), INF, dtype=torch.float32, device=dev)
    distK[:, 0, 0] = 0.0
    pedge = torch.full((R, L + 1, K), -1, dtype=torch.int32, device=dev)
    prank = torch.full((R, L + 1, K), -1, dtype=torch.int32, device=dev)
    sidx = starts.long().clamp(0, L)
    ends_l = ends.long()
    col = torch.arange(P * K, device=dev)[None, :]
    for b in range(1, L + 1):
        d_start = distK[:, sidx, :]                          # (R, P, K)
        cand = torch.where(ends_l[None, :, None] == b,
                           d_start + costs[:, :, None], inf)
        flat = cand.reshape(R, P * K)
        vals, args = [], []
        for _ in range(K):
            a = torch.argmin(flat, dim=1)
            m = flat.gather(1, a[:, None])[:, 0]
            vals.append(m)
            args.append(a)
            flat = torch.where(col == a[:, None], inf, flat)
        m = torch.stack(vals, dim=1)                         # (R, K)
        a = torch.stack(args, dim=1)
        ok = m < inf
        distK[:, b, :] = torch.where(ok, m, inf)
        pedge[:, b, :] = torch.where(ok, a // K, -1).to(torch.int32)
        prank[:, b, :] = torch.where(ok, a % K, -1).to(torch.int32)
    return distK, pedge, prank


def tropical_route_kbest_cuda(starts: torch.Tensor, ends: torch.Tensor,
                              costs: torch.Tensor, *, total_layers: int,
                              k_best: int):
    """The CUDA kernel on CUDA tensors; same contract as the plain version.

    starts/ends (P,) int32 and costs (R, P) float32, contiguous, on one
    CUDA device. Raises on anything else. ``launches`` counts the kernel
    launches this wrapper made."""
    R, P = costs.shape
    L, K = int(total_layers), int(k_best)
    for name, t, dt in (("starts", starts, torch.int32),
                        ("ends", ends, torch.int32),
                        ("costs", costs, torch.float32)):
        if t.device.type != "cuda" or t.device != costs.device:
            raise ValueError(f"tropical_route_kbest_cuda: {name} must be on "
                             f"the CUDA device of costs, got {t.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"tropical_route_kbest_cuda: {name} must be a "
                             f"contiguous {dt} tensor, got {t.dtype}")
    if starts.shape != (P,) or ends.shape != (P,):
        raise ValueError("tropical_route_kbest_cuda: starts/ends must be "
                         f"({P},), got {tuple(starts.shape)}, "
                         f"{tuple(ends.shape)}")
    if not 1 <= K <= 32 or L < 1 or P < 1:
        raise ValueError(f"tropical_route_kbest_cuda: need 1 <= k_best <= "
                         f"32, total_layers >= 1, P >= 1 (got {K}, {L}, {P})")
    dev = costs.device
    distK = torch.empty((R, L + 1, K), dtype=torch.float32, device=dev)
    pedge = torch.empty((R, L + 1, K), dtype=torch.int32, device=dev)
    prank = torch.empty((R, L + 1, K), dtype=torch.int32, device=dev)
    if R == 0:                  # degenerate batch: nothing to launch
        return distK, pedge, prank
    lib = _LIB.get()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tropical_route_kbest_launch(
            starts.data_ptr(), ends.data_ptr(), costs.data_ptr(),
            distK.data_ptr(), pedge.data_ptr(), prank.data_ptr(),
            R, P, L, K, stream)
    _LIB.check(err, "tropical_route_kbest launch")
    tropical_route_kbest_cuda.launches += 1
    return distK, pedge, prank


tropical_route_kbest_cuda.launches = 0
