"""Batched min-plus (tropical) routing DP — kernels K2 and K1.

Port of ``repro.kernels.tropical_route`` (the Pallas TPU kernels
``tropical_route`` and ``tropical_route_kbest``). On the trust-pruned
*layered* DAG the cheapest chain is one min-plus relaxation per layer
boundary,

    dist[b] = min { dist[start_p] + C_p : end_p == b },

and the K cheapest chains keep the K smallest candidates
``distK[start_p, k] + C_p`` in (value, peer, rank) order — for a batch of
R request rows at once.

Each kernel has two versions of the same function here:

* ``tropical_route_plain`` / ``tropical_route_kbest_plain`` — plain
  PyTorch on any device, the reference's ``layered_dp`` /
  ``layered_dp_kbest`` (``repro.core.routing_jax``) line for line.
  ``routing_torch`` uses them as its ``layered_dp`` / ``layered_dp_kbest``;
  the CPU tests hold them against the reference.
* ``tropical_route_cuda`` / ``tropical_route_kbest_cuda`` — the
  hand-written CUDA kernels (``csrc/tropical_route.cu``). K2 runs one warp
  per request row over the peers bucketed by end boundary
  (``route_csr``); K1 one block per row. Their outputs equal the plain
  versions' bit for bit.

``kernels.ops`` picks between them by the device of the tensors it is
given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

INF = 3.0e38   # f32-rounded where it meets a tensor, as jnp.float32(3e38)

_LIB = CudaLibrary("tropical_route.cu", {
    "tropical_route_launch": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "tropical_route_smem_bytes": [ctypes.c_int] * 2,
    "tropical_route_kbest_launch": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
})

#: shared memory a block may use on the H100 (227 KB)
_MAX_SMEM = 232_448


def tropical_route_plain(starts: torch.Tensor, ends: torch.Tensor,
                         costs: torch.Tensor, *, total_layers: int):
    """Single-best min-plus DP over boundaries.

    starts, ends: (P,) int boundaries; costs: (R, P) float32 (INF =
    pruned). Per boundary b the candidates are ``dist[start_p] + C_p`` for
    the peers with ``end_p == b`` and INF for every other peer; the min
    over the whole row is kept, and ``torch.argmin`` (the first minimum)
    gives the predecessor where it is below INF. f32 ``INF + INF``
    overflows to ``+inf``, as in the reference.

    ``starts`` of the peers that end inside [1, L] must lie in [0, L];
    they are clamped there, as the kernel does (the reference reads out of
    range past it).

    Returns (dist (R, L+1) f32, pred (R, L+1) int32 peer index or -1).
    """
    R, P = costs.shape
    L = int(total_layers)
    dev = costs.device
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    dist = torch.full((R, L + 1), INF, dtype=torch.float32, device=dev)
    dist[:, 0] = 0.0
    pred = torch.full((R, L + 1), -1, dtype=torch.int32, device=dev)
    sidx = starts.long().clamp(0, L)
    ends_l = ends.long()
    for b in range(1, L + 1):
        d_start = dist[:, sidx]                              # (R, P)
        cand = torch.where(ends_l[None, :] == b, d_start + costs, inf)
        arg = torch.argmin(cand, dim=1)
        best = cand.gather(1, arg[:, None])[:, 0]
        dist[:, b] = best
        pred[:, b] = torch.where(best < inf, arg, -1).to(torch.int32)
    return dist, pred


def route_csr(starts: torch.Tensor, ends: torch.Tensor, total_layers: int):
    """The peers bucketed by end boundary, as kernel K2 reads them.

    Returns (offsets (L+2,) int32, order (P,) int32, sstart (P,) int32):
    the peers ending at boundary b (1 <= b <= L) are
    ``order[offsets[b]:offsets[b+1]]`` in ascending index order; peers
    ending outside [1, L] sort last and are never read. ``sstart`` is
    ``clamp(starts[order], 0, L)``. Built with torch on the device of
    ``ends``; the planner caches it per compiled topology
    (``CompiledGraph.device_route_csr``)."""
    L = int(total_layers)
    e = ends.long()
    key = torch.where((e >= 1) & (e <= L), e, torch.full_like(e, L + 1))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=L + 2)
    offsets = torch.zeros(L + 2, dtype=torch.int32, device=e.device)
    offsets[1:] = torch.cumsum(counts, 0)[:L + 1].to(torch.int32)
    sstart = starts.long()[order].clamp(0, L).to(torch.int32)
    return offsets, order.to(torch.int32), sstart


def _check_inputs(fn: str, starts, ends, costs):
    """Device, type, contiguity and shape checks shared by the wrappers."""
    P = costs.shape[1]
    for name, t, dt in (("starts", starts, torch.int32),
                        ("ends", ends, torch.int32),
                        ("costs", costs, torch.float32)):
        if t.device.type != "cuda" or t.device != costs.device:
            raise ValueError(f"{fn}: {name} must be on the CUDA device of "
                             f"costs, got {t.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"tensor, got {t.dtype}")
    if starts.shape != (P,) or ends.shape != (P,):
        raise ValueError(f"{fn}: starts/ends must be ({P},), got "
                         f"{tuple(starts.shape)}, {tuple(ends.shape)}")


def tropical_route_cuda(starts: torch.Tensor, ends: torch.Tensor,
                        costs: torch.Tensor, *, total_layers: int,
                        csr=None):
    """Kernel K2 on CUDA tensors; same contract as the plain version.

    starts/ends (P,) int32 and costs (R, P) float32, contiguous, on one
    CUDA device. ``csr`` is ``route_csr(starts, ends, total_layers)``,
    built here when not given (the planner passes its cached copy).
    Raises on anything else. ``launches`` counts the kernel launches this
    wrapper made."""
    fn = "tropical_route_cuda"
    R, P = costs.shape
    L = int(total_layers)
    _check_inputs(fn, starts, ends, costs)
    if L < 1 or P < 1:
        raise ValueError(f"{fn}: need total_layers >= 1 and P >= 1 "
                         f"(got {L}, {P})")
    if csr is None:
        csr = route_csr(starts, ends, L)
    offsets, order, sstart = csr
    for name, t, n in (("offsets", offsets, L + 2), ("order", order, P),
                       ("sstart", sstart, P)):
        if t.device != costs.device or t.dtype != torch.int32 or \
                t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{fn}: csr {name} must be a contiguous "
                             f"({n},) int32 tensor on {costs.device}")
    dev = costs.device
    dist = torch.empty((R, L + 1), dtype=torch.float32, device=dev)
    pred = torch.empty((R, L + 1), dtype=torch.int32, device=dev)
    if R == 0:                  # degenerate batch: nothing to launch
        return dist, pred
    lib = _LIB.get()
    smem = lib.tropical_route_smem_bytes(P, L)
    if smem > _MAX_SMEM:
        raise ValueError(f"{fn}: P={P}, L={L} needs {smem} bytes of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tropical_route_launch(
            offsets.data_ptr(), order.data_ptr(), sstart.data_ptr(),
            costs.data_ptr(), dist.data_ptr(), pred.data_ptr(),
            R, P, L, stream)
    _LIB.check(err, "tropical_route launch")
    tropical_route_cuda.launches += 1
    return dist, pred


tropical_route_cuda.launches = 0


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
    _check_inputs("tropical_route_kbest_cuda", starts, ends, costs)
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
