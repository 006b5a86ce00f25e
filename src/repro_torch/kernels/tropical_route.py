"""Batched min-plus (tropical) routing DP — kernels K2 and K1, and the
fused window entries built on them.

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
  hand-written CUDA kernels (``csrc/tropical_route.cu``): one warp per
  request row over the peers bucketed by end boundary (``route_csr``), the
  whole chain in shared memory. Their outputs equal the plain versions'
  bit for bit.

The window entries route what one serving window (or one
``route_batched`` call) needs in ONE launch: the pruned effective costs,
the DP and the backtrack. ``route_window_plain`` /
``route_window_kbest_plain`` compose ``effective_costs`` → the plain DP →
``backtrack`` / ``backtrack_kbest`` (all defined here, and re-exported by
``routing_torch``, so ``kernels`` never imports ``core``);
``route_window_cuda`` / ``route_window_kbest_cuda`` run the fused kernels,
counted under K2's and K1's ``launches``. ``upload_window_state`` brings
their per-window inputs up in one host-to-device copy and
``window_to_host`` their outputs back in one device-to-host copy.

``kernels.ops`` picks between the versions by the device of the tensors it
is given.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.obs.trace import NOOP_SPAN, wall

INF = 3.0e38   # f32-rounded where it meets a tensor, as jnp.float32(3e38)

_LIB = CudaLibrary("tropical_route.cu", {
    "tropical_route_launch": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "tropical_route_kbest_launch": [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "route_window_launch": [ctypes.c_void_p] * 8 + [ctypes.c_float]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "route_smem_bytes": [ctypes.c_int] * 5,
    "route_launch_floor": [ctypes.c_void_p],
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
    """The peers bucketed by end boundary, as the kernels read them.

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


def csr_ends(csr, n_peers: int, total_layers: int) -> torch.Tensor:
    """(P,) int32 end boundaries as the plain DPs read them, from a
    ``route_csr``: b for the peers of bucket b, L + 1 for the peers ending
    outside [1, L] (no boundary matches them, as none matches their own
    end)."""
    offsets, order, _ = csr
    L = int(total_layers)
    dev = offsets.device
    bounds = torch.cat([offsets.long(),
                        torch.tensor([n_peers], device=dev)])
    key = torch.repeat_interleave(torch.arange(L + 2, device=dev),
                                  torch.diff(bounds))
    ends = torch.empty(n_peers, dtype=torch.int32, device=dev)
    ends[order.long()] = key.to(torch.int32)
    return ends


def _check(fn: str, dev, specs) -> None:
    """Each (name, tensor, dtype, shape) must be a contiguous tensor of that
    dtype and shape on ``dev``, a CUDA device."""
    if dev.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {dev}")
    for name, t, dt, shape in specs:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} must be on {dev}, got "
                             f"{t.device}")
        if t.dtype != dt or not t.is_contiguous() or \
                tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"tensor of shape {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _csr_specs(csr, P: int, L: int):
    offsets, order, sstart = csr
    return [("csr offsets", offsets, torch.int32, (L + 2,)),
            ("csr order", order, torch.int32, (P,)),
            ("csr sstart", sstart, torch.int32, (P,))]


def _check_smem(fn: str, P: int, L: int, K: int, kbest: bool,
                window: bool) -> None:
    smem = _LIB.get().route_smem_bytes(P, L, K, int(kbest), int(window))
    if smem > _MAX_SMEM:
        raise ValueError(f"{fn}: P={P}, L={L} needs {smem} bytes of shared "
                         f"memory per request row, more than {_MAX_SMEM}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def tropical_route_cuda(starts: torch.Tensor, ends: torch.Tensor,
                        costs: torch.Tensor, *, total_layers: int,
                        csr=None):
    """Kernel K2 on CUDA tensors; same contract as the plain version.

    starts/ends (P,) int32 and costs (R, P) float32, contiguous, on one
    CUDA device. ``csr`` is ``route_csr(starts, ends, total_layers)``,
    built here when not given (the planner passes its cached copy).
    Raises on anything else. ``launches`` counts the kernel launches this
    wrapper and ``route_window_cuda`` made."""
    fn = "tropical_route_cuda"
    R, P = costs.shape
    L = int(total_layers)
    dev = costs.device
    _check(fn, dev, [("starts", starts, torch.int32, (P,)),
                     ("ends", ends, torch.int32, (P,)),
                     ("costs", costs, torch.float32, (R, P))])
    if L < 1 or P < 1:
        raise ValueError(f"{fn}: need total_layers >= 1 and P >= 1 "
                         f"(got {L}, {P})")
    if csr is None:
        csr = route_csr(starts, ends, L)
    _check(fn, dev, _csr_specs(csr, P, L))
    dist = torch.empty((R, L + 1), dtype=torch.float32, device=dev)
    pred = torch.empty((R, L + 1), dtype=torch.int32, device=dev)
    if R == 0:                  # degenerate batch: nothing to launch
        return dist, pred
    _check_smem(fn, P, L, 1, False, False)
    offsets, order, sstart = csr
    with torch.cuda.device(dev):
        err = _LIB.get().tropical_route_launch(
            offsets.data_ptr(), order.data_ptr(), sstart.data_ptr(),
            costs.data_ptr(), dist.data_ptr(), pred.data_ptr(),
            R, P, L, _stream(dev))
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
                              k_best: int, csr=None):
    """Kernel K1 on CUDA tensors; same contract as the plain version.

    starts/ends (P,) int32 and costs (R, P) float32, contiguous, on one
    CUDA device; ``csr`` as for ``tropical_route_cuda``. Raises on
    anything else. ``launches`` counts the kernel launches this wrapper and
    ``route_window_kbest_cuda`` made."""
    fn = "tropical_route_kbest_cuda"
    R, P = costs.shape
    L, K = int(total_layers), int(k_best)
    dev = costs.device
    _check(fn, dev, [("starts", starts, torch.int32, (P,)),
                     ("ends", ends, torch.int32, (P,)),
                     ("costs", costs, torch.float32, (R, P))])
    if not 1 <= K <= 32 or L < 1 or P < 1:
        raise ValueError(f"{fn}: need 1 <= k_best <= 32, total_layers >= "
                         f"1, P >= 1 (got {K}, {L}, {P})")
    if csr is None:
        csr = route_csr(starts, ends, L)
    _check(fn, dev, _csr_specs(csr, P, L))
    distK = torch.empty((R, L + 1, K), dtype=torch.float32, device=dev)
    pedge = torch.empty((R, L + 1, K), dtype=torch.int32, device=dev)
    prank = torch.empty((R, L + 1, K), dtype=torch.int32, device=dev)
    if R == 0:                  # degenerate batch: nothing to launch
        return distK, pedge, prank
    _check_smem(fn, P, L, K, True, False)
    offsets, order, sstart = csr
    with torch.cuda.device(dev):
        err = _LIB.get().tropical_route_kbest_launch(
            offsets.data_ptr(), order.data_ptr(), sstart.data_ptr(),
            costs.data_ptr(), distK.data_ptr(), pedge.data_ptr(),
            prank.data_ptr(), R, P, L, K, _stream(dev))
    _LIB.check(err, "tropical_route_kbest launch")
    tropical_route_kbest_cuda.launches += 1
    return distK, pedge, prank


tropical_route_kbest_cuda.launches = 0


# ---------------------------------------------------------------------------
# The window: effective costs, DP, backtrack
# ---------------------------------------------------------------------------


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
    order. pred: (R, L+1) from ``layered_dp`` (or the CUDA kernel). A
    step is valid only at a boundary in [1, L] (a chain that reaches a
    start outside it ends there, as the reference's out-of-range read of
    ``pred`` gives an invalid step)."""
    R = pred.shape[0]
    L = int(total_layers)
    dev = pred.device
    pr = pred.long()
    st = starts.long()
    b = torch.full((R,), L, dtype=torch.long, device=dev)
    hops = []
    for _ in range(int(k_max)):
        p = torch.gather(pr, 1, b.clamp(0, L)[:, None])[:, 0]
        valid = (b > 0) & (b <= L) & (p >= 0)
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


def route_window_plain(csr, starts, latency, trust, alive, tau, *,
                       timeout_ms: float, total_layers: int, k_max: int):
    """One window, single best: ``effective_costs`` → ``tropical_route_plain``
    → ``backtrack``.

    csr: ``route_csr`` of the topology; starts (P,) int32 (unclamped);
    latency / trust (P,) f32; alive (P,) bool (alive ∧ valid); tau (R,)
    f32 trust floors. Returns (hops (R, k_max) int32 peer indices in stage
    order, -1 padded; costs (R,) f32, dist[L])."""
    L = int(total_layers)
    costs = effective_costs(latency, trust, alive, tau, timeout_ms)
    ends = csr_ends(csr, starts.shape[0], L)
    dist, pred = tropical_route_plain(starts, ends, costs, total_layers=L)
    hops = backtrack(starts, pred, total_layers=L, k_max=k_max)
    return hops.to(torch.int32), dist[:, L]


def route_window_kbest_plain(csr, starts, latency, trust, alive, tau, *,
                             timeout_ms: float, total_layers: int,
                             k_best: int, k_max: int):
    """One window, K best: ``effective_costs`` →
    ``tropical_route_kbest_plain`` → ``backtrack_kbest``. Inputs as for
    ``route_window_plain``. Returns (hops (R, K, k_max) int32, costs (R, K)
    f32, distK[L], nondecreasing along K)."""
    L = int(total_layers)
    costs = effective_costs(latency, trust, alive, tau, timeout_ms)
    ends = csr_ends(csr, starts.shape[0], L)
    distK, pedge, prank = tropical_route_kbest_plain(
        starts, ends, costs, total_layers=L, k_best=k_best)
    hops = backtrack_kbest(starts, pedge, prank, total_layers=L,
                           k_max=k_max)
    return hops.to(torch.int32), distK[:, L, :]


def _route_window_cuda(fn, csr, starts, latency, trust, alive, tau,
                       timeout_ms, L, K, k_max):
    """Launch a fused window kernel (K = 0: single best). Both outputs are
    views of ONE int32 buffer, hops then costs, so ``window_to_host``
    brings them back in one copy."""
    P, R = starts.shape[0], tau.shape[0]
    dev = tau.device
    _check(fn, dev, [("starts", starts, torch.int32, (P,)),
                     ("latency", latency, torch.float32, (P,)),
                     ("trust", trust, torch.float32, (P,)),
                     ("alive", alive, torch.bool, (P,)),
                     ("tau", tau, torch.float32, (R,))]
           + _csr_specs(csr, P, L))
    if L < 1 or P < 1 or k_max < 0 or not 0 <= K <= 32:
        raise ValueError(f"{fn}: need total_layers >= 1, P >= 1, k_max >= "
                         f"0 and k_best <= 32 (got {L}, {P}, {k_max}, {K})")
    rows = R * max(K, 1)
    buf = torch.empty(rows * k_max + rows, dtype=torch.int32, device=dev)
    shape = (R, K) if K else (R,)
    hops = buf[:rows * k_max].view(*shape, k_max)
    costs = buf[rows * k_max:].view(torch.float32).view(shape)
    if R == 0:                  # degenerate batch: nothing to launch
        return hops, costs
    _check_smem(fn, P, L, max(K, 1), K > 0, True)
    offsets, order, sstart = csr
    with torch.cuda.device(dev):
        err = _LIB.get().route_window_launch(
            offsets.data_ptr(), order.data_ptr(), sstart.data_ptr(),
            starts.data_ptr(), latency.data_ptr(), trust.data_ptr(),
            alive.data_ptr(), tau.data_ptr(), float(timeout_ms),
            hops.data_ptr(), costs.data_ptr(), R, P, L, K, k_max,
            _stream(dev))
    _LIB.check(err, f"{fn} launch")
    return hops, costs


def route_window_cuda(csr, starts, latency, trust, alive, tau, *,
                      timeout_ms: float, total_layers: int, k_max: int):
    """The fused single-best window kernel on CUDA tensors; the contract of
    ``route_window_plain``, bit for bit. Counts under K2's
    ``tropical_route_cuda.launches``."""
    out = _route_window_cuda("route_window_cuda", csr, starts, latency,
                             trust, alive, tau, timeout_ms,
                             int(total_layers), 0, int(k_max))
    if tau.shape[0]:
        tropical_route_cuda.launches += 1
    return out


def route_window_kbest_cuda(csr, starts, latency, trust, alive, tau, *,
                            timeout_ms: float, total_layers: int,
                            k_best: int, k_max: int):
    """The fused K-best window kernel on CUDA tensors; the contract of
    ``route_window_kbest_plain``, bit for bit, for 1 <= k_best <= 32.
    Counts under K1's ``tropical_route_kbest_cuda.launches``."""
    K = int(k_best)
    if not 1 <= K <= 32:
        raise ValueError(f"route_window_kbest_cuda: need 1 <= k_best <= 32 "
                         f"(got {K})")
    out = _route_window_cuda("route_window_kbest_cuda", csr, starts,
                             latency, trust, alive, tau, timeout_ms,
                             int(total_layers), K, int(k_max))
    if tau.shape[0]:
        tropical_route_kbest_cuda.launches += 1
    return out


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    """One host-to-device copy; to CUDA from pinned memory and without a
    synchronisation (the caching host allocator keeps the pinned block
    until the copy is done)."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def upload_tau(tau, device) -> torch.Tensor:
    """(R,) f32 trust floors on ``device`` in one copy."""
    return _to_device(torch.from_numpy(np.ascontiguousarray(tau, np.float32)),
                      torch.device(device))


def upload_window_state(latency, trust, alive, tau, device):
    """(latency f32, trust f32, alive bool, tau f32) on ``device`` from ONE
    host-to-device copy: the four host arrays (f64 columns rounded to f32
    on the host, as the reference does) packed into one byte buffer —
    latency, trust and tau at 4-byte-aligned offsets, alive last — whose
    device copy the four tensors are views of."""
    lat = np.asarray(latency, np.float32)
    tr = np.asarray(trust, np.float32)
    ta = np.asarray(tau, np.float32)
    P, R = lat.shape[0], ta.shape[0]
    buf = np.empty(9 * P + 4 * R, np.uint8)
    buf[:4 * P].view(np.float32)[:] = lat
    buf[4 * P:8 * P].view(np.float32)[:] = tr
    buf[8 * P:8 * P + 4 * R].view(np.float32)[:] = ta
    buf[8 * P + 4 * R:] = np.asarray(alive, bool)
    dev = _to_device(torch.from_numpy(buf), torch.device(device))

    def f32(lo, hi):
        return dev[lo:hi].view(torch.float32)

    return (f32(0, 4 * P), f32(4 * P, 8 * P),
            dev[8 * P + 4 * R:].view(torch.bool), f32(8 * P, 8 * P + 4 * R))


def window_to_host(hops: torch.Tensor, costs: torch.Tensor):
    """(hops, costs) of a window entry as numpy arrays. A CUDA entry wrote
    both into one buffer, costs right after hops, so they come back in ONE
    synchronising copy (wall span ``route.readback``); CPU tensors are
    read in place."""
    if hops.device.type == "cpu":
        return hops.numpy(), costs.numpy()
    n = hops.numel()
    if hops.untyped_storage().data_ptr() != \
            costs.untyped_storage().data_ptr() or \
            costs.data_ptr() != hops.data_ptr() + 4 * n:
        raise ValueError("window_to_host: costs must follow hops in one "
                         "buffer, as the CUDA window entries write them")
    tr = wall()
    with tr.span("route.readback") if tr.enabled else NOOP_SPAN:
        flat = torch.as_strided(hops, (n + costs.numel(),), (1,)).cpu()
    return (flat[:n].numpy().reshape(hops.shape),
            flat[n:].view(torch.float32).numpy().reshape(costs.shape))


def launch_floor_cuda(device) -> None:
    """Launch an empty kernel (one warp): the floor that the routing
    kernels' per-call and device times are read against. Counted nowhere."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        err = _LIB.get().route_launch_floor(_stream(dev))
    _LIB.check(err, "route_launch_floor")
