"""Kernel dispatch by device.

Port of ``repro.kernels.ops`` for the kernels ported so far (K1
``tropical_route_kbest``, K2 ``tropical_route``, K3 ``flash_attention``,
K4 ``decode_attention``, K5 ``wkv6_chunked`` and K6 ``ssd_chunked``),
and the fused routing-window entries that run K1's and K2's DPs.
The rule is the tensor's
device, not a fallback: a CPU tensor goes to the kernel's plain PyTorch
version (that is how the tests run without a GPU); a CUDA tensor launches
the hand-written kernel, and a kernel that cannot take the input raises
instead of quietly running the plain version. Each CUDA wrapper counts its launches in
``<wrapper>.launches``.

No kernel has a gradient, as no Pallas kernel of the reference has one
(``jax.grad`` through them raises). A CUDA kernel's output is a new tensor
with no ``grad_fn``, so a gradient through it would quietly be zero: the
float dispatchers (K3-K6) therefore raise on a CUDA tensor that requires
grad while autograd is recording (``refuse_grad``). Training runs
``attn_impl="xla"``, the plain versions, which are differentiable; serving
runs under ``torch.inference_mode`` and never meets the check.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.rwkv6_chunk import (wkv6_chunked_cuda,
                                             wkv6_chunked_plain)
from repro_torch.kernels.ssd_chunk import ssd_chunked_cuda, ssd_chunked_plain
from repro_torch.kernels.tropical_route import (route_window_cuda,
                                                route_window_kbest_cuda,
                                                route_window_kbest_plain,
                                                route_window_plain,
                                                tropical_route_cuda,
                                                tropical_route_kbest_cuda,
                                                tropical_route_kbest_plain,
                                                tropical_route_plain)

#: the CUDA wrappers whose ``launches`` counters a run can read and reset
CUDA_KERNELS = {
    "tropical_route_kbest": tropical_route_kbest_cuda,
    "tropical_route": tropical_route_cuda,
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "wkv6_chunked": wkv6_chunked_cuda,
    "ssd_chunked": ssd_chunked_cuda,
}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd is recording and any of ``tensors`` requires
    grad: kernel ``name`` has no gradient, and its output would carry
    none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no gradient (as the reference's "
            "Pallas kernel has none), and an input requires grad; train "
            "with attn_impl='xla', which runs the differentiable plain "
            "PyTorch version")


def flash_attention(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,D); k,v (B,Sk,Hkv,D) -> (B,S,Hq,D)."""
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal)
    refuse_grad("flash_attention", q, k, v)
    return flash_attention_cuda(q, k, v, causal=causal)


def decode_attention(q, cache_k, cache_v, kv_len):
    """q (B,Hq,D); caches (B,S,Hkv,D); kv_len (B,) int32 -> (B,Hq,D).
    Contract: 1 <= kv_len[b] <= S (``kernels/decode_attention.py``)."""
    if _on_cpu(q):
        return decode_attention_plain(q, cache_k, cache_v, kv_len)
    refuse_grad("decode_attention", q, cache_k, cache_v)
    return decode_attention_cuda(q, cache_k, cache_v, kv_len)


def wkv6(r, k, v, lw, u, state0):
    """r, k, v, lw (B,S,H,K) f32; u (H,K); state0 (B,H,K,K) -> (y, state).
    The reference's ``ops.wkv6`` runs its token oracle off the TPU; the
    port's plain version is the chunked form, which the tests hold against
    both."""
    if _on_cpu(r):
        return wkv6_chunked_plain(r, k, v, lw, u, state0)
    refuse_grad("wkv6_chunked", r, k, v, lw, u, state0)
    return wkv6_chunked_cuda(r, k, v, lw, u, state0)


def ssd(x, dt, la, Bm, Cm, h0):
    """x (B,S,H,P) f32; dt, la (B,S,H); Bm, Cm (B,S,N); h0 (B,H,N,P) ->
    (y, state). As for ``wkv6``, the port's plain version is the chunked
    form, which the tests hold against the reference's token oracle and
    its Pallas kernel."""
    if _on_cpu(x):
        return ssd_chunked_plain(x, dt, la, Bm, Cm, h0)
    refuse_grad("ssd_chunked", x, dt, la, Bm, Cm, h0)
    return ssd_chunked_cuda(x, dt, la, Bm, Cm, h0)


def tropical_route(starts, ends, costs, *, total_layers: int, csr=None):
    """starts/ends (P,) int32; costs (R, P) f32 -> (dist, pred), each
    (R, L+1). ``csr`` (``tropical_route.route_csr``) is the kernel's
    cached bucketing; the plain version does not need it."""
    if _on_cpu(costs):
        return tropical_route_plain(starts, ends, costs,
                                    total_layers=total_layers)
    return tropical_route_cuda(starts, ends, costs,
                               total_layers=total_layers, csr=csr)


def tropical_route_kbest(starts, ends, costs, *, total_layers: int,
                         k_best: int):
    """starts/ends (P,) int32; costs (R, P) f32 -> (distK, pedge, prank)."""
    if _on_cpu(costs):
        return tropical_route_kbest_plain(starts, ends, costs,
                                          total_layers=total_layers,
                                          k_best=k_best)
    return tropical_route_kbest_cuda(starts, ends, costs,
                                     total_layers=total_layers,
                                     k_best=k_best)


def route_window(csr, starts, latency, trust, alive, tau, *,
                 timeout_ms: float, total_layers: int, k_max: int):
    """One routing window, single best: effective costs, K2's DP and the
    backtrack -> (hops (R, k_max) int32, costs (R,) f32)
    (``tropical_route.route_window_plain``). On CUDA one launch, counted
    as K2's."""
    kw = dict(timeout_ms=timeout_ms, total_layers=total_layers, k_max=k_max)
    if _on_cpu(latency):
        return route_window_plain(csr, starts, latency, trust, alive, tau,
                                  **kw)
    return route_window_cuda(csr, starts, latency, trust, alive, tau, **kw)


def route_window_kbest(csr, starts, latency, trust, alive, tau, *,
                       timeout_ms: float, total_layers: int, k_best: int,
                       k_max: int):
    """One routing window, K best: effective costs, K1's DP and the
    backtrack -> (hops (R, K, k_max) int32, costs (R, K) f32). On CUDA one
    launch, counted as K1's."""
    kw = dict(timeout_ms=timeout_ms, total_layers=total_layers,
              k_best=k_best, k_max=k_max)
    if _on_cpu(latency):
        return route_window_kbest_plain(csr, starts, latency, trust, alive,
                                        tau, **kw)
    return route_window_kbest_cuda(csr, starts, latency, trust, alive, tau,
                                   **kw)


def reset_launch_counts() -> None:
    for fn in CUDA_KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in CUDA_KERNELS.items()}
