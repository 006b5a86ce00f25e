"""Kernel dispatch by device.

Port of ``repro.kernels.ops`` for the kernels ported so far (K1
``tropical_route_kbest``, K2 ``tropical_route`` and K3
``flash_attention``). The rule is the tensor's device, not a fallback: a
CPU tensor goes to the kernel's plain PyTorch version (that is how the
tests run without a GPU); a CUDA tensor launches the hand-written kernel,
and a kernel that cannot take the input raises instead of quietly running
the plain version. Each CUDA wrapper
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.tropical_route import (tropical_route_cuda,
                                                tropical_route_kbest_cuda,
                                                tropical_route_kbest_plain,
                                                tropical_route_plain)

#: the CUDA wrappers whose ``launches`` counters a run can read and reset
CUDA_KERNELS = {
    "tropical_route_kbest": tropical_route_kbest_cuda,
    "tropical_route": tropical_route_cuda,
    "flash_attention": flash_attention_cuda,
}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,D); k,v (B,Sk,Hkv,D) -> (B,S,Hq,D)."""
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)


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


def reset_launch_counts() -> None:
    for fn in CUDA_KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in CUDA_KERNELS.items()}
