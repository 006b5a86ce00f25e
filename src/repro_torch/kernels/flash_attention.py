"""Blocked causal GQA flash attention — kernel K3.

Port of ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel): q (B, S, Hq, D); k, v (B, Sk, Hkv, D) -> (B, S, Hq, D) in q's
dtype, with query head h reading KV head h // (Hq // Hkv), scores and
softmax statistics in f32, and q scaled by 1/sqrt(D) before QK^T.

Two versions of the same function live here:

* ``flash_attention_plain`` — plain PyTorch on any device: the full
  softmax in f32 over grouped (never repeated) KV heads.
* ``flash_attention_cuda`` — the hand-written CUDA kernels
  (``csrc/flash_attention.cu``), an online softmax over key tiles with one
  block per (query tile, head, batch). ``flash_kernel`` names the kernel
  that serves a call: bf16 at D = 64, 80, 128 runs on Hopper's ``wgmma``
  (a producer warpgroup keeps TMA loads of 128-key K/V tiles in flight,
  one or two consumer warpgroups of 64 query rows each), bf16 at D = 16,
  32 on ``mma.sync`` (64-query tiles, K/V staged by ``cp.async``); both
  round P to bf16 for PV with f32 accumulation. f32 runs on FP32 FMAs.
  Unlike the TPU kernel it takes any sequence length: the ragged tail is
  masked inside the kernel.

``kernels.ops.flash_attention`` picks between them by the device of the
tensors it is given.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaLibrary

#: head dims the CUDA kernels are instantiated for
CUDA_HEAD_DIMS = (16, 32, 64, 80, 128)
#: head dims of the bf16 wgmma kernel; the others run on mma.sync
WGMMA_HEAD_DIMS = (64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)

#: the CUDA kernels: name (its profiler name is ``name<...>``) -> (code of
#: ``flash_attention_launch``, query rows per block)
KERNELS = {
    "flash_f32_kernel": (0, 64),
    "flash_bf16_mma_kernel": (1, 64),
    "flash_bf16_wgmma_kernel": (2, 64),        # one consumer warpgroup
    "flash_bf16_wgmma_kernel/2": (3, 128),     # two consumer warpgroups
}
#: at most this many query rows, the wgmma kernel runs one consumer
#: warpgroup (64 rows a block: Whisper's Sq = 1 and 4, the main path's
#: 8-token prompts), else two (128 rows a block)
WGMMA_ONE_GROUP_ROWS = 64

_LIB = CudaLibrary("flash_attention.cu", {
    "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_smem_bytes": [ctypes.c_int, ctypes.c_int],
})


def flash_kernel(dtype: torch.dtype, D: int, Sq: int) -> str:
    """The CUDA kernel that serves a call (a key of ``KERNELS``): f32 on
    FP32 FMAs; bf16 at a head dim in ``WGMMA_HEAD_DIMS`` on wgmma, with one
    consumer warpgroup up to ``WGMMA_ONE_GROUP_ROWS`` query rows and two
    above; bf16 at D = 16, 32 on mma.sync."""
    if D not in CUDA_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in "
                         f"{CUDA_HEAD_DIMS}")
    if dtype == torch.float32:
        return "flash_f32_kernel"
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_cuda: dtype {dtype} not in "
                         f"{_DTYPES}")
    if D not in WGMMA_HEAD_DIMS:
        return "flash_bf16_mma_kernel"
    if Sq <= WGMMA_ONE_GROUP_ROWS:
        return "flash_bf16_wgmma_kernel"
    return "flash_bf16_wgmma_kernel/2"


def flash_grid(B: int, Sq: int, Hq: int, kernel: str) -> Tuple[int, int, int]:
    """The launch grid of ``kernel``: (Hq, query tiles, B), the heads of a
    query tile adjacent in launch order (a KV group's tiles come from L2
    to its heads). Block (x, y, z) serves head x, batch row z and query
    tile ``tiles - 1 - y``: the heaviest causal tiles launch first."""
    rows = KERNELS[kernel][1]
    return Hq, -(-Sq // rows), B


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """q (B,S,Hq,D); k,v (B,Sk,Hkv,D) -> (B,S,Hq,D) in q's dtype.

    The kernel's arithmetic without tiling: q scaled by 1/sqrt(D) in f32,
    f32 scores against the query's KV group, causal mask aligned at
    position 0, f32 softmax, f32 PV, one cast at the end."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, Hkv, G, D) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors; same contract as the plain version.

    q, k, v contiguous and 16-byte aligned, one dtype (float32 or
    bfloat16), one CUDA device, head dim in ``CUDA_HEAD_DIMS``, Hq a
    multiple of Hkv. Raises on anything else. ``flash_kernel`` picks the
    kernel; ``launches`` counts the kernel launches this wrapper made."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_cuda: q, k, v must be 4-D "
                         "(B, S, H, D)")
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: k/v shapes {tuple(k.shape)}"
                         f", {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}")
    kernel = flash_kernel(q.dtype, D, S)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be on the "
                             f"CUDA device of q, got {t.device}")
        if t.dtype != q.dtype or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be a "
                             f"contiguous, 16-byte aligned {q.dtype} tensor")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if Sk == 0:
        raise ValueError("flash_attention_cuda: no keys to attend to")
    lib = _LIB.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Sk, Hq, Hkv, D, KERNELS[kernel][0],
            1.0 / math.sqrt(D), int(bool(causal)), stream)
    _LIB.check(err, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def smem_bytes(kernel: str, D: int) -> int:
    """Dynamic shared memory of one block of ``kernel`` at head dim ``D``
    (from the built library; -1 for a pair it does not take)."""
    return int(_LIB.get().flash_attention_smem_bytes(KERNELS[kernel][0], D))
