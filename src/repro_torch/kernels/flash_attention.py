"""Blocked causal GQA flash attention — kernel K3.

Port of ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel): q (B, S, Hq, D); k, v (B, Sk, Hkv, D) -> (B, S, Hq, D) in q's
dtype, with query head h reading KV head h // (Hq // Hkv), scores and
softmax statistics in f32, and q scaled by 1/sqrt(D) before QK^T.

Two versions of the same function live here:

* ``flash_attention_plain`` — plain PyTorch on any device: the full
  softmax in f32 over grouped (never repeated) KV heads.
* ``flash_attention_cuda`` — the hand-written CUDA kernel
  (``csrc/flash_attention.cu``): online softmax over 64-key tiles, one
  block per (64-query tile, head, batch). Unlike the TPU kernel it takes
  any sequence length: the ragged tail is masked inside the kernel.

``kernels.ops.flash_attention`` picks between them by the device of the
tensors it is given.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaLibrary

#: head dims the CUDA kernel is instantiated for
CUDA_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIB = CudaLibrary("flash_attention.cu", {
    "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
})


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

    q, k, v contiguous, one dtype (float32 or bfloat16), one CUDA device,
    head dim in ``CUDA_HEAD_DIMS``, Hq a multiple of Hkv. Raises on anything
    else. ``launches`` counts the kernel launches this wrapper made."""
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
    if D not in CUDA_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in "
                         f"{CUDA_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be on the "
                             f"CUDA device of q, got {t.device}")
        if t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be a "
                             f"contiguous {q.dtype} tensor")
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
            B, S, Sk, Hq, Hkv, D, _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(D), int(bool(causal)), stream)
    _LIB.check(err, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
