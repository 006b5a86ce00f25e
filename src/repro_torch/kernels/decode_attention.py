"""One-token GQA decode attention over a KV cache — kernel K4.

Port of ``repro.kernels.decode_attention.decode_attention`` (the Pallas TPU
kernel): q (B, Hq, D); cache_k, cache_v (B, S, Hkv, D); kv_len (B,) int32
-> (B, Hq, D) in q's dtype. Query head h attends over cache rows
``0 .. kv_len[b] - 1`` of KV head h // (Hq // Hkv), with q scaled by
1/sqrt(D) in f32 before the dot products and the softmax in f32.

Two versions of the same function live here:

* ``decode_attention_plain`` — plain PyTorch on any device: the full
  softmax in f32 over grouped (never repeated) KV heads.
* ``decode_attention_cuda`` — the hand-written CUDA kernels
  (``csrc/decode_attention.cu``), flash-decoding: the cache rows of each
  (KV head, batch row) are split across blocks by ``split_plan``, each
  block serving all of the head's query heads with an online softmax over
  its tiles, only the live rows read; a second kernel combines the
  blocks' partial (m, l, acc). ``decode_kernel`` names the split kernel:
  bf16 at D = 64, 80 or 128 (groups of up to ``MMA_MAX_GROUP`` heads) runs
  on the tensor cores (64-row tiles loaded by TMA), f32 and bf16 at D = 16
  or 32 on FP32 FMAs (128-row tiles). Unlike the TPU kernel it takes any
  capacity S (the TPU kernel asserts S % blk_k == 0).

``kernels.ops.decode_attention`` picks between them by the device of the
tensors it is given.

**The kv_len contract is 1 <= kv_len[b] <= S.** At kv_len = 0 the three
versions disagree, and none is meaningful: the reference oracle and the
plain version return NaN (every score is -inf), the Pallas kernel the mean
of V over the capacity (every score is its -1e30 mask), and the CUDA
kernel zeros (no row is read). A serving engine never gets there: the
cache holds at least the token just written. The CUDA kernel clamps
kv_len to [0, S], so a larger value reads no memory past the cache.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaLibrary

#: head dims the CUDA kernels are instantiated for
CUDA_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the split kernels: name (its profiler name is ``name<...>``) -> (code of
#: ``decode_attention_launch``, cache rows per tile)
KERNELS = {"decode_split_kernel": (0, 128),
           "decode_split_mma_kernel": (1, 64)}
#: cache rows per tile of the FP32-FMA split kernel (the default of
#: ``split_plan``); a split is a whole number of its kernel's tiles
TILE_ROWS = KERNELS["decode_split_kernel"][1]
#: cache rows per tile of the tensor-core split kernel
MMA_TILE_ROWS = KERNELS["decode_split_mma_kernel"][1]
#: head dims of the tensor-core kernel (128-byte swizzle rows, and D = 80's
#: last 16 columns as 32-byte rows)
MMA_HEAD_DIMS = (64, 80, 128)
#: the most query heads per KV head the tensor-core kernel takes (four
#: warps of 16 heads). It serves every bf16 group at its head dims, G = 1
#: included: on the H100 it was faster than the FMA kernel at every bf16
#: shape measured (GPT-2 Large's decode 0.0080 against 0.0109 ms on the
#: device, Whisper's 0.0046 against 0.0066, Zamba2's D = 80 0.0360 against
#: 0.0418; G = 3-48 by 1.3-4.5x), so the FMA kernel is not built for bf16
#: at D = 64, 80, 128
MMA_MAX_GROUP = 64
#: the split plan aims at this many blocks per SM over the grid where S
#: allows (in waves: an SM holds up to 4 at the engine's shapes); on the
#: H100, 8 timed faster than 2 or 4 at GPT-2 Large's decode shape and
#: about as fast at Zamba2's
BLOCKS_PER_SM = 8

_LIB = CudaLibrary("decode_attention.cu", {
    "decode_attention_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p],
    "decode_attention_smem_bytes": [ctypes.c_int] * 5,
})


def decode_kernel(dtype: torch.dtype, G: int, D: int) -> str:
    """The split kernel that serves a call (a key of ``KERNELS``): the
    tensor-core kernel for bf16 at a head dim in ``MMA_HEAD_DIMS``, the
    FP32-FMA kernel for f32 and for bf16 at D = 16, 32. Raises for a bf16
    group above ``MMA_MAX_GROUP`` at the tensor-core head dims, which no
    kernel takes."""
    if dtype == torch.bfloat16 and D in MMA_HEAD_DIMS:
        if G > MMA_MAX_GROUP:
            raise ValueError(f"decode_attention: no kernel takes {G} query "
                             f"heads per KV head in bf16 at D = {D} (at "
                             f"most {MMA_MAX_GROUP})")
        return "decode_split_mma_kernel"
    return "decode_split_kernel"


def split_plan(S: int, B: int, Hkv: int, num_sms: int,
               tile_rows: int = TILE_ROWS) -> Tuple[int, int]:
    """How a split kernel with ``tile_rows``-row tiles splits a capacity of
    ``S`` cache rows across blocks: ``(splits, rows_per_split)``. Split i
    covers rows ``[i * rows_per_split, min((i + 1) * rows_per_split,
    S))``; together they cover [0, S) once, each is a whole number of
    tiles (but the last, which ends at S), and none is empty. The plan
    aims at ``BLOCKS_PER_SM`` blocks per SM over the (splits, Hkv, B) grid
    and takes one split when the B * Hkv blocks already reach it or S fits
    one tile. It depends on the capacity, never on ``kv_len``, so the host
    never waits for the device to plan."""
    if S < 1 or B < 1 or Hkv < 1:
        raise ValueError(f"split_plan: S={S}, B={B}, Hkv={Hkv} must be >= 1")
    tiles = -(-S // tile_rows)
    want = -(-BLOCKS_PER_SM * num_sms // (B * Hkv))
    splits = max(1, min(tiles, want))
    per = -(-tiles // splits)            # tiles per split
    return -(-tiles // per), per * tile_rows


def decode_plan(S: int, B: int, Hq: int, Hkv: int, D: int,
                dtype: torch.dtype, num_sms: int) -> Tuple[str, int, int]:
    """The launch of one call: ``(kernel, splits, rows_per_split)``, the
    split kernel by ``decode_kernel`` and the split plan at its tile."""
    kernel = decode_kernel(dtype, Hq // Hkv, D)
    splits, rows = split_plan(S, B, Hkv, num_sms, KERNELS[kernel][1])
    return kernel, splits, rows


def decode_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,D); caches (B,S,Hkv,D); kv_len (B,) -> (B,Hq,D) in q's dtype.

    The kernel's arithmetic without tiling: q scaled by 1/sqrt(D) in f32,
    f32 scores against the query's KV group, -inf past ``kv_len[b]``, f32
    softmax, f32 PV, one cast at the end."""
    B, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k.float())
    live = torch.arange(S, device=q.device)[None, :] < \
        kv_len.to(q.device).reshape(-1, 1)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, cache_v.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors; same contract as the plain version.

    q (B, Hq, D), cache_k and cache_v (B, S, Hkv, D): contiguous, one dtype
    (float32 or bfloat16), 16-byte aligned, one CUDA device; kv_len (B,)
    contiguous int32 on the same device, read by the kernel (never synced to
    the host). Head dim in ``CUDA_HEAD_DIMS``, Hq a multiple of Hkv (in
    bf16 at D = 64, 80, 128 at most ``MMA_MAX_GROUP`` times Hkv). Raises
    on anything else, and never copies: a strided cache slice is refused,
    not silently made contiguous. Each call launches the split kernel that
    ``decode_plan`` names on a (splits, Hkv, B) grid and the combine kernel,
    with the partials in scratch from ``torch.empty``; ``launches`` counts
    the wrapper calls that launched them."""
    if q.dim() != 3 or cache_k.dim() != 4 or cache_v.dim() != 4:
        raise ValueError("decode_attention_cuda: q must be (B, Hq, D) and "
                         "the caches (B, S, Hkv, D)")
    B, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape != (B, S, Hkv, D) or cache_v.shape != cache_k.shape:
        raise ValueError(f"decode_attention_cuda: cache shapes "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention_cuda: Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}")
    if D not in CUDA_HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda: head dim {D} not in "
                         f"{CUDA_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention_cuda: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                    ("kv_len", kv_len)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention_cuda: {name} must be on the "
                             f"CUDA device of q, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_cuda: {name} must be "
                             "contiguous (a cache slice must be a layer of "
                             "a layer-major cache)")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != q.dtype or t.data_ptr() % 16:
            raise ValueError(f"decode_attention_cuda: {name} must be a "
                             f"16-byte aligned {q.dtype} tensor")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"decode_attention_cuda: kv_len must be int32 of "
                         f"shape ({B},), got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    if B == 0 or Hq == 0:
        return out
    if S == 0:
        raise ValueError("decode_attention_cuda: the cache has no rows")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    kernel, splits, rows = decode_plan(S, B, Hq, Hkv, D, q.dtype, sms)
    part = torch.empty(splits * B * Hq * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _LIB.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), part.data_ptr(), B, S, Hq,
            Hkv, D, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D), splits, rows,
            KERNELS[kernel][0], stream)
    _LIB.check(err, "decode_attention launch")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def smem_bytes(kernel: str, dtype: torch.dtype, D: int, G: int,
               rows_per_split: int) -> int:
    """Dynamic shared memory of one split block (from the built library):
    the FMA kernel at group ``G`` (0 when the group does not fit), the
    tensor-core kernel with one tile per split or more."""
    return int(_LIB.get().decode_attention_smem_bytes(
        KERNELS[kernel][0], _DTYPE_CODE[dtype], D, G, rows_per_split))
