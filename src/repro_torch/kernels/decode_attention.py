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
  its 128-row tiles, only the live rows read; a second kernel combines the
  blocks' partial (m, l, acc). Unlike the TPU kernel it takes any capacity
  S (the TPU kernel asserts S % blk_k == 0).

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

#: head dims the CUDA kernel is instantiated for
CUDA_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: cache rows per tile of the CUDA kernel; a split is a whole number of tiles
TILE_ROWS = 128
#: the split plan aims at this many blocks per SM over the grid where S
#: allows (in waves: an SM holds up to 4 at the engine's shapes); on the
#: H100, 8 timed faster than 2 or 4 at GPT-2 Large's decode shape and
#: about as fast at Zamba2's
BLOCKS_PER_SM = 8

_LIB = CudaLibrary("decode_attention.cu", {
    "decode_attention_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})


def split_plan(S: int, B: int, Hkv: int, num_sms: int) -> Tuple[int, int]:
    """How the CUDA kernel splits a capacity of ``S`` cache rows across
    blocks: ``(splits, rows_per_split)``. Split i covers rows
    ``[i * rows_per_split, min((i + 1) * rows_per_split, S))``; together
    they cover [0, S) once, each is a whole number of ``TILE_ROWS`` rows
    (but the last, which ends at S), and none is empty. The plan aims at
    ``BLOCKS_PER_SM`` blocks per SM over the (splits, Hkv, B) grid and
    takes one split when the B * Hkv blocks already reach it or S fits one
    tile. It depends on the capacity, never on ``kv_len``, so the host
    never waits for the device to plan."""
    if S < 1 or B < 1 or Hkv < 1:
        raise ValueError(f"split_plan: S={S}, B={B}, Hkv={Hkv} must be >= 1")
    tiles = -(-S // TILE_ROWS)
    want = -(-BLOCKS_PER_SM * num_sms // (B * Hkv))
    splits = max(1, min(tiles, want))
    per = -(-tiles // splits)            # tiles per split
    return -(-tiles // per), per * TILE_ROWS


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
    the host). Head dim in ``CUDA_HEAD_DIMS``, Hq a multiple of Hkv. Raises
    on anything else, and never copies: a strided cache slice is refused,
    not silently made contiguous. Each call launches the split kernel on a
    (splits, Hkv, B) grid (``split_plan``) and the combine kernel, with
    the partials in scratch from ``torch.empty``; ``launches`` counts the
    wrapper calls that launched them."""
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
    splits, rows = split_plan(S, B, Hkv, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    part = torch.empty(splits * B * Hq * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _LIB.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), part.data_ptr(), B, S, Hq,
            Hkv, D, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D), splits, rows,
            stream)
    _LIB.check(err, "decode_attention launch")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
