"""Chunked RWKV6 WKV scan — kernel K5.

Port of ``repro.kernels.rwkv6_chunk.wkv6_chunked`` (the Pallas TPU kernel):
r, k, v, lw (B, S, H, K) f32 with the log-decay ``lw <= 0``; u (H, K);
state0 (B, H, K, K) -> y (B, S, H, K) f32 and the final state (B, H, K, K).
Per head, with state S (K rows, V = K columns),

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T

computed chunk by chunk with every decay ratio taken as
``exp(non-positive log-cumsum difference)``, so nothing overflows at any
decay strength:

    inter : y += (r * exp(cum_prev)) @ state
    intra : y += A @ v,  A[t,s] = sum_k r_t k_s exp(cum_prev_t - cum_s), s < t
    bonus : y += (sum_k r_t u k_t) v_t
    state <- exp(cum_C) * state + (k * exp(cum_C - cum))^T v

Two versions of the same function live here, beside the one-token
recurrence ``wkv6_step`` (the model's decode step and, token by token,
the oracle ``ref.wkv6_ref``):

* ``wkv6_chunked_plain`` — plain PyTorch on any device, chunks of
  ``CHUNK = 32`` tokens as the reference model's jnp form
  (``repro.models.rwkv6.wkv6_chunked``). It is the port's one chunked
  implementation: ``models/rwkv6.wkv6_chunked`` is this function.
* ``wkv6_chunked_cuda`` — the hand-written CUDA kernels
  (``csrc/rwkv6_chunk.cu``), two launches per call on chunks of
  ``CUDA_CHUNK = 16`` tokens: a fully parallel pre-pass writes the decayed
  r and k, each chunk's state decay and its scores A (the strict lower
  triangle and the bonus diagonal) into scratch arrays the wrapper
  allocates, and the scan runs one block per (V slice, head, batch row),
  each carrying ``CUDA_SLICES[K]`` columns of the state through the
  chunks, the next chunks' tiles in flight, its products on the tensor
  cores as split 3xTF32 products (f32 accuracy, not single-pass TF32).

Both take any S. The reference asserts ``S % chunk == 0`` (its model at
``chunk = min(32, S)``), so it cannot prefill a 40-token prompt; here the
tail is padded (plain) or masked (kernel) with r = k = v = 0 and lw = 0,
which leaves the state unchanged and adds nothing to any real token's y:
the padded y is dropped. ``kernels.ops.wkv6`` picks between the versions
by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaLibrary

#: tokens per chunk of the plain version (the reference model's CHUNK)
CHUNK = 32
#: tokens per chunk of the CUDA kernels (their own choice: see the source)
CUDA_CHUNK = 16
#: head sizes the CUDA kernels are instantiated for, each with the state
#: columns one scan block carries (``REPRO_WKV6_SHAPES`` in the source)
CUDA_SLICES = {8: 8, 16: 16, 32: 16, 64: 16}
CUDA_HEAD_DIMS = tuple(sorted(CUDA_SLICES))

_LIB = CudaLibrary("rwkv6_chunk.cu", {
    "wkv6_chunked_launch": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "wkv6_chunked_occupancy": [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)],
})


def wkv6_step(r, k, v, lw, u, state):
    """One-token recurrence. r,k,v,lw (B,H,K); state (B,H,K,V)."""
    y = torch.einsum("bhk,bhkv->bhv", r, state) + \
        (r * u * k).sum(-1, keepdim=True) * v
    state = torch.exp(lw)[..., None] * state + \
        torch.einsum("bhk,bhv->bhkv", k, v)
    return y, state


def wkv6_chunked_plain(r, k, v, lw, u, state0):
    """Chunked WKV6 in plain PyTorch. r, k, v, lw (B,S,H,K) f32; u (H,K);
    state0 (B,H,K,K). Returns y (B,S,H,K) f32 and the final state.

    The reference model's arithmetic chunk for chunk, at ``CHUNK``; a
    ragged tail is zero-padded (lw = 0: no decay), which is exact."""
    B, S, H, K = r.shape
    chunk = CHUNK
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))

    def split(a):                                   # -> (n, B, H, C, K)
        return a.reshape(B, n, chunk, H, K).permute(1, 0, 3, 2, 4)

    rs, ks, vs, lws = (split(a) for a in (r, k, v, lw))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)     # s < t
    neg_inf = torch.tensor(float("-inf"), device=r.device)
    state = state0
    ys = []
    for c in range(n):
        rc, kc, vc, lwc = rs[c], ks[c], vs[c], lws[c]   # (B,H,C,K)
        cum = torch.cumsum(lwc, dim=2)                  # inclusive
        cum_prev = cum - lwc                            # through t-1
        # inter-chunk: y_t += (r_t * exp(cum_{t-1})) . S0
        y = torch.einsum("bhtk,bhkv->bhtv", rc * torch.exp(cum_prev), state)
        # intra-chunk: A[t,s] = sum_k r_t k_s exp(cum_{t-1} - cum_s), s < t
        diff = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]
        diff = torch.where(tri[None, None, :, :, None], diff, neg_inf)
        A = (rc[:, :, :, None, :] * kc[:, :, None, :, :]
             * torch.exp(diff)).sum(-1)                 # (B,H,C,C)
        # current-token bonus
        Ad = (rc * u[None, :, None, :] * kc).sum(-1)    # (B,H,C)
        y = y + torch.einsum("bhts,bhsv->bhtv", A, vc) + Ad[..., None] * vc
        # state carry: S' = exp(cum_C) S0 + sum_s exp(cum_C - cum_s) k_s v_s^T
        k_dec = kc * torch.exp(cum[:, :, -1:, :] - cum)
        state = torch.exp(cum[:, :, -1, :])[..., None] * state + \
            torch.einsum("bhsk,bhsv->bhkv", k_dec, vc)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, K)
    return y[:, :S], state


def wkv6_chunked_cuda(r, k, v, lw, u, state0):
    """The CUDA kernels on CUDA tensors; same contract as the plain version.

    r, k, v, lw (B, S, H, K), u (H, K) and state0 (B, H, K, K): float32,
    contiguous, all on one CUDA device; K in ``CUDA_HEAD_DIMS``; r, k, v
    and lw 16-byte aligned (they are read 16 bytes at a time); lw <= 0
    (the model's ``_decay`` gives ``-exp(...)``). Raises on anything else
    and never copies: a strided, misaligned or bf16 input is refused, not
    converted.
    ``launches`` counts the calls that launched the kernels (the pre-pass
    and the scan: one count for both)."""
    if r.dim() != 4:
        raise ValueError("wkv6_chunked_cuda: r must be (B, S, H, K), got "
                         f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6_chunked_cuda: {name} has shape "
                             f"{tuple(t.shape)}, r {tuple(r.shape)}")
    if u.shape != (H, K):
        raise ValueError(f"wkv6_chunked_cuda: u must be ({H}, {K}), got "
                         f"{tuple(u.shape)}")
    if state0.shape != (B, H, K, K):
        raise ValueError(f"wkv6_chunked_cuda: state0 must be "
                         f"({B}, {H}, {K}, {K}), got {tuple(state0.shape)}")
    if K not in CUDA_HEAD_DIMS:
        raise ValueError(f"wkv6_chunked_cuda: head size {K} not in "
                         f"{CUDA_HEAD_DIMS}")
    args = (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u),
            ("state0", state0))
    for name, t in args:
        if t.dtype != torch.float32:
            raise ValueError(f"wkv6_chunked_cuda: {name} must be float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6_chunked_cuda: {name} must be "
                             "contiguous")
    for name, t in args:
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"wkv6_chunked_cuda: {name} must be on the "
                             f"CUDA device of r, got {t.device}")
    for name, t in args[:4]:
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6_chunked_cuda: {name} must be 16-byte "
                             "aligned")
    y = torch.empty_like(r)
    state = torch.empty_like(state0)
    if B == 0 or H == 0:
        return y, state
    nch = -(-S // CUDA_CHUNK)
    rdec, kdec = torch.empty_like(r), torch.empty_like(k)
    wlast = torch.empty((B, H, nch, K), dtype=torch.float32, device=r.device)
    scores = torch.empty((B, H, nch, CUDA_CHUNK, CUDA_CHUNK),
                         dtype=torch.float32, device=r.device)
    lib = _LIB.get()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_chunked_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), rdec.data_ptr(),
            kdec.data_ptr(), wlast.data_ptr(), scores.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, K, stream)
    _LIB.check(err, "wkv6_chunked launch")
    wkv6_chunked_cuda.launches += 1
    return y, state


wkv6_chunked_cuda.launches = 0


def scan_occupancy(K, device=None):
    """How the scan kernel for head size K sits on a CUDA device: (blocks
    per SM, V slices per head), from the CUDA occupancy calculator."""
    if K not in CUDA_SLICES:
        raise ValueError(f"scan_occupancy: head size {K} not in "
                         f"{CUDA_HEAD_DIMS}")
    lib = _LIB.get()
    blocks, slices = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.wkv6_chunked_occupancy(K, ctypes.byref(blocks),
                                         ctypes.byref(slices))
    _LIB.check(err, "wkv6_chunked occupancy")
    return blocks.value, slices.value
