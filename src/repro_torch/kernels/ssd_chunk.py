"""Chunked Mamba2 SSD scan — kernel K6.

Port of ``repro.kernels.ssd_chunk.ssd_chunked`` (the Pallas TPU kernel):
x (B, S, H, P) f32; dt and the log-decay ``la <= 0`` (B, S, H) f32; Bm, Cm
(B, S, N) f32, shared by all heads (n_groups = 1); h0 (B, H, N, P) -> y
(B, S, H, P) f32 and the final state (B, H, N, P). Per head, with state h
(N rows, P columns),

    h_t = exp(la_t) h_{t-1} + dt_t B_t x_t^T
    y_t = h_t^T C_t

computed chunk by chunk with ``cum`` the inclusive prefix sum of la and
every decay taken as ``exp(non-positive log-cumsum difference)``, so
nothing overflows at any decay strength:

    intra : y += M @ (dt * x),  M[t,s] = (C_t . B_s) exp(cum_t - cum_s), s <= t
    inter : y += (C * exp(cum)) @ h
    state : h <- exp(cum_C) h + (B * exp(cum_C - cum))^T (dt * x)

Three versions of the recurrence live here:

* ``ssd_step`` — one token (the model's decode step, and token by token
  the oracle ``ref.ssd_ref``); the reference has no decode kernel.
* ``ssd_chunked_plain`` — plain PyTorch on any device, chunks of
  ``CHUNK = 64`` tokens as the reference model's jnp form
  (``repro.models.mamba2.ssd_chunked``). It is the port's one chunked
  implementation: ``models/mamba2.ssd_chunked`` is this function.
* ``ssd_chunked_cuda`` — the hand-written CUDA kernels
  (``csrc/ssd_chunk.cu``), two launches per call, chosen by shape
  (``scan_kernel``). At Zamba2's (P, N) = (64, 64) a pre-pass writes
  G = C . B^T of each step's diagonal 32 x 32 block once per batch row
  (shared by the heads) into a scratch array the wrapper allocates, then
  ``ssd_wgmma_kernel`` runs one block per (head, batch row) over steps of
  ``WGMMA_STEP = 32`` tokens: a producer keeps TMA loads of x, B and C in
  flight, two warpgroups do the even and the odd steps' state-independent
  work (the prefix sums of la over the plain version's 64-token chunk, M,
  B' and C', the intra-step product and the step's local state, on
  ``wgmma``), and a warpgroup carries the state in registers through the
  chain (one ``wgmma`` product and an elementwise update per step). At the
  reference kernel test's (16, 8) and (32, 16) and at Granite-4.0-H's
  (64, 128) the mma.sync kernels: a fully parallel pre-pass writes G =
  C . B^T once per (batch row, chunk of 64) and each chunk's prefix sums
  and factors into scratch arrays the wrapper allocates, and a scan
  carries the state in shared memory through the chunks on ``mma.sync``,
  one block per (column slice, head, batch row): all P columns at (16, 8)
  and (32, 16), slices of ``SCAN_COLUMNS`` = 32 at (64, 128), where a block
  of all 64 would need more shared memory than a block may have. Every
  product is a split 3xTF32 product (f32 accuracy, not single-pass TF32).

Both chunked versions take any S. The reference asserts ``S % chunk == 0``
(its model at ``chunk = min(64, S)``), so it cannot prefill a 100-token
prompt; here the tail is padded (plain) or masked (kernel) with x = dt =
la = 0 and B = C = 0, which leaves the state unchanged and adds nothing to
any real token's y: the padded y is dropped. ``kernels.ops.ssd`` picks
between the chunked versions by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaLibrary

#: tokens per chunk of the plain version and of the CUDA kernels (the
#: reference model's CHUNK)
CHUNK = 64
#: the (head size P, state size N) pairs the CUDA kernels are instantiated
#: for: Zamba2's, the reference kernel test's two and Granite-4.0-H's
CUDA_SHAPES = ((16, 8), (32, 16), (64, 64), (64, 128))
#: the pairs ``ssd_wgmma_kernel`` serves; the others run the mma.sync pre-pass
#: and scan
WGMMA_SHAPES = ((64, 64),)
#: tokens per step of ``ssd_wgmma_kernel``
WGMMA_STEP = 32
#: the columns a block of the mma.sync scan carries, where not all P
#: (``csrc/ssd_chunk.cu``'s REPRO_SSD_SHAPES)
SCAN_COLUMNS = {(64, 128): 32}

_LIB = CudaLibrary("ssd_chunk.cu", {
    "ssd_chunked_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "ssd_chunked_occupancy": [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)],
    "ssd_chunked_smem": [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_int)],
})


def scan_kernel(P, N):
    """The profiler names of the kernels a call at (P, N) launches, the
    pre-pass first: ``ssd_gram_kernel`` and ``ssd_wgmma_kernel`` at the
    pairs of ``WGMMA_SHAPES``, the mma.sync pre-pass and scan at the other
    pairs of ``CUDA_SHAPES``."""
    if (P, N) not in CUDA_SHAPES:
        raise ValueError(f"scan_kernel: {(P, N)} not in {CUDA_SHAPES}")
    if (P, N) in WGMMA_SHAPES:
        return ("ssd_gram_kernel", "ssd_wgmma_kernel")
    return ("ssd_prep_kernel", "ssd_scan_kernel")


def scan_plan(B, S, H, P, N):
    """Where a call's work goes: the scan kernel's name, its grid and, for
    each block, the (head, batch row, tokens, columns) it carries.
    ``ssd_wgmma_kernel``: one block per (head, batch row), all P columns,
    every token in steps of ``WGMMA_STEP``; the mma.sync scan: one block per
    (column slice, head, batch row), each slice ``SCAN_COLUMNS`` columns
    (all P where the pair is not listed), in chunks of ``CHUNK``."""
    kernel = scan_kernel(P, N)[-1]
    wgmma = (P, N) in WGMMA_SHAPES
    step = WGMMA_STEP if wgmma else CHUNK
    ps = P if wgmma else SCAN_COLUMNS.get((P, N), P)
    grid = (H, B) if wgmma else (P // ps, H, B)
    blocks = [{"head": h, "batch": b, "tokens": range(S),
               "columns": range(p0, p0 + ps), "steps": -(-S // step)}
              for b in range(B) for h in range(H)
              for p0 in range(0, P, ps)]
    return {"kernel": kernel, "grid": grid, "step": step, "blocks": blocks}


def ssd_step(x, dt, la, Bm, Cm, h):
    """One token. x (B,H,P); dt, la (B,H); Bm, Cm (B,N); h (B,H,N,P)."""
    a = torch.exp(la)[..., None, None]
    h = a * h + torch.einsum("bn,bhp,bh->bhnp", Bm, x, dt)
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    return y, h


def ssd_chunked_plain(x, dt, la, Bm, Cm, h0):
    """Chunked SSD in plain PyTorch. x (B,S,H,P) f32; dt, la (B,S,H);
    Bm, Cm (B,S,N); h0 (B,H,N,P). Returns y (B,S,H,P) f32 and the final
    state.

    The reference model's arithmetic chunk for chunk, at ``CHUNK``; a
    ragged tail is zero-padded (la = 0: no decay; dt = B = C = 0: no
    input), which is exact. The upper triangle of the decay matrix gets
    exponent -inf, so no positive exponent is ever taken."""
    Bz, S, H, P = x.shape
    chunk = CHUNK
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, la, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (dt, la, Bm, Cm))

    def split(a):                                   # -> (n, B, C, ...)
        return a.reshape(Bz, n, chunk, *a.shape[2:]).transpose(0, 1)

    xs, dts, las, Bs, Cs = (split(a) for a in (x, dt, la, Bm, Cm))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()       # s <= t
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    h = h0
    ys = []
    for c in range(n):
        xc, dtc, lac, Bc, Cc = xs[c], dts[c], las[c], Bs[c], Cs[c]
        cum = torch.cumsum(lac, dim=1)                      # (B,C,H)
        # decay matrix L[t,s] = exp(cum_t - cum_s) for s <= t
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (B,C,C,H)
        L = torch.exp(torch.where(tri[None, :, :, None], diff, neg_inf))
        G = torch.einsum("btn,bsn->bts", Cc, Bc)            # (B,C,C)
        M = G[..., None] * L                                # (B,C,C,H)
        dx = xc * dtc[..., None]                            # (B,C,H,P)
        y = torch.einsum("btsh,bshp->bthp", M, dx)
        # inter-chunk: y_t += C_t . (exp(cum_t) * h)
        dec = torch.exp(cum)                                # (B,C,H)
        y = y + torch.einsum("btn,bhnp,bth->bthp", Cc, h, dec)
        # state: h' = exp(cum_last) h + sum_s exp(cum_last - cum_s) B_s dx_s
        rdec = torch.exp(cum[:, -1:, :] - cum)              # (B,C,H)
        h = dec[:, -1][:, :, None, None] * h + \
            torch.einsum("bsn,bshp,bsh->bhnp", Bc, dx, rdec)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bz, n * chunk, H, P)
    return y[:, :S], h


def ssd_chunked_cuda(x, dt, la, Bm, Cm, h0):
    """The CUDA kernels on CUDA tensors; same contract as the plain version.

    x (B, S, H, P), dt and la (B, S, H), Bm and Cm (B, S, N) and h0
    (B, H, N, P): float32, contiguous, all on one CUDA device; (P, N) in
    ``CUDA_SHAPES``; x, Bm and Cm 16-byte aligned (they are loaded by TMA,
    or by 16-byte ``cp.async``); la <= 0 (the model's
    ``-exp(A_log) * softplus(...)``). Raises on anything else and never
    copies: a strided, misaligned or bf16 input is refused, not converted.
    ``launches`` counts the calls that launched the kernels (one count
    for the mma.sync pre-pass and scan together)."""
    if x.dim() != 4:
        raise ValueError("ssd_chunked_cuda: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S):
        raise ValueError(f"ssd_chunked_cuda: Bm must be ({B}, {S}, N), got "
                         f"{tuple(Bm.shape)}")
    N = Bm.shape[2]
    for name, t, want in (("dt", dt, (B, S, H)), ("la", la, (B, S, H)),
                          ("Cm", Cm, (B, S, N)), ("h0", h0, (B, H, N, P))):
        if t.shape != want:
            raise ValueError(f"ssd_chunked_cuda: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
    if (P, N) not in CUDA_SHAPES:
        raise ValueError(f"ssd_chunked_cuda: (head size, state size) "
                         f"{(P, N)} not in {CUDA_SHAPES}")
    args = (("x", x), ("dt", dt), ("la", la), ("Bm", Bm), ("Cm", Cm),
            ("h0", h0))
    for name, t in args:
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_chunked_cuda: {name} must be float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunked_cuda: {name} must be contiguous")
    for name, t in args:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_chunked_cuda: {name} must be on the CUDA "
                             f"device of x, got {t.device}")
        if name in ("x", "Bm", "Cm") and t.data_ptr() % 16:
            raise ValueError(f"ssd_chunked_cuda: {name} must be 16-byte "
                             "aligned")
    y = torch.empty_like(x)
    hout = torch.empty_like(h0)
    if B == 0 or H == 0:
        return y, hout
    # the pre-passes' scratch: G = C . B^T per batch row and step (the
    # diagonal 32 x 32 blocks for ssd_wgmma_kernel, 64 x 64 for the
    # mma.sync scan, with its per-token factors aux)
    aux_ptr = None
    if (P, N) in WGMMA_SHAPES:
        step = WGMMA_STEP
    else:
        step = CHUNK
        aux = torch.empty((4, B, H, -(-S // CHUNK), CHUNK),
                          dtype=torch.float32, device=x.device)
        aux_ptr = aux.data_ptr()
    gram = torch.empty((B, -(-S // step), step, step), dtype=torch.float32,
                       device=x.device)
    lib = _LIB.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunked_launch(
            x.data_ptr(), dt.data_ptr(), la.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), h0.data_ptr(), gram.data_ptr(), aux_ptr,
            y.data_ptr(), hout.data_ptr(), B, S, H, P, N, stream)
    _LIB.check(err, "ssd_chunked launch")
    ssd_chunked_cuda.launches += 1
    return y, hout


ssd_chunked_cuda.launches = 0


def scan_occupancy(P, N, device=None):
    """How the scan kernel for (P, N) sits on a CUDA device: (blocks per
    SM, column slices per head), from the CUDA occupancy calculator."""
    if (P, N) not in CUDA_SHAPES:
        raise ValueError(f"scan_occupancy: {(P, N)} not in {CUDA_SHAPES}")
    lib = _LIB.get()
    blocks, slices = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.ssd_chunked_occupancy(P, N, ctypes.byref(blocks),
                                        ctypes.byref(slices))
    _LIB.check(err, "ssd_chunked occupancy")
    return blocks.value, slices.value


def scan_smem(P, N):
    """The scan kernel for (P, N): (dynamic shared memory per block in
    bytes, threads per block)."""
    if (P, N) not in CUDA_SHAPES:
        raise ValueError(f"scan_smem: {(P, N)} not in {CUDA_SHAPES}")
    lib = _LIB.get()
    nbytes, threads = ctypes.c_int(0), ctypes.c_int(0)
    _LIB.check(lib.ssd_chunked_smem(P, N, ctypes.byref(nbytes),
                                    ctypes.byref(threads)),
               "ssd_chunked smem")
    return nbytes.value, threads.value
