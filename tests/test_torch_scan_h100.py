"""The scan kernels K5 (``wkv6_chunked_cuda``) and K6 (``ssd_chunked_cuda``)
on an H100, against their plain versions, within 5e-4.

This file imports no JAX, so that it also runs on a CUDA machine that has
none:

    PYTHONPATH=src pytest --noconftest -m h100 tests/test_torch_scan_h100.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package). Without
an sm_90 GPU every test here skips with its reason. The CPU tests of the
same kernels' arithmetic, against the Pallas kernels and the oracles, are
in ``test_torch_wkv6.py`` and ``test_torch_ssd.py``; the inputs here are
drawn from the same distributions as theirs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_chunk as wk
from repro_torch.kernels import ssd_chunk as sk

TOL = 5e-4


def _needs_h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")


def _wkv6_inputs(B, S, H, K, seed, state=False, lw=None):
    """r, k, v normal; lw = -exp(N - 2) or the constant ``lw``; u = 0.3 N;
    a zero or normal initial state (test_torch_wkv6's distribution), on
    the card."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)) for _ in range(3))
    lwv = -np.exp(rng.standard_normal((B, S, H, K)) - 2.0) if lw is None \
        else np.full((B, S, H, K), lw)
    u = 0.3 * rng.standard_normal((H, K))
    s0 = rng.standard_normal((B, H, K, K)) if state else \
        np.zeros((B, H, K, K))
    return [torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (r, k, v, lwv, u, s0)]


def _ssd_inputs(B, S, H, P, N, seed, state=False, decay=None):
    """x, Bm, Cm normal; dt = softplus(N); la = -exp(N - 1) dt or ``decay
    dt``; a zero or normal initial state (test_torch_ssd's distribution),
    on the card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    la = -np.exp(rng.standard_normal((B, S, H)) - 1.0) * dt \
        if decay is None else decay * dt
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, H, N, P)) if state else \
        np.zeros((B, H, N, P))
    return [torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (x, dt, la, Bm, Cm, h0)]


def _check(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= TOL


@pytest.mark.h100
@pytest.mark.parametrize("B,S,H,K,state,lw", [
    (2, 64, 2, 16, False, None), (1, 128, 4, 32, False, None),
    (2, 96, 3, 8, False, None), (1, 32, 2, 8, True, None),
    (1, 64, 1, 8, False, -20.0), (3, 40, 2, 64, True, None),
    (1, 1, 2, 32, True, None),
] + [(1, S, 1, K, True, None) for K in wk.CUDA_HEAD_DIMS
     for S in (15, 16, 17, 32, 33)] + [
    (4, 5, 32, 64, True, None), (4, 100, 32, 64, True, -20.0),
    (1, 2050, wk.WGMMA_MIN_BLOCKS, 64, True, None),
    (4, 256, 32, 64, True, None),
    (1, 100, wk.WGMMA_MIN_BLOCKS - 1, 64, True, None),
    (2, 100, 32, 64, True, None), (3, 100, 32, 64, True, None),
])
def test_wkv6_cuda_kernel_matches_plain_on_h100(B, S, H, K, state, lw):
    """K5 against its plain version: the reference test's shapes, a
    nonzero state, lw = -20, ragged sequences, and every head size the
    kernels take with S at and next to the chunk boundaries on a grid of
    one head (B = H = 1); at K = 64 on wkv6_wgmma_kernel's grid (B H >=
    ``WGMMA_MIN_BLOCKS``) also S below one chunk, strong decay, many
    chunks with a ragged tail and the engine's head count, and one block
    fewer (the mma.sync kernels); at RWKV6's H = 32 with two and three
    batch rows, each side of the measured crossover."""
    _needs_h100()
    args = _wkv6_inputs(B, S, H, K, seed=8, state=state, lw=lw)
    _check(wk.wkv6_chunked_cuda(*args), wk.wkv6_chunked_plain(*args))


@pytest.mark.h100
def test_ops_wkv6_launches_the_kernel_on_h100():
    _needs_h100()
    args = _wkv6_inputs(2, 40, 2, 16, seed=9, state=True)
    before = wk.wkv6_chunked_cuda.launches
    y, _ = ops.wkv6(*args)
    assert y.is_cuda and wk.wkv6_chunked_cuda.launches == before + 1


@pytest.mark.h100
@pytest.mark.parametrize("B,S,H,P,N,state,decay", [
    (2, 64, 2, 16, 8, False, None), (1, 128, 4, 32, 16, False, None),
    (2, 100, 3, 16, 8, True, None), (1, 130, 2, 16, 8, True, -20.0),
    (2, 1000, 4, 64, 64, False, None), (1, 1, 2, 32, 16, True, None),
    (2, 65, 8, 64, 64, True, None),
] + [(1, S, 1, P, N, True, None) for P, N in sk.CUDA_SHAPES
     for S in (63, 64, 65, 128, 129)] + [
    (1, 5, 3, 64, 64, True, None), (2, 31, 2, 64, 64, True, None),
    (2, 33, 2, 64, 64, True, None), (1, 200, 4, 64, 64, True, -20.0),
    (1, 4100, 2, 64, 64, True, None),
])
def test_ssd_cuda_kernel_matches_plain_on_h100(B, S, H, P, N, state, decay):
    """K6 against its plain version: the reference test's shapes, a
    nonzero state, strong decay, ragged sequences, and every (P, N) the
    kernels take with S at and next to the chunk boundaries on a grid of
    one head (B = H = 1); at (64, 64) also S below one 32-token step, S
    off the 64-token chunk across many chunks."""
    _needs_h100()
    args = _ssd_inputs(B, S, H, P, N, seed=11, state=state, decay=decay)
    _check(sk.ssd_chunked_cuda(*args), sk.ssd_chunked_plain(*args))


@pytest.mark.h100
@pytest.mark.parametrize("B,S,H,state", [(1, 4096, 128, False),
                                         (1, 1000, 128, True),
                                         (2, 100, 4, True)])
def test_ssd_cuda_kernel_at_granite_state_matches_plain_on_h100(B, S, H,
                                                                 state):
    """K6 at Granite-4.0-H's (P, N) = (64, 128), the mma.sync scan in
    slices of 32 columns: its heads at the routed loop's prefix lengths
    (S a whole number of chunks, and ragged with a nonzero state), and a
    small grid; within 1e-5 of the output's scale (|y| reaches several
    hundred at N = 128, beyond the absolute 5e-4 of the other shapes)."""
    _needs_h100()
    args = _ssd_inputs(B, S, H, 64, 128, seed=13, state=state)
    got = sk.ssd_chunked_cuda(*args)
    want = sk.ssd_chunked_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.h100
def test_ops_ssd_launches_the_kernel_on_h100():
    _needs_h100()
    args = _ssd_inputs(2, 100, 2, 16, 8, seed=12, state=True)
    before = sk.ssd_chunked_cuda.launches
    y, _ = ops.ssd(*args)
    assert y.is_cuda and sk.ssd_chunked_cuda.launches == before + 1
