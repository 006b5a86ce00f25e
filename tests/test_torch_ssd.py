"""The chunked Mamba2 SSD scan (kernel K6): the port against the JAX
reference.

The same inputs, made with numpy from a seed, go to both sides.

* ``ssd_chunked_plain`` (what ``ops.ssd`` runs on CPU tensors) is held
  against the reference's Pallas ``ssd_chunked`` (interpret mode) and its
  ``ssd_ref`` token oracle at the two shapes of ``tests/test_kernels.py``,
  on that test's input distribution (normal x, B, C; dt = softplus(N);
  la = -exp(N - 1) * dt), within the reference's 5e-4 absolute (outputs
  here are O(1-10); the scan's sums run in another order).
* Against the reference model's jnp chunked form
  (``repro.models.mamba2.ssd_chunked``) at its chunk of 64: within 1e-5 of
  the output's largest magnitude — the same chunking and f32 arithmetic,
  summed in another order.
* At ragged lengths (S = 1, 8, 65, 100, 1000: 65, 100 and 1000 are no
  multiple of the reference's chunk, which its chunked forms cannot take)
  against the reference oracle, within 5e-4; with a nonzero initial state;
  and under strong decay (la = -20 dt), which stays finite.
* The port's ``ref.ssd_ref`` and ``ssd_step`` against the reference's,
  within 1e-5.

The CUDA kernels run only on an H100 (the ``h100`` tests of
``test_torch_scan_h100.py``, which imports no JAX so that it runs on a
card's machine; skipped elsewhere); ``chip_smoke.py`` runs the same checks
at the engine's shapes.
Their wrapper's refusals are checked here: they happen before any launch.

The CUDA kernels take another order of work than the plain version, and
two kernels serve the shapes. At Zamba2's (P, N) = (64, 64),
``ssd_wgmma_kernel`` takes steps of 32 tokens; its prefix sums of la run
left to right over the plain version's 64-token chunk, and each step
factors its decays through the step's start (C' = C exp(cum_t - c0), B'
= B exp(c1 - cum_s) dt, e = exp(c1 - c0), every exponent <= 0); it
computes y^T = h^T C'^T + x^T M^T and h^T <- e h^T + x^T B' with h^T and
x^T as the products' register operands. At (16, 8) and (32, 16) the
mma.sync kernels run: a pre-pass computes G = C . B^T once per (batch
row, chunk of 64), shared by every head, and the chunk's prefix sums of
la left to right; the scan carries each slice of the state's columns
apart. Every product of both runs on the tensor cores as a split 3xTF32
product (x = hi + lo, hi rounded to TF32, lo = x - hi read as TF32; a b
~ a_lo b_hi + a_hi b_lo + a_hi b_hi). Test-local emulations of both
orders (``_kernel_emulation`` picks the one the wrapper launches) are
held against the Pallas kernel, ``ssd_ref`` and the reference model's
chunked form at the tolerances above, at ragged S next to the 32-token
step and the 64-token chunk, with a nonzero initial state, under strong
decay and, for the mma.sync kernels' order, with the columns cut into
slices. ``scan_plan``, the wrapper's account of which block carries
what, is checked to cover every (token, head, batch row, column) exactly
once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunked as jssd_pallas
from repro.models import mamba2 as jm2
from repro_torch.kernels import ops, ref as tref, ssd_chunk as tk

from _tf32 import as_tf32, mm3, round_tf32

torch.set_num_threads(1)

TOL = 5e-4

#: (B, S, H, P, N, Pallas chunk) of tests/test_kernels.py::test_ssd_chunked
SHAPES = [(2, 64, 2, 16, 8, 16), (1, 128, 4, 32, 16, 32)]
NAMES = ("x", "dt", "la", "Bm", "Cm", "h0")


def _inputs(B, S, H, P, N, seed=0, state=False, decay=None):
    """The reference test's distribution: normal x, Bm, Cm; dt =
    softplus(N); la = -exp(N - 1) * dt, or ``decay * dt`` when given; a
    zero or normal initial state. Returns (numpy tuple, torch tuple)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    if decay is None:
        la = -np.exp(rng.standard_normal((B, S, H)) - 1.0) * dt
    else:
        la = decay * dt
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, H, N, P)) if state else \
        np.zeros((B, H, N, P))
    arrs = tuple(a.astype(np.float32) for a in (x, dt, la, Bm, Cm, h0))
    return arrs, tuple(torch.from_numpy(a.copy()) for a in arrs)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_plain_matches_pallas_and_oracle(B, S, H, P, N, chunk):
    arrs, tx = _inputs(B, S, H, P, N)
    y, h = tk.ssd_chunked_plain(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ph = jssd_pallas(*jx, chunk=chunk, interpret=True)
    ry, rh = jref.ssd_ref(*jx)
    for got, want in ((y, py), (h, ph), (y, ry), (h, rh)):
        _close(got, want, TOL)


@pytest.mark.parametrize("B,S,H,P,N", [(2, 64, 2, 16, 8), (1, 128, 4, 32, 16),
                                       (2, 192, 3, 16, 32)])
def test_plain_matches_reference_model_chunked(B, S, H, P, N):
    """The port's one chunked form against the reference model's jnp form
    at its chunk of 64: the same arithmetic, within 1e-5 of scale."""
    arrs, tx = _inputs(B, S, H, P, N, seed=3, state=True)
    y, h = tk.ssd_chunked_plain(*tx)
    jy, jh = jm2.ssd_chunked(*[jnp.asarray(a) for a in arrs],
                             chunk=min(64, S))
    for got, want in ((y, jy), (h, jh)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("S", [1, 8, 65, 100, 1000])
def test_plain_ragged_length_matches_oracle(S):
    """Any S: the zero-padded tail leaves the state and the real tokens'
    y unchanged (the reference's chunked forms assert S % chunk == 0)."""
    arrs, tx = _inputs(2, S, 2, 16, 8, seed=4)
    y, h = tk.ssd_chunked_plain(*tx)
    assert y.shape == (2, S, 2, 16)
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(h, rh, TOL)


def test_plain_nonzero_initial_state():
    arrs, tx = _inputs(2, 64, 3, 16, 8, seed=5, state=True)
    y, h = tk.ssd_chunked_plain(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ph = jssd_pallas(*jx, chunk=32, interpret=True)
    ry, rh = jref.ssd_ref(*jx)
    for got, want in ((y, py), (h, ph), (y, ry), (h, rh)):
        _close(got, want, TOL)


def test_plain_strong_decay_stays_finite():
    """la = -20 dt (a = e^-20 per unit of dt): every exponent the plain
    version takes is <= 0, so the output is finite and equals the
    oracle."""
    arrs, tx = _inputs(1, 130, 2, 16, 8, seed=6, state=True, decay=-20.0)
    y, h = tk.ssd_chunked_plain(*tx)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(h, rh, TOL)


@pytest.mark.parametrize("S", [0, 5, 70])
def test_torch_oracle_matches_reference_oracle(S):
    arrs, tx = _inputs(2, S, 3, 16, 8, seed=7, state=True)
    y, h = tref.ssd_ref(*tx)
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    assert y.shape == (2, S, 3, 16)
    _close(y, ry, 1e-5)
    _close(h, rh, 1e-5)


def test_ssd_step_matches_reference():
    arrs, tx = _inputs(3, 1, 4, 16, 8, seed=8, state=True)
    step = [a[:, 0] for a in arrs[:5]] + [arrs[5]]
    y, h = tk.ssd_step(*[t[:, 0] for t in tx[:5]], tx[5])
    jy, jh = jm2.ssd_step(*[jnp.asarray(a) for a in step])
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)


def test_ops_ssd_on_cpu_is_the_plain_version():
    _, tx = _inputs(2, 100, 2, 16, 8, seed=9, state=True)
    y, h = ops.ssd(*tx)
    py, ph = tk.ssd_chunked_plain(*tx)
    assert torch.equal(y, py) and torch.equal(h, ph)
    assert tk.ssd_chunked_cuda.launches == 0


def test_ssd_registered_for_launch_counts():
    assert ops.CUDA_KERNELS["ssd_chunked"] is tk.ssd_chunked_cuda
    assert ops.launch_counts()["ssd_chunked"] == tk.ssd_chunked_cuda.launches


def _args(**shape):
    _, tx = _inputs(**{**dict(B=1, S=8, H=2, P=16, N=8, seed=10), **shape})
    return dict(zip(NAMES, tx))


@pytest.mark.parametrize("what,change,match", [
    ("bf16 x", lambda a: {"x": a["x"].bfloat16()}, "float32"),
    ("f64 h0", lambda a: {"h0": a["h0"].double()}, "float32"),
    ("strided x", lambda a: {"x": a["x"].transpose(1, 2).contiguous()
                             .transpose(1, 2)}, "contiguous"),
    ("strided Bm", lambda a: {"Bm": torch.cat([a["Bm"], a["Cm"]], -1)
                              [..., :8]}, "contiguous"),
    ("dt shape", lambda a: {"dt": a["dt"][:, :4]}, "dt must be"),
    ("Cm shape", lambda a: {"Cm": a["Cm"][..., :4]}, "Cm must be"),
    ("h0 shape", lambda a: {"h0": a["h0"][:, :1]}, "h0 must be"),
    ("Bm rank", lambda a: {"Bm": a["Bm"][0]}, "Bm must be"),
    ("head size", lambda a: _args(P=12), "head size"),
    ("state size", lambda a: _args(N=12), "state size"),
    ("uninstantiated pair", lambda a: _args(P=64, N=8), "not in"),
    ("cpu tensors", lambda a: {}, "CUDA device"),
])
def test_cuda_wrapper_refuses_without_copying(what, change, match):
    """The wrapper checks shapes, sizes, dtype, contiguity and device
    before any launch, and raises rather than converting."""
    args = _args()
    args.update(change(args))
    with pytest.raises(ValueError, match=match):
        tk.ssd_chunked_cuda(**args)
    assert tk.ssd_chunked_cuda.launches == 0


def _left_to_right_cumsum(a, dim):
    """Inclusive prefix sums along ``dim`` added one value at a time, in
    f32: the sums a sequential scan takes."""
    a = a.movedim(dim, 0)
    out = torch.empty_like(a)
    c = torch.zeros_like(a[0])
    for t in range(a.shape[0]):
        c = c + a[t]
        out[t] = c
    return out.movedim(0, dim)


def _mma_sync_emulation(x, dt, la, Bm, Cm, h0, ps=None):
    """The mma.sync kernels' K6 order of work (its kernels serve (16, 8) and
    (32, 16)) in torch (f32): G = C . B^T per (batch row, chunk of 64),
    shared by all heads; cum left to right per chunk; M = G * exp(cum_t -
    cum_s) * dt_s (s <= t) and B' = B * exp(cum_last - cum_s) * dt_s; the
    state's columns in slices of ``ps`` (default: all P, as the CUDA kernel
    takes them), each carried through the chunks apart, y = exp(cum) (C . h)
    + M . x and h <- exp(cum_last) h + B'^T . x with 3xTF32 products."""
    Bz, S, H, P = x.shape
    N = Bm.shape[2]
    ps = ps or P
    C = tk.CHUNK
    n = -(-S // C)
    pad = n * C - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt, la, Bm, Cm = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                          for a in (dt, la, Bm, Cm))
    xs = x.reshape(Bz, n, C, H, P).permute(0, 1, 3, 2, 4)     # (B,n,H,C,P)
    dts, las = (a.reshape(Bz, n, C, H).permute(0, 1, 3, 2)   # (B,n,H,C)
                for a in (dt, la))
    Bs, Cs = (a.reshape(Bz, n, C, N) for a in (Bm, Cm))       # (B,n,C,N)
    G = torch.einsum("bctn,bcsn->bcts", Cs, Bs).tril()
    cum = _left_to_right_cumsum(las, -1)
    tri = torch.ones((C, C), dtype=torch.bool).tril()
    ys, hs = [], []
    for p0 in range(0, P, ps):
        h = h0[..., p0:p0 + ps].clone()
        yc = []
        for c in range(n):
            cc, xc = cum[:, c], xs[:, c, ..., p0:p0 + ps]
            diff = cc[..., :, None] - cc[..., None, :]
            L = torch.exp(torch.where(tri, diff, torch.tensor(float("-inf"))))
            M = G[:, c, None] * L * dts[:, c, :, None, :]      # (B,H,t,s)
            Bw = Bs[:, c, None] * (torch.exp(cc[..., -1:] - cc)
                                   * dts[:, c])[..., None]     # (B,H,s,N)
            y = torch.exp(cc)[..., None] * mm3(Cs[:, c, None], h) + \
                mm3(M, xc)
            h = torch.exp(cc[..., -1])[..., None, None] * h + \
                mm3(Bw.transpose(-1, -2), xc)
            yc.append(y)
        ys.append(torch.stack(yc, 1))                          # (B,n,H,C,ps)
        hs.append(h)
    y = torch.cat(ys, -1).permute(0, 1, 3, 2, 4).reshape(Bz, n * C, H, P)
    return y[:, :S], torch.cat(hs, -1)


def _wgmma_emulation(x, dt, la, Bm, Cm, h0):
    """ssd_wgmma_kernel's order of work in torch (f32): steps of 32 tokens;
    the prefix sums of la left to right over each 64-token chunk (the plain
    version's rounding), and per step, with c0 the sum before the step (0
    at a chunk's start) and c1 its last: M = (C . B^T) exp(cum_t - cum_s)
    dt_s (s <= t), B' = B exp(c1 - cum_s) dt_s, C' = C exp(cum_t - c0),
    e = exp(c1 - c0); y^T = h^T C'^T + x^T M^T and h^T <- e h^T + x^T B',
    every product 3xTF32."""
    Bz, S, H, P = x.shape
    T, C = tk.WGMMA_STEP, tk.CHUNK
    n = -(-S // C)
    pad = n * C - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt, la, Bm, Cm = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                          for a in (dt, la, Bm, Cm))
    cum = _left_to_right_cumsum(la.reshape(Bz, n, C, H), 2).reshape(
        Bz, n * C, H)
    tri = torch.ones((T, T), dtype=torch.bool).tril()
    hT = h0.transpose(-1, -2)                                  # (B,H,P,N)
    ys = []
    for c in range(n * C // T):
        sl = slice(c * T, (c + 1) * T)
        cs, dts = cum[:, sl], dt[:, sl]                        # (B,T,H)
        c0 = cum[:, c * T - 1] if c % (C // T) else torch.zeros_like(
            cs[:, 0])
        c1 = cs[:, -1]
        Cc, Bc = Cm[:, sl], Bm[:, sl]                          # (B,T,N)
        G = torch.einsum("btn,bsn->bts", Cc, Bc)
        diff = cs[:, :, None, :] - cs[:, None, :, :]           # (B,t,s,H)
        L = torch.exp(torch.where(tri[..., None], diff,
                                  torch.tensor(float("-inf"))))
        M = (G[..., None] * L * dts[:, None]).permute(0, 3, 1, 2)
        Bp = (Bc[:, :, None, :] * (torch.exp(c1[:, None] - cs)
                                   * dts)[..., None]).permute(0, 2, 1, 3)
        Cp = (Cc[:, :, None, :]
              * torch.exp(cs - c0[:, None])[..., None]).permute(0, 2, 1, 3)
        xT = x[:, sl].permute(0, 2, 3, 1)                      # (B,H,P,s)
        yT = mm3(xT, M.transpose(-1, -2)) + mm3(hT, Cp.transpose(-1, -2))
        hT = torch.exp(c1 - c0)[..., None, None] * hT + mm3(xT, Bp)
        ys.append(yT.permute(0, 3, 1, 2))                      # (B,t,H,P)
    return torch.cat(ys, 1)[:, :S], hT.transpose(-1, -2)


def _kernel_emulation(x, dt, la, Bm, Cm, h0):
    """The order of work of the kernel the wrapper launches at this
    (P, N)."""
    if (x.shape[3], Bm.shape[2]) in tk.WGMMA_SHAPES:
        return _wgmma_emulation(x, dt, la, Bm, Cm, h0)
    return _mma_sync_emulation(x, dt, la, Bm, Cm, h0)


def test_tf32_split_keeps_f32_accuracy():
    """hi + lo (as the tensor core reads lo) is within 2^-21 of x, and a
    3xTF32 product within ~1e-6 of the f64 product, where one TF32 pass
    is off by ~1e-3."""
    rng = np.random.default_rng(20)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    hi = round_tf32(a)
    rec = hi + as_tf32(a - hi)
    assert float(((rec - a).abs() / a.abs()).max()) <= 2.0 ** -21
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    err3 = float((mm3(a, b).double() - exact).abs().max()) / scale
    err1 = float((as_tf32(a) @ as_tf32(b) - exact).abs().max()) / scale
    assert err3 < 2e-6 < 1e-4 < err1


def test_kernel_prefix_is_left_to_right_and_non_increasing():
    """The pre-pass's prefix sums of la (<= 0, with zeros, tiny values and a
    zero-padded tail) are the sequential f32 sums and never increase, so
    every exponent cum_t - cum_s (s <= t), cum_last - cum_s, cum_t is
    <= 0 in floating point."""
    rng = np.random.default_rng(21)
    la = -np.exp(rng.standard_normal((6, 64)) * 4 - 3).astype(np.float32)
    la[1] = 0.0
    la[2, 30:] = 0.0
    la[3] = -1e-30
    la[4, ::2] = -20.0
    cum = _left_to_right_cumsum(torch.from_numpy(la), -1)
    want = np.zeros(6, np.float32)
    for t in range(64):
        want = (want + la[:, t]).astype(np.float32)
        assert np.array_equal(cum[:, t].numpy(), want)
    assert bool((cum[:, 1:] <= cum[:, :-1]).all())


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_kernel_arithmetic_matches_pallas_and_oracle(B, S, H, P, N, chunk):
    """The CUDA kernels' order of work and 3xTF32 products against the
    Pallas kernel and ssd_ref at the reference test's shapes."""
    arrs, tx = _inputs(B, S, H, P, N)
    y, h = _kernel_emulation(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ph = jssd_pallas(*jx, chunk=chunk, interpret=True)
    ry, rh = jref.ssd_ref(*jx)
    for got, want in ((y, py), (h, ph), (y, ry), (h, rh)):
        _close(got, want, TOL)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 100])
def test_kernel_arithmetic_ragged_length(S):
    """Ragged S next to the kernel's 64-token chunk, with a nonzero initial
    state, against the oracle."""
    arrs, tx = _inputs(2, S, 3, 16, 8, seed=22, state=True)
    y, h = _kernel_emulation(*tx)
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(h, rh, TOL)


@pytest.mark.parametrize("P,N,ps", [(16, 8, 8), (32, 16, 16), (64, 64, 64),
                                    (64, 64, 16), (64, 128, 32)])
def test_kernel_arithmetic_column_slices(P, N, ps):
    """The mma.sync kernels' order with the state's columns carried in
    slices apart, then concatenated, gives the reference model's chunked
    form (1e-5 of scale) at every (P, N) the wrapper takes (its kernels
    serve (16, 8), (32, 16) and, in slices of 32 columns, (64, 128)), with
    a nonzero initial state."""
    arrs, tx = _inputs(1, 128, 2, P, N, seed=23, state=True)
    y, h = _mma_sync_emulation(*tx, ps=ps)
    jy, jh = jm2.ssd_chunked(*[jnp.asarray(a) for a in arrs], chunk=64)
    for got, want in ((y, jy), (h, jh)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


def test_kernel_arithmetic_strong_decay_stays_finite():
    """la = -20 dt, a nonzero initial state and a ragged tail: finite, and
    equal to the oracle."""
    arrs, tx = _inputs(1, 130, 2, 16, 8, seed=24, state=True, decay=-20.0)
    y, h = _kernel_emulation(*tx)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(h, rh, TOL)


#: (B, S, H, Pallas chunk) at Zamba2's (P, N) = (64, 64), ssd_wgmma_kernel's
WGMMA_CASES = [(1, 128, 2, 64), (2, 64, 1, 32)]


@pytest.mark.parametrize("B,S,H,chunk", WGMMA_CASES)
def test_wgmma_arithmetic_matches_pallas_and_oracle(B, S, H, chunk):
    """ssd_wgmma_kernel's order of work (32-token steps, decays through
    each step's start, the y^T orientation, 3xTF32) against the Pallas
    kernel and ssd_ref at (P, N) = (64, 64), with a nonzero state, within
    1e-5 of the output's scale (|y| reaches ~100 here at N = 64)."""
    arrs, tx = _inputs(B, S, H, 64, 64, seed=40, state=True)
    y, h = _wgmma_emulation(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ph = jssd_pallas(*jx, chunk=chunk, interpret=True)
    ry, rh = jref.ssd_ref(*jx)
    for got, want in ((y, py), (h, ph), (y, ry), (h, rh)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("S", [1, 5, 31, 32, 33, 63, 65, 100, 130])
def test_wgmma_arithmetic_ragged_length(S):
    """Ragged S next to the 32-token step and the 64-token chunk (below one
    step, across steps inside a chunk, across chunks), with a nonzero
    initial state, against the oracle (1e-5 of scale)."""
    arrs, tx = _inputs(2, S, 2, 64, 64, seed=41, state=True)
    y, h = _wgmma_emulation(*tx)
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    for got, want in ((y, ry), (h, rh)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


def test_wgmma_arithmetic_matches_reference_model_chunked():
    """Against the reference model's chunked form at its chunk of 64 (the
    same prefix sums per chunk), within 1e-5 of scale."""
    arrs, tx = _inputs(1, 192, 3, 64, 64, seed=42, state=True)
    y, h = _wgmma_emulation(*tx)
    jy, jh = jm2.ssd_chunked(*[jnp.asarray(a) for a in arrs], chunk=64)
    for got, want in ((y, jy), (h, jh)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


def test_wgmma_arithmetic_strong_decay_stays_finite():
    """la = -20 dt, a nonzero initial state and a ragged tail: every
    factor through a step's start has an exponent <= 0, so the output is
    finite and equals the oracle (1e-5 of scale)."""
    arrs, tx = _inputs(1, 130, 2, 64, 64, seed=43, state=True, decay=-20.0)
    y, h = _wgmma_emulation(*tx)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    ry, rh = jref.ssd_ref(*[jnp.asarray(a) for a in arrs])
    for got, want in ((y, ry), (h, rh)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


def test_kernel_emulation_picks_the_launched_kernel():
    """``scan_kernel`` names the G pre-pass and ssd_wgmma_kernel at
    (64, 64) only, the two mma.sync kernels elsewhere, and refuses an
    uninstantiated pair."""
    assert tk.scan_kernel(64, 64) == ("ssd_gram_kernel", "ssd_wgmma_kernel")
    for P, N in ((16, 8), (32, 16), (64, 128)):
        assert tk.scan_kernel(P, N) == ("ssd_prep_kernel", "ssd_scan_kernel")
    with pytest.raises(ValueError, match="not in"):
        tk.scan_kernel(64, 8)
    assert set(tk.WGMMA_SHAPES) <= set(tk.CUDA_SHAPES)


@pytest.mark.parametrize("B,S,H,P,N", [(2, 100, 3, 64, 64), (1, 1, 2, 64, 64),
                                       (3, 64, 2, 16, 8), (1, 129, 4, 32, 16),
                                       (2, 0, 2, 64, 64), (2, 100, 3, 64, 128),
                                       (1, 64, 1, 64, 128)])
def test_scan_plan_covers_each_element_once(B, S, H, P, N):
    """Every (token, head, batch row, column) is carried by exactly one
    block of the scan's grid, which has one block per entry of the plan,
    and the steps cover S."""
    plan = tk.scan_plan(B, S, H, P, N)
    seen = np.zeros((B, S, H, P), np.int64)
    for blk in plan["blocks"]:
        t = np.asarray(blk["tokens"], np.int64)
        c = np.asarray(blk["columns"], np.int64)
        seen[blk["batch"], t[:, None], blk["head"], c[None, :]] += 1
        assert blk["steps"] * plan["step"] >= S > (blk["steps"] - 1) \
            * plan["step"] or S == blk["steps"] == 0
    assert (seen == 1).all()
    assert int(np.prod(plan["grid"])) == len(plan["blocks"])
    assert plan["kernel"] == tk.scan_kernel(P, N)[-1]


def test_scan_columns_pinned_to_the_cuda_table():
    """``SCAN_COLUMNS`` and ``CUDA_SHAPES`` restate ``csrc/ssd_chunk.cu``'s
    REPRO_SSD_SHAPES table of (P, N, column slice): every mma.sync pair is
    in it, and a pair's slice is ``SCAN_COLUMNS``' entry where it is not
    all P columns, so that the plan and the launch cannot drift apart."""
    import re
    from pathlib import Path
    src = (Path(tk.__file__).parents[1] / "csrc" / "ssd_chunk.cu").read_text()
    table = src[src.index("#define REPRO_SSD_SHAPES"):]
    table = table[:table.index("\n\n")]
    rows = [tuple(map(int, m)) for m in
            re.findall(r"X\((\d+),\s*(\d+),\s*(\d+)\)", table)]
    assert {(P, N) for P, N, _ in rows} == \
        set(tk.CUDA_SHAPES) - set(tk.WGMMA_SHAPES)
    assert {(P, N): ps for P, N, ps in rows if ps != P} == tk.SCAN_COLUMNS
