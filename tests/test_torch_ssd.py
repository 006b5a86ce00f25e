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

The CUDA kernels run only on an H100 (the ``h100`` tests; skipped
elsewhere); ``chip_smoke.py`` runs the same checks at the engine's shapes.
Their wrapper's refusals are checked here: they happen before any launch.

The CUDA kernels take another order of work than the plain version: a
pre-pass computes G = C . B^T once per (batch row, chunk), shared by every
head, and the chunk's prefix sums of la left to right; the scan carries
each slice of the state's columns apart; and every product runs on the
tensor cores as a split 3xTF32 product (x = hi + lo, hi rounded to TF32,
lo = x - hi read as TF32; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi). A
test-local emulation of that arithmetic (``_kernel_emulation``) is held
against the Pallas kernel, ``ssd_ref`` and the reference model's chunked
form at the tolerances above, at ragged S next to the 64-token chunk, with
a nonzero initial state, under strong decay and with the columns cut into
slices.
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


def _kernel_emulation(x, dt, la, Bm, Cm, h0, ps=None):
    """K6's order of work in torch (f32): G = C . B^T per (batch row,
    chunk of 64), shared by all heads; cum left to right per chunk;
    M = G * exp(cum_t - cum_s) * dt_s (s <= t) and
    B' = B * exp(cum_last - cum_s) * dt_s; the state's columns in slices
    of ``ps`` (default: all P, as the CUDA kernel takes them), each carried
    through the chunks apart, y = exp(cum) (C . h) + M . x and
    h <- exp(cum_last) h + B'^T . x with 3xTF32 products."""
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
                                    (64, 64, 16)])
def test_kernel_arithmetic_column_slices(P, N, ps):
    """The state's columns carried in slices apart, then concatenated, give
    the reference model's chunked form (1e-5 of scale) at every (P, N) the
    kernels take, with a nonzero initial state."""
    arrs, tx = _inputs(1, 128, 2, P, N, seed=23, state=True)
    y, h = _kernel_emulation(*tx, ps=ps)
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


def _needs_h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")


@pytest.mark.h100
@pytest.mark.parametrize("B,S,H,P,N,state,decay", [
    (2, 64, 2, 16, 8, False, None), (1, 128, 4, 32, 16, False, None),
    (2, 100, 3, 16, 8, True, None), (1, 130, 2, 16, 8, True, -20.0),
    (2, 1000, 4, 64, 64, False, None), (1, 1, 2, 32, 16, True, None),
    (2, 65, 8, 64, 64, True, None),
] + [(1, S, 1, P, N, True, None) for P, N in tk.CUDA_SHAPES
     for S in (63, 64, 65, 128, 129)])
def test_cuda_kernel_matches_plain_on_h100(B, S, H, P, N, state, decay):
    """The CUDA kernels against their plain version (H100 only): the
    reference test's shapes, a nonzero state, strong decay, ragged
    sequences, and every (P, N) the kernels take with S at and next to
    the chunk boundaries on a grid of one head (B = H = 1), within
    5e-4."""
    _needs_h100()
    _, tx = _inputs(B, S, H, P, N, seed=11, state=state, decay=decay)
    args = [t.cuda() for t in tx]
    y, h = tk.ssd_chunked_cuda(*args)
    py, ph = tk.ssd_chunked_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    assert float((y - py).abs().max()) <= TOL
    assert float((h - ph).abs().max()) <= TOL


@pytest.mark.h100
def test_ops_ssd_launches_the_kernel_on_h100():
    _needs_h100()
    _, tx = _inputs(2, 100, 2, 16, 8, seed=12, state=True)
    before = tk.ssd_chunked_cuda.launches
    y, _ = ops.ssd(*[t.cuda() for t in tx])
    assert y.is_cuda and tk.ssd_chunked_cuda.launches == before + 1
