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

The CUDA kernel runs only on an H100 (the ``h100`` tests; skipped
elsewhere); ``chip_smoke.py`` runs the same checks at the engine's shapes.
Its wrapper's refusals are checked here: they happen before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunked as jssd_pallas
from repro.models import mamba2 as jm2
from repro_torch.kernels import ops, ref as tref, ssd_chunk as tk

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
])
def test_cuda_kernel_matches_plain_on_h100(B, S, H, P, N, state, decay):
    """The CUDA kernel against its plain version (H100 only): the
    reference test's shapes, a nonzero state, strong decay and ragged
    sequences, within 5e-4."""
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
