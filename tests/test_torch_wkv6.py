"""The chunked RWKV6 WKV scan (kernel K5): the port against the JAX
reference.

The same inputs, made with numpy from a seed, go to both sides.

* ``wkv6_chunked_plain`` (what ``ops.wkv6`` runs on CPU tensors) is held
  against the reference's Pallas ``wkv6_chunked`` (interpret mode) and its
  ``wkv6_ref`` token oracle at the shapes of ``tests/test_kernels.py``, on
  that test's input distribution (normal r, k, v; lw = -exp(N - 2)), with a
  nonzero initial state and with lw = -20, within the reference's 5e-4
  absolute (outputs here are O(1-10); the scan's sums run in another
  order).
* Against the reference model's jnp chunked form
  (``repro.models.rwkv6.wkv6_chunked``) at its chunk of 32: within 1e-5 of
  the output's largest magnitude — the same chunking and f32 arithmetic,
  summed in another order (outputs reach |y| ~ 60 here, where one f32 ulp
  is 4e-6, so the bound is relative to that scale).
* At ragged lengths (S = 40, which the reference's chunked forms cannot
  take, and S = 1, 33) against the reference oracle and the port's own,
  within 5e-4.
* The port's ``ref.wkv6_ref`` against the reference's, within 1e-5.

The CUDA kernels run only on an H100 (the ``h100`` tests; skipped
elsewhere); ``chip_smoke.py`` runs the same checks at the engine's shapes.
Their wrapper's refusals are checked here: they happen before any launch.

The CUDA kernels take another order of work than the plain version: a
pre-pass takes each 16-token chunk's prefix sums of lw as a shuffle tree
scan made non-increasing by a min-scan, and from them the decayed r and k,
the chunk's state decay and the scores A (strict lower triangle, bonus
diagonal); the scan carries each slice of the state's V columns apart and
runs its products on the tensor cores as split 3xTF32 products (x = hi +
lo, hi rounded to TF32, lo = x - hi read as TF32). A test-local emulation
of that arithmetic (``_kernel_emulation``) is held against the Pallas
kernel, the oracle and the reference model's chunked form at the
tolerances above, at ragged S next to the chunk, with a nonzero initial
state, under strong decay and with the columns cut into slices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_chunk import wkv6_chunked as jwkv6_pallas
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_chunk as tk

from _tf32 import mm3

torch.set_num_threads(1)

TOL = 5e-4

#: (B, S, H, K, Pallas chunk) of tests/test_kernels.py::test_wkv6_chunked
SHAPES = [(2, 64, 2, 16, 16), (1, 128, 4, 32, 32), (2, 96, 3, 8, 32)]


def _inputs(B, S, H, K, seed=0, state=False, lw=None, u_scale=0.3):
    """The reference test's distribution: normal r, k, v; lw =
    -exp(N - 2) (or the constant ``lw``); u = u_scale * N; a zero or
    normal initial state. Returns (numpy tuple, torch tuple)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    if lw is None:
        lwv = -np.exp(rng.standard_normal((B, S, H, K)) - 2.0)
    else:
        lwv = np.full((B, S, H, K), lw)
    lwv = lwv.astype(np.float32)
    u = (u_scale * rng.standard_normal((H, K))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, K, K)) if state
          else np.zeros((B, H, K, K))).astype(np.float32)
    arrs = (r, k, v, lwv, u, s0)
    return arrs, tuple(torch.from_numpy(a.copy()) for a in arrs)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("B,S,H,K,chunk", SHAPES)
def test_plain_matches_pallas_and_oracle(B, S, H, K, chunk):
    arrs, tx = _inputs(B, S, H, K)
    y, s = tk.wkv6_chunked_plain(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ps = jwkv6_pallas(*jx, chunk=chunk, interpret=True)
    ry, rs = jref.wkv6_ref(*jx)
    _close(y, py, TOL)
    _close(s, ps, TOL)
    _close(y, ry, TOL)
    _close(s, rs, TOL)


def test_plain_nonzero_initial_state():
    """tests/test_kernels.py::test_wkv6_nonzero_initial_state's case."""
    arrs, tx = _inputs(1, 32, 2, 8, seed=1, state=True, u_scale=0.1)
    y, s = tk.wkv6_chunked_plain(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ps = jwkv6_pallas(*jx, chunk=8, interpret=True)
    ry, rs = jref.wkv6_ref(*jx)
    for got, want in ((y, py), (s, ps), (y, ry), (s, rs)):
        _close(got, want, TOL)


def test_plain_strong_decay_no_overflow():
    """lw = -20 (w = e^-20): every exponent stays <= 0, so the output is
    finite and equals the oracle."""
    arrs, tx = _inputs(1, 64, 1, 8, seed=2, lw=-20.0, u_scale=0.0)
    y, s = tk.wkv6_chunked_plain(*tx)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    jx = [jnp.asarray(a) for a in arrs]
    ry, rs = jref.wkv6_ref(*jx)
    py, _ = jwkv6_pallas(*jx, chunk=32, interpret=True)
    _close(y, ry, TOL)
    _close(s, rs, TOL)
    _close(y, py, TOL)


@pytest.mark.parametrize("B,S,H,K", [(2, 64, 2, 16), (1, 128, 4, 32),
                                     (2, 96, 3, 8)])
def test_plain_matches_reference_model_chunked(B, S, H, K):
    """The port's one chunked form against the reference model's jnp form
    at its chunk of 32: the same arithmetic, within 1e-5."""
    arrs, tx = _inputs(B, S, H, K, seed=3, state=True)
    y, s = tk.wkv6_chunked_plain(*tx)
    jy, js = jrwkv6.wkv6_chunked(*[jnp.asarray(a) for a in arrs], chunk=32)
    for got, want in ((y, jy), (s, js)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("S", [1, 33, 40])
def test_plain_ragged_length_matches_oracle(S):
    """Any S: the zero-padded tail leaves the state and the real tokens'
    y unchanged (the reference's chunked forms assert S % chunk == 0)."""
    arrs, tx = _inputs(2, S, 2, 16, seed=4, state=True)
    y, s = tk.wkv6_chunked_plain(*tx)
    assert y.shape == (2, S, 2, 16)
    ry, rs = jref.wkv6_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(s, rs, TOL)
    ty, ts = tref.wkv6_ref(*tx)
    _close(y, ty, TOL)
    _close(s, ts, TOL)


@pytest.mark.parametrize("S", [0, 5, 40])
def test_torch_oracle_matches_reference_oracle(S):
    arrs, tx = _inputs(2, S, 3, 8, seed=5, state=True)
    y, s = tref.wkv6_ref(*tx)
    ry, rs = jref.wkv6_ref(*[jnp.asarray(a) for a in arrs])
    assert y.shape == (2, S, 3, 8)
    _close(y, ry, 1e-5)
    _close(s, rs, 1e-5)


def test_ops_wkv6_on_cpu_is_the_plain_version():
    _, tx = _inputs(2, 40, 2, 16, seed=6, state=True)
    y, s = ops.wkv6(*tx)
    py, ps = tk.wkv6_chunked_plain(*tx)
    assert torch.equal(y, py) and torch.equal(s, ps)
    assert tk.wkv6_chunked_cuda.launches == 0


def test_wkv6_registered_for_launch_counts():
    assert ops.CUDA_KERNELS["wkv6_chunked"] is tk.wkv6_chunked_cuda
    assert "wkv6_chunked" in ops.launch_counts()


def _refused(**change):
    _, tx = _inputs(1, 8, 2, 16, seed=7)
    args = dict(zip(("r", "k", "v", "lw", "u", "state0"), tx))
    args.update(change)
    return args


@pytest.mark.parametrize("what,change,match", [
    ("bf16 r", lambda a: {"r": a["r"].bfloat16()}, "float32"),
    ("f64 state", lambda a: {"state0": a["state0"].double()}, "float32"),
    ("strided v", lambda a: {"v": a["v"].transpose(1, 2).contiguous()
                             .transpose(1, 2)}, "contiguous"),
    ("u shape", lambda a: {"u": a["u"][:1]}, "u must be"),
    ("state shape", lambda a: {"state0": a["state0"][:, :1]}, "state0"),
    ("k shape", lambda a: {"k": a["k"][:, :4]}, "k has shape"),
    ("head size", None, "head size"),
    ("cpu tensors", lambda a: {}, "CUDA device"),
])
def test_cuda_wrapper_refuses_without_copying(what, change, match):
    """The wrapper checks shapes, dtype, contiguity and device before any
    launch, and raises rather than converting."""
    if change is None:
        _, tx = _inputs(1, 8, 1, 12, seed=7)
        args = dict(zip(("r", "k", "v", "lw", "u", "state0"), tx))
    else:
        args = _refused()
        args.update(change(args))
    with pytest.raises(ValueError, match=match):
        tk.wkv6_chunked_cuda(**args)
    assert tk.wkv6_chunked_cuda.launches == 0


def _tree_prefix(lw, dim):
    """The pre-pass's prefix sums along ``dim`` (16 values): a shuffle tree
    scan (step d adds the value d back), then each value replaced by the
    minimum of itself and all before it (a min-scan of the same shape).
    Returns (inclusive, exclusive = the inclusive one shifted by one)."""
    c = lw.movedim(dim, 0).clone()
    n = c.shape[0]
    for op in (torch.add, torch.minimum):
        d = 1
        while d < n:
            c = torch.cat([c[:d], op(c[d:], c[:-d])])
            d *= 2
    prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    return c.movedim(0, dim), prev.movedim(0, dim)


def _kernel_emulation(r, k, v, lw, u, state0, vs=None):
    """K5's order of work in torch (f32): per chunk of 16 the tree prefix
    sums, rdec = r exp(cp), kdec = k exp(cum_last - cum), exp(cum_last) and
    the scores A (s < t, and the bonus r u k on the diagonal); the state's
    V columns in slices of ``vs`` (default: the kernel's), each carried
    through the chunks apart, y = rdec . S + A . v and
    S <- exp(cum_last) S + kdec^T . v with 3xTF32 products."""
    B, S, H, K = r.shape
    vs = vs or tk.CUDA_SLICES.get(K, K)
    C = tk.CUDA_CHUNK
    n = -(-S // C)
    pad = n * C - S
    if pad:
        r, k, v, lw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                       for a in (r, k, v, lw))
    rs, ks, vv, lws = (a.reshape(B, n, C, H, K).permute(0, 1, 3, 2, 4)
                       for a in (r, k, v, lw))                 # (B,n,H,C,K)
    cum, cp = _tree_prefix(lws, 3)
    last = cum[..., -1:, :]
    rdec, kdec, wl = rs * torch.exp(cp), ks * torch.exp(last - cum), \
        torch.exp(last[..., 0, :])
    strict = torch.ones((C, C), dtype=torch.bool).tril(-1)
    diff = cp[..., :, None, :] - cum[..., None, :, :]          # (...,t,s,K)
    A = (rs[..., :, None, :] * ks[..., None, :, :] * torch.exp(
        torch.where(strict[..., None], diff, torch.tensor(float("-inf"))))
         ).sum(-1)
    A = A + torch.diag_embed((rs * u[None, None, :, None, :] * ks).sum(-1))
    ys, states = [], []
    for j0 in range(0, K, vs):
        st = state0[..., j0:j0 + vs].clone()
        yc = []
        for c in range(n):
            vc = vv[:, c, ..., j0:j0 + vs]
            yc.append(mm3(rdec[:, c], st) + mm3(A[:, c], vc))
            st = wl[:, c, ..., None] * st + \
                mm3(kdec[:, c].transpose(-1, -2), vc)
        ys.append(torch.stack(yc, 1))
        states.append(st)
    y = torch.cat(ys, -1).permute(0, 1, 3, 2, 4).reshape(B, n * C, H, K)
    return y[:, :S], torch.cat(states, -1)


def test_tree_prefix_is_non_increasing_and_close_to_sequential():
    """The pre-pass's tree scan with its min-scan never increases for
    lw <= 0 (random, zeros, tiny values, a zero-padded tail, lw = -20), so
    cp_t - cum_s (s < t), cum_last - cum_s and cp_t are <= 0 in floating
    point; and it stays within a few ulps of the sequential sums."""
    rng = np.random.default_rng(30)
    lw = -np.exp(rng.standard_normal((16, 200)) * 4 - 3).astype(np.float32)
    lw[:, 0] = 0.0
    lw[5:, 1] = 0.0
    lw[:, 2] = -1e-30
    lw[:, 3] = -20.0
    cum, cp = _tree_prefix(torch.from_numpy(lw), 0)
    assert bool((cum[1:] <= cum[:-1]).all()) and bool((cp <= 0).all())
    assert bool((cp[1:] == cum[:-1]).all())
    seq = np.cumsum(lw.astype(np.float64), axis=0)
    assert np.abs(cum.numpy() - seq).max() <= 4e-6 * max(1.0, np.abs(seq).max())


@pytest.mark.parametrize("B,S,H,K,chunk", SHAPES)
def test_kernel_arithmetic_matches_pallas_and_oracle(B, S, H, K, chunk):
    """The CUDA kernels' order of work and 3xTF32 products against the
    Pallas kernel and the oracle at the reference test's shapes."""
    arrs, tx = _inputs(B, S, H, K)
    y, s = _kernel_emulation(*tx)
    jx = [jnp.asarray(a) for a in arrs]
    py, ps = jwkv6_pallas(*jx, chunk=chunk, interpret=True)
    ry, rs = jref.wkv6_ref(*jx)
    for got, want in ((y, py), (s, ps), (y, ry), (s, rs)):
        _close(got, want, TOL)


@pytest.mark.parametrize("S", [1, 15, 16, 17, 100])
def test_kernel_arithmetic_ragged_length(S):
    """Ragged S next to the kernels' 16-token chunk, with a nonzero initial
    state, against the oracle."""
    arrs, tx = _inputs(2, S, 2, 16, seed=31, state=True)
    y, s = _kernel_emulation(*tx)
    ry, rs = jref.wkv6_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(s, rs, TOL)


@pytest.mark.parametrize("K,vs", [(8, 8), (16, 16), (32, 16), (64, 16),
                                  (64, 8)])
def test_kernel_arithmetic_column_slices(K, vs):
    """The state's V columns carried in slices apart, then concatenated,
    give the reference model's chunked form (1e-5 of scale) at every head
    size the kernels take, with a nonzero initial state."""
    arrs, tx = _inputs(1, 64, 2, K, seed=32, state=True)
    y, s = _kernel_emulation(*tx, vs=vs)
    jy, js = jrwkv6.wkv6_chunked(*[jnp.asarray(a) for a in arrs], chunk=32)
    for got, want in ((y, jy), (s, js)):
        _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


def test_kernel_arithmetic_strong_decay_stays_finite():
    """lw = -20, a nonzero initial state and a ragged tail: finite, and
    equal to the oracle and the Pallas kernel."""
    arrs, tx = _inputs(1, 70, 1, 8, seed=33, state=True, lw=-20.0)
    y, s = _kernel_emulation(*tx)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    ry, rs = jref.wkv6_ref(*[jnp.asarray(a) for a in arrs])
    _close(y, ry, TOL)
    _close(s, rs, TOL)


def _needs_h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")


@pytest.mark.h100
@pytest.mark.parametrize("B,S,H,K,state,lw", [
    (2, 64, 2, 16, False, None), (1, 128, 4, 32, False, None),
    (2, 96, 3, 8, False, None), (1, 32, 2, 8, True, None),
    (1, 64, 1, 8, False, -20.0), (3, 40, 2, 64, True, None),
    (1, 1, 2, 32, True, None),
] + [(1, S, 1, K, True, None) for K in tk.CUDA_HEAD_DIMS
     for S in (15, 16, 17, 32, 33)])
def test_cuda_kernel_matches_plain_on_h100(B, S, H, K, state, lw):
    """The CUDA kernels against their plain version (H100 only): the
    reference test's shapes, a nonzero state, lw = -20, ragged sequences,
    and every head size the kernels take with S at and next to the chunk
    boundaries on a grid of one head (B = H = 1), within 5e-4."""
    _needs_h100()
    _, tx = _inputs(B, S, H, K, seed=8, state=state, lw=lw)
    args = [t.cuda() for t in tx]
    y, s = tk.wkv6_chunked_cuda(*args)
    py, ps = tk.wkv6_chunked_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert float((y - py).abs().max()) <= TOL
    assert float((s - ps).abs().max()) <= TOL


@pytest.mark.h100
def test_ops_wkv6_launches_the_kernel_on_h100():
    _needs_h100()
    _, tx = _inputs(2, 40, 2, 16, seed=9, state=True)
    before = tk.wkv6_chunked_cuda.launches
    y, _ = ops.wkv6(*[t.cuda() for t in tx])
    assert y.is_cuda and tk.wkv6_chunked_cuda.launches == before + 1
