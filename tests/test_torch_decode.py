"""KV-cache decode (kernel K4, RoPE, prefill / decode_step): the port
against the JAX reference.

The same inputs, made with numpy from a seed, go to both sides.

* K4's plain version (what ``ops.decode_attention`` runs on CPU tensors)
  is held against the reference's Pallas ``decode_attention`` (``blk_k =
  32``, interpret mode) and its ``decode_attention_ref`` oracle at the
  shapes of ``tests/test_kernels.py`` and at Zamba2's head dim 80, with
  the reference's tolerances:
  2e-4 absolute in f32, 2e-2 in bf16 (bf16 holds about 3 significant
  digits; outputs are O(1)). ``kv_len`` stays inside K4's contract,
  1 <= kv_len <= S, as the reference's test draws it. A ragged capacity
  S = 100 (no multiple of any block; the Pallas kernel cannot take it) is
  checked against the oracle only.
* RoPE angles and rotation: 1e-6 absolute in f32 (both compute in f32;
  only the sin/cos implementations differ).
* ``prefill`` (logits and the padded K/V cache) and three ``decode_step``s
  (logits and caches) on ``gpt2-large.reduced(num_layers=4,
  vocab_size=128)`` and ``tinyllama-1.1b.reduced(vocab_size=128)`` (GQA
  4/2, RoPE, RMSNorm, SwiGLU), for both ``attn_impl`` values: 2e-5 absolute
  in f32 (the same f32 arithmetic in another summation order; logits here
  are O(0.1-1)), 2e-2 in bf16 (both sides round every matmul, residual and
  cache entry to bf16, at different places).

The CUDA kernel runs only on an H100 (the ``h100`` test; skipped
elsewhere); ``chip_smoke.py`` runs the same check at the engine's shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import params_from_jax

torch.set_num_threads(1)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

SHAPES = [
    (2, 64, 4, 2, 32),
    (3, 256, 8, 1, 64),
    (1, 128, 5, 5, 16),
    (2, 96, 4, 4, 80),     # Zamba2's shared block: head dim 80
]

REDUCED = {"gpt2-large": dict(num_layers=4, vocab_size=128, remat=False),
           "tinyllama-1.1b": dict(vocab_size=128, remat=False)}


def _inputs(B, S, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    if dtype == "bfloat16":   # round once, hand both sides the same bits
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    kv_len = rng.integers(1, S + 1, size=B).astype(np.int32)
    jx = [jnp.asarray(a) for a in arrs] + [jnp.asarray(kv_len)]
    tx = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs] + [torch.from_numpy(kv_len)]
    return jx, tx


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# K4: plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,Hq,Hkv,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_oracle(B, S, Hq, Hkv, D, dtype):
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(B, S, Hq, Hkv, D, dtype)
    got = ops.decode_attention(tq, tk, tv, tl)           # CPU: plain
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jdecode(jq, jk, jv, jl, blk_k=32, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_ragged_capacity(dtype):
    """S = 100 is no multiple of the TPU kernel's blocks; the port takes it,
    including kv_len = S and kv_len = 1."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(4, 100, 8, 2, 32, dtype,
                                               seed=1)
    lens = np.array([1, 37, 99, 100], np.int32)
    got = tda.decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


def test_decode_plain_reads_only_live_rows():
    """Rows past kv_len do not change the result, whatever finite values
    they hold (their scores are -inf, so their weights are exactly 0)."""
    _, (tq, tk, tv, _) = _inputs(2, 48, 4, 2, 16, "float32", seed=2)
    lens = torch.tensor([5, 30], dtype=torch.int32)
    base = tda.decode_attention_plain(tq, tk, tv, lens)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[0, 5:] = 1e4
    tv2[1, 30:] = -3e4
    assert torch.equal(tda.decode_attention_plain(tq, tk2, tv2, lens), base)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv, tl) = _inputs(1, 16, 4, 2, 32, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_cuda(tq, tk, tv, tl)


def test_decode_attention_registered_for_launch_counts():
    assert ops.CUDA_KERNELS["decode_attention"] is tda.decode_attention_cuda
    assert "decode_attention" in ops.launch_counts()


@pytest.mark.h100
def test_decode_kernel_matches_plain_on_h100():
    """The CUDA kernel against its plain version (H100 only): the shapes
    above, a ragged capacity, GQA at G = 8 and kv_len at both ends."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    for B, S, Hq, Hkv, D in SHAPES + [(4, 1000, 32, 4, 64),
                                      (4, 300, 20, 20, 64),
                                      (2, 77, 4, 1, 128)]:
        for dtype in ("float32", "bfloat16"):
            _, tx = _inputs(B, S, Hq, Hkv, D, dtype)
            q, k, v, lens = (t.cuda() for t in tx)
            lens[0] = 1
            lens[-1] = S
            got = tda.decode_attention_cuda(q, k, v, lens)
            want = tda.decode_attention_plain(q, k, v, lens)
            assert float((got.float() - want.float()).abs().max()) \
                <= TOL[dtype]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [32, 64])
def test_rope_matches_reference(head_dim):
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 2200, size=(2, 40)).astype(np.int32)
    want = np.asarray(jrope.rope_angles(jnp.asarray(pos), head_dim, 1e4))
    got = trope.rope_angles(torch.from_numpy(pos), head_dim, 1e4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        trope.rope_freqs(head_dim, 1e4).numpy(),
        np.asarray(jrope.rope_freqs(head_dim, 1e4)))
    x = rng.standard_normal((2, 40, 3, head_dim)).astype(np.float32)
    jr = jrope.apply_rotary(jnp.asarray(x), jnp.asarray(want))
    tr = trope.apply_rotary(torch.from_numpy(x), got)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=0)


def test_positional_angles_dispatch():
    tcfg = tget_config("tinyllama-1.1b").reduced()
    pos = torch.arange(6)[None, :]
    a = trope.positional_angles(tcfg, pos)
    assert a.shape == (1, 6, tcfg.head_dim // 2)
    assert torch.equal(trope.positional_angles(tcfg, pos[None].expand(3, 1, 6)),
                       a)                       # temporal stream of (3,B,S)
    assert trope.positional_angles(tget_config("gpt2-large"), pos) is None
    mcfg = dataclasses.replace(tcfg, pos_type="mrope")
    with pytest.raises(NotImplementedError, match="vlm"):
        trope.positional_angles(mcfg, pos)


# ---------------------------------------------------------------------------
# attention-level decode pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cache_update_matches_reference(masked):
    rng = np.random.default_rng(4)
    ck, cv = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
              for _ in range(2))
    jk, jv = jattn.cache_update(jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(kn), jnp.asarray(vn), 4,
                                masked=masked)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    rk, rv = tattn.cache_update(tk, tv, torch.from_numpy(kn),
                                torch.from_numpy(vn), 4, masked=masked)
    assert rk is tk and rv is tv                 # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("window", [0, 4])
def test_decode_attend_matches_reference(impl, window):
    """Both implementations, with and without a sliding window (on the CPU
    a window keeps the reference's math on either)."""
    cfg = get_config("tinyllama-1.1b").reduced(activation_dtype="float32")
    tcfg = dataclasses.replace(tget_config("tinyllama-1.1b").reduced(
        activation_dtype="float32"), attn_impl=impl)
    (_, jk, jv, _), (_, tk, tv, _) = _inputs(2, 12, 4, 2, 32, "float32",
                                             seed=5)
    q = np.random.default_rng(6).standard_normal((2, 1, 4, 32)).astype(
        np.float32)
    want = jattn.decode_attend(cfg, jnp.asarray(q), jk, jv, 7, window=window)
    got = tattn.decode_attend(tcfg, torch.from_numpy(q), tk, tv,
                              torch.full((2,), 7, dtype=torch.int32),
                              window=window)
    assert got.shape == (2, 1, 4, 32)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])


# ---------------------------------------------------------------------------
# prefill + decode_step against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["gpt2-large", "tinyllama-1.1b"])
def model_params(request):
    arch = request.param
    cfg = get_config(arch).reduced(**REDUCED[arch])
    params = jbuild_model(cfg).init(jax.random.PRNGKey(11))
    return arch, jax.tree.map(np.asarray, params)


def _cfgs(arch, act, impl):
    cfg = dataclasses.replace(get_config(arch).reduced(**REDUCED[arch]),
                              activation_dtype=act, attn_impl=impl)
    tcfg = dataclasses.replace(tget_config(arch).reduced(**REDUCED[arch]),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_steps_match_reference(model_params, act, impl):
    arch, jp = model_params
    cfg, tcfg = _cfgs(arch, act, impl)
    # the reference's flash prefill is the oracle off-TPU; its decode is
    # attention_direct either way
    jcfg = dataclasses.replace(cfg, attn_impl="xla")
    tp = params_from_jax(jp, device="cpu")
    toks = np.random.default_rng(7).integers(1, 128, size=(2, 9))
    jl, jc = jtf.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), capacity=16)
    with torch.inference_mode():
        tl, tc = ttf.prefill(tcfg, tp, torch.from_numpy(toks), capacity=16)
    assert tc["index"] == int(jc["index"]) == 9
    assert tc["k"].shape == (tcfg.num_layers, 2, 16, tcfg.num_kv_heads,
                             tcfg.head_dim)
    assert tc["k"].dtype == getattr(torch, act)
    tol = MODEL_TOL[act]
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=tol)
        assert float(tc[name][:, :, 9:].abs().sum()) == 0.0    # zero pad
    cur = np.array([[3], [77]])
    for step in range(3):
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(cur, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = ttf.decode_step(tcfg, tp, torch.from_numpy(cur), tc)
        assert tc["index"] == int(jc["index"]) == 10 + step
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol,
                                   err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       atol=tol, err_msg=f"step {step}")
        cur = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def test_make_cache_layout():
    tcfg = tget_config("tinyllama-1.1b").reduced(vocab_size=128)
    c = ttf.make_cache(tcfg, 3, 11, device="cpu")
    assert c["k"].shape == (2, 3, 11, 2, 32) and c["index"] == 0
    assert c["k"].dtype == torch.bfloat16 and c["k"][1].is_contiguous()
    jc = jtf.make_cache(get_config("tinyllama-1.1b").reduced(vocab_size=128),
                        3, 11)
    assert tuple(jc["k"].shape) == tuple(c["k"].shape)


def test_pipeline_server_still_refuses_rope():
    """RoPE is served by the engine path only; the pipeline server's stage
    functions keep raising for it."""
    from repro_torch.distributed.pipeline import StagePartition
    from repro_torch.serving.gtrac_serve import make_stage_fns
    tcfg = tget_config("tinyllama-1.1b").reduced(vocab_size=64)
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="rope"):
        make_stage_fns(tcfg, params, StagePartition.uniform(2, 1))
