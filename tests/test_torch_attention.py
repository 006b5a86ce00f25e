"""Flash attention (kernel K3): the port against the JAX reference.

The port's flash dispatch on CPU tensors runs the kernel's plain PyTorch
version; it is held against the reference's Pallas ``flash_attention``
(``blk_q = blk_k = 32``, interpret mode) and its ``attention_ref`` oracle at
the shapes of ``tests/test_kernels.py``, causal and non-causal, with the
reference's own tolerances: 2e-4 absolute in f32, 2e-2 in bf16 (bf16 holds
about 3 significant digits; outputs are O(1)). The same inputs, made with
numpy from a seed, go to both sides. A ragged S = 200 (not a multiple of
any block; the Pallas kernel cannot take it) is checked against
``attention_ref`` only. The CUDA kernel runs only on an H100 (the last
test; skipped elsewhere).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}

SHAPES = [
    (2, 64, 4, 2, 32),
    (1, 128, 8, 2, 64),
    (2, 96, 3, 1, 16),     # MQA, ragged heads
    (1, 256, 2, 2, 128),   # MHA, wide head
]


def _inputs(B, S, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    if dtype == "bfloat16":   # round once, hand both sides the same bits
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs]
    return jx, tx


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_oracle(B, S, Hq, Hkv, D, dtype,
                                               causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, D, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)    # CPU: plain
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jflash(jq, jk, jv, causal=causal, blk_q=32, blk_k=32,
                    interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])
    # the torch oracle port agrees with the JAX oracle
    np.testing.assert_allclose(
        _np(tref.attention_ref(tq, tk, tv, causal=causal)), _np(oracle),
        atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_ragged_length(dtype):
    """S = 200 is no multiple of the TPU kernel's blocks; the port takes it."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 200, 4, 2, 32, dtype, seed=1)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    want = jref.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attend_matches_reference(impl):
    """The model-level dispatch on both implementations, f32 activations."""
    cfg = get_config("gpt2-large").reduced(num_layers=2, attn_impl=impl,
                                           activation_dtype="float32")
    tcfg = tget_config("gpt2-large").reduced(num_layers=2, attn_impl=impl,
                                             activation_dtype="float32")
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 24, 4, 2, 32, "float32", seed=2)
    got = tattn.attend(tcfg, tq, tk, tv, causal=True)
    want = jattn.attend(cfg, jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])


def test_attention_direct_window_and_kv_len():
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 16, 4, 2, 32, "float32", seed=3)
    for kw in ({"window": 5}, {"kv_len": np.array([9, 16])},
               {"q_offset": 0, "window": 0}):
        got = tattn.attention_direct(tq, tk, tv, causal=True, **kw)
        want = jattn.attention_direct(jq, jk, jv, causal=True, **kw)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"])


def test_flash_rejects_sliding_window():
    tcfg = tget_config("gpt2-large").reduced(attn_impl="flash",
                                             sliding_window=8)
    _, (tq, tk, tv) = _inputs(1, 16, 4, 2, 32, "float32")
    with pytest.raises(ValueError, match="sliding_window"):
        tattn.attend(tcfg, tq, tk, tv, causal=True,
                     window=tcfg.sliding_window)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv) = _inputs(1, 16, 4, 2, 32, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(tq, tk, tv)


@pytest.mark.h100
def test_kernel_matches_plain_on_h100():
    """The CUDA kernel against its plain version (H100 only)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    for B, S, Hq, Hkv, D in SHAPES + [(1, 200, 20, 20, 64)]:
        for dtype in ("float32", "bfloat16"):
            _, tx = _inputs(B, S, Hq, Hkv, D, dtype)
            q, k, v = (t.cuda() for t in tx)
            for causal in (True, False):
                got = tfa.flash_attention_cuda(q, k, v, causal=causal)
                want = tfa.flash_attention_plain(q, k, v, causal=causal)
                assert float((got.float() - want.float()).abs().max()) \
                    <= TOL[dtype]
