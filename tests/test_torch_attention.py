"""Flash attention (kernel K3): the port against the JAX reference.

The port's flash dispatch on CPU tensors runs the kernel's plain PyTorch
version; it is held against the reference's Pallas ``flash_attention``
(``blk_q = blk_k = 32``, interpret mode) and its ``attention_ref`` oracle at
the shapes of ``tests/test_kernels.py`` and at Zamba2's head dim 80,
causal and non-causal, with the
reference's own tolerances: 2e-4 absolute in f32, 2e-2 in bf16 (bf16 holds
about 3 significant digits; outputs are O(1)). The same inputs, made with
numpy from a seed, go to both sides. A ragged S = 200 (not a multiple of
any block; the Pallas kernel cannot take it) is checked against
``attention_ref`` only. The CUDA kernel runs only on an H100 (the last
test; skipped elsewhere).

The CUDA kernel's bf16 path runs on the tensor cores and rounds once more
than the plain version: each softmax weight p is rounded to bf16 before
PV. A test-local emulation of that arithmetic (exact bf16 q.k products
summed in f32, the scale applied to the f32 scores, an online softmax in
base 2 over 64-key tiles, P rounded to bf16, f32 PV) is held against the
Pallas kernel and the oracle within the same 2e-2, at head dims 64 and
80, G = 1 and 8, causal and not, ragged S and S up to 512; and over the
wgmma kernel's 128-key tiles at head dims 64, 80 and 128, up to
granite-34b's G = 48.

Which CUDA kernel serves a call (``flash_kernel``: wgmma at bf16 D = 64,
80, 128, mma.sync at bf16 D = 16, 32, FMAs in f32) and the grid of query
tiles each one launches (every query row of every head and batch row in
one block, heaviest tiles first) are checked here too.
"""
import math

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
    (2, 64, 4, 4, 80),     # Zamba2's shared block: head dim 80
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


LOG2E = 1.4426950408889634


def _tensor_core_emulation(q, k, v, *, causal=True, tile=64):
    """K3's bf16 arithmetic on the tensor cores, in torch: q, k, v bf16
    (B, S, H, D) -> bf16. Scores are f32 sums of the exact bf16 products,
    scaled after the product by log2(e)/sqrt(D) in f32; an online softmax
    in base 2 over ``tile``-key tiles with the kernel's m == -inf guard; l
    sums the f32 p, PV takes p rounded to bf16; acc / max(l, 1e-30)."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale_log2 = float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
                       * torch.tensor(LOG2E, dtype=torch.float32))
    qg = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, Hkv, G, S), float("-inf"))
    l = torch.zeros((B, Hkv, G, S))
    acc = torch.zeros((B, Hkv, G, S, D))
    rows = torch.arange(S)
    for k0 in range(0, Sk, tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        x = torch.einsum("bqhgd,bkhd->bhgqk", qg, kt) * scale_log2
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])
            x = x.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.where(m == float("-inf"), torch.zeros(()),
                            torch.exp2(m - m_new))
        base = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
        p = torch.exp2(x - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(torch.bfloat16)


#: (B, S, Hq, Hkv, D): G = 1 and 8 at head dims 64 and 80, S up to 512
MMA_SHAPES = [
    (1, 128, 8, 8, 64),
    (1, 128, 8, 1, 64),
    (1, 256, 8, 8, 80),
    (1, 256, 8, 1, 80),
    (1, 512, 2, 2, 80),
    (1, 512, 8, 1, 64),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", MMA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_arithmetic_matches_pallas_and_oracle(B, S, Hq, Hkv, D,
                                                          causal):
    """The bf16 kernel's extra rounding (P to bf16 before PV) stays inside
    the bf16 tolerance of the Pallas kernel, the oracle and the plain
    version."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, D, "bfloat16",
                                         seed=4)
    got = _tensor_core_emulation(tq, tk, tv, causal=causal)
    assert torch.isfinite(got.float()).all()
    pallas = jflash(jq, jk, jv, causal=causal, blk_q=128, blk_k=128,
                    interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(tfa.flash_attention_plain(tq, tk, tv, causal=causal)),
        atol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 200, 8, 1, 80),
                                          (1, 100, 8, 8, 64),
                                          (1, 77, 8, 1, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_arithmetic_ragged_length(B, S, Hq, Hkv, D, causal):
    """Ragged S (a partial last tile, which the Pallas kernel cannot
    take): the emulation against the oracle."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, D, "bfloat16",
                                         seed=5)
    got = _tensor_core_emulation(tq, tk, tv, causal=causal)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL["bfloat16"])


#: (B, S, Hq, Hkv, D) over the wgmma kernel's 128-key tiles: head dims 64,
#: 80 and 128, G = 1, 7 and 48
WGMMA_SHAPES = [
    (1, 256, 48, 1, 128),
    (1, 256, 4, 4, 80),
    (1, 256, 7, 1, 64),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", WGMMA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_tile_arithmetic_matches_pallas_and_oracle(B, S, Hq, Hkv, D,
                                                         causal):
    """The wgmma kernel's arithmetic (that of the mma.sync kernel over
    128-key tiles) against the Pallas kernel, the oracle and the plain
    version, within the bf16 tolerance."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, Hq, Hkv, D, "bfloat16",
                                         seed=8)
    got = _tensor_core_emulation(tq, tk, tv, causal=causal, tile=128)
    assert torch.isfinite(got.float()).all()
    pallas = jflash(jq, jk, jv, causal=causal, blk_q=128, blk_k=128,
                    interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(tfa.flash_attention_plain(tq, tk, tv, causal=causal)),
        atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", tfa.CUDA_HEAD_DIMS)
@pytest.mark.parametrize("Sq", [1, 64, 65, 2048])
def test_flash_kernel_choice(dtype, D, Sq):
    """Every head dim maps to a kernel: f32 to the FMA kernel; bf16 at D =
    64, 80, 128 to wgmma (one consumer warpgroup up to 64 query rows, two
    above), at D = 16, 32 to mma.sync."""
    kernel = tfa.flash_kernel(getattr(torch, dtype), D, Sq)
    assert kernel in tfa.KERNELS
    if dtype == "float32":
        assert kernel == "flash_f32_kernel"
    elif D in (64, 80, 128):
        assert kernel == ("flash_bf16_wgmma_kernel" if Sq <= 64 else
                          "flash_bf16_wgmma_kernel/2")
    else:
        assert kernel == "flash_bf16_mma_kernel"


def test_flash_kernel_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_kernel(torch.bfloat16, 96, 16)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_kernel(torch.float16, 64, 16)


@pytest.mark.parametrize("kernel", list(tfa.KERNELS))
@pytest.mark.parametrize("B,Sq,Hq", [(1, 1, 1), (2, 64, 3), (1, 65, 2),
                                     (4, 200, 5), (2, 2048, 4)])
def test_flash_grid_covers_each_query_row_once(kernel, B, Sq, Hq):
    """Each kernel's grid, read as the kernels read blockIdx (head x,
    batch row z, query tile tiles - 1 - y), serves every (query row, head,
    batch row) in exactly one block, the heaviest (last) query tile of
    each head and batch row first."""
    rows = tfa.KERNELS[kernel][1]
    nx, ny, nz = tfa.flash_grid(B, Sq, Hq, kernel)
    assert (nx, nz) == (Hq, B) and ny == -(-Sq // rows)
    seen = np.zeros((B, Hq, Sq), np.int64)
    first_tile = {}
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                q0 = (ny - 1 - y) * rows
                seen[z, x, q0:q0 + rows] += 1
                first_tile.setdefault((z, x), q0)
    assert (seen == 1).all()
    assert set(first_tile.values()) == {(ny - 1) * rows}


@pytest.mark.parametrize("Sq,Sk", [(64, 128), (128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_wide_group_matches_pallas(Sq, Sk, dtype, causal):
    """granite-34b's heads (G = 48, Hkv = 1, D = 128), Sq != Sk, causal
    (keys and queries counted from 0) and not: the plain version against
    the Pallas kernel in interpret mode and the oracle."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, Sq, Sk, 48, 1, 128, dtype,
                                      seed=10)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    pallas = jflash(jq, jk, jv, causal=causal, blk_q=32, blk_k=32,
                    interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])


#: the engine's prefill shapes: GPT-2 Large 4 x 1024, TinyLlama 4 x 2048 at
#: G = 8, Zamba2's shared block 4 x 2048 at D = 80
ENGINE_PREFILL_SHAPES = [(4, 1024, 20, 20, 64), (4, 2048, 32, 4, 64),
                         (4, 2048, 32, 32, 80)]


@pytest.mark.h100
def test_kernel_matches_plain_on_h100():
    """The CUDA kernel against its plain version (H100 only)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    for B, S, Hq, Hkv, D in SHAPES + MMA_SHAPES + WGMMA_SHAPES + \
            ENGINE_PREFILL_SHAPES + [(1, 200, 20, 20, 64), (2, 200, 8, 1, 80),
                                     (1, 77, 8, 1, 64),
                                     (4, 2048, 48, 1, 128)]:
        for dtype in ("float32", "bfloat16"):
            _, tx = _inputs(B, S, Hq, Hkv, D, dtype)
            q, k, v = (t.cuda() for t in tx)
            for causal in (True, False):
                got = tfa.flash_attention_cuda(q, k, v, causal=causal)
                want = tfa.flash_attention_plain(q, k, v, causal=causal)
                assert float((got.float() - want.float()).abs().max()) \
                    <= TOL[dtype]


# ---------------------------------------------------------------------------
# K3 in Whisper's modes: non-causal, Sq != Sk
# ---------------------------------------------------------------------------


def _qkv(B, Sq, Sk, Hq, Hkv, D, dtype, seed=0):
    """q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), numpy-seeded, the same
    bits for both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, s, h, D)).astype(np.float32)
            for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
          for a in arrs]
    return jx, tx


#: (B, Sq, Sk, Hq, Hkv, D): a decode step's one-token cross-attention, a
#: short prompt's cross-attention, a longer query block, GQA
CROSS_SHAPES = [(2, 1, 64, 4, 4, 64), (2, 4, 128, 4, 4, 64),
                (1, 32, 96, 4, 2, 32), (1, 9, 64, 6, 3, 16)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_sq_ne_sk_matches_pallas(B, Sq, Sk, Hq, Hkv, D, dtype,
                                             causal):
    """K3's plain version with Sq != Sk against the Pallas kernel in
    interpret mode and the oracle. Non-causal is Whisper's
    cross-attention; causal with Sq != Sk holds the two masks to the same
    rule (key j visible to query i iff j <= i, both counted from 0: the
    plain version's ``tril`` on (Sq, Sk), the kernel's absolute
    positions)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Sq, Sk, Hq, Hkv, D, dtype, seed=6)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    pallas = jflash(jq, jk, jv, causal=causal, blk_q=32, blk_k=32,
                    interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("Sk", [100, 1500])
@pytest.mark.parametrize("Sq", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_ragged_cross_matches_direct(Sk, Sq, dtype):
    """Ragged encoder lengths (Whisper's 1500 frames is no multiple of
    the TPU kernel's blocks): K3's plain version, non-causal, against the
    reference's ``attention_direct``."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, Sq, Sk, 4, 4, 64, dtype, seed=7)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=False)
    want = jattn.attention_direct(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


#: (Sq, Sk, causal): at the chunk threshold (1024: direct), one past it
#: (1025: chunked's ragged fallback), two chunks (2048), a ragged 1500
#: (Whisper's frames), and short queries over long keys
CHUNK_CASES = [(1024, 1024, True), (1025, 1025, True), (2048, 2048, True),
               (1500, 1500, False), (4, 2048, False), (1, 1500, False)]


@pytest.mark.parametrize("Sq,Sk,causal", CHUNK_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_chunked_matches_reference(Sq, Sk, causal, dtype):
    """``attention_chunked`` at the reference's dispatch chunk
    (``max(attn_chunk_size, Sk // 8)`` = 1024 here) and at 256 (8 chunks
    at 2048), and its ragged fallback, within the stated tolerance."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, Sq, Sk, 2, 1, 16, dtype, seed=8)
    for chunk in (1024, 256):
        got = tattn.attention_chunked(tq, tk, tv, causal=causal,
                                      chunk=chunk)
        want = jattn.attention_chunked(jq, jk, jv, causal=causal,
                                       chunk=chunk)
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                                   err_msg=f"chunk {chunk}")


def _record(monkeypatch, mod, seen):
    """Record which of ``mod``'s three attention functions ``attend``
    calls (each still computes)."""
    for name in ("attention_direct", "attention_chunked",
                 "attention_flash"):
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)


#: (Sq, Sk, kv_len, q_offset): every branch of the reference's dispatch
BRANCH_CASES = [(4, 1024, None, 0), (4, 1025, None, 0), (4, 2048, None, 0),
                (4, 1500, None, 0), (4, 2048, 2000, 0), (4, 2048, None, 3),
                (1, 1500, None, 0), (4, 64, None, 0)]


@pytest.mark.parametrize("Sq,Sk,kv_len,q_offset", BRANCH_CASES)
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_takes_the_reference_branch(monkeypatch, Sq, Sk, kv_len,
                                           q_offset, impl, dtype):
    """``attend`` picks the reference's branch for every (Sk, kv_len,
    q_offset) (flash without kv_len; chunked above the threshold without
    kv_len or offset; else direct), and the result agrees. The
    reference's first call of a chunked dispatch may fall through to
    ``attention_direct`` (ragged Sk), as the port's does."""
    over = dict(num_layers=2, attn_impl=impl, activation_dtype=dtype)
    cfg = get_config("qwen2-vl-7b").reduced(**over)
    tcfg = tget_config("qwen2-vl-7b").reduced(**over)
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, Sq, Sk, 4, 2, 32, dtype, seed=9)
    jseen, tseen = [], []
    _record(monkeypatch, jattn, jseen)
    _record(monkeypatch, tattn, tseen)
    kw = dict(causal=False, q_offset=q_offset)
    want = jattn.attend(cfg, jq, jk, jv, kv_len=None if kv_len is None
                        else np.array([kv_len]), **kw)
    got = tattn.attend(tcfg, tq, tk, tv, kv_len=None if kv_len is None
                       else torch.tensor([kv_len]), **kw)
    assert tseen == jseen and tseen
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.h100
def test_kernel_sq_ne_sk_matches_plain_on_h100():
    """The CUDA kernel, non-causal and with Sq != Sk (one query row of a
    64-row tile; a key tail past a multiple of 64), against its plain
    version (H100 only)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100): the CUDA kernel has no "
                    "CPU mode")
    for B, Sq, Sk, Hq, Hkv, D in CROSS_SHAPES + [(4, 1, 1500, 20, 20, 64),
                                                 (4, 4, 1500, 20, 20, 64),
                                                 (2, 1500, 1500, 20, 20, 64)]:
        for dtype in ("float32", "bfloat16"):
            _, tx = _qkv(B, Sq, Sk, Hq, Hkv, D, dtype)
            q, k, v = (t.cuda() for t in tx)
            got = tfa.flash_attention_cuda(q, k, v, causal=False)
            want = tfa.flash_attention_plain(q, k, v, causal=False)
            assert float((got.float() - want.float()).abs().max()) \
                <= TOL[dtype]
