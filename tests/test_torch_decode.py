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

The CUDA kernel splits the cache rows across blocks (flash-decoding) by
``split_plan`` and combines the blocks' partial (m, l, acc). Its split
kernel is named by ``decode_kernel``: bf16 at D = 64, 80 or 128 (groups of
up to ``MMA_MAX_GROUP`` query heads) runs on the tensor cores in 64-row
tiles, f32 and bf16 at D = 16, 32 on FP32 FMAs in 128-row tiles. The plans are checked here
(every row in exactly one split, whole tiles of the kernel, one split at
small S, at least one block per SM for granite-34b's G = 48), and a
test-local torch emulation of each kernel's split and combine arithmetic
over its plan's ranges (the tensor-core kernel's: exact bf16 products
summed in f32, the scale in f32 before exp2, p rounded to bf16 for PV) is
held against the Pallas kernel and the oracle within 2e-4 (f32) / 2e-2
(bf16), with empty splits, kv_len = 1, kv_len on a split boundary and
kv_len = S, at G = 4 and at granite-34b's G = 48 (Hkv = 1, D = 128).
"""
import dataclasses
import math

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


# ---------------------------------------------------------------------------
# K4's split plan and its split-and-combine arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 77, 128, 129, 300, 1000, 1120, 2144, 4096,
                               32768])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 1), (4, 4), (3, 2), (4, 20),
                                   (4, 32), (8, 64)])
@pytest.mark.parametrize("num_sms", [132, 8])
def test_split_plan_covers_rows_once_in_whole_tiles(S, B, Hkv, num_sms):
    splits, rows = tda.split_plan(S, B, Hkv, num_sms)
    tiles = -(-S // tda.TILE_ROWS)
    assert rows % tda.TILE_ROWS == 0 and 1 <= splits <= tiles
    covered = np.zeros(S, np.int64)
    for i in range(splits):
        lo, hi = i * rows, min((i + 1) * rows, S)
        assert lo < hi                                # no empty split
        covered[lo:hi] += 1
    assert (covered == 1).all()                       # each row once
    want = -(-tda.BLOCKS_PER_SM * num_sms // (B * Hkv))   # splits wanted
    if tiles == 1 or want == 1:
        assert splits == 1
    else:            # splits as short as they can be without passing want
        per = rows // tda.TILE_ROWS
        assert splits <= want
        assert per == 1 or -(-tiles // (per - 1)) > want


def test_split_plan_at_the_engine_shapes():
    """The engine's bf16 decode at B = 4, by the kernel that serves it:
    GPT-2 Large (G = 1), TinyLlama (G = 8), Zamba2 (G = 1, D = 80) and
    granite-34b (G = 48) on the tensor-core kernel, split as far as the
    plan's blocks per SM or their 64-row tiles allow; a small capacity
    takes few splits of whole tiles."""
    # (kernel, splits, rows per split): 720, 544, 1152 and 136 blocks on
    # the H100's 132 SMs
    sms = 132
    bf16 = torch.bfloat16
    assert tda.decode_plan(1120, 4, 20, 20, 64, bf16, sms) == \
        ("decode_split_mma_kernel", 9, 128)
    assert tda.decode_plan(2144, 4, 32, 4, 64, bf16, sms) == \
        ("decode_split_mma_kernel", 34, 64)
    assert tda.decode_plan(2144, 4, 32, 32, 80, bf16, sms) == \
        ("decode_split_mma_kernel", 9, 256)
    assert tda.decode_plan(2144, 4, 48, 1, 128, bf16, sms) == \
        ("decode_split_mma_kernel", 34, 64)
    assert tda.decode_plan(104, 4, 20, 20, 64, bf16, sms) == \
        ("decode_split_mma_kernel", 2, 64)
    # the FMA kernel's plans, as before, at the f32 engine's shapes
    assert tda.split_plan(1120, 4, 20, sms) == (9, 128)
    assert tda.split_plan(104, 4, 20, sms) == (1, 128)
    assert tda.split_plan(128, 1, 1, sms) == (1, 128)
    assert tda.split_plan(2144, 4, 4, sms) == (17, 128)
    assert tda.split_plan(2144, 4, 32, sms) == (9, 256)
    assert tda.decode_plan(2144, 4, 32, 4, 64, torch.float32, sms) == \
        ("decode_split_kernel", 17, 128)
    with pytest.raises(ValueError):
        tda.split_plan(0, 4, 4, sms)


def test_split_plan_fills_the_card_at_granite():
    """granite-34b's decode (capacity 2144, B = 4, Hkv = 1, G = 48, D =
    128, bf16) runs at least one block per SM of the H100's 132 (the
    128-row FMA plan gave 17 splits, 68 blocks)."""
    kernel, splits, rows = tda.decode_plan(2144, 4, 48, 1, 128,
                                           torch.bfloat16, 132)
    assert kernel == "decode_split_mma_kernel"
    assert splits * 1 * 4 >= 132
    assert tda.split_plan(2144, 4, 1, 132) == (17, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", tda.CUDA_HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 9, 16, 17, 48, 64, 65])
def test_decode_kernel_choice(dtype, D, G):
    """Every head dim and group maps to one split kernel: the tensor-core
    kernel exactly for bf16 at D = 64, 80 or 128 and G <= 64, the FMA
    kernel for f32 and bf16 at D = 16, 32; a bf16 group above 64 at the
    tensor-core head dims is refused (no kernel takes it)."""
    mma_dim = dtype == "bfloat16" and D in (64, 80, 128)
    if mma_dim and G > 64:
        with pytest.raises(ValueError, match="no kernel takes"):
            tda.decode_kernel(getattr(torch, dtype), G, D)
        return
    kernel = tda.decode_kernel(getattr(torch, dtype), G, D)
    assert kernel == ("decode_split_mma_kernel" if mma_dim else
                      "decode_split_kernel")
    assert kernel in tda.KERNELS


@pytest.mark.parametrize("D", [64, 80, 128])
def test_decode_cuda_refuses_bf16_groups_above_the_mma_kernel(D):
    """The wrapper's plan refuses 65 query heads per KV head in bf16 at the
    tensor-core head dims, before any launch, and takes 64."""
    with pytest.raises(ValueError, match="no kernel takes 65"):
        tda.decode_plan(2144, 4, 65, 1, D, torch.bfloat16, 132)
    assert tda.decode_plan(2144, 4, 64, 1, D, torch.bfloat16, 132)[0] == \
        "decode_split_mma_kernel"
    assert tda.decode_plan(2144, 4, 65, 1, D, torch.float32, 132)[0] == \
        "decode_split_kernel"


@pytest.mark.parametrize("S", [1, 63, 64, 65, 300, 2144, 32768])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 1), (4, 4), (4, 8), (8, 64)])
def test_split_plan_in_whole_mma_tiles(S, B, Hkv):
    """The tensor-core kernel's plans: each row in one split of whole
    64-row tiles (the last ends at S), none empty."""
    splits, rows = tda.split_plan(S, B, Hkv, 132, tda.MMA_TILE_ROWS)
    assert rows % tda.MMA_TILE_ROWS == 0
    assert 1 <= splits <= -(-S // tda.MMA_TILE_ROWS)
    assert (splits - 1) * rows < S <= splits * rows


LOG2E = 1.4426950408889634


def _split_emulation(q, cache_k, cache_v, kv_len, num_sms=132):
    """K4's arithmetic on the card, in torch, for the split kernel and plan
    that ``decode_plan`` names: per split, an online softmax over the
    split's live rows in the kernel's tiles, a partial (m, l, acc) per
    split (m = -inf, l = 0, acc = 0 for a split with no live row), then the
    combine: weights exp(m_i - M), acc / max(l, 1e-30) in q's dtype. The
    FMA kernel scales q by 1/sqrt(D) in f32 and takes exp. The tensor-core
    kernel sums the exact bf16 products in f32, takes log2(e)/sqrt(D) in
    f32 on the scores before exp2 (m in log2 units, written out as m * ln
    2), and rounds p to bf16 for PV while l sums the f32 p; the rows it
    masks in a partial last tile (before the split, or TMA's zeros before
    row 0) get p = 0 exactly, so only the live rows are summed here."""
    B, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = Hq // Hkv
    kernel, splits, rows = tda.decode_plan(S, B, Hq, Hkv, D, q.dtype,
                                           num_sms)
    tile = tda.KERNELS[kernel][1]
    mma = kernel == "decode_split_mma_kernel"
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qg = q.float().reshape(B, Hkv, G, D)
    if not mma:
        qg = qg * scale
    kf, vf = cache_k.float(), cache_v.float()
    pm = torch.full((splits, B, Hkv, G), float("-inf"))
    pl = torch.zeros((splits, B, Hkv, G))
    pa = torch.zeros((splits, B, Hkv, G, D))
    for b in range(B):
        n = min(max(int(kv_len[b]), 0), S)
        for i in range(splits):
            r0, r1 = i * rows, min((i + 1) * rows, n)
            if r0 >= r1:
                continue                      # empty: m = -inf, l = 0
            m = torch.full((Hkv, G), float("-inf"))
            l = torch.zeros((Hkv, G))
            acc = torch.zeros((Hkv, G, D))
            for k0 in range(r0, r1, tile):
                k1 = min(k0 + tile, r1)
                sc = torch.einsum("hgd,khd->hgk", qg[b], kf[b, k0:k1])
                if mma:
                    sc = sc * scale_log2
                m_new = torch.maximum(m, sc.amax(-1))
                if mma:
                    alpha = torch.where(m == float("-inf"), torch.zeros(()),
                                        torch.exp2(m - m_new))
                    p = torch.exp2(sc - m_new[..., None])
                    pv = p.to(torch.bfloat16).float()
                else:
                    alpha = torch.where(m == float("-inf"), torch.zeros(()),
                                        torch.exp(m - m_new))
                    p = pv = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hgk,khd->hgd", pv, vf[b, k0:k1])
                m = m_new
            pm[i, b] = m * math.log(2.0) if mma else m
            pl[i, b], pa[i, b] = l, acc
    M = pm.amax(0)
    live = pm != float("-inf")
    w = torch.where(live, torch.exp(pm - torch.where(
        M == float("-inf"), torch.zeros(()), M)), torch.zeros(()))
    L = (pl * w).sum(0)
    O = (pa * w[..., None]).sum(0)
    out = torch.where((M == float("-inf"))[..., None], torch.zeros(()),
                      O / torch.clamp_min(L, 1e-30)[..., None])
    return out.reshape(B, Hq, D).to(q.dtype), splits


@pytest.mark.parametrize("S,num_sms", [(512, 132), (1024, 2), (1024, 132)])
@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_combine_matches_pallas_and_oracle(S, num_sms, D, dtype):
    """kv_len = 1 (every split but the first empty), kv_len on the first
    split boundary, kv_len = S and one in the middle; several splits of
    one tile (S = 512 and 1024 at 132 SMs) and two of four tiles (1024 at
    2 SMs)."""
    B, Hq, Hkv = 4, 8, 2
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(B, S, Hq, Hkv, D, dtype,
                                               seed=6)
    _, splits, rows = tda.decode_plan(S, B, Hq, Hkv, D, tq.dtype, num_sms)
    assert splits > 1 and (num_sms > 2 or rows == 4 * tda.TILE_ROWS)
    lens = np.array([1, rows, S, S // 2 + 3], np.int32)
    got, _ = _split_emulation(tq, tk, tv, torch.from_numpy(lens), num_sms)
    assert torch.isfinite(got.float()).all()
    jl = jnp.asarray(lens)
    pallas = jdecode(jq, jk, jv, jl, blk_k=128, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("S,lens", [(256, (1, 64, 256, 131)),
                                    (512, (512, 128, 65, 2))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_combine_wide_group_matches_pallas_and_oracle(S, lens, dtype):
    """granite-34b's head shape (G = 48, Hkv = 1, D = 128) at a small S:
    bf16 on the tensor-core kernel's plan (64-row splits: kv_len = 1, on a
    split boundary, one row past one, = S, in the middle), f32 on the FMA
    kernel's."""
    B, Hq, Hkv, D = 4, 48, 1, 128
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(B, S, Hq, Hkv, D, dtype,
                                               seed=9)
    kernel, splits, _ = tda.decode_plan(S, B, Hq, Hkv, D, tq.dtype, 132)
    assert splits > 1
    assert (kernel == "decode_split_mma_kernel") == (dtype == "bfloat16")
    got, _ = _split_emulation(tq, tk, tv,
                              torch.tensor(lens, dtype=torch.int32))
    assert torch.isfinite(got.float()).all()
    jl = jnp.asarray(np.array(lens, np.int32))
    pallas = jdecode(jq, jk, jv, jl, blk_k=128, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_combine_ragged_capacity(dtype):
    """S = 300 (a last split of 44 rows, which the Pallas kernel cannot
    take), against the oracle and the plain version: 3 splits of 128 rows
    on the FMA kernel (f32), 5 of 64 on the tensor-core kernel (bf16)."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(4, 300, 8, 1, 64, dtype,
                                               seed=7)
    lens = np.array([1, 128, 300, 257], np.int32)
    got, splits = _split_emulation(tq, tk, tv, torch.from_numpy(lens))
    assert splits == {"float32": 3, "bfloat16": 5}[dtype]
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])
    plain = tda.decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(plain), atol=TOL[dtype])


@pytest.mark.h100
def test_decode_kernel_matches_plain_on_h100():
    """The CUDA kernel against its plain version (H100 only): the shapes
    above, a ragged capacity, GQA at G = 8, kv_len at both ends, and the
    engine's decode shapes with kv_len = 1, on the first split boundary,
    = S and in the middle."""
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
    # GPT-2 Large, TinyLlama, Zamba2 at B = 4, and a ragged D = 128
    for B, S, Hq, Hkv, D in [(4, 1120, 20, 20, 64), (4, 2144, 32, 4, 64),
                             (4, 2144, 32, 32, 80), (4, 1000, 16, 2, 128),
                             (4, 2144, 48, 1, 128)]:
        for dtype in ("float32", "bfloat16"):
            _, _, rows = tda.decode_plan(
                S, B, Hq, Hkv, D, getattr(torch, dtype),
                torch.cuda.get_device_properties(0).multi_processor_count)
            _, tx = _inputs(B, S, Hq, Hkv, D, dtype, seed=8)
            q, k, v, _ = (t.cuda() for t in tx)
            lens = torch.tensor([1, rows, S, S // 2 + 3], dtype=torch.int32,
                                device="cuda")
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
    # M-RoPE: text-only positions, a (B, S) copied to the three
    # streams, give plain RoPE's angles; distinct streams do not
    mcfg = dataclasses.replace(tcfg, pos_type="mrope",
                               mrope_sections=(8, 4, 4))
    assert torch.equal(trope.positional_angles(mcfg, pos), a)
    streams = torch.stack([pos, pos + 1, pos + 2])
    assert not torch.equal(trope.positional_angles(mcfg, streams), a)


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
    """The pipeline server's stage functions serve RoPE now (they refused
    it until the decoder zoo joined the port): on tinyllama-1.1b.reduced
    (4 layers in 2 stages, the reference's parameters) each stage's output
    (hidden states, then the last position's logits) matches the
    reference's jitted stage within 2e-5 (f32) / 2e-2 (bf16). Positions
    run 0..S-1 in every stage, so RoPE needs no offset across hops."""
    from repro.distributed.pipeline import StagePartition as JPartition
    from repro.serving.gtrac_serve import make_stage_fns as jmake_stage_fns
    from repro_torch.distributed.pipeline import StagePartition
    from repro_torch.serving.gtrac_serve import make_stage_fns
    arch = "tinyllama-1.1b"
    red = dict(REDUCED[arch], num_layers=4)
    jp = jax.tree.map(np.asarray, jbuild_model(
        get_config(arch).reduced(**red)).init(jax.random.PRNGKey(3)))
    toks = np.random.default_rng(3).integers(1, 128, size=(2, 11))
    for act in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(arch).reduced(**red),
                                  activation_dtype=act)
        tcfg = dataclasses.replace(tget_config(arch).reduced(**red),
                                   activation_dtype=act, attn_impl="flash")
        assert tcfg.pos_type == "rope"
        jfns = jmake_stage_fns(cfg, jp, JPartition.uniform(4, 2))
        tfns = make_stage_fns(tcfg, params_from_jax(jp, device="cpu"),
                              StagePartition.uniform(4, 2))
        jpay = (jnp.asarray(toks, jnp.int32), None)
        tpay = (torch.from_numpy(toks), None)
        for jf, tf in zip(jfns, tfns):
            jpay, tpay = jf(jpay), tf(tpay)
            np.testing.assert_allclose(_np(tpay[1]), _np(jpay[1]),
                                       atol=MODEL_TOL[act], err_msg=act)
        assert tpay[1].shape == (2, 1, 128)
