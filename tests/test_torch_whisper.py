"""Whisper (the audio family: encoder over stub frame embeddings, decoder
with cross-attention) on the port, held against the JAX reference with the
reference's own parameters (``params_from_jax``) and numpy-seeded inputs.

* ``prefill`` (logits, the self K/V padded to the capacity, the cross
  K/V of the encoder output) and three ``decode_step``s within 2e-5 (f32)
  / 2e-2 (bf16) absolute, for ``attn_impl`` xla and flash; ``encode``'s
  and ``decode_hidden``'s layer-normed hidden states within 2e-5 absolute
  in f32 and, in bf16, 2e-2 in relative RMS norm (as the RWKV6 tests hold
  bf16 activations: one bf16 ulp at |x| of 2-4 is 0.016-0.03). On the
  flash side the reference runs its Pallas kernel in interpret mode, at
  S_enc = 64, where its blocks divide every length (the non-causal
  encoder, the causal decoder, cross-attention with Sq = 9 and Sq = 1
  against Sk = 64).
* Ragged encoder lengths (100, and Whisper's own 1500 frames: the
  reference's flash kernel asserts Sk % block == 0): the port's flash path
  (K3's plain version, non-causal, Sq != Sk) against the reference's
  ``attention_direct`` path.
* Teacher-forced decode = prefill; greedy tokens through both model APIs.
* The full config: a verbatim copy, ``param_count`` (1.53 B) and the
  parameter tree (shapes and dtypes, on the ``meta`` device) equal to the
  reference's; ``cache_bytes`` of the API's cache; the serve CLI refuses
  the audio family in both modes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import whisper as jw
from repro.models.api import build_model as jbuild_model
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import whisper as tw
from repro_torch.serving.kv_cache import cache_bytes

from _trees import PORT_ONLY_FIELDS, config_fields, param_shapes

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
REDUCED = dict(vocab_size=128, remat=False)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _cfgs(act="float32", impl="xla"):
    cfg = dataclasses.replace(get_config(ARCH).reduced(**REDUCED),
                              activation_dtype=act)
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(**REDUCED),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


@pytest.fixture(scope="module")
def params():
    cfg = get_config(ARCH).reduced(**REDUCED)
    jp = jax.tree.map(np.asarray, jbuild_model(cfg).init(
        jax.random.PRNGKey(5)))
    return jp, tw.params_from_jax(jp, device="cpu")


def _inputs(B, S, S_enc, d, act, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 128, size=(B, S))
    frames = rng.standard_normal((B, S_enc, d)).astype(np.float32)
    if act == "bfloat16":   # round once, hand both sides the same bits
        frames = frames.astype(ml_dtypes.bfloat16).astype(np.float32)
    return toks, frames


def _check_hidden(got, want, act):
    """Layer-normed hidden states (up to ~4): 2e-5 absolute in f32; in
    bf16, where one ulp at 2-4 is 0.016 and XLA and PyTorch round the bf16
    matmuls at different places, 2e-2 in relative RMS norm, as the RWKV6
    tests hold bf16 activations."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if act == "float32":
        np.testing.assert_allclose(got, want, atol=TOL[act])
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= TOL[act], rel


def _interpret_flash(monkeypatch):
    """The reference's flash path on its Pallas kernel, interpret mode."""
    monkeypatch.setattr(jattn, "attention_flash",
                        lambda q, k, v, *, causal: jflash(
                            q, k, v, causal=causal, interpret=True))


def test_config_is_a_verbatim_copy():
    """Every field of the reference's config, as the reference gives it;
    the port's own fields at the values that change nothing."""
    shared, own = config_fields(tget_config(ARCH), get_config(ARCH))
    assert shared == dataclasses.asdict(get_config(ARCH))
    assert own == PORT_ONLY_FIELDS
    assert tget_config(ARCH).param_count() == get_config(ARCH).param_count()
    assert tget_config(ARCH).param_count() == 1_534_558_720


def test_full_param_tree_matches_reference():
    cfg, tcfg = get_config(ARCH), tget_config(ARCH)
    want = param_shapes(jax.eval_shape(lambda: jbuild_model(cfg).init(
        jax.random.PRNGKey(0))))
    got = param_shapes(tapi.build_model(tcfg).init(torch.Generator(),
                                                   "meta"))
    assert got == want
    assert got["/enc_pos"] == ((cfg.max_position, cfg.d_model), "float32")
    assert got["/decoder/cross/wq"] == ((32, 1280, 1280), "float32")


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_and_decode_hidden_match_reference(params, monkeypatch, act,
                                                  impl):
    if impl == "flash":
        _interpret_flash(monkeypatch)
    jp, tp = params
    cfg, tcfg = _cfgs(act, impl)
    toks, frames = _inputs(2, 9, 64, cfg.d_model, act)
    jenc = jw.encode(cfg, jp, jnp.asarray(frames))
    jx, _ = jw.decode_hidden(cfg, jp, jnp.asarray(toks, jnp.int32), jenc)
    with torch.inference_mode():
        tenc = tw.encode(tcfg, tp, torch.from_numpy(frames))
        tx, kv = tw.decode_hidden(tcfg, tp, torch.from_numpy(toks), tenc)
    assert kv is None and tenc.dtype == getattr(torch, act)
    for got, want in ((tenc, jenc), (tx, jx)):
        _check_hidden(got, want, act)


def _prefill_and_steps(cfg, tcfg, jp, tp, toks, frames, capacity, tol,
                       steps=3):
    jl, jc = jw.prefill(cfg, jp, jnp.asarray(toks, jnp.int32),
                        frames=jnp.asarray(frames), capacity=capacity)
    with torch.inference_mode():
        tl, tc = tw.prefill(tcfg, tp, torch.from_numpy(toks),
                            frames=torch.from_numpy(frames),
                            capacity=capacity)
    B, S = toks.shape
    L, H, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    assert tc["index"] == int(jc["index"]) == S
    assert tc["sk"].shape == (L, B, capacity, H, D)
    assert tc["ck"].shape == (L, B, frames.shape[1], H, D)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol)
    for name in ("sk", "sv", "ck", "cv"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=tol,
                                   err_msg=name)
    cur = np.array([[3], [77]])[:B]
    for step in range(steps):
        jl, jc = jw.decode_step(cfg, jp, jnp.asarray(cur, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tw.decode_step(tcfg, tp, torch.from_numpy(cur), tc)
        assert tc["index"] == int(jc["index"]) == S + 1 + step
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol,
                                   err_msg=f"step {step}")
        for name in ("sk", "sv"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       atol=tol, err_msg=f"step {step}")
        cur = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_steps_match_reference(params, monkeypatch, act,
                                                  impl):
    if impl == "flash":
        _interpret_flash(monkeypatch)
    jp, tp = params
    cfg, tcfg = _cfgs(act, impl)
    toks, frames = _inputs(2, 9, 64, cfg.d_model, act, seed=1)
    _prefill_and_steps(cfg, tcfg, jp, tp, toks, frames, 16, TOL[act])


@pytest.mark.parametrize("S_enc", [100, 1500])
def test_ragged_encoder_length_matches_direct(params, S_enc):
    """The port's flash path (K3's plain version: the non-causal encoder
    at S_enc, cross-attention 5 x S_enc and 1 x S_enc) against the
    reference's xla path, which is ``attention_direct`` at these lengths
    (1500 > the chunk threshold, but no multiple of the 1024 chunk)."""
    jp, tp = params
    cfg, _ = _cfgs()
    _, tcfg = _cfgs(impl="flash")
    toks, frames = _inputs(1, 5, S_enc, cfg.d_model, "float32", seed=2)
    _prefill_and_steps(cfg, tcfg, jp, tp, toks, frames, 8, TOL["float32"],
                       steps=2)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_teacher_forced_decode_equals_prefill(params, impl):
    """The reference's ``test_decode_matches_forward`` on the port: the
    last logits of a prefill over S + T tokens equal a prefill over S
    then T teacher-forced decode steps (1e-4), and the reference's own
    decode chain (2e-5)."""
    jp, tp = params
    cfg, tcfg = _cfgs(impl=impl)
    S, T = 16, 6
    toks, frames = _inputs(1, S + T, 32, cfg.d_model, "float32", seed=3)
    tt, tf = torch.from_numpy(toks), torch.from_numpy(frames)
    with torch.inference_mode():
        full, _ = tw.prefill(tcfg, tp, tt, frames=tf)
        logits, cache = tw.prefill(tcfg, tp, tt[:, :S], frames=tf,
                                   capacity=S + T + 4)
        for t in range(T):
            logits, cache = tw.decode_step(tcfg, tp, tt[:, S + t:S + t + 1],
                                           cache)
    np.testing.assert_allclose(_np(logits), _np(full), atol=1e-4)
    jl, jc = jw.prefill(cfg, jp, jnp.asarray(toks[:, :S], jnp.int32),
                        frames=jnp.asarray(frames), capacity=S + T + 4)
    for t in range(T):
        jl, jc = jw.decode_step(cfg, jp, jnp.asarray(
            toks[:, S + t:S + t + 1], jnp.int32), jc)
    np.testing.assert_allclose(_np(logits), _np(jl), atol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_model_api_greedy_tokens_match_reference(params, impl):
    """prefill(tokens=, frames=, capacity=) and greedy decode_steps
    through both model APIs: identical tokens."""
    jp, tp = params
    cfg, tcfg = _cfgs(impl=impl)
    toks, frames = _inputs(2, 4, 48, cfg.d_model, "float32", seed=4)
    jm, tm = jbuild_model(cfg), tapi.build_model(tcfg)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32),
                        frames=jnp.asarray(frames), capacity=12)
    jtoks, ttoks = [], []
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, tokens=torch.from_numpy(toks),
                            frames=torch.from_numpy(frames), capacity=12)
        for _ in range(8):
            jcur = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
            tcur = torch.argmax(tl[:, -1], dim=-1)[:, None]
            jtoks.append(np.asarray(jcur)[:, 0].tolist())
            ttoks.append(tcur[:, 0].tolist())
            jl, jc = jm.decode_step(jp, jcur, jc)
            tl, tc = tm.decode_step(tp, tcur, tc)
    assert ttoks == jtoks and tc["index"] == int(jc["index"]) == 12


def test_cache_and_cache_bytes_match_reference():
    """The API's empty cache (four (L, B, capacity, H, D) tensors, the
    reference's audio branch) and ``cache_bytes``."""
    for cfg, tcfg in ((get_config(ARCH), tget_config(ARCH)),
                      (get_config(ARCH).reduced(),
                       tget_config(ARCH).reduced())):
        for batch, cap in ((4, 36), (1, 5)):
            assert cache_bytes(tcfg, batch, cap) == \
                jcache_bytes(cfg, batch, cap)
    tcfg = tget_config(ARCH)
    c = tapi.make_cache(tcfg, 4, 36, device="meta")
    assert {k: tuple(v.shape) for k, v in c.items() if k != "index"} == \
        {k: (32, 4, 36, 20, 64) for k in ("sk", "sv", "ck", "cv")}
    assert c["index"] == 0 and c["sk"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["engine", "gtrac"])
def test_serve_refuses_audio(mode):
    """Neither serving path of the reference can run Whisper (the stage
    functions read params["layers"]; the engine prefills without frames):
    the CLI says so in both modes."""
    with pytest.raises(NotImplementedError, match="frames"):
        tserve.main(["--mode", mode, "--device", "cpu", "--reduced",
                     "--arch", ARCH, "--tokens", "2", "--requests", "1"])
