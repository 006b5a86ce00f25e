"""The rest of the decoder-only zoo on the port: smollm-360m (RoPE, GQA
15/5), starcoder2-7b (RoPE, LayerNorm, GELU), granite-34b (learned
positions, MQA), qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b (MoE), each
held against the JAX reference on its ``.reduced`` config
(``vocab_size=128``) with the reference's own parameters
(``params_from_jax``) and numpy-seeded prompts.

* The configs are verbatim copies: every field equal.
* ``prefill`` (logits, padded K/V cache) and three ``decode_step``s, for
  both ``attn_impl`` values: 2e-5 absolute in f32 (the same f32
  arithmetic in another summation order; the reduced models' logits are
  O(0.1-1)), 2e-2 in bf16 (both sides round every matmul, residual and
  cache entry to bf16, at different places).
* ``ServingEngine.run_batch`` under f32 activations: the reference
  engine's greedy tokens, token for token (two prompt lengths, windows of
  3, mixed budgets), for both ``attn_impl`` values; in bf16 every stream
  gets its tokens and the engine its prefill and decode counts.
* ``cache_bytes`` equal to the reference's ``jax.eval_shape`` count.
* MoE teacher-forced decode = prefill at ``moe_capacity_factor=4.0`` (no
  token dropped in either), as the reference's ``test_decode_matches_
  forward``: within 1e-4 of the port's full-prompt logits and 2e-5 of the
  reference's own decode chain.

The trust-routed pipeline server on these models is
``tests/test_torch_zoo_serving.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild_model
from repro.serving.api import SubmitSpec as JSubmitSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro_torch.configs import get_config as tget_config
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import cache_bytes

torch.set_num_threads(1)

ARCHS = ["smollm-360m", "starcoder2-7b", "granite-34b", "qwen3-moe-30b-a3b",
         "phi3.5-moe-42b-a6.6b"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
REDUCED = dict(vocab_size=128, remat=False)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _cfgs(arch, act="float32", impl="xla", **over):
    kw = dict(REDUCED, **over)
    cfg = dataclasses.replace(get_config(arch).reduced(**kw),
                              activation_dtype=act)
    tcfg = dataclasses.replace(tget_config(arch).reduced(**kw),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def model_params(request):
    arch = request.param
    cfg = get_config(arch).reduced(**REDUCED)
    params = jbuild_model(cfg).init(jax.random.PRNGKey(11))
    return arch, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_verbatim_copy(arch):
    assert dataclasses.asdict(tget_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    assert tget_config(arch).param_count() == get_config(arch).param_count()


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_steps_match_reference(model_params, act, impl):
    arch, jp = model_params
    cfg, tcfg = _cfgs(arch, act, impl)
    # the reference's flash prefill is the oracle off-TPU; its decode is
    # attention_direct either way
    tp = params_from_jax(jp, device="cpu")
    toks = np.random.default_rng(7).integers(1, 128, size=(2, 9))
    jl, jc = jtf.prefill(cfg, jp, jnp.asarray(toks, jnp.int32), capacity=16)
    with torch.inference_mode():
        tl, tc = ttf.prefill(tcfg, tp, torch.from_numpy(toks), capacity=16)
    assert tc["index"] == int(jc["index"]) == 9
    assert tc["k"].shape == (tcfg.num_layers, 2, 16, tcfg.num_kv_heads,
                             tcfg.head_dim)
    tol = TOL[act]
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=tol)
    cur = np.array([[3], [77]])
    for step in range(3):
        jl, jc = jtf.decode_step(cfg, jp, jnp.asarray(cur, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = ttf.decode_step(tcfg, tp, torch.from_numpy(cur), tc)
        assert tc["index"] == int(jc["index"]) == 10 + step
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol,
                                   err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       atol=tol, err_msg=f"step {step}")
        cur = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def _queue(seed=0):
    """Five requests, prompt lengths 6 and 9 interleaved, mixed budgets."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 128, size=n), m)
            for n, m in ((6, 5), (9, 4), (6, 3), (9, 5), (6, 5))]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_greedy_tokens_match_reference(model_params, impl):
    arch, jp = model_params
    cfg, tcfg = _cfgs(arch, impl=impl)
    jeng = JServingEngine(cfg, jp, max_batch=3)
    teng = ServingEngine(tcfg, params_from_jax(jp, device="cpu"),
                         max_batch=3, device="cpu")
    for prompt, m in _queue():
        jeng.submit(JSubmitSpec(prompt=prompt, max_new_tokens=m))
        teng.submit(SubmitSpec(prompt=prompt, max_new_tokens=m))
    want = [(r.request_id, r.output) for r in jeng.run_batch()]
    got = [(r.request_id, r.output) for r in teng.run_batch()]
    assert got == want
    assert [len(o) for _, o in got] == [5, 4, 3, 5, 5]
    assert teng.prefills == 4


def test_engine_bf16_runs_and_counts(model_params):
    arch, jp = model_params
    _, tcfg = _cfgs(arch, "bfloat16", "flash")
    eng = ServingEngine(tcfg, params_from_jax(jp, device="cpu"),
                        device="cpu")
    for prompt, _ in _queue(1):
        eng.submit(SubmitSpec(prompt=prompt, max_new_tokens=4))
    done = eng.run_batch()
    assert all(len(r.output) == 4 and all(0 <= t < 128 for t in r.output)
               for r in done)
    assert eng.prefills == 2 and eng.decode_steps == 2 * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_matches_reference(arch):
    for reduced in (True, False):
        cfg, tcfg = get_config(arch), tget_config(arch)
        if reduced:
            cfg, tcfg = cfg.reduced(), tcfg.reduced()
        for batch, cap in ((4, 2144), (1, 5)):
            assert cache_bytes(tcfg, batch, cap) == \
                jcache_bytes(cfg, batch, cap)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the full-prompt logits (the
    reference's ``test_decode_matches_forward``, at its capacity factor
    4.0, where neither the prompt nor a decode step drops a token)."""
    cfg, tcfg = _cfgs(arch, moe_capacity_factor=4.0)
    jp = jax.tree.map(np.asarray, jbuild_model(cfg).init(
        jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    S, T = 16, 6
    toks = np.random.default_rng(5).integers(1, 128, size=(1, S + T))
    with torch.inference_mode():
        full, _ = ttf.prefill(tcfg, tp, torch.from_numpy(toks))
        logits, cache = ttf.prefill(tcfg, tp, torch.from_numpy(toks[:, :S]),
                                    capacity=S + T + 4)
        for t in range(T):
            logits, cache = ttf.decode_step(
                tcfg, tp, torch.from_numpy(toks[:, S + t:S + t + 1]), cache)
    np.testing.assert_allclose(_np(logits), _np(full), atol=1e-4)
    jl, jc = jtf.prefill(cfg, jp, jnp.asarray(toks[:, :S], jnp.int32),
                         capacity=S + T + 4)
    for t in range(T):
        jl, jc = jtf.decode_step(cfg, jp, jnp.asarray(
            toks[:, S + t:S + t + 1], jnp.int32), jc)
    np.testing.assert_allclose(_np(logits), _np(jl), atol=2e-5)
