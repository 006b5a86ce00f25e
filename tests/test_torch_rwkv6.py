"""RWKV6 through the KV-cache engine: the port against the JAX reference.

``rwkv6-1.6b.reduced(vocab_size=128)`` (2 layers, d_model 128, 4 WKV
heads of 32, d_ff 256) on the reference's own ``init`` parameters, carried
by ``params_from_jax``; the same tokens, made with numpy from a seed, go to
both sides. Prompt lengths 9 and 64 (two chunks of 32, so the inter-chunk
carry is exercised). Both ``attn_impl`` values are covered: ``flash``
sends the prefill scan to ``ops.wkv6`` (kernel K5's dispatch, which on CPU
tensors runs its plain version), ``xla`` to the plain chunked form.

Tolerances:

* f32: 2e-5 absolute on hidden states, states and logits — the same f32
  arithmetic summed in another order (hidden states are layer-normed,
  |x| < 5; logits O(0.1-1)).
* bf16: 2e-2 absolute on logits and on the f32 WKV state. The bf16 hidden
  states and token-shift carries are layer-normed activations up to ~4,
  where one bf16 ulp is 0.016-0.03, and XLA and PyTorch round the bf16
  matmuls and elementwise ops at different places; they are held to 2e-2
  in relative RMS norm (both sides sit ~1.2% RMS from the f32 result).

Also: chunked prefill equals the token recurrence in the port (as
``tests/test_models_smoke.py::test_rwkv6_chunked_equals_recurrent``, at
1e-4, and at a ragged 40 tokens the reference cannot prefill), the
engine's greedy tokens equal the reference ``ServingEngine``'s,
``cache_bytes`` equals the reference's ``jax.eval_shape`` count, and the
serve CLI runs the engine and refuses the pipeline server for RWKV6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import rwkv6 as jrwkv6
from repro.models.api import build_model as jbuild_model
from repro.models.api import make_cache as jmake_cache
from repro.serving.api import SubmitSpec as JSubmitSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import cache_bytes, grow_cache, make_cache

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
REDUCED = dict(vocab_size=128)
F32_TOL = 2e-5
BF16_TOL = 2e-2
STATE = ("tm_last", "cm_last", "wkv")


@pytest.fixture(scope="module")
def ref_params():
    cfg = get_config(ARCH).reduced(**REDUCED)
    return jax.tree.map(np.asarray, jbuild_model(cfg).init(
        jax.random.PRNGKey(3)))


def _cfgs(act="float32", impl="xla"):
    cfg = dataclasses.replace(get_config(ARCH).reduced(**REDUCED),
                              activation_dtype=act)
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(**REDUCED),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, 128, size=(B, S)).astype(np.int32)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


def _check(name, got, want, act, activations=False):
    """f32: 2e-5 absolute. bf16: 2e-2 absolute, or for bf16 activations
    (hidden states, token-shift carries) 2e-2 in relative RMS norm."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if act == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0,
                                   err_msg=name)
    elif activations:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_TOL, (name, rel)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0,
                                   err_msg=name)


def _check_state(got, want, act):
    for n in STATE:
        _check(n, got[n], want[n], act, activations=n != "wkv")


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("S", [9, 64])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_hidden_matches_reference(ref_params, act, S, impl):
    cfg, tcfg = _cfgs(act, impl)
    toks = _tokens(2, S)
    jx, jst = jrwkv6.forward_hidden(cfg, ref_params, jnp.asarray(toks))
    tx, tst = trwkv6.forward_hidden(tcfg, params_from_jax(ref_params,
                                                          device="cpu"),
                                    torch.from_numpy(toks).long())
    _check("hidden", tx, jx, act, activations=True)
    _check_state(tst, jst, act)
    assert tst["wkv"].dtype == torch.float32
    assert tst["tm_last"].dtype == getattr(torch, act)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("S", [9, 64])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, act, S, impl):
    """``prefill`` logits and cache, then three ``decode_step``s (the
    reference's greedy tokens fed to both sides): logits and caches."""
    cfg, tcfg = _cfgs(act, impl)
    tp = params_from_jax(ref_params, device="cpu")
    toks = _tokens(3, S, seed=1)
    jl, jc = jrwkv6.prefill(cfg, ref_params, jnp.asarray(toks))
    tl, tc = trwkv6.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                            capacity=S + 8)
    _check("prefill logits", tl, jl, act)
    _check_state(tc, jc, act)
    assert tc["index"] == int(jc["index"]) == S
    for step in range(3):
        nxt = np.argmax(np.asarray(jl, np.float32)[:, -1], -1)
        nxt = nxt[:, None].astype(np.int32)
        jl, jc = jrwkv6.decode_step(cfg, ref_params, jnp.asarray(nxt), jc)
        tl, tc = trwkv6.decode_step(tcfg, tp, torch.from_numpy(nxt).long(),
                                    tc)
        _check(f"decode {step} logits", tl, jl, act)
    _check_state(tc, jc, act)
    assert tc["index"] == int(jc["index"]) == S + 3


@pytest.mark.parametrize("S", [16, 40])
def test_chunked_equals_recurrent(S):
    """The port's chunked prefill equals its token-by-token recurrence
    (the reference's test at S = 16, and a ragged S = 40 that the
    reference's chunked form cannot take), on the port's own random
    weights."""
    tcfg = tget_config(ARCH).reduced(d_model=64, rwkv_head_dim=16, d_ff=128,
                                     activation_dtype="float32")
    params = trwkv6.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    toks = torch.from_numpy(_tokens(2, S, seed=2)).long() % tcfg.vocab_size
    x_full, st_full = trwkv6.forward_hidden(tcfg, params, toks)
    st, outs = None, []
    for t in range(S):
        x1, st = trwkv6.forward_hidden(tcfg, params, toks[:, t:t + 1], st,
                                       single_step=True)
        outs.append(x1)
    np.testing.assert_allclose(x_full.numpy(), torch.cat(outs, 1).numpy(),
                               atol=1e-4, rtol=0)
    for n in STATE:
        np.testing.assert_allclose(st_full[n].numpy(), st[n].numpy(),
                                   atol=1e-4, rtol=0)


def _queue(seed=0):
    """Five requests, prompt lengths 9 and 64 interleaved, mixed budgets."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 128, size=n), m)
            for n, m in ((9, 5), (64, 4), (9, 3), (64, 5), (9, 5))]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_greedy_tokens_match_reference(ref_params, impl):
    cfg, tcfg = _cfgs("float32", impl)
    jeng = JServingEngine(cfg, ref_params, max_batch=3)
    teng = ServingEngine(tcfg, params_from_jax(ref_params, device="cpu"),
                         max_batch=3, device="cpu")
    for prompt, m in _queue():
        jeng.submit(JSubmitSpec(prompt=prompt, max_new_tokens=m))
        teng.submit(SubmitSpec(prompt=prompt, max_new_tokens=m))
    want = [(r.request_id, r.output) for r in jeng.run_batch()]
    got = [(r.request_id, r.output) for r in teng.run_batch()]
    assert got == want
    assert [len(o) for _, o in got] == [5, 4, 3, 5, 5]
    assert teng.prefills == 4        # windows of 3 then 2, two lengths each


def test_engine_bf16_runs_and_counts(ref_params):
    """bf16 activations (the card's working type) and a ragged prompt of
    40 tokens: every stream gets its tokens, in range; one prefill per
    prompt-length group, max_new - 1 decode steps per group."""
    _, tcfg = _cfgs("bfloat16", "flash")
    eng = ServingEngine(tcfg, params_from_jax(ref_params, device="cpu"),
                        device="cpu")
    rng = np.random.default_rng(4)
    for n in (40, 9, 40):
        eng.submit(SubmitSpec(prompt=rng.integers(1, 128, size=n),
                              max_new_tokens=4))
    done = eng.run_batch()
    assert all(len(r.output) == 4 and all(0 <= t < 128 for t in r.output)
               for r in done)
    assert eng.prefills == 2 and eng.decode_steps == 2 * 3


@pytest.mark.parametrize("act,batch,cap", [
    ("bfloat16", 4, 2144),
    ("bfloat16", 3, 17),
    ("float32", 1, 5),
])
def test_cache_bytes_matches_reference(act, batch, cap):
    for reduced in (True, False):
        cfg, tcfg = get_config(ARCH), tget_config(ARCH)
        if reduced:
            cfg, tcfg = cfg.reduced(), tcfg.reduced()
        cfg = dataclasses.replace(cfg, activation_dtype=act)
        tcfg = dataclasses.replace(tcfg, activation_dtype=act)
        assert cache_bytes(tcfg, batch, cap) == jcache_bytes(cfg, batch, cap)
    small = dataclasses.replace(tget_config(ARCH).reduced(),
                                activation_dtype=act)
    c = make_cache(small, batch, cap, device="cpu")
    assert cache_bytes(small, batch, cap) == sum(
        c[n].numel() * c[n].element_size() for n in STATE) + 4


def test_cache_bytes_full_width():
    """Full width, B = 4, bf16: 786,432 bytes of token-shift carries,
    50,331,648 of WKV state, 4 of index, for any capacity."""
    tcfg = tget_config(ARCH)
    assert tcfg.activation_dtype == "bfloat16"
    for cap in (104, 2144, 10_000):
        assert cache_bytes(tcfg, 4, cap) == 786_432 + 50_331_648 + 4 \
            == 51_118_084


def test_make_cache_matches_reference_layout():
    cfg, tcfg = _cfgs("bfloat16")
    jc = jmake_cache(cfg, 3, 11)
    for c in (make_cache(tcfg, 3, 11, device="cpu"),
              tapi.build_model(tcfg).make_cache(3, 11, device="cpu")):
        assert set(c) == set(jc) == set(STATE) | {"index"}
        for n in STATE:
            assert tuple(c[n].shape) == tuple(jc[n].shape)
            assert str(c[n].dtype).replace("torch.", "") == str(jc[n].dtype)
            assert float(c[n].abs().sum()) == 0.0
        assert c["index"] == 0


def test_grow_cache_passes_state_through():
    _, tcfg = _cfgs("bfloat16")
    cache = make_cache(tcfg, 2, 4, device="cpu")
    grown = grow_cache(cache, 64)
    assert set(grown) == set(cache)
    for n in STATE:
        assert grown[n] is cache[n]
    assert grown["index"] == cache["index"]


def test_init_params_follow_reference_distributions(ref_params):
    """The port's seeded init has the reference tree's keys, shapes and
    dtypes, its constants exactly, and its dense scales."""
    tcfg = tget_config(ARCH).reduced(**REDUCED)
    tp = tapi.build_model(tcfg).init(torch.Generator().manual_seed(0),
                                     "cpu")
    assert len(tp["layers"]) == tcfg.num_layers
    assert set(tp["embed"]) == set(ref_params["embed"]) == {"tok", "head"}
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == set(ref_params["layers"])
        for name, want in ref_params["layers"].items():
            got = lp[name]
            if isinstance(want, dict):
                for k2, w2 in want.items():
                    np.testing.assert_array_equal(got[k2].numpy(), w2[i])
                continue
            assert tuple(got.shape) == want.shape[1:], name
            assert got.dtype == torch.float32
            if name in ("mu", "cm_mu", "w0", "u", "gn_w", "gn_b"):
                np.testing.assert_array_equal(got.numpy(), want[i])
            else:
                scale = 0.01 if name == "wd2" else 0.02
                assert abs(float(got.std()) - scale) < 0.1 * scale, name


def test_params_from_jax_carries_rwkv6(ref_params):
    tp = params_from_jax(ref_params, device="cpu")
    for name in ("wr", "wd1", "wd2", "u", "cm_k", "mu"):
        back = np.stack([lp[name].numpy() for lp in tp["layers"]])
        np.testing.assert_array_equal(back, ref_params["layers"][name])
    np.testing.assert_array_equal(tp["embed"]["head"].numpy(),
                                  ref_params["embed"]["head"])


def test_serve_engine_mode_runs_rwkv6_on_cpu(capsys):
    tserve.main(["--mode", "engine", "--device", "cpu", "--reduced",
                 "--arch", ARCH, "--tokens", "3", "--requests", "2",
                 "--prompt-len", "40", "--attn-impl", "flash"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2
    assert "6 tokens in" in out and "1 prefills, 2 decode steps" in out


def test_serve_gtrac_mode_refuses_rwkv6():
    """The pipeline server is dense-only (the reference's stage functions
    are transformer-only): the CLI names the engine mode instead of
    failing deeper down."""
    with pytest.raises(NotImplementedError, match="--mode engine"):
        tserve.main(["--mode", "gtrac", "--device", "cpu", "--reduced",
                     "--arch", ARCH, "--tokens", "2", "--requests", "1"])
