"""Zamba2 (Mamba2 blocks + one shared attention block) through the KV-cache
engine: the port against the JAX reference.

Two configs: ``zamba2-2.7b.reduced(vocab_size=128)`` (2 Mamba2 blocks, one
per group: d_model 128, 8 SSM heads of P = 32, N = 16; the shared block 4
query / 2 KV heads of 32) and ``.reduced(num_layers=4, attn_every=2,
vocab_size=128)``, whose groups hold two blocks each, so the grouping and
the shared block's reuse across groups are exercised. Parameters are the
reference's own ``init``, carried by ``params_from_jax``; the same tokens,
made with numpy from a seed, go to both sides. Prompt lengths 9 and 64
(one chunk; the reference's chunked scan takes S <= 64 or multiples of
64). Both ``attn_impl`` values are covered: ``flash`` sends the prefill
scan to ``ops.ssd`` (kernel K6's dispatch) and the shared block's attention
to ``ops.flash_attention`` / ``ops.decode_attention`` (K3 / K4), which on
CPU tensors run their plain versions; ``xla`` runs the plain forms.

Tolerances:

* f32: 2e-5 absolute on hidden states, conv tails, SSM states, K/V and
  logits — the same f32 arithmetic summed in another order (hidden states
  are RMS-normed, |x| < 5; logits O(0.1-1)).
* bf16: 2e-2 absolute on logits, K/V, conv tails and the f32 SSM states.
  The bf16 final hidden states are normed activations up to ~4, where one
  bf16 ulp is 0.016-0.03, and XLA and PyTorch round bf16 matmuls and
  elementwise ops at different places; they are held to 2e-2 in relative
  RMS norm.

Also: the mixer alone (``mamba2_forward`` with and without a carried
state, ``mamba2_step``), the chunked prefill against token-by-token decode
in the port (teacher-forced, at 16 tokens and at a ragged 100 the
reference cannot prefill), the engine's greedy tokens against the
reference ``ServingEngine``'s, ``cache_bytes`` against the reference's
``jax.eval_shape`` count (and at full width), ``grow_cache``, the seeded
init, ``params_from_jax`` and the serve CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import mamba2 as jm2, zamba2 as jz
from repro.models.api import build_model as jbuild_model, make_cache as jmake_cache
from repro.serving.api import SubmitSpec as JSubmitSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi, mamba2 as tm2, zamba2 as tz
from repro_torch.models.common import logits_head
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import cache_bytes, grow_cache, make_cache

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
VOCAB = 128
#: one Mamba2 block per group, and two groups of two
VARIANTS = {"g1": {}, "g2": dict(num_layers=4, attn_every=2)}
F32_TOL = 2e-5
BF16_TOL = 2e-2
CACHE = ("k", "v", "conv", "ssm")


def _ref_cfg(variant, act="float32"):
    return dataclasses.replace(
        get_config(ARCH).reduced(vocab_size=VOCAB, **VARIANTS[variant]),
        activation_dtype=act)


def _port_cfg(variant, act="float32", impl="xla"):
    return dataclasses.replace(
        tget_config(ARCH).reduced(vocab_size=VOCAB, **VARIANTS[variant]),
        activation_dtype=act, attn_impl=impl)


@pytest.fixture(scope="module")
def ref_params():
    return {v: jax.tree.map(np.asarray, jbuild_model(_ref_cfg(v)).init(
        jax.random.PRNGKey(3))) for v in VARIANTS}


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, size=(B, S)).astype(np.int32)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


def _check(name, got, want, act, activations=False):
    """f32: 2e-5 absolute. bf16: 2e-2 absolute, or for bf16 hidden states
    2e-2 in relative RMS norm."""
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


def _check_cache(got, want, act):
    for n in CACHE:
        _check(n, got[n], want[n], act)


# ---------------------------------------------------------------------------
# The Mamba2 mixer
# ---------------------------------------------------------------------------


def _both(a, dtype):
    """numpy -> (jax array in ``dtype``, torch tensor of the same values)."""
    j = jnp.asarray(a, dtype)
    return j, torch.tensor(np.asarray(j, np.float32)).to(
        getattr(torch, str(j.dtype)))


def _mixer_params(ref_params):
    jp = jax.tree.map(lambda a: a[0], ref_params["g1"]["mamba"]["mixer"])
    tp = params_from_jax(ref_params["g1"], device="cpu")["mamba"][0]["mixer"]
    return jp, tp


def _mixer_state(tcfg, act, B, seed):
    """A random (conv tail in ``act``, f32 SSM state) pair for both sides."""
    d_in, H, P, N = tm2.dims(tcfg)
    rng = np.random.default_rng(seed)
    conv = _both(rng.standard_normal(
        (B, tcfg.ssm_conv_width - 1, d_in + 2 * N)), act)
    ssm = _both(0.1 * rng.standard_normal((B, H, N, P)), "float32")
    return (conv[0], ssm[0]), (conv[1], ssm[1])


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_mamba2_forward_matches_reference(ref_params, act, carry, impl):
    """The mixer on a 64-token segment, from zeros or continuing a carried
    (conv, ssm) state; output and the new state."""
    cfg, tcfg = _ref_cfg("g1", act), _port_cfg("g1", act, impl)
    jp, tp = _mixer_params(ref_params)
    jx, tx = _both(np.random.default_rng(1).standard_normal(
        (2, 64, tcfg.d_model)), act)
    jstate, tstate = _mixer_state(tcfg, act, 2, seed=2)
    jout, (jconv, jssm) = jm2.mamba2_forward(cfg, jp, jx,
                                             jstate if carry else None)
    tout, (tconv, tssm) = tm2.mamba2_forward(tcfg, tp, tx,
                                             tstate if carry else None)
    _check("out", tout, jout, act)
    _check("conv", tconv, jconv, act)
    _check("ssm", tssm, jssm, act)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_mamba2_step_matches_reference(ref_params, act):
    cfg, tcfg = _ref_cfg("g1", act), _port_cfg("g1", act)
    jp, tp = _mixer_params(ref_params)
    jx, tx = _both(np.random.default_rng(3).standard_normal(
        (3, 1, tcfg.d_model)), act)
    jstate, tstate = _mixer_state(tcfg, act, 3, seed=4)
    jout, (jconv, jssm) = jm2.mamba2_step(cfg, jp, jx, jstate)
    tout, (tconv, tssm) = tm2.mamba2_step(tcfg, tp, tx, tstate)
    _check("out", tout, jout, act)
    _check("conv", tconv, jconv, act)
    _check("ssm", tssm, jssm, act)


def test_causal_conv_is_shifted_multiply_adds():
    """W shifted multiply-adds (no cuDNN convolution): equals the
    reference's, and a token never sees a later one."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = tm2.causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jm2.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    x2 = x.copy()
    x2[:, 7:] = 100.0
    got2 = tm2.causal_conv(*(torch.from_numpy(a) for a in (x2, w, b)))
    assert torch.equal(got2[:, :7], got[:, :7])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_hidden_and_caches_match_reference(ref_params, act, variant,
                                                   impl):
    cfg, tcfg = _ref_cfg(variant, act), _port_cfg(variant, act, impl)
    toks = _tokens(2, 64)
    jx, (jconv, jssm, jk, jv) = jz.forward_hidden(
        cfg, ref_params[variant], jnp.asarray(toks), collect_cache=True)
    cache = make_cache(tcfg, 2, 64, device="cpu")
    tx = tz.forward_hidden(tcfg, params_from_jax(ref_params[variant],
                                                 device="cpu"),
                           torch.from_numpy(toks).long(), cache=cache)
    _check("hidden", tx, jx, act, activations=True)
    _check_cache(cache, {"k": jk, "v": jv, "conv": jconv, "ssm": jssm}, act)
    assert cache["ssm"].dtype == torch.float32
    assert cache["k"].dtype == cache["conv"].dtype == getattr(torch, act)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("S", [9, 64])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, act, S, variant,
                                            impl):
    """``prefill`` logits and cache, then three ``decode_step``s (the
    reference's greedy tokens fed to both sides): logits and caches."""
    cfg, tcfg = _ref_cfg(variant, act), _port_cfg(variant, act, impl)
    jp = ref_params[variant]
    tp = params_from_jax(jp, device="cpu")
    toks = _tokens(3, S, seed=1)
    jl, jc = jz.prefill(cfg, jp, jnp.asarray(toks), capacity=S + 8)
    tl, tc = tz.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                        capacity=S + 8)
    _check("prefill logits", tl, jl, act)
    _check_cache(tc, jc, act)
    assert tc["index"] == int(jc["index"]) == S
    for step in range(3):
        nxt = np.argmax(_f32(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = jz.decode_step(cfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tz.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tc)
        _check(f"decode {step} logits", tl, jl, act)
    _check_cache(tc, jc, act)
    assert tc["index"] == int(jc["index"]) == S + 3


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("S", [16, 100])
def test_chunked_equals_recurrent(S, impl):
    """Teacher-forced decode equals the full prefill: the logits of every
    position from one ``forward_hidden`` over S tokens against ``prefill``
    of the first token and S - 1 ``decode_step``s, and the final caches;
    at 16 tokens and at a ragged 100 (no multiple of the chunk of 64, which
    the reference's chunked scan cannot take), on the port's own random
    weights."""
    tcfg = _port_cfg("g2", impl=impl)
    params = tz.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(2, S, seed=2)).long()
    full = make_cache(tcfg, 2, S, device="cpu")
    want = logits_head(tcfg, params["embed"],
                       tz.forward_hidden(tcfg, params, toks, cache=full))
    logits, cache = tz.prefill(tcfg, params, toks[:, :1], capacity=S)
    got = [logits]
    for t in range(1, S):
        logits, cache = tz.decode_step(tcfg, params, toks[:, t:t + 1], cache)
        got.append(logits)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               atol=1e-4, rtol=0)
    for n in CACHE:
        np.testing.assert_allclose(cache[n].numpy(), full[n].numpy(),
                                   atol=1e-4, rtol=0, err_msg=n)


def test_n_groups_refuses_a_ragged_grouping():
    tcfg = tget_config(ARCH).reduced(num_layers=3, attn_every=2)
    with pytest.raises(ValueError, match="attn_every"):
        tz.n_groups(tcfg)
    assert tz.n_groups(tget_config(ARCH)) == 9


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _queue(seed=0):
    """Five requests, prompt lengths 9 and 64 interleaved, mixed budgets."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, VOCAB, size=n), m)
            for n, m in ((9, 5), (64, 4), (9, 3), (64, 5), (9, 5))]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_greedy_tokens_match_reference(ref_params, variant, impl):
    cfg, tcfg = _ref_cfg(variant), _port_cfg(variant, impl=impl)
    jeng = JServingEngine(cfg, ref_params[variant], max_batch=3)
    teng = ServingEngine(tcfg, params_from_jax(ref_params[variant],
                                               device="cpu"),
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
    100 tokens: every stream gets its tokens, in range; one prefill per
    prompt-length group, max_new - 1 decode steps per group."""
    tcfg = _port_cfg("g2", "bfloat16", "flash")
    eng = ServingEngine(tcfg, params_from_jax(ref_params["g2"], device="cpu"),
                        device="cpu")
    rng = np.random.default_rng(4)
    for n in (100, 9, 100):
        eng.submit(SubmitSpec(prompt=rng.integers(1, VOCAB, size=n),
                              max_new_tokens=4))
    done = eng.run_batch()
    assert all(len(r.output) == 4 and all(0 <= t < VOCAB for t in r.output)
               for r in done)
    assert eng.prefills == 2 and eng.decode_steps == 2 * 3


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,batch,cap", [
    ("bfloat16", 4, 104),
    ("bfloat16", 3, 17),
    ("float32", 1, 5),
])
def test_cache_bytes_matches_reference(act, batch, cap):
    for over in ({}, VARIANTS["g2"], None):
        cfg, tcfg = get_config(ARCH), tget_config(ARCH)
        if over is not None:
            cfg, tcfg = cfg.reduced(**over), tcfg.reduced(**over)
        cfg = dataclasses.replace(cfg, activation_dtype=act)
        tcfg = dataclasses.replace(tcfg, activation_dtype=act)
        assert cache_bytes(tcfg, batch, cap) == jcache_bytes(cfg, batch, cap)


def test_cache_bytes_full_width():
    """Full width, B = 4, bf16: K/V of 9 groups × 32 heads × 80, the conv
    tails of 54 blocks and the (54, 4, 80, 64, 64) f32 SSM states, plus the
    index: the reference's counts at capacities 104 and 2144."""
    tcfg = tget_config(ARCH)
    assert tcfg.activation_dtype == "bfloat16"
    assert cache_bytes(tcfg, 4, 104) == 328_255_492
    assert cache_bytes(tcfg, 4, 2144) == 1_080_281_092


def test_make_cache_matches_reference_layout():
    cfg, tcfg = _ref_cfg("g2", "bfloat16"), _port_cfg("g2", "bfloat16")
    jc = jmake_cache(cfg, 3, 11)
    for c in (make_cache(tcfg, 3, 11, device="cpu"),
              tapi.build_model(tcfg).make_cache(3, 11, device="cpu")):
        assert set(c) == set(jc) == set(CACHE) | {"index"}
        for n in CACHE:
            assert tuple(c[n].shape) == tuple(jc[n].shape)
            assert str(c[n].dtype).replace("torch.", "") == str(jc[n].dtype)
            assert float(c[n].abs().sum()) == 0.0
        assert c["index"] == 0
        assert c["k"][1].is_contiguous()


def test_grow_cache_grows_kv_and_leaves_the_state():
    tcfg = _port_cfg("g2", "bfloat16")
    cache = make_cache(tcfg, 2, 4, device="cpu")
    cache["k"].fill_(1.0)
    cache["ssm"].fill_(2.0)
    grown = grow_cache(cache, 64)
    assert set(grown) == set(cache)
    assert grown["k"].shape == (2, 2, 64, 2, 32) == grown["v"].shape
    assert float(grown["k"][:, :, :4].min()) == 1.0
    assert float(grown["k"][:, :, 4:].abs().max()) == 0.0
    for n in ("conv", "ssm"):
        assert grown[n] is cache[n]
    assert grown["index"] == cache["index"]


# ---------------------------------------------------------------------------
# Parameters and the launcher
# ---------------------------------------------------------------------------


def test_init_params_follow_reference_distributions(ref_params):
    """The port's seeded init has the reference tree's keys, shapes and
    dtypes, its constants exactly, and its dense scales."""
    tcfg = _port_cfg("g2")
    tp = tapi.build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    jp = ref_params["g2"]
    assert set(tp) == set(jp)
    assert len(tp["mamba"]) == tcfg.num_layers
    assert set(tp["embed"]) == set(jp["embed"]) == {"tok", "head"}
    for i, lp in enumerate(tp["mamba"]):
        np.testing.assert_array_equal(lp["norm"]["weight"].numpy(),
                                      jp["mamba"]["norm"]["weight"][i])
        for name, want in jp["mamba"]["mixer"].items():
            got = lp["mixer"][name]
            assert tuple(got.shape) == want.shape[1:], name
            assert got.dtype == torch.float32
            if name in ("conv_b", "A_log", "D", "dt_bias", "gn_w"):
                np.testing.assert_array_equal(got.numpy(), want[i])
            else:
                scale = 0.1 if name == "conv_w" else 0.02
                assert abs(float(got.std()) - scale) < 0.15 * scale, name
    for part in ("attn", "mlp", "norm1", "norm2"):
        assert set(tp["shared"][part]) == set(jp["shared"][part])
        for name, want in jp["shared"][part].items():
            assert tuple(tp["shared"][part][name].shape) == want.shape


def test_params_from_jax_carries_zamba2(ref_params):
    jp = ref_params["g2"]
    tp = params_from_jax(jp, device="cpu")
    assert len(tp["mamba"]) == 4
    for name in ("in_proj", "conv_w", "A_log", "out_proj", "gn_w"):
        back = np.stack([lp["mixer"][name].numpy() for lp in tp["mamba"]])
        np.testing.assert_array_equal(back, jp["mamba"]["mixer"][name])
    # one copy of the shared block, carried as it is
    np.testing.assert_array_equal(tp["shared"]["attn"]["wq"].numpy(),
                                  jp["shared"]["attn"]["wq"])
    np.testing.assert_array_equal(tp["shared"]["mlp"]["wi"].numpy(),
                                  jp["shared"]["mlp"]["wi"])
    np.testing.assert_array_equal(tp["embed"]["head"].numpy(),
                                  jp["embed"]["head"])


def test_serve_engine_mode_runs_zamba2_on_cpu(capsys):
    tserve.main(["--mode", "engine", "--device", "cpu", "--reduced",
                 "--arch", ARCH, "--tokens", "3", "--requests", "2",
                 "--prompt-len", "100", "--attn-impl", "flash"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2
    assert "6 tokens in" in out and "1 prefills, 2 decode steps" in out


def test_serve_gtrac_mode_refuses_zamba2():
    """The pipeline server is dense-only: the CLI names the engine mode."""
    with pytest.raises(NotImplementedError, match="--mode engine"):
        tserve.main(["--mode", "gtrac", "--device", "cpu", "--reduced",
                     "--arch", ARCH, "--tokens", "2", "--requests", "1"])
