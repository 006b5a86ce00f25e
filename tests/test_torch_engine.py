"""The KV-cache serving engine: the port against the JAX reference.

``ServingEngine.run_batch`` under ``activation_dtype="float32"`` must give
the reference engine's greedy tokens, token for token, for
``gpt2-large.reduced(num_layers=4, vocab_size=128)`` and
``tinyllama-1.1b.reduced(vocab_size=128)`` on the reference's own
parameters (``params_from_jax``), with two prompt lengths in one queue,
``max_batch`` windows, per-request ``max_new_tokens`` and an EOS id. Both
``attn_impl`` values are covered (``flash`` runs kernel K4's dispatch,
which on CPU tensors is its plain version). ``cache_bytes`` must equal the
reference's ``jax.eval_shape`` count exactly. The sampled path cannot
reproduce ``jax.random.categorical``'s stream, so it is tested by its
distribution: 40000 draws from one logit row against softmax, with a
chi-square statistic below 50 for 15 degrees of freedom (the 99.997th
percentile; the draws are seeded, so the test is deterministic).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.api import build_model as jbuild_model
from repro.serving.api import SubmitSpec as JSubmitSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttransformer
from repro_torch.models import whisper as twhisper
from repro_torch.models.transformer import init_params, params_from_jax
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine, next_tokens
from repro_torch.serving.kv_cache import cache_bytes, grow_cache, make_cache

torch.set_num_threads(1)

REDUCED = {"gpt2-large": dict(num_layers=4, vocab_size=128, remat=False),
           "tinyllama-1.1b": dict(vocab_size=128, remat=False)}


@pytest.fixture(scope="module", params=["gpt2-large", "tinyllama-1.1b"])
def model_params(request):
    arch = request.param
    cfg = get_config(arch).reduced(**REDUCED[arch])
    params = jbuild_model(cfg).init(jax.random.PRNGKey(5))
    return arch, jax.tree.map(np.asarray, params)


def _cfgs(arch, impl="xla", act="float32"):
    cfg = dataclasses.replace(get_config(arch).reduced(**REDUCED[arch]),
                              activation_dtype=act)
    tcfg = dataclasses.replace(tget_config(arch).reduced(**REDUCED[arch]),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


def _queue(seed=0):
    """Five requests, prompt lengths 6 and 9 interleaved, mixed budgets;
    request 3 stops at an EOS id."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 128, size=n), m)
            for n, m in ((6, 5), (9, 4), (6, 3), (9, 5), (6, 5))]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_greedy_tokens_match_reference(model_params, impl):
    arch, jp = model_params
    cfg, tcfg = _cfgs(arch, impl)
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
    # windows of 3 then 2, each split into two prompt lengths
    assert teng.prefills == 4
    assert teng.admission.admitted == 5 and not teng.queue

    # an EOS id stops its stream early, on both sides
    eos = want[3][1][1]
    jeng2 = JServingEngine(cfg, jp)
    teng2 = ServingEngine(tcfg, params_from_jax(jp, device="cpu"),
                          device="cpu")
    prompt = _queue()[3][0]
    jr = jeng2.submit(JSubmitSpec(prompt=prompt, max_new_tokens=5,
                                  eos_id=int(eos)))
    tr = teng2.submit(SubmitSpec(prompt=prompt, max_new_tokens=5,
                                 eos_id=int(eos)))
    jeng2.run_batch([jr])
    teng2.run_batch([tr])
    assert tr.output == jr.output and tr.output[-1] == eos and tr.done


def test_engine_bf16_runs_and_counts(model_params):
    """bf16 activations (the card's working type): every stream gets its
    tokens, in range; one prefill per prompt-length group and max_new - 1
    decode steps per group."""
    arch, jp = model_params
    _, tcfg = _cfgs(arch, "flash", "bfloat16")
    eng = ServingEngine(tcfg, params_from_jax(jp, device="cpu"),
                        device="cpu")
    for prompt, _ in _queue(1):
        eng.submit(SubmitSpec(prompt=prompt, max_new_tokens=4))
    done = eng.run_batch()
    assert all(len(r.output) == 4 and all(0 <= t < 128 for t in r.output)
               for r in done)
    assert eng.prefills == 2 and eng.decode_steps == 2 * 3


@pytest.mark.parametrize("arch,act,batch,cap", [
    ("gpt2-large", "bfloat16", 3, 17),
    ("gpt2-large", "float32", 4, 1120),
    ("tinyllama-1.1b", "bfloat16", 4, 2144),
    ("tinyllama-1.1b", "float32", 1, 5),
])
def test_cache_bytes_matches_reference(arch, act, batch, cap):
    for reduced in (True, False):
        cfg = get_config(arch)
        tcfg = tget_config(arch)
        if reduced:
            cfg, tcfg = cfg.reduced(), tcfg.reduced()
        cfg = dataclasses.replace(cfg, activation_dtype=act)
        tcfg = dataclasses.replace(tcfg, activation_dtype=act)
        assert cache_bytes(tcfg, batch, cap) == jcache_bytes(cfg, batch, cap)
    small = dataclasses.replace(tget_config(arch).reduced(),
                                activation_dtype=act)
    c = make_cache(small, batch, 9, device="cpu")
    assert cache_bytes(small, batch, 9) == \
        sum(c[n].numel() * c[n].element_size() for n in ("k", "v")) + 4


def test_grow_cache_zero_pads_and_preserves():
    tcfg = tget_config("tinyllama-1.1b").reduced(vocab_size=128)
    cache = make_cache(tcfg, 2, 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for n in ("k", "v"):
        cache[n].copy_(torch.randn(cache[n].shape, generator=gen))
    cache["index"] = 3
    grown = grow_cache(cache, 7)
    assert grown["k"].shape[2] == 7 and grown["v"].shape[2] == 7
    for n in ("k", "v"):
        assert torch.equal(grown[n][:, :, :4], cache[n])      # bit-equal
        assert float(grown[n][:, :, 4:].abs().sum()) == 0.0
        assert grown[n].dtype == cache[n].dtype
    assert grown["index"] == 3 and cache["k"].shape[2] == 4
    same = grow_cache(cache, 2)                # never a truncation
    assert same["k"].shape == cache["k"].shape


def test_sampled_path_is_seeded():
    _, tcfg = _cfgs("tinyllama-1.1b")
    params = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")

    def run(seed):
        eng = ServingEngine(tcfg, params, device="cpu")
        reqs = [eng.submit(SubmitSpec(prompt=np.arange(1, 7) + i,
                                      max_new_tokens=6)) for i in range(3)]
        eng.run_batch(reqs, greedy=False, temperature=1.0, seed=seed)
        return [r.output for r in reqs]

    assert run(3) == run(3)
    assert run(3) != run(4)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampled_distribution_matches_softmax(temperature):
    rng = np.random.default_rng(9)
    row = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    n = 40000
    gen = torch.Generator().manual_seed(0)
    toks = next_tokens(row.expand(n, 16), greedy=False,
                       temperature=temperature, generator=gen)
    counts = np.bincount(toks.numpy(), minlength=16)
    expect = n * torch.softmax(row / temperature, dim=0).double().numpy()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 50.0, chi2
    # greedy: the first maximum, as jnp.argmax
    tied = torch.tensor([[0.0, 2.0, 1.0, 2.0]])
    assert next_tokens(tied).tolist() == [1]


def test_submit_shim_warns_and_ids_match_reference(model_params):
    """The deprecated keyword form warns, and request ids (auto, pinned,
    auto after pinned) follow the reference's counter
    (tests/test_serving.py)."""
    arch, jp = model_params
    cfg, tcfg = _cfgs(arch)
    jeng = JServingEngine(cfg, jp)
    teng = ServingEngine(tcfg, params_from_jax(jp, device="cpu"),
                         device="cpu")
    with pytest.deprecated_call():
        req = teng.submit(np.arange(1, 5), max_new_tokens=2)
    assert req.max_new_tokens == 2 and req.request_id == 0
    with pytest.deprecated_call():
        jeng.submit(np.arange(1, 5), max_new_tokens=2)
    specs = [dict(prompt=np.arange(4)), dict(prompt=np.arange(4),
                                              request_id=7),
             dict(prompt=np.arange(4))]
    got = [teng.submit(SubmitSpec(**s)).request_id for s in specs]
    want = [jeng.submit(JSubmitSpec(**s)).request_id for s in specs]
    assert got == want == [1, 7, 8]


@pytest.mark.parametrize("arch", ["gpt2-large", "tinyllama-1.1b"])
def test_serve_engine_mode_runs_on_cpu(arch, capsys):
    tserve.main(["--mode", "engine", "--device", "cpu", "--reduced",
                 "--arch", arch, "--tokens", "3", "--requests", "2",
                 "--attn-impl", "flash"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2
    assert "6 tokens in" in out and "1 prefills, 2 decode steps" in out


def test_build_model_serves_dense_and_names_the_rest():
    tcfg = tget_config("tinyllama-1.1b").reduced(vocab_size=64)
    model = tapi.build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    lp = params["layers"][0]
    assert "wg" in lp["ffn"] and "bias" not in lp["norm1"]
    assert params["embed"]["head"].shape == (64, tcfg.d_model)
    assert "pos" not in params["embed"]
    assert model.make_cache(2, 5, device="cpu")["k"].shape == \
        (2, 2, 5, 2, 32)
    # every family of the reference is served (vlm by the transformer,
    # audio by models/whisper.py); a family it does not have raises
    assert tapi._module(dataclasses.replace(tcfg, family="vlm")) is \
        ttransformer
    assert tapi._module(dataclasses.replace(tcfg, family="audio")) is \
        twhisper
    with pytest.raises(NotImplementedError, match="family 'speech'"):
        tapi.build_model(dataclasses.replace(tcfg, family="speech"))
    # the moe family is served since the MoE slice: its layers carry the
    # router and the expert stacks, its cache is the dense layout
    moe_cfg = tget_config("qwen3-moe-30b-a3b").reduced(vocab_size=64)
    moe = tapi.build_model(moe_cfg)
    mp = moe.init(torch.Generator().manual_seed(0), "cpu")
    E, d, f = moe_cfg.num_experts, moe_cfg.d_model, moe_cfg.d_ff
    ffn = mp["layers"][0]["ffn"]
    assert set(ffn) == {"router", "wi", "wg", "wo"}
    assert ffn["router"].shape == (d, E) and ffn["wo"].shape == (E, f, d)
    assert ffn["wi"].shape == ffn["wg"].shape == (E, d, f)
    assert moe.make_cache(2, 5, device="cpu")["k"].shape == \
        (2, 2, 5, 2, 32)
    # the ssm family (RWKV6) and the hybrid family (Zamba2) are served
    # since their slices landed
    rwkv = tapi.build_model(tget_config("rwkv6-1.6b").reduced(vocab_size=64))
    assert set(rwkv.make_cache(2, 5, device="cpu")) == \
        {"tm_last", "cm_last", "wkv", "index"}
    zamba = tapi.build_model(tget_config("zamba2-2.7b").reduced(vocab_size=64))
    zp = zamba.init(torch.Generator().manual_seed(0), "cpu")
    assert len(zp["mamba"]) == 2 and set(zp["shared"]) == \
        {"attn", "mlp", "norm1", "norm2"}
    assert set(zamba.make_cache(2, 5, device="cpu")) == \
        {"k", "v", "conv", "ssm", "index"}


def test_params_from_jax_carries_tinyllama():
    cfg = get_config("tinyllama-1.1b").reduced(vocab_size=128)
    jp = jax.tree.map(np.asarray,
                      jbuild_model(cfg).init(jax.random.PRNGKey(2)))
    tp = params_from_jax(jp, device="cpu")
    assert len(tp["layers"]) == cfg.num_layers
    for path in (("ffn", "wg"), ("ffn", "wi"), ("attn", "wk"),
                 ("norm1", "weight"), ("norm2", "weight")):
        back = np.stack([lp[path[0]][path[1]].numpy()
                         for lp in tp["layers"]])
        np.testing.assert_array_equal(back,
                                      jp["layers"][path[0]][path[1]])
    np.testing.assert_array_equal(tp["embed"]["head"].numpy(),
                                  jp["embed"]["head"])
    np.testing.assert_array_equal(tp["final_norm"]["weight"].numpy(),
                                  jp["final_norm"]["weight"])
    assert set(tp["embed"]) == set(jp["embed"]) == {"tok", "head"}
