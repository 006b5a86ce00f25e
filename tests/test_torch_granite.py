"""Granite-4.0-H-Small in the port: its config, the decoder stack of Mamba2
and NoPE attention layers as the pipeline server serves it, the KV-cache
path's refusal, the attention scale, the shared expert's place among the
weight casts, the wall spans it opens, and the existing configurations'
stage logits held bit for bit to what the port gave before Granite's
fields and layer kinds existed. CPU only, tiny widths. The comparison
with the plain reference (``portbench/reference/granite_hybrid.py``) is in
``portbench/tests/test_portbench_granite.py``.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import ModelConfig, layer_period
from repro_torch.distributed.pipeline import StagePartition
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.models.common import cast_matmul_weights, cast_once_count
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.gtrac_serve import make_stage_fns

from _trees import PORT_ONLY_FIELDS

GRANITE = "granite-4.0-h-small"
#: stage logits of reduced StarCoder2 and Qwen3 configs, taken with the
#: port as it was before ``ModelConfig`` had layer kinds, a shared expert
#: and multipliers (``_stage_logits`` below, run on that code)
GOLDEN = Path(__file__).with_name("golden_stage_logits.npz")


def _stage_logits(arch, param_dtype, seed):
    """The last stage's logits of a reduced ``arch`` (4 layers in two
    stages, bf16 activations, the flash path's plain versions) on
    ``seed``'s weights and tokens, one thread."""
    torch.set_num_threads(1)
    cfg = get_config(arch).reduced(num_layers=4, attn_impl="flash",
                                   activation_dtype="bfloat16",
                                   param_dtype=param_dtype)
    params = tf.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(seed + 1))
    payload = (toks, None)
    for fn in make_stage_fns(cfg, params, StagePartition.uniform(4, 2)):
        payload = fn(payload)
    return payload[1].float()


@pytest.mark.parametrize("arch,param_dtype,seed", [
    ("starcoder2-7b", "float32", 5), ("qwen3-moe-30b-a3b", "bfloat16", 6)])
def test_existing_configs_give_the_stage_logits_they_gave(arch, param_dtype,
                                                          seed):
    want = torch.from_numpy(np.load(GOLDEN)[arch])
    assert torch.equal(_stage_logits(arch, param_dtype, seed), want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_existing_configs_keep_the_new_fields_at_no_change(arch):
    cfg = get_config(arch)
    assert {k: getattr(cfg, k) for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS


def test_granite_config_is_the_published_one():
    cfg = get_config(GRANITE)
    assert GRANITE not in ALL_ARCHS          # the reference has no such arch
    kinds = cfg.layer_types
    assert len(kinds) == cfg.num_layers == 40
    assert [i for i, k in enumerate(kinds) if k == "attention"] == \
        [5, 15, 25, 35]
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == \
        (4096, 32, 8, 128)
    assert (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
            cfg.ssm_head_dim, cfg.ssm_state) == (128, 64, 128)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.d_ff,
            cfg.shared_expert_ff) == (72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.attention_multiplier,
            cfg.residual_multiplier, cfg.logits_scaling) == \
        (12.0, 1 / 128, 0.22, 16.0)
    assert cfg.pos_type == "none" and cfg.tie_embeddings
    assert cfg.vocab_size == 100_352
    # every leaf but the final norm's weight
    assert cfg.param_count() == 32_207_337_984 - cfg.d_model


def test_reduced_granite_keeps_one_whole_period():
    full = get_config(GRANITE)
    assert layer_period(full.layer_types) == 10
    red = full.reduced()
    assert red.num_layers == 10 and red.layer_types == full.layer_types[:10]
    assert red.layer_types.count("attention") == 1
    two = full.reduced(num_layers=20)
    assert two.layer_types == full.layer_types[:20]
    assert ModelConfig.reduced(get_config("qwen3-moe-30b-a3b")).layer_types \
        == ()


def _granite(**kw):
    kw = dict(dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                   d_ff=32, vocab_size=128, num_experts=8,
                   experts_per_token=2, shared_expert_ff=48, ssm_state=16,
                   ssm_head_dim=16, activation_dtype="float32"), **kw)
    cfg = get_config(GRANITE).reduced(**kw)
    return cfg, tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_granite_layers_hold_their_own_mixer_and_a_shared_expert():
    cfg, params = _granite()
    for kind, lp in zip(cfg.layer_types, params["layers"]):
        assert ("mamba" in lp, "attn" in lp) == (kind == "mamba",
                                                 kind == "attention")
        assert set(lp["ffn"]["shared"]) == {"wi", "wg", "wo"}
        assert lp["ffn"]["shared"]["wi"].shape == (64, 48)


@pytest.mark.parametrize("call", ["build_model", "engine", "make_cache",
                                  "prefill", "decode_step"])
def test_kv_cache_paths_refuse_a_stack_with_mamba_layers(call):
    cfg, params = _granite()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    calls = {
        "build_model": lambda: build_model(cfg),
        "engine": lambda: ServingEngine(cfg, params, device="cpu"),
        "make_cache": lambda: tf.make_cache(cfg, 1, 8, device="cpu"),
        "prefill": lambda: tf.prefill(cfg, params, toks),
        "decode_step": lambda: tf.decode_step(
            cfg, params, toks[:, :1], {"k": None, "v": None, "index": 0}),
    }
    with pytest.raises(NotImplementedError, match="no SSM cache"):
        calls[call]()


def test_stage_functions_serve_the_mixed_stack():
    """Two stages of five layers (one all Mamba2, one with the attention
    layer) give the logits of the whole stack's forward_hidden and head,
    and a forward of a longer prefix gives the shorter one's logits at its
    last position (every layer is causal; one sequence, so the MoE
    capacity does not bind at these lengths)."""
    cfg, params = _granite(moe_capacity_factor=8.0)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 90), generator=g)
    fns = make_stage_fns(cfg, params, StagePartition.uniform(10, 5))
    with torch.inference_mode():
        payload = (toks, None)
        for fn in fns:
            payload = fn(payload)
        h = tf.forward_hidden(cfg, params, toks)
        from repro_torch.models.common import logits_head
        whole = logits_head(cfg, params["embed"], h[:, -1:])
        short = (toks[:, :70], None)
        for fn in fns:
            short = fn(short)
        full_h = tf.forward_hidden(cfg, params, toks)
    torch.testing.assert_close(payload[1], whole, rtol=0, atol=0)
    at70 = logits_head(cfg, params["embed"], full_h[:, 69:70])
    torch.testing.assert_close(short[1], at70, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [None, 1 / 128, 0.3])
def test_attention_scale_on_every_plain_route(scale):
    """K3's plain version, the direct and the chunked paths take the same
    score scale; None is 1/sqrt(D)."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 128, 4, 16, generator=g)
    k, v = (torch.randn(1, 128, 2, 16, generator=g) for _ in range(2))
    want = tattn.attention_direct(q, k, v, causal=True, scale=scale)
    got = tfa.flash_attention_plain(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    chunked = tattn.attention_chunked(q, k, v, causal=True, chunk=32,
                                      scale=scale)
    torch.testing.assert_close(chunked, want, rtol=1e-5, atol=1e-6)
    if scale is not None:
        other = tattn.attention_direct(q, k, v, causal=True)
        assert not torch.allclose(other, want)


def test_weight_casts_cover_the_mixers_and_the_shared_expert():
    """bf16 weights are the caller's own (no bytes added, as the routed
    cell runs Granite); f32 weights are cast once, the Mamba2 mixer's
    projections and conv and the shared expert's matrices among them,
    and nothing read in f32 (A_log, D, dt_bias, the norms, the router)."""
    cfg, params = _granite(param_dtype="bfloat16",
                           activation_dtype="bfloat16")
    assert cast_once_count(cfg, params) == {"leaves": 0, "bytes": 0}
    cast = cast_matmul_weights(cfg, params)
    assert cast["layers"][0]["mamba"]["in_proj"] is \
        params["layers"][0]["mamba"]["in_proj"]
    cfg32, p32 = _granite(param_dtype="float32",
                          activation_dtype="bfloat16")
    out = cast_matmul_weights(cfg32, p32)
    m, s = out["layers"][0]["mamba"], out["layers"][0]["ffn"]["shared"]
    for leaf in (m["in_proj"], m["conv_w"], m["conv_b"], m["out_proj"],
                 s["wi"], s["wg"], s["wo"], out["layers"][5]["attn"]["wq"]):
        assert leaf.dtype == torch.bfloat16
    for leaf in (m["A_log"], m["D"], m["dt_bias"],
                 out["layers"][0]["ffn"]["router"]):
        assert leaf.dtype == torch.float32
    # the caller's tree is untouched
    assert p32["layers"][0]["mamba"]["in_proj"].dtype == torch.float32


def test_granite_stage_opens_ssm_scan_and_shared_expert_spans():
    cfg, params = _granite()
    toks = torch.randint(0, cfg.vocab_size, (1, 20),
                         generator=torch.Generator().manual_seed(3))
    fns = make_stage_fns(cfg, params, StagePartition.uniform(10, 10))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fns[0]((toks, None))
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("model.ssm") == 9 and names.count("model.attn") == 1
    assert names.count("ssm.scan") == 9
    assert names.count("moe.shared") == 10 == names.count("model.ffn")
    # a config without Mamba2 layers or a shared expert opens neither
    qcfg = get_config("qwen3-moe-30b-a3b").reduced(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=128, num_experts=8, experts_per_token=2,
        activation_dtype="float32")
    qparams = tf.init_params(qcfg, torch.Generator().manual_seed(0), "cpu")
    qfns = make_stage_fns(qcfg, qparams, StagePartition.uniform(2, 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        qfns[0]((toks, None))
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"model.ssm", "ssm.scan", "moe.shared"}


def test_layer_types_must_name_every_layer():
    cfg = dataclasses.replace(get_config(GRANITE).reduced(),
                              layer_types=("mamba",) * 3)
    with pytest.raises(ValueError, match="layer_types"):
        tf.require_decoder(cfg)
