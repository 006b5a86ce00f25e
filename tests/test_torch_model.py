"""GPT-2 stage compute: the port against the JAX reference.

The reference's parameters (``model.init``, converted to numpy) go through
``params_from_jax`` into the port; the same prompt goes to both sides.
Tolerances, absolute on logits and hidden states:

* f32 activations: 1e-4 — both sides compute in f32; only summation order
  differs (matmul blocking, reductions).
* bf16 activations: 3e-2 — both sides round every matmul and residual to
  bf16 (8 bits of mantissa) but at different places inside XLA's and
  PyTorch's kernels; over 4 layers the logits (std ~0.3 here) drift by a few
  bf16 ulps.

Both ``attn_impl`` values are covered: ``xla`` (plain attention) and
``flash`` (kernel K3's dispatch, which on CPU tensors runs its plain
version; the reference runs its jnp oracle off-TPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.distributed.pipeline import StagePartition
from repro.models.api import build_model
from repro.models.common import logits_head as jlogits_head
from repro.models.transformer import forward_hidden as jforward_hidden
from repro.serving.gtrac_serve import make_stage_fns as jmake_stage_fns
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed.pipeline import StagePartition as TStagePartition
from repro_torch.models.common import logits_head
from repro_torch.models.transformer import (forward_hidden, init_params,
                                            params_from_jax)
from repro_torch.serving.gtrac_serve import make_stage_fns

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
REDUCED = dict(num_layers=4, vocab_size=128, remat=False)


@pytest.fixture(scope="module")
def ref_params():
    cfg = get_config("gpt2-large").reduced(**REDUCED)
    params = build_model(cfg).init(jax.random.PRNGKey(7))
    return jax.tree.map(np.asarray, params)


def _cfgs(act, impl):
    cfg = dataclasses.replace(get_config("gpt2-large").reduced(**REDUCED),
                              activation_dtype=act, attn_impl=impl)
    tcfg = dataclasses.replace(tget_config("gpt2-large").reduced(**REDUCED),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


def _tokens(n=12, seed=0):
    return np.random.default_rng(seed).integers(1, 128, size=(1, n))


def test_reduced_config_is_gqa_4_over_2():
    _, tcfg = _cfgs("float32", "xla")
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim) == (4, 2, 32)


def test_params_from_jax_round_trip(ref_params):
    tp = params_from_jax(ref_params)
    assert len(tp["layers"]) == 4
    back = {k: np.stack([lp[k1][k2].numpy() for lp in tp["layers"]])
            for k, (k1, k2) in {"wq": ("attn", "wq"),
                                "wi": ("ffn", "wi"),
                                "n1": ("norm1", "bias")}.items()}
    np.testing.assert_array_equal(back["wq"],
                                  ref_params["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(back["wi"],
                                  ref_params["layers"]["ffn"]["wi"])
    np.testing.assert_array_equal(back["n1"],
                                  ref_params["layers"]["norm1"]["bias"])
    for k in ("tok", "pos"):
        np.testing.assert_array_equal(tp["embed"][k].numpy(),
                                      ref_params["embed"][k])
    np.testing.assert_array_equal(tp["final_norm"]["weight"].numpy(),
                                  ref_params["final_norm"]["weight"])


def test_init_params_distributions():
    _, tcfg = _cfgs("float32", "xla")
    p = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    wq = p["layers"][0]["attn"]["wq"]
    assert wq.shape == (tcfg.d_model, tcfg.num_heads * tcfg.head_dim)
    assert abs(float(wq.std()) - 0.02) < 2e-3
    assert torch.equal(p["final_norm"]["weight"], torch.ones(tcfg.d_model))
    assert torch.equal(p["layers"][3]["norm2"]["bias"],
                       torch.zeros(tcfg.d_model))
    assert "head" not in p["embed"]             # tied head


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_reference(ref_params, act, impl):
    cfg, tcfg = _cfgs(act, impl)
    toks = _tokens()
    x, _, _ = jforward_hidden(cfg, ref_params, jnp.asarray(toks, jnp.int32))
    want = np.asarray(jlogits_head(cfg, ref_params["embed"], x), np.float32)
    tp = params_from_jax(ref_params)
    with torch.inference_mode():
        h = forward_hidden(tcfg, tp, torch.as_tensor(toks))
        got = logits_head(tcfg, tp["embed"], h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[act])


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_stage_fns_match_reference(ref_params, act, impl):
    cfg, tcfg = _cfgs(act, impl)
    toks = _tokens(9, seed=1)
    jfns = jmake_stage_fns(cfg, ref_params, StagePartition.uniform(4, 2))
    tfns = make_stage_fns(tcfg, params_from_jax(ref_params),
                          TStagePartition.uniform(4, 2))
    assert len(jfns) == len(tfns) == 2
    jp = (jnp.asarray(toks, jnp.int32), None)
    tpay = (torch.as_tensor(toks), None)
    for jf, tf in zip(jfns, tfns):
        jp, tpay = jf(jp), tf(tpay)
        np.testing.assert_allclose(tpay[1].float().numpy(),
                                   np.asarray(jp[1], np.float32),
                                   atol=TOL[act])
    assert tpay[1].shape == (1, 1, 128)         # last position's logits
