"""The MoE layer (``models/moe.py``): the port against the JAX reference.

Parameters come from the reference's ``init_moe`` (converted to numpy),
inputs from a numpy seed; both sides get the same arrays. On
``qwen3-moe-30b-a3b.reduced`` and ``phi3.5-moe-42b-a6.6b.reduced`` (4
experts, top-2, d_model 128):

* ``moe_capacity`` equal for every token count from 1 to 300 and several
  capacity factors;
* ``route_topk``: the selected expert sets exact, gates within 1e-6 and
  router probabilities within 1e-6 (both f32; only the summation order of
  the router matmul differs);
* ``apply_moe`` within 1e-5 absolute in f32 (the outputs are O(0.01): the
  same f32 products in another blocking), with capacity drops active at
  the default capacity factor 1.25 (the router is skewed toward expert 0,
  so its queue overflows; the test checks that tokens were dropped) and
  absent at 8.0; the gated ``silu`` branch and the plain ``gelu`` branch;
  in bf16 within 2e-2 (both round every product and the combine to bf16,
  at different places);
* ``load_balance_loss`` within 1e-6;
* the reference's dense-gather oracle (``tests/test_models_smoke.py``),
  each token's experts computed one by one, mirrored on the port within
  1e-4, as there;
* run twice, ``apply_moe`` gives equal bits (no atomics: the dispatch is a
  gather and the combine a fixed-order sum).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config
from repro.models import moe as jmoe
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import init_params, params_from_jax

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]


def _cfgs(arch, dtype="float32", **over):
    kw = dict(activation_dtype=dtype, **over)
    return (get_config(arch).reduced(**kw),
            tget_config(arch).reduced(**kw))


def _params(cfg, seed=0, skew=False):
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), cfg))
    p = {k: np.array(v) for k, v in p.items()}
    if skew:
        # every input below has a +1 mean, so this column wins for all
        p["router"][:, 0] += 0.5 / np.sqrt(cfg.d_model)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(cfg, B=2, S=37, seed=0, mean=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, cfg.d_model)) + mean).astype(
        np.float32)


def _dropped(cfg, tp, x):
    """Assignments past their expert's capacity, from the port's router."""
    T = x.shape[0] * x.shape[1]
    _, idx, _ = tmoe.route_topk(cfg, tp, torch.from_numpy(x).reshape(T, -1))
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    return int(torch.clamp(counts - tmoe.moe_capacity(cfg, T), min=0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [1.0, 1.25, 4.0, 8.0])
def test_moe_capacity_matches_reference(arch, factor):
    cfg, tcfg = _cfgs(arch, moe_capacity_factor=factor)
    full, tfull = get_config(arch), tget_config(arch)
    for T in range(1, 301):
        assert tmoe.moe_capacity(tcfg, T) == jmoe.moe_capacity(cfg, T)
        assert tmoe.moe_capacity(tfull, 37 * T) == \
            jmoe.moe_capacity(full, 37 * T)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_topk_matches_reference(arch):
    cfg, tcfg = _cfgs(arch)
    p, tp = _params(cfg, seed=1)
    xf = _x(cfg, seed=2, mean=0.0).reshape(-1, cfg.d_model)
    gates, idx, probs = jmoe.route_topk(cfg, p, jnp.asarray(xf))
    tg, ti, tpr = tmoe.route_topk(tcfg, tp, torch.from_numpy(xf))
    assert ti.shape == (xf.shape[0], cfg.experts_per_token)
    np.testing.assert_array_equal(np.sort(ti.numpy(), -1),
                                  np.sort(np.asarray(idx), -1))
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), atol=1e-6)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(probs), atol=1e-6)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor,drops", [(1.25, True), (8.0, False)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_moe_matches_reference(arch, factor, drops, act):
    cfg, tcfg = _cfgs(arch, moe_capacity_factor=factor, act=act)
    p, tp = _params(cfg, skew=True)
    assert ("wg" in tp) == (act == "silu")
    x = _x(cfg)
    assert (_dropped(tcfg, tp, x) > 0) == drops
    y, aux = jmoe.apply_moe(cfg, p, jnp.asarray(x), return_aux=True)
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x),
                              return_aux=True)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(aux), atol=1e-6)
    assert torch.equal(tmoe.apply_moe(tcfg, tp, torch.from_numpy(x)), ty)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_bf16_matches_reference(arch):
    cfg, tcfg = _cfgs(arch, dtype="bfloat16")
    p, tp = _params(cfg, seed=3)
    x = _x(cfg, seed=3, mean=0.0).astype(ml_dtypes.bfloat16)
    y = jmoe.apply_moe(cfg, p, jnp.asarray(x))
    ty = tmoe.apply_moe(tcfg, tp, torch.from_numpy(
        x.astype(np.float32)).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(y, np.float32), atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_matches_reference(arch):
    cfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((50, cfg.num_experts)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :cfg.experts_per_token].astype(np.int32)
    want = jmoe.load_balance_loss(cfg, jnp.asarray(probs), jnp.asarray(idx))
    got = tmoe.load_balance_loss(tcfg, torch.from_numpy(probs),
                                 torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_moe_matches_dense_gather_oracle(act):
    """Sorted-scatter dispatch == per-token gather-compute oracle (the
    reference's ``test_moe_matches_dense_gather_oracle``, on the port)."""
    _, tcfg = _cfgs("phi3.5-moe-42b-a6.6b", num_experts=4,
                    experts_per_token=2, moe_capacity_factor=16.0, act=act)
    tp = tmoe.init_moe(tcfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_x(tcfg, B=1, S=8, mean=0.0))
    y = tmoe.apply_moe(tcfg, tp, x)
    xf = x.reshape(-1, tcfg.d_model)
    gates, idx, _ = tmoe.route_topk(tcfg, tp, xf)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(tcfg.experts_per_token):
            e = int(idx[t, j])
            h = xf[t] @ tp["wi"][e]
            if act == "silu":
                h = F.silu(h) * (xf[t] @ tp["wg"][e])
            else:
                h = F.gelu(h, approximate="tanh")
            want[t] += gates[t, j] * (h @ tp["wo"][e])
    np.testing.assert_allclose(y.reshape(-1, tcfg.d_model).numpy(),
                               want.numpy(), atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_moe_tree(arch):
    """The reference's stacked MoE tree unstacks into one dict per layer:
    router (d, E), wi / wg (E, d, f), wo (E, f, d), bit for bit."""
    cfg = get_config(arch).reduced(vocab_size=64)
    jp = jax.tree.map(np.asarray, jbuild_model(cfg).init(
        jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, device="cpu")
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert len(tp["layers"]) == cfg.num_layers
    for i, lp in enumerate(tp["layers"]):
        ffn = lp["ffn"]
        assert set(ffn) == {"router", "wi", "wg", "wo"}
        assert ffn["router"].shape == (d, E)
        assert ffn["wi"].shape == ffn["wg"].shape == (E, d, f)
        assert ffn["wo"].shape == (E, f, d)
        for name in ffn:
            np.testing.assert_array_equal(
                ffn[name].numpy(), jp["layers"]["ffn"][name][i])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_moe_tree_in_param_dtype(arch):
    """``init_params`` makes the MoE tree in ``param_dtype``, expert
    stacks included, with the reference's shapes and scale."""
    tcfg = dataclasses.replace(tget_config(arch).reduced(vocab_size=64),
                               param_dtype="bfloat16")
    p = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [p["embed"]["tok"], p["final_norm"]["weight"]] + [
        w for lp in p["layers"] for sub in lp.values() for w in sub.values()]
    assert all(w.dtype == torch.bfloat16 for w in leaves)
    ffn = p["layers"][0]["ffn"]
    E, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert ffn["wi"].shape == (E, d, f) and ffn["wo"].shape == (E, f, d)
    assert abs(float(ffn["wi"].float().std()) - 0.02) < 2e-3
