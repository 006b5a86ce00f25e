"""Qwen2-VL (the vlm family: M-RoPE over three position streams, stub
patch embeddings prepended to the tokens) on the port, held against the
JAX reference with the reference's own parameters (``params_from_jax``)
and numpy-seeded inputs.

* ``mrope_angles`` / ``positional_angles`` within 1e-6, and the text-only
  case (a (B, S) copied to the three streams) equal to plain RoPE's.
* ``prefill`` with ``prefix_embeds`` (B, Sv, d) and (3, B, S_total)
  positions (a small image grid by Qwen2-VL's rope-index rule: t = 0,
  h = i // W, w = i % W, then text at max + 1 + j on every stream), then
  three ``decode_step``s with continued (3, B, 1) positions: logits and
  caches within 2e-5 (f32) / 2e-2 (bf16), for ``attn_impl`` xla and flash
  (the reference's flash path on the Pallas kernel in interpret mode).
  The same through both packages' model API, whose ``decode_step`` takes
  the position from the cache's index.
* The engine's greedy tokens (text only) and ``run_queue``'s tokens and
  every ServeMetrics field identical to the reference's on
  ``qwen2-vl-7b.reduced(num_layers=4)``; the serve CLI's gtrac mode.
* The full config: a verbatim copy, ``param_count`` (7.62 B) and the
  parameter tree (shapes and dtypes, made on the ``meta`` device) equal to
  the reference's ``jax.eval_shape`` of its ``init``; ``cache_bytes``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import GTRACConfig
from repro.distributed.pipeline import StagePartition
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild_model
from repro.serving.api import SubmitSpec as JSubmitSpec
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.gtrac_serve import GTRACPipelineServer, make_stage_fns
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import rope as trope
from repro_torch.models import transformer as ttf
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.gtrac_serve import \
    GTRACPipelineServer as TGTRACPipelineServer
from repro_torch.serving.kv_cache import cache_bytes

from _trees import param_shapes

torch.set_num_threads(1)

ARCH = "qwen2-vl-7b"
REDUCED = dict(vocab_size=128, remat=False)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _cfgs(act="float32", impl="xla", **over):
    kw = dict(REDUCED, **over)
    cfg = dataclasses.replace(get_config(ARCH).reduced(**kw),
                              activation_dtype=act)
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(**kw),
                               activation_dtype=act, attn_impl=impl)
    return cfg, tcfg


@pytest.fixture(scope="module")
def jparams():
    cfg = get_config(ARCH).reduced(**REDUCED)
    params = jbuild_model(cfg).init(jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, params)


def image_positions(B, grid, text):
    """(3, B, Sv + text) positions by Qwen2-VL's rope-index rule for one
    image of ``grid`` = (H, W) merged patches followed by ``text``
    tokens."""
    H, W = grid
    i = np.arange(H * W)
    img = np.stack([np.zeros_like(i), i // W, i % W])
    txt = img.max() + 1 + np.arange(text)
    pos = np.concatenate([img, np.broadcast_to(txt, (3, text))], axis=1)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).copy()


def _inputs(B, grid, text, d, act, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 128, size=(B, text))
    pe = rng.standard_normal((B, grid[0] * grid[1], d)).astype(np.float32)
    if act == "bfloat16":   # round once, hand both sides the same bits
        pe = pe.astype(ml_dtypes.bfloat16).astype(np.float32)
    return toks, pe, image_positions(B, grid, text)


def test_config_is_a_verbatim_copy():
    assert dataclasses.asdict(tget_config(ARCH)) == \
        dataclasses.asdict(get_config(ARCH))
    assert tget_config(ARCH).param_count() == get_config(ARCH).param_count()
    assert tget_config(ARCH).param_count() == 7_615_483_904


def test_full_param_tree_matches_reference():
    """The full-width tree, shapes and dtypes, allocated nowhere: the
    port's ``init`` on the meta device against the reference's
    ``jax.eval_shape``."""
    cfg, tcfg = get_config(ARCH), tget_config(ARCH)
    want = param_shapes(jax.eval_shape(lambda: jbuild_model(cfg).init(
        jax.random.PRNGKey(0))))
    got = param_shapes(tapi.build_model(tcfg).init(torch.Generator(),
                                                   "meta"))
    assert got == want
    # param_count leaves out the final norm's d weights
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == cfg.param_count() + cfg.d_model


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (32, (8, 4, 4)),
                                               (128, (0, 0, 64))])
def test_mrope_angles_match_reference(head_dim, sections):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 5000, size=(3, 2, 33))
    want = jrope.mrope_angles(jnp.asarray(pos, jnp.int32), head_dim, 1e6,
                              sections)
    got = trope.mrope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert got.dtype == torch.float32 and \
        got.shape == (2, 33, head_dim // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(AssertionError):
        trope.mrope_angles(torch.from_numpy(pos), head_dim, 1e6, (8, 8, 8))


def test_positional_angles_match_reference_and_degenerate_to_rope():
    cfg, tcfg = _cfgs()
    pos3 = image_positions(2, (2, 4), 9)
    for pos in (pos3, pos3[0]):          # three streams; text only (B, S)
        want = jrope.positional_angles(cfg, jnp.asarray(pos, jnp.int32))
        got = trope.positional_angles(tcfg, torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    text = torch.from_numpy(pos3[0])
    rope = dataclasses.replace(tcfg, pos_type="rope")
    assert torch.equal(trope.positional_angles(tcfg, text),
                       trope.positional_angles(rope, text))


def _interpret_flash(monkeypatch):
    """The reference's flash path on its Pallas kernel, interpret mode."""
    monkeypatch.setattr(jattn, "attention_flash",
                        lambda q, k, v, *, causal: jflash(
                            q, k, v, causal=causal, interpret=True))


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_with_image_and_decode_match_reference(jparams, monkeypatch,
                                                       act, impl):
    """An image prefix of 2 x 4 patches and 9 text tokens (S_total = 17),
    then three decode steps at continued positions (12, 13, 14 on every
    stream)."""
    if impl == "flash":
        _interpret_flash(monkeypatch)
    cfg, tcfg = _cfgs(act, impl)
    tp = params_from_jax(jparams, device="cpu")
    B, grid, text = 2, (2, 4), 9
    toks, pe, pos = _inputs(B, grid, text, cfg.d_model, act)
    jl, jc = jtf.prefill(cfg, jparams, jnp.asarray(toks, jnp.int32),
                         positions=jnp.asarray(pos, jnp.int32),
                         prefix_embeds=jnp.asarray(pe), capacity=24)
    with torch.inference_mode():
        tl, tc = ttf.prefill(tcfg, tp, torch.from_numpy(toks),
                             positions=torch.from_numpy(pos),
                             prefix_embeds=torch.from_numpy(pe),
                             capacity=24)
    assert tc["index"] == int(jc["index"]) == 17
    assert tc["k"].shape == (tcfg.num_layers, B, 24, tcfg.num_kv_heads,
                             tcfg.head_dim)
    tol = TOL[act]
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=tol)
    cur = np.array([[3], [77]])
    nxt = int(pos.max()) + 1
    for step in range(3):
        p3 = np.full((3, B, 1), nxt + step)
        jl, jc = jtf.decode_step(cfg, jparams, jnp.asarray(cur, jnp.int32),
                                 jc, positions=jnp.asarray(p3, jnp.int32))
        with torch.inference_mode():
            tl, tc = ttf.decode_step(tcfg, tp, torch.from_numpy(cur), tc,
                                     positions=torch.from_numpy(p3))
        assert tc["index"] == int(jc["index"]) == 18 + step
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol,
                                   err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       atol=tol, err_msg=f"step {step}")
        cur = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def test_model_api_image_prefill_and_greedy_decode(jparams):
    """Through both model APIs: prefill(tokens, prefix_embeds, positions),
    then greedy decode_steps, which take their position from the cache's
    index (the reference's ``Model.decode_step`` forwards no positions):
    the same tokens, logits within 2e-5."""
    cfg, tcfg = _cfgs()
    tp = params_from_jax(jparams, device="cpu")
    toks, pe, pos = _inputs(2, (2, 4), 9, cfg.d_model, "float32", seed=2)
    jm, tm = jbuild_model(cfg), tapi.build_model(tcfg)
    jl, jc = jm.prefill(jparams, tokens=jnp.asarray(toks, jnp.int32),
                        prefix_embeds=jnp.asarray(pe),
                        positions=jnp.asarray(pos, jnp.int32), capacity=24)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, tokens=torch.from_numpy(toks),
                            prefix_embeds=torch.from_numpy(pe),
                            positions=torch.from_numpy(pos), capacity=24)
        jtoks, ttoks = [], []
        for _ in range(5):
            np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL["float32"])
            jcur = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
            tcur = torch.argmax(tl[:, -1], dim=-1)[:, None]
            jtoks.append(np.asarray(jcur)[:, 0].tolist())
            ttoks.append(tcur[:, 0].tolist())
            jl, jc = jm.decode_step(jparams, jcur, jc)
            tl, tc = tm.decode_step(tp, tcur, tc)
    assert ttoks == jtoks and tc["index"] == int(jc["index"]) == 22


def _queue(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 128, size=n), m)
            for n, m in ((6, 5), (9, 4), (6, 3), (9, 5), (6, 5))]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_greedy_tokens_match_reference(jparams, impl):
    """Text through the engine: positions 0..S-1 copied to the three
    M-RoPE streams in both packages."""
    cfg, tcfg = _cfgs(impl=impl)
    jeng = JServingEngine(cfg, jparams, max_batch=3)
    teng = ServingEngine(tcfg, params_from_jax(jparams, device="cpu"),
                         max_batch=3, device="cpu")
    for prompt, m in _queue():
        jeng.submit(JSubmitSpec(prompt=prompt, max_new_tokens=m))
        teng.submit(SubmitSpec(prompt=prompt, max_new_tokens=m))
    want = [(r.request_id, r.output) for r in jeng.run_batch()]
    got = [(r.request_id, r.output) for r in teng.run_batch()]
    assert got == want and [len(o) for _, o in got] == [5, 4, 3, 5, 5]


def test_run_queue_matches_reference():
    """The pipeline server on qwen2-vl-7b.reduced(num_layers=4): each
    stage builds text-only M-RoPE angles, as the reference's; tokens and
    every ServeMetrics field identical."""
    over = dict(num_layers=4, vocab_size=128, remat=False,
                activation_dtype="float32")
    cfg = get_config(ARCH).reduced(**over)
    params = jbuild_model(cfg).init(jax.random.PRNGKey(7))
    tparams = params_from_jax(jax.tree.map(np.asarray, params),
                              device="cpu")
    gkw = dict(disaggregate=True, prefill_chunk_tokens=16)
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=2,
                              gcfg=GTRACConfig(**gkw), seed=0)
    srv.stage_fns = make_stage_fns(cfg, params, StagePartition.uniform(4, 2))
    srv.router.backend = "jnp"
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(**over),
                               attn_impl="flash")
    tsrv = TGTRACPipelineServer(tcfg, tparams, layers_per_stage=2,
                                gcfg=TGTRACConfig(**gkw), seed=0,
                                device="cpu", router_backend="kernel")
    rng = np.random.default_rng(0)
    for n in (8, 8, 40, 8):
        p = rng.integers(1, 128, size=n)
        srv.submit(JSubmitSpec(prompt=p, max_new_tokens=5))
        tsrv.submit(SubmitSpec(prompt=p, max_new_tokens=5))
    done, tdone = srv.run_queue(), tsrv.run_queue()
    assert [r.request_id for r in tdone] == [r.request_id for r in done]
    for a, b in zip(tdone, done):
        assert a.output == b.output, a.request_id
        assert dataclasses.asdict(a.metrics) == dataclasses.asdict(b.metrics)
    assert vars(tsrv.router.stats) == vars(srv.router.stats)
    assert sum(r.metrics.tokens for r in tdone) > 0


def test_cache_bytes_matches_reference():
    for cfg, tcfg in ((get_config(ARCH), tget_config(ARCH)),
                      (get_config(ARCH).reduced(),
                       tget_config(ARCH).reduced())):
        for batch, cap in ((4, 2144), (1, 5)):
            assert cache_bytes(tcfg, batch, cap) == \
                jcache_bytes(cfg, batch, cap)


def test_serve_gtrac_mode_serves_vlm(capsys):
    tserve.main(["--mode", "gtrac", "--device", "cpu", "--reduced",
                 "--arch", ARCH, "--windowed", "--tokens", "3",
                 "--requests", "2", "--attn-impl", "flash"])
    out = capsys.readouterr().out
    assert "SSR:" in out and "windows:" in out
    assert "flash_attention" in out
