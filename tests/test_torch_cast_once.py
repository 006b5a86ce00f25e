"""The matmul weights cast to the activation dtype once, when the pipeline
server's stage functions and the KV-cache engine are built
(``models.common.cast_matmul_weights``), against the model functions on
the caller's f32 tree, which cast each weight at its matmul: the same
logits and tokens bit for bit, the other leaves shared, no bytes for a
tree already in the activation dtype, the ``cast_once`` counter, and the
casts gone from a decode step. CPU only, tiny widths, bf16 activations.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.distributed.pipeline import StagePartition
from repro_torch.models import transformer
from repro_torch.models.common import (adtype, cast_matmul_weights,
                                       logits_head)
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.gtrac_serve import (GTRACPipelineServer,
                                             make_stage_fns)

torch.set_num_threads(1)

CONFIGS = {
    # LayerNorm, GELU, GQA 4/2, untied head, RoPE
    "starcoder2": ("starcoder2-7b", dict(num_layers=4)),
    # tied head, learned positions
    "tied": ("gpt2-large", dict(num_layers=4, max_position=64)),
    # SwiGLU experts, the router kept f32
    "moe": ("qwen3-moe-30b-a3b", dict(num_layers=4, num_experts=8,
                                      experts_per_token=2, d_ff=64)),
}
#: the leaves the matmuls and row gathers read through ``.to``
LAYER_KEYS = {"attn": ("wq", "wk", "wv", "wo"), "ffn": ("wi", "wg", "wo")}
EMBED_KEYS = ("tok", "pos", "head")
B, S, STEPS = 2, 12, 3


def _leaves(tree, path=()):
    """(path, tensor) of every leaf, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _is_cast_site(path):
    if path[0] == "embed":
        return path[1] in EMBED_KEYS
    return path[0] == "layers" and path[3] in LAYER_KEYS.get(path[2], ())


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    name, kw = CONFIGS[request.param]
    cfg = get_config(name).reduced(**kw)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(4))
    return request.param, cfg, params, toks


def _engine(cfg, params):
    return ServingEngine(cfg, params, max_batch=B, device="cpu")


def check_stage_chain(case, cfg, params, toks):
    """The stage functions' chain (on the tree cast once) = the model's
    forward on the f32 tree (cast at each matmul), bit for bit."""
    fns = make_stage_fns(cfg, params, StagePartition.uniform(cfg.num_layers,
                                                             2))
    payload = (toks, None)
    for fn in fns:
        payload = fn(payload)
    with torch.inference_mode():
        x = transformer.forward_hidden(cfg, params, toks)
        want = logits_head(cfg, params["embed"], x[:, -1:, :])
    assert torch.equal(payload[1], want)


def check_engine(case, cfg, params, toks):
    """The engine's prefill and decode logits and its greedy tokens = the
    model's on the f32 tree, bit for bit."""
    eng = _engine(cfg, params)
    cap = S + STEPS + eng.margin
    with torch.inference_mode():
        got, gcache = eng._prefill(eng.params, toks, cap)
        want, wcache = eng.model.prefill(params, tokens=toks, capacity=cap)
        assert torch.equal(got, want)
        assert torch.equal(gcache["k"], wcache["k"])
        tokens = []
        for _ in range(STEPS):
            cur = torch.argmax(want[:, -1], -1)[:, None]
            tokens.append(cur[:, 0].tolist())
            got, gcache = eng._decode(eng.params, cur, gcache)
            want, wcache = eng.model.decode_step(params, cur, wcache)
            assert torch.equal(got, want)
    reqs = [eng.submit(SubmitSpec(prompt=np.asarray(t), max_new_tokens=STEPS))
            for t in toks.tolist()]
    eng.run_batch()
    assert [r.output for r in reqs] == [list(t) for t in zip(*tokens)]


def check_kept_leaves(case, cfg, params, toks):
    """Norm weights and biases and the router keep their dtype and
    storage; every cast site holds its activation-dtype copy."""
    cast = _engine(cfg, params).params
    for (path, a), (_, b) in zip(_leaves(params), _leaves(cast)):
        if _is_cast_site(path):
            assert b.dtype == adtype(cfg) and torch.equal(b, a.to(b.dtype))
            assert b.data_ptr() != a.data_ptr()
        else:
            assert b.dtype == a.dtype and b.data_ptr() == a.data_ptr()
    kept = {p[-1] for p, _ in _leaves(params) if not _is_cast_site(p)}
    assert ("bias" in kept) == (cfg.norm_type == "layernorm")
    assert ("router" in kept) == (cfg.family == "moe")


def check_no_new_bytes(case, cfg, params, toks):
    """A tree already in the activation dtype comes back with every leaf's
    storage shared, and ``cast_once`` reads 0."""
    same = _map(params, lambda t: t.to(adtype(cfg)))
    assert cast_matmul_weights(cfg, same)["embed"]["tok"] is \
        same["embed"]["tok"]
    eng = _engine(cfg, same)
    assert eng.cast_once == {"leaves": 0, "bytes": 0}
    for (_, a), (_, b) in zip(_leaves(same), _leaves(eng.params)):
        assert b.data_ptr() == a.data_ptr()


def check_counter(case, cfg, params, toks):
    """``cast_once`` on the engine and the server = the leaves and bytes
    counted from the trees (for StarCoder2's shape 6 a layer, the token
    table and the head)."""
    eng = _engine(cfg, params)
    new = [b for (_, a), (_, b) in zip(_leaves(params), _leaves(eng.params))
           if b.data_ptr() != a.data_ptr()]
    want = {"leaves": len(new),
            "bytes": sum(t.numel() * t.element_size() for t in new)}
    assert eng.cast_once == want
    if case == "starcoder2":
        assert want["leaves"] == 6 * cfg.num_layers + 2
    srv = GTRACPipelineServer(cfg, params, layers_per_stage=2,
                              replicas={"golden": 1}, seed=0, device="cpu",
                              router_backend="torch")
    assert srv.cast_once == want


def _to_copies(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name() == "aten::_to_copy"
               for e in prof.profiler.kineto_results.events())


def check_decode_casts(case, cfg, params, toks):
    """A decode step on the cast tree records one ``aten::_to_copy`` fewer
    for each cast leaf the step reads than the same step on the f32 tree:
    each layer's attention and feed-forward weights, the token rows, the
    learned positions' rows and the head (a tied head reads the token
    table again)."""
    eng = _engine(cfg, params)
    cur = toks[:, :1]
    with torch.inference_mode():
        _, cache = eng.model.prefill(params, tokens=toks, capacity=S + 4)
        counts = []
        for tree in (params, eng.params):
            c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                 "index": cache["index"]}
            counts.append(_to_copies(
                lambda: eng.model.decode_step(tree, cur, c)))
    reads = sum(k in lp[sub] for lp in params["layers"]
                for sub, keys in LAYER_KEYS.items() for k in keys)
    reads += 2 + (cfg.pos_type == "learned")
    if case == "starcoder2":
        assert reads == 6 * cfg.num_layers + 2
    assert counts[0] - counts[1] == reads


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_stage_chain, check_engine, check_kept_leaves, check_no_new_bytes,
    check_counter, check_decode_casts)}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_cast_once(model, check):
    CHECKS[check](*model)
