"""The port's wall spans (``obs.trace.wall``): the spans the model, the
routed window loop and the engine open, which a torch profiler records as
``record_function`` ranges, the window loop's stage counters, and what
tracing off costs (no span or range made, no clock read). CPU only, tiny
widths, a CPU profiler.
"""
import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.base import GTRACConfig
from repro_torch.models.api import build_model
from repro_torch.obs import trace
from repro_torch.serving import gtrac_serve
from repro_torch.serving.api import SubmitSpec
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

DENSE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=128, remat=False,
             activation_dtype="float32")
MOE = dict(DENSE, num_experts=8, experts_per_token=2, d_ff=32)
MOE_SPANS = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
PROGRAM = ("model.", "moe.", "loop.", "route.", "engine.")


def _model(name, kw):
    cfg = get_config(name).reduced(**kw)
    return cfg, build_model(cfg).init(torch.Generator().manual_seed(0),
                                      "cpu")


@pytest.fixture(scope="module")
def dense():
    return _model("tinyllama-1.1b", DENSE)


@pytest.fixture(scope="module")
def moe():
    return _model("qwen3-moe-30b-a3b", MOE)


def _profiled(fn):
    """The program's spans that a CPU profiler recorded over ``fn()``, as
    a forest in start order: each node's ``name``, ``path`` from its root
    and ``kids`` (their names, in order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(PROGRAM)),
                    key=lambda x: (x[0], -x[1]))
    nodes, stack = [], []
    for s, e, name in ranges:
        while stack and stack[-1]["end"] <= s:
            stack.pop()
        parent = stack[-1] if stack else None
        node = {"name": name, "end": e, "kids": [], "root": parent is None,
                "path": f"{parent['path']}/{name}" if parent else name}
        if parent is not None:
            parent["kids"].append(name)
        nodes.append(node)
        stack.append(node)
    return nodes


def _server(cfg, params, **gkw):
    """One golden peer a stage: every hop succeeds and routes alike."""
    return gtrac_serve.GTRACPipelineServer(
        cfg, params, layers_per_stage=2, replicas={"golden": 1},
        gcfg=GTRACConfig(prefill_chunk_tokens=8, disaggregate=True, **gkw),
        seed=0, device="cpu", router_backend="torch")


def _two_streams(srv):
    """A 20-token prompt prefilled in chunks of 8, 8 and 4, and a 5-token
    prompt prefilled inline by its first decode step; 3 tokens each."""
    for n in (20, 5):
        srv.submit(SubmitSpec(prompt=np.arange(1, n + 1), max_new_tokens=3))


def test_routed_window_span_tree(dense):
    cfg, params = dense
    srv = _server(cfg, params)
    _two_streams(srv)
    served = []
    nodes = _profiled(lambda: served.extend(srv.run_queue()))
    assert [len(r.output) for r in served] == [3, 3]
    paths = collections.Counter(n["path"] for n in nodes)
    windows = paths["loop.window"]
    assert windows > 0
    assert set(paths) == {
        "loop.window", "loop.window/loop.admit",
        "loop.window/loop.admit/loop.emit", "loop.window/loop.view",
        "loop.window/loop.route", "loop.window/loop.route/route.readback",
        "loop.window/model.stage", "loop.window/model.stage/model.embed",
        "loop.window/model.stage/model.attn",
        "loop.window/model.stage/model.ffn",
        "loop.window/model.stage/model.head", "loop.window/loop.trust",
        "loop.window/loop.readback", "loop.window/loop.emit"}
    assert paths["loop.window/loop.admit"] == windows
    # 8 chain executions (3 chunks + 2 decode steps, 3 decode steps), each
    # trust-folded; 2 stages of 2 layers a chain
    assert paths["loop.window/loop.trust"] == 8
    assert paths["loop.window/model.stage"] == 16
    assert paths["loop.window/model.stage/model.embed"] == 8
    assert paths["loop.window/model.stage/model.head"] == 8
    # the first token of the chunked stream is read back from its last
    # chunk and emitted at its promotion; 5 more tokens are read and
    # emitted in decode windows
    assert paths["loop.window/loop.readback"] == 6
    assert paths["loop.window/loop.emit"] + \
        paths["loop.window/loop.admit/loop.emit"] == 6 + 2   # + 2 finishes
    stages = [n["kids"] for n in nodes if n["name"] == "model.stage"]
    for first, last in zip(stages[::2], stages[1::2]):    # one chain each
        assert first == ["model.embed"] + ["model.attn", "model.ffn"] * 2
        assert last == ["model.attn", "model.ffn"] * 2 + ["model.head"]


def test_moe_stage_has_four_moe_spans_per_layer(moe):
    cfg, params = moe
    fns = gtrac_serve.make_stage_fns(
        cfg, params, gtrac_serve.StagePartition.uniform(cfg.num_layers, 2))
    toks = torch.arange(1, 13)[None, :]
    nodes = _profiled(lambda: fns[1](fns[0]((toks, None))))
    assert [n["name"] for n in nodes if n["root"]] == ["model.stage"] * 2
    ffns = [n for n in nodes if n["name"] == "model.ffn"]
    assert len(ffns) == cfg.num_layers
    for f in ffns:
        assert f["kids"] == MOE_SPANS
    assert collections.Counter(n["name"] for n in nodes)[
        "moe.experts"] == cfg.num_layers


def test_engine_prefill_and_decode_span_tree(dense):
    cfg, params = dense
    eng = ServingEngine(cfg, params, max_batch=2, device="cpu")
    for _ in range(2):
        eng.submit(SubmitSpec(prompt=np.arange(1, 7), max_new_tokens=3))
    nodes = _profiled(eng.run_batch)
    roots = [n for n in nodes if n["root"]]
    # the prefill's logits give the first token, two decode steps the rest
    assert [n["name"] for n in roots] == [
        "model.prefill", "engine.sample", "engine.readback",
        "model.decode", "engine.sample", "engine.readback",
        "model.decode", "engine.sample", "engine.readback"]
    layers = ["model.attn", "model.ffn"] * cfg.num_layers
    for n in roots:
        if n["name"].startswith("model."):
            assert n["kids"] == ["model.embed"] + layers + ["model.head"]
        else:
            assert n["kids"] == []


def test_stage_counters_hand_computed(dense):
    """Each hop runs 2 stages of 2 layers on a (1, prefix) payload. The
    chunked stream: chunks to 8, 16, 20 (fresh 8, 8, 4), then decode
    steps at prefixes 21, 22 (fresh 1 each, its chain warm). The inline
    stream: decode steps at 5 (fresh 5: nothing warm), 6 and 7 (fresh
    1). positions = 2 stages x 2 layers x (8+16+20+21+22 + 5+6+7),
    fresh = 2 x 2 x (8+8+4+1+1 + 5+1+1)."""
    cfg, params = dense
    srv = _server(cfg, params)
    # the newest server's counters, for a reader with no handle on it
    assert gtrac_serve.last_stage_stats() is srv.stage_stats
    _two_streams(srv)
    srv.run_queue()
    want = {"forwards": 16,
            "positions": 4 * (8 + 16 + 20 + 21 + 22 + 5 + 6 + 7),
            "fresh": 4 * (8 + 8 + 4 + 1 + 1 + 5 + 1 + 1)}
    snap = srv.obs.snapshot()
    assert {k: snap[f"stage/{k}"] for k in want} == want
    assert vars(gtrac_serve.last_stage_stats()) == want


def test_tracing_off_allocates_no_span_and_reads_no_clock(dense,
                                                          monkeypatch):
    cfg, params = dense
    assert trace.wall() is trace.NOOP_TRACER
    made, reads = [], []
    init0, clock0 = trace.Span.__init__, time.perf_counter

    def span_init(self, *a, **kw):
        made.append(a)
        init0(self, *a, **kw)

    def clock():
        reads.append(1)
        return clock0()

    def ranges(name):
        made.append(name)
        return trace.NOOP_SPAN

    fns = gtrac_serve.make_stage_fns(
        cfg, params, gtrac_serve.StagePartition.uniform(cfg.num_layers, 2))
    model = build_model(cfg)
    toks = torch.arange(1, 9)[None, :]
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens=toks, capacity=12)
    monkeypatch.setattr(trace.Span, "__init__", span_init)
    monkeypatch.setattr(trace, "record_function", ranges)
    monkeypatch.setattr(time, "perf_counter", clock)
    fns[1](fns[0]((toks, None)))
    with torch.inference_mode():
        model.decode_step(params, toks[:, -1:], cache)
    monkeypatch.undo()
    assert made == [] and reads == []


def test_profiler_records_the_spans_by_name(dense):
    """While a torch profiler records, every wall site's tracer is the
    profiler ranges and each span is a range of its name; after the
    profiler stops, the sites are back on the no-op tracer."""
    cfg, params = dense
    fns = gtrac_serve.make_stage_fns(
        cfg, params, gtrac_serve.StagePartition.uniform(cfg.num_layers, 2))
    toks = torch.arange(1, 9)[None, :]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.wall() is trace.PROFILER_RANGES
        fns[1](fns[0]((toks, None)))
    assert trace.wall() is trace.NOOP_TRACER
    counts = collections.Counter(e.name for e in prof.events())
    assert {"model.stage", "model.embed", "model.attn", "model.ffn",
            "model.head"} <= set(counts)
    assert counts["model.stage"] == 2
    assert counts["model.attn"] == counts["model.ffn"] == cfg.num_layers
