"""Trace export and critical-path reports: the port's ``obs/export.py`` and
``obs/report.py`` against the JAX package's reference modules, and the
traced slice end to end.

The same spans, recorded by each package's tracer on the same injected
clocks, export to the SAME bytes (JSONL and Chrome trace events), and the
validator finds the same errors in the same corrupted files; every report
function (``ttft_breakdown``, ``itl_breakdown``, ``plan_wall_summary``,
``top_spans``, ``format_report``) returns what the reference's returns.
The RPC span trees on ``FakeClock`` (cross-process worker stamps
included) and the executors' failover and hedge markers are exact. A
traced ``run_queue`` with hedging records the reference's sim-domain spans
and TTFT decomposition, each request's components summing to its measured
TTFT within 1e-6 ms; and the serve CLI with hedging, the process control
plane and ``--trace`` prints the reference CLI's summary lines.
"""
import dataclasses
import json
import re

import pytest
import torch

from repro import control_plane as jcp
from repro.configs.base import GTRACConfig
from repro.control_plane import registry as jcp_registry
from repro.core.executor import ChainExecutor
from repro.core.hedging import HedgedChainExecutor
from repro.core.registry import AnchorRegistry
from repro.launch import serve as jserve
from repro.obs import export as jexport
from repro.obs import report as jreport
from repro.obs.trace import TraceBuffer, Tracer
from repro.serving.api import SubmitSpec
from repro_torch import control_plane as tcp
from repro_torch.configs.base import GTRACConfig as TGTRACConfig
from repro_torch.core.executor import ChainExecutor as TChainExecutor
from repro_torch.core.hedging import \
    HedgedChainExecutor as THedgedChainExecutor
from repro_torch.core.registry import AnchorRegistry as TAnchorRegistry
from repro_torch.launch import serve as tserve
from repro_torch.obs import export as texport
from repro_torch.obs import report as treport
from repro_torch.obs.trace import TraceBuffer as TTraceBuffer
from repro_torch.obs.trace import Tracer as TTracer
from repro_torch.serving.api import SubmitSpec as TSubmitSpec

from test_torch_serving import (_prompts, _servers,  # noqa: F401
                                models)

torch.set_num_threads(1)

REF = dict(Tracer=Tracer, TraceBuffer=TraceBuffer, export=jexport,
           report=jreport)
PORT = dict(Tracer=TTracer, TraceBuffer=TTraceBuffer, export=texport,
            report=treport)
SIDES = (("ref", REF), ("port", PORT))
REPORTS = ("ttft_breakdown", "itl_breakdown", "plan_wall_summary",
           "top_spans", "format_report")


def _demo_buffer(pkg):
    """The reference test's buffer: a request, its first decode step, and
    an rpc-domain collect on a second clock."""
    st = {"t": 0.0}
    tr = pkg["Tracer"](pkg["TraceBuffer"](), clock=lambda: st["t"],
                       domain="serve")
    req = tr.begin("request", cat="request", t0=0.0, rid=1)
    tr.add("decode.step", 0.0, 0.25, cat="decode", parent=req, rid=1,
           emitted=True, first_token=True)
    tr.scope("rpc", clock=lambda: 9.0).end(
        tr.scope("rpc").begin("rpc.collect", cat="rpc", t0=9.0), t1=9.5)
    tr.add("route.plan", 0.1, 0.1, cat="route", wall_us=812.5,
           cache_hit=False)
    st["t"] = 0.25
    tr.end(req, ttft_ms=250.0)
    return tr.sink


def _report_buffer(pkg):
    """The reference's ``TestReport`` spans: queue wait, a prefill chunk
    with a hop, a stall, a first decode step with a failed and a good hop,
    then a steady decode step carrying window drag."""
    tr = pkg["Tracer"](pkg["TraceBuffer"](), clock=lambda: 0.0,
                       domain="serve")
    req = tr.begin("request", cat="request", t0=0.0, rid=5)
    tr.add("queue.wait", 0.0, 0.1, cat="serve", parent=req)
    c = tr.add("prefill.chunk", 0.1, 0.3, cat="prefill", parent=req,
               ok=True)
    tr.add("hop", 0.1, 0.3, cat="exec", parent=c, peer=1, ok=True)
    tr.add("prefill.stall", 0.3, 0.35, cat="prefill", parent=req)
    s = tr.add("decode.step", 0.35, 0.5, cat="decode", parent=req, rid=5,
               emitted=True, first_token=True, drag_ms=100.0)
    tr.add("hop", 0.35, 0.45, cat="exec", parent=s, peer=2, ok=False)
    tr.add("hop", 0.45, 0.5, cat="exec", parent=s, peer=3, ok=True)
    tr.add("decode.step", 0.6, 0.65, cat="decode", parent=req, rid=5,
           emitted=True, first_token=False, drag_ms=0.0)
    tr.end(req, t1=0.65, ttft_ms=500.0, stale_rounds_max=2)
    return tr.sink


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
def test_export_bytes_match_reference(tmp_path, fmt):
    """The same spans export to the same bytes; JSONL round-trips through
    ``load_jsonl`` and validates clean."""
    files = {}
    for side, pkg in SIDES:
        path = tmp_path / f"{side}.{fmt}"
        fn = getattr(pkg["export"], f"export_{fmt}")
        assert fn(_demo_buffer(pkg), str(path)) == 4
        files[side] = path.read_bytes()
    assert files["port"] == files["ref"]
    if fmt == "jsonl":
        path = str(tmp_path / "port.jsonl")
        assert texport.validate_jsonl(path) == (4, [])
        rows = texport.load_jsonl(path)
        assert rows == jexport.load_jsonl(str(tmp_path / "ref.jsonl"))
        by_name = {r["name"]: r for r in rows}
        assert by_name["decode.step"]["parent"] == by_name["request"]["id"]
        assert by_name["rpc.collect"]["domain"] == "rpc"
    else:
        doc = json.loads(files["port"])
        assert len({e["pid"] for e in doc["traceEvents"]
                    if e["ph"] == "X"}) == 2      # serve + rpc domains


@pytest.mark.parametrize("corruption", ["negative_duration", "missing_key",
                                        "bad_type", "duplicate_id",
                                        "bad_dur", "unparseable"])
def test_validator_findings_match_reference(tmp_path, corruption):
    """One corruption at a time: the port's validator reports the same
    span count and the same error lines as the reference's."""
    path = tmp_path / "t.jsonl"
    texport.export_jsonl(_demo_buffer(PORT), str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    lines = [json.dumps(r) for r in rows]
    if corruption == "negative_duration":
        rows[0]["t1"] = rows[0]["t0"] - 1.0
    elif corruption == "missing_key":
        del rows[1]["name"]
    elif corruption == "bad_type":
        rows[2]["attrs"] = []
    elif corruption == "duplicate_id":
        rows[3]["id"] = rows[0]["id"]
    elif corruption == "bad_dur":
        rows[1]["dur_ms"] += 1.0
    lines = [json.dumps(r) for r in rows]
    if corruption == "unparseable":
        lines[2] = lines[2][:-3]
    path.write_text("\n".join(lines) + "\n\n")
    got = texport.validate_jsonl(str(path))
    assert got == jexport.validate_jsonl(str(path))
    assert got[1], corruption


@pytest.mark.parametrize("buffer", ["demo", "report"])
def test_report_functions_match_reference(buffer):
    """Every report function over the same spans, as span objects and as
    exported dicts: equal to the reference's output."""
    make = _demo_buffer if buffer == "demo" else _report_buffer
    bufs = {side: make(pkg) for side, pkg in SIDES}
    for name in REPORTS:
        got = getattr(treport, name)(bufs["port"])
        assert got == getattr(jreport, name)(bufs["ref"]), name
        dicts = [texport.span_dict(s) for s in bufs["port"].sorted_spans()]
        assert getattr(treport, name)(dicts) == got, name
    if buffer == "report":
        (row,) = treport.ttft_breakdown(bufs["port"])
        assert row["failover_ms"] == pytest.approx(100.0)
        assert row["ttft_sum_ms"] == pytest.approx(row["measured_ttft_ms"])
        itl = treport.itl_breakdown(bufs["port"])
        assert itl["n"] == 1 and itl["itl_p50_ms"] == pytest.approx(150.0)


# ---------------------------------------------------------------------------
# Exact span trees: rpc on FakeClock, executor markers
# ---------------------------------------------------------------------------


def _rpc_trace(cp, tracer_cls, buffer_cls, cfg, mute):
    class Drop(cp.LoopbackTransport):
        def __init__(self, host):
            super().__init__(host)
            self.mute, self.drop_next = False, 0

        def post(self, msg):
            if self.mute:
                return
            super().post(msg)
            if self.drop_next > 0 and self._out:
                self._out.pop()
                self.drop_next -= 1

    clock = cp.FakeClock()
    ticks = iter([10.0, 10.007])
    tr = Drop(cp.ShardHost(cfg, 0, svc_clock=lambda: next(ticks)))
    ch = cp.RpcChannel(tr, cp.RpcPolicy(timeout_s=1.0, retries=2,
                                        backoff_base_s=0.05,
                                        backoff_factor=2.0), clock)
    ch.tracer = tracer_cls(buffer_cls(), clock=clock.monotonic,
                           domain="rpc")
    if mute:
        tr.mute = True
        with pytest.raises(cp.RpcTimeout):
            ch.request("ping")
    else:
        tr.drop_next = 1
        ch.request("register", 7, 0, 2, 0.0, "", None, None, 0, None)
    return [(s.span_id, s.parent_id, s.name, s.cat, s.domain, s.t0, s.t1,
             s.attrs) for s in ch.tracer.sink.spans]


@pytest.mark.parametrize("mute", [False, True], ids=["retry", "timeout"])
def test_rpc_span_tree_matches_reference(mute):
    """A lost reply answered from the worker's dedup cache (with the
    original cross-process worker stamp), and timeout exhaustion: the
    same span ids, parents, names, FakeClock intervals and attributes."""
    ref = _rpc_trace(jcp, Tracer, TraceBuffer, GTRACConfig(), mute)
    port = _rpc_trace(tcp, TTracer, TTraceBuffer, TGTRACConfig(), mute)
    assert port == ref
    names = [s[2] for s in port]
    if mute:
        assert names == ["rpc.attempt", "rpc.backoff", "rpc.attempt",
                         "rpc.backoff", "rpc.attempt", "rpc.collect"]
    else:
        assert names == ["rpc.attempt", "rpc.backoff", "rpc.attempt",
                         "rpc.worker", "rpc.collect"]
        assert port[3][6] - port[3][5] == pytest.approx(0.007)


def _stage_table(anchor_cls, cfg, latencies):
    a = anchor_cls(cfg)
    for pid, lat in enumerate(latencies):
        a.register(pid, 0, 3, now=0.0, latency_ms=lat)
        a.heartbeat(pid, 0.0)
    a.register(99, 3, 6, now=0.0, latency_ms=50.0)
    a.heartbeat(99, 0.0)
    return a.snapshot(0.0)


@pytest.mark.parametrize("case", ["failover_splice", "hedge_won",
                                  "no_hedge"])
def test_executor_markers_match_reference(case):
    """``failover.splice`` from ``ChainExecutor``; ``hedge.fired`` and
    ``hedge.won`` from the hedged executor (none when every hop is fast):
    the same events with the same attributes."""
    lat = {0: 1000.0, 1: 80.0, 99: 50.0}
    out = {}
    for side, (plain, hedged, anchor, cfg_cls, tracer, buf) in (
            ("ref", (ChainExecutor, HedgedChainExecutor, AnchorRegistry,
                     GTRACConfig, Tracer, TraceBuffer)),
            ("port", (TChainExecutor, THedgedChainExecutor, TAnchorRegistry,
                      TGTRACConfig, TTracer, TTraceBuffer))):
        cfg = cfg_cls()
        t = _stage_table(anchor, cfg, [100.0, 100.0])
        if case == "failover_splice":
            ex = plain(cfg, lambda pid, k, p: (p, 150.0, pid != 0))
        elif case == "hedge_won":
            ex = hedged(cfg, lambda pid, k, p: (p, lat[pid], True),
                        quantile_factor=2.0)
        else:
            ex = hedged(cfg, lambda pid, k, p: (p, 90.0, True))
        ex.tracer = tracer(buf(), clock=lambda: 3.0)
        report, _ = ex.execute([0, 99], t)
        out[side] = (dataclasses.asdict(report),
                     [(s.name, s.cat, s.t0, s.t1, s.attrs)
                      for s in ex.tracer.sink.spans])
    assert out["port"] == out["ref"]
    names = [s[0] for s in out["port"][1]]
    assert names == {"failover_splice": ["failover.splice"],
                     "hedge_won": ["hedge.fired", "hedge.won"],
                     "no_hedge": []}[case]


# ---------------------------------------------------------------------------
# The slice as a whole: traced, hedged window serving
# ---------------------------------------------------------------------------


#: span attributes naming a seeker cache by its ``source_id``, which a
#: process-wide counter hands out (so it depends on what ran before)
_SOURCE_ID_ATTRS = ("seeker", "sender", "receiver")


def _sim_spans(buf):
    """Every span outside the rpc clock domain, minus host wall readings
    (``route.plan``'s ``wall_us``), with seeker source ids relabelled in
    order of first appearance."""
    rank = {}
    out = []
    for s in buf.spans:
        if s.domain == "rpc":
            continue
        attrs = {k: (rank.setdefault(v, len(rank))
                     if k in _SOURCE_ID_ATTRS else v)
                 for k, v in s.attrs.items() if k != "wall_us"}
        out.append((s.span_id, s.parent_id, s.name, s.cat, s.domain, s.t0,
                    s.t1, attrs))
    return out


@pytest.mark.parametrize("gossip", [False, True])
def test_traced_hedged_run_queue_matches_reference(models, tmp_path,
                                                   gossip):
    """A traced ``run_queue`` with hedging (and, in one case, gossip and
    the relay plane) on gpt2-large.reduced: the same sim-domain spans,
    the same TTFT and ITL decompositions, every request's components
    summing to its measured TTFT within 1e-6 ms, and an exported trace
    that validates clean."""
    kw = dict(trace_enabled=True, hedge_enabled=True, disaggregate=True,
              prefill_chunk_tokens=4)
    if gossip:
        kw.update(gossip_enabled=True, relay_enabled=True, gossip_seekers=3)
    srv, tsrv = _servers(models, kw, "jnp", "kernel")
    for i, p in enumerate(_prompts()):
        srv.submit(SubmitSpec(prompt=p, max_new_tokens=4,
                              arrival_time=0.01 * i))
        tsrv.submit(TSubmitSpec(prompt=p, max_new_tokens=4,
                                arrival_time=0.01 * i))
    done, tdone = srv.run_queue(), tsrv.run_queue()
    assert [r.output for r in tdone] == [r.output for r in done]
    assert _sim_spans(tsrv.trace) == _sim_spans(srv.trace)
    rows = treport.ttft_breakdown(tsrv.trace)
    assert rows == jreport.ttft_breakdown(srv.trace)
    assert treport.itl_breakdown(tsrv.trace) == \
        jreport.itl_breakdown(srv.trace)
    plan = treport.plan_wall_summary(tsrv.trace)
    want = jreport.plan_wall_summary(srv.trace)
    assert (plan["windows"], plan["cache_hits"]) == \
        (want["windows"], want["cache_hits"])
    assert len(rows) == len(tdone) and all(r["complete"] for r in rows)
    by_rid = {r.request_id: r for r in tdone}
    for r in rows:
        assert abs(r["ttft_sum_ms"] - r["measured_ttft_ms"]) <= 1e-6, r
        assert r["measured_ttft_ms"] == by_rid[r["rid"]].metrics.ttft_ms
    names = {s.name for s in tsrv.trace.spans}
    assert {"hedge.fired", "hop", "decode.step", "prefill.chunk"} <= names
    path = str(tmp_path / "serve.jsonl")
    assert texport.export_jsonl(tsrv.trace, path) == len(tsrv.trace)
    assert texport.validate_jsonl(path) == (len(tsrv.trace), [])


def _summary(out: str) -> list:
    """The CLI's summary lines with token lists, paths and host timings
    taken out (the two packages draw different random weights, and wall
    time is the host's)."""
    keep = []
    for line in out.splitlines():
        if line.startswith(("device ", "plan (host wall", "  ")) or \
                line.startswith(("critical path", "   rid")) or \
                "Warning" in line or "self.pid = os.fork()" in line:
            continue
        if line.startswith("trace: "):
            line = re.sub(r"-> \S+ \(", "-> PATH (", line)
        else:
            line = re.sub(r" -> .*$", "", line)
        keep.append(line.replace(" (sim clock)", ""))
    return keep


def test_serve_cli_hedged_procs_trace_matches_reference(tmp_path, capsys,
                                                        monkeypatch):
    """``--device cpu --reduced --windowed --hedged --shards 4
    --control-plane procs --trace <tmp>``: the port's CLI (four spawned
    workers) prints the reference CLI's summary lines — SSR, windows,
    hedges fired, TTFT/ITL, completion, the control-plane health line, the
    trace line and the per-request critical-path rows — and writes a
    trace that validates clean. The reference's shards run over its
    loopback transport, so no process holding JAX's threads forks."""
    monkeypatch.setattr(
        jcp_registry, "ProcWorker",
        lambda cfg, s, start_method=None: jcp.LoopbackTransport(
            jcp.ShardHost(cfg, s)))
    argv = ["--reduced", "--windowed", "--hedged", "--shards", "4",
            "--control-plane", "procs", "--tokens", "3", "--requests", "3"]
    out = {}
    for side, main in (("ref", jserve.main), ("port", tserve.main)):
        path = tmp_path / f"{side}.jsonl"
        extra = ["--device", "cpu"] if side == "port" else []
        main(argv + extra + ["--trace", str(path)])
        out[side] = capsys.readouterr().out
    port = _summary(out["port"])
    assert port == _summary(out["ref"])
    assert any(line.startswith("SSR: ") and "hedges fired: " in line
               for line in port)
    assert ("control plane: 4 worker procs, 0 rpc retries, 0 timeouts, "
            "0 degraded windows, 0 worker restarts, 0 dropped writes, "
            "0 full resyncs") in port
    n, errors = texport.validate_jsonl(str(tmp_path / "port.jsonl"))
    assert n > 0 and errors == []
    assert re.search(r"^trace: \d+ spans -> PATH \(jsonl, 0 evicted\)$",
                     "\n".join(port), re.M)
    for argv, msg in ((["--hedged"], "--hedged is a window-serving"),):
        with pytest.raises(SystemExit):
            tserve.main(["--device", "cpu", "--reduced"] + argv)
        assert msg in capsys.readouterr().err
