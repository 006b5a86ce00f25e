"""Critical-path analysis over exported span trees.

``ttft_breakdown`` decomposes each request's time-to-first-token into
the sim-time components that *sum to the measured TTFT* (the
accounting identity the trace-demo asserts):

    ttft = queue_wait + prefill_exec + prefill_stall + first_decode_exec

where the exec components further split into hop-exec (successful hop
latencies) and failover (failed-hop detection latencies — repair work
rides the successful-hop side because the spliced replacement hop DID
run). Routing ``plan`` cost is reported separately in wall time: the
sim clock does not advance while the batched DP runs, so plan cost is
host overhead, not request latency. The staleness column is the worst
gossip staleness (rounds) the request routed under — the
trust-discount input, not a time quantum.

``itl_breakdown`` splits steady-state inter-token latency into own
chain execution vs window drag (waiting for the window's slowest
stream — the batching interference term).

``format_report`` renders both plus the top spans by total duration
(the "top regressing spans" view) and the completion-rate line
(requests that never emitted are counted as incomplete, the paper's
SSR complement).

Port of ``repro.obs.report``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.obs.export import span_dict
from repro_torch.obs.metrics import percentiles
from repro_torch.obs.trace import Span, TraceBuffer


def _as_dicts(src) -> List[dict]:
    if isinstance(src, TraceBuffer):
        return [span_dict(s) for s in src.sorted_spans()]
    out = []
    for s in src:
        out.append(span_dict(s) if isinstance(s, Span) else s)
    return out


def _children(spans: Sequence[dict]) -> Dict[Optional[int], List[dict]]:
    by_parent: Dict[Optional[int], List[dict]] = defaultdict(list)
    for sp in spans:
        by_parent[sp["parent"]].append(sp)
    for kids in by_parent.values():
        kids.sort(key=lambda s: (s["t0"], s["id"]))
    return by_parent


def _hop_split(hop_parent: dict,
               by_parent: Dict[Optional[int], List[dict]]) -> Dict[str, float]:
    """Split one exec span's duration into successful-hop vs failed-hop
    (failover detection) milliseconds from its hop children."""
    ok_ms = fail_ms = 0.0
    for h in by_parent.get(hop_parent["id"], ()):
        if h["name"] != "hop":
            continue
        if h["attrs"].get("ok"):
            ok_ms += h["dur_ms"]
        else:
            fail_ms += h["dur_ms"]
    return {"hop_exec_ms": ok_ms, "failover_ms": fail_ms}


def ttft_breakdown(src) -> List[dict]:
    """Per-request TTFT decomposition; one dict per *request* span.

    Keys: rid, measured_ttft_ms (the serving layer's stamp; -1 when
    the request never emitted), queue_wait_ms, prefill_ms,
    prefill_stall_ms, decode_ms, hop_exec_ms, failover_ms,
    ttft_sum_ms (the component sum — equals measured within float
    rounding for completed requests), complete, stale_rounds_max.
    """
    spans = _as_dicts(src)
    by_parent = _children(spans)
    rows: List[dict] = []
    for sp in spans:
        if sp["cat"] != "request":
            continue
        attrs = sp["attrs"]
        row = {"rid": attrs.get("rid"), "queue_wait_ms": 0.0,
               "prefill_ms": 0.0, "prefill_stall_ms": 0.0,
               "decode_ms": 0.0, "hop_exec_ms": 0.0, "failover_ms": 0.0,
               "measured_ttft_ms": float(attrs.get("ttft_ms", -1.0)),
               "complete": bool(attrs.get("ttft_ms", -1.0) >= 0),
               "stale_rounds_max": int(attrs.get("stale_rounds_max", 0))}
        for child in by_parent.get(sp["id"], ()):
            name = child["name"]
            if name == "queue.wait":
                row["queue_wait_ms"] += child["dur_ms"]
            elif name == "prefill.chunk":
                row["prefill_ms"] += child["dur_ms"]
                for k, v in _hop_split(child, by_parent).items():
                    row[k] += v
            elif name == "prefill.stall":
                row["prefill_stall_ms"] += child["dur_ms"]
            elif name == "decode.step" and \
                    child["attrs"].get("first_token"):
                row["decode_ms"] += child["dur_ms"]
                for k, v in _hop_split(child, by_parent).items():
                    row[k] += v
        row["ttft_sum_ms"] = (row["queue_wait_ms"] + row["prefill_ms"]
                              + row["prefill_stall_ms"] + row["decode_ms"])
        rows.append(row)
    rows.sort(key=lambda r: (-(r["measured_ttft_ms"]), r["rid"] or 0))
    return rows


def itl_breakdown(src) -> dict:
    """Steady-state ITL decomposition across all requests: for every
    decode step after a stream's first token, its inter-token latency
    is (own chain exec) + (previous window's drag). Returns p50/p99 of
    each component plus of the reconstructed ITLs."""
    spans = _as_dicts(src)
    steps: Dict[object, List[dict]] = defaultdict(list)
    for sp in spans:
        if sp["name"] == "decode.step":
            steps[sp["attrs"].get("rid")].append(sp)
    execs: List[float] = []
    drags: List[float] = []
    itls: List[float] = []
    for rid, ss in steps.items():
        ss.sort(key=lambda s: (s["t0"], s["id"]))
        for prev, cur in zip(ss, ss[1:]):
            if not cur["attrs"].get("emitted"):
                continue
            drag = float(prev["attrs"].get("drag_ms", 0.0))
            execs.append(cur["dur_ms"])
            drags.append(drag)
            itls.append(cur["dur_ms"] + drag)
    e50, e99 = percentiles(execs, (50, 99))
    d50, d99 = percentiles(drags, (50, 99))
    i50, i99 = percentiles(itls, (50, 99))
    return {"n": len(itls),
            "exec_p50_ms": e50, "exec_p99_ms": e99,
            "drag_p50_ms": d50, "drag_p99_ms": d99,
            "itl_p50_ms": i50, "itl_p99_ms": i99}


def plan_wall_summary(src) -> dict:
    """Routing plan cost (host wall time — zero sim time) from the
    ``route.plan`` events the batch router emits."""
    spans = _as_dicts(src)
    walls = [float(sp["attrs"].get("wall_us", 0.0)) for sp in spans
             if sp["name"] == "route.plan"]
    hits = sum(1 for sp in spans if sp["name"] == "route.plan"
               and sp["attrs"].get("cache_hit"))
    p50, p99 = percentiles(walls, (50, 99))
    return {"windows": len(walls), "cache_hits": hits,
            "wall_us_p50": p50, "wall_us_p99": p99,
            "wall_us_total": float(sum(walls))}


def top_spans(src, n: int = 8) -> List[dict]:
    """Heaviest span groups by total duration — the regression view."""
    spans = _as_dicts(src)
    groups: Dict[tuple, List[float]] = defaultdict(list)
    for sp in spans:
        groups[(sp["domain"], sp["name"])].append(sp["dur_ms"])
    rows = []
    for (domain, name), durs in groups.items():
        p50, p99 = percentiles(durs, (50, 99))
        rows.append({"domain": domain, "name": name, "count": len(durs),
                     "total_ms": float(sum(durs)), "p50_ms": p50,
                     "p99_ms": p99})
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:n]


def format_report(src, top: int = 8) -> str:
    """The printed critical-path report (launch/serve.py --trace)."""
    rows = ttft_breakdown(src)
    itl = itl_breakdown(src)
    plan = plan_wall_summary(src)
    complete = sum(r["complete"] for r in rows)
    lines = ["critical path (per request, ms — components sum to TTFT):",
             f"{'rid':>6s} {'ttft':>9s} {'=sum':>9s} {'queue':>8s} "
             f"{'prefill':>8s} {'stall':>8s} {'decode':>8s} "
             f"{'hop-exec':>8s} {'failover':>8s} {'stale':>5s}"]
    for r in rows:
        ttft = (f"{r['measured_ttft_ms']:9.1f}" if r["complete"]
                else "   incomp")
        lines.append(
            f"{str(r['rid']):>6s} {ttft} {r['ttft_sum_ms']:9.1f} "
            f"{r['queue_wait_ms']:8.1f} {r['prefill_ms']:8.1f} "
            f"{r['prefill_stall_ms']:8.1f} {r['decode_ms']:8.1f} "
            f"{r['hop_exec_ms']:8.1f} {r['failover_ms']:8.1f} "
            f"{r['stale_rounds_max']:5d}")
    lines.append(
        f"completion: {complete}/{len(rows)} requests emitted "
        f"({len(rows) - complete} incomplete)")
    if itl["n"]:
        lines.append(
            f"itl decomposition over {itl['n']} steady-state tokens: "
            f"p99 {itl['itl_p99_ms']:.1f} ms = exec p99 "
            f"{itl['exec_p99_ms']:.1f} + window-drag p99 "
            f"{itl['drag_p99_ms']:.1f}")
    if plan["windows"]:
        lines.append(
            f"plan (host wall, not sim latency): {plan['windows']} "
            f"windows, {plan['cache_hits']} cache hits, p50/p99 "
            f"{plan['wall_us_p50']:.0f}/{plan['wall_us_p99']:.0f} us")
    lines.append("top span groups by total duration:")
    for r in top_spans(src, n=top):
        lines.append(
            f"  {r['domain']:>6s} {r['name']:<22s} n={r['count']:<6d} "
            f"total {r['total_ms']:10.1f} ms  p50 {r['p50_ms']:8.2f}  "
            f"p99 {r['p99_ms']:8.2f}")
    return "\n".join(lines)
