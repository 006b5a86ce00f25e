"""Trace export: JSONL (one span per line) and Chrome trace-event JSON
(load at https://ui.perfetto.dev or chrome://tracing), plus the schema
check ``make trace-demo`` gates on.

JSONL schema per line::

    {"id": int, "parent": int|null, "name": str, "cat": str,
     "domain": str, "t0": float, "t1": float, "dur_ms": float,
     "attrs": object}

``t0``/``t1`` are seconds in the span's clock domain (sim seconds for
the serving/gossip planes, rpc-clock seconds for the control plane);
Chrome export keeps domains apart as separate pids so mixed-clock
timelines never interleave misleadingly.

Run ``python -m repro_torch.obs.export --validate trace.jsonl`` to schema-
check a file (exit 1 on any violation).

Port of ``repro.obs.export``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

from repro_torch.obs.trace import Span, TraceBuffer

_REQUIRED = {"id": int, "parent": (int, type(None)), "name": str,
             "cat": str, "domain": str, "t0": (int, float),
             "t1": (int, float), "dur_ms": (int, float), "attrs": dict}


def span_dict(span: Span) -> dict:
    return {"id": span.span_id, "parent": span.parent_id,
            "name": span.name, "cat": span.cat, "domain": span.domain,
            "t0": span.t0, "t1": span.t1,
            "dur_ms": (span.t1 - span.t0) * 1e3, "attrs": span.attrs}


def _spans(src) -> List[Span]:
    if isinstance(src, TraceBuffer):
        return src.sorted_spans()
    return sorted(src, key=lambda s: (s.domain, s.t0, s.span_id))


def export_jsonl(src, path: str) -> int:
    """Write one JSON object per span (start-time order). Returns the
    span count."""
    spans = _spans(src)
    with open(path, "w") as f:
        for sp in spans:
            f.write(json.dumps(span_dict(sp), default=str) + "\n")
    return len(spans)


def export_chrome(src, path: str) -> int:
    """Chrome trace-event format: complete ("X") events, microsecond
    timestamps, one pid per clock domain, instant ("i") events for
    zero-duration spans. Perfetto-loadable."""
    spans = _spans(src)
    domains: Dict[str, int] = {}
    events = []
    for sp in spans:
        pid = domains.setdefault(sp.domain, len(domains) + 1)
        args = {k: (v if isinstance(v, (int, float, str, bool))
                    or v is None else str(v))
                for k, v in sp.attrs.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        ev = {"name": sp.name, "cat": sp.cat or "span",
              "ts": sp.t0 * 1e6, "pid": pid, "tid": 1, "args": args}
        if sp.t1 > sp.t0:
            ev["ph"] = "X"
            ev["dur"] = (sp.t1 - sp.t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 1,
             "args": {"name": f"domain:{dom}"}}
            for dom, pid in domains.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}, f)
    return len(spans)


def validate_jsonl(path: str) -> Tuple[int, List[str]]:
    """Schema-check an exported JSONL trace. Returns
    ``(span_count, errors)`` — empty errors means the file is valid.

    Checks: every line parses, required keys present with the right
    types, ``t1 >= t0``, ``dur_ms`` consistent, ids unique. Parent ids
    may reference spans evicted from the bounded ring, so dangling
    parents are NOT errors."""
    errors: List[str] = []
    seen = set()
    count = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: unparseable JSON ({e})")
                continue
            count += 1
            for key, typ in _REQUIRED.items():
                if key not in obj:
                    errors.append(f"line {lineno}: missing key {key!r}")
                elif not isinstance(obj[key], typ):
                    errors.append(
                        f"line {lineno}: {key!r} has type "
                        f"{type(obj[key]).__name__}")
            if not isinstance(obj.get("id"), int):
                continue
            if obj["id"] in seen:
                errors.append(f"line {lineno}: duplicate id {obj['id']}")
            seen.add(obj["id"])
            t0, t1 = obj.get("t0"), obj.get("t1")
            if isinstance(t0, (int, float)) and isinstance(t1, (int, float)):
                if t1 < t0 - 1e-9:
                    errors.append(f"line {lineno}: t1 < t0")
                dur = obj.get("dur_ms")
                if isinstance(dur, (int, float)) and \
                        abs(dur - (t1 - t0) * 1e3) > 1e-6:
                    errors.append(f"line {lineno}: dur_ms inconsistent")
    return count, errors


def load_jsonl(path: str) -> List[dict]:
    """Parse an exported JSONL trace back into span dicts (report
    tooling over saved traces)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def main(argv: Iterable[str] = None) -> int:  # pragma: no cover - CLI
    import argparse
    ap = argparse.ArgumentParser(description="trace JSONL schema check")
    ap.add_argument("--validate", metavar="PATH", required=True)
    args = ap.parse_args(argv)
    count, errors = validate_jsonl(args.validate)
    for e in errors[:20]:
        print(f"INVALID: {e}")
    print(f"{args.validate}: {count} spans, {len(errors)} schema errors")
    return 1 if errors else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
