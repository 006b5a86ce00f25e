"""The program's own wall spans and counters, reduced for the per-layer
metrics that read them: ``issue_us_per_layer``, ``idle_in_model``,
``readback_share`` and ``recompute_factor``.

While a torch profiler records, the port opens a ``record_function`` range
for each of its wall spans (``repro_torch.obs.trace.wall``): ``model.*``
and ``moe.*`` in the model functions, ``loop.*`` and ``route.*`` in the
routed window loop, ``engine.*`` in the engine. ``slice_ranges`` reads
those ranges, and the device's busy intervals, from the raw kineto events
of the slice whose summary the traced run reports (``trace.SliceProfiler``
chose it). A program without such spans leaves the lists empty, and every
reader then returns None.

The reductions are plain functions over ``(start_ns, end_ns, name)``
tuples and ``(start_ns, end_ns)`` intervals:

* ``idle_gaps``: the device's idle gaps between its busy intervals,
  those of at least ``trace.GAP_MIN_S``, as the slice's breakdown takes
  them;
* ``idle_within``: how much of those gaps has its midpoint inside a span
  whose name starts with one of the given prefixes, at any depth;
* ``issue_ns_per_layer``: the model spans' time (``model.stage``,
  ``model.prefill``, ``model.decode``) less the read-back spans nested in
  them, over the layers they ran (one ``model.attn`` span a layer);
* ``readback_ns``: the time of the read-back spans;
* ``by_name`` and ``label_gaps``: count, total and self time per span
  name, and the idle gaps by the innermost span at their midpoint, which
  ``host_split.py`` reports.
"""
from __future__ import annotations

import bisect
import importlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from portbench.trace import GAP_MIN_S

#: name prefixes of the program's wall spans
PROGRAM = ("model.", "moe.", "loop.", "route.", "engine.")
#: the spans of the model's host work, and of the host waiting on the card
MODEL_CALLS = ("model.stage", "model.prefill", "model.decode")
READBACKS = ("loop.readback", "route.readback", "engine.readback")
#: a span every layer run opens once
LAYER = "model.attn"
#: the label of an idle gap that no program span holds
NO_SPAN = "(no program span)"

Interval = Tuple[int, int]
Span = Tuple[int, int, str]


class SliceRanges(NamedTuple):
    wall_s: float
    busy: List[Interval]       # the device's busy intervals, merged
    spans: List[Span]          # the program's spans, sorted by start


def chosen_slice(run) -> Optional[Dict]:
    """The profiled slice the run's summary was reduced from."""
    s = run.summary
    if not s:
        return None
    for sl in run.profiler.slices:
        if sl["shapes"] is s.get("shapes"):
            return sl
    return None


def slice_ranges(run) -> Optional[SliceRanges]:
    """The chosen slice's device intervals and program spans, read once
    a run (kept in the slice); None for an untraced run."""
    sl = chosen_slice(run)
    if sl is None:
        return None
    if "program_ranges" in sl:
        return sl["program_ranges"]
    from torch.autograd import DeviceType
    device: List[Interval] = []
    spans: List[Span] = []
    for e in sl["prof"].profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                s = e.start_ns()
                device.append((s, s + e.duration_ns()))
        elif e.name().startswith(PROGRAM):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), e.name()))
    out = sl["program_ranges"] = SliceRanges(sl["wall_s"], merge(device),
                                             sorted(set(spans)))
    return out


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_gaps(busy: Sequence[Interval],
              min_ns: float = GAP_MIN_S * 1e9) -> List[Interval]:
    """The gaps of at least ``min_ns`` between merged busy intervals."""
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])
            if b[0] - a[1] >= min_ns]


def idle_within(gaps: Sequence[Interval], spans: Sequence[Span],
                prefixes: Tuple[str, ...]) -> Tuple[int, int]:
    """(ns of the gaps whose midpoint lies inside a span named with one of
    ``prefixes``, ns of all the gaps)."""
    cover = merge([(s, e) for s, e, name in spans
                   if name.startswith(prefixes)])
    starts = [s for s, _ in cover]
    inside = 0
    for a, b in gaps:
        t = (a + b) / 2
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and cover[i][1] >= t:
            inside += b - a
    return inside, sum(b - a for a, b in gaps)


def readback_ns(spans: Sequence[Span]) -> int:
    return sum(e - s for s, e, name in spans if name in READBACKS)


def issue_ns_per_layer(spans: Sequence[Span]) -> Optional[float]:
    """ns of model host work per layer run: the model spans' time less
    the read-back spans inside them, over the ``model.attn`` spans inside
    them; None where no layer ran."""
    calls = merge([(s, e) for s, e, name in spans if name in MODEL_CALLS])
    starts = [s for s, _ in calls]

    def inside(s, e):
        i = bisect.bisect_right(starts, s) - 1
        return i >= 0 and e <= calls[i][1]

    layers = sum(1 for s, e, name in spans
                 if name == LAYER and inside(s, e))
    if not layers:
        return None
    nested = sum(e - s for s, e, name in spans
                 if name in READBACKS and inside(s, e))
    return (sum(e - s for s, e in calls) - nested) / layers


def by_name(spans: Sequence[Span]) -> Dict[str, List[float]]:
    """[count, total ns, self ns] per span name: self time leaves out the
    time of the program's spans nested directly inside (ranges on one
    thread nest; a span starting where another ends is not inside it)."""
    out: Dict[str, List[float]] = {}
    stack: List[Span] = []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        row = out.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += e - s
        row[2] += e - s
        if stack:
            out[stack[-1][2]][2] -= e - s
        stack.append((s, e, name))
    return out


def label_gaps(gaps: Sequence[Interval],
               spans: Sequence[Span]) -> Dict[str, int]:
    """ns of the gaps by the innermost span that holds each gap's
    midpoint, ``NO_SPAN`` where none does (a sweep: the spans nest)."""
    out: Dict[str, int] = {}
    order = sorted(spans, key=lambda x: (x[0], -x[1]))
    stack: List[Span] = []
    i = 0
    for a, b in sorted(gaps):
        t = (a + b) / 2
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        name = stack[-1][2] if stack else NO_SPAN
        out[name] = out.get(name, 0) + (b - a)
    return out


def stage_counters() -> Optional[Dict[str, int]]:
    """The window loop's stage counters of the run's server
    (``repro_torch.serving.gtrac_serve.last_stage_stats``, the server made
    last in the process); None for a program without them or a run that
    made no server."""
    mod = importlib.import_module("repro_torch.serving.gtrac_serve")
    last = getattr(mod, "last_stage_stats", None)
    stats = last() if last is not None else None
    if stats is None:
        return None
    return {k: int(getattr(stats, k)) for k in ("forwards", "positions",
                                                 "fresh")}
