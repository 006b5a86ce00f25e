"""Span tracing over the repo's injectable clocks.

Port of ``repro.obs.trace``: the reference's spans, buffer and tracers
copied (it holds no JAX, and the port keeps its own copy rather than
importing the reference), plus the profiler ranges at the end of this
module, which the reference has no counterpart of.

A ``Span`` is a named interval ``[t0, t1]`` with a parent, a clock
domain, and free-form attributes. ``Tracer`` stamps spans from ONE
clock callable — the sim clock (``Testbed.now``) for the serving /
gossip planes, an rpc ``Clock`` (``SystemClock`` / ``FakeClock``) for
the process control plane — so tests drive exact span trees and
durations deterministically. Completed spans land in a shared
``TraceBuffer`` ring (bounded: old spans are evicted, never the
process's memory), and multiple tracers in different clock domains can
feed one buffer (``Tracer.scope``) so a single export carries every
layer.

Three ways to record:

* ``with tracer.span("window"):`` — lexical nesting via the tracer's
  open-span stack (children attach to the stack top);
* ``sp = tracer.begin(...); ...; tracer.end(sp)`` — non-lexical spans
  (a request span stays open across many serving windows);
* ``tracer.add(name, t0, t1, parent=...)`` — post-hoc synthesis with
  explicit times (per-hop spans reconstructed from an ``ExecReport``'s
  latencies, so the hot path never pays per-hop clock reads).

Overhead contract: instrumentation points guard on ``tracer.enabled``;
the shared ``NOOP_TRACER`` answers every call with one preallocated
no-op span, so with tracing disabled the hot path pays a single
attribute check and allocates nothing.

The port's own host work (the layers of the model functions, the routed
window loop, the engine) is marked by wall spans that reach no sink:
while a ``torch.profiler`` records, ``wall()`` returns ``PROFILER_RANGES``,
whose span is a ``record_function`` range of the span's name, so the
profiler's trace carries the program's spans beside the device activity,
on its own clock; otherwise it returns ``NOOP_TRACER``. Model functions
are free functions, so their sites call ``wall()`` rather than take a
tracer. A site reads::

    tr = wall()
    with tr.span("model.attn") if tr.enabled else NOOP_SPAN:
        ...
"""
from __future__ import annotations

import collections
import itertools
import time as _time
from typing import Callable, Deque, List, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function


class Span:
    """One traced interval. Mutable until exported — ``tracer.end`` and
    late attribute stamps (e.g. a decode step's window drag, known only
    after the whole window ran) update the same object already in the
    ring."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "domain",
                 "t0", "t1", "attrs", "_tracer", "_pushed")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 cat: str, domain: str, t0: float, attrs: dict):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.domain = domain
        self.t0 = float(t0)
        self.t1 = float(t0)
        self.attrs = attrs
        self._tracer: Optional["Tracer"] = None
        self._pushed = False

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    # lexical form: ``with tracer.span(...):``
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        if self._tracer is not None:
            self._tracer.end(self)
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Span({self.name!r} id={self.span_id} "
                f"parent={self.parent_id} t0={self.t0:.6f} "
                f"dur={self.dur_s:.6f} {self.attrs})")


class _NoopSpan:
    """Shared, attribute-free stand-in: every ``NoopTracer`` call hands
    back this one object, so disabled tracing allocates nothing."""

    __slots__ = ()
    span_id = 0
    parent_id = None
    name = ""
    t0 = 0.0
    t1 = 0.0

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()
NOOP_SPAN = _NOOP_SPAN


class TraceBuffer:
    """Bounded completed-span ring shared by every tracer of one run."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.spans: Deque[Span] = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self._ids = itertools.count(1)

    def next_id(self) -> int:
        return next(self._ids)

    def append(self, span: Span) -> None:
        if len(self.spans) == self.capacity:
            self.dropped += 1
        self.spans.append(span)

    def __len__(self) -> int:
        return len(self.spans)

    def sorted_spans(self) -> List[Span]:
        """Spans in start-time order (the ring holds completion order)."""
        return sorted(self.spans, key=lambda s: (s.domain, s.t0, s.span_id))


class Tracer:
    """Span factory for one clock domain, writing into a shared ring."""

    enabled = True

    def __init__(self, sink: Optional[TraceBuffer] = None,
                 clock: Optional[Callable[[], float]] = None,
                 domain: str = "main"):
        self.sink = sink if sink is not None else TraceBuffer()
        self.clock = clock if clock is not None else _time.perf_counter
        self.domain = domain
        self._stack: List[Span] = []

    def scope(self, domain: str,
              clock: Optional[Callable[[], float]] = None) -> "Tracer":
        """A sibling tracer in another clock domain feeding the SAME
        ring (e.g. the control plane's rpc clock next to the sim
        clock). Stacks are per-tracer: lexical nesting never crosses a
        clock domain."""
        return Tracer(self.sink, clock=clock or self.clock, domain=domain)

    @property
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def begin(self, name: str, cat: str = "", t0: Optional[float] = None,
              parent: Optional[Span] = None, push: bool = False,
              **attrs) -> Span:
        pid = (parent.span_id if parent is not None
               else (self._stack[-1].span_id if self._stack else None))
        sp = Span(self.sink.next_id(), pid, name, cat, self.domain,
                  self.clock() if t0 is None else t0, attrs)
        sp._tracer = self
        if push:
            sp._pushed = True
            self._stack.append(sp)
        return sp

    def end(self, span: Span, t1: Optional[float] = None, **attrs) -> Span:
        span.t1 = self.clock() if t1 is None else float(t1)
        if attrs:
            span.attrs.update(attrs)
        if span._pushed:
            # tolerate out-of-order ends: pop through to this span
            while self._stack:
                top = self._stack.pop()
                if top is span:
                    break
            span._pushed = False
        self.sink.append(span)
        return span

    def span(self, name: str, cat: str = "", **attrs) -> Span:
        """Lexical child span: ``with tracer.span("plan"): ...``."""
        return self.begin(name, cat=cat, push=True, **attrs)

    def event(self, name: str, cat: str = "", t: Optional[float] = None,
              parent: Optional[Span] = None, **attrs) -> Span:
        """Zero-duration marker at ``t`` (default: now)."""
        sp = self.begin(name, cat=cat, t0=t, parent=parent, **attrs)
        sp.t1 = sp.t0
        self.sink.append(sp)
        return sp

    def add(self, name: str, t0: float, t1: float, cat: str = "",
            parent: Optional[Span] = None, **attrs) -> Span:
        """Post-hoc span with explicit times (report-driven synthesis)."""
        sp = self.begin(name, cat=cat, t0=t0, parent=parent, **attrs)
        sp.t1 = float(t1)
        self.sink.append(sp)
        return sp


class NoopTracer:
    """Disabled tracing: every method returns the one shared no-op span
    and records nothing. Call sites on hot paths additionally guard on
    ``tracer.enabled`` so even the no-op calls (and their kwargs dicts)
    are skipped."""

    enabled = False
    sink = None
    domain = "noop"
    current = None

    def scope(self, domain: str, clock=None) -> "NoopTracer":
        return self

    def begin(self, name, cat="", t0=None, parent=None, push=False,
              **attrs):
        return _NOOP_SPAN

    def end(self, span, t1=None, **attrs):
        return _NOOP_SPAN

    def span(self, name, cat="", **attrs):
        return _NOOP_SPAN

    def event(self, name, cat="", t=None, parent=None, **attrs):
        return _NOOP_SPAN

    def add(self, name, t0, t1, cat="", parent=None, **attrs):
        return _NOOP_SPAN


NOOP_TRACER = NoopTracer()


class ProfilerRanges:
    """The wall sites' tracer while a torch profiler records: a span is a
    ``record_function`` range of its name, kept by the profiler; nothing
    is stamped or stored here. Wall sites open lexical spans only."""

    enabled = True

    def span(self, name: str) -> record_function:
        return record_function(name)


PROFILER_RANGES = ProfilerRanges()


def wall():
    """The tracer a wall site uses: ``PROFILER_RANGES`` while a torch
    profiler records, else ``NOOP_TRACER``."""
    return PROFILER_RANGES if _profiler_enabled() else NOOP_TRACER
