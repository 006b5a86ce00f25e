"""Process-wide metrics registry + the one percentile helper.

Port of ``repro.obs.metrics``, copied verbatim: it holds no JAX, and the
port keeps its own copy rather than importing the reference.

``MetricsRegistry`` holds counters / gauges / fixed-bucket histograms
under slash-separated names (``layer/metric``, e.g. ``relay/msgs``).
Existing stats dataclasses (RelayStats, GossipStats, RpcStats /
ControlPlaneHealth, RouterStats, ...) are not rewritten — they are
*exposed*: ``expose(prefix, obj)`` registers the live object and
``snapshot()`` reads its numeric fields fresh every call, so the
registry is a window onto the counters each layer already maintains
and the old hand-written mirror loops go away
(serving/gtrac_serve.GTRACPipelineServer._fill_stream_metrics).

``percentiles`` is the single percentile implementation every summary
and benchmark uses (latency_summary, benchmarks/common, the BENCH_*
writers): -1.0 per quantile when there are no samples.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Number = Union[int, float]


def percentiles(xs: Sequence[float],
                qs: Sequence[float]) -> Tuple[float, ...]:
    """``np.percentile`` over ``xs`` for each quantile in ``qs``;
    every entry is -1.0 when ``xs`` is empty (the repo-wide
    no-samples sentinel)."""
    arr = np.asarray(xs, np.float64)
    if arr.size == 0:
        return tuple(-1.0 for _ in qs)
    return tuple(float(np.percentile(arr, q)) for q in qs)


class Counter:
    """Monotonic count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``uppers`` are inclusive upper bounds
    with an implicit +inf overflow bucket; keeps count/sum/min/max for
    exact means alongside the bucketed distribution."""

    __slots__ = ("uppers", "counts", "count", "sum", "min", "max")

    def __init__(self, uppers: Sequence[float]):
        self.uppers = tuple(float(u) for u in uppers)
        self.counts = [0] * (len(self.uppers) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: Number) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for i, u in enumerate(self.uppers):
            if v <= u:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else -1.0

    def percentile(self, q: float) -> float:
        """Bucket-resolution estimate: the upper bound of the bucket
        holding the q-th sample (``max`` for the overflow bucket)."""
        if not self.count:
            return -1.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.uppers[i] if i < len(self.uppers) else self.max
        return self.max


class MetricsRegistry:
    """Name -> instrument map plus live *views* over existing stats
    objects. ``snapshot()`` returns one flat dict of every instrument
    and every exposed object's numeric fields — the single source the
    serving layer fills ``ServeMetrics`` from."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._views: List[Tuple[str, object]] = []
        self._derived: Dict[str, Callable[[], Number]] = {}

    # -- instruments ---------------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  uppers: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                uppers if uppers is not None
                else (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                      5000, 10000, 25000))
        return h

    # -- views over existing stats objects -----------------------------------

    def expose(self, prefix: str, obj: object) -> None:
        """Register a live stats object: its int/float fields appear in
        every snapshot as ``prefix/field`` (read fresh — no copies, no
        mirroring to go stale)."""
        self._views.append((prefix, obj))

    def derived(self, name: str, fn: Callable[[], Number]) -> None:
        """A computed metric (e.g. ``RelayStats.seeker_wire_bytes``)."""
        self._derived[name] = fn

    @staticmethod
    def _numeric_fields(obj: object) -> Dict[str, Number]:
        if dataclasses.is_dataclass(obj):
            pairs = ((f.name, getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
        else:
            pairs = vars(obj).items()
        return {k: v for k, v in pairs
                if isinstance(v, (int, float)) and not isinstance(v, bool)}

    def snapshot(self) -> Dict[str, Number]:
        snap: Dict[str, Number] = {}
        for prefix, obj in self._views:
            for k, v in self._numeric_fields(obj).items():
                snap[f"{prefix}/{k}"] = v
        for name, c in self._counters.items():
            snap[name] = c.value
        for name, g in self._gauges.items():
            snap[name] = g.value
        for name, h in self._histograms.items():
            snap[f"{name}/count"] = h.count
            snap[f"{name}/sum"] = h.sum
            snap[f"{name}/mean"] = h.mean()
            snap[f"{name}/p50"] = h.percentile(50)
            snap[f"{name}/p99"] = h.percentile(99)
        for name, fn in self._derived.items():
            snap[name] = fn()
        return snap
