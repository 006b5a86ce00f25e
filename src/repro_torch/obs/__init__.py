"""Unified observability plane: tracing + metrics + export + reports
(port of ``repro.obs``).

``obs.trace`` produces nested spans on the injectable sim/wall clocks
into a bounded ring buffer (``TraceBuffer``); ``obs.metrics`` is the
process-wide ``MetricsRegistry`` the per-layer stats dataclasses are
exposed through (one declarative snapshot instead of hand-written
mirror loops); ``obs.export`` writes JSONL / Chrome trace-event files;
``obs.report`` decomposes TTFT and ITL per request into critical-path
components that sum to the measured latencies.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentiles)
from repro_torch.obs.trace import (NOOP_TRACER, NoopTracer, Span, TraceBuffer,
                                   Tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentiles",
    "NOOP_TRACER", "NoopTracer", "Span", "TraceBuffer", "Tracer",
]
