"""Observability plane: tracing + metrics (port of ``repro.obs``; the
reference's ``export`` and ``report`` modules join in a later slice).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentiles)
from repro_torch.obs.trace import (NOOP_TRACER, NoopTracer, Span, TraceBuffer,
                                   Tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentiles",
    "NOOP_TRACER", "NoopTracer", "Span", "TraceBuffer", "Tracer",
]
