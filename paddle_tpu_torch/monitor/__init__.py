"""paddle_tpu_torch.monitor — runtime counters/gauges/histograms +
Prometheus text exposition + the tick-level span tracer.  A copy of
``paddle_tpu/monitor/``: the port keeps its own so it never imports the
JAX package.

Reference parity: ``platform/monitor.h`` ``StatValue``/``StatRegistry``
(+ the STAT_ADD/STAT_SUB macros) — see stats.py — and
``platform/profiler.h`` ``RecordEvent`` spans with the
``tools/timeline.py`` chrome-trace export — see tracing.py (bounded
per-thread ring buffers, Catapult-native events).  Consumer: the
serving engine (queue depth, slot occupancy, tokens/sec, TTFT/TPOT,
tick spans).  Pure stdlib — safe in fork'd worker processes and HTTP
handler threads; no torch import until a span asks for the profiler
pass-through (``annotate=True``: ``torch.profiler.record_function``).
"""
from .stats import (  # noqa: F401
    Counter, Gauge, Histogram, StatValue, StatRegistry, RateMeter,
    DEFAULT_BUCKETS, default_registry, sanitize_name,
    stat_add, stat_sub, stat_get,
)
from .exposition import render_prometheus  # noqa: F401
from .tracing import (  # noqa: F401
    Tracer, NullTracer, RecordEvent, TraceEvent, to_chrome_trace,
    default_tracer,
)


def counter(name, help=""):
    """Get-or-create a Counter in the default registry."""
    return default_registry().counter(name, help)


def gauge(name, help=""):
    """Get-or-create a Gauge in the default registry."""
    return default_registry().gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    """Get-or-create a Histogram in the default registry."""
    return default_registry().histogram(name, help, buckets=buckets)


__all__ = [
    "Counter", "Gauge", "Histogram", "StatValue", "StatRegistry",
    "RateMeter", "DEFAULT_BUCKETS", "default_registry", "sanitize_name",
    "stat_add", "stat_sub", "stat_get", "render_prometheus",
    "counter", "gauge", "histogram",
    "Tracer", "NullTracer", "RecordEvent", "TraceEvent",
    "to_chrome_trace", "default_tracer",
]
