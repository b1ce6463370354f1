"""Observability layer: unified metrics registry, sampled per-query
tracing, and Prometheus / Chrome-trace exporters.

This package depends only on the standard library and ``torch`` — it sits
*below* ``repro_torch.api`` / ``repro_torch.serve`` in the import graph so
any layer can instrument itself without cycles. The engine and the executor
open ``plan``/``compile``/``execute`` spans under the current trace, and
the graph search its stages' spans; under ``torch.profiler`` each search
opens a root of its own (``profiled_traces()``).
"""
from .registry import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_MS_BOUNDS,
    MetricsRegistry,
    log_bounds,
)
from .trace import (
    NOOP_SPAN,
    Span,
    Trace,
    Tracer,
    current,
    profiled_traces,
    span,
)
from .export import (
    chrome_trace,
    dump_chrome_trace,
    json_snapshot,
    prometheus_text,
)
from .http import MetricsServer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_MS_BOUNDS",
    "MetricsRegistry",
    "MetricsServer",
    "NOOP_SPAN",
    "Span",
    "Trace",
    "Tracer",
    "chrome_trace",
    "current",
    "dump_chrome_trace",
    "json_snapshot",
    "log_bounds",
    "profiled_traces",
    "prometheus_text",
    "span",
]
