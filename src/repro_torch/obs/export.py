"""Exporters: Prometheus text exposition and Chrome-trace (Perfetto) JSON.

Both formats are pure functions of registry/tracer state — no I/O here
except the two ``dump_*`` conveniences that write a file.
"""
from __future__ import annotations

import json
import math
import re
from typing import Iterable, List

from .registry import MetricsRegistry
from .trace import Span, Trace

__all__ = [
    "chrome_trace",
    "dump_chrome_trace",
    "json_snapshot",
    "prometheus_text",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format (v0.0.4): ``# TYPE`` headers,
    histogram ``_bucket{le="..."}`` cumulative series plus ``_sum`` and
    ``_count``.  Provider-derived values export as gauges."""
    lines: List[str] = []
    for name, kind, payload in registry.collect():
        pname = _sanitize(name)
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(payload)}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(payload)}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            for le, cum in payload["buckets"]:
                lines.append(
                    f'{pname}_bucket{{le="{_fmt(le)}"}} {cum}'
                )
            lines.append(f"{pname}_sum {_fmt(payload['sum'])}")
            lines.append(f"{pname}_count {payload['count']}")
    return "\n".join(lines) + "\n"


def json_snapshot(registry: MetricsRegistry) -> str:
    return json.dumps(registry.snapshot(), indent=2, sort_keys=True)


def _span_events(
    span: Span, trace_id: int, out: List[dict], pid: int, tid: int
) -> None:
    args = {k: v for k, v in span.attrs.items()}
    args["trace_id"] = trace_id
    out.append({
        "name": span.name,
        "ph": "X",  # complete event: ts + dur
        "ts": span.t0 * 1e6,
        "dur": span.duration * 1e6,
        "pid": pid,
        "tid": tid,
        "args": args,
    })
    for c in span.children:
        _span_events(c, trace_id, out, pid, tid)


def chrome_trace(traces: Iterable[Trace]) -> dict:
    """Chrome Trace Event JSON (load in ``chrome://tracing`` or
    ui.perfetto.dev).  Each trace renders on its own track (tid) so
    overlapping sampled requests don't interleave visually."""
    events: List[dict] = []
    for tr in traces:
        _span_events(tr.root, tr.trace_id, events, pid=1, tid=tr.trace_id)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }


def dump_chrome_trace(traces: Iterable[Trace], path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(traces), f, indent=2)
