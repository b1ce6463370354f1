"""Sampling-based per-query tracing with a near-zero-cost disabled path.

Design constraints, in priority order:

1. **Disabled must be free.**  The serve loop's ≤2% overhead budget means
   the common (untraced) request may not allocate.  ``current()`` is one
   thread-local attribute read; it returns the module-level ``NOOP_SPAN``
   singleton whenever no real span is active.  ``NOOP_SPAN`` is falsy, so
   instrumentation sites guard any attribute *computation* with ``if sp:``
   and otherwise touch nothing — no objects, no timestamps, no dict writes.
2. **Context flows implicitly.**  A real ``Span`` pushes itself onto a
   thread-local stack in ``__enter__`` and pops in ``__exit__``; nested
   instrumentation (engine → executor → partitioned searcher) finds its
   parent via ``current()`` without any plumbing through call signatures.
3. **Sampling is deterministic.**  ``Tracer(sample_every=N)`` samples every
   N-th ``should_sample()`` call via a counter, so tests and the bench can
   force exactly which request is traced (N=1 → all, N=0 → none).

Spans also record whenever ``torch.profiler`` records (``profiling()``, a
module flag read): a span site then records even with no span open, and
``Engine.search`` opens a root ``search`` whose finished tree is kept in
``PROFILED`` (``profiled_traces()``). While the profiler records, every
real span also enters a ``record_function`` of its own name, so the
program's spans sit in the profiler's trace beside the device operations,
on the profiler's clock.

Timestamps are ``time.perf_counter()`` seconds; exporters convert.  Spans
support *synthetic* children with explicit timing (``add``) for phases
measured in a different clock domain (e.g. the serve loop's virtual-clock
queue wait), which keeps the decomposition invariant — root duration =
sum of direct children — exact by construction.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

__all__ = [
    "NOOP_SPAN", "PROFILED", "Span", "Trace", "Tracer", "current", "profiled_root",
    "profiled_traces", "profiling", "span",
]


class _Local(threading.local):
    """A thread's open spans, innermost last: the class's empty tuple until
    a span opens on the thread, so an untraced site reads it without the
    caught ``AttributeError`` a ``getattr`` default costs."""

    stack: tuple = ()


_tls = _Local()


class _NoopSpan:
    """Falsy do-nothing stand-in for a Span; a single shared instance is
    returned from every trace entry point when tracing is off or the
    request was not sampled.  Every method returns ``self`` so chained
    instrumentation (``span("x").set("k", v)``) stays allocation-free."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def span(self, name: str) -> "_NoopSpan":
        return self

    def set(self, key: str, value) -> "_NoopSpan":
        return self

    def add(self, name: str, t0: float, duration: float) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


def profiling() -> bool:
    """Whether ``torch.profiler`` records in this process: a module flag of
    ``torch.autograd.profiler``, read without a call into C++."""
    return _profiler._is_profiler_enabled


def current():
    """The innermost active span on this thread, or ``NOOP_SPAN``."""
    stack = _tls.stack
    if stack:
        return stack[-1]
    return NOOP_SPAN


def span(name: str):
    """Open a child of the current span; with none active, a span of its own
    while the profiler records, else the no-op. This is the one-liner
    instrumentation entry point:

        with obs_trace.span("plan") as sp:
            ...
            if sp:
                sp.set("backend", plan.backend)
    """
    stack = _tls.stack
    if stack:
        return stack[-1].span(name)
    if _profiler._is_profiler_enabled:
        return Span(name)
    return NOOP_SPAN


class Span:
    """A named timed interval with attributes and children.  Real spans
    only exist on a sampled or profiled path, so clarity wins over
    nanosecond shaving here; the untraced path never constructs one."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "_rf")

    def __init__(self, name: str, t0: Optional[float] = None):
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self.children: List["Span"] = []
        self._rf = None  # the profiler's record of this span, while open

    # -- context / structure ----------------------------------------------

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        stack = _tls.stack
        if not isinstance(stack, list):
            stack = _tls.stack = []
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self.t1 is None:
            self.t1 = time.perf_counter()
        stack = _tls.stack
        if stack and stack[-1] is self:
            stack.pop()

    def span(self, name: str) -> "Span":
        child = Span(name)
        self.children.append(child)
        return child

    def add(self, name: str, t0: float, duration: float) -> "Span":
        """Attach an already-measured child (synthetic span) — used for
        phases timed in another clock domain, e.g. queue wait."""
        child = Span(name, t0=t0)
        child.t1 = t0 + duration
        self.children.append(child)
        return child

    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    # -- reporting ---------------------------------------------------------

    @property
    def duration(self) -> float:
        if self.t1 is None:
            return 0.0
        return self.t1 - self.t0

    def find(self, name: str) -> Optional["Span"]:
        """Depth-first lookup by name (self included)."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "t0": self.t0,
            "duration_ms": self.duration * 1e3,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


class Trace:
    """One sampled request: a root span plus an id for correlation."""

    __slots__ = ("trace_id", "root")

    def __init__(self, trace_id: int, root: Span):
        self.trace_id = trace_id
        self.root = root

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "root": self.root.to_dict()}


class Tracer:
    """Deterministic counter-based sampler + bounded store of finished
    traces.  ``sample_every=0`` disables sampling entirely (every entry
    point degrades to the no-op path); ``sample_every=1`` traces every
    request.  At most ``max_traces`` finished traces are retained
    (oldest dropped) — the store must not become the new unbounded list.
    """

    def __init__(self, sample_every: int = 0, max_traces: int = 256):
        self.sample_every = int(sample_every)
        self.max_traces = int(max_traces)
        self._lock = threading.Lock()
        self._tick = 0
        self._next_id = 0
        self._traces: List[Trace] = []

    @property
    def enabled(self) -> bool:
        return self.sample_every > 0

    def should_sample(self) -> bool:
        if self.sample_every <= 0:
            return False
        with self._lock:
            self._tick += 1
            return self._tick % self.sample_every == 0

    def start(self, name: str = "request") -> Trace:
        with self._lock:
            tid = self._next_id
            self._next_id += 1
        return Trace(tid, Span(name))

    def finish(self, trace: Trace) -> None:
        if trace.root.t1 is None:
            trace.root.t1 = time.perf_counter()
        with self._lock:
            self._traces.append(trace)
            if len(self._traces) > self.max_traces:
                del self._traces[: len(self._traces) - self.max_traces]

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


#: the finished roots of the searches made while the profiler recorded
#: (``profiled_root``), oldest dropped past ``max_traces``
PROFILED = Tracer(sample_every=1, max_traces=1024)


class _StoredRoot:
    """Context of a root opened under the profiler: enters its span and,
    when it ends, keeps its trace in ``PROFILED``."""

    __slots__ = ("trace",)

    def __init__(self, name: str):
        self.trace = PROFILED.start(name)

    def __enter__(self) -> Span:
        return self.trace.root.__enter__()

    def __exit__(self, *exc) -> None:
        self.trace.root.__exit__(*exc)
        PROFILED.finish(self.trace)


def profiled_root(name: str):
    """A root span kept in ``PROFILED`` when it ends, where no span is open
    on this thread and the profiler records; ``NOOP_SPAN`` otherwise (a
    sampled request's open tree takes the spans itself)."""
    if _tls.stack or not _profiler._is_profiler_enabled:
        return NOOP_SPAN
    return _StoredRoot(name)


def profiled_traces() -> List[Trace]:
    """The traces ``profiled_root`` kept, oldest first."""
    return PROFILED.traces()
