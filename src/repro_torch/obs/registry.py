"""Unified metrics registry: named counters, gauges and streaming histograms.

Every subsystem in the stack grew its own ad-hoc counter surface —
``Executor.stats()``, ``SegmentStore`` residency gauges, ``ResultCache``
hit/invalidation counters, ``routing.trace_count()``, the ``ServerStats``
latency lists.  The ``MetricsRegistry`` is the one place they all meet:

* **owned instruments** — ``Counter`` / ``Gauge`` / ``Histogram`` objects a
  subsystem creates through the registry and updates directly on its hot
  path.  Histograms use *fixed log-spaced bounds* with streaming
  count/sum/min/max, so their memory is constant no matter how many
  observations land (the old ``ServerStats`` latency lists grew without
  bound over a long-running server); p50/p95/p99 are estimated by linear
  interpolation inside the covering bucket.
* **providers** — existing counter owners that already expose a
  ``stats()``-style dict register a zero-argument callable under a prefix;
  the registry pulls and flattens it at collection time.  This keeps every
  legacy hot path byte-identical (no new locks or writes per event) while
  still giving one consistent scrape surface.

All registry state is guarded by one re-entrant lock; each instrument
additionally carries its own small lock so concurrent ``inc``/``observe``
calls from the serve worker, merge thread and caller threads never lose
updates (counter conservation is stress-tested under 8 threads).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_right
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_MS_BOUNDS",
    "MetricsRegistry",
    "log_bounds",
]


def log_bounds(
    lo: float, hi: float, per_decade: int = 10
) -> Tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` to ≥ ``hi`` with
    ``per_decade`` buckets per factor of 10.  The resolution bounds the
    percentile estimation error: adjacent edges differ by a factor of
    ``10**(1/per_decade)`` (≈1.26 at the default), and linear interpolation
    inside the covering bucket tightens that further."""
    if lo <= 0 or hi <= lo or per_decade <= 0:
        raise ValueError("need 0 < lo < hi and per_decade > 0")
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    ratio = 10.0 ** (1.0 / per_decade)
    return tuple(lo * ratio**i for i in range(n))


#: Default latency bounds: 1 µs … ≥60 s in milliseconds, 10 buckets per
#: decade (78 buckets — fixed memory regardless of traffic volume).
LATENCY_MS_BOUNDS = log_bounds(1e-3, 6e4, per_decade=10)


class Counter:
    """Monotone counter (thread-safe)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (thread-safe)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming histogram over fixed log-spaced bounds.

    State is ``len(bounds) + 1`` bucket counts plus count/sum/min/max —
    constant memory, O(log buckets) per ``observe`` (bisect), no stored
    samples.  ``percentile`` walks the cumulative counts to the covering
    bucket and interpolates linearly between its edges (clamped to the
    observed min/max, so degenerate single-bucket distributions still
    report exact values).
    """

    __slots__ = (
        "name", "help", "bounds", "_counts", "_count", "_sum",
        "_min", "_max", "_lock",
    )

    def __init__(
        self,
        name: str,
        bounds: Iterable[float] = LATENCY_MS_BOUNDS,
        help: str = "",
    ):
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("bounds must be a nonempty ascending sequence")
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        x = float(x)
        i = bisect_right(self.bounds, x)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x

    # -- reporting ---------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Streaming quantile estimate (0 when empty).  Exact at the
        observed extremes; elsewhere accurate to the bucket resolution."""
        with self._lock:
            count = self._count
            if count == 0:
                return 0.0
            target = q / 100.0 * (count - 1) + 1.0  # 1-based fractional rank
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else self._min
                    hi = (
                        self.bounds[i]
                        if i < len(self.bounds) else self._max
                    )
                    lo = max(lo, self._min)
                    hi = min(hi, self._max)
                    if hi <= lo:
                        return lo
                    frac = (target - cum) / c
                    return lo + frac * (hi - lo)
                cum += c
            return self._max  # unreachable unless racing; safe fallback

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
            }

    def cumulative_buckets(self) -> list:
        """``[(upper_bound, cumulative_count), ..., ("+Inf", count)]`` —
        the Prometheus histogram exposition shape."""
        with self._lock:
            out = []
            cum = 0
            for b, c in zip(self.bounds, self._counts):
                cum += c
                out.append((b, cum))
            out.append((math.inf, cum + self._counts[-1]))
            return out


class MetricsRegistry:
    """Thread-safe name → instrument map plus pull-based providers.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent per
    name; re-registering a name as a different kind raises).  Providers are
    zero-argument callables returning a (possibly nested) dict of numeric
    values; ``collect`` flattens them as ``{prefix}_{key}`` gauges — the
    bridge that puts every pre-existing ``stats()`` surface behind one
    scrape endpoint without touching its hot path.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, object] = {}
        self._providers: Dict[str, Callable[[], dict]] = {}

    # -- instruments -------------------------------------------------------

    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, kind):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, not {kind.__name__}"
                    )
                return m
            m = self._metrics[name] = factory()
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name, help))

    def histogram(
        self,
        name: str,
        bounds: Iterable[float] = LATENCY_MS_BOUNDS,
        help: str = "",
    ) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(name, bounds, help)
        )

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    # -- providers ---------------------------------------------------------

    def register_provider(
        self, prefix: str, fn: Callable[[], dict]
    ) -> None:
        """Attach an existing ``stats()``-style surface under ``prefix``
        (re-registering a prefix replaces the callable — engines get
        swapped under a live server by merges)."""
        with self._lock:
            self._providers[prefix] = fn

    def unregister_provider(self, prefix: str) -> None:
        with self._lock:
            self._providers.pop(prefix, None)

    @staticmethod
    def _flatten(prefix: str, d: dict, out: dict) -> None:
        for k, v in d.items():
            name = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, dict):
                MetricsRegistry._flatten(name, v, out)
            elif isinstance(v, bool):
                out[name] = int(v)
            elif isinstance(v, (int, float)) and math.isfinite(v):
                out[name] = v
            # non-numeric provider values (strings, None) are not metrics

    def provider_values(self) -> dict:
        """Flattened numeric snapshot of every registered provider.  A
        provider that raises is skipped (a scrape must never take down the
        serving path it observes)."""
        with self._lock:
            providers = list(self._providers.items())
        out: dict = {}
        for prefix, fn in providers:
            try:
                d = fn()
            except Exception:
                continue
            if isinstance(d, dict):
                self._flatten(prefix, d, out)
        return out

    # -- collection --------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-able sample: owned instruments + provider values."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            elif isinstance(m, Histogram):
                s = m.snapshot()
                s.update(
                    p50=m.percentile(50),
                    p95=m.percentile(95),
                    p99=m.percentile(99),
                )
                out["histograms"][m.name] = s
        out["providers"] = self.provider_values()
        return out

    def collect(self) -> list:
        """``(name, kind, payload)`` triples for the exporters: kind is
        "counter" | "gauge" | "histogram"; histogram payloads carry the
        cumulative buckets plus sum/count."""
        with self._lock:
            metrics = list(self._metrics.values())
        rows = []
        for m in metrics:
            if isinstance(m, Counter):
                rows.append((m.name, "counter", m.value))
            elif isinstance(m, Gauge):
                rows.append((m.name, "gauge", m.value))
            elif isinstance(m, Histogram):
                rows.append((
                    m.name, "histogram",
                    {
                        "buckets": m.cumulative_buckets(),
                        "sum": m.sum,
                        "count": m.count,
                    },
                ))
        for name, v in sorted(self.provider_values().items()):
            rows.append((name, "gauge", v))
        return rows
