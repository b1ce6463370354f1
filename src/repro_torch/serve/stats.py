"""Live serving metrics, sampled without device round-trips.

``ServerStats`` is a thin view over a ``repro_torch.obs.MetricsRegistry`` plus
the per-tenant breakdown: request latencies land in the registry's bounded
streaming histograms (``serve_queue_ms`` / ``serve_service_ms`` /
``serve_total_ms`` / ``serve_merge_ms`` — fixed log-spaced buckets, so a
long-running server's memory does not grow with every completion), and
every other counter owner in the stack — the executor's plan cache, the
compiled-plan counter, a mutable engine's delta/WAL/merge gauges
(``delta``), a tiered engine's hot/cold tier and tracker (``tier``), a
partitioned engine's ``SegmentStore`` (``segment_store``) and the
serve-layer ``ResultCache`` — is registered as a pull-based
*provider* on the same registry, so one scrape surface (``/metrics``,
``/metrics.json`` via ``repro_torch.obs.MetricsServer``) sees them all with
zero new work on any hot path. The port has no jit:
``core.routing.trace_count`` counts compiled search plans, and the
``retraces`` / ``jit_hit_rate`` keys read it where the reference reads its
jit trace count.

Latency is decomposed per request into ``queue`` (waiting for the
micro-batch window — the serving loop's clock domain) and ``service`` (measured
wall time of the coalesced batch execution the request rode in, up to a
sync on the engine's device); the percentiles reported are end-to-end
(queue + service).

All recording paths hold one re-entrant lock: under ``ThreadedServer`` the
submit path runs on caller threads while completions/batches come from the
worker and merges from the merge thread. ``snapshot()`` takes the same
lock for the counter block, so a mid-stream scrape sees a consistent
sample. ``snapshot()`` keys are backward-compatible with the pre-registry
implementation.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import TYPE_CHECKING, Optional

from repro_torch.core import routing as routing_mod
from repro_torch.obs.registry import MetricsRegistry

if TYPE_CHECKING:
    from repro_torch.api import Engine
    from repro_torch.cache.results import ResultCache

__all__ = ["ServerStats"]


class ServerStats:
    """Serving-loop metrics accumulator (one per serve_loop run or server)."""

    def __init__(
        self,
        engine: Optional["Engine"] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self._engine = engine
        self._lock = threading.RLock()
        self.registry = registry or MetricsRegistry()
        ex = engine.executor.stats() if engine is not None else None
        # baselines: snapshot deltas isolate *this* serving run from
        # whatever warmed the process earlier
        self._cache0 = ex or {"hits": 0, "misses": 0, "evictions": 0}
        self._traces0 = routing_mod.trace_count()
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.rejected_by_reason: dict = defaultdict(int)
        self.per_tenant: dict = defaultdict(
            lambda: {
                "submitted": 0, "completed": 0, "rejected": 0,
                "upserts": 0, "deletes": 0, "writes_shed": 0,
            }
        )
        self.upserts = 0
        self.deletes = 0
        self.writes_rejected = 0
        # bounded streaming latency state (the old unbounded lists)
        self._h_queue = self.registry.histogram(
            "serve_queue_ms", help="per-request micro-batch window wait"
        )
        self._h_service = self.registry.histogram(
            "serve_service_ms", help="coalesced batch execution wall time"
        )
        self._h_total = self.registry.histogram(
            "serve_total_ms", help="end-to-end request latency"
        )
        self._h_merge = self.registry.histogram(
            "serve_merge_ms", help="delta merge wall time (prepare + apply)"
        )
        self.batches = 0
        self.real_rows = 0
        self.bucket_rows = 0
        self.service_wall_s = 0.0
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.span_s = 0.0  # loop-clock span of the run (for QPS)
        #: completions served straight from the result cache (no device work)
        self.cache_served = 0
        self._result_cache: Optional["ResultCache"] = None
        self._register_providers()

    def _register_providers(self) -> None:
        """Expose every existing counter owner through the registry. All
        providers are pulled at scrape time only — nothing new runs on a
        serving hot path."""
        reg = self.registry
        reg.register_provider("serve", self._serve_counters)
        reg.register_provider(
            "routing", lambda: {"jit_traces": routing_mod.trace_count()}
        )
        eng = self._engine
        if eng is None:
            return
        reg.register_provider("executor", lambda: eng.executor.stats())
        write_stats = getattr(eng, "write_stats", None)
        if write_stats is not None:  # MutableEngine: delta/WAL/merge gauges
            reg.register_provider("delta", write_stats)
        tier_stats = getattr(eng, "tier_stats", None)
        if tier_stats is not None:  # TieredEngine: hot/cold + tracker
            reg.register_provider("tier", tier_stats)
        store = getattr(getattr(eng, "index", None), "store", None)
        if store is not None:  # partitioned: shard residency LRU
            reg.register_provider("segment_store", store.stats)

    def _serve_counters(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "upserts": self.upserts,
                "deletes": self.deletes,
                "writes_shed": self.writes_rejected,
                "merges": self._h_merge.count,
                "batches": self.batches,
                "real_rows": self.real_rows,
                "bucket_rows": self.bucket_rows,
                "queue_depth": self.queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "cache_served": self.cache_served,
            }

    @property
    def result_cache(self) -> Optional["ResultCache"]:
        """The attached ``repro_torch.cache.ResultCache`` (set by the serving
        loop when one is in play) — ``snapshot`` folds its counters in and the
        assignment registers it as a registry provider."""
        return self._result_cache

    @result_cache.setter
    def result_cache(self, rc: Optional["ResultCache"]) -> None:
        self._result_cache = rc
        if rc is not None:
            self.registry.register_provider("result_cache", rc.stats)
        else:
            self.registry.unregister_provider("result_cache")

    # -- recording (host-side only) ------------------------------------------

    def record_submit(self, tenant: str) -> None:
        with self._lock:
            self.submitted += 1
            self.per_tenant[tenant]["submitted"] += 1

    def record_reject(self, tenant: str, reason: str) -> None:
        with self._lock:
            self.rejected += 1
            self.rejected_by_reason[reason] += 1
            self.per_tenant[tenant]["rejected"] += 1

    def record_write(self, tenant: str, op: str) -> None:
        """One accepted (applied) write. ``op`` is "upsert" or "delete"."""
        with self._lock:
            if op == "upsert":
                self.upserts += 1
                self.per_tenant[tenant]["upserts"] += 1
            else:
                self.deletes += 1
                self.per_tenant[tenant]["deletes"] += 1

    def record_write_reject(self, tenant: str, reason: str) -> None:
        """One shed write (kept separate from read rejections: ``rejected``
        counts queries only, so read SLO math is unpolluted)."""
        with self._lock:
            self.writes_rejected += 1
            self.rejected_by_reason[reason] += 1
            self.per_tenant[tenant]["writes_shed"] += 1

    def record_merge(self, wall_ms: float) -> None:
        """One completed delta→main merge (prepare + apply wall time)."""
        self._h_merge.observe(float(wall_ms))

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.max_queue_depth = max(self.max_queue_depth, depth)

    def record_batch(self, n_real: int, bucket: int, service_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.real_rows += n_real
            self.bucket_rows += bucket
            self.service_wall_s += service_s

    def record_completion(
        self,
        tenant: str,
        queue_ms: float,
        service_ms: float,
        cached: bool = False,
    ) -> None:
        with self._lock:
            self.admitted += 1  # completion implies prior admission
            self.completed += 1
            self.per_tenant[tenant]["completed"] += 1
            if cached:
                self.cache_served += 1
        # histograms carry their own locks; keep the hot section short
        self._h_queue.observe(queue_ms)
        self._h_service.observe(service_ms)
        self._h_total.observe(queue_ms + service_ms)

    # -- reporting ------------------------------------------------------------

    @property
    def batch_fill_ratio(self) -> float:
        """Real rows / padded bucket rows across every coalesced batch —
        the padding overhead of the bucket ladder (1.0 = no padding)."""
        return self.real_rows / self.bucket_rows if self.bucket_rows else 0.0

    def snapshot(self) -> dict:
        """One host-side metrics sample (safe to call mid-stream). Keys
        are unchanged from the list-backed implementation; percentiles are
        now the registry histograms' streaming estimates."""
        with self._lock:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "rejected_by_reason": dict(self.rejected_by_reason),
                "latency_ms": {
                    "p50": round(self._h_total.percentile(50), 3),
                    "p95": round(self._h_total.percentile(95), 3),
                    "p99": round(self._h_total.percentile(99), 3),
                    "mean": round(self._h_total.mean, 3),
                },
                "queue_ms_p99": round(self._h_queue.percentile(99), 3),
                "service_ms_p99": round(self._h_service.percentile(99), 3),
                "queue_depth": self.queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "batches": self.batches,
                "batch_fill_ratio": round(self.batch_fill_ratio, 4),
                "qps": round(self.completed / self.span_s, 1)
                if self.span_s else 0.0,
                "service_qps": round(
                    self.completed / self.service_wall_s, 1
                ) if self.service_wall_s else 0.0,
                "per_tenant": {
                    t: {
                        **c,
                        "qps": round(c["completed"] / self.span_s, 1)
                        if self.span_s else 0.0,
                    }
                    for t, c in sorted(self.per_tenant.items())
                },
            }
            if self.upserts or self.deletes or self.writes_rejected:
                out["writes"] = {
                    "upserts": self.upserts,
                    "deletes": self.deletes,
                    "shed": self.writes_rejected,
                    "merges": self._h_merge.count,
                    "merge_ms_p50": round(self._h_merge.percentile(50), 3),
                    "merge_ms_p95": round(self._h_merge.percentile(95), 3),
                }
            cache_served = self.cache_served
        # delta/tombstone occupancy gauges from a write-capable engine
        write_stats = getattr(self._engine, "write_stats", None)
        if write_stats is not None:
            out["delta"] = write_stats()
        # serve-layer result cache: hit/invalidation counters plus how many
        # completions this run served without touching the device
        if self._result_cache is not None:
            out["result_cache"] = {
                **self._result_cache.stats(),
                "served": cache_served,
            }
        # hot/cold tier counters from a tiered engine (repro_torch.cache)
        tier_stats = getattr(self._engine, "tier_stats", None)
        if tier_stats is not None:
            out["tier"] = tier_stats()
        # cache/trace rates from host counters (deltas vs construction time)
        retraces = routing_mod.trace_count() - self._traces0
        out["retraces"] = retraces
        out["jit_hit_rate"] = round(
            1.0 - retraces / self.batches, 4
        ) if self.batches else 1.0
        if self._engine is not None:
            now = self._engine.executor.stats()
            hits = now["hits"] - self._cache0["hits"]
            misses = now["misses"] - self._cache0["misses"]
            out["plan_cache"] = {
                "hits": hits,
                "misses": misses,
                "hit_rate": round(hits / (hits + misses), 4)
                if hits + misses else 1.0,
                "evictions": now["evictions"] - self._cache0["evictions"],
                "size": now["size"],
            }
        return out
