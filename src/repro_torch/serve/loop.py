"""Serving loops: a deterministic synchronous loop and a threaded server.

``serve_loop`` is the unit-testable core: it replays a *scripted trace* of
``(arrival_time, Request)`` pairs against a virtual clock — admission,
windowing, coalescing and bucket choice are all pure functions of the trace,
so tests assert exact admission decisions, exact batch shapes and bit-exact
results without threads or sleeps. The threaded front-end
(``ThreadedServer``) runs the same queue/microbatcher/registry objects off
the wall clock for live use (``launch/serve.py``).

Every submitted request receives exactly one typed response (``Completed``
or ``Rejected``), returned in submission order by ``serve_loop`` and as a
``Future`` by ``ThreadedServer.submit``; writes are answered with a
``WriteAck`` by a ``repro_torch.mutable.MutableEngine`` and
``Rejected(immutable_engine)`` by an engine without ``upsert``.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Iterable, List, Optional, Tuple, Union

import torch

from repro_torch.api import Engine
from repro_torch.cache.results import ResultCache, result_key
from repro_torch.obs.http import MetricsServer
from repro_torch.obs.trace import Tracer
from repro_torch.serve import request as request_mod
from repro_torch.serve.batcher import DEFAULT_BUCKETS, Microbatcher
from repro_torch.serve.request import (
    Completed, Delete, Rejected, Request, Response, Upsert, WriteAck,
)
from repro_torch.serve.stats import ServerStats
from repro_torch.serve.tenants import TenantPolicy, TenantRegistry

__all__ = ["ThreadedServer", "serve_loop"]

Submittable = Union[Request, Upsert, Delete]
TraceItem = Union[Submittable, Tuple[float, Submittable]]

_MERGE = object()  # inbox tag: a prepared merge ready for its fast apply


def _apply_write(engine, write) -> WriteAck:
    """Apply one admitted write to a mutable engine and build its ack.
    The caller has already checked that the engine takes writes."""
    if isinstance(write, Upsert):
        wid = engine.upsert(write.vector, write.attrs, id=write.id)
        applied = True
        op = "upsert"
    else:
        wid = int(write.id)
        applied = engine.delete(wid)
        op = "delete"
    return WriteAck(
        request_id=write.request_id, tenant=write.tenant, id=int(wid),
        op=op, applied=applied, delta_rows=engine.delta.n_rows,
    )


def serve_loop(
    engine: Engine,
    requests: Iterable[TraceItem],
    registry: Optional[TenantRegistry] = None,
    *,
    window_ms: float = 2.0,
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
    max_queue: int = 1024,
    stats: Optional[ServerStats] = None,
    result_cache: Optional[ResultCache] = None,
    tracer: Optional[Tracer] = None,
) -> Tuple[List[Response], ServerStats]:
    """Drive a scripted request trace through the serving stack.

    ``requests`` yields ``(arrival_time_s, Request)`` pairs in
    nondecreasing arrival order (bare ``Request`` items arrive at the
    current clock — a plain list coalesces maximally). The virtual clock
    advances only from those timestamps: groups flush when their window
    deadline passes or they fill the largest bucket, and token buckets
    refill from the same clock, so the whole run is reproducible. Batch
    *service* time is still measured wall time (it feeds latency stats, not
    decisions).

    Trace items may also be ``Upsert``/``Delete`` writes (engine must be a
    ``MutableEngine``): each is admitted against the tenant's write bucket,
    applied *inline* at its arrival time — so every later query in the
    trace reads the post-write state — and acked with a ``WriteAck``.
    When the engine's compaction policy fires, the merge runs synchronously
    at that trace position (deterministic; the threaded front-end instead
    overlaps the expensive prepare with serving).

    ``result_cache`` attaches a serve-layer ``repro_torch.cache.ResultCache``:
    after admission, a request whose (tenant, query, params) signature hits
    a valid entry (same engine write epoch, TTL — against the virtual clock
    — unexpired) completes immediately with the cached payload
    (``Completed.cached=True``, bit-identical to fresh execution); misses
    execute normally and populate the cache at settle time with the epoch
    captured *at admission*, so an entry computed across a write can never
    serve afterwards.

    ``tracer`` attaches sampled per-query tracing (``repro_torch.obs.Tracer``):
    each flushed batch whose group holds a sampled request records one
    span tree (queue wait + batch, with the engine's plan/compile/execute
    children) retrievable via ``tracer.traces()``. ``None`` (and a tracer
    with ``sample_every=0``) keep the loop on the no-op path.

    Returns one response per submitted request, in submission order, plus
    the ``ServerStats`` for the run.
    """
    registry = registry or TenantRegistry(default_policy=TenantPolicy())
    stats = stats or ServerStats(engine)
    if result_cache is not None:
        stats.result_cache = result_cache
    mb = Microbatcher(
        engine, stats, window_s=window_ms * 1e-3, buckets=buckets,
        tracer=tracer,
    )
    out: List[Optional[Response]] = []
    slot: dict = {}  # in-flight request_id → submission index
    pending_key: dict = {}  # in-flight request_id → (cache key, epoch)
    now = 0.0
    t_start: Optional[float] = None
    next_id = 0

    def settle(completions) -> None:
        for c in completions:
            out[slot.pop(c.request_id)] = c
            pk = pending_key.pop(c.request_id, None)
            if pk is not None:
                result_cache.insert(pk[0], c.ids, c.dists, now, pk[1])

    for item in requests:
        t, req = item if isinstance(item, tuple) else (now, item)
        now = max(now, float(t))
        t_start = now if t_start is None else t_start
        settle(mb.flush_due(now))
        if req.request_id is None:
            req = dataclasses.replace(req, request_id=next_id)
        next_id = max(next_id, req.request_id) + 1
        idx = len(out)
        out.append(None)
        if isinstance(req, (Upsert, Delete)):
            # write path: admit → apply inline (read-your-writes: every
            # later trace item queries the post-write state) → merge when
            # the compaction policy fires
            if not hasattr(engine, "upsert"):
                reason = request_mod.REJECT_IMMUTABLE
            else:
                reason = registry.admit_write(req, now)
            if reason is not None:
                stats.record_write_reject(req.tenant, reason)
                out[idx] = Rejected(
                    request_id=req.request_id, tenant=req.tenant,
                    reason=reason,
                )
                continue
            ack = _apply_write(engine, req)
            stats.record_write(req.tenant, ack.op)
            out[idx] = ack
            if engine.should_merge():
                merged = engine.merge()
                if merged is not None:
                    stats.record_merge(merged["wall_ms"])
            continue
        stats.record_submit(req.tenant)
        if req.request_id in slot:  # collides with an in-flight request
            reason: Optional[str] = request_mod.REJECT_DUPLICATE
        elif mb.queue.depth >= max_queue:
            reason = request_mod.REJECT_QUEUE
        else:
            reason = registry.admit(req, now)
        if reason is not None:
            stats.record_reject(req.tenant, reason)
            out[idx] = Rejected(
                request_id=req.request_id, tenant=req.tenant, reason=reason
            )
            continue
        params = registry.resolve_params(req)
        if result_cache is not None:
            epoch = getattr(engine, "write_epoch", 0)
            key = result_key(req.tenant, req.query, params)
            hit = result_cache.lookup(key, now, epoch)
            if hit is not None:
                ids, dists = hit
                stats.record_completion(req.tenant, 0.0, 0.0, cached=True)
                out[idx] = Completed(
                    request_id=req.request_id, tenant=req.tenant,
                    ids=ids, dists=dists, queue_ms=0.0, service_ms=0.0,
                    bucket=0, batch_fill=0.0, cached=True,
                )
                continue
            pending_key[req.request_id] = (key, epoch)
        slot[req.request_id] = idx
        settle(mb.enqueue(req, params, now))

    # drain: every remaining deadline is ≤ last arrival + window
    now += mb.queue.window_s
    settle(mb.flush_all(now))
    assert not slot, "every admitted request must have been flushed"
    stats.span_s = max(now - (t_start or 0.0), 1e-9)
    return out, stats


class ThreadedServer:
    """Thin wall-clock front-end over the same queue/microbatcher core.

    ``submit`` performs admission synchronously on the caller's thread
    (rejections resolve the returned ``Future`` immediately — backpressure
    is instant); admitted requests are handed to one worker thread that
    owns the ``Microbatcher`` and flushes groups on window expiry or full
    buckets.

    Writes (``Upsert``/``Delete``) are admitted against the tenant's write
    bucket and *applied synchronously* on the caller's thread — the
    returned Future is already resolved, so read-your-writes holds for any
    request submitted afterwards. Merging never blocks serving: when the
    compaction policy fires, a dedicated thread runs the expensive
    ``merge_prepare`` off-lock while queries keep flowing, then posts the
    prepared index to the worker, which performs the fast pointer-swap
    ``merge_apply`` between batches. The merge thread issues its device
    work on the device's current stream, so the swap needs no cross-stream
    fence. Use as a context manager::

        with ThreadedServer(engine, registry, window_ms=2.0) as srv:
            futs = [srv.submit(r) for r in reqs]
            results = [f.result() for f in futs]
        print(srv.stats.snapshot())
    """

    def __init__(
        self,
        engine: Engine,
        registry: Optional[TenantRegistry] = None,
        *,
        window_ms: float = 2.0,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        max_queue: int = 1024,
        result_cache: Optional[ResultCache] = None,
        tracer: Optional[Tracer] = None,
        metrics_port: Optional[int] = None,
    ):
        self.registry = registry or TenantRegistry(
            default_policy=TenantPolicy()
        )
        self._engine = engine
        self.stats = ServerStats(engine)
        self._result_cache = result_cache
        if result_cache is not None:
            self.stats.result_cache = result_cache
        self.tracer = tracer
        self._mb = Microbatcher(
            engine, self.stats, window_s=window_ms * 1e-3, buckets=buckets,
            tracer=tracer,
        )
        #: scrape endpoint over this server's metrics registry; pass
        #: ``metrics_port=0`` for an ephemeral port (read ``.port`` back)
        self.metrics_server: Optional[MetricsServer] = (
            None if metrics_port is None
            else MetricsServer(self.stats.registry, port=metrics_port)
        )
        self.max_queue = max_queue
        self._inbox: "queue_mod.Queue" = queue_mod.Queue()
        self._futures: dict = {}
        self._pending_keys: dict = {}  # request_id → (cache key, epoch)
        self._lock = threading.Lock()  # admission + id assignment
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._merge_thread: Optional[threading.Thread] = None
        self._merge_inflight = False
        self._t0 = time.monotonic()
        self._next_id = 0

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ThreadedServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
            if self.metrics_server is not None:
                self.metrics_server.start()
        return self

    def stop(self) -> None:
        """Drain the queue, flush every pending group, join the worker.
        Requests that slipped into the inbox after the worker's final
        emptiness check are resolved as ``Rejected(server_stopped)`` —
        no Future is ever stranded."""
        if self._thread is not None:
            self._stop.set()
            # in-flight merge first: its prepared result lands in the inbox
            # and the worker applies it before its final emptiness check
            if self._merge_thread is not None:
                self._merge_thread.join()
                self._merge_thread = None
            self._thread.join()
            self._thread = None
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue_mod.Empty:
                break
            if item[0] is _MERGE:  # defensive: the worker normally applies it
                self._finish_merge(item[1])
                continue
            req, _ = item
            with self._lock:
                fut = self._futures.pop(req.request_id, None)
                self._pending_keys.pop(req.request_id, None)
            if fut is not None and not fut.done():
                self.stats.record_reject(
                    req.tenant, request_mod.REJECT_STOPPED
                )
                fut.set_result(Rejected(
                    request_id=req.request_id, tenant=req.tenant,
                    reason=request_mod.REJECT_STOPPED,
                ))
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.stats.span_s = max(time.monotonic() - self._t0, 1e-9)

    def __enter__(self) -> "ThreadedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface -------------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def submit(self, req: Submittable) -> "Future[Response]":
        """Admit (or shed) on the caller's thread; returns a Future that
        resolves to this request's typed response. Writes resolve before
        returning (they are applied synchronously)."""
        if isinstance(req, (Upsert, Delete)):
            return self._submit_write(req)
        fut: "Future[Response]" = Future()
        with self._lock:
            if req.request_id is None:
                req = dataclasses.replace(req, request_id=self._next_id)
            self._next_id = max(self._next_id, req.request_id) + 1
            self.stats.record_submit(req.tenant)
            if self._stop.is_set():
                reason: Optional[str] = request_mod.REJECT_STOPPED
            elif req.request_id in self._futures:  # collides with in-flight
                reason = request_mod.REJECT_DUPLICATE
            elif (self._inbox.qsize() + self._mb.queue.depth
                    >= self.max_queue):
                reason = request_mod.REJECT_QUEUE
            else:
                reason = self.registry.admit(req, self._now())
            if reason is not None:
                self.stats.record_reject(req.tenant, reason)
                fut.set_result(Rejected(
                    request_id=req.request_id, tenant=req.tenant,
                    reason=reason,
                ))
                return fut
            params = self.registry.resolve_params(req)
            if self._result_cache is not None:
                # epoch read under the admission lock: writes apply (and
                # bump it) under this same lock, so a post-ack submit sees
                # the post-write epoch — read-your-writes holds through
                # the cache
                epoch = getattr(self._engine, "write_epoch", 0)
                key = result_key(req.tenant, req.query, params)
                hit = self._result_cache.lookup(key, self._now(), epoch)
                if hit is not None:
                    ids, dists = hit
                    self.stats.record_completion(
                        req.tenant, 0.0, 0.0, cached=True
                    )
                    fut.set_result(Completed(
                        request_id=req.request_id, tenant=req.tenant,
                        ids=ids, dists=dists, queue_ms=0.0,
                        service_ms=0.0, bucket=0, batch_fill=0.0,
                        cached=True,
                    ))
                    return fut
                self._pending_keys[req.request_id] = (key, epoch)
            self._futures[req.request_id] = fut
        self._inbox.put((req, params))
        return fut

    def _submit_write(self, write: Union[Upsert, Delete]) -> "Future[Response]":
        """Admit and apply one write on the caller's thread. By the time the
        (already resolved) Future returns, the write is visible to every
        query submitted afterwards — read-your-writes."""
        fut: "Future[Response]" = Future()
        with self._lock:
            if write.request_id is None:
                write = dataclasses.replace(write, request_id=self._next_id)
            self._next_id = max(self._next_id, write.request_id) + 1
            if self._stop.is_set():
                reason: Optional[str] = request_mod.REJECT_STOPPED
            elif not hasattr(self._engine, "upsert"):
                reason = request_mod.REJECT_IMMUTABLE
            else:
                reason = self.registry.admit_write(write, self._now())
            if reason is not None:
                self.stats.record_write_reject(write.tenant, reason)
                fut.set_result(Rejected(
                    request_id=write.request_id, tenant=write.tenant,
                    reason=reason,
                ))
                return fut
            ack = _apply_write(self._engine, write)
            self.stats.record_write(write.tenant, ack.op)
            fut.set_result(ack)
        self._maybe_schedule_merge()
        return fut

    # -- background merge ------------------------------------------------------

    def _maybe_schedule_merge(self) -> None:
        """Act on the compaction policy's decision: at most one merge in
        flight, prepared off the serving path on its own thread."""
        eng = self._engine
        if not hasattr(eng, "should_merge"):
            return
        with self._lock:
            if (self._merge_inflight or self._stop.is_set()
                    or not eng.should_merge()):
                return
            self._merge_inflight = True
            self._merge_thread = threading.Thread(
                target=self._merge_prepare_worker, daemon=True
            )
            self._merge_thread.start()

    def _merge_prepare_worker(self) -> None:
        from repro_torch.mutable import merge as merge_mod

        dev = self._engine.device
        try:
            if dev.type == "cuda":
                # the thread starts on device 0: issue the prepare on the
                # engine's device (its current stream, as the readers use)
                torch.cuda.set_device(dev)
            prepared = merge_mod.merge_prepare(self._engine)
        except BaseException:
            with self._lock:
                self._merge_inflight = False
            raise
        if prepared is None:
            with self._lock:
                self._merge_inflight = False
            return
        self._inbox.put((_MERGE, prepared))  # the worker applies it between batches

    def _finish_merge(self, prepared) -> None:
        from repro_torch.mutable import merge as merge_mod

        merged = merge_mod.merge_apply(self._engine, prepared)
        wall_ms = prepared.prepare_ms + merged["apply_ms"]
        self._engine.merge_ms.append(wall_ms)
        self.stats.record_merge(wall_ms)
        with self._lock:
            self._merge_inflight = False

    # -- worker ---------------------------------------------------------------

    def _resolve(self, completions) -> None:
        for c in completions:
            with self._lock:
                fut = self._futures.pop(c.request_id, None)
                pk = self._pending_keys.pop(c.request_id, None)
            if pk is not None:
                # stored under the submit-time epoch: a write that landed
                # mid-flight leaves this entry permanently stale (the
                # lookup epoch check rejects it) — stale top-k is
                # structurally unreachable
                self._result_cache.insert(
                    pk[0], c.ids, c.dists, self._now(), pk[1]
                )
            if fut is not None:
                fut.set_result(c)

    def _run(self) -> None:
        window = self._mb.queue.window_s
        try:
            while not (self._stop.is_set() and self._inbox.empty()):
                deadline = self._mb.queue.next_deadline()
                timeout = window if deadline is None else max(
                    min(deadline - self._now(), window), 1e-4
                )
                try:
                    item = self._inbox.get(timeout=timeout)
                    if item[0] is _MERGE:  # fast swap between batches
                        self._finish_merge(item[1])
                    else:
                        req, params = item
                        self._resolve(
                            self._mb.enqueue(req, params, self._now())
                        )
                except queue_mod.Empty:
                    pass
                self._resolve(self._mb.flush_due(self._now()))
            self._resolve(self._mb.flush_all(self._now()))
        except BaseException as exc:  # fail loudly: never strand futures
            with self._lock:
                pending, self._futures = self._futures, {}
                self._pending_keys.clear()
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(exc)
            raise
