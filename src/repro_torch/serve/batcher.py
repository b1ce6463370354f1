"""Micro-batching onto the executor cache: coalesce → bucket → pad → run.

The executor (``api.executor``) was built for repeated fixed-shape batches:
one plan signature → one compiled executable → nothing compiled again. A live
multi-tenant stream is the opposite — heterogeneous single queries arriving
one at a time. The ``Microbatcher`` closes that gap:

* **coalesce** — admitted requests are grouped by *coalescing key*: the
  request's own B=1 plan signature (predicate kind × resolved routing
  params × codec × planned backend) with the batch-size field struck out.
  Two requests with the same key are served by the same executable, so they
  can share a device batch; planning each request at B=1 also pins the
  backend, so a request's batch never silently flips it onto different
  (brute-vs-traversal) semantics than it would get served alone.
* **bucket + pad** — each flushed group is padded up to a fixed bucket
  ladder (default 1/8/32/128) with inert rows, so the whole stream
  collapses onto ``|keys| × |ladder|`` resident executables and every
  coalesced batch replays a cached one, compiling nothing after warmup.
* **run** — one ``Engine.search`` per flushed group, then one sync on the
  engine's device (so the measured service time covers the device's work)
  and one host copy of the batch's ids and distances; per-request results
  are sliced back out host-side.

Padding is *provably* inert: all traversal state is per-row and the entry
pool is row-invariant (``routing.make_entry_ids``), so a real row's top-k
(ids and distances) is bit-identical to the same query served alone. Pad
rows are ANY-queries (mask = 0 — pure-ANN rows, the inert wildcard
form) whenever the group already carries a mask; mask-free groups
(all-MATCH) are padded by cloning the first real row instead, because an
ANY row cannot be expressed without introducing a mask — which would change
the plan signature and the scorer path the real rows compiled against.
Either way the pad rows' outputs are dropped on slice-out.

Flushing is clock-driven and synchronous: the owner (``serve_loop`` or the
threaded front-end) advances ``now`` and calls ``flush_due``; a group also
flushes eagerly the moment it fills the largest bucket.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import Engine, QueryBatch, SearchParams
from repro_torch.api.executor import PlanSignature
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Tracer
from repro_torch.serve.request import Completed, Request
from repro_torch.serve.stats import ServerStats

__all__ = ["DEFAULT_BUCKETS", "Microbatcher", "RequestQueue"]

DEFAULT_BUCKETS = (1, 8, 32, 128)


@dataclasses.dataclass
class _Pending:
    """One admitted request compiled and queued, awaiting its batch."""

    req: Request
    qb: QueryBatch  # compiled single-row batch
    params: SearchParams  # resolved (tenant default or override)
    backend: str  # B=1 planner decision, pinned at flush
    arrival: float  # loop-clock enqueue time
    sampled: bool = False  # tracer's per-request sampling decision


class RequestQueue:
    """Pending requests grouped by coalescing key, with per-group window
    deadlines (deadline = first enqueue + window) and a global depth."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._groups: "OrderedDict[PlanSignature, List[_Pending]]" = OrderedDict()
        self._deadlines: Dict[PlanSignature, float] = {}
        self.depth = 0

    def push(self, key: PlanSignature, pending: _Pending) -> int:
        group = self._groups.setdefault(key, [])
        if not group:
            self._deadlines[key] = pending.arrival + self.window_s
        group.append(pending)
        self.depth += 1
        return len(group)

    def due(self, now: float) -> List[PlanSignature]:
        """Keys whose window expired at ``now``, oldest deadline first."""
        ripe = [k for k, d in self._deadlines.items() if d <= now]
        return sorted(ripe, key=self._deadlines.__getitem__)

    def pop(self, key: PlanSignature) -> List[_Pending]:
        group = self._groups.pop(key, [])
        self._deadlines.pop(key, None)
        self.depth -= len(group)
        return group

    def keys(self) -> List[PlanSignature]:
        return list(self._groups)

    def next_deadline(self) -> Optional[float]:
        return min(self._deadlines.values()) if self._deadlines else None


class Microbatcher:
    """Coalesces compiled requests into padded bucket batches on one
    ``Engine``. Not thread-safe by itself — the threaded front-end owns it
    from a single worker thread; ``serve_loop`` drives it synchronously."""

    def __init__(
        self,
        engine: Engine,
        stats: ServerStats,
        window_s: float = 0.002,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        tracer: Optional[Tracer] = None,
    ):
        ladder = tuple(sorted(set(int(b) for b in buckets)))
        if not ladder or ladder[0] < 1:
            raise ValueError("buckets must be positive ints")
        self.engine = engine
        self.stats = stats
        self.buckets = ladder
        self.queue = RequestQueue(window_s)
        self.tracer = tracer

    # -- compile + enqueue ----------------------------------------------------

    def compile_key(
        self, qb: QueryBatch, params: SearchParams
    ) -> Tuple[PlanSignature, str]:
        """(coalescing key, planned backend) for one compiled request: the
        B=1 plan signature with the batch field struck out. The B=1 plan
        pins the backend so batched execution keeps the exact semantics
        (brute hard-filter oracle vs soft traversal) the request would get
        served alone."""
        plan = self.engine.plan(qb, params)
        sig = self.engine.executor.signature(qb, params, plan)
        return sig._replace(batch=0), plan.backend

    def enqueue(
        self, req: Request, params: SearchParams, now: float
    ) -> List[Completed]:
        """Queue one admitted request; returns flushed responses (non-empty
        only when this request filled the largest bucket)."""
        qb = QueryBatch.from_queries([req.query])
        key, backend = self.compile_key(qb, params)
        sampled = (
            self.tracer is not None and self.tracer.should_sample()
        )
        size = self.queue.push(
            key, _Pending(req, qb, params, backend, now, sampled)
        )
        self.stats.record_queue_depth(self.queue.depth)
        if size >= self.buckets[-1]:
            return self.flush(key, now)
        return []

    # -- flush ----------------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def flush_due(self, now: float) -> List[Completed]:
        out: List[Completed] = []
        for key in self.queue.due(now):
            out.extend(self.flush(key, now))
        return out

    def flush_all(self, now: float) -> List[Completed]:
        out: List[Completed] = []
        for key in self.queue.keys():
            out.extend(self.flush(key, now))
        return out

    def flush(self, key: PlanSignature, now: float) -> List[Completed]:
        group = self.queue.pop(key)
        if not group:
            return []
        self.stats.record_queue_depth(self.queue.depth)
        bucket = self.bucket_for(len(group))
        # one trace per flushed batch: the first sampled pending is the lead
        # request the trace narrates; the engine spans (plan/compile/
        # execute) attach under "batch" via the thread-local current span
        lead: Optional[_Pending] = None
        if self.tracer is not None:
            lead = next((p for p in group if p.sampled), None)
        trace = self.tracer.start("request") if lead is not None else None
        root = trace.root if trace is not None else obs_trace.NOOP_SPAN
        with root.span("batch") as batch_sp:
            with batch_sp.span("assemble"):
                qb = self._assemble(key, group, bucket)
            # pin the B=1 backend decision: the cost model's batch-amortized
            # crossover must not flip a coalesced batch onto other semantics
            params = dataclasses.replace(
                group[0].params, backend=group[0].backend
            )
            t0 = time.perf_counter()
            res = self.engine.search(qb, params)
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
            service_s = time.perf_counter() - t0
            if batch_sp:
                batch_sp.set("bucket", bucket)
                batch_sp.set("batch_real", len(group))
                batch_sp.set("pad_rows", bucket - len(group))
                batch_sp.set("backend", group[0].backend)
        ids = res.ids.cpu().numpy()  # one host copy per batch
        dists = res.dists.cpu().numpy()
        self.stats.record_batch(len(group), bucket, service_s)
        fill = len(group) / bucket
        out = []
        for i, p in enumerate(group):
            queue_ms = max(now - p.arrival, 0.0) * 1e3
            service_ms = service_s * 1e3
            self.stats.record_completion(p.req.tenant, queue_ms, service_ms)
            out.append(Completed(
                request_id=p.req.request_id,
                tenant=p.req.tenant,
                ids=ids[i].copy(),
                dists=dists[i].copy(),
                queue_ms=queue_ms,
                service_ms=service_ms,
                bucket=bucket,
                batch_fill=fill,
            ))
        if trace is not None:
            # the queue wait ran on the loop's clock (virtual in serve_loop,
            # wall in ThreadedServer) — attach it as a synthetic span ending
            # where the batch began, and pin the root to queue + batch so
            # the trace decomposes the end-to-end latency exactly
            queue_s = max(now - lead.arrival, 0.0)
            batch = root.children[0]
            root.t0 = batch.t0 - queue_s
            root.t1 = batch.t1
            root.add("queue", root.t0, queue_s)
            root.children.reverse()  # queue first, then batch
            root.set("tenant", lead.req.tenant)
            root.set("request_id", lead.req.request_id)
            root.set("queue_ms", queue_s * 1e3)
            root.set("service_ms", service_s * 1e3)
            root.set("cached", False)
            self.tracer.finish(trace)
        return out

    # -- batch assembly --------------------------------------------------------

    def _assemble(
        self, key: PlanSignature, group: List[_Pending], bucket: int
    ) -> QueryBatch:
        """Stack the group's single-row batches and pad to ``bucket`` rows.

        All rows share the key's structure (mask presence, interval
        presence, ONE_OF presence), so stacking is pure concatenation apart
        from the ONE_OF ``allowed`` value-set width, which pads to the
        group max with -1 (exactly how ``QueryBatch.from_queries`` pads a
        heterogeneous batch).
        """
        n, pad = len(group), bucket - len(group)
        vectors = np.concatenate([p.qb.vectors for p in group])
        attrs = np.concatenate([p.qb.attrs for p in group])
        mask = intervals = allowed = hard = None
        if key.has_mask:
            mask = np.concatenate([p.qb.mask for p in group])
        if key.targets_ndim == 3:
            intervals = np.concatenate([p.qb.intervals for p in group])
        if key.has_one_of:
            v = max(p.qb.allowed.shape[2] for p in group)
            allowed = np.full((n, attrs.shape[1], v), -1, np.int32)
            for i, p in enumerate(group):
                allowed[i, :, : p.qb.allowed.shape[2]] = p.qb.allowed[0]
            hard = np.concatenate([p.qb.hard for p in group])
        if pad:
            if key.has_mask:
                # inert ANY rows: every dimension wildcarded (pure ANN)
                vectors = np.concatenate(
                    [vectors, np.zeros((pad,) + vectors.shape[1:], vectors.dtype)]
                )
                attrs = np.concatenate(
                    [attrs, np.zeros((pad,) + attrs.shape[1:], attrs.dtype)]
                )
                mask = np.concatenate(
                    [mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)]
                )
                if intervals is not None:
                    intervals = np.concatenate([
                        intervals,
                        np.zeros((pad,) + intervals.shape[1:], intervals.dtype),
                    ])
                if allowed is not None:
                    allowed = np.concatenate([
                        allowed,
                        np.full((pad,) + allowed.shape[1:], -1, allowed.dtype),
                    ])
                    hard = np.concatenate(
                        [hard, np.zeros((pad,) + hard.shape[1:], hard.dtype)]
                    )
            else:
                # mask-free (all-MATCH) group: an ANY row would introduce a
                # mask and change the compiled signature — clone row 0
                # instead (equally inert: outputs are dropped on slice-out)
                def clone(a):
                    return (
                        None if a is None
                        else np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                    )

                vectors, attrs = clone(vectors), clone(attrs)
                intervals, allowed, hard = (
                    clone(intervals), clone(allowed), clone(hard)
                )
        return QueryBatch(
            vectors, attrs, mask=mask, allowed=allowed, hard=hard,
            intervals=intervals,
        )
