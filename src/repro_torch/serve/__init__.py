"""Multi-tenant serving subsystem on top of ``repro_torch.api.Engine``.

Turns a stream of heterogeneous single ``(tenant, Query)`` requests into
the uniform, cache-hitting batches the plan→compile→execute pipeline was
built for:

  request ──admission──▶ RequestQueue ──window/bucket──▶ Microbatcher
  (token bucket,         (grouped by        (pad to bucket ladder,
   k/pool caps)           plan signature)    one Engine.search per group)

* ``Request`` / ``Completed`` / ``Rejected`` — typed request/response
  surface; load shedding is a result, not an exception.
* ``Upsert`` / ``Delete`` / ``WriteAck`` — the write path (engine must be
  a ``repro_torch.mutable.MutableEngine``; an engine without ``upsert``
  answers ``Rejected(immutable_engine)``): separate per-tenant write token
  buckets, writes applied before their ack resolves (read-your-writes),
  background delta→main merges that never block serving.
* ``TenantRegistry`` / ``TenantPolicy`` — per-tenant default
  ``SearchParams``, k/pool caps, deterministic token-bucket admission.
* ``Microbatcher`` / ``RequestQueue`` — coalesce admitted requests by
  compatible plan signature within a time/size window, pad each batch up a
  fixed bucket ladder so every batch replays a cached executable with
  nothing compiled after warmup; per-request results are bit-identical to
  serving each query alone (row-invariant entry pools, per-row traversal
  state, and batch-invariant kernels on the card).
* ``ServerStats`` — live metrics sampled without device round-trips
  (end-to-end latency percentiles, queue depth, batch-fill ratio, plan-
  cache hit rate and compiled plans, per-tenant QPS, shed counts).
* ``serve_loop`` — deterministic synchronous loop over a scripted
  ``(arrival_time, Request)`` trace (unit-testable without threads);
  ``ThreadedServer`` — thin wall-clock front-end for live serving
  (``launch/serve.py``).

Typical use::

    from repro_torch.serve import (
        Request, TenantPolicy, TenantRegistry, serve_loop,
    )

    reg = TenantRegistry()
    reg.register("acme", TenantPolicy(params=SearchParams(k=10),
                                      rate=500.0, burst=64))
    trace = [(i * 1e-4, Request("acme", q)) for i, q in enumerate(queries)]
    responses, stats = serve_loop(engine, trace, reg, window_ms=2.0)
    print(stats.snapshot())
"""
from repro_torch.serve.batcher import DEFAULT_BUCKETS, Microbatcher, RequestQueue
from repro_torch.serve.loop import ThreadedServer, serve_loop
from repro_torch.serve.request import (
    Completed, Delete, Rejected, Request, Response, Upsert, WriteAck,
)
from repro_torch.serve.stats import ServerStats
from repro_torch.serve.tenants import TenantPolicy, TenantRegistry, TokenBucket

__all__ = [
    "Completed",
    "DEFAULT_BUCKETS",
    "Delete",
    "Microbatcher",
    "Rejected",
    "Request",
    "RequestQueue",
    "Response",
    "ServerStats",
    "TenantPolicy",
    "TenantRegistry",
    "ThreadedServer",
    "TokenBucket",
    "Upsert",
    "WriteAck",
    "serve_loop",
]
