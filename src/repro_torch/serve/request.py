"""Serving request/response types.

A ``Request`` is one tenant-attributed declarative query. The serving loop
answers every submitted request with exactly one typed response:

* ``Completed`` — the per-query top-k (host numpy, sliced out of the
  coalesced batch) plus the request's own latency decomposition;
* ``Rejected``  — admission control shed the request *before* it consumed
  any device work (token budget exhausted, queue full, per-tenant cap
  violated, unknown tenant). Rejection is a result, not an exception: under
  overload the serving loop keeps draining at its provisioned rate and the
  caller sees exactly which requests were shed and why.

Writes are requests too: ``Upsert`` and ``Delete`` flow through the same
submission surface, pass a *separate* per-tenant write token bucket, and
are answered with a ``WriteAck`` (or ``Rejected``). A write is applied
before its ack resolves, so read-your-writes holds: any query submitted
after observing the ack sees the write. An engine without ``upsert`` (a
plain ``Engine``) answers each write ``Rejected(reason=REJECT_IMMUTABLE)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.api import Query, SearchParams

__all__ = [
    "Completed", "Delete", "Rejected", "Request", "Response", "Upsert",
    "WriteAck",
]

#: Rejection reasons emitted by admission control (``TenantRegistry.admit``)
#: and the bounded request queue.
REJECT_RATE = "rate_limit"  # token bucket empty for this tenant
REJECT_QUEUE = "queue_full"  # global pending-request bound hit
REJECT_K_CAP = "k_cap"  # per-request k above the tenant's cap
REJECT_POOL_CAP = "pool_cap"  # per-request pool above the tenant's cap
REJECT_UNKNOWN = "unknown_tenant"  # tenant not registered, no default policy
REJECT_DUPLICATE = "duplicate_id"  # request_id collides with one in flight
REJECT_STOPPED = "server_stopped"  # submitted to a stopped ThreadedServer
REJECT_WRITE_RATE = "write_rate_limit"  # write token bucket empty
REJECT_IMMUTABLE = "immutable_engine"  # write to an engine without upsert


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a tenant id plus a declarative ``Query``.

    ``params`` optionally overrides the tenant's default ``SearchParams``
    for this request only; the override must respect the tenant's k/pool
    caps or admission rejects it. ``request_id`` is assigned by the loop
    (submission order) when left at None.
    """

    tenant: str
    query: Query
    params: Optional[SearchParams] = None
    request_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Completed:
    """Successful response — per-query slices of the coalesced batch result.

    ``queue_ms`` is time spent waiting for the micro-batch window (the
    serving loop's clock domain: virtual under ``serve_loop``, wall under the
    threaded front-end); ``service_ms`` is the measured wall time of the
    batch execution this request rode in; ``bucket``/``batch_fill`` say how
    that batch was shaped (ladder size and real-row fraction).
    """

    request_id: int
    tenant: str
    ids: np.ndarray  # (k,) neighbor ids, INVALID-padded
    dists: np.ndarray  # (k,) fused distances
    queue_ms: float
    service_ms: float
    bucket: int
    batch_fill: float
    #: True when the payload came from the serve-layer ``ResultCache``
    #: (bit-identical to fresh execution; queue/service are ~0 and
    #: ``bucket=0`` — no batch was ridden). Trailing default keeps every
    #: existing positional constructor call valid.
    cached: bool = False

    @property
    def ok(self) -> bool:
        return True

    @property
    def latency_ms(self) -> float:
        return self.queue_ms + self.service_ms


@dataclasses.dataclass(frozen=True)
class Upsert:
    """One tenant-attributed write: insert (``id=None`` — the engine
    assigns the next sequential id) or overwrite (``id`` given) a single
    logical row. Answered with a ``WriteAck``."""

    tenant: str
    vector: np.ndarray
    attrs: np.ndarray
    id: Optional[int] = None
    request_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Delete:
    """Delete one logical row. ``applied=False`` in the ack when the id
    was not visible (already deleted, or never existed)."""

    tenant: str
    id: int
    request_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class WriteAck:
    """A write's typed response. The write is durable in the engine's
    delta (and visible to every later query) *before* this ack exists."""

    request_id: int
    tenant: str
    id: int
    op: str  # "upsert" | "delete"
    applied: bool  # False only for a delete of a non-visible id
    delta_rows: int  # delta occupancy right after this write

    @property
    def ok(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Load-shedding response: the request never reached the device."""

    request_id: int
    tenant: str
    reason: str  # one of the REJECT_* constants above

    @property
    def ok(self) -> bool:
        return False


Response = Union[Completed, WriteAck, Rejected]
