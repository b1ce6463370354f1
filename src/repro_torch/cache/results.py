"""Serve-layer result cache: (tenant, query signature) → top-k payload.

Repeated/trending queries re-execute the full plan→compile→execute path
today even though the executor already made *compilation* free — the device
computation itself is the remaining cost. This cache keys the exact request
content (tenant, query vector bytes, predicate tuple, search params) and
returns the stored top-k ids/distances, which are bit-identical to what a
fresh execution would produce because the engine is deterministic for a
fixed index state.

"Fixed index state" is enforced with an **engine write epoch**: every
entry records ``engine.write_epoch`` captured when its request was
admitted (before execution), and a lookup only hits when the entry's epoch
equals the engine's current epoch (an immutable ``Engine`` stays at epoch
0). ``MutableEngine`` bumps the epoch inside the write lock *before* the
write's ack resolves, so:

* a cached entry can never serve a result computed before a write that has
  been acknowledged (read-your-writes holds through the cache);
* a result computed concurrently with a write is stored with the pre-write
  epoch and therefore never hits afterwards (conservative under-caching —
  stale data is structurally unreachable, a few extra misses are the cost).

Entries also carry an optional TTL against the *caller's* clock (the serve
loop's virtual clock or ``ThreadedServer``'s wall clock), and the whole
structure is a bounded LRU. All counters are lock-guarded — lookups and
inserts come from the serve worker while invalidation-relevant writes come
from merge/write threads.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np

__all__ = ["ResultCache", "result_key"]


def result_key(tenant: str, query, params) -> bytes:
    """Content signature of one request: blake2b over the tenant, the raw
    f32 vector bytes, the predicate tuple repr (``Predicate`` is a frozen
    dataclass of ints — repr is stable and canonical) and the
    ``SearchParams`` repr (frozen dataclass, same property)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(tenant.encode())
    h.update(b"\x00")
    h.update(np.ascontiguousarray(query.vector, np.float32).tobytes())
    h.update(b"\x00")
    h.update(repr(query.predicates).encode())
    h.update(b"\x00")
    h.update(repr(params).encode())
    return h.digest()


class CachedResult(NamedTuple):
    ids: np.ndarray  # (K,) i32, INVALID-padded
    dists: np.ndarray  # (K,) f32
    epoch: int  # engine write epoch the result was computed under
    expires: float  # caller-clock expiry (+inf when no TTL)
    empty: bool = False  # negative result: hard predicate pruned every row


class ResultCache:
    """Bounded LRU + TTL + epoch-validated result cache (thread-safe)."""

    def __init__(self, max_entries: int = 4096, ttl: Optional[float] = None):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        if ttl is not None and ttl <= 0:
            raise ValueError("ttl must be positive (None = no expiry)")
        self.max_entries = int(max_entries)
        self.ttl = ttl
        self._entries: "OrderedDict[bytes, CachedResult]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.invalidations = 0  # epoch-stale entries dropped at lookup
        self.expirations = 0  # TTL-expired entries dropped at lookup
        self.evictions = 0  # LRU displacement at insert
        #: hits on negative entries (all-INVALID payloads: the query's hard
        #: predicate pruned every row) — repeating an impossible predicate
        #: costs a dict lookup instead of a device scan
        self.empty_hits = 0

    def lookup(
        self, key: bytes, now: float, epoch: int
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Return ``(ids, dists)`` copies on a valid hit, else None. An
        entry from another write epoch is dropped (counted ``invalidations``)
        — the index changed since it was computed; a TTL-expired entry is
        dropped (counted ``expirations``)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            if entry.epoch != epoch:
                del self._entries[key]
                self.invalidations += 1
                self.misses += 1
                return None
            if now >= entry.expires:
                del self._entries[key]
                self.expirations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            if entry.empty:
                self.empty_hits += 1
            return entry.ids.copy(), entry.dists.copy()

    def insert(
        self,
        key: bytes,
        ids: np.ndarray,
        dists: np.ndarray,
        now: float,
        epoch: int,
    ) -> None:
        """Store a freshly computed payload under the epoch captured when
        its request was admitted (NOT the current epoch — if a write landed
        mid-flight the entry must already be stale)."""
        expires = float("inf") if self.ttl is None else now + self.ttl
        ids = np.asarray(ids)
        # negative-result caching: a hard predicate that prunes to zero
        # survivors yields an all-INVALID row — flag it so repeat lookups
        # of the impossible predicate are attributable (``empty_hits``)
        empty = bool(ids.size) and bool(np.all(ids < 0))
        with self._lock:
            self._entries[key] = CachedResult(
                ids=ids.copy(),
                dists=np.asarray(dists).copy(),
                epoch=int(epoch),
                expires=expires,
                empty=empty,
            )
            self._entries.move_to_end(key)
            self.insertions += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def reset_counters(self) -> None:
        """Zero the counters without touching entries (benchmark warmup)."""
        with self._lock:
            self.hits = self.misses = self.insertions = 0
            self.invalidations = self.expirations = self.evictions = 0
            self.empty_hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "empty_hits": self.empty_hits,
                "empty_entries": sum(
                    1 for e in self._entries.values() if e.empty
                ),
                "insertions": self.insertions,
                "invalidations": self.invalidations,
                "expirations": self.expirations,
                "evictions": self.evictions,
                "size": len(self._entries),
                "max_entries": self.max_entries,
                "ttl": self.ttl,
            }
