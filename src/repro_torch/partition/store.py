"""Streaming shard residency: LRU-bounded device cache over partitions.

``SegmentStore`` is the out-of-core half of the IVF layer. Partitions live
cold on disk (or as host memmaps) and are materialized on the device only
while they are being probed, under a hard **resident-row cap**: before a
miss is loaded the store evicts least-recently-used partitions until the
incoming rows fit, so ``peak_resident_rows`` never exceeds the cap (the one
documented exception: a single partition larger than the whole cap still
loads after evicting everything; size the cap above the largest partition
bucket).

Rows are accounted at their padded *bucket* size (next power of two, floor
``bucket_min``) because that is what occupies device memory; the same
bucketing gives the searcher a few distinct partition shapes.

``prefetch(pid)`` overlaps the next probe's disk read and device transfer
with the current probe: a single background worker stages the padded
``ResidentPartition`` in a two-deep buffer, and the next ``get`` for that
pid claims it without blocking on I/O. The buffer is *staging only*: a
prefetched partition is charged against ``cap_rows`` only when ``get``
installs it, so the residency invariant is untouched; an entry that falls
off the buffer or is never claimed counts as ``prefetch_wasted``.

A partition travels as one buffer: its arrays are copied, padded in
place, into one staging buffer on the host (pinned on the card), which
goes to the device in one copy on the store's own stream; the resident
tensors are views into that device buffer, so an eviction frees one
allocation. The copy is waited for before the partition is handed out,
and the buffer is recorded on the default stream, where the searcher
reads it, so the caching allocator cannot reuse its memory while a kernel
that reads it is still queued after eviction.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.graph_ops import INVALID

Tensor = torch.Tensor

__all__ = ["PartitionData", "ResidentPartition", "SegmentStore", "row_bucket"]


def row_bucket(n: int, bucket_min: int = 256) -> int:
    """Next power-of-two row count ≥ max(n, bucket_min)."""
    b = bucket_min
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class PartitionData:
    """Host-side (possibly memory-mapped) partition payload from a loader."""

    features: np.ndarray  # (n, M) f32
    attrs: np.ndarray  # (n, L) i32
    graph: np.ndarray  # (n, Γ) i32; Γ = 0 when built scan-only
    codes: Optional[np.ndarray]  # (n, ...) quantized codes or None
    row_ids: np.ndarray  # (n,) global row ids


@dataclasses.dataclass
class ResidentPartition:
    """Device-resident partition, padded up to its row bucket.

    Pad rows carry zero features/attrs/codes, all-INVALID adjacency and
    ``row_ids == -1``; every consumer masks on ``row_ids >= 0``.
    """

    features: Tensor  # (b, M) f32
    attrs: Tensor  # (b, L) i32
    graph: Tensor  # (b, Γ) i32
    codes: Optional[Tensor]
    row_ids: Tensor  # (b,) i32, -1 beyond n_real
    n_real: int
    n_pad: int  # the bucket b: rows charged against the residency cap


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
}


def _layout(data: PartitionData, b: int) -> list:
    """(field, host array, dtype, pad fill) in buffer order: the 4-byte
    arrays first, the codes last, so every array starts on a 16-byte
    boundary (b is a power of two ≥ 256)."""
    out = [
        ("features", data.features, np.dtype(np.float32), 0),
        ("attrs", data.attrs, np.dtype(np.int32), 0),
        ("graph", data.graph, np.dtype(np.int32), INVALID),
        ("row_ids", data.row_ids, np.dtype(np.int32), -1),
    ]
    if data.codes is not None:
        out.append(("codes", data.codes, np.asarray(data.codes).dtype, 0))
    return out


class SegmentStore:
    """LRU residency manager keyed by partition id.

    ``loader(pid)`` produces host ``PartitionData``; the store pads it to
    its row bucket, copies it to ``device`` (None → the CUDA card), and
    tracks rows against ``cap_rows`` with an evict-before-load policy.
    Counters (``hits``/``loads``/``evictions``) and gauges
    (``resident_rows``/``peak_resident_rows``) count as the reference's do.

    Residency state and all counters are guarded by one re-entrant lock:
    under ``ThreadedServer`` the serve worker and the prefetch worker reach
    the store concurrently. ``loader`` I/O and the device transfer run
    *outside* the lock so a slow disk never serializes unrelated probes.

    ``pin(pids)`` marks partitions the LRU must not evict. Pinned
    partitions are materialized immediately, still charge ``cap_rows``,
    and are skipped by the eviction scan; when nothing evictable remains
    the evict-before-load loop gives up and loads over the cap (the same
    escape hatch as the single oversized partition).
    """

    def __init__(
        self,
        loader: Callable[[int], PartitionData],
        cap_rows: int,
        bucket_min: int = 256,
        device=None,
    ):
        if cap_rows <= 0:
            raise ValueError("cap_rows must be positive")
        self.loader = loader
        self.cap_rows = int(cap_rows)
        self.bucket_min = int(bucket_min)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._resident: "OrderedDict[int, ResidentPartition]" = OrderedDict()
        self._pinned: set = set()
        self.hits = 0
        self.loads = 0
        self.evictions = 0
        self.resident_rows = 0
        self.peak_resident_rows = 0
        # double-buffer prefetch: ≤ 2 staged loads (one being claimed by the
        # current probe, one in flight for the next) + lazy worker thread
        self._prefetch_lock = threading.Lock()
        self._staged: "OrderedDict[int, Future[ResidentPartition]]" = OrderedDict()
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        self._copy_stream = None  # the card's copy stream, made on first use
        self.prefetch_hits = 0
        self.prefetch_wasted = 0

    # -- residency -------------------------------------------------------

    def get(self, pid: int) -> ResidentPartition:
        with self._lock:
            hit = self._resident.get(pid)
            if hit is not None:
                self._resident.move_to_end(pid)
                self.hits += 1
                return hit
        part = self._claim_prefetch(pid)
        if part is None:
            part = self._materialize(pid)
        with self._lock:
            raced = self._resident.get(pid)
            if raced is not None:  # another thread installed it meanwhile
                self._resident.move_to_end(pid)
                self.hits += 1
                return raced
            # evict-before-load keeps the peak gauge under the cap; pinned
            # partitions are skipped, so the loop also stops when only
            # pinned rows remain
            while (
                self.resident_rows + part.n_pad > self.cap_rows
                and self._evict_lru()
            ):
                pass
            self._resident[pid] = part
            self.loads += 1
            self.resident_rows += part.n_pad
            self.peak_resident_rows = max(self.peak_resident_rows, self.resident_rows)
        return part

    # -- pinning -----------------------------------------------------------

    def pin(self, pids) -> None:
        """Replace the pinned set: the given partitions become unevictable
        and are materialized immediately (charging ``cap_rows`` as usual);
        previously pinned partitions fall back to plain LRU membership."""
        pids = set(int(p) for p in pids)
        with self._lock:
            self._pinned = pids
        for pid in sorted(pids):
            self.get(pid)

    def unpin(self) -> None:
        """Drop every pin (rows stay resident until the LRU evicts them)."""
        with self._lock:
            self._pinned = set()

    def pinned_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._pinned)

    @property
    def pinned_rows(self) -> int:
        """Resident rows (bucket-padded) currently held by pinned partitions."""
        with self._lock:
            return sum(p.n_pad for pid, p in self._resident.items() if pid in self._pinned)

    # -- prefetch ----------------------------------------------------------

    def prefetch(self, pid: int) -> None:
        """Stage ``pid`` in the background (no-op if resident or already
        staged). At most two loads are staged at once: the one the current
        probe is about to claim plus the one in flight behind it; an older
        entry that falls off the buffer was never claimed and counts as
        ``prefetch_wasted``."""
        with self._lock:
            if pid in self._resident:
                return
        with self._prefetch_lock:
            if pid in self._staged:
                return
            if self._prefetch_pool is None:
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="segment-prefetch"
                )
            self._staged[pid] = self._prefetch_pool.submit(self._materialize, pid)
            dropped = 0
            while len(self._staged) > 2:
                self._staged.popitem(last=False)
                dropped += 1
        if dropped:
            with self._lock:
                self.prefetch_wasted += dropped

    def _claim_prefetch(self, pid: int) -> Optional[ResidentPartition]:
        """Take ``pid``'s staged load if one exists (blocking on the
        in-flight transfer, still overlapped with the work that ran since
        ``prefetch``). Other entries stay staged."""
        with self._prefetch_lock:
            fut = self._staged.pop(pid, None)
        if fut is None:
            return None
        part = fut.result()
        with self._lock:
            self.prefetch_hits += 1
        return part

    def drop_prefetch(self) -> None:
        """Discard staged loads that were never claimed (counted wasted)."""
        with self._prefetch_lock:
            dropped = len(self._staged)
            self._staged.clear()
        if dropped:
            with self._lock:
                self.prefetch_wasted += dropped

    def _to_device(self, host: Tensor) -> Tensor:
        """The staged host buffer on the device. On the card: copied on the
        store's stream and waited for before it is returned, then recorded
        on the default stream, where it is read."""
        if self.device.type != "cuda":
            return host
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = host.to(self.device, non_blocking=True)
        self._copy_stream.synchronize()
        out.record_stream(torch.cuda.default_stream(self.device))
        return out

    def _materialize(self, pid: int) -> ResidentPartition:
        data = self.loader(pid)
        n = int(data.features.shape[0])
        b = row_bucket(n, self.bucket_min)
        fields = _layout(data, b)
        shapes = [(b,) + tuple(np.shape(a)[1:]) for _, a, _, _ in fields]
        sizes = [int(np.prod(sh)) * dt.itemsize for sh, (_, _, dt, _) in zip(shapes, fields)]
        host = torch.empty(sum(sizes), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        raw = host.numpy()
        views, off = {}, 0
        for (name, a, dt, fill), sh, size in zip(fields, shapes, sizes):
            dst = raw[off:off + size].view(dt).reshape(sh)
            np.copyto(dst[:n], a, casting="same_kind")
            dst[n:] = fill
            views[name] = (off, size, dt, sh)
            off += size
        dev = self._to_device(host)
        out = {name: dev[o:o + size].view(_TORCH_DTYPES[dt]).view(sh)
               for name, (o, size, dt, sh) in views.items()}
        return ResidentPartition(
            features=out["features"], attrs=out["attrs"], graph=out["graph"],
            codes=out.get("codes"), row_ids=out["row_ids"], n_real=n, n_pad=b,
        )

    def _evict_lru(self) -> bool:
        """Evict the least-recently-used *unpinned* partition (caller holds
        the lock). False when everything resident is pinned."""
        for pid in self._resident:
            if pid not in self._pinned:
                part = self._resident.pop(pid)
                self.resident_rows -= part.n_pad
                self.evictions += 1
                return True
        return False

    def evict_all(self) -> None:
        """Drop everything, pins included (a full reset, not an LRU pass)."""
        self.drop_prefetch()
        with self._lock:
            self._pinned = set()
            while self._resident and self._evict_lru():
                pass

    # -- introspection -----------------------------------------------------

    def resident_ids(self) -> list[int]:
        with self._lock:
            return list(self._resident.keys())

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "loads": self.loads,
                "evictions": self.evictions,
                "resident_partitions": len(self._resident),
                "resident_rows": self.resident_rows,
                "peak_resident_rows": self.peak_resident_rows,
                "cap_rows": self.cap_rows,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_wasted": self.prefetch_wasted,
                "pinned_partitions": len(self._pinned),
                "pinned_rows": self.pinned_rows,
            }

    def reset_counters(self) -> None:
        with self._lock:
            self.hits = self.loads = self.evictions = 0
            self.prefetch_hits = self.prefetch_wasted = 0
            self.peak_resident_rows = self.resident_rows
