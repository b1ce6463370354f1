"""Hot/cold row tiering for the full-precision rerank gather.

Under a ``hot_rows`` budget the top-frequency rows are kept full-precision
and *contiguous* on the device (``hot_features``); the cold tail stays
where the engine keeps it: PQ/pq4 codes on the device for the traversal,
f32 rows in the host store (``features_host``, possibly a memmap) for the
rerank. The rerank gather then routes through ``slot_of``: hot candidates
resolve with one device ``index_select`` (no decode, no host traffic),
cold candidates are fancy-indexed on the host and sent over as one
(…, M) buffer, staged in pinned memory on a CUDA device.

Scores stay exact by construction: a hot row is a bit-identical copy of
its source f32 row, and the mixed gather combines the two sources with a
``torch.where`` that never touches the values, so tiering changes *where*
bytes come from, never what they are (``tests/test_torch_cache.py`` holds
the full search output bit-identical to the untiered engine).

Promotion and demotion run in epochs with hysteresis: resident rows get
their decayed frequency multiplied by ``hysteresis`` before the
top-``hot_rows`` cut, so a cold challenger must beat a resident by that
factor to displace it (no thrash on near-tied popularity).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import resolve_device

__all__ = ["HotTier"]


class HotTier:
    """Frequency-ranked hot row slice + tier-routed candidate gather."""

    def __init__(
        self,
        features_host: np.ndarray,  # (N, M) f32 host store (memmap ok)
        hot_rows: int,
        hysteresis: float = 1.5,
        device=None,
    ):
        """``device`` holds the hot slice and receives every gather (None →
        the CUDA card)."""
        if hot_rows < 0:
            raise ValueError("hot_rows must be nonnegative")
        if hysteresis < 1.0:
            raise ValueError("hysteresis must be ≥ 1 (1 = no stickiness)")
        if features_host.dtype != np.float32:
            features_host = np.asarray(features_host, np.float32)
        self.features_host = features_host
        self.device = resolve_device(device)
        self.n_rows = int(features_host.shape[0])
        self.hot_rows = min(int(hot_rows), self.n_rows)
        self.hysteresis = float(hysteresis)
        self.slot_of = np.full(self.n_rows, -1, np.int32)
        self.hot_ids = np.empty(0, np.int64)
        self.hot_features: Optional[torch.Tensor] = None  # (H, M), None while empty
        self._lock = threading.Lock()
        # pinned host buffer the cold rows are staged in (CUDA only); its
        # own lock, so the counters' lock is never held across a copy
        self._staging: Optional[torch.Tensor] = None
        self._stage_lock = threading.Lock()
        # row-granular gather counters (a candidate slot = one row gather)
        self.hot_row_hits = 0
        self.cold_row_gathers = 0
        self.promotions = 0
        self.demotions = 0
        self.epochs = 0

    # -- promotion ---------------------------------------------------------

    def promote(self, counts: np.ndarray) -> None:
        """Recompute the hot set from decayed frequency ``counts`` (N,).

        Residents keep a ``hysteresis`` score multiplier; rows with zero
        frequency are never promoted. The hot slice is rebuilt contiguously
        in ascending-id order (deterministic layout, stable slot map).
        """
        if self.hot_rows <= 0:
            return
        eff = np.asarray(counts, np.float64).copy()
        if self.hot_ids.size:
            eff[self.hot_ids] *= self.hysteresis
        top = np.argsort(-eff, kind="stable")[: self.hot_rows]
        new = np.sort(top[eff[top] > 0]).astype(np.int64)
        # the new slice is built before the lock: a gather in flight keeps
        # reading the old one
        hot = (
            torch.from_numpy(np.ascontiguousarray(self.features_host[new], np.float32)).to(
                self.device
            )
            if new.size
            else None
        )
        slot_of = np.full(self.n_rows, -1, np.int32)
        slot_of[new] = np.arange(new.size, dtype=np.int32)
        with self._lock:
            old = self.hot_ids
            self.promotions += int(np.setdiff1d(new, old).size)
            self.demotions += int(np.setdiff1d(old, new).size)
            # publish the new references together (gather snapshots them)
            self.hot_features = hot
            self.slot_of = slot_of
            self.hot_ids = new
            self.epochs += 1

    # -- gather ------------------------------------------------------------

    def gather(self, ids: np.ndarray) -> torch.Tensor:
        """(…, M) f32 candidate rows on the tier's device for host-side
        ``ids`` (INVALID → row 0, as ``graph_ops.gather_rows``), routed
        through the tier map."""
        with self._lock:
            slot_of, hot_features = self.slot_of, self.hot_features
        ids = np.maximum(np.asarray(ids, np.int64), 0)
        slots = slot_of[ids]
        hot = slots >= 0
        n_hot = int(hot.sum())
        n_cold = int(ids.size - n_hot)
        with self._lock:
            self.hot_row_hits += n_hot
            self.cold_row_gathers += n_cold
        m = int(self.features_host.shape[1])
        if n_hot and n_cold == 0:
            return self._take(hot_features, slots).reshape(*ids.shape, m)
        # cold rows gather on the host (hot slots read row 0, cheap; the
        # where below discards them) and go over as one (…, M) buffer
        host = self._to_device(np.where(hot, 0, ids))
        if n_hot == 0:
            return host
        dev = self._take(hot_features, np.maximum(slots, 0)).reshape(*ids.shape, m)
        return torch.where(torch.from_numpy(hot).to(self.device)[..., None], dev, host)

    def _take(self, table: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(np.ascontiguousarray(slots.reshape(-1), np.int64))
        return table.index_select(0, idx.to(self.device))

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """``features_host[rows]`` on the device: one fancy-index on the
        host and one host-to-device copy (from a reused pinned buffer on a
        CUDA device)."""
        m = int(self.features_host.shape[1])
        flat = rows.reshape(-1)
        if self.device.type != "cuda":
            out = np.ascontiguousarray(self.features_host[flat], np.float32)
            return torch.from_numpy(out).reshape(*rows.shape, m).to(self.device)
        with self._stage_lock:
            k = flat.size
            if self._staging is None or self._staging.shape[0] < k:
                cap = 1 << max(k - 1, 1).bit_length()
                self._staging = torch.empty((cap, m), dtype=torch.float32, pin_memory=True)
            buf = self._staging[:k]
            np.take(self.features_host, flat, axis=0, out=buf.numpy())
            # a blocking copy: the buffer is refilled by the next call
            out = buf.to(self.device)
        return out.reshape(*rows.shape, m)

    # -- introspection -----------------------------------------------------

    @property
    def hot_bytes(self) -> int:
        return 0 if self.hot_features is None else int(self.hot_ids.size) * int(
            self.features_host.shape[1]
        ) * 4

    def stats(self) -> dict:
        with self._lock:
            total = self.hot_row_hits + self.cold_row_gathers
            return {
                "hot_rows_budget": self.hot_rows,
                "hot_rows_resident": int(self.hot_ids.size),
                "hot_bytes": self.hot_bytes,
                "hot_row_hits": self.hot_row_hits,
                "cold_row_gathers": self.cold_row_gathers,
                "tier_hit_rate": (self.hot_row_hits / total) if total else 0.0,
                "promotions": self.promotions,
                "demotions": self.demotions,
                "epochs": self.epochs,
            }

    def reset_counters(self) -> None:
        with self._lock:
            self.hot_row_hits = self.cold_row_gathers = 0
