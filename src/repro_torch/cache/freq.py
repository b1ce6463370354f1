"""Decayed access-frequency counters over global row ids.

The serving path already surfaces pool-head ids host-side in every
``SearchResult`` (the ``np.asarray(res.ids)`` the microbatcher performs
anyway), so frequency tracking is one ``np.add.at`` scatter per batch —
near-zero overhead on the hot path. Counts decay multiplicatively at tier
epoch boundaries (an exponentially-weighted moving average of per-epoch
access counts), so the hot set follows shifting popularity instead of
accumulating all-time counts.

Thread-safety: ``observe`` can race with ``end_epoch``/``snapshot`` under
``ThreadedServer`` (serve worker vs whoever drives promotion), so every
mutation holds the tracker lock.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["FrequencyTracker"]


class FrequencyTracker:
    """Per-row decayed EWMA access counters.

    ``observe(ids)`` folds a batch of returned row ids into the counters
    (INVALID/-1 slots and out-of-range ids are ignored); ``end_epoch()``
    multiplies everything by ``decay`` so older epochs fade geometrically.
    """

    def __init__(self, n_rows: int, decay: float = 0.5):
        if n_rows <= 0:
            raise ValueError("n_rows must be positive")
        if not (0.0 <= decay <= 1.0):
            raise ValueError("decay must lie in [0, 1]")
        self.n_rows = int(n_rows)
        self.decay = float(decay)
        self.counts = np.zeros(self.n_rows, np.float32)
        self.observed = 0  # valid ids folded in (all-time)
        self.epochs = 0
        self._lock = threading.Lock()

    def observe(self, ids) -> int:
        """Fold a batch of row ids (any shape) into the counters; returns
        how many valid ids were counted."""
        flat = np.asarray(ids).ravel()
        flat = flat[(flat >= 0) & (flat < self.n_rows)]
        if flat.size:
            with self._lock:
                np.add.at(self.counts, flat, np.float32(1.0))
                self.observed += int(flat.size)
        return int(flat.size)

    def end_epoch(self) -> None:
        with self._lock:
            self.counts *= np.float32(self.decay)
            self.epochs += 1

    def snapshot(self) -> np.ndarray:
        """Consistent copy of the counters (safe to rank outside the lock)."""
        with self._lock:
            return self.counts.copy()

    def stats(self) -> dict:
        with self._lock:
            return {
                "observed": self.observed,
                "epochs": self.epochs,
                "nonzero_rows": int(np.count_nonzero(self.counts)),
                "decay": self.decay,
            }
