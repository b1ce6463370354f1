"""Append-only delta segment (the LSM memtable of the index).

``DeltaSegment`` holds every row written since the last merge in
capacity-doubling host arrays: an upsert *appends* a new row and marks any
previous row for the same logical id dead (rows are never edited in place),
a delete just flips the alive bit. The host arrays are the source of truth:
``latest()`` and the merge read them.

A device mirror of the same four arrays grows with them and is written row
by row at ``append`` / ``kill``, so a search scans the delta where it lies
instead of copying it to the card. At query time the segment is served by
an exact ``fused_auto`` scan, and ``repro_torch.mutable.engine`` federates
its top-k with the frozen main index's.

Deleting or overwriting a frozen main row cannot touch the main index's
tensors, so ``MutableEngine`` records the id as a tombstone and filters it
out of main-side results. Capacity doubles (never shrinks): dead and
padding columns are masked to INF before the top-k.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.api.engine import admissible_matrix
from repro_torch.api.query import QueryBatch
from repro_torch.core import auto as auto_mod
from repro_torch.core import resolve_device, to_tensor
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID, smallest_k

__all__ = ["DeltaSegment"]

Tensor = torch.Tensor

_MIN_CAPACITY = 256


class DeltaSegment:
    """Mutable rows awaiting merge, scanned exactly at query time.

    Host arrays (capacity ``C`` ≥ ``size``):
      features (C, M) f32 · attrs (C, L) i32 · ids (C,) i64 · alive (C,) bool
    and their mirror on ``device`` (None → the CUDA card).

    ``row_of`` maps each logical id to its *latest* row (alive or dead: a
    dead latest row records a delete or overwrite whose last values the
    merge may still need for zombie rows).
    """

    def __init__(self, feat_dim: int, attr_dim: int, device=None):
        self.feat_dim = int(feat_dim)
        self.attr_dim = int(attr_dim)
        self.device = resolve_device(device)
        self._cap = 0
        self.size = 0
        self.features = np.zeros((0, self.feat_dim), np.float32)
        self.attrs = np.zeros((0, self.attr_dim), np.int32)
        self.ids = np.zeros((0,), np.int64)
        self.alive = np.zeros((0,), bool)
        self.row_of: dict = {}
        self._mirror = {
            name: torch.from_numpy(a).to(self.device)
            for name, a in self._host_arrays().items()
        }

    def _host_arrays(self) -> dict:
        return {"features": self.features, "attrs": self.attrs, "ids": self.ids,
                "alive": self.alive}

    # -- writes ---------------------------------------------------------------

    def _grow(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = max(_MIN_CAPACITY, self._cap or _MIN_CAPACITY)
        while cap < need:
            cap *= 2
        fills = {"features": 0, "attrs": 0, "ids": -1, "alive": False}
        for name, a in self._host_arrays().items():
            out = np.full((cap,) + a.shape[1:], fills[name], a.dtype)
            out[: a.shape[0]] = a
            setattr(self, name, out)
            old = self._mirror[name]
            dev = old.new_full((cap,) + tuple(old.shape[1:]), fills[name])
            dev[: old.shape[0]] = old
            self._mirror[name] = dev
        self._cap = cap

    def append(self, logical_id: int, vector, attrs) -> int:
        """Record an upsert: the new row becomes the id's latest (and only
        alive) delta row. Returns the row index."""
        self._grow(self.size + 1)
        prev = self.row_of.get(logical_id)
        if prev is not None:
            self.alive[prev] = False
            self._mirror["alive"][prev] = False
        row = self.size
        self.features[row] = np.asarray(vector, np.float32).reshape(-1)
        self.attrs[row] = np.asarray(attrs, np.int32).reshape(-1)
        self.ids[row] = logical_id
        self.alive[row] = True
        for name, a in self._host_arrays().items():
            self._mirror[name][row] = torch.from_numpy(a[row : row + 1])[0]
        self.row_of[logical_id] = row
        self.size += 1
        return row

    def kill(self, logical_id: int) -> bool:
        """Mark the id's delta row (if any) dead; True when one existed."""
        row = self.row_of.get(logical_id)
        if row is None or not self.alive[row]:
            return False
        self.alive[row] = False
        self._mirror["alive"][row] = False
        return True

    # -- views ----------------------------------------------------------------

    @property
    def n_alive(self) -> int:
        return int(self.alive[: self.size].sum())

    @property
    def n_rows(self) -> int:
        return self.size

    def count_alive(self, ids: Tensor) -> Tensor:
        """How many entries of ``ids`` (on the segment's device) name an
        alive delta row, as a 0-dim device tensor (no host sync)."""
        alive = self._mirror["ids"].masked_fill(~self._mirror["alive"], INVALID - 1)
        return torch.isin(ids.to(torch.int64), alive).sum()

    def latest(self) -> dict:
        """logical id → (vector, attrs, alive) of its latest delta row."""
        return {
            int(i): (
                self.features[r].copy(), self.attrs[r].copy(),
                bool(self.alive[r]),
            )
            for i, r in self.row_of.items()
        }

    # -- exact scan ------------------------------------------------------------

    def topk(
        self,
        queries: QueryBatch,
        k: int,
        metric_cfg: MetricConfig,
        oracle: bool,
        enforce: bool = False,
    ) -> Tuple[Tensor, Tensor]:
        """(B, k) logical ids (int32) and squared fused distances of the
        alive rows, on the segment's device.

        ``oracle=True`` mirrors a brute-planned main side: plain L2 ranking
        with every predicate hard-filtered. ``oracle=False`` mirrors a
        traversal plan: soft fused scoring under ``metric_cfg`` with the
        query mask, plus exact ONE_OF membership always and full hard
        predicates under ``enforce``. Scores are comparable with the main
        side's, so the federated merge is a plain sort. INVALID-padded when
        fewer than k rows qualify.

        Ties: one stable sort, the lower row first. The reference partitions
        (``np.argpartition``, not stable) before its stable sort, so the two
        can differ only among equal distances at the k-th place.
        """
        b = queries.batch_size
        dev = self.device
        if self.size == 0:
            return (torch.full((b, k), INVALID, dtype=torch.int32, device=dev),
                    torch.full((b, k), INF, dtype=torch.float32, device=dev))
        feats, attrs = self._mirror["features"], self._mirror["attrs"]
        qv = to_tensor(queries.vectors, torch.float32, dev)
        if oracle:
            d = auto_mod.brute_fused_sqdist(
                qv, to_tensor(queries.attrs, torch.int32, dev), feats, attrs,
                MetricConfig(mode="l2"),
            )
            ok = admissible_matrix(queries, attrs)
        else:
            d = auto_mod.brute_fused_sqdist(
                qv, to_tensor(queries.targets, torch.int32, dev), feats, attrs, metric_cfg,
                mask=None if queries.mask is None else to_tensor(queries.mask, torch.int32, dev),
            )
            # exact ONE_OF membership on every backend, every predicate
            # under enforce
            ok = admissible_matrix(queries, attrs, one_of_only=not enforce)
        d = d.masked_fill(~(ok & self._mirror["alive"][None, :]), INF)
        kk = min(k, self._cap)
        sq, rows = smallest_k(d, kk)
        ids = torch.where(sq < INF / 2, self._mirror["ids"][rows], INVALID).to(torch.int32)
        sq = sq.masked_fill(ids < 0, INF)
        if kk < k:
            ids = torch.cat([ids, ids.new_full((b, k - kk), INVALID)], 1)
            sq = torch.cat([sq, sq.new_full((b, k - kk), INF)], 1)
        return ids, sq
