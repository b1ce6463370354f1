"""MutableEngine: writes without rebuild, reads federated over (main, delta).

The LSM view of the index: the frozen ``StableIndex`` is the immutable
segment, ``DeltaSegment`` is the memtable, ``tombstones`` mask deleted and
overwritten main rows, and an append-only ``oplog`` is the source of truth
the merge replays (``repro_torch.mutable.merge``).

Every query is planned once against the main index, executed through the
usual plan→compile→execute pipeline, and *federated* with an exact scan of
the delta. The delta scan mirrors the main plan's semantics (brute plan →
hard L2 oracle; traversal plan → soft fused scoring plus exact ONE_OF
membership, full predicates under ``enforce_equality``), so the two top-k
lists rank in the same currency and merge with one stable sort. A deleted
id is masked on both sides, an upserted id is masked in main and served
from its single alive delta row; recall over the unwritten corpus is what
the main plan delivers. Main ids and distances stay on the device: the
tombstone filter is ``torch.isin`` against a device tensor rebuilt only
when the tombstone set changes.

The main-side traversal is widened by a fixed policy (``k → max(2k,
k+16)``, capped by the pool) whenever tombstones could eat into the top-k;
fixed, so the plan signature does not depend on the delta or tombstone
sizes and the executor cache keeps hitting across the write stream. With
no writes at all the engine is a transparent proxy: bit-identical results,
the same cached executables.

Writes and reads take the engine lock. A merge swaps whole tensor
references (``StableIndex.apply_rows`` builds new ones) and never writes
the tensors a reader may hold.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Set

import numpy as np
import torch

from repro_torch.api import Engine, QueryBatch, SearchParams
from repro_torch.api.planner import CostModel
from repro_torch.core.graph_ops import INF, INVALID
from repro_torch.core.routing import SearchResult
from repro_torch.mutable.delta import DeltaSegment
from repro_torch.obs import trace as obs_trace

__all__ = ["CompactionPolicy", "MutableEngine", "WriteOp"]


@dataclasses.dataclass(frozen=True)
class WriteOp:
    """One logical write, as recorded in the oplog (arrays are copies: the
    log is immutable history the merge can replay at any time)."""

    kind: str  # "upsert" | "delete"
    id: int
    vector: Optional[np.ndarray] = None  # upsert only
    attrs: Optional[np.ndarray] = None  # upsert only


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When to fold the delta into the main index.

    Merge when the delta holds ``max_delta_rows`` rows, or, consulting the
    planner's cost model, when the extra per-query cost of scanning the
    delta (its brute cost plus one extra dispatch) exceeds
    ``max_cost_regression`` of the main query's own predicted cost. The cost
    gate is skipped below ``min_delta_rows`` so a trickle of writes never
    triggers churn merges.
    """

    max_delta_rows: int = 4096
    max_cost_regression: float = 0.25
    min_delta_rows: int = 64
    probe_pool: int = 64  # operating point the regression is priced at

    def should_merge(
        self,
        *,
        delta_rows: int,
        n_main: int,
        cost_model: Optional[CostModel] = None,
        has_graph: bool = True,
    ) -> bool:
        if delta_rows <= 0:
            return False
        if delta_rows >= self.max_delta_rows:
            return True
        if delta_rows < self.min_delta_rows or cost_model is None:
            return False
        pool = min(self.probe_pool, max(n_main, 1))
        main_cost = (
            cost_model.graph_cost(n=n_main, pool=pool, batch=1)
            if has_graph else cost_model.brute_cost(n=n_main, pool=pool)
        )
        # the delta rides on every query: a small exact scan plus one more
        # dispatch (the probe's measured batch_overhead)
        delta_cost = (
            cost_model.brute_cost(n=delta_rows, pool=pool)
            + cost_model.batch_overhead
        )
        return delta_cost >= self.max_cost_regression * max(main_cost, 1e-9)


class MutableEngine:
    """Engine facade with UPSERT/DELETE. Duck-types ``api.Engine`` for the
    serving stack (``plan``/``search``/``executor``/``n_items``), so the
    microbatcher and ``ServerStats`` work unchanged."""

    def __init__(
        self,
        engine: Engine,
        policy: CompactionPolicy = CompactionPolicy(),
        wal_path: Optional[str] = None,
        wal_fsync: bool = False,
    ):
        """``wal_path`` attaches a write-ahead log (``mutable.wal``): every
        write is logged before it is applied, and an existing log at that
        path is replayed here, so constructing over the last checkpointed
        engine rebuilds the logical state. ``checkpoint`` folds, saves and
        resets the log."""
        if not isinstance(engine, Engine):
            raise TypeError(
                "MutableEngine wraps a built repro_torch.api.Engine (a tiered "
                "engine is rejected too: merges renumber rows under its "
                "frequency tracker)"
            )
        if engine.is_sharded:
            raise ValueError(
                "MutableEngine wraps single-host engines (the sharded "
                "index has no incremental link path yet)"
            )
        if engine.is_partitioned:
            raise ValueError(
                "MutableEngine wraps single-host flat engines — the "
                "partitioned index's per-partition graphs have no "
                "incremental link path; apply writes to the flat engine "
                "and rebuild partitions, or shard the write stream"
            )
        self.engine = engine
        self.policy = policy
        #: index-content version for the result cache: bumped inside the
        #: write lock in ``_apply_op``, before any ack resolves, so an entry
        #: recorded under the old epoch never serves a post-write read. WAL
        #: replay bumps it once per recovered op.
        self.write_epoch = 0
        self.delta = DeltaSegment(self.feat_dim, engine.attr_dim, device=engine.device)
        self.tombstones: Set[int] = set()
        self.oplog: list = []
        self._lock = threading.RLock()
        self._next_id = engine.n_items
        self.merge_count = 0
        self.merge_ms: list = []
        self._tomb_dev: Optional[torch.Tensor] = None
        self._tomb_key = None
        dev = engine.device
        self._served_ids = torch.zeros((), dtype=torch.int64, device=dev)
        self._served_from_delta = torch.zeros((), dtype=torch.int64, device=dev)
        self.wal = None
        if wal_path is not None:
            from repro_torch.mutable.wal import WriteAheadLog

            self.wal = WriteAheadLog(wal_path, self.feat_dim, self.attr_dim, fsync=wal_fsync)
            for kind, id, vector, attrs in self.wal.replay():
                # already durable: apply without logging again
                self._apply_op(WriteOp(kind=kind, id=int(id), vector=vector, attrs=attrs),
                               log=False)
                self._next_id = max(self._next_id, int(id) + 1)

    # -- Engine duck-typing ----------------------------------------------------

    @property
    def index(self):
        return self.engine.index

    @property
    def executor(self):
        return self.engine.executor

    @property
    def cost_model(self):
        return self.engine.cost_model

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def feat_dim(self) -> int:
        return int(self.engine.index.features.shape[1])

    @property
    def attr_dim(self) -> int:
        return self.engine.attr_dim

    @property
    def n_items(self) -> int:
        """Logical (post-write) corpus size: main rows minus tombstones plus
        alive delta rows. An overwrite nets to zero (one tombstone, one
        alive delta row)."""
        return self.engine.n_items - len(self.tombstones) + self.delta.n_alive

    def plan(self, queries: QueryBatch, params: SearchParams):
        return self.engine.plan(queries, params)

    # -- writes ----------------------------------------------------------------

    def upsert(self, vector, attrs, id: Optional[int] = None) -> int:
        """Insert or overwrite one logical row; returns its id (assigned
        sequentially when not given). Visible to every later search."""
        with self._lock:
            if id is None:
                id = self._next_id
            id = int(id)
            if id < 0:
                raise ValueError("ids are nonnegative")
            self._next_id = max(self._next_id, id + 1)
            op = WriteOp(
                kind="upsert", id=id,
                vector=np.array(vector, np.float32).reshape(-1),
                attrs=np.array(attrs, np.int32).reshape(-1),
            )
            if op.vector.shape != (self.feat_dim,):
                raise ValueError(f"vector must have dim {self.feat_dim}, got {op.vector.shape}")
            if op.attrs.shape != (self.attr_dim,):
                raise ValueError(f"attrs must have dim {self.attr_dim}, got {op.attrs.shape}")
            self._apply_op(op)
            return id

    def delete(self, id: int) -> bool:
        """Delete one logical row; False (and no write) when the id is not
        visible."""
        with self._lock:
            id = int(id)
            if not self.exists(id):
                return False
            self._apply_op(WriteOp(kind="delete", id=id))
            return True

    def exists(self, id: int) -> bool:
        """Current visibility of one logical id."""
        with self._lock:
            row = self.delta.row_of.get(id)
            if row is not None:
                return bool(self.delta.alive[row])
            return 0 <= id < self.engine.n_items and id not in self.tombstones

    def _apply_op(self, op: WriteOp, log: bool = True) -> None:
        """Log and apply one write to the live (delta, tombstones) state;
        also the merge's replay entry point for ops after its snapshot.
        ``log=False`` skips the WAL for ops that are already durable (WAL
        replay at construction, the merge's tail)."""
        if log and self.wal is not None:
            # log before apply: an acknowledged write is on disk before it
            # is visible, so a crash loses at most unacknowledged ops
            self.wal.append(op.kind, op.id, op.vector, op.attrs)
        self.write_epoch += 1  # invalidates cached results before the ack
        self.oplog.append(op)
        if op.kind == "upsert":
            self.delta.append(op.id, op.vector, op.attrs)
        else:
            self.delta.kill(op.id)
        if op.id < self.engine.n_items:
            self.tombstones.add(op.id)  # mask the stale main row

    # -- federated read --------------------------------------------------------

    def _tombstones_on_device(self) -> torch.Tensor:
        """The tombstone set as a device tensor, rebuilt only when the set
        can have changed (a write or a merge)."""
        key = (self.write_epoch, self.merge_count)
        if self._tomb_key != key:
            tomb = np.fromiter(self.tombstones, np.int32, len(self.tombstones))
            self._tomb_dev = torch.from_numpy(tomb).to(self.device)
            self._tomb_key = key
        return self._tomb_dev

    def search(
        self, queries: QueryBatch, params: SearchParams = SearchParams()
    ) -> SearchResult:
        if isinstance(queries, tuple):
            queries = QueryBatch.match(*queries)
        with self._lock:
            if self.delta.n_alive == 0 and not self.tombstones:
                # no-write fast path: transparent proxy, bit-identical
                return self.engine.search(queries, params)
            k = params.k
            widened = self._widen(params)
            plan = self.engine.plan(queries, widened)
            res = self.engine.executor.run(queries, widened, plan)
            main_ids, main_sq = res.ids, res.sqdists
            if self.tombstones:
                dead = torch.isin(main_ids, self._tombstones_on_device())
                main_ids = main_ids.masked_fill(dead, INVALID)
                main_sq = main_sq.masked_fill(dead, INF)
            with obs_trace.span("delta_scan") as sp:
                d_ids, d_sq = self.delta.topk(
                    queries, k, self.engine.index.metric_cfg,
                    oracle=(plan.backend == "brute"),
                    enforce=params.enforce_equality,
                )
                if sp:
                    sp.set("delta_rows", int(self.delta.n_alive))
                    sp.set("tombstones", len(self.tombstones))
            # one currency on both sides (module docstring): one stable sort
            all_ids = torch.cat([main_ids, d_ids], dim=1)
            all_sq = torch.cat([main_sq, d_sq], dim=1)
            out_sq, order = torch.sort(all_sq, dim=1, stable=True)
            out_sq = out_sq[:, :k]
            out_ids = all_ids.gather(1, order[:, :k])
            out_ids = torch.where(out_sq < INF / 2, out_ids, INVALID)
            out_sq = out_sq.masked_fill(out_ids < 0, INF)
            self._served_ids += (out_ids >= 0).sum()
            self._served_from_delta += self.delta.count_alive(out_ids)
            return SearchResult(
                ids=out_ids,
                dists=torch.sqrt(torch.clamp_min(out_sq, 0.0)),
                sqdists=out_sq,
                n_dist_evals=(res.n_dist_evals + self.delta.n_alive).to(torch.int32),
                n_hops=res.n_hops,
                n_code_evals=res.n_code_evals,
            )

    @staticmethod
    def _widen(params: SearchParams) -> SearchParams:
        """Fixed main-side widening: enough surplus candidates to backfill
        the slots the tombstone filter eats, independent of the live delta
        and tombstone sizes, so the plan signature (and the executor cache)
        stays stable across the write stream."""
        pool = params.effective_pool
        k_main = min(pool, max(2 * params.k, params.k + 16))
        if k_main <= params.k:
            return params
        rerank = params.rerank_size
        if rerank and rerank < k_main:
            rerank = k_main
        return dataclasses.replace(params, k=k_main, pool_size=pool, rerank_size=rerank)

    # -- compaction ------------------------------------------------------------

    def should_merge(self) -> bool:
        """The compaction policy's live decision (host only)."""
        with self._lock:
            has_graph = self.engine.has_graph
            cm = None
            if has_graph:
                cm = self.engine._cost_model or self.engine.cost_model_override
            return self.policy.should_merge(
                delta_rows=self.delta.n_rows,
                n_main=self.engine.n_items,
                cost_model=cm,
                has_graph=has_graph,
            )

    def merge(self) -> Optional[dict]:
        """Synchronous merge: prepare (outside the lock) and apply. Returns
        the merge stats, or None when there was nothing to fold. The
        threaded server splits the two halves instead (``serve.loop``)."""
        from repro_torch.mutable import merge as merge_mod

        t0 = time.perf_counter()
        prepared = merge_mod.merge_prepare(self)
        if prepared is None:
            return None
        out = merge_mod.merge_apply(self, prepared)
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        self.merge_ms.append(out["wall_ms"])
        return out

    def checkpoint(self, path: str) -> Optional[dict]:
        """Fold the delta into the main index, save the merged engine at
        ``path`` and shrink the WAL to the tombstone set plus the (usually
        empty) unmerged tail: restart recovery is then ``Engine.load(path)``
        and ``MutableEngine(..., wal_path=...)``. Returns the merge stats
        (None when there was nothing to fold; the save and reset still
        run)."""
        stats = self.merge()
        with self._lock:
            self.engine.save(path)
            if self.wal is not None:
                # the save holds tombstoned ids as zombie rows; the set
                # itself lives only here, so the reset log states it as
                # deletes, then any ops that raced the merge
                self.wal.reset(
                    [("delete", t, None, None) for t in sorted(self.tombstones)]
                    + [(op.kind, op.id, op.vector, op.attrs) for op in self.oplog]
                )
        return stats

    # -- observability ---------------------------------------------------------

    def write_stats(self) -> dict:
        """Gauges for ``ServerStats``: host counters, and the served-id
        counts read back from the device."""
        with self._lock:
            served = int(self._served_ids)
            return {
                "delta_rows": self.delta.n_rows,
                "delta_alive": self.delta.n_alive,
                "tombstones": len(self.tombstones),
                "logical_n": self.n_items,
                "oplog_len": len(self.oplog),
                "wal_bytes": self.wal.n_bytes if self.wal is not None else 0,
                "merges": self.merge_count,
                "delta_result_fraction": round(
                    int(self._served_from_delta) / served, 4
                ) if served else 0.0,
            }
