"""TieredEngine: frequency-aware hot/cold tiering over an ``api.Engine``.

Wraps a built engine the way ``MutableEngine`` does (the same ``search``
surface) with its own ``Executor``, so compiled closures resolve the
*tiered* searcher backends, and adds the frequency feedback loop:

    search → observe the returned row ids (already on the host) → every
    ``epoch_queries`` queries: decay the counters, recompute the hot set
    with hysteresis, rebuild the contiguous device slice / pinned
    partitions.

Execution changes only where the full-precision rerank gathers its rows:

* **flat quantized engines** (sq8/pq/pq4/opq-*): the graph backend runs the
  traversal over codes with ``routing.search_pool`` (no f32 operand at
  all), gathers the pool head through ``HotTier.gather`` (hot rows: one
  device ``index_select``; cold rows: a host gather and one copy) and
  emits through ``routing.rerank_gathered``, ``emit_topk``'s op sequence
  with the rows scored by the same ``gather_auto`` call. The brute ADC
  backend splices the same tier gather into its two-stage scan
  (``BruteForceSearcher._adc_two_stage``). Both are bit-identical to the
  untiered engine.
* **partitioned engines**: tiering is partition-granular (the chunk design
  of frequency-aware embedding caches): hot rows vote for their partitions
  and the top partitions under the row budget are pinned resident in the
  ``SegmentStore`` (the LRU never evicts them), so skewed probe streams
  stop paying reloads for their head.
* **unquantized plans** pass through: the rerank *is* the scan there, the
  full f32 matrix is already resident, and there is nothing to tier.

A ``MutableEngine`` is rejected as a base: merges renumber rows under the
tracker (the serve-layer ``ResultCache`` epoch covers write traffic
instead).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api import engine as engine_mod
from repro_torch.api.engine import Engine, SearchParams
from repro_torch.api.executor import Executor
from repro_torch.api.planner import Plan
from repro_torch.api.query import QueryBatch
from repro_torch.cache.freq import FrequencyTracker
from repro_torch.cache.tier import HotTier
from repro_torch.core import routing as routing_mod
from repro_torch.core import to_tensor
from repro_torch.core.routing import SearchResult
from repro_torch.obs import trace as obs_trace

__all__ = ["TieredEngine"]


class _TieredGraphSearcher(engine_mod.GraphSearcher):
    """HELP traversal over codes + tier-routed exact rerank."""

    def search(self, engine, queries, params, plan, entry_ids=None):
        if plan.quant_mode == "none":
            # exact plans gather nothing beyond the traversal itself
            return super().search(engine, queries, params, plan, entry_ids)
        idx = engine.index
        dev = engine.device
        cfg = plan.routing_cfg
        qv = to_tensor(queries.vectors, torch.float32, dev)
        qa = to_tensor(queries.targets, torch.int32, dev)
        mask = engine_mod._mask(engine, queries)
        n = idx.features.shape[0]
        if entry_ids is None:
            entry_ids = routing_mod.make_entry_ids(
                n, qv.shape[0], cfg.pool_size, params.seed, device=dev
            )
        r_ids, evals, hops = routing_mod.search_pool(
            idx.attrs, idx.graph, qv, qa, entry_ids, idx.metric_cfg, cfg, n,
            mask, idx.quant.routing_operand(qv),
        )
        cv = engine.tier.gather(r_ids.cpu().numpy())
        return routing_mod.rerank_gathered(
            cv, idx.attrs, r_ids, qv, qa, idx.metric_cfg, cfg, mask, evals, hops,
        )


class _TieredBruteSearcher(engine_mod.BruteForceSearcher):
    """ADC two-stage scan with the f32 rerank rows gathered through the
    tier; every other op is ``BruteForceSearcher._adc_two_stage``'s. Non-ADC
    brute plans (the exact oracle) pass through: they scan the full f32
    matrix, there is nothing to tier."""

    def _adc_two_stage(self, engine, queries, qv, qa, params, gather_rows=None):
        return super()._adc_two_stage(
            engine, queries, qv, qa, params,
            gather_rows=lambda cand: engine.tier.gather(cand.cpu().numpy()),
        )


class TieredEngine:
    """Engine wrapper adding frequency-tracked hot/cold tiering."""

    def __init__(
        self,
        engine: Engine,
        hot_rows: int = 0,
        epoch_queries: int = 512,
        decay: float = 0.5,
        hysteresis: float = 1.5,
    ):
        if not isinstance(engine, Engine):
            raise TypeError(
                "TieredEngine wraps a built repro_torch.api.Engine (wrap the "
                "engine, not a MutableEngine: tier row ids do not survive "
                "merges; write traffic is covered by the serve ResultCache epoch)"
            )
        if engine.is_sharded:
            raise ValueError(
                "sharded engines rerank inside their shard loop; tiering "
                "applies to flat and partitioned engines"
            )
        if epoch_queries <= 0:
            raise ValueError("epoch_queries must be positive")
        self.base = engine
        self.hot_rows = int(hot_rows)
        self.epoch_queries = int(epoch_queries)
        self.tracker = FrequencyTracker(engine.n_items, decay=decay)
        self._since_epoch = 0
        self._graph = _TieredGraphSearcher()
        self._brute = _TieredBruteSearcher()
        self._executor: Optional[Executor] = None
        self._pid_of: Optional[np.ndarray] = None  # partitioned: row → pid
        if engine.is_partitioned:
            self.tier = None
        else:
            self.tier = HotTier(
                engine.index.features.cpu().numpy(), hot_rows,
                hysteresis=hysteresis, device=engine.device,
            )

    # -- engine facade (duck-typed like MutableEngine) ---------------------

    @property
    def index(self):
        return self.base.index

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def is_partitioned(self) -> bool:
        return self.base.is_partitioned

    @property
    def n_items(self) -> int:
        return self.base.n_items

    @property
    def attr_dim(self) -> int:
        return self.base.attr_dim

    @property
    def quant_mode(self) -> str:
        return self.base.quant_mode

    @property
    def has_graph(self) -> bool:
        return self.base.has_graph

    @property
    def cost_model(self):
        return self.base.cost_model

    @property
    def host_attrs(self) -> np.ndarray:
        return self.base.host_attrs

    @property
    def write_epoch(self) -> int:
        return getattr(self.base, "write_epoch", 0)

    @property
    def executor(self) -> Executor:
        """Own executable cache: closures must resolve *tiered* backends."""
        if self._executor is None:
            self._executor = Executor(self, max_entries=self.base.executor_max_entries)
        return self._executor

    def searcher(self, name: str):
        if self.tier is not None and name == "graph":
            return self._graph
        if self.tier is not None and name == "brute":
            return self._brute
        return self.base.searcher(name)

    def plan(self, queries: QueryBatch, params: SearchParams) -> Plan:
        return self.base.plan(queries, params)

    def _predicate_filter(self, res, queries, full):
        return self.base._predicate_filter(res, queries, full)

    def invalidate_caches(self) -> None:
        self.base.invalidate_caches()
        if self._executor is not None:
            self._executor.clear()

    def save(self, path: str) -> None:
        self.base.save(path)

    # -- search + feedback loop --------------------------------------------

    def search(
        self,
        queries: Union[QueryBatch, tuple],
        params: SearchParams = SearchParams(),
    ) -> SearchResult:
        if isinstance(queries, tuple):
            queries = QueryBatch.match(*queries)
        with obs_trace.span("plan") as sp:
            plan = self.plan(queries, params)
            if sp:
                sp.set("backend", plan.backend)
                sp.set("quant_mode", plan.quant_mode)
                sp.set("reason", plan.reason)
                sp.set("cost_brute", plan.cost_brute)
                sp.set("cost_graph", plan.cost_graph)
                if plan.backend == "partitioned":
                    sp.set("nprobe", plan.nprobe)
                    sp.set("sub_backend", plan.sub_backend)
        sp = obs_trace.current()
        if sp and self.tier is not None:
            hot0, cold0 = self.tier.hot_row_hits, self.tier.cold_row_gathers
        res = self.executor.run(queries, params, plan)
        if sp and self.tier is not None:
            # the gather ran inside the executor's execute span; report this
            # request's tier split as counter deltas
            sp.set("tier_hot_hits", self.tier.hot_row_hits - hot0)
            sp.set("tier_cold_gathers", self.tier.cold_row_gathers - cold0)
        ids = res.ids.cpu().numpy()
        self.tracker.observe(ids)
        self._since_epoch += int(ids.shape[0])
        if self._since_epoch >= self.epoch_queries:
            self._since_epoch = 0
            self.refresh_tier()
        return res

    def refresh_tier(self) -> None:
        """End a frequency epoch: recompute the hot set (with hysteresis),
        rebuild the device slice / re-pin partitions, decay the counters."""
        counts = self.tracker.snapshot()
        if self.tier is not None:
            self.tier.promote(counts)
        elif self.hot_rows > 0:
            self._pin_partitions(counts)
        self.tracker.end_epoch()

    # -- partitioned tiering: pin hot partitions resident ------------------

    def _row_to_pid(self) -> np.ndarray:
        """(N,) global row id → partition id, built once from the
        per-partition ``row_ids`` arrays (memmaps when disk-backed)."""
        if self._pid_of is None:
            idx = self.base.index
            pid_of = np.full(self.n_items, -1, np.int32)
            for pid in range(idx.n_partitions):
                pid_of[np.asarray(idx._load_partition(pid).row_ids)] = pid
            self._pid_of = pid_of
        return self._pid_of

    def _pin_partitions(self, counts: np.ndarray) -> None:
        """Partition-granular promotion: sum row frequency per partition,
        greedily pin the hottest partitions whose padded row buckets fit
        under min(hot_rows, cap_rows)."""
        from repro_torch.partition.store import row_bucket

        idx = self.base.index
        store = idx.store
        per_pid = np.zeros(idx.n_partitions, np.float64)
        np.add.at(per_pid, self._row_to_pid(), counts)
        budget = min(self.hot_rows, store.cap_rows)
        pinned, rows = [], 0
        for pid in np.argsort(-per_pid, kind="stable"):
            if per_pid[pid] <= 0:
                break
            b = row_bucket(int(idx.summaries.n_rows[pid]), store.bucket_min)
            if rows + b > budget:
                continue  # a smaller hot partition may still fit
            pinned.append(int(pid))
            rows += b
        store.pin(pinned)

    # -- introspection -----------------------------------------------------

    def tier_stats(self) -> dict:
        """Tier counters for ``ServerStats`` and the launcher: flat engines
        report the ``HotTier`` gather split, partitioned engines the pinned
        set and the ``SegmentStore`` residency counters (pinned partitions
        turn probe loads into hits)."""
        out = {
            "hot_rows_budget": self.hot_rows,
            "epoch_queries": self.epoch_queries,
            "tracker": self.tracker.stats(),
        }
        if self.tier is not None:
            out.update(self.tier.stats())
        else:
            s = self.base.index.store.stats()
            total = s["hits"] + s["loads"]
            out.update(s)
            out["tier_hit_rate"] = (s["hits"] / total) if total else 0.0
        return out
