"""Executor: the compile/execute half of plan→compile→execute.

A plan signature (batch shape × predicate kind × resolved ``RoutingConfig``
× codec × backend) keys a bounded LRU of compiled executables: closures
holding the widened exec plan, the cached entry pool and the post-filter
decision. A cache hit pays one dict lookup plus the device work. Each miss
on the graph or sharded backend counts one compiled plan in
``core.routing.trace_count`` (the port has no jit; this is the counterpart
of the reference's trace count), so a repeated signature compiles nothing.

Padded rows never perturb real rows: all traversal state is per row and
the entry pool is row-invariant (``routing.make_entry_ids``), so a query
returns bit-identical top-k alone or inside a padded bucket batch.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import TYPE_CHECKING, Callable, NamedTuple, Optional

import torch

from repro_torch.api.query import QueryBatch
from repro_torch.core import lru_get
from repro_torch.core import routing as routing_mod
from repro_torch.core.routing import RoutingConfig, SearchResult
from repro_torch.obs import trace as obs_trace

if TYPE_CHECKING:
    from repro_torch.api.engine import Engine, SearchParams
    from repro_torch.api.planner import Plan

__all__ = ["Executor", "PlanSignature"]

#: Default executables kept per engine (override: ``Engine(executor_max_entries=...)``).
CACHE_SIZE = 256


class PlanSignature(NamedTuple):
    """Everything that changes the compiled executable; array values are
    runtime operands, not signature."""

    backend: str
    batch: int  # B
    feat_dim: int  # M
    targets_ndim: int  # 2 point | 3 interval
    has_mask: bool
    has_one_of: bool
    routing_cfg: Optional[RoutingConfig]
    quant_mode: str
    k: int
    seed: int
    enforce: bool
    pool: int  # effective pool
    rerank: int  # rerank_size
    nprobe: int = 0  # partitioned backend only
    sub_backend: str = ""  # partitioned backend only


class Executor:
    """Per-engine plan-signature cache of compiled search executables."""

    def __init__(self, engine: "Engine", max_entries: int = CACHE_SIZE):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self._engine = engine
        self.max_entries = max_entries
        self._cache: OrderedDict[PlanSignature, Callable] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def stats(self) -> dict:
        """Host-side cache counters: hits, misses, evictions, resident size
        and the configured bound."""
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "size": len(self._cache),
            "max_entries": self.max_entries,
        }

    def clear(self) -> None:
        """Drop every resident executable (the engine's index was swapped by
        a ``repro_torch.mutable`` merge, so the closures' entry pools are
        sized for the old N). The counters stay: ``ServerStats`` reports
        their growth since its construction, which must stay monotone across
        merges."""
        self._cache.clear()

    def signature(
        self, queries: QueryBatch, params: "SearchParams", plan: "Plan"
    ) -> PlanSignature:
        return PlanSignature(
            backend=plan.backend,
            batch=queries.batch_size,
            feat_dim=queries.vectors.shape[1],
            targets_ndim=queries.targets.ndim,
            has_mask=queries.mask is not None,
            has_one_of=queries.has_one_of,
            routing_cfg=plan.routing_cfg,
            quant_mode=plan.quant_mode,
            k=params.k,
            seed=params.seed,
            enforce=params.enforce_equality,
            pool=params.effective_pool,
            rerank=params.rerank_size,
            nprobe=plan.nprobe,
            sub_backend=plan.sub_backend,
        )

    def run(self, queries: QueryBatch, params: "SearchParams", plan: "Plan") -> SearchResult:
        with obs_trace.span("compile") as sp:
            sig = self.signature(queries, params, plan)
            size0 = len(self._cache)
            fn, hit = lru_get(
                self._cache, sig, lambda: self._compile(params, plan, sig),
                self.max_entries,
            )
            if hit:
                self.hits += 1
            else:
                self.misses += 1
                if len(self._cache) == size0:  # insert displaced the LRU
                    self.evictions += 1
            if sp:
                sp.set("hit", hit)
                sp.set("backend", sig.backend)
                sp.set("batch", sig.batch)
        with obs_trace.span("execute") as sp:
            res = fn(queries)
            if sp and not obs_trace.profiling():
                # a sampled request without the profiler: wait so the span
                # covers device time. Under the profiler its trace holds the
                # device time, and these waits and reads would move it.
                if res.ids.is_cuda:
                    torch.cuda.synchronize(res.ids.device)
                sp.set("n_hops", int(res.n_hops))
                sp.set("fp_evals", int(res.total_dist_evals))
                sp.set("code_evals", int(res.total_code_evals))
        return res

    def _compile(
        self, params: "SearchParams", plan: "Plan", sig: PlanSignature
    ) -> Callable[[QueryBatch], SearchResult]:
        """Build the executable for one signature: resolve the widened exec
        plan and the post-filter once, pre-generate the entry pool, and
        close over the backend."""
        engine = self._engine
        # the brute oracle filters exactly in-kernel, and so does a
        # partitioned plan whose sub-backend scans; traversals post-filter
        acts_like_brute = plan.backend == "brute" or (
            plan.backend == "partitioned" and plan.sub_backend == "brute"
        )
        do_filter = not acts_like_brute and (
            sig.has_one_of or (sig.enforce and sig.targets_ndim == 3)
        )
        exec_params, exec_plan = params, plan
        if do_filter:
            # widen the traversal cut from k to the whole exactly-scored
            # head: the covering-interval penalty admits in-hull non-members
            # with zero gap, so the membership filter below needs surplus
            # candidates to backfill the slots they displace. Exact search
            # scores the whole pool exactly; a quantized one its rerank head.
            cfg = plan.routing_cfg
            repl = {}
            if plan.quant_mode == "none":
                wide_k = cfg.pool_size
                repl["rerank_size"] = 0  # unused on the exact path
            else:
                wide_k = cfg.effective_rerank
            if wide_k > params.k:
                exec_params = dataclasses.replace(params, k=wide_k)
                exec_plan = dataclasses.replace(
                    plan, routing_cfg=dataclasses.replace(cfg, k=wide_k, **repl)
                )

        entry_ids = None
        if exec_plan.backend in ("graph", "sharded"):
            routing_mod.note_compiled_plan()
        if exec_plan.backend == "graph":  # sharded: each shard draws its own
            # the entry pool is a pure function of (N, B, pool, seed)
            entry_ids = routing_mod.make_entry_ids(
                engine.n_items, sig.batch, exec_plan.routing_cfg.pool_size,
                sig.seed, device=engine.device,
            )
        searcher = engine.searcher(exec_plan.backend)
        k = params.k
        enforce = params.enforce_equality

        def run(queries: QueryBatch) -> SearchResult:
            res = searcher.search(engine, queries, exec_params, exec_plan, entry_ids=entry_ids)
            if do_filter:
                # ONE_OF membership is exact on every backend; full predicate
                # enforcement only under enforce_equality. The pass re-sorts
                # so survivors keep the ascending-with-INVALID-tail invariant.
                with obs_trace.span("filter") as sp:
                    if sp:
                        sp.set("rows", queries.batch_size)
                    res = engine._predicate_filter(res, queries, enforce)
                if res.ids.shape[1] > k:
                    res = res._replace(
                        ids=res.ids[:, :k], dists=res.dists[:, :k], sqdists=res.sqdists[:, :k],
                    )
            return res

        return run
