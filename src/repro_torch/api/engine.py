"""Engine facade: one search entry point over the graph, sharded, brute
and partitioned backends.

``Engine.search(QueryBatch, SearchParams) -> SearchResult`` runs an
explicit plan→compile→execute pipeline:

  plan     ``api.planner``: a ``CostModel`` calibrated from one probe on the
           engine's own index picks brute or graph per batch
  compile  ``api.executor``: the plan signature keys a cache of compiled
           executables (widened exec plan, cached entry pool, post-filter)
  execute  a ``Searcher`` backend:
    graph  single-host HELP traversal (``gather_auto`` on every hop; on a
           quantized index over codes, then an exact ``gather_auto`` rerank
           of the pool head)
    sharded  the same traversal on every model shard of a
           ``ShardedStableIndex`` (``repro_torch.distributed``), an exact
           top-k merge, or a pooled rerank over codes
    brute  exact predicate oracle: hard filter + L2 top-k over every row
           (``fused_auto``); on a PQ-quantized index an ADC scan of every
           code (``adc_scan`` / ``adc_scan4``) and an exact rerank of the
           pool
    partitioned  IVF probe and merge over a ``PartitionedStableIndex``
           (``repro_torch.partition``): the brute or graph sub-backend in
           each probed partition, streamed through a ``SegmentStore``
           under a cap of resident rows

Value-set (ONE_OF) and range (BETWEEN) batches compile to [lo, hi]
interval targets that both backends score natively; ONE_OF membership is
then enforced exactly on every backend's output. MATCH and BETWEEN are hard
filters on the brute oracle and a soft AUTO penalty under traversal unless
``enforce_equality=True``.

The engine runs on the device that holds its index (``device=None`` at
construction → the CUDA card); a sharded engine merges on its first
shard's device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.api import executor as executor_mod
from repro_torch.api import planner as planner_mod
from repro_torch.api.executor import Executor
from repro_torch.api.planner import CostModel, Plan
from repro_torch.api.query import QueryBatch
from repro_torch.core import auto as auto_mod
from repro_torch.core import baselines as baselines_mod
from repro_torch.core import resolve_device, routing as routing_mod, to_tensor
from repro_torch.core.auto import DatasetStats, MetricConfig
from repro_torch.core.graph_ops import INF, INVALID, smallest_k
from repro_torch.core.help_graph import HelpConfig
from repro_torch.core.index import StableIndex
from repro_torch.core.routing import RoutingConfig, SearchResult
from repro_torch.distributed.search import SHARDED_META, ShardedStableIndex, is_sharded_dir
from repro_torch.kernels.gather_auto.ops import gather_auto
from repro_torch.obs import trace as obs_trace
from repro_torch.partition.index import PartitionedStableIndex, is_partitioned_dir
from repro_torch.quant import (
    QUANT_MODES, QuantConfig, QuantizedVectors, adc_scan, is_pq_mode,
)

Tensor = torch.Tensor

BACKENDS = ("auto", "graph", "sharded", "brute", "partitioned")
QUANT_PARAMS = ("auto",) + QUANT_MODES


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Consolidated per-request knobs, field for field the reference's.

    ``pool_size=0`` → max(4k, 32), ``pioneer_size=0`` → 8 (capped at the
    pool), ``rerank_size=0`` → whole pool. ``brute_threshold`` is deprecated
    (the planner's cost model decides). ``nprobe`` (0 → ≈√P) and
    ``sub_backend`` (auto | graph | brute) steer the partitioned backend.
    """

    k: int = 10
    pool_size: int = 0
    pioneer_size: int = 0
    rerank_size: int = 0
    quant: str = "auto"
    seed: int = 0
    enforce_equality: bool = False
    backend: str = "auto"
    brute_threshold: Optional[int] = None  # deprecated fixed-N override
    coarse_max_iters: int = 64
    refine_max_iters: int = 256
    use_visited: bool = True
    nprobe: int = 0
    sub_backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} ({BACKENDS})")
        if self.quant not in QUANT_PARAMS:
            raise ValueError(f"unknown quant {self.quant!r} ({QUANT_PARAMS})")
        if self.k <= 0:
            raise ValueError("k must be positive")
        if self.nprobe < 0:
            raise ValueError("nprobe must be nonnegative (0 → auto)")
        if self.sub_backend not in ("auto", "graph", "brute"):
            raise ValueError(
                f"unknown sub_backend {self.sub_backend!r} (auto | graph | brute)"
            )

    @property
    def effective_pool(self) -> int:
        return self.pool_size or max(4 * self.k, 32)

    def routing_config(self, quant_mode: str, enforce: bool) -> RoutingConfig:
        pool = self.effective_pool
        return RoutingConfig(
            k=self.k,
            pool_size=pool,
            pioneer_size=self.pioneer_size or min(8, pool),
            coarse_max_iters=self.coarse_max_iters,
            refine_max_iters=self.refine_max_iters,
            use_visited=self.use_visited,
            enforce_equality=enforce,
            quant_mode=quant_mode,
            rerank_size=self.rerank_size,
        )


@runtime_checkable
class Searcher(Protocol):
    """Backend contract: execute a compiled plan over an index.
    ``entry_ids`` is the executor-cached seed pool (graph backend)."""

    name: str

    def search(
        self, engine: "Engine", queries: QueryBatch, params: SearchParams,
        plan: Plan, entry_ids: Optional[Tensor] = None,
    ) -> SearchResult:
        ...


def _mask(engine: "Engine", queries: QueryBatch) -> Optional[Tensor]:
    return None if queries.mask is None else to_tensor(queries.mask, torch.int32, engine.device)


class GraphSearcher:
    """Single-host HELP-graph traversal."""

    name = "graph"

    def search(self, engine, queries, params, plan, entry_ids=None):
        idx = engine.index
        dev = engine.device
        return routing_mod.search(
            idx.features, idx.attrs, idx.graph,
            to_tensor(queries.vectors, torch.float32, dev),
            to_tensor(queries.targets, torch.int32, dev),
            idx.metric_cfg, plan.routing_cfg,
            mask=_mask(engine, queries), entry_ids=entry_ids, seed=params.seed,
            quant=idx.quant if plan.quant_mode != "none" else None,
        )


class ShardedSearcher:
    """Traversal on every model shard, a cross-shard rerank and an exact
    top-k merge (``ShardedStableIndex``). Entry pools are local to each
    shard, so the executor's global entry pool is ignored."""

    name = "sharded"

    def search(self, engine, queries, params, plan, entry_ids=None):
        dev = engine.device
        return engine.index.search(
            to_tensor(queries.vectors, torch.float32, dev),
            to_tensor(queries.targets, torch.int32, dev),
            k=params.k, routing_cfg=plan.routing_cfg,
            mask=_mask(engine, queries), seed=params.seed,
        )


class BruteForceSearcher:
    """Exact predicate oracle: hard filter + L2 ranking over every row.

      * point (MATCH/ANY) predicates delegate to ``brute_force_hybrid``;
      * ONE_OF / BETWEEN predicates run the same scan with exact
        set-membership / interval-containment filtering;
      * PQ codes with ``quant != "none"``: ``_adc_two_stage`` scans every
        code, then reranks the pool exactly. ``n_dist_evals`` counts the
        rerank, ``n_code_evals`` the N code scores.
    """

    name = "brute"

    def search(self, engine, queries, params, plan, entry_ids=None):
        idx = engine.index
        dev = engine.device
        qv = to_tensor(queries.vectors, torch.float32, dev)
        qa = to_tensor(queries.attrs, torch.int32, dev)
        if is_pq_mode(plan.quant_mode) and idx.quant is not None:
            return self._adc_two_stage(engine, queries, qv, qa, params)
        if not (queries.has_one_of or queries.has_intervals):
            return baselines_mod.brute_force_hybrid(
                idx.features, idx.attrs, qv, qa, params.k, mask=_mask(engine, queries)
            )
        sv2 = auto_mod.brute_fused_sqdist(
            qv, qa, idx.features, idx.attrs, MetricConfig(mode="l2")
        )
        return _filtered_topk(
            sv2, admissible_matrix(queries, idx.attrs), params.k, full_evals=idx.features.shape[0]
        )

    def _adc_two_stage(self, engine, queries, qv, qa, params, gather_rows=None):
        """ADC code scan → hard filter → exact rerank of the pool head.
        ``rerank_size`` bounds the exact stage as in the traversal path
        (0 → the whole pool). ``gather_rows`` maps the (B, P) candidates to
        their (B, P, M) f32 rows (the hot/cold tier, ``repro_torch.cache``);
        they are then scored by the same kernel call over a staged table
        (``routing.staged_operands``). None reads ``idx.features``."""
        idx = engine.index
        store = idx.quant
        scores = adc_scan(
            store.lut(qv), store.codes, qa, idx.attrs, mode="l2", packed=store.packed,
        )  # (B, N) approximate squared L2 from codes only
        n = scores.shape[1]
        pool = min(params.effective_pool, n)
        pool = min(max(params.rerank_size or pool, params.k), pool)
        code_sq, cand = smallest_k(scores.masked_fill(~admissible_matrix(queries, idx.attrs), INF), pool)
        cand = cand.to(torch.int32)
        if gather_rows is None:
            rd = gather_auto(qv, qa, idx.features, idx.attrs, cand, mode="l2")
        else:
            rows = routing_mod.staged_operands(gather_rows(cand), idx.attrs, cand)
            rd = gather_auto(qv, qa, *rows, mode="l2")
        rd = rd.masked_fill(code_sq >= INF / 2, INF)
        res = _filtered_topk(rd, torch.ones_like(rd, dtype=torch.bool), params.k,
                             full_evals=pool, ids=cand)
        return res._replace(n_code_evals=torch.full(
            (qv.shape[0],), n, dtype=torch.int32, device=qv.device))


def admissible_matrix(queries: QueryBatch, attrs: Tensor, one_of_only: bool = False) -> Tensor:
    """(B, N) admissibility of the rows ``attrs`` (N, L) on their device:
    equality for point batches, containment in [lo, hi] (equality on point
    dimensions) and exact ONE_OF set membership otherwise, the semantics of
    ``QueryBatch.admissible``. ``one_of_only`` constrains just the ONE_OF
    dimensions, as ``QueryBatch.admissible_rows(..., one_of_only=True)``."""
    if not (one_of_only or queries.has_one_of or queries.has_intervals):
        dev = attrs.device
        mask = None if queries.mask is None else to_tensor(queries.mask, torch.int32, dev)
        return baselines_mod._equality_ok(to_tensor(queries.attrs, torch.int32, dev), attrs, mask)
    return admissible_rows(queries, attrs[None], one_of_only)


def admissible_rows(queries: QueryBatch, rows: Tensor, one_of_only: bool = False) -> Tensor:
    """(B, K) admissibility of per-query rows ``rows`` (B, K, L), or of one
    table shared by every query (1, K, L), on their device: the semantics of
    ``QueryBatch.admissible_rows``, bit for bit. ``one_of_only`` tests ONE_OF
    membership over the ``-1``-padded ``allowed`` where ``hard``; otherwise
    containment in ``_bounds()``, membership and the wildcard ``mask``."""
    dev = rows.device
    if one_of_only and not queries.has_one_of:
        return torch.ones((queries.batch_size, rows.shape[1]), dtype=torch.bool, device=dev)
    # every operand goes up before any work is queued: a blocking upload
    # waits for the stream, and would otherwise wait for this test's own work
    if queries.has_one_of:
        allowed = to_tensor(queries.allowed, torch.int32, dev)
        hard = to_tensor(queries.hard, torch.bool, dev)
    if not one_of_only:
        lo, hi = (to_tensor(t, torch.int32, dev)[:, None, :] for t in queries._bounds())
        mask = None if queries.mask is None else to_tensor(queries.mask, torch.int32, dev)
    if queries.has_one_of:
        ok = (rows[..., None] == allowed[:, None, :, :]).any(-1) | ~hard[:, None, :]
        if one_of_only:
            return ok.all(-1)
    okl = (rows >= lo) & (rows <= hi)
    if queries.has_one_of:
        okl = okl & ok
    if mask is not None:
        okl = okl | (mask[:, None, :] == 0)
    return okl.all(-1)


def _filtered_topk(
    sq_scores: Tensor,
    ok: Tensor,
    k: int,
    full_evals: int,
    ids: Optional[Tensor] = None,
) -> SearchResult:
    """Top-k of masked scores → INVALID-padded SearchResult."""
    b = sq_scores.shape[0]
    dev = sq_scores.device
    sq, take = smallest_k(sq_scores.masked_fill(~ok, INF), k)
    out = take if ids is None else ids.gather(1, take)
    out = torch.where(torch.isfinite(sq) & (sq < INF / 2), out, INVALID).to(torch.int32)
    sq = sq.masked_fill(out < 0, INF)
    return SearchResult(
        ids=out,
        dists=torch.sqrt(torch.clamp_min(sq, 0.0)),
        sqdists=sq,
        n_dist_evals=torch.full((b,), full_evals, dtype=torch.int32, device=dev),
        n_hops=torch.zeros((), dtype=torch.int32, device=dev),
        n_code_evals=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


_SEARCHERS: dict[str, Searcher] = {
    s.name: s for s in (GraphSearcher(), ShardedSearcher(), BruteForceSearcher())
}


@dataclasses.dataclass
class Engine:
    """The one search facade over a single-host ``StableIndex``, a
    ``ShardedStableIndex`` or a ``PartitionedStableIndex``.

    ``cost_model`` may be injected at construction; otherwise it is
    calibrated lazily from one probe the first time an auto-plan needs it."""

    #: index-content version for the result cache: an immutable engine stays
    #: at 0; ``repro_torch.mutable.MutableEngine`` shadows it with a counter
    #: bumped inside its write lock before each write's ack. A class
    #: attribute, not a field, so equality and repr are untouched.
    write_epoch = 0

    index: Union[StableIndex, ShardedStableIndex, PartitionedStableIndex]
    cost_model_override: Optional[CostModel] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    executor_max_entries: int = dataclasses.field(
        default=executor_mod.CACHE_SIZE, repr=False, compare=False
    )
    _attrs_np: Optional[np.ndarray] = dataclasses.field(default=None, repr=False, compare=False)
    _attrs_dev: Optional[Tensor] = dataclasses.field(default=None, repr=False, compare=False)
    _cost_model: Optional[CostModel] = dataclasses.field(default=None, repr=False, compare=False)
    _executor: Optional[Executor] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def host_attrs(self) -> np.ndarray:
        """Host copy of the attribute matrix (copied once per engine; a
        partitioned index's is already a host array or memmap)."""
        if self._attrs_np is None:
            attrs = self.index.attrs
            self._attrs_np = attrs.cpu().numpy() if isinstance(attrs, Tensor) else attrs
        return self._attrs_np

    @property
    def device_attrs(self) -> Optional[Tensor]:
        """The attribute matrix on the engine's device: a flat index's own
        tensor, a sharded index's shards concatenated once per engine, or
        None where the index keeps it on the host (partitioned)."""
        if self._attrs_dev is None:
            attrs = self.index.attrs
            if not isinstance(attrs, Tensor):
                return None
            self._attrs_dev = attrs
        return self._attrs_dev

    @property
    def cost_model(self) -> CostModel:
        """The planner cost model (probe runs on first access unless one
        was injected)."""
        if self._cost_model is None:
            if self.cost_model_override is not None:
                self._cost_model = self.cost_model_override
            elif self.is_sharded:
                raise ValueError(
                    "cost_model applies to single-host engines only — a "
                    "sharded index always plans onto the sharded backend, "
                    "so there is no brute/graph crossover to calibrate"
                )
            elif self.is_partitioned:
                # no global arrays to probe; the model only prices the
                # sub-backend choice, so the prior will do (a measured
                # table can still be injected)
                self._cost_model = planner_mod.default_cost_model(self.index.n_items)
            else:
                self._cost_model = planner_mod.calibrate(self.index)
        return self._cost_model

    @property
    def executor(self) -> Executor:
        if self._executor is None:
            self._executor = Executor(self, max_entries=self.executor_max_entries)
        return self._executor

    def searcher(self, name: str) -> Searcher:
        if name == "partitioned" and name not in _SEARCHERS:
            # registered on first use, as the reference does
            from repro_torch.partition.search import PartitionedSearcher

            _SEARCHERS[name] = PartitionedSearcher()
        return _SEARCHERS[name]

    def invalidate_caches(self) -> None:
        """Drop what was derived from ``self.index`` after a merge swapped
        it (``repro_torch.mutable``): the attribute copies and every
        compiled executable (their closures hold entry pools sized for the
        old N). The cost model stays: it extrapolates across corpus growth,
        so a merge does not probe again."""
        self._attrs_np = None
        self._attrs_dev = None
        if self._executor is not None:
            self._executor.clear()

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        features,
        attrs,
        help_cfg: HelpConfig = HelpConfig(),
        quant_cfg: Optional[QuantConfig] = None,
        build_graph: bool = True,
        device=None,
        **kw,
    ) -> "Engine":
        """Build a single-host engine on ``device`` (None → the CUDA card),
        with ``quant_cfg``'s codec when given. ``build_graph=False`` skips
        the HELP construction for scan-only corpora."""
        return cls(StableIndex.build(
            features, attrs, help_cfg=help_cfg, quant_cfg=quant_cfg,
            build_graph=build_graph, device=device, **kw,
        ))

    @classmethod
    def build_partitioned(
        cls, features, attrs, n_partitions: int, device=None, **kw
    ) -> "Engine":
        """Build an out-of-core engine on ``device`` (None → the CUDA
        card): IVF coarse partitions over HELP subgraphs with streaming
        residency (see ``repro_torch.partition``). Keywords forward to
        ``PartitionedStableIndex.build``."""
        return cls(PartitionedStableIndex.build(
            features, attrs, n_partitions, device=device, **kw
        ))

    @classmethod
    def from_parts(
        cls,
        features,
        attrs,
        graph,
        metric_cfg: MetricConfig,
        stats: Optional[DatasetStats] = None,
        quant: Optional[QuantizedVectors] = None,
        help_cfg: HelpConfig = HelpConfig(),
        device=None,
    ) -> "Engine":
        """Wrap prebuilt arrays (and a codec store on the same device) on
        ``device`` (None → the CUDA card)."""
        dev = resolve_device(device)
        feats_np = features.cpu().numpy() if isinstance(features, Tensor) else np.asarray(features)
        attrs_np = attrs.cpu().numpy() if isinstance(attrs, Tensor) else np.asarray(attrs)
        if stats is None:
            stats = auto_mod.sample_stats(feats_np, attrs_np)
        return cls(StableIndex(
            features=to_tensor(feats_np, torch.float32, dev),
            attrs=to_tensor(attrs_np, torch.int32, dev),
            graph=to_tensor(graph, torch.int32, dev),
            metric_cfg=metric_cfg, help_cfg=help_cfg, stats=stats, quant=quant,
        ))

    # -- introspection -------------------------------------------------------

    @property
    def is_sharded(self) -> bool:
        return not isinstance(self.index, (StableIndex, PartitionedStableIndex))

    @property
    def is_partitioned(self) -> bool:
        return isinstance(self.index, PartitionedStableIndex)

    @property
    def n_items(self) -> int:
        if self.is_partitioned or self.is_sharded:
            return self.index.n_items
        return int(self.index.features.shape[0])

    @property
    def attr_dim(self) -> int:
        if self.is_sharded:
            return self.index.attr_dim
        return int(self.index.attrs.shape[1])

    @property
    def has_graph(self) -> bool:
        if self.is_partitioned or self.is_sharded:
            return self.index.has_graph
        return int(self.index.graph.shape[1]) > 0

    @property
    def quant_mode(self) -> str:
        """Codec attached to the index ("none" when unquantized)."""
        if self.is_partitioned or self.is_sharded:
            return self.index.quant_mode
        return self.index.quant.cfg.mode if self.index.quant is not None else "none"

    # -- planning ------------------------------------------------------------

    def _resolve_quant(self, params: SearchParams, backend: str) -> str:
        """The codec a search runs with: ``auto`` takes the index's, except
        that brute plus sq8 scans exactly (there is no sq8 scan kernel);
        ``none`` forces a full-precision search, except on a quantized
        sharded index, whose shards hold codes in place of f32 reads."""
        stored = self.quant_mode
        if params.quant == "auto":
            if backend == "brute" and stored == "sq8":
                return "none"
            return stored
        if params.quant == "sq8" and backend == "brute":
            raise ValueError(
                "the brute-force backend has no sq8 scan path; use quant='auto' or 'none'"
            )
        if params.quant == "none":
            if self.is_sharded and stored != "none":
                raise ValueError(
                    "quant='none' on a quantized sharded index is not "
                    "supported (codes are sharded in place of f32 reads)"
                )
            return "none"
        if params.quant != stored:
            raise ValueError(
                f"params.quant={params.quant!r} but the index holds {stored!r} codes"
            )
        return params.quant

    def plan(self, queries: QueryBatch, params: SearchParams) -> Plan:
        """Resolve (backend, quant_mode, routing_cfg, predicted costs) for
        one batch; see ``api.planner.make_plan``."""
        return planner_mod.make_plan(self, queries, params)

    # -- execution -----------------------------------------------------------

    def search(
        self,
        queries: Union[QueryBatch, tuple],
        params: SearchParams = SearchParams(),
    ) -> SearchResult:
        """Execute a compiled query batch: plan → executor → backend, on the
        engine's device. A plain ``(query_vectors, query_attrs)`` tuple is an
        all-MATCH batch."""
        if isinstance(queries, tuple):
            queries = QueryBatch.match(*queries)
        # under torch.profiler, a search with no span open is a root of its own
        with obs_trace.profiled_root("search") as root:
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
            if root:
                root.set("backend", plan.backend)
                root.set("batch", queries.batch_size)
            return self.executor.run(queries, params, plan)

    def _predicate_filter(
        self, res: SearchResult, queries: QueryBatch, full: bool
    ) -> SearchResult:
        """Hard-filter traversal output: ONE_OF membership always, every
        predicate (equality / interval containment) when ``full``. The
        candidates' rows are gathered on the device from a device table, or
        on the host from a host table (a partitioned index's) and uploaded;
        either way the test runs on the device."""
        table = self.device_attrs
        sp = obs_trace.current()  # the executor's "filter" span when recorded
        if sp:
            sp.set("on_device", table is not None)
        if table is not None:
            taken = table[res.ids.clamp_min(0)]  # (B, K, L)
        else:
            taken = to_tensor(
                self.host_attrs[np.maximum(res.ids.cpu().numpy(), 0)], torch.int32, self.device
            )
        ok = admissible_rows(queries, taken, one_of_only=not full) & (res.ids >= 0)
        # re-sort so survivors stay ascending with INVALID padding at the tail
        sq, take = smallest_k(res.sqdists.masked_fill(~ok, INF), res.sqdists.shape[1])
        out = res.ids.masked_fill(~ok, INVALID).gather(1, take)
        return res._replace(ids=out, dists=torch.sqrt(torch.clamp_min(sq, 0.0)), sqdists=sq)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the engine: the single-host ``stable-single-v1`` layout,
        ``stable-sharded-v1`` for a sharded index or
        ``stable-partitioned-v1`` for a partitioned one, with the planner
        cost model in the meta (a flat graph engine that has not planned
        yet runs the probe once here; a partitioned one takes the prior; a
        sharded one keeps a model only when one was injected)."""
        extra = {}
        cm = self._cost_model or self.cost_model_override
        if cm is None and not self.is_sharded and self.has_graph:
            cm = self.cost_model
        if cm is not None:
            extra["cost_model"] = cm.to_json()
        self.index.save(path, extra_meta=extra)

    @classmethod
    def load(
        cls,
        path: str,
        device=None,
        mmap: bool = False,
        residency_rows: Optional[int] = None,
        mesh=None,
    ) -> "Engine":
        """Load a saved engine (either package's) onto ``device`` (None →
        the CUDA card), sniffing the format. A persisted cost model is
        restored as ``cost_model_override``: load runs no probe.

        A sharded layout goes onto ``mesh`` (a ``launch.mesh.LocalMesh``;
        None → ``data=1`` and the saved shard count on ``device``).
        ``mmap`` memory-maps the single-host array files (partitioned
        layouts always map theirs: their rows reach the device per
        partition, on residency). ``residency_rows`` caps a partitioned
        layout's resident rows (see ``partition.SegmentStore``)."""
        meta_file = os.path.join(path, "meta.json")
        if is_sharded_dir(path):
            if residency_rows is not None:
                raise ValueError("residency_rows only applies to partitioned layouts")
            index = ShardedStableIndex.load(path, mesh=mesh, device=device)
            meta_file = os.path.join(path, SHARDED_META)
        elif mesh is not None:
            raise ValueError(f"{path} holds an unsharded engine; mesh= only applies to sharded layouts")
        elif is_partitioned_dir(path):
            index = PartitionedStableIndex.load(
                path, residency_rows=residency_rows, device=device
            )
        else:
            if residency_rows is not None:
                raise ValueError("residency_rows only applies to partitioned layouts")
            index = StableIndex.load(path, device=device, mmap=mmap)
        with open(meta_file) as f:
            saved_cm = json.load(f).get("cost_model")
        override = planner_mod.cost_model_from_table(saved_cm) if saved_cm else None
        return cls(index, cost_model_override=override)
