"""Execution planner: calibrated cost model + backend selection.

The planner turns one (QueryBatch, SearchParams) pair into a ``Plan``.
Backend choice is driven by a ``CostModel`` measured on the engine's own
index rather than a fixed size threshold:

  brute cost ≈ N full-precision scorings (at the measured scan discount),
               or with PQ codes N code scorings at a fractional cost plus a
               pool-sized exact rerank (the ``adc_scan`` path);
  graph cost ≈ measured candidate scorings per pool slot × pool size,
               grown logarithmically with corpus size, widened for wide
               (interval) predicates, plus a fixed dispatch overhead
               amortized over the batch.

Costs are in full-precision-evaluation units, the currency
``SearchResult.n_dist_evals`` reports, so one cheap probe traversal at
build/load time calibrates the model (``calibrate``), or a measured table
is loaded (``cost_model_from_table``). The probe times the card: its
decision near the crossover is not deterministic, so callers that need a
frozen decision pin ``SearchParams(backend=...)`` or inject a model.

On a quantized index the probe routes over codes, as serving will, and
fits on the code scorings. A partitioned index plans onto the partitioned
backend, which resolves ``nprobe`` and prices the brute or graph
sub-backend at the average partition size (``_plan_partitioned``); it runs
no probe. A sharded index always plans onto the sharded backend, which
has no brute/graph crossover to price.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.api.query import QueryBatch
from repro_torch.core import routing as routing_mod
from repro_torch.core.auto import MetricConfig, brute_fused_sqdist
from repro_torch.core.graph_ops import smallest_k
from repro_torch.core.routing import RoutingConfig
from repro_torch.quant.store import is_packed_mode, is_pq_mode

if TYPE_CHECKING:  # engine imports planner; never the reverse at runtime
    from repro_torch.api.engine import Engine, SearchParams

__all__ = [
    "CostModel",
    "Plan",
    "calibrate",
    "calibration_count",
    "cost_model_from_table",
    "default_cost_model",
    "make_plan",
]

#: Probe-traversal shape used by ``calibrate``.
PROBE_BATCH = 8
PROBE_POOL = 32
#: Pool sizes of the traversal sweep: two points fit slope and intercept.
PROBE_POOLS = (16, 32)
#: Corpus-prefix fractions of the brute-scan timing sweep.
PROBE_N_FRACTIONS = (0.25, 0.5, 1.0)

_CALIBRATION_COUNT = [0]


def calibration_count() -> int:
    """Total calibration probes run so far in this process."""
    return _CALIBRATION_COUNT[0]


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved execution plan, inspectable via ``Engine.plan``."""

    backend: str  # graph | brute | partitioned
    quant_mode: str  # none | sq8 | pq-family (resolved from params × index)
    routing_cfg: Optional[RoutingConfig]  # None unless a traversal runs
    reason: str  # human-readable planner justification
    cost_brute: Optional[float] = None  # predicted brute cost (fp-eval units)
    cost_graph: Optional[float] = None  # predicted graph cost (fp-eval units)
    sub_backend: str = ""  # partitioned backend only
    nprobe: int = 0  # partitioned backend only


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-query search-cost predictor in full-precision-eval units."""

    unit_evals: float  # candidate scorings per pool slot at the probe point
    probe_pool: int  # pool size the probe ran at
    probe_n: int  # corpus size the probe ran at
    code_eval_cost: float = 0.25  # one code scoring vs one fp scoring
    batch_overhead: float = 64.0  # fixed dispatch cost per batch (fp units)
    brute_eval_cost: float = 1.0  # wall cost of one brute-scan eval vs one
    # traversal eval, measured by the probe
    pool_intercept: float = 0.0  # pool-independent scorings per query

    def __post_init__(self):
        if self.unit_evals <= 0 or self.probe_pool <= 0 or self.probe_n <= 0:
            raise ValueError("CostModel needs positive probe measurements")

    def _scale(self, n: int) -> float:
        """Corpus-growth factor: walks lengthen ~logarithmically with N."""
        return max(1.0, math.log(max(n, 2)) / math.log(max(self.probe_n, 2)))

    def graph_evals(self, *, n: int, pool: int, width: float = 0.0) -> float:
        """Predicted candidate scorings per query for one traversal."""
        per_query = self.pool_intercept + self.unit_evals * pool
        return per_query * self._scale(n) * (1.0 + width)

    def code_cost(self, quant_mode: str) -> float:
        if is_packed_mode(quant_mode):
            return 0.5 * self.code_eval_cost
        return self.code_eval_cost

    def graph_cost(
        self,
        *,
        n: int,
        pool: int,
        batch: int = 1,
        width: float = 0.0,
        quant_mode: str = "none",
        rerank: int = 0,
    ) -> float:
        """Per-query traversal cost (codec traversals add a rerank)."""
        evals = self.graph_evals(n=n, pool=pool, width=width)
        if quant_mode == "none":
            cost = evals
        else:
            cost = self.code_cost(quant_mode) * evals + float(min(rerank or pool, pool))
        return cost + self.batch_overhead / max(batch, 1)

    def brute_cost(self, *, n: int, pool: int, quant_mode: str = "none") -> float:
        """Per-query scan cost: N exact scorings at the measured discount."""
        if is_pq_mode(quant_mode):
            return (
                self.brute_eval_cost * self.code_cost(quant_mode) * n
                + float(min(pool, n))
            )
        return self.brute_eval_cost * float(n)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def cost_model_from_table(table) -> CostModel:
    """Rebuild a ``CostModel`` from a measured table: the dict/path of a
    planner benchmark artifact (its ``cost_model`` section) or a bare field
    dict."""
    if isinstance(table, (str, bytes)):
        with open(table) as f:
            table = json.load(f)
    d = table.get("cost_model", table)
    kw = {k: d[k] for k in ("unit_evals", "probe_pool", "probe_n")}
    for k in ("code_eval_cost", "batch_overhead", "brute_eval_cost", "pool_intercept"):
        if k in d:
            kw[k] = d[k]
    return CostModel(**kw)


def default_cost_model(n: int) -> CostModel:
    """Uncalibrated prior (generic constants)."""
    return CostModel(unit_evals=4.0, probe_pool=PROBE_POOL, probe_n=max(int(n), 2))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate(index, seed: int = 0, time_probe: bool = True) -> CostModel:
    """Fit a ``CostModel`` from a small probe sweep on ``index``.

    PROBE_BATCH database rows (spread over the corpus) serve as queries
    with their own attributes as targets; small capped traversals at each
    ``PROBE_POOLS`` point fit ``unit_evals`` and ``pool_intercept``. On a
    quantized index the probes route over codes and the fit counts the
    code scorings. With ``time_probe`` it also times the brute scan at the
    ``PROBE_N_FRACTIONS`` prefixes and the traversal (best of two runs,
    ending in a device synchronize): the least-squares line through the
    scan timings gives ``brute_eval_cost`` (scan vs traversal wall cost per
    eval) and a measured ``batch_overhead``.
    """
    _CALIBRATION_COUNT[0] += 1
    dev = index.features.device
    n = int(index.features.shape[0])
    take = torch.from_numpy(
        np.linspace(0, n - 1, num=min(PROBE_BATCH, n)).astype(np.int64)
    ).to(dev)
    qv = index.features[take]
    qa = index.attrs[take]
    b = int(qv.shape[0])
    pools = sorted({min(p, n) for p in PROBE_POOLS})

    def traversal_cfg(pool: int) -> RoutingConfig:
        return RoutingConfig(
            k=min(8, pool), pool_size=pool, pioneer_size=min(8, pool),
            coarse_max_iters=8, refine_max_iters=32,
        )

    def run_traversal(cfg: RoutingConfig):
        return routing_mod.search(
            index.features, index.attrs, index.graph, qv, qa,
            index.metric_cfg, cfg, seed=seed, quant=index.quant,
        )

    # unit_evals/pool_intercept price traversal scorings only: on a
    # quantized index the probes' fp evals are the exact rerank, which
    # graph_cost prices as its own term
    per_query: dict[int, float] = {}
    wall_per_query: dict[int, float] = {}
    for pool in pools:
        res = run_traversal(traversal_cfg(pool))
        per_query[pool] = float(
            res.mean_dist_evals if index.quant is None else res.mean_code_evals
        )
        wall_per_query[pool] = float(res.mean_dist_evals + res.mean_code_evals)
    p_hi = pools[-1]
    if len(pools) >= 2:
        p_lo = pools[0]
        slope = (per_query[p_hi] - per_query[p_lo]) / (p_hi - p_lo)
        intercept = per_query[p_lo] - slope * p_lo
        if slope <= 0 or intercept < 0:
            # a degenerate sweep must not give a decreasing or negative
            # cost curve: fall back to the slope-only fit
            slope, intercept = per_query[p_hi] / p_hi, 0.0
    else:
        slope, intercept = per_query[p_hi] / p_hi, 0.0

    brute_eval_cost = 1.0
    overhead_kw = {}
    if time_probe:
        cfg_hi = traversal_cfg(p_hi)

        def run_brute(ni: int):
            sv2 = brute_fused_sqdist(
                qv, qa, index.features[:ni], index.attrs[:ni], MetricConfig(mode="l2")
            )
            return smallest_k(sv2, min(cfg_hi.k, ni))[0]

        def best_of_two(fn) -> float:
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                times.append(time.perf_counter() - t0)
            return min(times)

        sizes = sorted({max(int(n * f), 1) for f in PROBE_N_FRACTIONS})
        t_scan: dict[int, float] = {}
        for ni in sizes:
            run_brute(ni)  # warm up off the clock
            _sync(dev)
            t_scan[ni] = best_of_two(lambda ni=ni: run_brute(ni))
        t_graph = best_of_two(lambda: run_traversal(cfg_hi))
        per_graph_eval = t_graph / max(wall_per_query[p_hi] * b, 1.0)
        if len(sizes) >= 2:
            s, t0_fit = np.polyfit(sizes, [t_scan[ni] for ni in sizes], 1)
            per_brute_eval = max(float(s), 0.0) / b
            if per_graph_eval > 0 and t0_fit > 0:
                overhead_kw["batch_overhead"] = float(
                    np.clip(t0_fit / per_graph_eval, 1.0, 65536.0)
                )
        else:
            per_brute_eval = t_scan[sizes[-1]] / max(b * sizes[-1], 1)
        if per_graph_eval > 0 and per_brute_eval > 0:
            brute_eval_cost = float(np.clip(per_brute_eval / per_graph_eval, 0.05, 20.0))
    return CostModel(
        unit_evals=max(slope, 1e-3),
        probe_pool=p_hi,
        probe_n=n,
        brute_eval_cost=brute_eval_cost,
        pool_intercept=max(intercept, 0.0),
        **overhead_kw,
    )


def predicate_width(queries: QueryBatch) -> float:
    """Mean fraction of wide (lo < hi interval) attribute dimensions."""
    if queries.intervals is None:
        return 0.0
    wide = queries.intervals[..., 1] > queries.intervals[..., 0]
    return float(np.mean(wide))


def make_plan(engine: "Engine", queries: QueryBatch, params: "SearchParams") -> Plan:
    """Resolve (backend, quant_mode, routing_cfg, predicted costs) for one
    batch. Rules, first match wins:

      1. ``params.backend`` override (validated against the index kind)
      2. sharded index → "sharded"; partitioned index → "partitioned"
      3. no HELP graph (``build_graph=False``) → "brute"
      4. deprecated ``params.brute_threshold`` explicitly set → fixed-N rule
      5. calibrated cost model: brute vs graph at the predicted per-query
         cost crossover for this (N, pool, predicate width, batch)

    A "partitioned" plan also resolves ``nprobe`` (explicit
    ``params.nprobe`` or ≈√P) and the per-partition ``sub_backend``.
    """
    if queries.attr_dim != engine.attr_dim:
        raise ValueError(f"query attr_dim {queries.attr_dim} != index {engine.attr_dim}")
    cost_brute = cost_graph = None
    if params.backend != "auto":
        backend = params.backend
        if backend == "sharded" and not engine.is_sharded:
            raise ValueError("backend='sharded' needs a sharded index")
        if backend != "sharded" and engine.is_sharded:
            raise ValueError(f"backend={backend!r} unavailable on a sharded index")
        if backend == "partitioned" and not engine.is_partitioned:
            raise ValueError(
                "backend='partitioned' needs a partitioned index "
                "(Engine.build_partitioned / a partitioned save dir)"
            )
        if backend != "partitioned" and engine.is_partitioned:
            raise ValueError(
                f"backend={backend!r} unavailable on a partitioned index: "
                "use 'auto' or 'partitioned' (sub-backend is planned per "
                "partition; nprobe=P reproduces the unpartitioned scan)"
            )
        if backend == "graph" and not engine.has_graph:
            raise ValueError("backend='graph' but the index has no graph")
        reason = "explicit backend override"
    elif engine.is_partitioned:
        backend, reason = "partitioned", "index is partitioned (IVF coarse quantizer)"
    elif engine.is_sharded:
        backend, reason = "sharded", "index is sharded over the mesh"
    elif not engine.has_graph:
        backend, reason = "brute", "index built without a HELP graph"
    elif params.brute_threshold is not None:
        warnings.warn(
            "SearchParams.brute_threshold is deprecated: the planner chooses "
            "brute vs graph from a calibrated cost model (Engine.cost_model). "
            "The explicit value is honored as a hard override; leave it unset "
            "to use the cost model.",
            DeprecationWarning,
            stacklevel=3,
        )
        backend = "brute" if engine.n_items <= params.brute_threshold else "graph"
        rel = "≤" if backend == "brute" else ">"
        reason = (
            f"N={engine.n_items} {rel} brute_threshold={params.brute_threshold} "
            "(deprecated override)"
        )
    else:
        cm = engine.cost_model
        n = engine.n_items
        pool = min(params.effective_pool, n)
        # price the codec that will run: quant="none" forces full precision
        # on a quantized index, and the brute oracle scans codes for pq only
        q = "none" if params.quant == "none" else engine.quant_mode
        cost_brute = cm.brute_cost(n=n, pool=pool, quant_mode=q if is_pq_mode(q) else "none")
        # the width surcharge models the executor's cut-widening for the
        # exact-membership backfill: ONE_OF always, intervals when enforced
        widens = queries.has_one_of or (params.enforce_equality and queries.has_intervals)
        cost_graph = cm.graph_cost(
            n=n, pool=pool, batch=queries.batch_size,
            width=predicate_width(queries) if widens else 0.0, quant_mode=q,
            rerank=params.rerank_size,
        )
        backend = "brute" if cost_brute <= cost_graph else "graph"
        reason = (
            f"cost model: brute≈{cost_brute:.0f} vs graph≈{cost_graph:.0f} "
            f"fp-eval units/query → {backend}"
        )

    sub_backend, nprobe = "", 0
    if backend == "partitioned":
        sub_backend, nprobe, cost_brute, cost_graph, sub_reason = (
            _plan_partitioned(engine, queries, params)
        )
        reason = f"{reason}; {sub_reason}"

    # the codec follows the backend that scores rows: for a partitioned
    # plan its sub-backend (a brute sub-scan has no sq8 path either)
    quant_mode = engine._resolve_quant(params, sub_backend or backend)
    routing_cfg = None
    if backend in ("graph", "sharded") or sub_backend == "graph":
        routing_cfg = params.routing_config(quant_mode, params.enforce_equality)
    return Plan(
        backend=backend, quant_mode=quant_mode, routing_cfg=routing_cfg,
        reason=reason, cost_brute=cost_brute, cost_graph=cost_graph,
        sub_backend=sub_backend, nprobe=nprobe,
    )


def _plan_partitioned(
    engine: "Engine", queries: QueryBatch, params: "SearchParams"
) -> tuple[str, int, float, Optional[float], str]:
    """Resolve (sub_backend, nprobe, cost_brute, cost_graph, reason) for a
    partitioned plan.

    nprobe: explicit ``params.nprobe`` wins; otherwise the IVF default ≈√P
    (clamped to [1, P]). Sub-backend pricing reuses the flat cost model at
    the *average* partition size: both alternatives pay P centroid
    scorings, then either one scan over the ~nprobe·N/P probed rows or
    nprobe traversals of ~N/P rows each. "graph" is only on the table when
    the partitions were built with HELP subgraphs.
    """
    p = engine.index.n_partitions
    nprobe = params.nprobe or int(round(math.sqrt(p)))
    nprobe = max(1, min(nprobe, p))
    cm = engine.cost_model
    n = engine.n_items
    avg_rows = max(int(math.ceil(n / max(p, 1))), 1)
    probe_rows = min(nprobe * avg_rows, n)
    q = "none" if params.quant == "none" else engine.quant_mode
    cost_brute = float(p) + cm.brute_cost(
        n=probe_rows,
        pool=min(params.effective_pool, probe_rows),
        quant_mode=q if is_pq_mode(q) else "none",
    )
    if params.sub_backend == "graph" and not engine.has_graph:
        raise ValueError("sub_backend='graph' but the partitions have no HELP subgraphs")
    if params.sub_backend == "brute":
        return ("brute", nprobe, cost_brute, None,
                f"nprobe={nprobe}/{p}, sub-backend brute (explicit override)")
    if not engine.has_graph:
        return ("brute", nprobe, cost_brute, None,
                f"nprobe={nprobe}/{p}, sub-backend brute (no HELP subgraphs)")
    widens = queries.has_one_of or (params.enforce_equality and queries.has_intervals)
    cost_graph = float(p) + nprobe * cm.graph_cost(
        n=avg_rows,
        pool=min(params.effective_pool, avg_rows),
        batch=queries.batch_size,
        width=predicate_width(queries) if widens else 0.0,
        quant_mode=q,
        rerank=params.rerank_size,
    )
    if params.sub_backend == "graph":
        sub, why = "graph", "explicit override"
    else:
        sub = "brute" if cost_brute <= cost_graph else "graph"
        why = f"brute≈{cost_brute:.0f} vs graph≈{cost_graph:.0f}/query"
    return (sub, nprobe, cost_brute, cost_graph,
            f"nprobe={nprobe}/{p}, sub-backend {sub} ({why})")
