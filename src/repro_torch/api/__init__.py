"""Unified query/engine API of the port.

    from repro_torch.api import Engine, QueryBatch, SearchParams

    eng = Engine.build(features, attrs)              # on the CUDA card
    res = eng.search(QueryBatch.match(qv, qa), SearchParams(k=10))

    # subset query: constrain only the first two attributes
    res = eng.search(QueryBatch.match(qv, qa, active=[0, 1]))

``Engine.plan(batch, params)`` exposes the planner decision without
executing it; ``Engine.executor.stats()`` reports plan-cache hits/misses.
"""
from repro_torch.api.engine import Engine, Searcher, SearchParams
from repro_torch.api.executor import Executor, PlanSignature
from repro_torch.api.planner import CostModel, Plan, cost_model_from_table
from repro_torch.api.query import ANY, BETWEEN, MATCH, ONE_OF, Predicate, Query, QueryBatch
from repro_torch.core.routing import SearchResult

__all__ = [
    "ANY",
    "BETWEEN",
    "CostModel",
    "Engine",
    "Executor",
    "MATCH",
    "ONE_OF",
    "Plan",
    "PlanSignature",
    "Predicate",
    "Query",
    "QueryBatch",
    "SearchParams",
    "SearchResult",
    "Searcher",
    "cost_model_from_table",
]
