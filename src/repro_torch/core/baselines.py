"""Baseline hybrid-ANNS strategies the paper compares against (§II-B,
§IV-A), and the recall metric.

  - ``brute_force_hybrid``   exact oracle (ground truth for Recall@K): a
                             hard attribute filter plus exact L2 top-k over
                             every row, scored by the ``fused_auto`` kernel
  - ``pre_filter_search``    SSP / Milvus-style: attribute filter → scan
  - ``post_filter_search``   VSP / Vearch-style: pure-L2 ANN top-K′ → filter

The reference's additive and NHQ-style fusion baselines wait for a later
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import routing as routing_mod
from repro_torch.core import to_tensor
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID, gather_rows, smallest_k
from repro_torch.core.routing import RoutingConfig, SearchResult

Tensor = torch.Tensor


def _equality_ok(qa: Tensor, xa: Tensor, mask: Optional[Tensor]) -> Tensor:
    eq = qa[:, None, :] == xa[None, :, :]
    if mask is not None:
        eq = eq | (mask[:, None, :] == 0)
    return eq.all(-1)  # (B, N)


def brute_force_hybrid(
    db_v: Tensor,
    db_a: Tensor,
    qv,
    qa,
    k: int,
    mask=None,
) -> SearchResult:
    """Exact Attribute-Equality oracle: hard filter + exact L2 top-k, on
    the device that holds the database."""
    dev = db_v.device
    qv = to_tensor(qv, torch.float32, dev)
    qa = to_tensor(qa, torch.int32, dev)
    mask = None if mask is None else to_tensor(mask, torch.int32, dev)
    sv2 = auto_mod.brute_fused_sqdist(qv, qa, db_v, db_a, MetricConfig(mode="l2"))
    scores = sv2.masked_fill(~_equality_ok(qa, db_a, mask), INF)
    sq, ids = smallest_k(scores, k)
    ids = torch.where(torch.isfinite(sq) & (sq < INF / 2), ids, INVALID).to(torch.int32)
    b = qv.shape[0]
    return SearchResult(
        ids=ids, dists=torch.sqrt(torch.clamp_min(sq, 0.0)), sqdists=sq,
        n_dist_evals=torch.full((b,), db_v.shape[0], dtype=torch.int32, device=dev),
        n_hops=torch.zeros((), dtype=torch.int32, device=dev),
        n_code_evals=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def pre_filter_search(
    db_v: Tensor,
    db_a: Tensor,
    qv,
    qa,
    k: int,
    mask=None,
) -> SearchResult:
    """SSP: scalar filter first, then scan the matching subset.

    With no per-attribute sub-index this is exact (the oracle's results);
    its cost is the full filter pass plus |match| feature distances, which
    ``n_dist_evals`` reports."""
    res = brute_force_hybrid(db_v, db_a, qv, qa, k, mask)
    dev = db_v.device
    ok = _equality_ok(
        to_tensor(qa, torch.int32, dev), db_a,
        None if mask is None else to_tensor(mask, torch.int32, dev),
    )
    return res._replace(n_dist_evals=ok.sum(1, dtype=torch.int32))


def post_filter_search(
    db_v: Tensor,
    db_a: Tensor,
    graph_l2: Tensor,
    qv,
    qa,
    k: int,
    k_prime: int,
    routing_cfg: Optional[RoutingConfig] = None,
    mask=None,
    seed: int = 0,
) -> SearchResult:
    """VSP: pure-L2 graph ANN for the top-K′ candidates, then the attribute
    filter keeps the best k (ties to the lower rank, as ``lax.top_k``).

    ``graph_l2`` must be built with ``MetricConfig(mode='l2')``. Recall
    saturates below 1 when the matching subset is sparse (the K′-estimation
    dilemma of paper §II-B)."""
    cfg = routing_cfg or RoutingConfig(k=k_prime, pool_size=max(k_prime, 16))
    cfg = dataclasses.replace(cfg, k=k_prime, pool_size=max(cfg.pool_size, k_prime))
    res = routing_mod.search(
        db_v, db_a, graph_l2, qv, qa, MetricConfig(mode="l2"), cfg, None, None, seed
    )
    dev = db_v.device
    qa = to_tensor(qa, torch.int32, dev)
    eq = gather_rows(db_a, res.ids) == qa[:, None, :]  # (B, K′, L)
    if mask is not None:
        eq = eq | (to_tensor(mask, torch.int32, dev)[:, None, :] == 0)
    ok = eq.all(-1) & (res.ids >= 0)
    sq, take = smallest_k(res.sqdists.masked_fill(~ok, INF), k)
    ids = torch.where(sq < INF / 2, res.ids.gather(1, take), INVALID)
    return SearchResult(
        ids=ids, dists=torch.sqrt(torch.clamp_min(sq, 0.0)), sqdists=sq,
        n_dist_evals=res.n_dist_evals, n_hops=res.n_hops,
        n_code_evals=res.n_code_evals,
    )


def recall_at_k(result_ids, truth_ids, k: int) -> float:
    """Recall@K = |top-K ∩ truth| / K, averaged over queries (paper §IV-A)."""
    r = to_tensor(result_ids, torch.int64, "cpu")[:, :k]
    t = to_tensor(truth_ids, torch.int64, "cpu")[:, :k]
    valid_truth = t >= 0
    hit = (r[:, :, None] == t[:, None, :]) & (r[:, :, None] >= 0)
    hits = hit.any(1) & valid_truth
    denom = valid_truth.sum(1).clamp_min(1)
    return float((hits.sum(1).to(torch.float32) / denom).mean())
