"""The exact hybrid oracle and the recall metric (paper §IV-A).

``brute_force_hybrid`` is the ground truth for Recall@K: a hard attribute
filter plus exact L2 top-k over every row, scored by the ``fused_auto``
kernel. The reference's other baselines (pre/post-filter, additive and
NHQ-style fusion) wait for a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import to_tensor
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID, smallest_k
from repro_torch.core.routing import SearchResult

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


def recall_at_k(result_ids, truth_ids, k: int) -> float:
    """Recall@K = |top-K ∩ truth| / K, averaged over queries (paper §IV-A)."""
    r = to_tensor(result_ids, torch.int64, "cpu")[:, :k]
    t = to_tensor(truth_ids, torch.int64, "cpu")[:, :k]
    valid_truth = t >= 0
    hit = (r[:, :, None] == t[:, None, :]) & (r[:, :, None] >= 0)
    hits = hit.any(1) & valid_truth
    denom = valid_truth.sum(1).clamp_min(1)
    return float((hits.sum(1).to(torch.float32) / denom).mean())
