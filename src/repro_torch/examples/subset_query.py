"""Masking mechanism demo (paper §III-E): one engine serves full-equality,
subset (wildcard), missing-value, value-set AND range hybrid queries —
declared with per-attribute predicates instead of hand-built masks.

    PYTHONPATH=src python -m repro_torch.examples.subset_query [--n 8000] [--queries 64] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import (
    ANY, BETWEEN, MATCH, ONE_OF, Engine, Query, QueryBatch, SearchParams,
)
from repro_torch.core import resolve_device
from repro_torch.core.baselines import brute_force_hybrid, recall_at_k
from repro_torch.core.help_graph import HelpConfig
from repro_torch.data.synthetic import make_hybrid_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_hybrid_dataset(n=args.n, n_queries=args.queries, profile="sift",
                             attr_dim=5, labels_per_dim=3, n_clusters=16,
                             attr_cluster_corr=0.6, seed=2)
    eng = Engine.build(ds.features, ds.attrs,
                       HelpConfig(gamma=24, gamma_new=6, max_rounds=8), device=dev)
    idx = eng.index
    params = SearchParams(k=10)
    out = {}

    # subset queries: the first F attributes constrained, the rest wildcard —
    # QueryBatch.match(active=...) compiles the Eq. 8 mask for us.
    for f_active in (5, 3, 1, 0):
        batch = QueryBatch.match(ds.query_features, ds.query_attrs,
                                 active=range(f_active))
        res = eng.search(batch, params)
        mask = np.zeros_like(ds.query_attrs)
        mask[:, :f_active] = 1
        truth = brute_force_hybrid(idx.features, idx.attrs, ds.query_features,
                                   ds.query_attrs, 10, mask=mask)
        sel = (1 / 3) ** f_active
        out[f"F={f_active}"] = recall_at_k(res.ids, truth.ids, 10)
        print(f"F={f_active} active filters (selectivity ≈ {sel:7.2%}): "
              f"Recall@10 = {out[f'F={f_active}']:.3f}")
    print("F=0 is pure (unfiltered) ANN — one index, every query class.")

    # value-set query: attribute 0 must match, attribute 1 ∈ {0, 2}, rest
    # unconstrained. ONE_OF compiles to its covering [lo, hi] interval, so
    # the batch rides the HELP graph like any other query; exact set
    # membership is still enforced on the output.
    qs = [
        Query(ds.query_features[i],
              [MATCH(int(ds.query_attrs[i, 0])), ONE_OF(0, 2), ANY, ANY, ANY])
        for i in range(min(16, args.queries))
    ]
    batch = QueryBatch.from_queries(qs)
    plan = eng.plan(batch, params)
    res = eng.search(batch, params)
    ids = res.ids.cpu().numpy()
    a1 = ds.attrs[np.maximum(ids, 0), 1]
    out["one_of_ok"] = bool(((a1 == 0) | (a1 == 2) | (ids < 0)).all())
    print(f"ONE_OF batch → backend={plan.backend} ({plan.reason}); "
          f"attr-1 ∈ {{0,2}} respected: {out['one_of_ok']}; "
          f"evals/query = {res.total_dist_evals // max(len(qs), 1)} of {args.n}")

    # range query: attribute 0 ∈ [0, 1] — the same interval machinery, as a
    # soft AUTO penalty by default and a hard filter under enforce_equality.
    qs = [
        Query(ds.query_features[i], [BETWEEN(0, 1), ANY, ANY, ANY, ANY])
        for i in range(min(16, args.queries))
    ]
    batch = QueryBatch.from_queries(qs)
    res = eng.search(batch, SearchParams(k=10, enforce_equality=True))
    ids = res.ids.cpu().numpy()
    a0 = ds.attrs[np.maximum(ids, 0), 0]
    out["between_ok"] = bool((((a0 >= 0) & (a0 <= 1)) | (ids < 0)).all())
    print(f"BETWEEN(0, 1) batch (enforced): attr-0 ∈ [0,1] respected: "
          f"{out['between_ok']}")
    return out


if __name__ == "__main__":
    main()
