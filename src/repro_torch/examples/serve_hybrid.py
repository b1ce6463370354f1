"""End-to-end serving demo (the paper's kind: hybrid ANNS serving).

Builds an engine, then serves batched hybrid queries from a request queue
through the unified ``Engine.search`` facade, reporting throughput, recall,
tail latency and per-request eval cost — including subset-attribute
(wildcard) requests declared as predicates (Eq. 8 masking).

    PYTHONPATH=src python -m repro_torch.examples.serve_hybrid [--n 20000] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import Engine, QueryBatch, SearchParams
from repro_torch.core import resolve_device
from repro_torch.core.baselines import brute_force_hybrid, recall_at_k
from repro_torch.core.help_graph import HelpConfig
from repro_torch.data.synthetic import make_hybrid_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, batch, n_batches = args.n, args.batch, args.batches
    print(f"Index: {n} products (GLOVE-like features, 5 attrs) on {dev}...")
    ds = make_hybrid_dataset(
        n=n, n_queries=batch * n_batches, profile="glove", attr_dim=5,
        labels_per_dim=3, n_clusters=16, attr_cluster_corr=0.6, seed=1,
    )
    eng = Engine.build(ds.features, ds.attrs,
                       HelpConfig(gamma=24, gamma_new=6, max_rounds=8), device=dev)
    idx = eng.index
    params = SearchParams(k=10, pool_size=64, pioneer_size=8)

    # warm the planner's probe and the executor's cached plan
    eng.search(QueryBatch.match(ds.query_features[:batch], ds.query_attrs[:batch]), params)

    lat, recalls, per_q = [], [], []
    for b in range(n_batches):
        qv = ds.query_features[b * batch:(b + 1) * batch]
        qa = ds.query_attrs[b * batch:(b + 1) * batch]
        t0 = time.perf_counter()
        res = eng.search(QueryBatch.match(qv, qa), params)
        if res.ids.is_cuda:
            torch.cuda.synchronize(res.ids.device)
        lat.append(time.perf_counter() - t0)
        per_q.append(res.n_dist_evals.cpu().numpy())
        truth = brute_force_hybrid(idx.features, idx.attrs, qv, qa, 10)
        recalls.append(recall_at_k(res.ids, truth.ids, 10))

    lat_ms = np.array(lat) * 1e3
    ev = np.concatenate(per_q)
    print(f"served {n_batches} batches × {batch} queries:")
    print(f"  QPS        = {batch * n_batches / sum(lat):.0f}")
    print(f"  latency    = p50 {np.percentile(lat_ms, 50):.1f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.1f} ms per batch")
    print(f"  Recall@10  = {np.mean(recalls):.3f}")
    print(f"  evals/req  = p50 {np.percentile(ev, 50):.0f}, "
          f"p99 {np.percentile(ev, 99):.0f}")

    # subset query: only the first 2 attributes constrained (Eq. 8 masking,
    # declared via predicates — no hand-built mask arrays)
    qv, qa = ds.query_features[:batch], ds.query_attrs[:batch]
    wild = QueryBatch.match(qv, qa, active=[0, 1])
    res = eng.search(wild, params)
    truth = brute_force_hybrid(idx.features, idx.attrs, qv, qa, 10,
                               mask=wild.mask)
    wild_recall = recall_at_k(res.ids, truth.ids, 10)
    print(f"  wildcard (F=2) Recall@10 = {wild_recall:.3f}")
    return float(np.mean(recalls)), wild_recall


if __name__ == "__main__":
    main()
