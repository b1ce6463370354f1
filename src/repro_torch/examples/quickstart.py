"""Quickstart: build a STABLE engine on synthetic hybrid data and search it
through the unified declarative API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 10000] [--queries 100] [--device cpu]
"""
import argparse

from repro_torch.api import Engine, QueryBatch, SearchParams
from repro_torch.core import resolve_device
from repro_torch.core.baselines import brute_force_hybrid, recall_at_k
from repro_torch.core.help_graph import HelpConfig
from repro_torch.data.synthetic import make_hybrid_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"Generating a SIFT-like hybrid dataset ({args.n} vectors × 5 attrs)...")
    ds = make_hybrid_dataset(
        n=args.n, n_queries=args.queries, profile="sift", attr_dim=5,
        labels_per_dim=3, n_clusters=16, attr_cluster_corr=0.6, seed=0,
    )

    print(f"Building the HELP index under the AUTO metric (α auto-calibrated) on {dev}...")
    eng = Engine.build(
        ds.features, ds.attrs, HelpConfig(gamma=24, gamma_new=6, max_rounds=8), device=dev,
    )
    idx = eng.index
    print(f"  α = {idx.metric_cfg.alpha:.3f}  "
          f"ψ history = {[round(p, 3) for p in idx.report.psi_history]}  "
          f"pruned {idx.report.pruned_edge_fraction:.1%} of edges "
          f"in {idx.report.build_seconds:.1f}s")

    print(f"Searching {args.queries} hybrid queries "
          "(feature NN + exact attribute match)...")
    batch = QueryBatch.match(ds.query_features, ds.query_attrs)
    params = SearchParams(k=10)
    plan = eng.plan(batch, params)
    print(f"  planner: backend={plan.backend} quant={plan.quant_mode} "
          f"({plan.reason})")
    if plan.backend != "graph":
        # at demo sizes the calibrated cost model can honestly prefer the
        # dense scan — pin the graph backend so the traversal is on display
        print("  (pinning backend='graph' to demo the HELP traversal)")
        params = SearchParams(k=10, backend="graph")
    res = eng.search(batch, params)
    truth = brute_force_hybrid(
        idx.features, idx.attrs, ds.query_features, ds.query_attrs, 10
    )
    r = recall_at_k(res.ids, truth.ids, 10)
    brute_evals = ds.features.shape[0] * args.queries
    print(f"  Recall@10 = {r:.3f}")
    print(f"  distance evals: {res.total_dist_evals:,} "
          f"(brute force would be {brute_evals:,} — "
          f"{brute_evals / max(res.total_dist_evals, 1):.1f}× more); "
          f"per-query mean {res.mean_dist_evals:.0f}")
    ids = res.ids[0].cpu().numpy()
    attrs_ok = (ds.attrs[ids[ids >= 0]] == ds.query_attrs[0]).all(1)
    print(f"  query 0: top-10 ids {ids.tolist()} "
          f"(attribute-matched: {int(attrs_ok.sum())}/10)")
    return r


if __name__ == "__main__":
    main()
