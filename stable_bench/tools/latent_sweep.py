"""Fix the latent dimension r of the benchmark's data.

    python3 stable_bench/tools/latent_sweep.py [--dims 8,16,24,32,48,64] [--seed 1]

on one CUDA card, from the root of a checkout. For each configuration of
``BENCHMARK.json`` and each r: draw the data (``datagen``), build the
index with ``Engine.build``, run the first call of each group of
``bulk_graph``, and hold the answers to the reference's exact top-10.
Prints one JSON line per (configuration, r) with each predicate class's
recall@10, the build seconds and each call's milliseconds, and the largest
r at which MATCH recall reaches 0.9 (the reference's ``recall_target``).
``--baseline`` adds the port's own ``make_hybrid_dataset`` (full-rank
noise) at the SIFT configuration's size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: MATCH recall@10 the data must reach (the reference's ``recall_target``)
RECALL_TARGET = 0.9


def measure(cell, seed: int, device, api, bench, check, reference, data=None) -> dict:
    """Recall@10 of each class over the first call of each group, those
    calls' milliseconds, and the build s."""
    import torch

    if data is not None:
        orig = bench.datagen.make_data
        bench.datagen.make_data = lambda cfg, s, dev: data
    try:
        prog = bench.Program(cell, seed, device, api)
    finally:
        if data is not None:
            bench.datagen.make_data = orig
    out = {"build_s": prog.build_s, "classes": {}, "calls_ms": []}
    w = bench.measure(prog, cell.driver, 0.0, False, min_calls=len(prog.groups))
    out["calls_ms"] = [c["latency_s"] * 1e3 for c in w["calls"]]
    q, ids, sq = w["answers"]
    n_cls = len(cell.mix["classes"])
    answers = [(cls["name"], check.Answers(q[q % n_cls == i], ids[q % n_cls == i], sq[q % n_cls == i]))
               for i, cls in enumerate(cell.mix["classes"])]
    d = prog.data
    prog.free()
    cfg, mix = cell.config, cell.mix
    preds = reference.compile_predicates(mix["classes"], d.query_attrs, cfg["labels_per_dim"])
    alpha = reference.alpha(d.features, d.attrs)
    exact = reference.exact_topk(d.features, d.attrs, d.query_features, preds, mix["params"]["k"])
    for name, ans in answers:
        j = check.judge(d.features, d.attrs, d.query_features, preds, alpha, exact, ans,
                        check.promises(mix["params"], cfg["index"]))
        out["classes"][name] = {"recall": j["recall"], "malformed": j["malformed"],
                                "score_gap": j["score_gap"]}
    out["alpha"] = alpha
    del prog, d
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", default="8,16,24,32,48,64")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--baseline", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import api
    from stable_bench import bench, check, reference

    dev = torch.device("cuda", 0)
    manifest = bench.load_json(ROOT / "BENCHMARK.json")
    graph = [w for w in manifest["workloads"] if w["traffic"] == "bulk_graph"]
    rows = []
    if args.baseline:
        from repro_torch.data.synthetic import make_hybrid_dataset

        cell = bench.Cell(manifest, graph[0]["name"])
        cfg = cell.config
        t = time.perf_counter()
        ds = make_hybrid_dataset(n=cfg["n_rows"], n_queries=cfg["n_queries"], profile=cfg["profile"]["name"],
                                 attr_dim=cfg["attr_dim"], labels_per_dim=cfg["labels_per_dim"], seed=0)
        data = bench.datagen.Data(*(torch.from_numpy(a).to(dev) for a in (
            ds.features, ds.attrs, ds.query_features, ds.query_attrs)))
        r = measure(cell, args.seed, dev, api, bench, check, reference, data)
        r.update(config=cfg["name"], latent_dim="full (make_hybrid_dataset)",
                 draw_s=time.perf_counter() - t)
        print(json.dumps(r), flush=True)
        del data, ds
    for w in graph:
        best = None
        for r_dim in [int(x) for x in args.dims.split(",")]:
            cell = bench.Cell(manifest, w["name"])
            cell.config["latent_dim"] = r_dim
            t = time.perf_counter()
            r = measure(cell, args.seed, dev, api, bench, check, reference)
            r.update(config=cell.config["name"], latent_dim=r_dim, total_s=time.perf_counter() - t)
            rows.append(r)
            print(json.dumps(r), flush=True)
            if r["classes"]["match"]["recall"] >= RECALL_TARGET:
                best = r_dim
        print(json.dumps({"config": w["config"], "chosen_latent_dim": best,
                          "rule": f"largest r with MATCH recall@10 >= {RECALL_TARGET}"}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "latent_sweep.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
