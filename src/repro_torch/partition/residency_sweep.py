"""Time a partitioned search under a residency cap against the same search
with every partition resident, on one card.

A search of the partitioned backend under a cap loads, one by one, each
probed partition that the cap could not keep. This script splits its time:
it builds the partitioned engine of ``chip_smoke.py``'s partitioned step
(the sift profile at N rows, P = 2^round(log2(N/8000)), HelpConfig(12, 4,
4), pq codes at S = 64), saves it under ``build/``, loads it under a cap
of max bucket × max(4, √P) rows and, for 128 queries with MATCH on
attribute 0 at each nprobe of ``NPROBES`` on the brute sub-backend, takes
the median of 3 host-clock searches (after a sync) three ways: under the
cap with the store's prefetch, under the cap without it, and with the cap
lifted so every partition stays resident. It also times one partition's
load alone (the median of 20 ``SegmentStore._materialize`` calls on the
median-sized partition). Run from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.partition.residency_sweep [--n N] [--json PATH]

It prints the card's name and power limit, then one JSON line. The package
it measures is the one on ``PYTHONPATH``: to compare two trees, unpack each
with ``git archive`` under ``build/`` and run this script once with each
tree's ``src`` on ``PYTHONPATH``, in turns, in one call.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

NPROBES = (1, 11)
QUERIES, REPS, LOAD_REPS = 128, 3, 20


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> None:
    import repro_torch
    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.kernels import build
    from repro_torch.partition import row_bucket
    from repro_torch.quant import QuantConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("residency_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    p = max(8, 2 ** int(round(math.log2(max(args.n // 8000, 8)))))
    sp = max(1, int(round(math.sqrt(p))))
    ds = make_hybrid_dataset(n=args.n, n_queries=QUERIES, profile="sift", seed=0)
    root = os.path.join(os.getcwd(), "build")
    os.makedirs(root, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="residency_sweep_", dir=root)
    try:
        path = os.path.join(workdir, "index")
        Engine.build_partitioned(
            ds.features, ds.attrs, n_partitions=p, device=dev,
            help_cfg=HelpConfig(gamma=12, gamma_new=4, max_rounds=4),
            quant_cfg=QuantConfig(mode="pq", pq_subspaces=64),
        ).save(path)
        sizes = np.array([int(r) for r in
                          json.load(open(os.path.join(path, "meta.json")))["summaries"]["n_rows"]])
        cap = max(row_bucket(int(r)) for r in sizes) * max(4, sp)
        eng = Engine.load(path, device=dev, residency_rows=cap)
        store = eng.index.store
        pid = int(np.argsort(sizes)[len(sizes) // 2])
        out = dict(package=os.path.dirname(repro_torch.__file__), n=args.n, partitions=p,
                   cap_rows=cap, load_rows=int(sizes[pid]),
                   load_ms=median_ms(lambda: store._materialize(pid), LOAD_REPS), nprobe={})
        qb = QueryBatch.match(ds.query_features, ds.query_attrs, active=[0])
        prefetch = store.prefetch
        for nprobe in NPROBES:
            params = SearchParams(k=10, nprobe=nprobe, sub_backend="brute", quant="none")
            row = out["nprobe"][nprobe] = {}
            for way, cap_rows, fetch in (("capped", cap, prefetch),
                                         ("capped_no_prefetch", cap, lambda pid: None),
                                         ("all_resident", 10 ** 12, prefetch)):
                store.cap_rows, store.prefetch = cap_rows, fetch
                store.evict_all()
                store.reset_counters()
                eng.search(qb, params)  # cold
                torch.cuda.synchronize()
                loads = store.loads
                row[way] = median_ms(lambda: eng.search(qb, params), REPS)
                row[f"{way}_loads_a_search"] = (store.loads - loads) / REPS
        store.cap_rows, store.prefetch = cap, prefetch
        store.evict_all()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
