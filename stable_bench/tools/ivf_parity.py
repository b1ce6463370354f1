"""Hold a partitioned cell's answers to the plain IVF reference.

    python3 stable_bench/tools/ivf_parity.py [--cell sift1m-theta243-ivf128.bulk_ivf]
                                             [--data-seeds 1,2,3] [--seconds 15]
                                             [--first-seed 3500000000]

on one CUDA card, from the root of a checkout. For each data set
(``--data-seeds``: the configuration's ``data_seed`` replaced by each) it
sets the cell's program up at the configuration's size, runs a window of
``--seconds`` through ``Program.call`` (the timed path), judges it as
``run.py`` does (``correct``, the checks and the end-to-end numbers), and
holds every answer to ``reference_ivf`` given the built index's centroids
and row assignment:

``ivf_gap``        the largest |reference score of the j-th returned row −
                   the IVF reference's j-th| / (|q|² + |x|²); its limit is
                   ``LIMIT``, as ``exact_gap``'s;
``differ_share``   answers whose id set differs from the IVF reference's
                   beyond float ties (``reference_ivf.compare``);
``probe_differs``  answered queries whose probed partitions differ from the
                   IVF reference's (float32 centroid scores against float64);

and the same two numbers for the control: the IVF reference computed in
bfloat16 in the program's place, which has to read above ``LIMIT``. It also
logs the partitions' sizes and row buckets, which the seed changes (the
seed orders the rows k-means draws from). Each line is one JSON object; all
of them also go to ``chiprun_out/ivf_parity.jsonl``.
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: the limit of ``ivf_gap``: ``exact_gap``'s
LIMIT = 1e-5


def assignment(pidx, device):
    """(N,) each row's partition in a built partitioned index."""
    import torch

    out = torch.full((pidx.n_items,), -1, dtype=torch.int64)
    for pid in range(pidx.n_partitions):
        rows = torch.as_tensor(pidx._load_partition(pid).row_ids, dtype=torch.int64)
        out[rows] = pid
    assert bool((out >= 0).all()), "a row in no partition"
    return out.to(device)


def program_probes(prog, nprobe: int):
    """(Q, nprobe) the program's probe of every query of the cell's groups
    (-1 where empty), with a sub-backend that scans under every predicate."""
    import numpy as np

    pidx = prog.engine.index
    n = sum(len(r) for r in prog.rows)
    out = np.full((n, nprobe), -1, np.int64)
    for qb, rows in zip(prog.batches, prog.rows):
        out[rows] = pidx.probe(qb, nprobe, True)
    return out


def partition_shape(pidx) -> dict:
    from repro_torch.partition.store import row_bucket

    sizes = sorted(int(n) for n in pidx.summaries.n_rows)
    buckets = Counter(row_bucket(n) for n in sizes)
    return {"min": sizes[0], "median": sizes[len(sizes) // 2], "max": sizes[-1],
            "buckets": {str(b): c for b, c in sorted(buckets.items())},
            "bucket_rows": sum(row_bucket(n) for n in sizes)}


def parity(cell, seed: int, seconds: float, dev, api) -> dict:
    """One data set's run of ``cell``: set-up, a window, ``run.py``'s
    judgement, and every answer held to the IVF reference and the control."""
    import numpy as np
    import torch

    from stable_bench import bench, reference, reference_ivf

    params = cell.mix["params"]
    nprobe, k = params["nprobe"], params["k"]
    t0 = time.perf_counter()
    prog = bench.Program(cell, seed, dev, api)
    setup_s = time.perf_counter() - t0
    w = bench.measure(prog, cell.driver, seconds, False)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    pidx = prog.engine.index
    centroids = torch.as_tensor(pidx.quantizer.centroids, device=dev)
    assign = assignment(pidx, dev)
    shape = partition_shape(pidx)
    probes = program_probes(prog, nprobe)
    prog.free()
    res = bench.finish(cell, w, prog, setup_s, peak, dev)
    data = prog.data
    preds = reference.compile_predicates(cell.mix["classes"], data.query_attrs,
                                         cell.config["labels_per_dim"])
    t1 = time.perf_counter()
    want = reference_ivf.topk(data.features, data.attrs, data.query_features, preds,
                              centroids, assign, nprobe, k)
    ref_s = time.perf_counter() - t1
    ans = w["answers"]
    query = torch.as_tensor(ans.query, device=dev)
    got = reference_ivf.compare(data.features, data.query_features, query,
                                torch.as_tensor(ans.ids, device=dev), want)
    ref_sets = torch.sort(want.probes, 1).values.cpu().numpy()
    prog_sets = np.sort(probes, 1)
    probe_differs = int((ref_sets[ans.query] != prog_sets[ans.query]).any(1).sum())
    ctl = reference_ivf.topk(data.features, data.attrs, data.query_features, preds,
                             centroids, assign, nprobe, k, dtype=torch.bfloat16)
    ctl_got = reference_ivf.compare(data.features, data.query_features, query,
                                    ctl.ids[query], want)
    return {"cell": cell.name, "seed": seed, "data_seed": cell.config["data_seed"],
            "correct": res["correct"],
            "checks": {n: c["value"] for n, c in res["checks"].items()},
            "metrics": {n: m["value"] for n, m in res["metrics"].items()},
            "answers": got.answers, "ivf_gap": got.ivf_gap,
            "differ_share": got.differ / got.answers,
            "probe_differs": probe_differs, "limit": LIMIT, "within": got.ivf_gap <= LIMIT,
            "control_bfloat16": {"ivf_gap": ctl_got.ivf_gap,
                                 "differ_share": ctl_got.differ / ctl_got.answers,
                                 "above": ctl_got.ivf_gap > LIMIT},
            "partitions": shape, "memory_peak_bytes": peak, "phases": prog.phases,
            "reference_s": ref_s, "run_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="sift1m-theta243-ivf128.bulk_ivf")
    ap.add_argument("--data-seeds", default="1,2,3")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--first-seed", type=int, default=3_500_000_000)
    args = ap.parse_args(argv)

    import torch

    from repro_torch import api
    from stable_bench import bench

    dev = torch.device("cuda", 0)
    cell = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"), args.cell)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "ivf_parity.jsonl", "a") as log:
        for i, ds in enumerate(int(x) for x in args.data_seeds.split(",") if x):
            cell.config["data_seed"] = ds
            row = parity(cell, args.first_seed + 7919 * i, args.seconds, dev, api)
            print(json.dumps(row), flush=True)
            log.write(json.dumps(row) + "\n")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
