"""Read the correctness numbers that the limits are set from.

    python3 stable_bench/tools/readings.py --cells NAME[,NAME] [--seeds 12] [--control 3]
                                           [--seconds 3] [--first-seed 3000000000]
                                           [--data-seeds 1,2,3]

on one CUDA card, from the root of a checkout. For each cell, data set
(``--data-seeds``: the configuration's ``data_seed`` replaced by each,
cycling with the seeds; its own where absent) and seed it runs what
``run.py`` runs (set-up, a window of ``--seconds``, the check) and prints
the numbers compared, with recall. On the first ``--control`` seeds it
also judges the control (``control.py``: the reference in the
program's place, in bfloat16) on the same window's queries. Each line is
one JSON object; all of them also go to ``chiprun_out/readings.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--data-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import api
    from stable_bench import bench, control, reference

    dev = torch.device("cuda", 0)
    manifest = bench.load_json(ROOT / "BENCHMARK.json")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "readings.jsonl", "a") as log:
        for name in args.cells.split(","):
            cell = bench.Cell(manifest, name)
            data_seeds = [int(x) for x in args.data_seeds.split(",") if x]
            for i in range(args.seeds):
                seed = args.first_seed + 7919 * i
                if data_seeds:
                    cell.config["data_seed"] = data_seeds[i % len(data_seeds)]
                t0 = time.perf_counter()
                prog = bench.Program(cell, seed, dev, api)
                setup_s = time.perf_counter() - t0
                w = bench.measure(prog, cell.driver, args.seconds, False)
                peak = torch.cuda.max_memory_allocated(dev)
                prog.free()
                res = bench.finish(cell, w, prog, setup_s, peak, dev)
                row = {"cell": name, "seed": seed, "data_seed": cell.config["data_seed"],
                       "side": "program", "correct": res["correct"],
                       "checks": {k: v["value"] for k, v in res["checks"].items()},
                       "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                       "malformed_by": res["malformed_by"],
                       "answers": res["attempted"], "memory_peak_bytes": peak,
                       "phases": prog.phases, "run_s": time.perf_counter() - t0}
                print(json.dumps(row), flush=True)
                log.write(json.dumps(row) + "\n")
                if i < args.control:
                    preds = reference.compile_predicates(
                        cell.mix["classes"], prog.data.query_attrs, cell.config["labels_per_dim"])
                    ctl = dict(w, answers=control.answers(prog.data, preds, w["answers"],
                                                          cell.mix["params"]["k"]))
                    res = bench.finish(cell, ctl, prog, setup_s, peak, dev)
                    row = {"cell": name, "seed": seed, "data_seed": cell.config["data_seed"],
                           "side": "control bfloat16",
                           "correct": res["correct"], "malformed_by": res["malformed_by"],
                           "checks": {k: v["value"] for k, v in res["checks"].items()}}
                    print(json.dumps(row), flush=True)
                    log.write(json.dumps(row) + "\n")
                del prog, w
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
