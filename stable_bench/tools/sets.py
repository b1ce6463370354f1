"""Run sets of a cell as the check runs them, and read their spread.

    python3 stable_bench/tools/sets.py --cell NAME [--sets 2] [--runs 6] [--seconds S]
                                       [--trace 0] [--first-seed 4000000000]

from the root of a checkout on a machine with the cell's cards. Each run
is a new process of the benchmark's own command. Every set uses the same
seeds. Prints each run's result line and, per end-to-end metric, each
set's median and spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) over the median; also
the spread with each set's run farthest from its median left out. All
lines go to ``chiprun_out/sets.jsonl`` as well.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or manifest["run_seconds"]
    seeds = [args.first_seed + 104729 * i for i in range(args.runs)]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sets = []
    with open(out_dir / "sets.jsonl", "a") as log:
        for s in range(args.sets):
            rows = []
            for seed in seeds:
                t = time.perf_counter()
                p = subprocess.run(
                    manifest["command"] + ["--workload", args.cell, "--seed", str(seed),
                                           "--seconds", str(seconds), "--trace", str(args.trace)],
                    cwd=ROOT, capture_output=True, text=True)
                lines = p.stdout.strip().splitlines()
                res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
                row = {"cell": args.cell, "set": s, "seed": seed, "rc": p.returncode,
                       "wall_s": time.perf_counter() - t, "result": res,
                       "stderr_tail": p.stderr[-1500:]}
                rows.append(row)
                print(json.dumps(row), flush=True)
                log.write(json.dumps(row) + "\n")
            sets.append(rows)
        names = {m for rows in sets for r in rows if r["result"] for m in r["result"]["metrics"]}
        for name in sorted(names):
            per = [[r["result"]["metrics"][name]["value"] for r in rows
                    if r["result"] and name in r["result"]["metrics"]] for rows in sets]
            summary = {"cell": args.cell, "metric": name,
                       "medians": [statistics.median(v) for v in per if v],
                       "spreads": [spread(v) for v in per if len(v) >= 2],
                       "trimmed_spreads": [spread(trimmed(v)) for v in per if len(v) >= 3],
                       "correct": [r["result"]["correct"] for rows in sets for r in rows if r["result"]]}
            print(json.dumps(summary), flush=True)
            log.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
