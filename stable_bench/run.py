"""Run one cell of the benchmark on this machine's CUDA cards.

    python3 stable_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's checks on standard error and
one JSON object as the last line of standard output. Exits with another
code than 0, and prints no result, without enough CUDA cards, without the
program (``src/repro_torch``), or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# keep any library the program loads from importing JAX by itself
os.environ.setdefault("USE_FLAX", "0")
# one process with one host thread for PyTorch's and numpy's own pools: no
# idle worker spins beside the thread that drives the card
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from stable_bench import bench

    cell = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"), args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 3
    try:
        from repro_torch import api
    except ImportError as e:
        print(f"run.py: the program is not in this checkout ({e})", file=sys.stderr)
        return 4
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), api, T_START)
    foreign = bench.foreign_modules()
    if foreign:
        print(f"run.py: JAX or the JAX package was loaded: {', '.join(foreign)}", file=sys.stderr)
        return 5
    for why, n in out.pop("malformed_by").items():
        print(f"malformed answers, {why}: {n}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
