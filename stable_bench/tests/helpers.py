"""Small cells for the CPU tests: the manifest's cells cut to a few
thousand rows, run on the CPU with the kernels' plain versions."""
import torch

from stable_bench import bench

SMALL = dict(n_rows=3000, n_queries=200, latent_dim=8)
SMALL_BATCH = {"bulk_graph": "all", "bulk_exact": 16}
CPU = torch.device("cpu")


def manifest() -> dict:
    return bench.load_json(bench.ROOT / "BENCHMARK.json")


def small_cell(name: str) -> bench.Cell:
    cell = bench.Cell(manifest(), name)
    cell.config.update(SMALL)
    cell.mix["batch"] = SMALL_BATCH[cell.workload["traffic"]]
    return cell
