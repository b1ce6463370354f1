"""Small cells for the CPU tests: the manifest's cells cut to a few
thousand rows, run on the CPU with the kernels' plain versions."""
import torch

from stable_bench import bench

SMALL = dict(n_rows=3000, n_queries=200, latent_dim=8)
SMALL_BATCH = {"bulk_graph": "all", "bulk_exact": 16}
CPU = torch.device("cpu")


def manifest() -> dict:
    return bench.load_json(bench.ROOT / "BENCHMARK.json")


#: a small partitioned index: P = 8 partitions of ≈ 375 rows (buckets of
#: 512) under a cap of two buckets, so a call loads and evicts
SMALL_PARTITION = {"n_partitions": 8, "residency_rows": 1024, "kmeans_iters": 10}
#: small partitioned cells by name: (sub-backend, nprobe) over
#: ``bulk_exact``'s calls; ``brute_full`` probes every partition
PARTITIONED = {"partitioned.brute": ("brute", 3), "partitioned.brute_full": ("brute", 8),
               "partitioned.graph": ("graph", 3)}
#: the four predicate kinds on two of the five attributes at most, for the
#: scan of 3 of 8 partitions: its ≈ 1,100 rows hold ≥ 10 admitted rows for
#: every query, as the card's 1M rows do for ``bulk_exact``'s classes, where
#: a MATCH of all five admits ≈ 12 of the 3,000 rows
WIDE_CLASSES = [
    {"name": "match", "default": "any", "attrs": {"0": "match", "1": "match"}},
    {"name": "subset", "default": "any", "attrs": {"0": "match"}},
    {"name": "one_of", "default": "any", "attrs": {"0": ["one_of", 0, 1], "1": "match"}},
    {"name": "between", "default": "any", "attrs": {"0": ["between", 0, 1], "1": "match"}},
]
#: ``short_share``'s limit in those cells: a sound run reads 0 there, half a
#: batch left out 0.5
SMALL_SHORT_SHARE = 0.25


def small_cell(name: str) -> bench.Cell:
    """A cell of the manifest cut to a few thousand rows, or one of
    ``PARTITIONED``: sift1m-theta243's bulk_exact cell cut alike, its index
    partitioned and its mix on the partitioned backend (a scan of some
    partitions with ``WIDE_CLASSES``)."""
    if name in PARTITIONED:
        sub_backend, nprobe = PARTITIONED[name]
        cell = small_cell("sift1m-theta243.bulk_exact")
        cell.config["index"]["partition"] = dict(SMALL_PARTITION)
        cell.mix["params"].update(backend="partitioned", nprobe=nprobe, sub_backend=sub_backend)
        bench.check_backend(name, cell.config["index"], name, cell.mix["params"])
        if name == "partitioned.brute":
            cell.mix["classes"] = WIDE_CLASSES
            cell.limits["short_share"] = SMALL_SHORT_SHARE
        return cell
    cell = bench.Cell(manifest(), name)
    cell.config.update(SMALL)
    cell.mix["batch"] = SMALL_BATCH[cell.workload["traffic"]]
    return cell
