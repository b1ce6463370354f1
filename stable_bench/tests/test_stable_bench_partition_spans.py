"""The readers of the partitioned searcher's spans (``probe``, ``group``,
``merge``): nothing from an empty store or from a tree without those spans,
the expected numbers from hand-built trees, and a traced CPU run of the
partitioned cell cut small that reports them."""
import time

import pytest

from repro_torch import api
from repro_torch.obs import trace as obs_trace
from repro_torch.partition.store import row_bucket
from stable_bench import bench, program_spans, roofline
from stable_bench.tests.helpers import CPU, SMALL, SMALL_SHORT_SHARE, WIDE_CLASSES, manifest

IVF = "sift1m-theta243-ivf128.bulk_ivf"
READERS = ["partition.probe_ms", "partition.group_ms", "partition.groups_per_call",
           "partition.pad_share", "partition.scan_roofline"]
#: the partitioned cell cut to a few thousand rows: P = 8 (partitions of
#: ≈ 375 rows in buckets of 512), all resident, nprobe 3, and the four
#: predicate kinds on two attributes at most, so that the scanned rows hold
#: ≥ 10 admitted rows for every query, as the card's 1M rows do
SMALL_PARTITION = {"n_partitions": 8, "residency_rows": None, "kmeans_iters": 10}
SMALL_NPROBE = 3


def small_ivf_cell() -> bench.Cell:
    cell = bench.Cell(manifest(), IVF)
    cell.config.update(SMALL)
    cell.config["index"]["partition"] = dict(SMALL_PARTITION)
    cell.mix["batch"] = 16
    cell.mix["params"]["nprobe"] = SMALL_NPROBE
    cell.mix["classes"] = WIDE_CLASSES
    cell.limits["short_share"] = SMALL_SHORT_SHARE
    bench.check_backend(IVF, cell.config["index"], IVF, cell.mix["params"])
    return cell


@pytest.fixture
def store():
    obs_trace.PROFILED.clear()
    yield obs_trace.PROFILED
    obs_trace.PROFILED.clear()


def keep(store, batch, probe_s, groups):
    """A ``search`` root of ``batch`` rows whose ``execute`` holds a
    ``probe`` of ``probe_s`` over 8 centroids, a ``group`` a tuple of
    ``groups`` (seconds, queries, bucket, rows_real, rows) and a ``merge``."""
    root = obs_trace.Span("search", t0=0.0)
    root.t1 = 1.0
    root.set("backend", "partitioned").set("batch", batch)
    ex = root.add("execute", 0.0, 1.0)
    ex.add("probe", 0.0, probe_s).set("partitions_scored", 8)
    for pid, (s, q, b, rr, r) in enumerate(groups):
        g = ex.add("group", 0.1, s)
        for k, v in zip(("pid", "queries", "bucket", "rows_real", "rows"), (pid, q, b, rr, r)):
            g.set(k, v)
    ex.add("merge", 0.9, 0.001)
    store.finish(obs_trace.Trace(len(store.traces()), root))


CALLS = [
    (16, 0.002, [(0.001, 5, 8, 300, 512), (0.003, 11, 16, 700, 1024), (0.002, 16, 16, 512, 512)]),
    (32, 0.004, [(0.004, 3, 4, 256, 256), (0.005, 32, 32, 1100, 2048)]),
]
GROUPS = [g for _, _, gs in CALLS for g in gs]
DIM, ATTR_DIM = 128, 5
FUSED_S = 0.002
CTX = {"config": {"dim": DIM, "attr_dim": ATTR_DIM},
       "trace": {"ops": {"void fused_auto_kernel<128, 128>": [(0.0, 0.0015), (0.5, 0.5005)],
                         "radixSort": [(0.0, 1.0)]}}}


def _least():
    t = sum(roofline.least_time_s(*roofline.fused_auto_work(b, 8, DIM, 1)) for b, _, _ in CALLS)
    return t + sum(roofline.least_time_s(*roofline.fused_auto_work(b, r, DIM, ATTR_DIM))
                   for _, _, b, _, r in GROUPS)


EXPECTED = {
    "partition.probe_ms": (2.0 + 4.0) / 2,
    "partition.group_ms": 1e3 * sum(g[0] for g in GROUPS) / len(GROUPS),
    "partition.groups_per_call": len(GROUPS) / len(CALLS),
    "partition.pad_share": 100.0 * (1.0 - sum(q * rr for _, q, _, rr, _ in GROUPS)
                                    / sum(b * r for _, _, b, _, r in GROUPS)),
    "partition.scan_roofline": 100.0 * _least() / FUSED_S,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_from_an_empty_store(name, store):
    assert program_spans.roots() == []
    assert bench.reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_from_a_graph_tree(name, store):
    """A flat graph search's root holds none of the searcher's spans."""
    root = obs_trace.Span("search", t0=0.0)
    root.t1 = 1.0
    root.set("backend", "graph").set("batch", 8)
    ex = root.add("execute", 0.0, 1.0)
    ex.add("coarse", 0.0, 0.5).add("hop", 0.0, 0.1)
    store.finish(obs_trace.Trace(0, root))
    assert bench.reader(name)(CTX) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_hand_built_trees(name, store):
    for batch, probe_s, groups in CALLS:
        keep(store, batch, probe_s, groups)
    assert bench.reader(name)(CTX) == pytest.approx(EXPECTED[name])


def test_scan_roofline_reads_nothing_without_the_kernel(store):
    for batch, probe_s, groups in CALLS:
        keep(store, batch, probe_s, groups)
    ctx = dict(CTX, trace={"ops": {"radixSort": [(0.0, 1.0)]}})
    assert bench.reader("partition.scan_roofline")(ctx) is None


def test_traced_run_of_the_small_partitioned_cell_reports_the_span_metrics(store):
    """The cell cut small, traced on the CPU: its roots hold one probe, one
    group a probed partition and one merge, and the span readers report.
    ``partition.scan_roofline`` reads the device's kernels, of which a CPU
    trace has none: it reports nothing here, as ``device.idle_pct`` does."""
    cell = small_ivf_cell()
    out = bench.run_cell(cell, 2**31 + 21, 0.5, True, CPU, api, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["short_share"]["value"] == 0.0
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS[:4]) <= set(metrics)
    assert "partition.scan_roofline" not in metrics and out["device"]["busy_s"] == 0.0
    roots = program_spans.roots()
    assert roots and all(r.attrs["backend"] == "partitioned" for r in roots)
    for r in roots:
        (probe,) = program_spans.named(r, "probe")
        assert len(program_spans.named(r, "merge")) == 1
        groups = program_spans.named(r, "group")
        assert len({g.attrs["pid"] for g in groups}) == len(groups)
        assert 1 <= len(groups) <= SMALL_PARTITION["n_partitions"]
        assert sum(g.attrs["queries"] for g in groups) == probe.attrs["partitions_probed"]
        for g in groups:
            assert g.attrs["queries"] <= g.attrs["bucket"] <= r.attrs["batch"]
            assert g.attrs["rows"] == row_bucket(g.attrs["rows_real"])
    assert 0 < metrics["partition.pad_share"] < 100
    assert 1 <= metrics["partition.groups_per_call"] <= 8
    assert metrics["partition.probe_ms"] > 0 and metrics["partition.group_ms"] > 0
