"""The readers of the program's own spans (``program_spans`` and the
``layer_metrics`` built on it): nothing from an empty store, the expected
numbers from hand-built trees, and a traced CPU run of a small graph cell
that reports them all."""
import time

import pytest

from repro_torch import api
from repro_torch.obs import trace as obs_trace
from stable_bench import bench, program_spans
from stable_bench.tests.helpers import CPU, small_cell

READERS = ["routing.hop_issue_ms", "routing.stop_wait_ms", "routing.stop_tests_per_call",
           "routing.active_row_share", "executor.filter_ms_per_call"]


@pytest.fixture
def store():
    obs_trace.PROFILED.clear()
    yield obs_trace.PROFILED
    obs_trace.PROFILED.clear()


def keep(store, batch, stages, filter_s):
    """A ``search`` root of ``batch`` rows whose ``execute`` holds a
    ``coarse`` and a ``refine`` span with the children ``stages`` gives, as
    (name, seconds, active), and a ``filter`` of ``filter_s``."""
    root = obs_trace.Span("search", t0=0.0)
    root.t1 = 1.0
    root.set("backend", "graph").set("batch", batch)
    ex = root.add("execute", 0.0, 1.0)
    for stage, kids in zip(("coarse", "refine"), stages):
        sp = ex.add(stage, 0.0, 0.5)
        for name, s, active in kids:
            child = sp.add(name, 0.0, s)
            if active is not None:
                child.set("active", active)
    ex.add("filter", 0.9, filter_s)
    store.finish(obs_trace.Trace(len(store.traces()), root))


def two_calls(store):
    keep(store, 10, [
        [("stop_test", 0.001, 10), ("hop", 0.004, None), ("stop_test", 0.003, 4),
         ("hop", 0.006, None), ("stop_test", 0.002, 0)],
        [("stop_test", 0.001, 10), ("hop", 0.002, None), ("stop_test", 0.001, 0)],
    ], 0.010)
    keep(store, 20, [
        [("stop_test", 0.002, 20), ("hop", 0.004, None)],  # ended by its iteration limit
        [("stop_test", 0.004, 5), ("hop", 0.004, None), ("stop_test", 0.002, 0)],
    ], 0.030)


EXPECTED = {
    # hops 4, 6, 2, 4, 4 ms
    "routing.hop_issue_ms": 20.0 / 5,
    # stop tests 1, 3, 2, 1, 1, 2, 4, 2 ms
    "routing.stop_wait_ms": 16.0 / 8,
    "routing.stop_tests_per_call": 8 / 2,
    # stop tests followed by a hop: 10 + 4 + 10 of 3 × 10 rows, 20 + 5 of 2 × 20
    "routing.active_row_share": 100.0 * (24 + 25) / (30 + 40),
    "executor.filter_ms_per_call": (10.0 + 30.0) / 2,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_from_an_empty_store(name, store):
    assert program_spans.roots() == []
    assert bench.reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_hand_built_trees(name, store):
    two_calls(store)
    assert bench.reader(name)({}) == pytest.approx(EXPECTED[name])


def test_traced_run_of_a_small_graph_cell_reports_the_span_metrics(store):
    cell = small_cell("sift1m-theta243.bulk_graph")
    out = bench.run_cell(cell, 2**31 + 11, 0.5, True, CPU, api, time.perf_counter())
    assert out["correct"] is True
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(metrics)
    roots = program_spans.roots()
    assert roots and all(r.attrs["backend"] == "graph" for r in roots)
    for r in roots:
        hops = len(program_spans.named(r, "hop"))
        assert hops <= len(program_spans.named(r, "stop_test")) <= hops + 2
    assert 0 < metrics["routing.active_row_share"] <= 100
    assert metrics["routing.hop_issue_ms"] > 0 and metrics["routing.stop_wait_ms"] > 0
    assert metrics["executor.filter_ms_per_call"] > 0
