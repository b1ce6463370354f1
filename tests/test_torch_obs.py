"""The port's observability layer (``repro_torch.obs``) against the
reference's ``repro.obs``: registry thread-safety and bounds, streaming
histogram percentiles against numpy (within one log bucket, ≤ 26%
relative), Prometheus text equal to the reference's for the same records,
JSON and Chrome-trace exports, the metrics HTTP endpoint on an ephemeral
port, the span tree of a sampled ``serve_loop`` batch on the port's
engine (graph backend, CPU), which sums to the end-to-end latency, and the
spans of a search under ``torch.profiler``: a ``search`` root kept in
``profiled_traces()`` with its stages, hops and stop tests, the same names
nested alike in the profiler's events, and nothing kept or allocated
without a profiler."""
import json
import re
import sys
import threading
import tracemalloc
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.api import MATCH, Engine, Query, SearchParams  # noqa: E402
from repro_torch.core.help_graph import HelpConfig  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request, TenantPolicy, TenantRegistry, ThreadedServer, serve_loop,
)

PARAMS = SearchParams(k=10, backend="graph")
SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9+\-.eEinfa]+$")


@pytest.fixture(scope="module")
def case():
    f, a, qf, qa = dataset(n=2000, n_queries=48, integer=True, seed=3)
    return Engine.build(f, a, HelpConfig(**HELP_KW), device="cpu"), qf, qa


def trace(qf, qa, n=48, spacing=2e-4):
    return [(i * spacing, Request(("acme", "beta")[i % 2],
                                  Query(qf[i], [MATCH(int(x)) for x in qa[i]])))
            for i in range(n)]


def fill(obs):
    """The same sequence of records into a registry of ``obs``."""
    reg = obs.MetricsRegistry()
    reg.counter("reqs", help="requests").inc(7)
    reg.gauge("depth").set(3.5)
    h = reg.histogram("lat_ms")
    for v in (0.5, 1.5, 12.0, 80.0, 0.003, 7e4):
        h.observe(v)
    reg.register_provider("exec", lambda: {"hits": 2, "rate": 0.5, "nested": {"flag": True}})
    return reg


def parse_prometheus(text: str) -> dict:
    """Every sample line of a Prometheus text exposition, by name."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert SAMPLE.match(line), line
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------


def test_counter_conservation_under_threads():
    """16 threads (more than the cores) on one counter and one histogram,
    with a short switch interval, lose no update."""
    reg = tobs.MetricsRegistry()
    c, h = reg.counter("ops"), reg.histogram("lat_ms")
    per_thread, n_threads = 2000, 16

    def work():
        for i in range(per_thread):
            c.inc()
            h.observe(float(i % 50) + 0.1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.value == per_thread * n_threads
    assert h.count == per_thread * n_threads


def test_histogram_percentiles_match_numpy():
    rng = np.random.default_rng(0)
    samples = np.exp(rng.normal(np.log(5.0), 1.0, size=20_000))
    h = tobs.MetricsRegistry().histogram("lat", bounds=tobs.LATENCY_MS_BOUNDS)
    j = jobs.MetricsRegistry().histogram("lat", bounds=jobs.LATENCY_MS_BOUNDS)
    for s in samples:
        h.observe(float(s))
        j.observe(float(s))
    for q in (50, 90, 95, 99):
        exact = float(np.percentile(samples, q))
        assert abs(h.percentile(q) - exact) / exact < 0.26, q
        assert h.percentile(q) == j.percentile(q)
    assert h.count == samples.size
    assert (h.min, h.max) == (pytest.approx(samples.min()), pytest.approx(samples.max()))


def test_histogram_state_is_bounded():
    h = tobs.MetricsRegistry().histogram("lat")
    for i in range(100_000):
        h.observe(float(i % 977) + 0.5)
    assert h.snapshot()["count"] == 100_000
    assert len(h.cumulative_buckets()) == len(tobs.LATENCY_MS_BOUNDS) + 1
    assert len(h._counts) == len(tobs.LATENCY_MS_BOUNDS) + 1
    assert tuple(tobs.log_bounds(1e-3, 6e4)) == tuple(jobs.log_bounds(1e-3, 6e4))


# ---------------------------------------------------------------------------
# Exporters and the HTTP endpoint
# ---------------------------------------------------------------------------


def test_prometheus_text_parses_and_equals_reference():
    text = tobs.prometheus_text(fill(tobs))
    assert text == jobs.prometheus_text(fill(jobs))
    samples = parse_prometheus(text)
    assert "# TYPE reqs counter" in text and "# TYPE lat_ms histogram" in text
    buckets = [v for k, v in samples.items() if k.startswith("lat_ms_bucket")]
    assert buckets == sorted(buckets) and buckets[-1] == 6
    assert samples['lat_ms_bucket{le="+Inf"}'] == 6 and samples["lat_ms_count"] == 6
    assert samples["exec_hits"] == 2 and samples["exec_nested_flag"] == 1


def test_json_snapshot_round_trips():
    text = tobs.json_snapshot(fill(tobs))
    assert text == jobs.json_snapshot(fill(jobs))
    snap = json.loads(text)
    assert snap["counters"]["reqs"] == 7
    assert snap["histograms"]["lat_ms"]["count"] == 6
    assert snap["providers"]["exec_rate"] == 0.5


def test_chrome_trace_structure(tmp_path):
    t = tobs.Tracer(sample_every=1)
    tr = t.start("request")
    with tr.root.span("batch"):
        with obs_trace.span("plan") as p:
            p.set("backend", "graph")
    t.finish(tr)
    doc = tobs.chrome_trace(t.traces())
    events = doc["traceEvents"]
    assert {e["name"] for e in events} == {"request", "batch", "plan"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 and e["tid"] == tr.trace_id for e in events)
    assert next(e for e in events if e["name"] == "plan")["args"]["backend"] == "graph"
    path = tmp_path / "trace.json"
    tobs.dump_chrome_trace(t.traces(), str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))


def test_metrics_server_scrape_on_ephemeral_port():
    reg = fill(tobs)
    with tobs.MetricsServer(reg, port=0) as srv:
        assert srv.port > 0 and srv.url.startswith("http://127.0.0.1:")
        text = urllib.request.urlopen(srv.url + "/metrics", timeout=10).read().decode()
        assert parse_prometheus(text)["reqs"] == 7
        snap = json.loads(urllib.request.urlopen(srv.url + "/metrics.json", timeout=10).read())
        assert snap["counters"]["reqs"] == 7
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=10)


# ---------------------------------------------------------------------------
# Traces and stats of the serve loop on the port's engine
# ---------------------------------------------------------------------------


def test_trace_tree_sums_to_end_to_end_latency(case):
    eng, qf, qa = case
    tracer = tobs.Tracer(sample_every=1)
    resp, _ = serve_loop(eng, trace(qf, qa), TenantRegistry(
        default_policy=TenantPolicy(params=PARAMS)), window_ms=2.0, buckets=(1, 8, 32),
        tracer=tracer)
    assert all(r.ok for r in resp)
    traces = tracer.traces()
    assert traces
    for tr in traces:
        root = tr.root
        queue, batch = root.find("queue"), root.find("batch")
        assert queue is not None and batch is not None
        assert root.duration == pytest.approx(queue.duration + batch.duration, abs=1e-9)
        for name in ("assemble", "plan", "compile", "execute"):
            assert batch.find(name) is not None, name
        child_s = sum(c.duration for c in batch.children)
        assert 0.5 * batch.duration <= child_s <= batch.duration + 1e-9
        attr_ms = root.attrs["queue_ms"] + root.attrs["service_ms"]
        total_ms = root.duration * 1e3
        assert abs(total_ms - attr_ms) <= max(1.0, 0.25 * total_ms)


def test_untraced_run_records_nothing(case):
    eng, qf, qa = case
    tracer = tobs.Tracer(sample_every=0)
    resp, _ = serve_loop(eng, trace(qf, qa, n=16), TenantRegistry(
        default_policy=TenantPolicy(params=PARAMS)), window_ms=2.0, buckets=(1, 8),
        tracer=tracer)
    assert all(r.ok for r in resp)
    assert tracer.traces() == []


def test_server_stats_registry_sees_every_owner(case):
    eng, qf, qa = case
    _, stats = serve_loop(eng, trace(qf, qa), TenantRegistry(
        default_policy=TenantPolicy(params=PARAMS)), window_ms=2.0, buckets=(1, 8, 32))
    snap = stats.snapshot()
    for key in ("submitted", "completed", "rejected", "latency_ms", "queue_ms_p99",
                "service_ms_p99", "batches", "batch_fill_ratio", "qps", "service_qps",
                "per_tenant", "retraces", "jit_hit_rate", "plan_cache"):
        assert key in snap, key
    assert 0.0 <= snap["latency_ms"]["p50"] <= snap["latency_ms"]["p99"]
    vals = stats.registry.provider_values()
    assert vals["serve_completed"] == stats.completed == 48
    assert "executor_hits" in vals and "routing_jit_traces" in vals
    assert not any(hasattr(stats, a) for a in ("queue_ms", "service_ms", "total_ms"))


def test_threaded_server_metrics_endpoint_counts_completions(case):
    eng, qf, qa = case
    reqs = [req for _, req in trace(qf, qa, n=12)]
    with ThreadedServer(eng, TenantRegistry(default_policy=TenantPolicy(params=PARAMS)),
                        window_ms=1.0, buckets=(1, 8), metrics_port=0) as srv:
        assert all(f.result(timeout=60).ok for f in [srv.submit(r) for r in reqs])
        url = srv.metrics_server.url
        text = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
        snap = json.loads(urllib.request.urlopen(url + "/metrics.json", timeout=10).read())
    completed = srv.stats.snapshot()["completed"]
    assert completed == 12
    assert parse_prometheus(text)["serve_completed"] == completed
    assert snap["providers"]["serve_completed"] == completed


# ---------------------------------------------------------------------------
# Spans under torch.profiler
# ---------------------------------------------------------------------------

#: the spans of a graph search with a ONE_OF post-filter, each with the span
#: it sits in
PARENT = {"plan": "search", "compile": "search", "execute": "search", "seed": "execute",
          "coarse": "execute", "refine": "execute", "emit": "execute", "filter": "execute",
          "hop": ("coarse", "refine"), "stop_test": ("coarse", "refine")}


def one_of_batch(qf, qa):
    return predicate_batches(qf[:24], qa[:24], tapi.query)["one_of"]


def named(span, name):
    out = [span] if span.name == name else []
    for c in span.children:
        out.extend(named(c, name))
    return out


@pytest.fixture
def profiled_search(case):
    """One graph search of a ONE_OF batch under the profiler (CPU events)."""
    from torch.profiler import ProfilerActivity, profile

    eng, qf, qa = case
    qb = one_of_batch(qf, qa)
    eng.search(qb, PARAMS)  # plan compiled outside the profile
    obs_trace.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.search(qb, PARAMS)
    kept = obs_trace.profiled_traces()
    obs_trace.PROFILED.clear()
    return res, kept, prof


def test_profiled_search_keeps_one_search_root_with_every_stage(profiled_search):
    res, kept, _ = profiled_search
    assert len(kept) == 1
    root = kept[0].root
    assert root.name == "search" and root.attrs == {"backend": "graph", "batch": 24}
    for name, parent in PARENT.items():
        spans = named(root, name)
        assert spans, name
        parents = parent if isinstance(parent, tuple) else (parent,)
        assert all(any(s in named(root, p)[0].children for p in parents) for s in spans), name
    hops = int(res.n_hops)
    assert len(named(root, "hop")) == hops > 0
    assert hops <= len(named(root, "stop_test")) <= hops + 2
    for stage in ("coarse", "refine"):
        sp = named(root, stage)[0]
        assert sp.attrs["hops"] == len(named(sp, "hop"))
    tests = named(root, "stop_test")
    assert all(0 <= t.attrs["active"] <= 24 for t in tests)
    assert tests[0].attrs["active"] == 24 and tests[-1].attrs["active"] == 0
    assert named(root, "filter")[0].attrs["rows"] == 24
    assert named(root, "filter")[0].attrs["on_device"] is True  # a flat index's own table
    assert root.duration >= named(root, "execute")[0].duration > 0


def test_profiler_events_hold_the_spans_nested_as_the_tree(profiled_search):
    _, kept, prof = profiled_search
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    for name, parent in PARENT.items():
        assert name in events, name
        parents = parent if isinstance(parent, tuple) else (parent,)
        for e in events[name]:
            up = e.cpu_parent
            while up is not None and up.name not in PARENT and up.name != "search":
                up = up.cpu_parent  # an operator's own events between spans
            assert up is not None and up.name in parents, (name, up and up.name)
    assert len(events["hop"]) == len(named(kept[0].root, "hop"))
    assert len(events["search"]) == 1


def test_answers_equal_with_the_profiler_on_and_off(case, profiled_search):
    eng, qf, qa = case
    res_on, _, _ = profiled_search
    res_off = eng.search(one_of_batch(qf, qa), PARAMS)
    assert torch.equal(res_on.ids, res_off.ids)
    assert torch.equal(res_on.sqdists, res_off.sqdists)
    assert int(res_on.n_hops) == int(res_off.n_hops)
    assert torch.equal(res_on.n_dist_evals, res_off.n_dist_evals)


def test_unprofiled_search_keeps_and_allocates_nothing(case, monkeypatch):
    """Without a profiler or a tracer no span is made, no profiler record is
    entered, nothing is kept, and the span sites allocate nothing."""
    eng, qf, qa = case
    qb = one_of_batch(qf, qa)
    eng.search(qb, PARAMS)
    made = []

    class Counted(obs_trace.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    def no_record(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(obs_trace, "Span", Counted)
    monkeypatch.setattr(obs_trace._profiler, "record_function", no_record)
    obs_trace.PROFILED.clear()
    res = eng.search(qb, PARAMS)
    assert int(res.n_hops) > 0
    assert made == [] and obs_trace.profiled_traces() == []
    assert obs_trace.span("hop") is obs_trace.NOOP_SPAN
    assert obs_trace.profiled_root("search") is obs_trace.NOOP_SPAN

    def sites():
        with obs_trace.profiled_root("search") as root:
            with obs_trace.span("hop") as sp:
                if sp or root:
                    sp.set("active", 1)

    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            sites()
        after = tracemalloc.take_snapshot()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    grown = sum(s.size_diff for s in after.compare_to(before, "filename") if s.size_diff > 0)
    # tracemalloc's own bookkeeping shows a few kB; one object a call would
    # be ≥ 1000 × its size
    assert grown < 16_000 and peak < 64_000


def test_sampled_serve_tree_takes_the_search_spans_under_the_profiler(case):
    """Under the profiler a sampled request's open tree takes the engine's
    spans (no root of its own is kept), and its spans reach the profiler's
    events too."""
    from torch.profiler import ProfilerActivity, profile

    eng, qf, qa = case
    tracer = tobs.Tracer(sample_every=1)
    obs_trace.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        resp, _ = serve_loop(eng, trace(qf, qa, n=8), TenantRegistry(
            default_policy=TenantPolicy(params=PARAMS)), window_ms=2.0, buckets=(1, 8),
            tracer=tracer)
    assert all(r.ok for r in resp)
    assert obs_trace.profiled_traces() == []
    batch = tracer.traces()[0].root.find("batch")
    assert batch.find("execute").find("coarse") is not None and batch.find("hop") is not None
    assert batch.find("search") is None
    names = {e.name for e in prof.events()}
    assert {"batch", "assemble", "plan", "execute", "coarse", "hop", "emit"} <= names
