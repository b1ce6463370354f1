"""The port's serving subsystem (``repro_torch.serve``, ``repro_torch.cache``
and the ``repro_torch.launch.serve`` CLI) against the reference's.

One index, built once on integer-valued features and saved, is loaded by
``repro.api.Engine`` and by ``repro_torch.api.Engine(device="cpu")``, so the
two serve stacks search the same graph. Every test pins ``backend="graph"``
or ``"brute"``: the reference's ``"auto"`` plans from a wall-clock probe,
and on the CPU the port's plain ``fused_auto`` is a BLAS product that is
not batch-invariant, so the bit-exact bars within the port are held on the
graph backend.

Tolerances: against the reference, response types, reject reasons,
``bucket`` and ``batch_fill`` equal; ids equal except at near-ties
(|Δd| ≤ 2·(1e-6 + 1e-5·|d|)); dists within rtol 1e-5; the stats counters
equal. Within the port, a served response equals its query searched alone
bit for bit.
"""
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset  # noqa: E402
from repro import api as japi, serve as jserve  # noqa: E402
from repro_torch import api as tapi, serve as tserve  # noqa: E402
from repro_torch.cache import ResultCache  # noqa: E402
from repro_torch.core import routing as troute  # noqa: E402
from repro_torch.core.help_graph import HelpConfig as THelp  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import request as treq  # noqa: E402

KINDS = ("match", "subset", "one_of", "between")
LABELS = 3
BUCKETS = (1, 8)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(reference engine, port engine, query features, query attrs) over one
    saved index."""
    f, a, qf, qa = dataset(n=2048, n_queries=48, integer=True, seed=6)
    built = tapi.Engine.build(f, a, THelp(**HELP_KW), device="cpu")
    path = str(tmp_path_factory.mktemp("serve_index"))
    built.index.save(path)  # arrays only: no cost model, no probe
    return japi.Engine.load(path), tapi.Engine.load(path, device="cpu"), qf, qa


def query(mod, qf, qa, i: int, kind: str):
    """Query ``i`` of one predicate kind, built with ``mod`` (either
    package's ``api``)."""
    v, a = qf[i % len(qf)], [int(x) for x in qa[i % len(qa)]]
    if kind == "match":
        return mod.Query(v, [mod.MATCH(x) for x in a])
    if kind == "subset":
        return mod.Query(v, [mod.MATCH(a[0]), mod.MATCH(a[1]), mod.ANY, mod.ANY, mod.ANY])
    if kind == "one_of":
        return mod.Query(v, [mod.ONE_OF(a[0], (a[0] + 1) % LABELS), mod.MATCH(a[1]), mod.ANY,
                             mod.MATCH(a[3]), mod.MATCH(a[4])])
    assert kind == "between"
    return mod.Query(v, [mod.BETWEEN(0, 1), mod.MATCH(a[1]), mod.MATCH(a[2]), mod.ANY,
                         mod.MATCH(a[4])])


def params(mod, backend="graph", **kw):
    return mod.SearchParams(**{"k": 10, "backend": backend, **kw})


def solo(eng, q, p):
    """``q`` searched alone through the port's ``Engine.search``."""
    res = eng.search(tapi.QueryBatch.from_queries([q]), p)
    return res.ids[0].numpy(), res.dists[0].numpy()


def assert_same_as_solo(eng, reqs, resps, p):
    for req, r in zip(reqs, resps):
        ids, dists = solo(eng, req.query, p)
        np.testing.assert_array_equal(r.ids, ids)
        np.testing.assert_array_equal(r.dists, dists)


def assert_ids_tie_aware(jd, ji, ti):
    """Ids equal except at near-ties of the reference's distances."""
    tie = 1e-6 + 1e-5 * np.abs(jd)
    for p in np.flatnonzero(ji != ti):
        near = np.abs(jd - jd[p]) <= 2 * tie[p]
        near[p] = False
        assert near.any(), f"slot {p}: id {ti[p]} != {ji[p]}, no near-tie"


def assert_same_responses(jresp, tresp):
    """Types, reject reasons, batch shapes; ids tie-aware, dists rtol 1e-5."""
    assert [type(r).__name__ for r in jresp] == [type(r).__name__ for r in tresp]
    for j, t in zip(jresp, tresp):
        assert (j.request_id, j.tenant) == (t.request_id, t.tenant)
        if isinstance(t, tserve.Rejected):
            assert j.reason == t.reason
        elif isinstance(t, tserve.Completed):
            assert (j.bucket, j.batch_fill, j.cached) == (t.bucket, t.batch_fill, t.cached)
            assert_ids_tie_aware(np.asarray(j.dists), np.asarray(j.ids), t.ids)
            np.testing.assert_allclose(t.dists, np.asarray(j.dists), rtol=1e-5)


def run_both(case, make_trace, make_registry, **kw):
    """The same trace through both packages' ``serve_loop``; the responses
    must agree (``assert_same_responses``)."""
    jeng, teng, _, _ = case
    jresp, jstats = jserve.serve_loop(jeng, make_trace(japi, jserve), make_registry(japi, jserve),
                                      **kw)
    tresp, tstats = tserve.serve_loop(teng, make_trace(tapi, tserve), make_registry(tapi, tserve),
                                      **kw)
    assert_same_responses(jresp, tresp)
    return jresp, tresp, jstats, tstats


def default_registry(backend="graph", **kw):
    def make(mod, pkg):
        return pkg.TenantRegistry(default_policy=pkg.TenantPolicy(params=params(mod, backend), **kw))
    return make


# ---------------------------------------------------------------------------
# Against the reference: one scripted trace through both serve loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["graph", "brute"])
def test_serve_loop_matches_reference(case, backend):
    """48 requests, 3 tenants, the four predicate kinds, 0.3 ms apart, one
    tenant rate-limited: equal responses and equal stats counters."""
    _, _, qf, qa = case

    def make_trace(mod, pkg):
        return [(i * 3e-4, pkg.Request("abc"[i % 3], query(mod, qf, qa, i, KINDS[i % 4])))
                for i in range(48)]

    def make_registry(mod, pkg):
        reg = pkg.TenantRegistry()
        p = params(mod, backend)
        reg.register("a", pkg.TenantPolicy(params=p))
        reg.register("b", pkg.TenantPolicy(params=p))
        reg.register("c", pkg.TenantPolicy(params=p, rate=100.0, burst=3.0))
        return reg

    jresp, tresp, jstats, tstats = run_both(case, make_trace, make_registry, window_ms=2.0,
                                            buckets=BUCKETS)
    shed = [r for r in tresp if not r.ok]
    assert shed and {r.tenant for r in shed} == {"c"}
    assert {r.reason for r in shed} == {treq.REJECT_RATE}
    assert {r.bucket for r in tresp if r.ok} == {1, 8}
    js, ts = jstats.snapshot(), tstats.snapshot()
    for key in ("submitted", "completed", "rejected", "rejected_by_reason", "batches",
                "batch_fill_ratio", "queue_depth", "max_queue_depth"):
        assert js[key] == ts[key], key
    strip = lambda pt: {t: {k: v for k, v in c.items() if k != "qps"} for t, c in pt.items()}
    assert strip(js["per_tenant"]) == strip(ts["per_tenant"])
    assert (jstats.real_rows, jstats.bucket_rows) == (tstats.real_rows, tstats.bucket_rows)


# ---------------------------------------------------------------------------
# Within the port: served responses equal solo searches, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_padded_bucket_matches_solo(case, kind):
    """5 requests padded to a bucket of 8 (inert ANY rows, or clones of row 0
    for an all-MATCH group) return what each query returns alone."""
    _, teng, qf, qa = case
    p = params(tapi)
    reqs = [tserve.Request("t", query(tapi, qf, qa, i, kind), request_id=i) for i in range(5)]
    stats = tserve.ServerStats(teng)
    mb = tserve.Microbatcher(teng, stats, window_s=1.0, buckets=(8, 16))
    for r in reqs:
        assert mb.enqueue(r, p, now=0.0) == []
    out = {c.request_id: c for c in mb.flush_all(0.0)}
    assert len(out) == 5 and stats.batches == 1 and stats.bucket_rows == 8
    assert {(c.bucket, c.batch_fill) for c in out.values()} == {(8, 5 / 8)}
    assert_same_as_solo(teng, reqs, [out[r.request_id] for r in reqs], p)


def test_trace_matches_solo_and_compiles_nothing_after_warmup(case):
    _, teng, qf, qa = case
    p = params(tapi)
    trace = [(i * 2e-4, tserve.Request("abc"[i % 3], query(tapi, qf, qa, i, KINDS[i % 4])))
             for i in range(40)]
    reg = lambda: tserve.TenantRegistry(default_policy=tserve.TenantPolicy(params=p))
    tserve.serve_loop(teng, trace, reg(), window_ms=2.0, buckets=(1, 8, 32))  # warm-up
    t0 = troute.trace_count()
    resp, stats = tserve.serve_loop(teng, trace, reg(), window_ms=2.0, buckets=(1, 8, 32))
    assert troute.trace_count() == t0
    snap = stats.snapshot()
    assert snap["retraces"] == 0 and snap["plan_cache"]["misses"] == 0
    assert snap["plan_cache"]["hit_rate"] == 1.0
    assert all(r.ok for r in resp) and stats.completed == 40
    assert_same_as_solo(teng, [req for _, req in trace], resp, p)


def test_mixed_kinds_split_groups(case):
    _, teng, qf, qa = case
    stats = tserve.ServerStats(teng)
    mb = tserve.Microbatcher(teng, stats, window_s=1.0, buckets=(1, 8))
    for i, kind in enumerate(KINDS + ("match",)):
        mb.enqueue(tserve.Request("t", query(tapi, qf, qa, i, kind), request_id=i),
                   params(tapi), now=0.0)
    assert len(mb.queue.keys()) == 4
    assert len(mb.flush_all(0.0)) == 5 and stats.batches == 4


def test_full_bucket_flushes_eagerly(case):
    _, teng, qf, qa = case
    mb = tserve.Microbatcher(teng, tserve.ServerStats(teng), window_s=1e9, buckets=(1, 4))
    flushed = []
    for i in range(4):
        flushed = mb.enqueue(tserve.Request("t", query(tapi, qf, qa, i, "match"), request_id=i),
                             params(tapi), now=0.0)
    assert len(flushed) == 4 and mb.queue.depth == 0
    assert flushed[0].bucket == 4 and flushed[0].batch_fill == 1.0


def test_bucket_for_ladder(case):
    mb = tserve.Microbatcher(case[1], tserve.ServerStats(), window_s=1.0, buckets=(32, 1, 8))
    assert mb.buckets == (1, 8, 32)
    assert [mb.bucket_for(n) for n in (1, 2, 8, 9, 32, 40)] == [1, 8, 8, 32, 32, 32]
    with pytest.raises(ValueError):
        tserve.Microbatcher(case[1], tserve.ServerStats(), buckets=(0, 8))


# ---------------------------------------------------------------------------
# Admission: each decision equal to the reference's on the same trace
# ---------------------------------------------------------------------------


def test_token_bucket_refill_matches_reference():
    times = [0.0, 0.0, 0.0, 0.05, 0.1, 0.09, 0.25, 0.25, 0.25, 1.0, 1.0, 1.0]
    jb, tb = jserve.TokenBucket(rate=10.0, burst=2.0), tserve.TokenBucket(rate=10.0, burst=2.0)
    got = [tb.try_take(t) for t in times]
    assert got == [jb.try_take(t) for t in times]
    assert got[:6] == [True, True, False, False, True, False]  # refill, no time reversal
    inf = tserve.TokenBucket(rate=math.inf, burst=2.0)
    assert all(inf.try_take(0.0) for _ in range(10))


def test_inf_rate_never_sheds_at_identical_timestamps(case):
    """40 same-instant requests (> the default burst of 32) all admit."""
    _, _, qf, qa = case
    trace = lambda mod, pkg: [(0.0, pkg.Request("t", query(mod, qf, qa, i, "match")))
                              for i in range(40)]
    _, tresp, _, _ = run_both(case, trace, default_registry(), window_ms=1.0, buckets=BUCKETS)
    assert all(r.ok for r in tresp)


def test_duplicate_inflight_id_rejected(case):
    _, _, qf, qa = case
    trace = lambda mod, pkg: [
        (0.0, pkg.Request("t", query(mod, qf, qa, 0, "match"), request_id=7)),
        (0.0, pkg.Request("t", query(mod, qf, qa, 1, "match"), request_id=7)),
    ]
    _, tresp, _, _ = run_both(case, trace, default_registry(), window_ms=1.0, buckets=BUCKETS)
    assert tresp[0].ok and tresp[1].reason == treq.REJECT_DUPLICATE


def test_caps_and_unknown_tenant(case):
    _, _, qf, qa = case

    def trace(mod, pkg):
        mk = lambda **kw: pkg.Request("t", query(mod, qf, qa, 0, "match"), **kw)
        return [
            (0.0, mk(params=params(mod, k=32))),  # k cap
            (0.0, mk(params=params(mod, pool_size=128))),  # pool cap
            (0.0, pkg.Request("ghost", query(mod, qf, qa, 0, "match"))),  # unknown
            (0.0, mk()),
        ]

    def registry(mod, pkg):
        reg = pkg.TenantRegistry()
        reg.register("t", pkg.TenantPolicy(params=params(mod), max_k=16, max_pool=64))
        return reg

    _, tresp, _, tstats = run_both(case, trace, registry, window_ms=1.0, buckets=BUCKETS)
    assert [getattr(r, "reason", None) for r in tresp] == [
        treq.REJECT_K_CAP, treq.REJECT_POOL_CAP, treq.REJECT_UNKNOWN, None]
    assert tstats.completed == 1


def test_queue_full_sheds(case):
    _, _, qf, qa = case
    trace = lambda mod, pkg: [(0.0, pkg.Request("t", query(mod, qf, qa, i, "match")))
                              for i in range(6)]
    _, tresp, _, _ = run_both(case, trace, default_registry(), window_ms=1.0, buckets=BUCKETS,
                              max_queue=4)
    assert [getattr(r, "reason", None) for r in tresp] == [None] * 4 + [treq.REJECT_QUEUE] * 2


# ---------------------------------------------------------------------------
# Writes: the port's engines are immutable
# ---------------------------------------------------------------------------


def test_writes_rejected_as_immutable_like_reference(case):
    _, teng, qf, qa = case
    f, a, _, _ = dataset(n=8, n_queries=1, integer=True, seed=6)

    def trace(mod, pkg):
        return [(0.0, pkg.Upsert("t", f[0], a[0])), (0.0, pkg.Delete("t", 3)),
                (0.0, pkg.Request("t", query(mod, qf, qa, 0, "match"))),
                (1e-3, pkg.Upsert("t", f[1], a[1], id=5))]

    _, tresp, jstats, tstats = run_both(case, trace, default_registry(), window_ms=1.0,
                                        buckets=BUCKETS)
    assert [getattr(r, "reason", None) for r in tresp] == [
        treq.REJECT_IMMUTABLE, treq.REJECT_IMMUTABLE, None, treq.REJECT_IMMUTABLE]
    assert jstats.snapshot()["writes"] == tstats.snapshot()["writes"]
    assert tstats.snapshot()["writes"]["shed"] == 3
    reg = default_registry()(tapi, tserve)
    with tserve.ThreadedServer(teng, reg, window_ms=1.0, buckets=(1,)) as srv:
        writes = [srv.submit(w).result(timeout=30) for _, w in trace(tapi, tserve)
                  if not isinstance(w, tserve.Request)]
    assert [w.reason for w in writes] == [treq.REJECT_IMMUTABLE] * 3
    assert srv.stats.writes_rejected == 3


# ---------------------------------------------------------------------------
# Result cache at the submission surface
# ---------------------------------------------------------------------------


def test_repeated_request_hits_bit_identical(case):
    _, teng, qf, qa = case
    cache = ResultCache()
    q = query(tapi, qf, qa, 0, "one_of")
    trace = [(i * 0.1, tserve.Request("a", q)) for i in range(3)]
    resp, stats = tserve.serve_loop(teng, trace, default_registry()(tapi, tserve),
                                    window_ms=1.0, buckets=(1,), result_cache=cache)
    assert [r.cached for r in resp] == [False, True, True]
    for r in resp[1:]:
        np.testing.assert_array_equal(r.ids, resp[0].ids)
        np.testing.assert_array_equal(r.dists, resp[0].dists)
    rc = stats.snapshot()["result_cache"]
    assert (rc["hits"], rc["size"], rc["served"]) == (2, 1, 2)


def test_rejected_requests_never_cached(case):
    _, teng, qf, qa = case
    cache = ResultCache()
    reg = tserve.TenantRegistry()
    reg.register("tight", tserve.TenantPolicy(params=params(tapi), rate=1e-9, burst=1.0))
    q = query(tapi, qf, qa, 0, "match")
    trace = [(0.0, tserve.Request("tight", q)), (0.0, tserve.Request("tight", q))]
    resp, stats = tserve.serve_loop(teng, trace, reg, window_ms=1.0, buckets=(1,),
                                    result_cache=cache)
    assert resp[0].ok and not resp[1].ok
    assert len(cache) == 1 and stats.snapshot()["result_cache"]["served"] == 0


def test_params_override_changes_cache_key(case):
    _, teng, qf, qa = case
    cache = ResultCache()
    reg = tserve.TenantRegistry(default_policy=tserve.TenantPolicy(
        params=params(tapi), max_k=10, max_pool=128))
    wide = params(tapi, pool_size=64)
    q = query(tapi, qf, qa, 0, "match")
    trace = [(0.0, tserve.Request("a", q)), (0.1, tserve.Request("a", q, params=wide)),
             (0.2, tserve.Request("a", q)), (0.3, tserve.Request("a", q, params=wide))]
    resp, stats = tserve.serve_loop(teng, trace, reg, window_ms=1.0, buckets=(1,),
                                    result_cache=cache)
    assert [r.cached for r in resp] == [False, False, True, True]
    snap = stats.snapshot()["result_cache"]
    assert (snap["hits"], snap["size"]) == (2, 2)


def test_threaded_server_repeat_hits(case):
    _, teng, qf, qa = case
    cache = ResultCache()
    q = query(tapi, qf, qa, 0, "match")
    with tserve.ThreadedServer(teng, default_registry()(tapi, tserve), window_ms=0.5,
                               buckets=(1, 8), result_cache=cache) as srv:
        r1 = srv.submit(tserve.Request("a", q)).result(timeout=30)
        r2 = srv.submit(tserve.Request("a", q)).result(timeout=30)
    assert not r1.cached and r2.cached
    np.testing.assert_array_equal(r1.ids, r2.ids)
    np.testing.assert_array_equal(r1.dists, r2.dists)
    assert srv.stats.snapshot()["result_cache"]["served"] == 1


# ---------------------------------------------------------------------------
# ThreadedServer
# ---------------------------------------------------------------------------


def test_threaded_server_serves_and_reports(case):
    _, teng, qf, qa = case
    p = params(tapi)
    reqs = [tserve.Request("t", query(tapi, qf, qa, i, KINDS[i % 4])) for i in range(16)]
    with tserve.ThreadedServer(teng, default_registry()(tapi, tserve), window_ms=2.0,
                               buckets=(1, 8)) as srv:
        out = [f.result(timeout=120) for f in [srv.submit(r) for r in reqs]]
    assert all(r.ok for r in out)
    assert_same_as_solo(teng, reqs, out, p)
    snap = srv.stats.snapshot()
    assert snap["completed"] == 16 and snap["batches"] >= 4
    assert [r.request_id for r in out] == list(range(16))


def test_threaded_server_rejects_after_stop(case):
    _, teng, qf, qa = case
    srv = tserve.ThreadedServer(teng, default_registry()(tapi, tserve), window_ms=1.0,
                                buckets=(1,))
    srv.start()
    srv.stop()
    r = srv.submit(tserve.Request("t", query(tapi, qf, qa, 0, "match"))).result(timeout=10)
    assert not r.ok and r.reason == treq.REJECT_STOPPED


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_serves_on_the_cpu(capsys):
    tlaunch.main(["--device", "cpu", "--n", "2000", "--requests", "64"])
    out = capsys.readouterr().out
    assert "[served] 64/64 completed, 0 shed" in out
    assert "end-to-end: QPS=" in out and "fill=" in out and "plan cache:" in out
    recall = float(out.split("Recall@10=")[1].split()[0])
    assert recall >= 0.8


@pytest.mark.parametrize("flag,value", [("--writes", "200"), ("--write-rate", "5"),
                                        ("--max-delta-rows", "64")])
def test_cli_serves_writes_on_the_cpu(capsys, flag, value):
    """Each write flag of the reference's CLI works in the port's: 200 held
    out rows stream back as upserts (and 50 deletes) through a
    MutableEngine; ``--write-rate`` sheds writes past each tenant's burst,
    and ``--max-delta-rows`` below the write count makes merges fire."""
    argv = ["--device", "cpu", "--n", "1500", "--requests", "48", "--writes", "200"]
    if flag != "--writes":
        argv += [flag, value]
    tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "building index over 1300 nodes" in out and "200 rows held out" in out
    assert "[served] 48/48 completed, 0 shed" in out
    line = out.split("  writes: ")[1].split("\n")[0]
    upserts, deletes, shed = (int(line.split(f" {w}")[0].rsplit(" ", 1)[-1])
                              for w in ("upserts", "deletes", "shed"))
    merges = int(line.split(" merges")[0].rsplit(" ", 1)[-1])
    assert upserts + deletes + shed == 250
    if flag == "--write-rate":
        assert shed > 0
    else:
        assert (upserts, deletes, shed) == (200, 50, 0)
    assert (merges > 0) == (flag == "--max-delta-rows")
    assert "delta:" in out
    assert float(out.split("Recall@10=")[1].split()[0]) >= 0.8


@pytest.mark.parametrize("flag,value", [pytest.param("--hot-rows", -9, id="--hot-rows-9")])
def test_cli_unported_flags_exit_before_building(capsys, flag, value):
    """A flag value the launcher cannot serve (a negative ``--hot-rows``)
    exits before anything is built."""
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", flag, str(value)])
    assert exc.value.code != 0
    err = capsys.readouterr()
    assert flag in err.err and "building" not in err.out


def test_cli_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--n", "2000", "--requests", "8"])


def test_serving_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.obs, repro_torch.cache\n"
        "import repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
