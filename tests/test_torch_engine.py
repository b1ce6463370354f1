"""``Engine.search`` against the reference ``Engine`` over one saved index,
with the backend pinned (the planner's probe times the hardware, so its
auto decision is not comparable across packages): graph and brute, for
MATCH, subset, ONE_OF and BETWEEN batches, exact on integer-valued
features. Also: equal plans under an injected ``CostModel``, the
executor's hit/miss counters and compiled-plan count, a query bit-identical
alone and padded into a batch of 8, ``save``/``load`` without a probe,
``device=None`` raising without a card, and the post-filter's device test
against ``QueryBatch.admissible_rows``: mask for mask, and search for search
against a host post-filter, with no host copy of the attribute table."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from repro.api import Engine as JEngine, SearchParams as JParams  # noqa: E402
from repro.api import planner as jplanner, query as jquery  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro_torch.api import Engine as TEngine, SearchParams as TParams  # noqa: E402
from repro_torch.api import engine as tengine, planner as tplanner, query as tquery  # noqa: E402
from repro_torch.core import routing as troute  # noqa: E402
from repro_torch.core.graph_ops import INF, INVALID, smallest_k  # noqa: E402
from repro_torch.core.index import index_from_numpy  # noqa: E402

CLASSES = ("match", "subset", "one_of", "between")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    f, a, qf, qa = dataset(n=2048, n_queries=16, integer=True, seed=6)
    jeng = JEngine.build(f, a, JHelp(**HELP_KW))
    path = str(tmp_path_factory.mktemp("jax_engine"))
    jeng.index.save(path)  # arrays only: no cost model, no probe
    teng = TEngine.load(path, device="cpu")
    return jeng, teng, predicate_batches(qf, qa, jquery), predicate_batches(qf, qa, tquery)


def assert_same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.ids), tres.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jres.sqdists), tres.sqdists.numpy())
    np.testing.assert_array_equal(np.asarray(jres.n_dist_evals), tres.n_dist_evals.numpy())
    assert int(jres.n_hops) == int(tres.n_hops)


# the brute oracle filters exactly either way, so enforce_equality only
# changes the graph backend
@pytest.mark.parametrize("backend,enforce", [("graph", False), ("graph", True), ("brute", False)])
@pytest.mark.parametrize("cls", CLASSES)
def test_search_matches_reference_engine(engines, cls, backend, enforce):
    jeng, teng, jb, tb = engines
    kw = dict(k=10, backend=backend, enforce_equality=enforce)
    assert_same(jeng.search(jb[cls], JParams(**kw)), teng.search(tb[cls], TParams(**kw)))


def test_plans_equal_under_injected_cost_model(engines):
    jeng, teng, jb, tb = engines
    table = dict(unit_evals=3.0, probe_pool=32, probe_n=2048, brute_eval_cost=0.7,
                 batch_overhead=40.0, pool_intercept=5.0)
    jm = dataclasses.replace(jeng, cost_model_override=jplanner.cost_model_from_table(table))
    jm._cost_model = None
    tm = TEngine(teng.index, cost_model_override=tplanner.cost_model_from_table(table))
    for cls in CLASSES:
        for b in (1, 8, 16):
            for params in ({}, {"enforce_equality": True}, {"pool_size": 200}, {"k": 5}):
                jq, tq = jb[cls].take(np.arange(b) % 16), tb[cls].take(np.arange(b) % 16)
                jp, tp = jm.plan(jq, JParams(**params)), tm.plan(tq, TParams(**params))
                assert jp.backend == tp.backend
                assert jp.reason == tp.reason
                assert (jp.cost_brute, jp.cost_graph) == (tp.cost_brute, tp.cost_graph)
                jr, tr_ = jp.routing_cfg, tp.routing_cfg
                assert (jr is None) == (tr_ is None)
                if jr is not None:
                    assert dataclasses.asdict(jr) == dataclasses.asdict(tr_)


def test_executor_counters_and_compiled_plans(engines):
    _, teng, _, tb = engines
    eng = TEngine(teng.index, cost_model_override=teng.cost_model_override)
    params = TParams(k=10, backend="graph")
    t0 = troute.trace_count()
    r1 = eng.search(tb["match"], params)
    assert troute.trace_count() == t0 + 1
    r2 = eng.search(tb["match"], params)
    assert troute.trace_count() == t0 + 1  # a hit compiles nothing
    assert torch.equal(r1.ids, r2.ids)
    eng.search(tb["between"], params)  # another predicate kind: a miss
    eng.search(tb["match"].take(np.arange(8)), params)  # another batch shape
    s = eng.executor.stats()
    assert (s["hits"], s["misses"], s["size"]) == (1, 3, 3)
    small = TEngine(teng.index, executor_max_entries=1)
    small.search(tb["match"], params)
    small.search(tb["subset"], params)
    assert small.executor.stats()["evictions"] == 1


@pytest.mark.parametrize("backend", ["graph", "brute"])
def test_query_alone_equals_query_padded_into_batch(engines, backend):
    _, teng, _, tb = engines
    params = TParams(k=10, backend=backend)
    for cls in ("match", "one_of"):
        alone = teng.search(tb[cls].take([3]), params)
        padded = teng.search(tb[cls].take([3, 3, 0, 1, 2, 4, 5, 6]), params)
        assert torch.equal(alone.ids[0], padded.ids[0])
        if backend == "graph":  # the CPU plain brute version is a BLAS product
            assert torch.equal(alone.sqdists[0], padded.sqdists[0])


def test_save_load_keeps_cost_model_and_runs_no_probe(engines, tmp_path):
    _, teng, _, tb = engines
    eng = TEngine(teng.index)
    eng.save(str(tmp_path))  # probes once here
    n0 = tplanner.calibration_count()
    back = TEngine.load(str(tmp_path), device="cpu")
    plan = back.plan(tb["match"], TParams())
    assert tplanner.calibration_count() == n0
    assert back.cost_model == eng.cost_model
    assert plan.backend in ("graph", "brute") and plan.cost_graph is not None
    jback = JEngine.load(str(tmp_path))  # the reference reads the port's save
    assert jback.cost_model.to_json() == eng.cost_model.to_json()


def test_from_parts_and_unported_paths(engines, tmp_path):
    jeng, teng, _, tb = engines
    idx = teng.index
    eng = TEngine.from_parts(idx.features, idx.attrs, idx.graph, idx.metric_cfg, device="cpu")
    assert dataclasses.asdict(eng.index.stats) == dataclasses.asdict(idx.stats)
    res = eng.search(tb["match"], TParams(backend="graph"))
    assert torch.equal(res.ids, teng.search(tb["match"], TParams(backend="graph")).ids)
    # the sharded and partitioned backends are ported; a flat index
    # refuses both as the reference's does
    with pytest.raises(ValueError, match="needs a sharded index"):
        eng.search(tb["match"], TParams(backend="sharded"))
    with pytest.raises(ValueError, match="needs a partitioned index"):
        eng.search(tb["match"], TParams(backend="partitioned"))
    with pytest.raises(ValueError):
        eng.search(tb["match"], TParams(quant="pq"))


def test_device_none_needs_a_card(engines, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, teng, _, _ = engines
    f, a, _, _ = dataset(n=300, n_queries=2)
    with pytest.raises(RuntimeError):
        TEngine.build(f, a)
    teng.index.save(str(tmp_path))
    with pytest.raises(RuntimeError):
        TEngine.load(str(tmp_path))
    idx = teng.index
    with pytest.raises(RuntimeError):
        index_from_numpy(
            idx.features.numpy(), idx.attrs.numpy(), idx.graph.numpy(),
            dataclasses.asdict(idx.metric_cfg), dataclasses.asdict(idx.help_cfg),
            dataclasses.asdict(idx.stats),
        )


def filter_batch(kind: str, b: int, l: int, rng) -> tquery.QueryBatch:
    """A batch over labels 0..3 of one compiled form: point (mask-free),
    wildcard (a point batch with ANY dimensions), interval (BETWEEN), or
    ONE_OF whose widest set has ``v`` values (narrower sets -1 padded),
    mixed with MATCH, ANY and BETWEEN."""
    qf = rng.normal(size=(b, 8)).astype(np.float32)
    qa = rng.integers(0, 4, (b, l)).astype(np.int32)
    if kind == "point":
        return tquery.QueryBatch.match(qf, qa)
    if kind == "wildcard":
        return tquery.QueryBatch.match(qf, qa, active=[0, 2])

    def pred(i, j):
        r = rng.integers(0, 4)
        if kind == "interval" or r == 0:
            lo = int(rng.integers(0, 3))
            return tquery.BETWEEN(lo, lo + int(rng.integers(0, 2)))
        if r == 1:
            return tquery.MATCH(int(qa[i, j]))
        if r == 2:
            return tquery.ANY
        v = int(kind[-1])
        size = v if j == 0 else int(rng.integers(1, v + 1))
        return tquery.ONE_OF(*(int(x) for x in rng.choice(4, size, replace=False)))

    return tquery.QueryBatch.from_queries(
        [tquery.Query(qf[i], [pred(i, j) for j in range(l)]) for i in range(b)]
    )


@pytest.mark.parametrize("one_of_only", [True, False])
@pytest.mark.parametrize("kind", ["point", "wildcard", "interval", "one_of_v1", "one_of_v2",
                                  "one_of_v3"])
def test_device_admissible_rows_equal_host(kind, one_of_only):
    rng = np.random.default_rng(len(kind) + 7 * one_of_only)
    b, k, l, n = 24, 40, 5, 300
    qb = filter_batch(kind, b, l, rng)
    if kind.startswith("one_of"):  # V values, sets narrower than V padded with -1
        v = int(kind[-1])
        assert qb.allowed.shape[2] == v and (qb.allowed[qb.hard] == -1).any() == (v > 1)
    host = rng.integers(0, 4, (n, l)).astype(np.int32)
    ids_np = rng.integers(-1, n, (b, k)).astype(np.int32)  # -1 is INVALID
    assert (ids_np == INVALID).any()
    ids = torch.from_numpy(ids_np)
    table = torch.from_numpy(host)
    got = tengine.admissible_rows(qb, table[ids.clamp_min(0)], one_of_only) & (ids >= 0)
    want = qb.admissible_rows(host[np.maximum(ids_np, 0)], one_of_only) & (ids_np >= 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def host_post_filter(self, res, queries, full):
    """The post-filter computed on the host: the ids copied back, the rows
    gathered from ``host_attrs`` and tested by ``QueryBatch.admissible_rows``."""
    ids = res.ids.cpu().numpy()
    ok = queries.admissible_rows(self.host_attrs[np.maximum(ids, 0)], one_of_only=not full)
    ok = torch.from_numpy(ok & (ids >= 0)).to(res.ids.device)
    sq, take = smallest_k(res.sqdists.masked_fill(~ok, INF), res.sqdists.shape[1])
    out = res.ids.masked_fill(~ok, INVALID).gather(1, take)
    return res._replace(ids=out, dists=torch.sqrt(torch.clamp_min(sq, 0.0)), sqdists=sq)


@pytest.mark.parametrize("cls,enforce", [("one_of", False), ("one_of", True), ("between", True)])
def test_graph_post_filter_on_device_equals_host(engines, monkeypatch, cls, enforce):
    _, teng, _, tb = engines
    dev = TEngine(teng.index, cost_model_override=teng.cost_model_override)
    host = TEngine(teng.index, cost_model_override=teng.cost_model_override)
    calls = []
    monkeypatch.setattr(host, "_predicate_filter",
                        lambda *a: calls.append(1) or host_post_filter(host, *a))
    params = TParams(k=10, backend="graph", enforce_equality=enforce)
    a, b = dev.search(tb[cls], params), host.search(tb[cls], params)
    assert calls == [1]
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert torch.equal(a.sqdists, b.sqdists)
    assert dev._attrs_np is None and dev.device_attrs is teng.index.attrs
