"""``Engine.search`` against the reference ``Engine`` over one saved index,
with the backend pinned (the planner's probe times the hardware, so its
auto decision is not comparable across packages): graph and brute, for
MATCH, subset, ONE_OF and BETWEEN batches, exact on integer-valued
features. Also: equal plans under an injected ``CostModel``, the
executor's hit/miss counters and compiled-plan count, a query bit-identical
alone and padded into a batch of 8, ``save``/``load`` without a probe, and
``device=None`` raising without a card."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from repro.api import Engine as JEngine, SearchParams as JParams  # noqa: E402
from repro.api import planner as jplanner, query as jquery  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro_torch.api import Engine as TEngine, SearchParams as TParams  # noqa: E402
from repro_torch.api import planner as tplanner, query as tquery  # noqa: E402
from repro_torch.core import routing as troute  # noqa: E402
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
