"""Quantized search of the port against the reference over one graph and
one codec store.

The reference builds the HELP graph on integer-valued features and a store
for every codec whose state is integer-valued: sq8 with scale 1 and zero
−128 (so a code decodes to the feature itself), PQ codebooks with rounded
centroids, and a permutation as the OPQ rotation. Every table entry and
every sum is then an exact integer, so graph and brute searches must match
the reference exactly (ids, sqdists, ``n_dist_evals``, ``n_code_evals``,
``n_hops``) for all five codecs and all four predicate classes. The port
gets the store through ``quant_from_numpy``; both packages read each
other's saved stores. On float data with a trained store, recall@10 must
sit within 0.005 of the reference's. The executor's widening and the
planner's probe are held to the reference's on the quantized index."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from repro import quant as jq  # noqa: E402
from repro.api import Engine as JEngine, SearchParams as JParams  # noqa: E402
from repro.api import planner as jplanner, query as jquery  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro.core.index import StableIndex as JIndex  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.api import Engine as TEngine, SearchParams as TParams  # noqa: E402
from repro_torch.api import planner as tplanner, query as tquery  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core.help_graph import HelpConfig as THelp  # noqa: E402
from repro_torch.core.index import StableIndex as TIndex, index_from_numpy  # noqa: E402

MODES = ("sq8", "pq", "pq4", "opq-pq", "opq-pq4")
CLASSES = ("match", "subset", "one_of", "between")
S = 16  # subspaces of the test stores (M = 128 → 8 dims each)


def integer_store(mode: str, f: np.ndarray) -> "jq.QuantizedVectors":
    """A reference store whose codec state is integer-valued."""
    m = f.shape[1]
    cfg = jq.QuantConfig(mode=mode, pq_subspaces=S, pq_train_iters=3)
    x = jnp.asarray(f)
    if mode == "sq8":
        params = jq.SQParams(scale=jnp.ones((m,), jnp.float32),
                             zero=jnp.full((m,), -128.0, jnp.float32))
        return jq.QuantizedVectors(cfg=cfg, codes=jq.sq8_encode(x, params)[0], sq_params=params)
    rotation = None
    if jq.has_rotation(mode):
        perm = np.random.default_rng(0).permutation(m)
        rotation = jnp.asarray(np.eye(m, dtype=np.float32)[perm])
        x = jq.rotate(x, rotation)
    cb = jq.pq_train(x, n_subspaces=S, n_centroids=cfg.effective_centroids, n_iters=3)
    cb = jq.PQCodebook(centroids=jnp.round(cb.centroids), dim=cb.dim)
    codes = jq.pq_encode(x, cb)
    if jq.is_packed_mode(mode):
        codes = jq.pack_nibbles(codes)
    return jq.QuantizedVectors(cfg=cfg, codes=codes, codebook=cb, rotation=rotation)


def to_port(jstore, device="cpu"):
    """The reference store handed over as numpy (``quant_from_numpy``)."""
    meta = {"cfg": dataclasses.asdict(jstore.cfg),
            "dim": jstore.codebook.dim if jstore.codebook else None,
            "codec": jq.codec_spec(jstore.cfg)}
    arrays = {"codes": np.asarray(jstore.codes)}
    if jstore.sq_params is not None:
        arrays.update(sq_scale=np.asarray(jstore.sq_params.scale),
                      sq_zero=np.asarray(jstore.sq_params.zero))
    if jstore.codebook is not None:
        arrays["centroids"] = np.asarray(jstore.codebook.centroids)
    if jstore.rotation is not None:
        arrays["rotation"] = np.asarray(jstore.rotation)
    return tq.quant_from_numpy(meta, arrays, device)


def port_index(jidx, quant):
    return index_from_numpy(
        np.asarray(jidx.features), np.asarray(jidx.attrs), np.asarray(jidx.graph),
        dataclasses.asdict(jidx.metric_cfg), dataclasses.asdict(jidx.help_cfg),
        dataclasses.asdict(jidx.stats), device="cpu", quant=quant,
    )


def assert_same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.ids), tres.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jres.sqdists), tres.sqdists.numpy())
    np.testing.assert_array_equal(np.asarray(jres.n_dist_evals), tres.n_dist_evals.numpy())
    np.testing.assert_array_equal(np.asarray(jres.n_code_evals), tres.n_code_evals.numpy())
    assert int(jres.n_hops) == int(tres.n_hops)


@pytest.fixture(scope="module")
def int_case():
    f, a, qf, qa = dataset(n=2048, n_queries=16, integer=True, seed=7)
    jidx = JIndex.build(f, a, JHelp(**HELP_KW))
    engines = {}
    for mode in MODES:
        jstore = integer_store(mode, f)
        jq_idx = dataclasses.replace(jidx, quant=jstore)
        engines[mode] = (JEngine(jq_idx), TEngine(port_index(jidx, to_port(jstore))))
    return engines, predicate_batches(qf, qa, jquery), predicate_batches(qf, qa, tquery)


@pytest.mark.parametrize("backend", ["graph", "brute"])
@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("mode", MODES)
def test_exact_parity_on_integer_codebooks(int_case, mode, cls, backend):
    engines, jb, tb = int_case
    jeng, teng = engines[mode]
    kw = dict(k=10, backend=backend)
    jplan, tplan = jeng.plan(jb[cls], JParams(**kw)), teng.plan(tb[cls], TParams(**kw))
    assert tplan.quant_mode == jplan.quant_mode
    assert tplan.quant_mode == ("none" if (mode, backend) == ("sq8", "brute") else mode)
    assert_same(jeng.search(jb[cls], JParams(**kw)), teng.search(tb[cls], TParams(**kw)))


@pytest.mark.parametrize("mode", ["sq8", "pq4"])
def test_quantized_one_of_widens_to_the_rerank_head(int_case, mode):
    """ONE_OF post-filtering widens the traversal cut to ``rerank_size``
    on a quantized plan (not to the pool), as the reference does."""
    engines, jb, tb = int_case
    jeng, teng = engines[mode]
    kw = dict(k=10, pool_size=40, rerank_size=16, backend="graph")
    for cls in ("one_of", "match"):
        jres, tres = jeng.search(jb[cls], JParams(**kw)), teng.search(tb[cls], TParams(**kw))
        assert_same(jres, tres)
        assert int(tres.n_dist_evals.max()) <= 16
    sig = teng.executor.signature(tb["one_of"], TParams(**kw), teng.plan(tb["one_of"], TParams(**kw)))
    assert sig.quant_mode == mode and sig.rerank == 16


def test_forced_exact_and_bad_codec_params(int_case):
    engines, jb, tb = int_case
    jeng, teng = engines["pq"]
    kw = dict(k=10, backend="graph", quant="none")
    assert teng.plan(tb["match"], TParams(**kw)).quant_mode == "none"
    assert_same(jeng.search(jb["match"], JParams(**kw)), teng.search(tb["match"], TParams(**kw)))
    with pytest.raises(ValueError):  # the index holds pq codes
        teng.search(tb["match"], TParams(quant="pq4", backend="graph"))
    with pytest.raises(ValueError):  # no sq8 scan on the brute backend
        engines["sq8"][1].search(tb["match"], TParams(quant="sq8", backend="brute"))


@pytest.mark.parametrize("mode", ["pq4", "sq8"])
def test_planner_probe_on_quantized_index(int_case, mode):
    """The probe routes over codes and fits on code evals: its counts are
    the reference's; plans under one injected model are equal, codec terms
    included."""
    engines, jb, tb = int_case
    jeng, teng = engines[mode]
    jm = jplanner.calibrate(jeng.index, time_probe=False)
    tm = tplanner.calibrate(teng.index, time_probe=False)
    assert (tm.unit_evals, tm.pool_intercept, tm.probe_pool) == \
        (jm.unit_evals, jm.pool_intercept, jm.probe_pool)
    table = dict(unit_evals=3.0, probe_pool=32, probe_n=2048, brute_eval_cost=0.7,
                 batch_overhead=40.0, pool_intercept=5.0)
    jx = JEngine(jeng.index, cost_model_override=jplanner.cost_model_from_table(table))
    tx = TEngine(teng.index, cost_model_override=tplanner.cost_model_from_table(table))
    for cls in CLASSES:
        for params in ({}, {"quant": "none"}, {"rerank_size": 12}, {"pool_size": 300}):
            jp, tp = jx.plan(jb[cls], JParams(**params)), tx.plan(tb[cls], TParams(**params))
            assert (jp.backend, jp.quant_mode, jp.reason) == (tp.backend, tp.quant_mode, tp.reason)
            assert (jp.cost_brute, jp.cost_graph) == (tp.cost_brute, tp.cost_graph)


@pytest.mark.parametrize("mode", MODES)
def test_stores_cross_between_packages(int_case, mode, tmp_path):
    engines, jb, tb = int_case
    jeng, teng = engines[mode]
    jidx = jeng.index
    q = jb["subset"]
    jres = jidx.search(q.vectors, q.attrs, k=10, mask=q.mask)
    # reference → port
    jidx.save(str(tmp_path / "ref"))
    tidx = TIndex.load(str(tmp_path / "ref"), device="cpu", mmap=True)
    assert tidx.quant.cfg == tq.QuantConfig(**dataclasses.asdict(jidx.quant.cfg))
    np.testing.assert_array_equal(tidx.quant.codes.numpy(), np.asarray(jidx.quant.codes))
    assert tidx.quant.codes.dtype == (torch.int8 if mode == "sq8" else torch.uint8)
    assert_same(jres, tidx.search(q.vectors, q.attrs, k=10, mask=q.mask))
    # port → reference
    teng.index.save(str(tmp_path / "port"))
    back = JIndex.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.quant.codes), teng.index.quant.codes.numpy())
    for name in ("codebook", "rotation", "sq_params"):
        mine, theirs = getattr(teng.index.quant, name), getattr(back.quant, name)
        assert (mine is None) == (theirs is None)
    if back.quant.codebook is not None:
        np.testing.assert_array_equal(np.asarray(back.quant.codebook.centroids),
                                      teng.index.quant.codebook.centroids.numpy())
        assert back.quant.codebook.dim == teng.index.quant.codebook.dim
    if back.quant.rotation is not None:
        np.testing.assert_array_equal(np.asarray(back.quant.rotation),
                                      teng.index.quant.rotation.numpy())
    assert_same(back.search(q.vectors, q.attrs, k=10, mask=q.mask),
                teng.index.search(q.vectors, q.attrs, k=10, mask=q.mask))


@pytest.mark.parametrize("mode", MODES)
def test_every_codec_builds_and_searches_on_the_cpu(mode):
    f, a, qf, qa = dataset(n=600, n_queries=6, integer=False, seed=2)
    eng = TEngine.build(f, a, help_cfg=THelp(**HELP_KW),
                        quant_cfg=tq.QuantConfig(mode, pq_subspaces=8, pq_train_iters=3),
                        device="cpu")
    assert eng.quant_mode == mode
    for backend in ("graph", "brute"):
        res = eng.search(tquery.QueryBatch.match(qf, qa), TParams(k=10, backend=backend))
        assert tuple(res.ids.shape) == (6, 10)
        assert bool(torch.isfinite(res.sqdists).all()) and bool((res.ids >= -1).all())


@functools.lru_cache(maxsize=None)
def float_case(mode: str):
    """A reference index with a trained ``mode`` store on float data, and
    the port's index over the same graph and store."""
    f, a, qf, qa = dataset(n=2048, n_queries=32, integer=False, seed=5)
    jidx = JIndex.build(f, a, JHelp(**HELP_KW), quant_cfg=jq.QuantConfig(mode, pq_subspaces=32))
    return f, a, qf, qa, jidx, port_index(jidx, to_port(jidx.quant))


@pytest.mark.parametrize("mode", ["pq", "pq4"])
def test_float_recall_within_half_a_point(mode):
    """A trained reference store on float data, searched by both packages:
    recall@10 against each package's exact oracle within 0.005."""
    f, a, qf, qa, jidx, tidx = float_case(mode)
    jeng, teng = JEngine(jidx), TEngine(tidx)
    jo = jbase.brute_force_hybrid(jidx.features, jidx.attrs, jnp.asarray(qf), jnp.asarray(qa), 10)
    to = tbase.brute_force_hybrid(tidx.features, tidx.attrs, qf, qa, 10)
    for backend in ("graph", "brute"):
        jres = jeng.search(jquery.QueryBatch.match(qf, qa), JParams(k=10, backend=backend))
        tres = teng.search(tquery.QueryBatch.match(qf, qa), TParams(k=10, backend=backend))
        j_recall = jbase.recall_at_k(jres.ids, jo.ids, 10)
        t_recall = tbase.recall_at_k(tres.ids, to.ids, 10)
        assert abs(j_recall - t_recall) <= 0.005, (backend, j_recall, t_recall)
        assert t_recall > 0.5


@pytest.mark.parametrize("mode", ["pq", "pq4"])
def test_float_brute_one_of_recall_within_half_a_point(mode):
    """Brute ONE_OF over a trained store on float data: the port's recall@10
    against its exact brute search sits within 0.005 of the reference's
    against its own. The 4-bit codecs' lower ONE_OF recall at N = 1M on the
    card is the codec's, not the port's."""
    f, a, qf, qa, jidx, tidx = float_case(mode)
    jb = predicate_batches(qf, qa, jquery)["one_of"]
    tb = predicate_batches(qf, qa, tquery)["one_of"]
    jo = JEngine(dataclasses.replace(jidx, quant=None)).search(jb, JParams(k=10, backend="brute"))
    to = TEngine(port_index(jidx, None)).search(tb, TParams(k=10, backend="brute"))
    jres = JEngine(jidx).search(jb, JParams(k=10, backend="brute"))
    tres = TEngine(tidx).search(tb, TParams(k=10, backend="brute"))
    j_recall = jbase.recall_at_k(jres.ids, jo.ids, 10)
    t_recall = tbase.recall_at_k(tres.ids, to.ids, 10)
    assert abs(j_recall - t_recall) <= 0.005, (j_recall, t_recall)
