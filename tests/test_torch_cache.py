"""The port's hot/cold tiering (``repro_torch.cache``: ``FrequencyTracker``,
``HotTier``, ``TieredEngine``; ``routing.search_pool`` /
``rerank_gathered``; the ``tier`` provider of ``ServerStats``; the
launcher's ``--hot-rows``) and the public-surface repairs that came with
it (``core.baselines.pre_filter_search`` / ``post_filter_search``,
``fused_auto_topk``, the ``repro_torch.kernels`` exports), each against
the reference.

One HELP graph is built by the port on integer-valued features (n =
2,000) and handed to the reference as arrays, with integer-valued codec
stores (``test_torch_mutable.integer_store``), so both packages search the
same index and every score is exact.

Tolerances: a ``TieredEngine`` equals the port's untiered engine bit for
bit (ids, dists, sqdists) in every tier state; against the reference's
``TieredEngine`` ids are equal except at near-ties (|Δd| ≤ 2·(1e-6 +
1e-5·|d|)) and sqdists agree within rtol 1e-5. The tracker and the tier
match the reference's exactly.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from test_torch_mutable import assert_results_alike, integer_store, to_port  # noqa: E402
from repro import api as japi, cache as jcache  # noqa: E402
from repro.api import query as jquery  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core.auto import MetricConfig as JMetric  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro.kernels import fused_auto_topk as j_fused_auto_topk  # noqa: E402
from repro_torch import api as tapi, cache as tcache, mutable as tmut, serve as tserve  # noqa: E402
from repro_torch.api import query as tquery  # noqa: E402
from repro_torch.core import baselines as tbase, help_graph as thelp, routing as trouting  # noqa: E402
from repro_torch.core.auto import MetricConfig as TMetric  # noqa: E402
from repro_torch.core.help_graph import HelpConfig as THelp  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.quant import QuantConfig as TQuant  # noqa: E402

N, NQ, K, POOL = 2000, 16, 10, 32
CODECS = ("none", "sq8", "pq", "pq4")
KINDS = ("match", "one_of", "between")
HOT = 256


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """(features, attrs, query features, query attrs) on integers."""
    return dataset(n=N, n_queries=NQ, integer=True, seed=5)


@pytest.fixture(scope="module")
def base(data):
    """codec → (reference StableIndex, port StableIndex) over one graph,
    built by the port and handed to the reference as arrays."""
    f, a, _, _ = data
    built = tapi.Engine.build(f, a, THelp(**HELP_KW), device="cpu").index
    from repro.core.auto import DatasetStats as JStats
    from repro.core.index import StableIndex as JIndex

    jidx = JIndex(
        features=jnp.asarray(f), attrs=jnp.asarray(a), graph=jnp.asarray(built.graph.numpy()),
        metric_cfg=JMetric(**dataclasses.asdict(built.metric_cfg)),
        help_cfg=JHelp(**HELP_KW), stats=JStats(**dataclasses.asdict(built.stats)),
    )
    out = {"none": (jidx, to_port(jidx))}
    for mode in CODECS[1:]:
        jq_idx = dataclasses.replace(jidx, quant=integer_store(mode, f))
        out[mode] = (jq_idx, to_port(jq_idx))
    return out


@pytest.fixture(scope="module")
def batches(data):
    _, _, qf, qa = data
    jb, tb = predicate_batches(qf, qa, jquery), predicate_batches(qf, qa, tquery)
    return {k: jb[k] for k in KINDS}, {k: tb[k] for k in KINDS}


def params(mod, backend):
    return mod.SearchParams(k=K, pool_size=POOL, pioneer_size=8, backend=backend)


def assert_bit_equal(res, ref, ctx=""):
    for field in ("ids", "dists", "sqdists"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), f"{ctx}: {field}"


def churn(tiered):
    """Skew the tracker to a disjoint id range and re-promote."""
    tiered.tracker.observe(np.tile(np.arange(1000, 1400), 5))
    tiered.refresh_tier()


# ---------------------------------------------------------------------------
# FrequencyTracker
# ---------------------------------------------------------------------------


STREAMS = {
    "filters": ([np.array([[0, 3, 3], [-1, 12, 9]])], 10, 0.5),
    "decay": ([[1, 1, 2], "epoch", [2]], 4, 0.5),
    "no_decay": ([[0, 0, 1], "epoch", [3, 3, 3], "epoch"], 4, 1.0),
    "forget": ([[0, 1, 2, 3], "epoch", "epoch", [1]], 4, 0.0),
    "random": ([np.random.default_rng(0).integers(-5, 60, size=(8, 10)), "epoch",
                np.random.default_rng(1).integers(0, 50, size=300)], 50, 0.25),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_tracker_matches_reference(case):
    steps, n, decay = STREAMS[case]
    j, t = jcache.FrequencyTracker(n, decay=decay), tcache.FrequencyTracker(n, decay=decay)
    for step in steps:
        if isinstance(step, str):
            j.end_epoch()
            t.end_epoch()
        else:
            assert t.observe(step) == j.observe(step)
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())
    assert t.stats() == j.stats()


def test_tracker_snapshot_is_a_copy():
    tr = tcache.FrequencyTracker(4)
    snap = tr.snapshot()
    tr.observe([0])
    assert snap[0] == 0.0 and tr.counts[0] == 1.0


@pytest.mark.parametrize("kw", [dict(n_rows=0), dict(n_rows=4, decay=1.5),
                                dict(n_rows=4, decay=-0.1)])
def test_tracker_validation(kw):
    with pytest.raises(ValueError):
        tcache.FrequencyTracker(**kw)
    with pytest.raises(ValueError):
        jcache.FrequencyTracker(**kw)


# ---------------------------------------------------------------------------
# HotTier
# ---------------------------------------------------------------------------


def feats(n=32, m=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)


PROMOTIONS = {
    # (budget, hysteresis, [counts per promote])
    "zero_frequency": (16, 1.5, [{3: 1.0, 7: 1.0}]),
    "hysteresis_holds": (2, 2.0, [{1: 10.0, 2: 10.0}, {1: 10.0, 2: 10.0, 5: 15.0}]),
    "hysteresis_yields": (2, 2.0, [{1: 10.0, 2: 10.0}, {1: 10.0, 2: 10.0, 5: 25.0}]),
    "ties_to_lower_id": (3, 1.0, [{9: 2.0, 4: 2.0, 30: 2.0, 11: 2.0, 0: 1.0}]),
    "budget_clamps": (100, 1.5, [{i: 1.0 for i in range(32)}]),
    "churn": (8, 1.5, [{i: float(i) for i in range(16)}, {i: 40.0 - i for i in range(16, 32)},
                       {}]),
}


def counts_of(d, n=32):
    c = np.zeros(n)
    for i, v in d.items():
        c[i] = v
    return c


@pytest.mark.parametrize("case", sorted(PROMOTIONS))
def test_tier_promotion_matches_reference(case):
    budget, hyst, rounds = PROMOTIONS[case]
    x = feats()
    j = jcache.HotTier(x, hot_rows=budget, hysteresis=hyst)
    t = tcache.HotTier(x, hot_rows=budget, hysteresis=hyst, device="cpu")
    assert t.hot_rows == j.hot_rows
    for r in rounds:
        j.promote(counts_of(r))
        t.promote(counts_of(r))
        np.testing.assert_array_equal(t.hot_ids, j.hot_ids)
        np.testing.assert_array_equal(t.slot_of, j.slot_of)
        if t.hot_features is None:
            assert j.hot_features is None
        else:
            np.testing.assert_array_equal(t.hot_features.numpy(), np.asarray(j.hot_features))
    st, sj = t.stats(), j.stats()
    assert st == sj and t.hot_bytes == j.hot_bytes


@pytest.mark.parametrize("state", ["cold", "mixed", "all_hot"])
def test_tier_gather_equals_direct_take(state):
    """Cold, mixed and all-hot gathers all return the exact source rows;
    INVALID clamps to row 0 as ``gather_rows`` does; the counters split
    as the reference's."""
    x = feats()
    ids = {"cold": np.array([[0, 5, -1], [31, 8, 2]]), "mixed": np.array([[0, 5, -1], [31, 8, 2]]),
           "all_hot": np.array([[0, 5], [8, 31]])}[state]
    j = jcache.HotTier(x, hot_rows=8)
    t = tcache.HotTier(x, hot_rows=8, device="cpu")
    if state != "cold":
        c = counts_of({0: 10.0, 5: 10.0, 8: 10.0, 31: 10.0})
        j.promote(c)
        t.promote(c)
    got = t.gather(ids)
    assert got.dtype == torch.float32 and tuple(got.shape) == ids.shape + (4,)
    np.testing.assert_array_equal(got.numpy(), x[np.maximum(ids, 0)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.gather(ids)))
    assert t.stats() == j.stats()
    if state == "mixed":
        assert t.stats()["hot_row_hits"] > 0 and t.stats()["cold_row_gathers"] > 0


def test_tier_reset_counters_and_empty_budget():
    t = tcache.HotTier(feats(), hot_rows=0, device="cpu")
    t.promote(np.ones(32))  # a zero budget never promotes
    assert t.hot_ids.size == 0 and t.stats()["epochs"] == 0
    t.gather(np.array([[1, 2]]))
    assert t.stats()["cold_row_gathers"] == 2
    t.reset_counters()
    assert t.stats()["cold_row_gathers"] == 0 and t.stats()["tier_hit_rate"] == 0.0


@pytest.mark.parametrize("kw", [dict(hot_rows=-1), dict(hot_rows=4, hysteresis=0.5)])
def test_tier_validation(kw):
    with pytest.raises(ValueError):
        tcache.HotTier(feats(), device="cpu", **kw)
    with pytest.raises(ValueError):
        jcache.HotTier(feats(), **kw)


# ---------------------------------------------------------------------------
# routing.search_pool / rerank_gathered
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS[1:])
@pytest.mark.parametrize("enforce", [False, True])
def test_search_pool_then_rerank_equals_search(base, data, codec, enforce):
    """Stages 1–3 plus a rerank of ``idx.features[r_ids]`` rows gathered
    outside equal ``routing.search`` bit for bit, and the pool head equals
    the reference's ``search_pool``."""
    _, _, qf, qa = data
    jidx, tidx = base[codec]
    cfg = trouting.RoutingConfig(k=K, pool_size=POOL, quant_mode=codec, enforce_equality=enforce,
                                 rerank_size=24)
    qv, qa_t = torch.from_numpy(qf), torch.from_numpy(qa)
    entry = trouting.make_entry_ids(N, NQ, POOL, 0, device="cpu")
    r_ids, evals, hops = trouting.search_pool(
        tidx.attrs, tidx.graph, qv, qa_t, entry, tidx.metric_cfg, cfg, N, None,
        tidx.quant.routing_operand(qv),
    )
    assert tuple(r_ids.shape) == (NQ, 24)
    cv = tidx.features[r_ids.clamp_min(0).long()]
    got = trouting.rerank_gathered(cv, tidx.attrs, r_ids, qv, qa_t, tidx.metric_cfg, cfg,
                                   None, evals, hops)
    want = trouting.search(tidx.features, tidx.attrs, tidx.graph, qv, qa_t, tidx.metric_cfg, cfg,
                           quant=tidx.quant)
    for field in want._fields:
        assert torch.equal(torch.as_tensor(getattr(got, field)),
                           torch.as_tensor(getattr(want, field))), field
    from repro.core import routing as jrouting

    jcfg = jrouting.RoutingConfig(**dataclasses.asdict(cfg))
    jr, je, _ = jrouting.search_pool(
        jidx.attrs, jidx.graph, jnp.asarray(qf), jnp.asarray(qa), jnp.asarray(entry.numpy()),
        jidx.metric_cfg, jcfg, N, None, jidx.quant.routing_operand(jnp.asarray(qf)),
    )
    np.testing.assert_array_equal(r_ids.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(evals.numpy(), np.asarray(je))


def test_search_pool_rejects_exact_codec(base):
    _, tidx = base["none"]
    with pytest.raises(ValueError, match="quantized"):
        trouting.search_pool(tidx.attrs, tidx.graph, torch.zeros(1, 128), torch.zeros(1, 5),
                             torch.zeros(1, POOL, dtype=torch.int32), tidx.metric_cfg,
                             trouting.RoutingConfig(k=K, pool_size=POOL), N)


def test_staged_operands_keep_invalid():
    cv = torch.arange(24, dtype=torch.float32).view(2, 3, 4)
    r_ids = torch.tensor([[5, -1, 0], [2, 1, -1]], dtype=torch.int32)
    attrs = torch.arange(14, dtype=torch.int32).view(7, 2)
    v, a, ids = trouting.staged_operands(cv, attrs, r_ids)
    assert torch.equal(v, cv.view(6, 4))
    assert torch.equal(a, attrs[r_ids.clamp_min(0).long()].view(6, 2))
    assert ids.tolist() == [[0, -1, 2], [3, 4, -1]]


# ---------------------------------------------------------------------------
# TieredEngine: bit-identical to the untiered engine, alike to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["graph", "brute"])
@pytest.mark.parametrize("codec", CODECS)
def test_every_tier_state_matches_untiered_and_reference(base, batches, codec, backend):
    """Cold tier (nothing promoted), warm tier (hot set resident) and a
    churned tier (promotions and demotions applied) serve ids, dists and
    sqdists bit-identical to the port's untiered engine for every predicate
    kind, and alike to the reference's TieredEngine in the same state."""
    jidx, tidx = base[codec]
    jb, tb = batches
    tp, jp = params(tapi, backend), params(japi, backend)
    untiered = tapi.Engine(tidx)
    refs = {kind: untiered.search(tb[kind], tp) for kind in KINDS}
    tiered = tcache.TieredEngine(tapi.Engine(tidx), hot_rows=HOT, epoch_queries=NQ)
    jtiered = jcache.TieredEngine(japi.Engine(jidx), hot_rows=HOT, epoch_queries=NQ)
    for state in ("cold", "warm", "churned"):
        if state == "churned":
            churn(tiered)
            churn(jtiered)
            assert tiered.tier.stats()["epochs"] >= 2 and tiered.tier.stats()["demotions"] > 0
        for kind in KINDS:
            got = tiered.search(tb[kind], tp)
            assert_bit_equal(got, refs[kind], f"{codec}/{backend}/{kind}/{state}")
            jres = jtiered.search(jb[kind], jp)
            assert_results_alike(jres.ids, jres.sqdists, got.ids.numpy(), got.sqdists.numpy())
        np.testing.assert_array_equal(tiered.tier.hot_ids, jtiered.tier.hot_ids)
    st, sj = tiered.tier_stats(), jtiered.tier_stats()
    for key in ("hot_row_hits", "cold_row_gathers", "promotions", "demotions", "epochs",
                "hot_rows_resident"):
        assert st[key] == sj[key], key
    # a quantized plan reranks through the tier; an exact one passes through
    reranks = tiered.quant_mode != "none" and not (backend == "brute" and codec == "sq8")
    assert (st["hot_row_hits"] + st["cold_row_gathers"] > 0) == reranks


def test_feedback_loop_promotes_result_rows(base, batches):
    """Rows the engine returns become the hot set; the warm pass then
    resolves most rerank gathers on the device."""
    tiered = tcache.TieredEngine(tapi.Engine(base["pq"][1]), hot_rows=512, epoch_queries=NQ)
    qb = batches[1]["match"]
    p = params(tapi, "graph")
    tiered.search(qb, p)  # NQ queries → epoch boundary → promote
    assert tiered.tier.hot_ids.size > 0
    tiered.tier.reset_counters()
    tiered.search(qb, p)
    st = tiered.tier_stats()
    assert st["hot_row_hits"] > 0 and st["tier_hit_rate"] > 0.2


def test_own_executor_resolves_tiered_searchers(base, batches):
    """The base engine's executor is untouched; the tiered engine's own one
    compiles closures over the tiered searchers (hot hits after a
    promotion prove the tier is on the path)."""
    base_eng = tapi.Engine(base["pq4"][1])
    tiered = tcache.TieredEngine(base_eng, hot_rows=HOT, epoch_queries=NQ)
    assert tiered.executor is not base_eng.executor
    assert tiered.searcher("graph") is not base_eng.searcher("graph")
    tiered.search(batches[1]["match"], params(tapi, "brute"))
    tiered.search(batches[1]["match"], params(tapi, "brute"))
    assert base_eng.executor.stats()["misses"] == 0
    assert tiered.tier.stats()["hot_row_hits"] > 0


def test_trace_span_carries_the_tier_split(base, batches):
    from repro_torch.obs import Tracer

    tiered = tcache.TieredEngine(tapi.Engine(base["pq"][1]), hot_rows=HOT, epoch_queries=NQ)
    p = params(tapi, "graph")
    tiered.search(batches[1]["match"], p)  # promote
    tracer = Tracer(sample_every=1)
    tr = tracer.start("request")
    with tr.root as root:
        tiered.search(batches[1]["match"], p)
    assert root.find("execute") is not None
    assert root.attrs["tier_hot_hits"] + root.attrs["tier_cold_gathers"] == NQ * POOL
    assert root.attrs["tier_hot_hits"] > 0


@pytest.mark.parametrize("wrap", ["mutable_in_tiered", "tiered_in_mutable", "epoch_zero"])
def test_constructor_guards(base, wrap):
    eng = tapi.Engine(base["none"][1])
    if wrap == "mutable_in_tiered":
        with pytest.raises(TypeError):
            tcache.TieredEngine(tmut.MutableEngine(eng), hot_rows=64)
    elif wrap == "tiered_in_mutable":
        with pytest.raises(TypeError):
            tmut.MutableEngine(tcache.TieredEngine(eng, hot_rows=64))
    else:
        with pytest.raises(ValueError):
            tcache.TieredEngine(eng, hot_rows=64, epoch_queries=0)


# ---------------------------------------------------------------------------
# partitioned engines: partition-granular pinning
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capped(data, tmp_path_factory):
    """The port's partitioned pq engine (P = 5), saved and loaded under a
    cap of 1,024 resident rows."""
    f, a, _, _ = data
    path = str(tmp_path_factory.mktemp("part_idx"))
    tapi.Engine.build_partitioned(
        f, a, n_partitions=5, help_cfg=THelp(gamma=6, gamma_new=3, max_rounds=2), device="cpu",
        quant_cfg=TQuant(mode="pq", pq_subspaces=8, pq_train_iters=4),
    ).save(path)
    return path


@pytest.mark.parametrize("sub", ["brute", "graph"])
def test_pinned_serving_bit_identical(capped, batches, sub):
    eng = tapi.Engine.load(capped, device="cpu", residency_rows=1024)
    qb = batches[1]["match"]
    p = tapi.SearchParams(k=K, pool_size=POOL, pioneer_size=8, nprobe=3, sub_backend=sub)
    ref = eng.search(qb, p)
    tiered = tcache.TieredEngine(eng, hot_rows=768, epoch_queries=NQ)
    assert tiered.tier is None
    assert_bit_equal(tiered.search(qb, p), ref, "cold")
    assert len(eng.index.store.pinned_ids()) >= 1
    assert_bit_equal(tiered.search(qb, p), ref, "pinned")
    st = tiered.tier_stats()
    assert st["pinned_partitions"] >= 1
    assert st["pinned_rows"] <= eng.index.store.cap_rows
    assert st["tier_hit_rate"] > 0  # pinned partitions turn loads into hits


def test_pins_match_reference_and_survive_lru_pressure(capped, batches):
    """The port pins the partitions the reference's rule picks from the
    same counts, and the pins stay resident while every partition cycles
    through the cap."""
    eng = tapi.Engine.load(capped, device="cpu", residency_rows=1024)
    jeng = japi.Engine.load(capped, residency_rows=1024)
    tiered = tcache.TieredEngine(eng, hot_rows=768, epoch_queries=NQ)
    jtiered = jcache.TieredEngine(jeng, hot_rows=768, epoch_queries=NQ)
    counts = np.zeros(N)
    counts[np.random.default_rng(2).integers(0, N, 400)] = 1.0
    tiered._pin_partitions(counts)
    jtiered._pin_partitions(counts)
    np.testing.assert_array_equal(tiered._row_to_pid(), jtiered._row_to_pid())
    store = eng.index.store
    pinned = store.pinned_ids()
    assert pinned and pinned == jeng.index.store.pinned_ids()
    for pid in range(eng.index.n_partitions):
        store.get(pid)
    assert set(pinned) <= set(store.resident_ids())
    store.unpin()
    assert store.pinned_ids() == []


# ---------------------------------------------------------------------------
# serving: ServerStats, serve_loop with a ResultCache, the launcher
# ---------------------------------------------------------------------------


def test_tiered_engine_through_serve_loop(base, data):
    """Tiering and the result cache compose: the served stream equals the
    untiered, uncached stream bit for bit, and both layers report activity
    (``ServerStats`` carries the ``tier`` key and provider)."""
    _, _, qf, qa = data
    eng = tapi.Engine(base["pq"][1])
    p = params(tapi, "graph")

    def reg():
        return tserve.TenantRegistry(default_policy=tserve.TenantPolicy(params=p))

    trace = [(i * 1e-3, tserve.Request("a", tquery.Query(
        qf[i % 8], [tquery.MATCH(int(v)) for v in qa[i % 8]]))) for i in range(48)]
    ref, _ = tserve.serve_loop(eng, trace, reg(), window_ms=1.0, buckets=(1, 8))
    tiered = tcache.TieredEngine(eng, hot_rows=HOT, epoch_queries=16)
    # a warm pass without the cache, so the tier promotes (with the cache
    # on, repeats never reach the engine)
    tserve.serve_loop(tiered, trace, reg(), window_ms=1.0, buckets=(1, 8))
    tiered.tier.reset_counters()
    stats = tserve.ServerStats(tiered)
    resp, stats = tserve.serve_loop(tiered, trace, reg(), window_ms=1.0, buckets=(1, 8),
                                    stats=stats, result_cache=tcache.ResultCache())
    for a, b in zip(ref, resp):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    snap = stats.snapshot()
    assert snap["result_cache"]["served"] > 0
    assert snap["tier"]["hot_row_hits"] > 0
    providers = stats.registry.snapshot()["providers"]
    assert providers["tier_hot_row_hits"] == snap["tier"]["hot_row_hits"]


def test_stats_without_a_tier_have_no_tier_key(base):
    stats = tserve.ServerStats(tapi.Engine(base["none"][1]))
    assert "tier" not in stats.snapshot()
    assert not any(k.startswith("tier_") for k in stats.registry.snapshot()["providers"])


@pytest.mark.parametrize("writes", [0, 64])
def test_cli_hot_rows(capsys, writes):
    argv = ["--device", "cpu", "--n", "1500", "--requests", "64", "--quant", "pq",
            "--pq-subspaces", "8", "--hot-rows", "256", "--buckets", "1,8,32"]
    tlaunch.main(argv + (["--writes", str(writes)] if writes else []))
    out = capsys.readouterr().out
    assert "[served] 64/64 completed" in out
    if writes:
        assert "--hot-rows is incompatible with --writes; serving untiered" in out
        assert "  tier:" not in out
    else:
        line = next(x for x in out.splitlines() if x.startswith("  tier:"))
        assert "hot budget 256 rows" in line


# ---------------------------------------------------------------------------
# repairs: baselines, fused_auto_topk, the kernels package's exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_pre_filter_search_matches_reference(data, masked):
    f, a, qf, qa = data
    mask = np.tile(np.array([[1, 0, 1, 1, 0]], np.int32), (NQ, 1)) if masked else None
    j = jbase.pre_filter_search(jnp.asarray(f), jnp.asarray(a), qf, qa, K, mask)
    t = tbase.pre_filter_search(torch.from_numpy(f), torch.from_numpy(a), qf, qa, K, mask)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.sqdists.numpy(), np.asarray(j.sqdists))
    np.testing.assert_array_equal(t.n_dist_evals.numpy(), np.asarray(j.n_dist_evals))


@pytest.fixture(scope="module")
def l2_graph(data):
    f, a, _, _ = data
    g, _, _ = thelp.build_help_graph(torch.from_numpy(f), torch.from_numpy(a),
                                     TMetric(mode="l2"), THelp(**HELP_KW))
    return g


@pytest.mark.parametrize("k_prime", [16, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_post_filter_search_matches_reference(data, l2_graph, k_prime, masked):
    f, a, qf, qa = data
    mask = np.tile(np.array([[1, 1, 0, 1, 0]], np.int32), (NQ, 1)) if masked else None
    j = jbase.post_filter_search(jnp.asarray(f), jnp.asarray(a), jnp.asarray(l2_graph.numpy()),
                                 qf, qa, K, k_prime, mask=mask)
    t = tbase.post_filter_search(torch.from_numpy(f), torch.from_numpy(a), l2_graph, qf, qa, K,
                                 k_prime, mask=mask)
    for field in ("ids", "sqdists", "n_dist_evals", "n_hops"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)


def test_post_filter_keeps_the_lower_rank_on_ties():
    """Every candidate at the same distance: the k kept are the first k
    admissible in the graph search's order, as ``lax.top_k`` keeps them."""
    n = 64
    f = np.zeros((n, 4), np.float32)
    a = (np.arange(n) % 2).astype(np.int32)[:, None]
    graph = np.stack([(np.arange(n) + d) % n for d in range(1, 9)], 1).astype(np.int32)
    qf, qa = np.zeros((2, 4), np.float32), np.array([[0], [1]], np.int32)
    j = jbase.post_filter_search(jnp.asarray(f), jnp.asarray(a), jnp.asarray(graph), qf, qa, 4, 16)
    t = tbase.post_filter_search(torch.from_numpy(f), torch.from_numpy(a), torch.from_numpy(graph),
                                 qf, qa, 4, 16)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    assert (np.asarray(a)[t.ids.numpy()][..., 0] == qa).all()


@pytest.mark.parametrize("mode", ["auto", "l2"])
@pytest.mark.parametrize("ties", [False, True])
def test_fused_auto_topk_matches_reference(data, mode, ties):
    from repro_torch.kernels.fused_auto.ops import fused_auto_topk

    f, a, qf, qa = data
    if ties:  # many rows at one distance: ids must come lowest first
        f = np.repeat(f[:40], 50, axis=0)
        a = np.repeat(a[:40], 50, axis=0)
    j_sq, j_ids = j_fused_auto_topk(jnp.asarray(qf), jnp.asarray(qa), jnp.asarray(f),
                                    jnp.asarray(a), K, alpha=1.5, mode=mode)
    t_sq, t_ids = fused_auto_topk(torch.from_numpy(qf), torch.from_numpy(qa), torch.from_numpy(f),
                                  torch.from_numpy(a), K, alpha=1.5, mode=mode)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_sq.numpy(), np.asarray(j_sq), rtol=1e-6)


def test_kernels_package_exports_the_references_names():
    import repro.kernels as jk
    import repro_torch.kernels as tk

    assert sorted(tk.__all__) == sorted(jk.__all__)
    for name in jk.__all__:
        assert callable(getattr(tk, name))


def test_cache_modules_import_no_jax():
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import sys\nimport repro_torch.cache, repro_torch.kernels, repro_torch.core.baselines\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    done = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=src),
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
