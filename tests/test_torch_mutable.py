"""The port's streaming mutability (``repro_torch.mutable``, the engine
hooks it needs, ``StableIndex.apply_rows``, ``help_graph.link_nodes`` and
the serve layer's write path) against the reference's.

The reference's index is built once on integer-valued features and handed
to the port through ``index_from_numpy`` (codec stores with integer-valued
state through ``quant_from_numpy``), so both packages search, extend and
re-link the same graph and every score is exact. Both packages apply the
same write script; overwrites are integer-valued too.

Tolerances: federated results and delta top-k ids equal except at
near-ties (|Δd| ≤ 2·(1e-6 + 1e-5·|d|)), sqdists within rtol 1e-5, eval
counts equal; ``apply_rows`` and ``link_nodes`` equal bit for bit. The
reference's delta top-k partitions before its stable sort and the port
sorts once, so the two may pick different rows among equal distances at
the k-th place: that is what the tie-aware comparison allows.
"""
import dataclasses
import os
import struct

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from repro import api as japi, mutable as jmut, quant as jq, serve as jserve  # noqa: E402
from repro.api import planner as jplanner, query as jquery  # noqa: E402
from repro.core import help_graph as jhelp  # noqa: E402
from repro.core.auto import DatasetStats as JStats, MetricConfig as JMetric  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro.core.index import StableIndex as JIndex  # noqa: E402
from repro_torch import api as tapi, mutable as tmut, serve as tserve  # noqa: E402
from repro_torch.api import planner as tplanner, query as tquery  # noqa: E402
from repro_torch.core import help_graph as thelp  # noqa: E402
from repro_torch.core.auto import MetricConfig as TMetric  # noqa: E402
from repro_torch.core.baselines import brute_force_hybrid, recall_at_k  # noqa: E402
from repro_torch.core.graph_ops import INVALID  # noqa: E402
from repro_torch.core.help_graph import HelpConfig as THelp  # noqa: E402
from repro_torch.core.index import index_from_numpy  # noqa: E402
from repro_torch.data.synthetic import make_hybrid_dataset  # noqa: E402
from repro_torch.obs import prometheus_text  # noqa: E402
from repro_torch.quant import quant_from_numpy  # noqa: E402

N0 = 900  # rows of the frozen main build; 60 more stream in as writes
S = 16  # subspaces of the integer codec stores
K, POOL = 10, 64
KINDS = ("match", "subset", "one_of", "between")
CODECS = ("none", "sq8", "pq")
NO_MERGE = dict(max_delta_rows=10 ** 9)


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------


def integer_store(mode: str, f: np.ndarray):
    """A reference codec store whose state is integer-valued (sq8 scale 1 /
    zero −128; rounded codebooks; a permutation as the OPQ rotation)."""
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


def to_port(jidx):
    """The reference's index (and codec store) as a port index on the CPU."""
    store = jidx.quant
    quant = None
    if store is not None:
        arrays = {"codes": np.asarray(store.codes)}
        if store.sq_params is not None:
            arrays.update(sq_scale=np.asarray(store.sq_params.scale),
                          sq_zero=np.asarray(store.sq_params.zero))
        if store.codebook is not None:
            arrays["centroids"] = np.asarray(store.codebook.centroids)
        if store.rotation is not None:
            arrays["rotation"] = np.asarray(store.rotation)
        meta = {"cfg": dataclasses.asdict(store.cfg),
                "dim": store.codebook.dim if store.codebook else None,
                "codec": jq.codec_spec(store.cfg)}
        quant = quant_from_numpy(meta, arrays, "cpu")
    return index_from_numpy(
        np.asarray(jidx.features), np.asarray(jidx.attrs), np.asarray(jidx.graph),
        dataclasses.asdict(jidx.metric_cfg), dataclasses.asdict(jidx.help_cfg),
        dataclasses.asdict(jidx.stats), device="cpu", quant=quant,
    )


@pytest.fixture(scope="module")
def data():
    """(features, attrs, query features, query attrs) on integers."""
    return dataset(n=N0 + 60, n_queries=16, integer=True, seed=11)


@pytest.fixture(scope="module")
def base(data):
    """codec → (reference StableIndex, port StableIndex) over one graph,
    built by the port (a reference build takes several times as long here)
    and handed to the reference as arrays."""
    f, a, _, _ = data
    built = tapi.Engine.build(f[:N0], a[:N0], THelp(**HELP_KW), device="cpu").index
    jidx = JIndex(
        features=jnp.asarray(f[:N0]), attrs=jnp.asarray(a[:N0]),
        graph=jnp.asarray(built.graph.numpy()),
        metric_cfg=JMetric(**dataclasses.asdict(built.metric_cfg)),
        help_cfg=JHelp(**HELP_KW), stats=JStats(**dataclasses.asdict(built.stats)),
    )
    out = {"none": (jidx, to_port(jidx))}
    for mode in ("sq8", "pq", "pq4", "opq-pq"):
        jq_idx = dataclasses.replace(jidx, quant=integer_store(mode, f[:N0]))
        out[mode] = (jq_idx, to_port(jq_idx))
    return out


def engines(base, codec, policy=None, **kw):
    """A fresh (reference, port) MutableEngine pair over shallow copies of
    the base indexes (a merge swaps an engine's index, never its arrays)."""
    jidx, tidx = base[codec]
    return (jmut.MutableEngine(japi.Engine(dataclasses.replace(jidx)),
                               jmut.CompactionPolicy(**(policy or NO_MERGE)), **kw),
            tmut.MutableEngine(tapi.Engine(dataclasses.replace(tidx)),
                               tmut.CompactionPolicy(**(policy or NO_MERGE)), **kw))


def write_script(data):
    """40 inserts, 10 vector + attribute overwrites, 15 deletes, all
    integer-valued: a list of ("upsert", id, vec, attrs) / ("delete", id)."""
    f, a, _, _ = data
    ops = [("upsert", i, f[i], a[i]) for i in range(N0, N0 + 40)]
    rng = np.random.default_rng(3)
    over = sorted(int(x) for x in rng.choice(N0, 10, replace=False))
    for i in over:
        v = (f[i] + rng.integers(-2, 3, f.shape[1])).astype(np.float32)
        ops.append(("upsert", i, v, ((a[i] + 1) % 3).astype(np.int32)))
    rest = np.setdiff1d(np.arange(N0), np.asarray(over))
    ops += [("delete", int(i)) for i in sorted(rng.choice(rest, 15, replace=False))]
    return ops


def apply(m, ops):
    for op in ops:
        if op[0] == "upsert":
            m.upsert(op[2], op[3], id=op[1])
        else:
            assert m.delete(op[1])


def assert_ids_tie_aware(jd, ji, ti):
    """Ids equal except at near-ties of the reference's distances."""
    tie = 1e-6 + 1e-5 * np.abs(jd)
    for p in np.flatnonzero(ji != ti):
        near = np.abs(jd - jd[p]) <= 2 * tie[p]
        near[p] = False
        assert near.any(), f"slot {p}: id {ti[p]} != {ji[p]}, no near-tie"


def assert_results_alike(jids, jsq, tids, tsq):
    jids, jsq = np.asarray(jids), np.asarray(jsq)
    tids, tsq = np.asarray(tids), np.asarray(tsq)
    for r in range(jids.shape[0]):
        assert_ids_tie_aware(jsq[r], jids[r], tids[r])
    np.testing.assert_allclose(tsq, jsq, rtol=1e-5)


@pytest.fixture(scope="module")
def states(base, data):
    """(phase, codec) → (reference engine, port engine, script) for the
    pre-merge state (the delta holds every write) and the post-merge one."""
    ops = write_script(data)
    out = {}
    for codec in CODECS:
        for phase in ("pre", "post"):
            jm, tm = engines(base, codec)
            apply(jm, ops)
            apply(tm, ops)
            if phase == "post":
                js, ts = jm.merge(), tm.merge()
                assert (ts["linked"], ts["repaired"], ts["tombstones"]) == (
                    js["linked"], js["repaired"], js["tombstones"])
                assert tm.delta.n_rows == 0 and not tm.oplog
            out[phase, codec] = (jm, tm, ops)
    return out


@pytest.fixture(scope="module")
def batches(data):
    _, _, qf, qa = data
    return predicate_batches(qf, qa, jquery), predicate_batches(qf, qa, tquery)


# ---------------------------------------------------------------------------
# DeltaSegment
# ---------------------------------------------------------------------------


def test_delta_append_overwrite_kill():
    d = tmut.DeltaSegment(4, 2, device="cpu")
    r0 = d.append(7, np.ones(4), np.zeros(2))
    assert d.n_alive == 1 and d.row_of[7] == r0
    r1 = d.append(7, 2 * np.ones(4), np.ones(2))  # overwrite: a new row
    assert r1 != r0 and d.n_alive == 1 and d.n_rows == 2
    assert not d.alive[r0] and d.alive[r1]
    latest = d.latest()
    np.testing.assert_array_equal(latest[7][0], 2 * np.ones(4))
    assert latest[7][2] is True
    assert d.kill(7) and d.n_alive == 0
    assert not d.kill(7)  # already dead
    assert d.latest()[7][2] is False  # the dead latest row stays for the merge
    for name in ("features", "attrs", "ids", "alive"):  # the mirror follows
        np.testing.assert_array_equal(d._mirror[name].numpy(), getattr(d, name))


def test_delta_capacity_doubles():
    d = tmut.DeltaSegment(2, 1, device="cpu")
    for i in range(600):
        d.append(i, np.full(2, i), np.zeros(1))
    assert d.n_rows == 600 and d.features.shape[0] == 1024
    assert tuple(d._mirror["features"].shape) == (1024, 2)
    np.testing.assert_array_equal(d._mirror["ids"].numpy(), d.ids)
    np.testing.assert_array_equal(d._mirror["features"].numpy(), d.features)


def test_delta_topk_padding_and_dead_masking(data):
    f, a, _, _ = data
    d = tmut.DeltaSegment(f.shape[1], a.shape[1], device="cpu")
    d.append(1, f[1], a[1])
    d.append(2, f[2], a[2])
    d.kill(2)
    ids, sq = d.topk(tquery.QueryBatch.match(f[1:2], a[1:2]), 5, None, oracle=True)
    assert tuple(ids.shape) == (1, 5) and ids.dtype == torch.int32
    assert int(ids[0, 0]) == 1  # the only alive row
    assert (ids[0, 1:] == INVALID).all()  # dead and padding masked out
    assert float(sq[0, 0]) == 0.0


@pytest.mark.parametrize("scan", ["oracle", "soft", "enforce"])
@pytest.mark.parametrize("kind", KINDS)
def test_delta_topk_matches_reference(data, batches, base, kind, scan):
    f, a, _, _ = data
    jd = jmut.DeltaSegment(f.shape[1], a.shape[1])
    td = tmut.DeltaSegment(f.shape[1], a.shape[1], device="cpu")
    for d in (jd, td):  # 300 rows: one capacity doubling, overwrites, kills
        for i in range(300):
            d.append(int(i % 280), f[i], a[i])
        for i in range(0, 280, 7):
            d.kill(i)
    cfg = base["none"][0].metric_cfg
    jb, tb = batches
    args = dict(oracle=scan == "oracle", enforce=scan == "enforce")
    ji, js = jd.topk(jb[kind], K, cfg, **args)
    ti, ts = td.topk(tb[kind], K, TMetric(**dataclasses.asdict(cfg)), **args)
    assert_results_alike(ji, js, ti.numpy(), ts.numpy())


# ---------------------------------------------------------------------------
# CompactionPolicy
# ---------------------------------------------------------------------------


def test_compaction_policy_decisions_match_reference():
    table = dict(unit_evals=16.0, probe_pool=64, probe_n=10_000, brute_eval_cost=1.0,
                 batch_overhead=4.0)
    jcm, tcm = jplanner.cost_model_from_table(table), tplanner.cost_model_from_table(table)
    for kw in (dict(), dict(max_delta_rows=100, min_delta_rows=8),
               dict(max_cost_regression=0.05, probe_pool=16)):
        jp, tp = jmut.CompactionPolicy(**kw), tmut.CompactionPolicy(**kw)
        for rows in (0, 7, 63, 64, 99, 100, 512, 4000, 4096, 32768):
            for n in (1, 900, 5000, 10 ** 6):
                for has_graph in (True, False):
                    for cms in ((None, None), (jcm, tcm)):
                        want = jp.should_merge(delta_rows=rows, n_main=n, cost_model=cms[0],
                                               has_graph=has_graph)
                        got = tp.should_merge(delta_rows=rows, n_main=n, cost_model=cms[1],
                                              has_graph=has_graph)
                        assert got == want, (kw, rows, n, has_graph, cms[0] is None)


# ---------------------------------------------------------------------------
# apply_rows and link_nodes (the merge primitives)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "sq8", "pq", "pq4", "opq-pq"])
def test_apply_rows_equals_reference(base, data, codec):
    f, a, _, _ = data
    jidx, tidx = base[codec]
    ids = np.array([5, N0, N0 + 3])  # one overwrite, two new rows (one gap)
    feats = f[[5, N0, N0 + 3]] + 1.0
    attrs = a[[5, N0, N0 + 3]]
    before = {k: getattr(tidx, k).clone() for k in ("features", "attrs", "graph")}
    codes_before = None if tidx.quant is None else tidx.quant.codes.clone()
    jnew, tnew = jidx.apply_rows(ids, feats, attrs), tidx.apply_rows(ids, feats, attrs)
    for k in ("features", "attrs", "graph"):
        np.testing.assert_array_equal(getattr(tnew, k).numpy(), np.asarray(getattr(jnew, k)))
        assert torch.equal(getattr(tidx, k), before[k])  # the old index is untouched
    assert (tnew.graph[N0:] == INVALID).all()
    if codec == "none":
        assert tnew.quant is None
    else:
        np.testing.assert_array_equal(tnew.quant.codes.numpy(), np.asarray(jnew.quant.codes))
        assert tnew.quant.codes.dtype == tidx.quant.codes.dtype
        assert torch.equal(tidx.quant.codes, codes_before)
    assert tidx.apply_rows(np.zeros(0, np.int64), feats[:0], attrs[:0]) is tidx


@pytest.mark.parametrize("banned", ["deleted", "none"])
def test_link_nodes_equals_reference(base, data, banned):
    """The write script's 40 inserts and 10 overwrites linked as a merge
    links them (the deleted ids banned, or nothing banned)."""
    jidx, tidx = base["none"]
    last = {op[1]: op for op in write_script(data) if op[0] == "upsert"}
    ids = np.asarray(sorted(last), np.int64)
    feats = np.stack([last[i][2] for i in ids])
    attrs = np.stack([last[i][3] for i in ids])
    ban = None
    if banned == "deleted":
        ban = np.asarray([op[1] for op in write_script(data) if op[0] == "delete"], np.int64)
    jnew, tnew = jidx.apply_rows(ids, feats, attrs), tidx.apply_rows(ids, feats, attrs)
    jg, jrep = jhelp.link_nodes(jnew.features, jnew.attrs, jnew.graph, ids, jnew.metric_cfg,
                                jnew.help_cfg, banned_ids=ban)
    graph_before = tnew.graph.clone()
    tg, trep = thelp.link_nodes(tnew.features, tnew.attrs, tnew.graph, ids, tnew.metric_cfg,
                                tnew.help_cfg, banned_ids=ban)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert trep == jrep > 0
    assert torch.equal(tnew.graph, graph_before)  # the input graph is not written
    assert (tg[torch.from_numpy(ids)] >= 0).any(1).all()  # every linked row has edges
    if ban is not None:
        assert not np.isin(tg[torch.from_numpy(ids)].numpy(), ban).any()


def test_offers_follow_scan_order():
    """The vectorized offers equal the reference's dict-of-lists loop."""
    rng = np.random.default_rng(0)
    node_ids = np.array([50, 51, 52, 53], np.int64)
    rows = rng.integers(-1, 60, (4, 6)).astype(np.int32)
    offers: dict = {}
    for i, v in enumerate(node_ids.tolist()):
        for u in rows[i].tolist():
            if u >= 0 and u not in set(node_ids.tolist()):
                offers.setdefault(u, []).append(v)
    u_ids, off = thelp._offers(rows, node_ids)
    assert u_ids.tolist() == list(offers)
    for r, vs in enumerate(offers.values()):
        assert off[r, : len(vs)].tolist() == vs and (off[r, len(vs):] == INVALID).all()


# ---------------------------------------------------------------------------
# The federated read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("backend", ["graph", "brute"])
def test_no_write_fast_path_bit_exact(base, batches, codec, backend):
    _, tm = engines(base, codec)
    _, tb = batches
    p = tapi.SearchParams(k=K, pool_size=POOL, backend=backend)
    for kind in KINDS:
        a, b = tm.engine.search(tb[kind], p), tm.search(tb[kind], p)
        for field in ("ids", "dists", "sqdists", "n_dist_evals"):
            assert torch.equal(getattr(a, field), getattr(b, field)), (kind, field)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["graph", "brute"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("phase", ["pre", "post"])
def test_federated_search_matches_reference(states, batches, phase, codec, backend, kind):
    jm, tm, _ = states[phase, codec]
    jb, tb = batches
    kw = dict(k=K, pool_size=POOL, backend=backend)
    jres, tres = jm.search(jb[kind], japi.SearchParams(**kw)), tm.search(tb[kind], tapi.SearchParams(**kw))
    assert_results_alike(jres.ids, jres.sqdists, tres.ids.numpy(), tres.sqdists.numpy())
    np.testing.assert_array_equal(tres.n_dist_evals.numpy(), np.asarray(jres.n_dist_evals))


@pytest.mark.parametrize("backend", ["graph", "brute"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("phase", ["pre", "post"])
def test_visibility(states, data, phase, codec, backend):
    """A deleted id is never returned; an inserted id and an overwritten
    one (with its new vector and attributes) are found by their own vector."""
    f, a, _, _ = data
    _, tm, ops = states[phase, codec]
    p = tapi.SearchParams(k=K, pool_size=POOL, backend=backend)
    deleted = [op[1] for op in ops if op[0] == "delete"]
    ids = tm.search(tquery.QueryBatch.match(f[deleted[:8]], a[deleted[:8]]), p).ids.numpy()
    assert not np.isin(ids, deleted).any()
    ups = [op for op in ops if op[0] == "upsert"]
    for chunk in (ups[:8], ups[40:46]):  # inserts, then overwrites
        q = tquery.QueryBatch.match(np.stack([op[2] for op in chunk]),
                                    np.stack([op[3] for op in chunk]))
        got = tm.search(q, p).ids.numpy()
        for r, op in enumerate(chunk):
            assert op[1] in got[r], (op[1], got[r])
    assert tm.n_items == N0 + 40 - 15
    assert not any(tm.exists(i) for i in deleted)
    assert all(tm.exists(op[1]) for op in ups)


def test_write_epoch_bumps_before_the_ack(base, data):
    f, a, _, _ = data
    assert tapi.Engine.write_epoch == 0
    _, tm = engines(base, "none")
    assert tm.write_epoch == 0 and tm.engine.write_epoch == 0
    assert tm.upsert(f[N0], a[N0], id=N0) == N0
    assert tm.write_epoch == 1
    assert tm.delete(N0) and tm.write_epoch == 2
    assert not tm.delete(N0) and tm.write_epoch == 2  # nothing applied: no bump
    assert tm.upsert(f[N0 + 1], a[N0 + 1]) == N0 + 1  # ids continue past the last
    assert tm.write_epoch == 3


def test_merge_swaps_the_index_and_clears_the_executor(base, data, batches):
    f, a, _, _ = data
    _, tm = engines(base, "none")
    _, tb = batches
    p = tapi.SearchParams(k=K, pool_size=POOL, backend="graph")
    old = tm.engine.index
    tm.search(tb["match"], p)  # fast path: compiles a plan for the old N
    host = tm.engine.host_attrs
    assert tm.engine.executor.stats()["size"] == 1
    apply(tm, [("upsert", N0 + i, f[N0 + i], a[N0 + i]) for i in range(5)])
    stats = tm.merge()
    assert stats["linked"] == 5 and stats["n_main"] == N0 + 5 and stats["replayed_ops"] == 0
    assert tm.engine.index is not old and int(old.features.shape[0]) == N0
    assert tm.engine.executor.stats()["size"] == 0  # closures over the old N dropped
    assert tm.engine.host_attrs is not host and tm.engine.host_attrs.shape[0] == N0 + 5
    assert tm.merge() is None  # nothing left to fold


# ---------------------------------------------------------------------------
# The write-ahead log
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wal_replays_across_packages(base, data, tmp_path, writer):
    """A log written by either package's MutableEngine rebuilds the same
    logical state in the other's."""
    path = str(tmp_path / "x.wal")
    ops = write_script(data)
    jidx, tidx = base["none"]
    first, second = ((jmut, japi, jidx), (tmut, tapi, tidx))
    if writer == "port":
        first, second = second, first
    m1 = first[0].MutableEngine(first[1].Engine(dataclasses.replace(first[2])), wal_path=path)
    apply(m1, ops)
    m1.wal.close()
    m2 = second[0].MutableEngine(second[1].Engine(dataclasses.replace(second[2])), wal_path=path)
    assert m2.tombstones == m1.tombstones and m2.n_items == m1.n_items
    assert m2.write_epoch == len(ops) and m2._next_id == m1._next_id
    l1, l2 = m1.delta.latest(), m2.delta.latest()
    assert list(l1) == list(l2)
    for i in l1:
        np.testing.assert_array_equal(l1[i][0], l2[i][0])
        np.testing.assert_array_equal(l1[i][1], l2[i][1])
        assert l1[i][2] == l2[i][2]
    m2.wal.close()


def test_wal_files_are_byte_identical(tmp_path):
    v, at = np.arange(4, dtype=np.float32), np.array([1, 2], np.int32)
    logs = {}
    for name, mod in (("ref", jmut), ("port", tmut)):
        w = mod.WriteAheadLog(str(tmp_path / f"{name}.wal"), 4, 2)
        w.append("upsert", 7, v, at)
        w.append("delete", 3)
        w.close()
        logs[name] = (tmp_path / f"{name}.wal").read_bytes()
    assert logs["ref"] == logs["port"]
    body = logs["port"].split(b"\n", 1)[1]
    assert body[:1] == b"U" and struct.unpack("<q", body[1:9])[0] == 7
    assert body[-9:] == b"D" + struct.pack("<q", 3)


def test_wal_torn_tail_header_and_reset(tmp_path):
    path = str(tmp_path / "t.wal")
    w = tmut.WriteAheadLog(path, 4, 2)
    v, at = np.zeros(4, np.float32), np.zeros(2, np.int32)
    w.append("upsert", 1, v, at)
    w.append("upsert", 2, v, at)
    w.close()
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 5)  # a crash mid-record
    w = tmut.WriteAheadLog(path, 4, 2)
    assert [i for _, i, _, _ in w.replay()] == [1]
    w.append("delete", 9)  # the tail was cut at a record boundary
    assert [(k, i) for k, i, _, _ in w.replay()] == [("upsert", 1), ("delete", 9)]
    w.reset([("delete", 42, None, None)])
    assert [(k, i) for k, i, _, _ in w.replay()] == [("delete", 42)]
    with pytest.raises(ValueError, match="WAL dims"):
        w.append("upsert", 1, np.zeros(3, np.float32), at)
    w.close()
    with pytest.raises(ValueError, match="dims"):
        tmut.WriteAheadLog(path, 5, 2)
    (tmp_path / "junk.wal").write_bytes(b"not json\n")
    with pytest.raises(ValueError, match="bad header"):
        tmut.WriteAheadLog(str(tmp_path / "junk.wal"), 4, 2)


def test_wal_replay_reconstructs_state(base, data, tmp_path):
    path = str(tmp_path / "m.wal")
    _, tm = engines(base, "none", wal_path=path)
    apply(tm, write_script(data))
    assert tm.write_stats()["wal_bytes"] > 0
    f, a, _, _ = data
    q = tquery.QueryBatch.match(f[:16], a[:16])
    p = tapi.SearchParams(k=K, pool_size=POOL, backend="brute")
    want = tm.search(q, p)
    _, tm2 = engines(base, "none", wal_path=path)
    assert tm2.tombstones == tm.tombstones and tm2.n_items == tm.n_items
    got = tm2.search(q, p)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.sqdists, want.sqdists)
    tm.wal.close()
    tm2.wal.close()


def test_checkpoint_folds_and_resets_the_log(base, data, tmp_path):
    path = str(tmp_path / "c.wal")
    _, tm = engines(base, "none", wal_path=path)
    ops = write_script(data)
    apply(tm, ops)
    grown = tm.write_stats()["wal_bytes"]
    out = str(tmp_path / "ckpt")
    stats = tm.checkpoint(out)
    assert stats["linked"] == 50 and tm.delta.n_rows == 0 and not tm.oplog
    assert tm.write_stats()["wal_bytes"] < grown  # the deletes restated only
    f, a, _, _ = data
    q = tquery.QueryBatch.match(f[:16], a[:16])
    p = tapi.SearchParams(k=K, pool_size=POOL, backend="brute")
    want = tm.search(q, p)
    tm2 = tmut.MutableEngine(tapi.Engine.load(out, device="cpu"), wal_path=path)
    assert tm2.tombstones == tm.tombstones and tm2.delta.n_rows == 0
    got = tm2.search(q, p)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.sqdists, want.sqdists)
    tm.wal.close()
    tm2.wal.close()


# ---------------------------------------------------------------------------
# Constructor guards
# ---------------------------------------------------------------------------


def test_constructor_guards(data):
    f, a, _, _ = data
    with pytest.raises(TypeError, match="Engine"):
        tmut.MutableEngine(object())
    part = tapi.Engine.build_partitioned(f[:N0], a[:N0], n_partitions=2, build_graph=False,
                                         device="cpu")
    with pytest.raises(ValueError, match="partitioned"):
        tmut.MutableEngine(part)


# ---------------------------------------------------------------------------
# The serve layer's write path
# ---------------------------------------------------------------------------


def mixed_trace(mod, pkg, data):
    """MATCH and ONE_OF reads interleaved with the write script, at 1 ms
    steps on the virtual clock."""
    _, _, qf, qa = data
    Q, MATCH, ONE_OF, ANY = mod.Query, mod.MATCH, mod.ONE_OF, mod.ANY
    reads = []
    for i in range(16):
        at = [int(x) for x in qa[i]]
        preds = ([MATCH(x) for x in at],
                 [ONE_OF(0, 2), MATCH(at[1]), ANY, MATCH(at[3]), MATCH(at[4])])[i % 2]
        reads.append(pkg.Request("t", Q(qf[i], preds)))
    writes = [pkg.Upsert("t", op[2], op[3], id=op[1]) if op[0] == "upsert"
              else pkg.Delete("t", op[1]) for op in write_script(data)]
    writes.append(pkg.Delete("t", N0 + 59))  # never written: not applied
    trace, wi = [], 0
    for i, r in enumerate(reads):
        trace.append(r)
        trace.extend(writes[wi:wi + 5])
        wi += 5
    trace.extend(writes[wi:])
    return [(1e-3 * i, item) for i, item in enumerate(trace)]


@pytest.mark.parametrize("backend", ["graph", "brute"])
def test_serve_loop_mixed_trace_equals_reference(base, data, backend):
    policy = dict(max_delta_rows=40, min_delta_rows=10 ** 9)  # one merge, mid-trace
    jm, tm = engines(base, "none", policy)
    outs = {}
    for name, m, mod, pkg in (("ref", jm, japi, jserve), ("port", tm, tapi, tserve)):
        reg = pkg.TenantRegistry(default_policy=pkg.TenantPolicy(
            params=mod.SearchParams(k=K, pool_size=POOL, backend=backend)))
        outs[name] = pkg.serve_loop(m, mixed_trace(mod, pkg, data), reg, window_ms=1.0,
                                    buckets=(1, 8))
    (jresp, jstats), (tresp, tstats) = outs["ref"], outs["port"]
    assert [type(r).__name__ for r in jresp] == [type(r).__name__ for r in tresp]
    for j, t in zip(jresp, tresp):
        assert (j.request_id, j.tenant, j.ok) == (t.request_id, t.tenant, t.ok)
        if isinstance(t, tserve.WriteAck):
            assert (j.id, j.op, j.applied, j.delta_rows) == (t.id, t.op, t.applied, t.delta_rows)
        elif isinstance(t, tserve.Completed):
            assert (j.bucket, j.batch_fill) == (t.bucket, t.batch_fill)
            assert_ids_tie_aware(np.asarray(j.dists), np.asarray(j.ids), t.ids)
            np.testing.assert_allclose(t.dists, np.asarray(j.dists), rtol=1e-5)
        else:
            assert j.reason == t.reason
    assert jm.merge_count == tm.merge_count == 1
    js, ts = jstats.snapshot(), tstats.snapshot()
    for key in ("upserts", "deletes", "shed", "merges"):
        assert js["writes"][key] == ts["writes"][key], key
    for key in ("delta_rows", "delta_alive", "tombstones", "logical_n", "oplog_len", "merges"):
        assert js["delta"][key] == ts["delta"][key], key
    assert (js["completed"], js["batches"]) == (ts["completed"], ts["batches"])


def test_immutable_engine_still_rejects_writes(base, data):
    f, a, _, _ = data
    out, stats = tserve.serve_loop(tapi.Engine(base["none"][1]), [tserve.Upsert("t", f[0], a[0])])
    assert not out[0].ok and out[0].reason == "immutable_engine"
    assert stats.snapshot()["writes"]["shed"] == 1


def test_threaded_read_your_writes(base, data):
    f, a, _, _ = data
    _, tm = engines(base, "none")
    reg = tserve.TenantRegistry(default_policy=tserve.TenantPolicy(
        params=tapi.SearchParams(k=K, pool_size=POOL, backend="graph")))
    with tserve.ThreadedServer(tm, reg, window_ms=1.0) as srv:
        i = N0 + 7
        ack = srv.submit(tserve.Upsert("t", f[i], a[i], id=i)).result(10)
        assert ack.ok and ack.op == "upsert" and ack.id == i
        q = tapi.Query(f[i], [tapi.MATCH(int(v)) for v in a[i]])
        r = srv.submit(tserve.Request("t", q)).result(30)
        assert r.ok and int(r.ids[0]) == i  # the fresh row wins at rank 0
        dack = srv.submit(tserve.Delete("t", i)).result(10)
        assert dack.ok and dack.applied
        r2 = srv.submit(tserve.Request("t", q)).result(30)
        assert r2.ok and i not in r2.ids
        assert not srv.submit(tserve.Delete("t", i)).result(10).applied


def test_threaded_background_merge(base, data):
    f, a, qf, qa = data
    _, tm = engines(base, "none", dict(max_delta_rows=20, min_delta_rows=10 ** 9))
    reg = tserve.TenantRegistry(default_policy=tserve.TenantPolicy(
        params=tapi.SearchParams(k=K, pool_size=POOL, backend="graph")))
    q = tapi.Query(qf[0], [tapi.MATCH(int(v)) for v in qa[0]])
    with tserve.ThreadedServer(tm, reg, window_ms=1.0) as srv:
        futs = []
        for i in range(40):
            j = N0 + i % 60
            ack = srv.submit(tserve.Upsert("t", f[j], a[j], id=j)).result(10)
            assert ack.ok
            futs.append(srv.submit(tserve.Request("t", q)))  # reads keep flowing
        assert all(fu.result(60).ok for fu in futs)
    assert tm.merge_count >= 1  # stop() drains the merge in flight
    snap = srv.stats.snapshot()
    assert snap["writes"]["merges"] == tm.merge_count and snap["writes"]["merge_ms_p95"] > 0
    assert snap["delta"]["merges"] == tm.merge_count
    text = prometheus_text(srv.stats.registry)
    assert "serve_merge_ms_count" in text and "delta_merges" in text


# ---------------------------------------------------------------------------
# Freshness through the serving stack (port only)
# ---------------------------------------------------------------------------


def test_freshness_through_serve_on_the_graph_backend():
    """3,000 rows built, then 150 inserted and 75 deleted through
    serve_loop. Graph MATCH recall@10 against the logical corpus's oracle
    stays within 0.02 of the engine's own recall before any write (the
    algorithm's number at this size) before the merge and after it; the
    brute backend's is 1."""
    ds = make_hybrid_dataset(n=3150, n_queries=64, profile="sift", seed=0)
    eng = tapi.Engine.build(ds.features[:3000], ds.attrs[:3000],
                            THelp(gamma=16, gamma_new=6, max_rounds=8), device="cpu")
    m = tmut.MutableEngine(eng, tmut.CompactionPolicy(**NO_MERGE))
    params = tapi.SearchParams(k=K, pool_size=128, pioneer_size=16, backend="graph")
    reg = tserve.TenantRegistry(default_policy=tserve.TenantPolicy(params=params))
    rng = np.random.default_rng(7)
    deleted = sorted(int(x) for x in rng.choice(3000, 75, replace=False))
    writes = [tserve.Upsert("t", ds.features[i], ds.attrs[i], id=i) for i in range(3000, 3150)]
    writes += [tserve.Delete("t", i) for i in deleted]
    reads = [tserve.Request("t", tapi.Query(ds.query_features[i],
                                            [tapi.MATCH(int(v)) for v in ds.query_attrs[i]]),
                            request_id=10_000 + i) for i in range(64)]
    qb = tquery.QueryBatch.match(ds.query_features, ds.query_attrs)

    def oracle(n, dead=()):
        attrs = ds.attrs[:n].copy()
        attrs[list(dead)] = -1  # a deleted row matches no MATCH query
        return brute_force_hybrid(torch.from_numpy(ds.features[:n]), torch.from_numpy(attrs),
                                  ds.query_features, ds.query_attrs, K).ids

    def recall_of(responses, truth):
        done = sorted((r for r in responses if hasattr(r, "ids")), key=lambda r: r.request_id)
        assert len(done) == 64
        return recall_at_k(np.stack([r.ids for r in done]), truth, K)

    r0 = recall_at_k(m.search(qb, params).ids, oracle(3000), K)
    truth = oracle(3150, deleted)
    out, _ = tserve.serve_loop(m, [(0.0, w) for w in writes] + [(1.0, r) for r in reads], reg)
    assert all(r.ok for r in out)
    r_pre = recall_of(out, truth)
    assert m.merge_count == 0 and m.delta.n_alive == 150
    m.policy = tmut.CompactionPolicy(max_delta_rows=10)
    poke = tserve.Upsert("t", ds.features[3149], ds.attrs[3149], id=3149)
    out2, stats2 = tserve.serve_loop(m, [(0.0, poke)] + [(1.0, r) for r in reads], reg)
    assert all(r.ok for r in out2) and m.merge_count == 1
    r_post = recall_of(out2, truth)
    assert stats2.snapshot()["writes"]["merges"] == 1
    assert r0 >= 0.85 and r_pre >= r0 - 0.02 and r_post >= r0 - 0.02, (r0, r_pre, r_post)
    brute = m.search(qb, dataclasses.replace(params, backend="brute"))
    assert recall_at_k(brute.ids, truth, K) == 1.0
    ids = m.search(tquery.QueryBatch.match(ds.features[deleted[:8]], ds.attrs[deleted[:8]]),
                   params).ids.numpy()
    assert not np.isin(ids, deleted).any()


def test_mutable_modules_import_no_jax():
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import sys\nimport repro_torch.mutable, repro_torch.serve, repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    done = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=src),
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
