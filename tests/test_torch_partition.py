"""The port's partitioned backend (``repro_torch.partition``) against the
reference's, and against the port's own flat brute engine.

Integer-valued features (``_torch_data.dataset``), n = 2,048, P = 5. What
is held, and to what:

* (a) k-means: centroids within rtol 1e-5 of the reference's on the same
  array and seed; assignments equal except where a row's two nearest
  centroid distances lie within 1e-5 relative of each other;
* (b) ``SegmentStore``: the same scripted calls through both packages'
  stores give equal ``stats()`` and resident ids after every call;
* (c) the ``stable-partitioned-v1`` layout both ways: each package loads
  the other's directory (summaries and row ids equal, centroids within
  rtol 1e-5, saved arrays equal byte for byte), and both search one saved
  directory alike: exact searches (brute and graph) equal bit for bit,
  since every partial sum on integer data is exact; pq searches with ids
  equal except at near-ties and sqdists within rtol 1e-5, since the two
  packages' ADC tables and sums differ in the last bits, so a pool may
  differ at a near-tie of code scores (on this data they came out equal);
* (d) the full probe with the brute sub-backend equals the port's flat
  brute engine bit for bit for every codec and predicate kind;
* (e) summary pruning equals the reference's and never drops a partition
  holding an admissible row;
* (f) planner and executor rules, (g) residency under a cap, and the
  serving layer over a partitioned engine.

The reference's partitioned HELP builds are not run here: each partition
size compiles its own traced build (≈ 40 s for five partitions). The
reference-built directory is scan-only; graphs cross packages through the
port-built directory, which the reference loads and traverses.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_data import dataset, predicate_batches  # noqa: E402
from repro import api as japi, partition as jpart, serve as jserve  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro.quant import QuantConfig as JQuant  # noqa: E402
from repro_torch import api as tapi, partition as tpart, serve as tserve  # noqa: E402
from repro_torch.api import planner as tplanner  # noqa: E402
from repro_torch.core.help_graph import HelpConfig as THelp  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.quant import QuantConfig as TQuant  # noqa: E402

N, P, NQ, K = 2048, 5, 16, 10
HELP = dict(gamma=6, gamma_new=3, max_rounds=4)
MODES = ("none", "sq8", "pq", "pq4", "opq-pq4")
KINDS = ("match", "subset", "one_of", "between")


def build(mode="pq", graph=True, **kw):
    f, a, _, _ = dataset(n=N, n_queries=NQ)
    return tapi.Engine.build_partitioned(
        f, a, n_partitions=P, help_cfg=THelp(**HELP), device="cpu", build_graph=graph,
        quant_cfg=TQuant(mode=mode, pq_subspaces=8), **kw,
    )


@pytest.fixture(scope="module")
def data():
    return dataset(n=N, n_queries=NQ)


@pytest.fixture(scope="module")
def saved(data, tmp_path_factory):
    """The port's partitioned pq index with HELP subgraphs, saved; and a
    scan-only pq index built by the reference, saved."""
    f, a, _, _ = data
    root = tmp_path_factory.mktemp("partitioned")
    port_dir, ref_dir = str(root / "port"), str(root / "ref")
    build("pq").save(port_dir)
    japi.Engine.build_partitioned(
        f, a, n_partitions=P, help_cfg=JHelp(**HELP), build_graph=False,
        quant_cfg=JQuant(mode="pq", pq_subspaces=8),
    ).save(ref_dir)
    return port_dir, ref_dir


@pytest.fixture(scope="module")
def pair(saved):
    """(reference engine, port engine) over the port's saved directory."""
    return japi.Engine.load(saved[0]), tapi.Engine.load(saved[0], device="cpu")


@pytest.fixture(scope="module")
def flat_and_part():
    """(flat brute engine, partitioned scan-only engine) per codec, each
    training its codec over the whole corpus."""
    f, a, _, _ = dataset(n=N, n_queries=NQ)
    out = {}
    for mode in MODES:
        qc = TQuant(mode=mode, pq_subspaces=8)
        out[mode] = (
            tapi.Engine.build(f, a, quant_cfg=qc, build_graph=False, device="cpu"),
            build(mode, graph=False),
        )
    return out


def batches(data, mod=tapi):
    _, _, qf, qa = data
    return predicate_batches(qf, qa, mod.query if mod is tapi else japi.query)


def assert_bit_equal(res, ref, ctx=""):
    for f in ("ids", "dists", "sqdists"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f"{ctx}: {f}"


def assert_near(jres, tres, ctx="", exact=False):
    """Ids equal except at near-ties of the reference's sqdists; sqdists
    within rtol 1e-5; with ``exact``, both equal bit for bit."""
    jd, ji = np.asarray(jres.sqdists), np.asarray(jres.ids)
    td, ti = tres.sqdists.numpy(), tres.ids.numpy()
    if exact:
        np.testing.assert_array_equal(ti, ji, err_msg=ctx)
        np.testing.assert_array_equal(td, jd, err_msg=ctx)
        return
    np.testing.assert_allclose(td, jd, rtol=1e-5, err_msg=ctx)
    tie = 1e-6 + 1e-5 * np.abs(jd)
    for b, p in zip(*np.nonzero(ji != ti)):
        near = np.abs(jd[b] - jd[b, p]) <= 2 * tie[b, p]
        near[p] = False
        assert near.any(), f"{ctx}: query {b} slot {p}: id {ti[b, p]} != {ji[b, p]}, no near-tie"


# ---------------------------------------------------------------------------
# (a) the coarse quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,iters", [(0, 50), (3, 8)])
def test_train_coarse_matches_reference(data, seed, iters):
    f = data[0]
    jq = jpart.train_coarse(f, P, n_iters=iters, seed=seed)
    tq = tpart.train_coarse(f, P, n_iters=iters, seed=seed, device="cpu")
    np.testing.assert_allclose(tq.centroids, jq.centroids, rtol=1e-5, atol=1e-4)
    ja, ta = jq.assign(f), tq.assign(f, chunk_rows=700)
    d = np.sort(((f[:, None, :] - tq.centroids[None].astype(np.float64)) ** 2).sum(-1), 1)
    near_tie = d[:, 1] - d[:, 0] <= 1e-5 * d[:, 1]
    assert ((ja == ta) | near_tie).all()
    # chunked assignment ≡ the one-shot scorer's argmin
    np.testing.assert_array_equal(ta, tq.scores(f).numpy().argmin(1))
    assert ta.min() >= 0 and ta.max() < P


def test_train_coarse_rejects_bad_sizes(data):
    with pytest.raises(ValueError, match="positive"):
        tpart.train_coarse(data[0], 0, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        tpart.train_coarse(data[0][:3], 4, device="cpu")


def test_minibatch_step_keeps_unseen_centers_bitwise():
    from repro_torch.partition.kmeans import _minibatch_step

    cents = torch.tensor([[0.0, 0.0], [10.0, 10.0], [100.3, -7.1]])
    counts = torch.tensor([2.0, 1.0, 5.0])
    batch = torch.tensor([[1.0, 1.0], [9.0, 11.0], [0.5, 0.0]])
    new, cnt = _minibatch_step(cents, counts, batch)
    assert torch.equal(new[2], cents[2])  # saw no row: stays put exactly
    assert cnt.tolist() == [4.0, 2.0, 5.0]
    # per-center rate cnt_b / counts_new toward the batch mean
    torch.testing.assert_close(new[0], torch.tensor([0.375, 0.25]))


# ---------------------------------------------------------------------------
# (b) the SegmentStore against the reference's, call for call
# ---------------------------------------------------------------------------


def fake_loader(pkg, sizes):
    def load(pid):
        n = sizes[pid]
        return pkg.PartitionData(
            features=np.full((n, 4), pid, np.float32),
            attrs=np.full((n, 2), pid, np.int32),
            graph=np.zeros((n, 3), np.int32),
            codes=np.full((n, 2), pid, np.uint8),
            row_ids=np.arange(n, dtype=np.int32) + 1000 * pid,
        )
    return load


STORE_SCRIPTS = {
    "lru_under_cap": ({i: 100 for i in range(4)}, 512,
                      [("get", 0), ("get", 1), ("get", 2), ("get", 1), ("get", 3)]),
    "evict_before_load": ({i: 200 for i in range(6)}, 768, [("get", i) for i in range(6)]),
    "oversized": ({0: 100, 1: 3000}, 512, [("get", 0), ("get", 1), ("get", 0)]),
    "prefetch_double_buffer": ({i: 100 for i in range(5)}, 4096,
                               [("prefetch", 1), ("get", 0), ("prefetch", 2), ("get", 1),
                                ("prefetch", 3), ("get", 2), ("get", 3), ("prefetch", 4),
                                ("evict_all",), ("get", 0), ("prefetch", 0)]),
    "buffer_depth_two": ({i: 100 for i in range(4)}, 4096,
                         [("prefetch", i) for i in range(4)] + [("get", 3), ("drop_prefetch",)]),
    "reset_counters": ({0: 100, 1: 100}, 1024,
                       [("get", 0), ("get", 1), ("reset",), ("get", 0), ("get", 2 % 2)]),
    "pinning": ({i: 300 for i in range(5)}, 1536,
                [("pin", (0, 1)), ("get", 2), ("get", 3), ("get", 4), ("unpin",), ("get", 2),
                 ("pin", (4,)), ("get", 0), ("get", 1), ("evict_all",), ("pin", (2, 3, 4)),
                 ("get", 0)]),
}


def _step(store, op):
    name, *args = op
    if name == "get":
        store.get(args[0])
    elif name == "prefetch":
        store.prefetch(args[0])
    elif name == "pin":
        store.pin(args[0])
    elif name == "reset":
        store.reset_counters()
    else:
        getattr(store, name)()


@pytest.mark.parametrize("script", list(STORE_SCRIPTS))
def test_segment_store_counts_as_reference(script):
    sizes, cap, ops = STORE_SCRIPTS[script]
    js = jpart.SegmentStore(fake_loader(jpart, sizes), cap)
    ts = tpart.SegmentStore(fake_loader(tpart, sizes), cap, device="cpu")
    for i, op in enumerate(ops):
        _step(js, op)
        _step(ts, op)
        assert ts.stats() == js.stats(), f"{script} step {i} {op}"
        assert ts.resident_ids() == js.resident_ids(), f"{script} step {i} {op}"
        assert ts.pinned_ids() == js.pinned_ids()
        assert ts.stats()["peak_resident_rows"] <= cap or script in ("oversized", "pinning")


def test_row_bucket_and_padding():
    assert [tpart.row_bucket(n) for n in (0, 256, 257, 5000)] == [256, 256, 512, 8192]
    assert tpart.row_bucket(10, bucket_min=8) == 16
    sizes = {0: 10}
    part = tpart.SegmentStore(fake_loader(tpart, sizes), 4096, device="cpu").get(0)
    ref = jpart.SegmentStore(fake_loader(jpart, sizes), 4096).get(0)
    assert (part.n_real, part.n_pad) == (ref.n_real, ref.n_pad) == (10, 256)
    for f in ("features", "attrs", "graph", "codes", "row_ids"):
        np.testing.assert_array_equal(getattr(part, f).numpy(), np.asarray(getattr(ref, f)))
    assert part.row_ids.dtype == torch.int32 and part.codes.dtype == torch.uint8
    assert (part.row_ids[10:] == -1).all() and (part.graph[10:] == -1).all()


def test_store_rejects_a_zero_cap():
    with pytest.raises(ValueError, match="cap_rows"):
        tpart.SegmentStore(fake_loader(tpart, {0: 1}), 0, device="cpu")


# ---------------------------------------------------------------------------
# (c) the saved layout both ways, and both packages searching one directory
# ---------------------------------------------------------------------------


def test_each_package_loads_the_others_directory(saved):
    port_dir, ref_dir = saved
    t_ref = tpart.PartitionedStableIndex.load(ref_dir, device="cpu")  # port reads the reference's
    j_port = jpart.PartitionedStableIndex.load(port_dir)  # reference reads the port's
    t_port = tpart.PartitionedStableIndex.load(port_dir, device="cpu")
    for name in ("n_rows", "attr_min", "attr_max"):
        np.testing.assert_array_equal(getattr(t_ref.summaries, name),
                                      getattr(t_port.summaries, name))
        np.testing.assert_array_equal(getattr(j_port.summaries, name),
                                      getattr(t_port.summaries, name))
    np.testing.assert_allclose(t_ref.quantizer.centroids, t_port.quantizer.centroids, rtol=1e-5)
    np.testing.assert_array_equal(j_port.quantizer.centroids, t_port.quantizer.centroids)
    assert j_port.has_graph and not t_ref.has_graph
    for pid in range(P):
        tp, jp, tr = (x._load_partition(pid) for x in (t_port, j_port, t_ref))
        np.testing.assert_array_equal(tr.row_ids, tp.row_ids)
        assert tr.graph.shape == (tp.row_ids.size, 0)
        for f in ("features", "attrs", "graph", "codes", "row_ids"):
            np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    # the reference writes the same meta keys and files the port writes
    files = lambda d: sorted(os.path.relpath(os.path.join(r, x), d)
                             for r, _, fs in os.walk(d) for x in fs)
    assert files(ref_dir) == files(port_dir)
    meta = [json.load(open(os.path.join(d, "meta.json"))) for d in (ref_dir, port_dir)]
    # a graph-built engine saves its (prior) cost model, as the reference's does
    assert sorted(meta[0]) == sorted(set(meta[1]) - {"cost_model"})
    assert meta[1]["cost_model"] == tplanner.default_cost_model(N).to_json()
    assert {k: meta[0][k] for k in ("format", "quant_cfg", "quant_dim", "quant_codec",
                                    "summaries", "help_cfg")} == \
        {k: meta[1][k] for k in ("format", "quant_cfg", "quant_dim", "quant_codec",
                                 "summaries", "help_cfg")}


def test_port_save_is_byte_identical_after_a_round_trip(saved, tmp_path):
    port_dir = saved[0]
    again = str(tmp_path / "again")
    tapi.Engine.load(port_dir, device="cpu").index.save(again)
    for root, _, fs in os.walk(port_dir):
        for x in fs:
            if x.endswith(".npy"):
                rel = os.path.relpath(os.path.join(root, x), port_dir)
                with open(os.path.join(port_dir, rel), "rb") as a, \
                        open(os.path.join(again, rel), "rb") as b:
                    assert a.read() == b.read(), rel


@pytest.mark.parametrize("sub,quant", [("brute", "none"), ("brute", "auto"), ("graph", "none")])
def test_both_packages_search_one_directory_alike(pair, data, sub, quant):
    jeng, teng = pair
    jb, tb = batches(data, japi), batches(data, tapi)
    # the reference traces each traversal shape anew: one probe depth there
    for kind in KINDS:
        for nprobe in (2, P) if sub == "brute" else (P,):
            p = dict(k=K, nprobe=nprobe, sub_backend=sub, quant=quant)
            jres = jeng.search(jb[kind], japi.SearchParams(**p))
            tres = teng.search(tb[kind], tapi.SearchParams(**p))
            assert_near(jres, tres, f"{kind}/{sub}/{quant}/nprobe={nprobe}",
                        exact=quant == "none")


def test_reference_directory_searches_alike(saved, data):
    jeng = japi.Engine.load(saved[1])
    teng = tapi.Engine.load(saved[1], device="cpu")
    jb, tb = batches(data, japi), batches(data, tapi)
    for kind in KINDS:
        for quant in ("none", "auto"):
            p = dict(k=K, nprobe=P, sub_backend="brute", quant=quant)
            assert_near(jeng.search(jb[kind], japi.SearchParams(**p)),
                        teng.search(tb[kind], tapi.SearchParams(**p)), f"{kind}/{quant}",
                        exact=quant == "none")


# ---------------------------------------------------------------------------
# (d) full probe ≡ the port's flat brute engine, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_full_probe_bit_exact_to_flat_brute(flat_and_part, data, mode, kind):
    flat, part = flat_and_part[mode]
    qb = batches(data)[kind]
    ref = flat.search(qb, tapi.SearchParams(k=K, backend="brute"))
    res = part.search(qb, tapi.SearchParams(k=K, nprobe=P, sub_backend="brute"))
    assert_bit_equal(res, ref, f"{mode}/{kind}")
    if mode in ("pq", "pq4", "opq-pq4"):  # the same pool-sized rerank
        assert torch.equal(res.n_dist_evals, ref.n_dist_evals)


@pytest.mark.parametrize("kind", KINDS)
def test_full_probe_keeps_the_flat_tie_order(data, kind):
    """Features in {-1, 0, 1}: most distances tie, across partitions too,
    so only the (score, global id) order reproduces the flat engine's."""
    f, a, qf, qa = data
    f3, q3 = np.sign(f[:, :8]).astype(np.float32), np.sign(qf[:, :8]).astype(np.float32)
    flat = tapi.Engine.build(f3, a, build_graph=False, device="cpu")
    part = tapi.Engine.build_partitioned(f3, a, n_partitions=P, build_graph=False, device="cpu")
    qb = predicate_batches(q3, qa, tapi.query)[kind]
    ref = flat.search(qb, tapi.SearchParams(k=K, backend="brute"))
    res = part.search(qb, tapi.SearchParams(k=K, nprobe=P, sub_backend="brute"))
    assert_bit_equal(res, ref, kind)


@pytest.mark.parametrize("b, nprobe, k", [(128, 11, 10), (37, 5, 300), (1, 4, 10)])
def test_graph_stage_rows_follow_the_eager_loop(b, nprobe, k):
    """The card's graphed groups read one staged row a group: its slot, the
    eager loop's padded sub-batch (``_pad_idx``), each row's merge-buffer
    row (pads to row B) and the query's fill level as the eager loop
    reaches it, in the eager loop's order (``_groups``)."""
    from repro_torch.partition.search import _batch_bucket, _groups, _pad_idx, _stage_rows

    rng = np.random.default_rng(b * nprobe)
    p = 24
    probes = np.stack([rng.choice(p, nprobe, replace=False) for _ in range(b)]).astype(np.int32)
    probes[rng.random(probes.shape) < 0.2] = -1
    n_pad = rng.choice([256, 4096, 8192], p).astype(np.int64)
    slot = rng.permutation(p).astype(np.int64)
    stage, pids, ns, buckets = _stage_rows(probes, k, n_pad, slot)
    fill = np.zeros(b, np.int64)
    groups = _groups(probes)
    assert pids.tolist() == list(groups)
    for row, pid, n, bucket, (gpid, qidx) in zip(stage, pids, ns, buckets, groups.items()):
        want = _batch_bucket(qidx.size, b)
        assert (n, bucket) == (qidx.size, want)
        assert row[0] == slot[pid]
        np.testing.assert_array_equal(row[1:1 + bucket], _pad_idx(qidx, bucket))
        np.testing.assert_array_equal(row[1 + bucket:1 + bucket + n], qidx)
        assert (row[1 + bucket + n:1 + 2 * bucket] == b).all()
        np.testing.assert_array_equal(row[1 + 2 * bucket:1 + 2 * bucket + n], fill[qidx])
        assert (row[1 + 2 * bucket + n:] == 0).all()
        fill[qidx] += min(k, n_pad[pid])


def test_select_orders_by_score_then_global_id():
    from repro_torch.partition.search import _select_perm

    scores = torch.tensor([[1.0, 1.0, 0.0, 3e38, 3e38, 1.0]])
    gids = torch.tensor([[7, 3, 9, 5, -1, 4]], dtype=torch.int32)
    s, g, perm = _select_perm(scores, gids, 6)
    assert g.tolist() == [[9, 3, 4, 7, -1, 5]] and perm.tolist() == [[2, 1, 5, 0, 4, 3]]
    assert torch.equal(s, scores.gather(1, perm))


def test_codec_trained_globally_as_the_flat_build(flat_and_part):
    for mode in ("sq8", "pq", "opq-pq4"):
        flat, part = flat_and_part[mode]
        fq, pidx = flat.index.quant, part.index
        if mode == "sq8":
            assert torch.equal(fq.sq_params.scale, pidx.sq_params.scale)
        else:
            assert torch.equal(fq.codebook.centroids, pidx.codebook.centroids)
        if fq.rotation is not None:
            assert torch.equal(fq.rotation, pidx.rotation)
        for pid in range(P):
            d = pidx._load_partition(pid)
            assert torch.equal(fq.codes[torch.from_numpy(d.row_ids)], torch.from_numpy(d.codes))


def test_exact_eval_counters_count_the_full_scan(flat_and_part, data):
    _, part = flat_and_part["none"]
    res = part.search(batches(data)["match"], tapi.SearchParams(k=K, nprobe=P, sub_backend="brute"))
    # summary pruning may skip partitions with no admissible row
    assert (res.n_dist_evals <= N).all() and (res.n_dist_evals > 0).all()
    _, part = flat_and_part["pq"]
    res = part.search(batches(data)["subset"], tapi.SearchParams(k=K, nprobe=P))
    assert (res.n_code_evals <= N).all()


# ---------------------------------------------------------------------------
# (e) summary pruning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_survivor_mask_equals_reference_and_covers_admissible_rows(pair, data, kind):
    jeng, teng = pair
    tb, jb = batches(data)[kind], batches(data, japi)[kind]
    for hard_all in (True, False):
        ok = teng.index.survivor_mask(tb, hard_all)
        np.testing.assert_array_equal(ok, jeng.index.survivor_mask(jb, hard_all))
    assign = np.empty(N, np.int64)
    for pid in range(P):
        assign[teng.index._load_partition(pid).row_ids] = pid
    adm = tb.admissible(data[1])
    for b in range(tb.batch_size):
        assert ok.shape == (NQ, P)
        assert teng.index.survivor_mask(tb, True)[b, np.unique(assign[adm[b]])].all()


def test_probe_orders_by_centroid_score(pair, data):
    _, teng = pair
    qb = batches(data)["match"]
    probes = teng.index.probe(qb, nprobe=P, hard_all=False)
    scores = teng.index.quantizer.scores(qb.vectors).numpy()
    np.testing.assert_array_equal(probes, np.argsort(scores, axis=1, kind="stable"))


# ---------------------------------------------------------------------------
# (f) planner and executor
# ---------------------------------------------------------------------------


def test_plans_partitioned_with_sqrt_p_and_clamps(pair, data):
    _, teng = pair
    qb = batches(data)["match"]
    plan = teng.plan(qb, tapi.SearchParams(k=K))
    assert plan.backend == "partitioned" and plan.nprobe == round(P ** 0.5)
    assert plan.sub_backend in ("graph", "brute")
    assert teng.plan(qb, tapi.SearchParams(nprobe=3)).nprobe == 3
    assert teng.plan(qb, tapi.SearchParams(nprobe=99)).nprobe == P
    assert teng.plan(qb, tapi.SearchParams(sub_backend="graph")).sub_backend == "graph"
    plan = teng.plan(qb, tapi.SearchParams(sub_backend="brute"))
    assert plan.sub_backend == "brute" and plan.routing_cfg is None
    # brute sub-scans have no sq8 path, like the flat brute backend
    assert plan.quant_mode == "pq"


def test_backend_validation(pair, flat_and_part, data):
    _, teng = pair
    qb = batches(data)["match"]
    with pytest.raises(ValueError, match="unavailable on a partitioned"):
        teng.plan(qb, tapi.SearchParams(backend="graph"))
    with pytest.raises(ValueError, match="needs a partitioned index"):
        flat_and_part["none"][0].plan(qb, tapi.SearchParams(backend="partitioned"))
    with pytest.raises(ValueError, match="no HELP subgraphs"):
        flat_and_part["none"][1].plan(qb, tapi.SearchParams(sub_backend="graph"))
    with pytest.raises(ValueError, match="unknown sub_backend"):
        tapi.SearchParams(sub_backend="bogus")
    with pytest.raises(ValueError, match="needs a sharded index"):
        teng.plan(qb, tapi.SearchParams(backend="sharded"))
    # a scan-only index plans the brute sub-backend
    assert flat_and_part["none"][1].plan(qb, tapi.SearchParams()).sub_backend == "brute"


def test_no_calibration_probe_on_partitioned(saved):
    eng = tapi.Engine.load(saved[0], device="cpu")
    before = tplanner.calibration_count()
    cm = eng.cost_model
    assert tplanner.calibration_count() == before
    assert cm == tplanner.default_cost_model(N)


def test_signatures_keyed_by_nprobe_and_sub_backend(saved, data):
    eng = tapi.Engine.load(saved[0], device="cpu")
    qb = batches(data)["match"]
    ex = eng.executor
    eng.search(qb, tapi.SearchParams(k=K, nprobe=2, sub_backend="brute"))
    eng.search(qb, tapi.SearchParams(k=K, nprobe=3, sub_backend="brute"))
    eng.search(qb, tapi.SearchParams(k=K, nprobe=3, sub_backend="graph"))
    assert ex.stats()["misses"] == 3
    eng.search(qb, tapi.SearchParams(k=K, nprobe=3, sub_backend="brute"))
    assert ex.stats()["hits"] == 1


@pytest.mark.parametrize("kind", ["one_of", "between"])
def test_brute_sub_backend_filters_in_kernel(pair, data, kind, monkeypatch):
    """A partitioned plan scanning with the brute sub-backend filters
    exactly inside the scan, as the flat brute backend does: no widened cut
    and no host post-filter (the executor's repair)."""
    _, teng = pair
    calls = []
    monkeypatch.setattr(type(teng), "_predicate_filter",
                        lambda self, *a, **k: calls.append(1) or a[0])
    teng.executor._cache.clear()
    p = tapi.SearchParams(k=K, nprobe=P, sub_backend="brute", enforce_equality=True)
    res = teng.search(batches(data)[kind], p)
    assert calls == [] and res.ids.shape == (NQ, K)
    teng.search(batches(data)[kind], dataclasses.replace(p, sub_backend="graph"))
    assert calls == [1]  # traversal output is post-filtered
    teng.executor._cache.clear()


def test_host_attrs_reads_the_memmap(saved, data):
    eng = tapi.Engine.load(saved[0], device="cpu")
    attrs = eng.host_attrs
    assert isinstance(attrs, np.memmap)
    np.testing.assert_array_equal(attrs, data[1])
    assert eng.host_attrs is attrs
    assert (eng.is_partitioned, eng.n_items, eng.attr_dim, eng.quant_mode, eng.has_graph) == \
        (True, N, 5, "pq", True)
    assert eng.device == torch.device("cpu")


def test_graph_sub_backend_post_filters_from_the_host_table(saved, data):
    """A partitioned index keeps its attributes on the host (a memmap): the
    post-filter gathers the candidates' rows there, uploads them for the
    device test, and its span records ``on_device`` false."""
    from repro_torch.obs.trace import Span

    eng = tapi.Engine.load(saved[0], device="cpu")
    assert eng.device_attrs is None
    qb = batches(data)["one_of"]
    with Span("query") as root:
        res = eng.search(qb, tapi.SearchParams(k=K, nprobe=P, sub_backend="graph"))
    assert root.find("filter").attrs == {"rows": NQ, "on_device": False}
    assert isinstance(eng._attrs_np, np.memmap)
    ids = res.ids.numpy()
    assert (ids[:, 0] >= 0).all()
    ok = qb.admissible_rows(data[1][np.maximum(ids, 0)], one_of_only=True)
    assert ok[ids >= 0].all()


def test_execute_span_carries_probe_attributes(saved, data):
    from repro_torch.obs.trace import Span

    eng = tapi.Engine.load(saved[0], device="cpu")
    with Span("query") as root:
        eng.search(batches(data)["one_of"], tapi.SearchParams(k=K, nprobe=2, sub_backend="brute"))
    plan = root.find("plan").attrs
    assert plan["nprobe"] == 2 and plan["sub_backend"] == "brute"
    # the probe's attribution sits in the searcher's own ``probe`` span,
    # inside the executor's ``execute``
    probe = root.find("execute").find("probe").attrs
    assert probe["partitions_scored"] == P and probe["nprobe"] == 2
    assert probe["partitions_probed"] + probe["partitions_pruned"] == 2 * NQ


def _named(span, name):
    out = [span] if span.name == name else []
    for c in span.children:
        out.extend(_named(c, name))
    return out


#: (engine, sub-backend) of each searcher loop: the exact scan, the pq scan
#: with its global rerank, the traversal
SPAN_CASES = [("none", "brute"), ("pq", "brute"), ("pq", "graph")]


def _span_engine(saved, flat_and_part, mode):
    if mode == "none":
        return flat_and_part["none"][1]
    return tapi.Engine.load(saved[0], device="cpu")


def _profiled(eng, qb, params):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obs_trace

    eng.search(qb, params)  # plan compiled outside the profile
    obs_trace.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.search(qb, params)
    kept = obs_trace.profiled_traces()
    obs_trace.PROFILED.clear()
    return res, kept, prof


@pytest.mark.parametrize("mode,sub", SPAN_CASES)
def test_profiled_partitioned_search_keeps_probe_groups_and_merge(saved, flat_and_part, data,
                                                                  mode, sub):
    """Under the profiler a partitioned search keeps one ``probe``, one
    ``group`` a probed partition with its shape, and one ``merge``, in the
    profiler's events too; the answers equal those of a search without it."""
    from repro_torch.partition.search import _batch_bucket, _groups

    eng = _span_engine(saved, flat_and_part, mode)
    qb = batches(data)["one_of"]
    params = tapi.SearchParams(k=K, nprobe=3, sub_backend=sub)
    res, kept, prof = _profiled(eng, qb, params)
    assert len(kept) == 1
    root = kept[0].root
    assert root.attrs == {"backend": "partitioned", "batch": NQ}
    (probe,) = _named(root, "probe")
    (merge,) = _named(root, "merge")
    groups = _named(root, "group")
    probes = eng.index.probe(qb, 3, sub == "brute")
    assert probe.attrs == {"partitions_scored": P, "partitions_probed": int((probes >= 0).sum()),
                           "partitions_pruned": int((probes < 0).sum()), "nprobe": 3}
    want = _groups(probes)
    assert [g.attrs["pid"] for g in groups] == list(want)
    n_rows = eng.index.summaries.n_rows
    for g in groups:
        pid, n = g.attrs["pid"], want[g.attrs["pid"]].size
        assert g.attrs == {"pid": pid, "queries": n, "bucket": _batch_bucket(n, NQ),
                           "rows_real": int(n_rows[pid]),
                           "rows": tpart.row_bucket(int(n_rows[pid]))}
        assert g.duration > 0
    execute = _named(root, "execute")[0]
    assert all(s in execute.children for s in [probe, merge, *groups])
    events = [e.name for e in prof.events()]
    assert events.count("probe") == 1 and events.count("merge") == 1
    assert events.count("group") == len(groups)
    off = eng.search(qb, params)
    assert_bit_equal(res, off, f"{mode}/{sub}")
    assert torch.equal(res.n_dist_evals, off.n_dist_evals)


@pytest.mark.parametrize("mode,sub", SPAN_CASES)
def test_unprofiled_partitioned_search_records_nothing(saved, flat_and_part, data, mode, sub,
                                                       monkeypatch):
    """Without a profiler or a sampled request the searcher's span sites
    make no span, enter no profiler record and keep nothing."""
    from repro_torch.obs import trace as obs_trace

    eng = _span_engine(saved, flat_and_part, mode)
    qb = batches(data)["one_of"]
    params = tapi.SearchParams(k=K, nprobe=3, sub_backend=sub)
    eng.search(qb, params)
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
    eng.search(qb, params)
    assert made == [] and obs_trace.profiled_traces() == []


# ---------------------------------------------------------------------------
# (g) residency under a cap
# ---------------------------------------------------------------------------


def cap_rows(eng) -> int:
    """A cap that holds every partition but the smallest: a stream that
    touches them all must evict."""
    buckets = [tpart.row_bucket(int(r)) for r in eng.index.summaries.n_rows]
    return sum(buckets) - min(buckets)


def test_peak_bounded_across_a_probe_stream(saved, data):
    eng = tapi.Engine.load(saved[0], device="cpu")
    cap = cap_rows(eng)
    eng.index.set_residency(cap)
    qb = batches(data)["match"]
    for nprobe in (1, 2, 3, 2, 1):
        eng.search(qb, tapi.SearchParams(k=K, nprobe=nprobe, sub_backend="brute"))
    st = eng.index.store.stats()
    assert st["peak_resident_rows"] <= cap and st["evictions"] > 0
    assert st["prefetch_hits"] > 0


def test_graph_sub_backend_runs_under_a_cap(saved, data):
    cap = cap_rows(tapi.Engine.load(saved[0], device="cpu"))
    eng = tapi.Engine.load(saved[0], device="cpu", residency_rows=cap)
    assert eng.index.store.cap_rows == cap
    res = eng.search(batches(data)["match"],
                     tapi.SearchParams(k=K, nprobe=P, sub_backend="graph", pool_size=32))
    assert res.ids.shape == (NQ, K) and (res.ids[:, 0] >= 0).all()
    assert eng.index.store.peak_resident_rows <= cap
    assert eng.index.store.stats()["evictions"] > 0


def test_residency_rows_rejected_on_a_flat_layout(tmp_path, data):
    f, a, _, _ = data
    path = str(tmp_path / "flat")
    tapi.Engine.build(f[:300], a[:300], build_graph=False, device="cpu").save(path)
    with pytest.raises(ValueError, match="residency_rows"):
        tapi.Engine.load(path, device="cpu", residency_rows=1024)


def test_small_partitions_scan_only(data):
    f, a, _, _ = data
    eng = tapi.Engine.build_partitioned(f[:60], a[:60], n_partitions=4, help_cfg=THelp(**HELP),
                                        device="cpu", kmeans_iters=4)
    widths = {pid: eng.index._load_partition(pid).graph.shape[1] for pid in range(4)}
    for pid, w in widths.items():
        n = int(eng.index.summaries.n_rows[pid])
        assert w == (HELP["gamma"] if n >= HELP["gamma"] + 2 else 0)
    assert 0 in widths.values()
    qb = batches(data)["match"]
    res = eng.search(qb, tapi.SearchParams(k=K, nprobe=4, sub_backend="graph", pool_size=16))
    assert res.ids.shape == (NQ, K)


# ---------------------------------------------------------------------------
# serving over a partitioned engine
# ---------------------------------------------------------------------------


def _serve_query(mod, qf, qa, i):
    v, a = qf[i % len(qf)], [int(x) for x in qa[i % len(qa)]]
    kind = KINDS[i % 4]
    if kind == "match":
        return mod.Query(v, [mod.MATCH(x) for x in a])
    if kind == "subset":
        return mod.Query(v, [mod.MATCH(a[0]), mod.MATCH(a[1]), mod.ANY, mod.ANY, mod.ANY])
    if kind == "one_of":
        return mod.Query(v, [mod.ONE_OF(a[0], (a[0] + 1) % 3), mod.MATCH(a[1]), mod.ANY,
                             mod.MATCH(a[3]), mod.MATCH(a[4])])
    return mod.Query(v, [mod.BETWEEN(0, 1), mod.MATCH(a[1]), mod.MATCH(a[2]), mod.ANY,
                         mod.MATCH(a[4])])


def test_serve_loop_matches_reference_and_solo(pair, data):
    jeng, teng = pair
    _, _, qf, qa = data

    def run(eng, mod, pkg):
        p = mod.SearchParams(k=K, backend="partitioned", nprobe=P, sub_backend="brute")
        trace = [(i * 3e-4, pkg.Request("ab"[i % 2], _serve_query(mod, qf, qa, i)))
                 for i in range(24)]
        reg = pkg.TenantRegistry(default_policy=pkg.TenantPolicy(params=p))
        resp, stats = pkg.serve_loop(eng, trace, reg, window_ms=2.0, buckets=(1, 8))
        return trace, resp, stats, p

    _, jresp, _, _ = run(jeng, japi, jserve)
    trace, tresp, tstats, p = run(teng, tapi, tserve)
    assert [type(r).__name__ for r in tresp] == [type(r).__name__ for r in jresp]
    assert all(isinstance(r, tserve.Completed) for r in tresp)
    for j, t in zip(jresp, tresp):
        assert (j.request_id, j.bucket, j.batch_fill) == (t.request_id, t.bucket, t.batch_fill)
        np.testing.assert_array_equal(t.ids, np.asarray(j.ids))
        np.testing.assert_allclose(t.dists, np.asarray(j.dists), rtol=1e-5)
    for (_, req), r in zip(trace, tresp):  # a served answer is its solo search
        alone = teng.search(tapi.QueryBatch.from_queries([req.query]), p)
        np.testing.assert_array_equal(r.ids, alone.ids[0].numpy())
        np.testing.assert_array_equal(r.dists, alone.dists[0].numpy())
    seg = tstats.registry.snapshot()["providers"]
    assert seg["segment_store_loads"] > 0 and "segment_store_peak_resident_rows" in seg


def test_server_stats_without_a_store_has_no_segment_provider(flat_and_part):
    snap = tserve.ServerStats(flat_and_part["none"][0]).registry.snapshot()
    assert not any(k.startswith("segment_store") for k in snap["providers"])


def test_cli_serves_a_partitioned_index_under_a_cap(tmp_path, capsys):
    from repro_torch.data.synthetic import make_hybrid_dataset

    ds = make_hybrid_dataset(n=2000, n_queries=32, profile="sift", attr_dim=5,
                             labels_per_dim=3, n_clusters=16, attr_cluster_corr=0.6, seed=0)
    path = str(tmp_path / "part")
    tapi.Engine.build_partitioned(ds.features, ds.attrs, n_partitions=4, device="cpu",
                                  build_graph=False).save(path)
    tlaunch.main(["--device", "cpu", "--n", "2000", "--requests", "32", "--index-dir", path,
                  "--residency-rows", "1024"])
    out = capsys.readouterr().out
    assert "[served] 32/32 completed, 0 shed" in out
    line = next(x for x in out.splitlines() if "segment store:" in x)
    assert "of 1024 resident rows" in line
    assert float(out.split("Recall@10=")[1].split()[0]) >= 0.5
