"""The plain IVF reference (``reference_ivf``) against a NumPy loop, against
the program's partitioned brute search, against the exact reference at a
full probe, under hull pruning, and against a planted fault; and the
parity tool on a small cell."""
import importlib.util

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.partition import search as part_search
from stable_bench import bench, datagen, loadgen, reference, reference_ivf
from stable_bench.tests.helpers import CPU, SMALL, manifest
from stable_bench.tests.test_stable_bench_imports import BENCH, top_level_imports
from stable_bench.tests.test_stable_bench_partition_spans import IVF, small_ivf_cell
from stable_bench.tests.test_stable_bench_reference import naive_admits, naive_predicate

K = 10
P = 8
CLASSES = bench.Cell(manifest(), IVF).mix["classes"]
KINDS = [c["name"] for c in CLASSES]


def naive_ivf(f, a, qf, qa, classes, labels, centroids, assign, nprobe, k):
    """Per query, by loops: hulls, survivors, the probe, then the admitted
    rows of the probed partitions by (squared L2, row id)."""
    f, qf, c = f.astype(np.float64), qf.astype(np.float64), centroids.astype(np.float64)
    parts = [np.where(assign == p)[0] for p in range(len(c))]
    hull = [(a[r].min(0), a[r].max(0)) if r.size else None for r in parts]
    ids = np.full((len(qf), k), -1)
    d2 = np.full((len(qf), k), np.inf)
    for i in range(len(qf)):
        pred = naive_predicate(classes[i % len(classes)], qa[i], labels)
        alive = []
        for p, h in enumerate(hull):
            if h is None:
                continue
            ok = True
            for j, (on, lo, hi, allowed) in enumerate(pred):
                if not on:
                    continue
                if allowed is None:
                    ok &= bool(h[1][j] >= lo and h[0][j] <= hi)
                else:
                    ok &= any(h[0][j] <= v <= h[1][j] for v in allowed)
            if ok:
                alive.append((float(((qf[i] - c[p]) ** 2).sum()), p))
        probe = [p for _, p in sorted(alive)[:nprobe]]
        cand = sorted((float(((qf[i] - f[r]) ** 2).sum()), int(r))
                      for p in probe for r in parts[p] if naive_admits(pred, a[r]))[:k]
        for j, (d, r) in enumerate(cand):
            ids[i, j], d2[i, j] = r, d
    return ids, d2


def small_data(n_rows, n_queries, seed=2**31 + 7):
    cfg = dict(bench.Cell(manifest(), IVF).config)
    cfg.update(SMALL, n_rows=n_rows, n_queries=n_queries)
    return cfg, datagen.make_data(cfg, seed, CPU)


def test_reference_ivf_imports_nothing_of_the_program():
    names = top_level_imports(BENCH / "reference_ivf.py")
    assert "repro_torch" not in names and not names & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("nprobe", [1, 3, 6])
def test_reference_ivf_against_a_numpy_loop(nprobe):
    cfg, data = small_data(300, 40)
    labels = cfg["labels_per_dim"]
    g = torch.Generator().manual_seed(5)
    centroids = data.features[torch.randperm(300, generator=g)[:6]]
    assign = torch.cdist(data.features.double(), centroids.double()).argmin(1)
    assign[:3] = 5  # partition 5 may hold rows far from its centroid
    preds = reference.compile_predicates(CLASSES, data.query_attrs, labels)
    got = reference_ivf.topk(data.features, data.attrs, data.query_features, preds, centroids,
                             assign, nprobe, K)
    want_ids, want_d2 = naive_ivf(*(t.numpy() for t in data), CLASSES, labels,
                                  centroids.numpy(), assign.numpy(), nprobe, K)
    np.testing.assert_array_equal(got.ids.numpy(), want_ids)
    np.testing.assert_allclose(got.d2.numpy(), want_d2, rtol=1e-9)


def assignment(pidx):
    out = np.full(pidx.n_items, -1, np.int64)
    for pid in range(pidx.n_partitions):
        out[np.asarray(pidx._load_partition(pid).row_ids)] = pid
    return torch.from_numpy(out)


def build_and_search(data, cfg, nprobe, attrs=None):
    """The program's partitioned index over the data (P = 8, scan-only) and
    its brute sub-backend's answers for every query, by class."""
    f, a = data.features.numpy(), (data.attrs if attrs is None else attrs).numpy()
    eng = api.Engine.build_partitioned(f, a, P, kmeans_iters=10, build_graph=False, device=CPU)
    n_q = data.query_features.shape[0]
    groups = [np.arange(i, n_q, len(CLASSES)) for i in range(len(CLASSES))]
    batches = loadgen.group_batches(api, CLASSES, data.query_features.numpy(),
                                    data.query_attrs.numpy(), cfg["labels_per_dim"], groups)
    ids = np.full((n_q, K), -1, np.int64)
    sq = np.full((n_q, K), np.inf, np.float64)
    params = api.SearchParams(k=K, pool_size=40, backend="partitioned", nprobe=nprobe,
                              sub_backend="brute")
    for qb, rows in zip(batches, groups):
        res = eng.search(qb, params)
        ids[rows], sq[rows] = res.ids.numpy(), res.sqdists.numpy()
    return eng, torch.from_numpy(ids), torch.from_numpy(sq)


@pytest.fixture(scope="module")
def built():
    cfg, data = small_data(3000, 200)
    return cfg, data, {n: build_and_search(data, cfg, n) for n in (1, 3, P)}


def _reference(data, cfg, eng, nprobe, attrs=None):
    attrs = data.attrs if attrs is None else attrs
    preds = reference.compile_predicates(CLASSES, data.query_attrs, cfg["labels_per_dim"])
    centroids = torch.as_tensor(eng.index.quantizer.centroids)
    return preds, reference_ivf.topk(data.features, attrs, data.query_features, preds, centroids,
                                     assignment(eng.index), nprobe, K)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nprobe", [1, 3, P])
def test_program_brute_sub_backend_equals_the_reference(built, nprobe, kind):
    """Ids equal up to float ties, scores within 1e-5 relative, class by class."""
    cfg, data, runs = built
    eng, ids, sq = runs[nprobe]
    _, want = _reference(data, cfg, eng, nprobe)
    rows = torch.arange(KINDS.index(kind), data.query_features.shape[0], len(CLASSES))
    par = reference_ivf.compare(data.features, data.query_features, rows, ids[rows], want)
    assert par.differ == 0 and par.ivf_gap <= 1e-5, par
    valid = ids[rows] >= 0
    assert torch.equal(valid, want.ids[rows] >= 0)
    np.testing.assert_allclose(sq[rows][valid].numpy(), want.d2[rows][valid].numpy(), rtol=1e-5)


def test_full_probe_equals_the_exact_reference(built):
    cfg, data, runs = built
    eng = runs[P][0]
    preds, want = _reference(data, cfg, eng, P)
    ids, d2, n_adm = reference.exact_topk(data.features, data.attrs, data.query_features, preds, K)
    assert torch.equal(want.ids, ids) and torch.equal(want.d2, d2)
    assert torch.equal(want.reached, n_adm)


def test_labels_correlated_with_partitions_prune_and_the_probe_reaches_further():
    """With attribute 0 a function of the row's partition, the hulls exclude
    most partitions for a MATCH on it, so the probe skips nearer pruned
    centroids for farther survivors; the program follows the reference."""
    cfg, data = small_data(3000, 200)
    eng0, _, _ = build_and_search(data, cfg, 2)
    part = assignment(eng0.index)
    attrs = data.attrs.clone()
    attrs[:, 0] = (part % 3).to(attrs.dtype)
    eng, ids, _ = build_and_search(data, cfg, 2, attrs=attrs)
    assert torch.equal(assignment(eng.index), part)  # k-means reads only the features
    preds, want = _reference(data, cfg, eng, 2, attrs=attrs)
    alive = reference_ivf.survivors(preds, reference_ivf.hulls(attrs, part, P))
    constrained = preds.mask[:, 0]
    assert bool((alive[constrained].sum(1) < P).all())
    nearest = torch.cdist(data.query_features.double(),
                          torch.as_tensor(eng.index.quantizer.centroids).double()).argsort(1)[:, :2]
    further = (torch.sort(want.probes, 1).values != torch.sort(nearest, 1).values).any(1)
    assert int(further.sum()) > 20
    q = torch.arange(data.query_features.shape[0])
    par = reference_ivf.compare(data.features, data.query_features, q, ids, want)
    assert par.differ == 0 and par.ivf_gap <= 1e-5, par


def test_a_skipped_partition_is_caught(built, monkeypatch):
    """A searcher that skips the first probed partition of every call gives
    answers the reference holds beyond its limit."""
    cfg, data, _ = built
    groups = part_search._groups

    def skip_first(probes):
        out = groups(probes)
        out.pop(next(iter(out)))
        return out

    monkeypatch.setattr(part_search, "_groups", skip_first)
    eng, ids, _ = build_and_search(data, cfg, 3)
    _, want = _reference(data, cfg, eng, 3)
    q = torch.arange(data.query_features.shape[0])
    par = reference_ivf.compare(data.features, data.query_features, q, ids, want)
    assert par.ivf_gap > 1e-5 and par.differ > 0


def _tool():
    spec = importlib.util.spec_from_file_location("ivf_parity", BENCH / "tools" / "ivf_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_tool_on_the_small_cell():
    """The tool's run of the cell cut small: the window's answers within the
    limit of the reference, the program's probe the reference's, and the
    run judged ``correct``."""
    row = _tool().parity(small_ivf_cell(), 2**31 + 31, 0.3, CPU, api)
    assert row["correct"] and row["within"] and row["answers"] > 0
    assert row["ivf_gap"] <= row["limit"] and row["differ_share"] == 0.0
    assert row["probe_differs"] == 0
    assert row["partitions"]["bucket_rows"] >= SMALL["n_rows"]
