"""The reference against naive NumPy loops."""
import numpy as np
import pytest
import torch

from stable_bench import datagen, reference
from stable_bench.tests.helpers import CPU, small_cell

CELLS = ["sift1m-theta243.bulk_graph", "deep1m-theta6561.bulk_graph"]


def naive_predicate(cls, a, labels):
    """Per attribute: (constrained, lo, hi, ONE_OF set or None)."""
    out = []
    for j, label in enumerate(a):
        t = cls.get("attrs", {}).get(str(j), cls["default"])
        if t == "match":
            out.append((True, label, label, None))
        elif t == "any":
            out.append((False, 0, 0, None))
        elif t[0] == "between":
            out.append((True, t[1], t[2], None))
        else:
            vals = sorted({(label + o) % labels for o in t[1:]})
            out.append((True, vals[0], vals[-1], set(vals)))
    return out


def naive_admits(pred, row):
    for (on, lo, hi, allowed), x in zip(pred, row):
        if on and not (lo <= x <= hi and (allowed is None or x in allowed)):
            return False
    return True


@pytest.fixture(scope="module", params=CELLS)
def case(request):
    cell = small_cell(request.param)
    cell.config.update(n_rows=600, n_queries=24)
    cfg, mix = cell.config, cell.mix
    d = datagen.make_data(cfg, 19, CPU)
    preds = reference.compile_predicates(mix["classes"], d.query_attrs, cfg["labels_per_dim"])
    qa = d.query_attrs.numpy()
    naive = [naive_predicate(mix["classes"][i % len(mix["classes"])], qa[i], cfg["labels_per_dim"])
             for i in range(len(qa))]
    return cell, d, preds, naive


def test_compiled_predicates(case):
    _, d, p, naive = case
    for i, pred in enumerate(naive):
        for j, (on, lo, hi, allowed) in enumerate(pred):
            assert bool(p.mask[i, j]) == on
            if on:
                assert (int(p.lo[i, j]), int(p.hi[i, j])) == (lo, hi)
            assert bool(p.hard[i, j]) == (allowed is not None)
            if allowed is not None:
                assert {int(v) for v in p.allowed[i, j] if v >= 0} == allowed


def test_admissible(case):
    _, d, p, naive = case
    got = reference.admissible(d.attrs, p).numpy()
    xa = d.attrs.numpy()
    for i, pred in enumerate(naive):
        assert [naive_admits(pred, r) for r in xa] == got[i].tolist()


def test_exact_topk(case):
    cell, d, p, naive = case
    k = 10
    ids, d2, n_adm = reference.exact_topk(d.features, d.attrs, d.query_features, p, k)
    x, q, xa = d.features.double().numpy(), d.query_features.double().numpy(), d.attrs.numpy()
    for i, pred in enumerate(naive):
        rows = [n for n in range(len(x)) if naive_admits(pred, xa[n])]
        dist = [float(((x[n] - q[i]) ** 2).sum()) for n in rows]
        best = sorted(zip(dist, rows))[:k]
        assert int(n_adm[i]) == len(rows)
        assert np.allclose(d2[i, : len(best)].numpy(), [b[0] for b in best], rtol=1e-9)
        assert ids[i, : len(best)].tolist() == [b[1] for b in best]
        assert (ids[i, len(best):] == reference.INVALID).all()


def test_alpha_and_auto_score(case):
    _, d, p, naive = case
    x, xa = d.features.double().numpy(), d.attrs.double().numpy()
    n, l = xa.shape
    idx = np.random.default_rng(0).choice(n, size=min(1000, n), replace=False)
    sv, sa = [], []
    for a in range(len(idx)):
        for b in range(a + 1, len(idx)):
            sv.append(np.sqrt(((x[idx[a]] - x[idx[b]]) ** 2).sum()))
            sa.append(np.abs(xa[idx[a]] - xa[idx[b]]).sum())
    want = reference.norm_to_unit(n / np.mean(sv)) + reference.norm_to_unit(np.mean(sa) / l)
    alpha = reference.alpha(d.features, d.attrs)
    assert alpha == pytest.approx(want, rel=1e-9)
    q = d.query_features.double().numpy()
    for i, pred in enumerate(naive[:6]):
        for n_ in range(0, len(x), 97):
            gap = sum(max(lo - xa[n_, j], xa[n_, j] - hi, 0.0)
                      for j, (on, lo, hi, _) in enumerate(pred) if on)
            want = ((x[n_] - q[i]) ** 2).sum() * (1 + gap / alpha) ** 2
            sa_t = reference.attribute_gap(d.attrs[n_], p.lo[i], p.hi[i], p.mask[i])
            got = reference.auto_sqdist(d.query_features[i], d.features[n_], sa_t, alpha)
            assert float(got) == pytest.approx(want, rel=1e-12)


def test_class_of_each_query_follows_the_mix(case):
    cell, d, p, _ = case
    mix = dict(cell.mix, calls="by_class")
    drv = cell.driver
    rows = [r for _, r in drv.groups(mix, cell.config["n_queries"])]
    assert sorted(np.concatenate(rows).tolist()) == list(range(cell.config["n_queries"]))
    assert all((r % len(mix["classes"]) == c).all() for c, r in enumerate(rows))
    whole = drv.groups(dict(mix, calls="whole_set"), cell.config["n_queries"])
    assert [n for n, _ in whole] == ["whole_set"] and whole[0][1].tolist() == list(range(cell.config["n_queries"]))
    c, pos = drv.call_rows(5, 7, rows)
    assert c == 5 % len(rows) and pos.tolist() == [(7 * (5 // len(rows)) + i) % len(rows[c]) for i in range(7)]
    # a call of the whole set takes every query once, in an order of its own
    orders = [drv.call_rows(j, "all", [whole[0][1]])[1] for j in range(3)]
    assert all(sorted(o.tolist()) == list(range(cell.config["n_queries"])) for o in orders)
    assert not (orders[0] == orders[1]).all()
    assert (orders[2] == drv.call_rows(2, "all", [whole[0][1]])[1]).all()
