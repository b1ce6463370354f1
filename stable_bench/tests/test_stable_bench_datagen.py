"""The generator: deterministic from the seed, each profile's magnitude,
features on a latent of the stated dimension."""
import pytest
import torch

from stable_bench import datagen
from stable_bench.tests.helpers import CPU, small_cell

CELLS = ["sift1m-theta243.bulk_graph", "deep1m-theta6561.bulk_graph"]


def small_config(name, **kw):
    cfg = small_cell(name).config
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_data(name):
    cfg = small_config(name)
    a = datagen.make_data(cfg, 2**31 + 11, CPU)
    b = datagen.make_data(cfg, 2**31 + 11, CPU)
    c = datagen.make_data(cfg, 2**31 + 12, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.features, c.features)
    # another seed: the same rows in another order, the same queries
    def rows(d):
        return sorted(zip(map(tuple, d.features.tolist()), map(tuple, d.attrs.tolist())))

    assert rows(a) == rows(c)
    assert torch.equal(a.query_features, c.query_features) and torch.equal(a.query_attrs, c.query_attrs)


@pytest.mark.parametrize("name", CELLS)
def test_shapes_and_labels(name):
    cfg = small_config(name)
    d = datagen.make_data(cfg, 5, CPU)
    n, q, m, l = cfg["n_rows"], cfg["n_queries"], cfg["dim"], cfg["attr_dim"]
    assert d.features.shape == (n, m) and d.query_features.shape == (q, m)
    assert d.attrs.shape == (n, l) and d.query_attrs.shape == (q, l)
    assert d.features.dtype == torch.float32 and d.attrs.dtype == torch.int32
    for a in (d.attrs, d.query_attrs):
        assert int(a.min()) == 0 and int(a.max()) == cfg["labels_per_dim"] - 1


@pytest.mark.parametrize("name", CELLS)
def test_profile_magnitude(name):
    cfg = small_config(name)
    d = datagen.make_data(cfg, 7, CPU)
    if cfg["profile"]["normalize"]:
        assert torch.allclose(d.features.norm(dim=1), torch.ones(cfg["n_rows"]), atol=1e-5)
        target = cfg["profile"]["mean_feature_dist"]
        assert abs(datagen.mean_pairwise_distance(d.features[1000:2000]) / target - 1) < 0.1
    else:
        target = cfg["profile"]["mean_feature_dist"]
        # the scale is measured on the first 1,000 rows drawn; the seed's
        # order puts any 1,000 rows first
        for part in (slice(0, 1000), slice(1000, 2000)):
            assert abs(datagen.mean_pairwise_distance(d.features[part]) / target - 1) < 0.05
        assert abs(datagen.mean_pairwise_distance(d.query_features) / target - 1) < 0.1


@pytest.mark.parametrize("r", [8, 24])
def test_features_span_the_latent(r):
    cfg = small_config(CELLS[0], latent_dim=r)
    d = datagen.make_data(cfg, 3, CPU)
    both = torch.cat([d.features, d.query_features]).double()
    assert int(torch.linalg.matrix_rank(both, rtol=1e-6)) == r
