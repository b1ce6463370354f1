"""The port's AUTO metric against the reference: α bit-equal (it enters
every score), all five fusion modes of ``fused_sqdist_from_sv2`` over
point, interval and masked targets, and exact ``brute_topk`` on
integer-valued data (ties to the lower id, as ``lax.top_k``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import dataset  # noqa: E402
from repro.core import auto as jauto  # noqa: E402
from repro_torch.core import auto as tauto  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return dataset(n=3000, n_queries=16, integer=False)


@pytest.mark.parametrize("n_samples,seed", [(1000, 0), (300, 5)])
def test_alpha_and_stats_bit_equal(data, n_samples, seed):
    f, a, _, _ = data
    js = jauto.sample_stats(f, a, n_samples=n_samples, seed=seed)
    ts = tauto.sample_stats(f, a, n_samples=n_samples, seed=seed)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert js.alpha == ts.alpha


def test_numerical_map_matches():
    raw = np.random.default_rng(0).choice(["a", "b", "c", "z"], size=(50, 3))
    jm, jt = jauto.numerical_map(raw)
    tm, tt = tauto.numerical_map(raw)
    np.testing.assert_array_equal(jm, tm)
    q = raw[:7]
    np.testing.assert_array_equal(jauto.map_query_attrs(q, jt), tauto.map_query_attrs(q, tt))


@pytest.mark.parametrize("mode", tauto.METRIC_MODES)
@pytest.mark.parametrize("kind", ["point", "interval", "masked"])
def test_fused_sqdist_from_sv2_all_modes(mode, kind):
    rng = np.random.default_rng(3)
    b, c, l = 6, 40, 5
    sv2 = (rng.random((b, c)) * 500).astype(np.float32)
    qa = rng.integers(0, 4, (b, l)).astype(np.int32)
    xa = rng.integers(0, 4, (b, c, l)).astype(np.int32)
    other = rng.integers(0, 4, (b, l)).astype(np.int32)
    iv = np.stack([np.minimum(qa, other), np.maximum(qa, other)], -1)
    mask = rng.integers(0, 2, (b, l)).astype(np.int32)
    targets = iv if kind == "interval" else qa
    m = mask[:, None, :] if kind == "masked" else None
    jcfg = jauto.MetricConfig(mode=mode, alpha=1.37, nhq_weight=2.5)
    tcfg = tauto.MetricConfig(mode=mode, alpha=1.37, nhq_weight=2.5)
    want = np.asarray(jauto.fused_sqdist_from_sv2(
        jnp.asarray(sv2), jnp.asarray(targets)[:, None], jnp.asarray(xa), jcfg,
        None if m is None else jnp.asarray(m),
    ))
    got = tauto.fused_sqdist_from_sv2(
        torch.from_numpy(sv2), torch.from_numpy(targets)[:, None], torch.from_numpy(xa),
        tcfg, None if m is None else torch.from_numpy(m),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["auto", "l2", "additive"])
def test_brute_topk_exact_on_integer_data(mode):
    f, a, qf, qa = dataset(n=1500, n_queries=12, integer=True)
    alpha = jauto.sample_stats(f, a).alpha
    jd, ji = jauto.brute_topk(
        jnp.asarray(qf), jnp.asarray(qa), jnp.asarray(f), jnp.asarray(a), 20,
        jauto.MetricConfig(mode=mode, alpha=alpha),
    )
    td, ti = tauto.brute_topk(
        torch.from_numpy(qf), torch.from_numpy(qa), torch.from_numpy(f),
        torch.from_numpy(a), 20, tauto.MetricConfig(mode=mode, alpha=alpha),
    )
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_attribute_distance_interval_reduces_to_point():
    rng = np.random.default_rng(8)
    qa = torch.from_numpy(rng.integers(0, 5, (4, 6)).astype(np.int32))
    xa = torch.from_numpy(rng.integers(0, 5, (4, 6)).astype(np.int32))
    deg = torch.stack([qa, qa], -1)
    assert torch.equal(tauto.attribute_distance(qa, xa), tauto.attribute_distance(deg, xa))
    with pytest.raises(ValueError):
        tauto.attribute_distance(torch.zeros(4, 6, 3, dtype=torch.int32), xa)
