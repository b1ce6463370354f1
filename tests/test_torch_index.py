"""Index construction and persistence against the reference.

One NN-descent round from the same state is bit-equal on integer-valued
features (exact scores + stable tie order). The orphan repair, vectorised
with numpy in the port, equals the reference's Python scan. A full build
on sift-profile floats tracks the reference's ψ history within 0.01 and
its recall@10 within 0.01. ``stable-single-v1`` directories load in both
directions.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset  # noqa: E402
from repro.core import auto as jauto  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import graph_ops as jg  # noqa: E402
from repro.core import help_graph as jh  # noqa: E402
from repro.core.index import StableIndex as JIndex  # noqa: E402
from repro_torch.core import auto as tauto  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import help_graph as th  # noqa: E402
from repro_torch.core.index import StableIndex as TIndex  # noqa: E402


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module")
def float_builds():
    f, a, qf, qa = dataset(n=2048, n_queries=64, integer=False, seed=4)
    jidx = JIndex.build(f, a, jh.HelpConfig(**HELP_KW))
    tidx = TIndex.build(f, a, th.HelpConfig(**HELP_KW), device="cpu")
    return jidx, tidx, qf, qa


def test_descent_round_bit_equal_on_integer_features():
    f, a, _, _ = dataset(n=2048, n_queries=4, integer=True, seed=3)
    alpha = jauto.sample_stats(f, a).alpha
    jcfg = jauto.MetricConfig(alpha=alpha)
    tcfg = tauto.MetricConfig(alpha=alpha)
    hcfg = HELP_KW  # the full build's shapes: its compiled blocks are reused
    rng = np.random.default_rng(0)
    gamma = hcfg["gamma"]
    init = rng.integers(0, len(f), (len(f), gamma)).astype(np.int32)
    jf, ja = jnp.asarray(f), jnp.asarray(a)
    d0 = jh._score_candidates(jf, ja, jnp.arange(len(f), dtype=jnp.int32), jnp.asarray(init), jcfg)
    ids, d, _ = jg.merge_pools(
        jnp.full((len(f), gamma), -1, jnp.int32), jnp.full((len(f), gamma), jg.INF),
        jnp.asarray(init), d0, gamma,
    )
    old = (rng.random((len(f), gamma)) < 0.3).astype(np.int8)  # some already expanded
    state = (np.asarray(ids), np.asarray(d), old)
    for _ in range(2):
        j = jh._descent_round(jf, ja, *map(jnp.asarray, state), jcfg, jh.HelpConfig(**hcfg))
        tt = th._descent_round(t(f), t(a), *map(t, state), tcfg, th.HelpConfig(**hcfg))
        for x, y in zip(j, tt):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        state = tuple(np.asarray(x) for x in j)


@pytest.mark.parametrize("seed", [0, 1])
def test_repair_orphans_equals_reference_scan(seed):
    rng = np.random.default_rng(seed)
    n, gamma = 300, 8
    pre = rng.integers(-1, n, (n, gamma)).astype(np.int32)
    pre_d = rng.integers(0, 5, (n, gamma)).astype(np.float32)  # many ties
    pre_d = np.sort(pre_d, 1)
    # a pruned graph that reaches only part of the nodes: many orphans
    nbr = rng.integers(0, n // 3, (n, gamma)).astype(np.int32)
    nbr[rng.random((n, gamma)) < 0.4] = -1
    nbr_d = np.where(nbr >= 0, rng.integers(0, 5, (n, gamma)), 3.0e38).astype(np.float32)
    order = np.argsort(nbr_d, 1, kind="stable")
    nbr, nbr_d = np.take_along_axis(nbr, order, 1), np.take_along_axis(nbr_d, order, 1)
    nbr[:3] = -1  # rows with no out-edge (fallback path has nothing to reverse)
    nbr_d[:3] = 3.0e38
    pre[:, :2][rng.random((n, 2)) < 0.5] = n - 1  # repeated in-edges of one node
    j = jh._repair_orphans(*map(jnp.asarray, (nbr, nbr_d, pre, pre_d)))
    tt = th._repair_orphans(*map(t, (nbr, nbr_d, pre, pre_d)))
    for x, y in zip(j, tt):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_full_build_tracks_reference(float_builds):
    jidx, tidx, qf, qa = float_builds
    assert tidx.report.rounds == jidx.report.rounds
    np.testing.assert_allclose(tidx.report.psi_history, jidx.report.psi_history, atol=0.01)
    assert abs(tidx.report.pruned_edge_fraction - jidx.report.pruned_edge_fraction) < 0.02
    assert tidx.metric_cfg == tauto.MetricConfig(**dataclasses.asdict(jidx.metric_cfg))
    for active in (None, [0, 1]):
        mask = None
        if active is not None:
            mask = np.zeros_like(qa)
            mask[:, active] = 1
        jres = jidx.search(qf, qa, k=10, mask=mask)
        jo = jbase.brute_force_hybrid(jidx.features, jidx.attrs, jnp.asarray(qf),
                                      jnp.asarray(qa), 10, None if mask is None else jnp.asarray(mask))
        tres = tidx.search(qf, qa, k=10, mask=mask)
        to = tbase.brute_force_hybrid(tidx.features, tidx.attrs, qf, qa, 10, mask)
        j_recall = jbase.recall_at_k(jres.ids, jo.ids, 10)
        t_recall = tbase.recall_at_k(tres.ids, to.ids, 10)
        assert abs(j_recall - t_recall) <= 0.01, (active, j_recall, t_recall)


def test_stable_single_v1_round_trips_both_ways(float_builds, tmp_path):
    jidx, tidx, qf, qa = float_builds
    # port → reference
    tidx.save(str(tmp_path / "port"))
    back = JIndex.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.features), tidx.features.numpy())
    np.testing.assert_array_equal(np.asarray(back.graph), tidx.graph.numpy())
    np.testing.assert_array_equal(np.asarray(back.attrs), tidx.attrs.numpy())
    assert back.quant is None
    assert dataclasses.asdict(back.metric_cfg) == dataclasses.asdict(tidx.metric_cfg)
    assert dataclasses.asdict(back.help_cfg) == dataclasses.asdict(tidx.help_cfg)
    assert dataclasses.asdict(back.stats) == dataclasses.asdict(tidx.stats)
    # reference → port
    jidx.save(str(tmp_path / "ref"))
    loaded = TIndex.load(str(tmp_path / "ref"), device="cpu", mmap=True)
    np.testing.assert_array_equal(loaded.graph.numpy(), np.asarray(jidx.graph))
    np.testing.assert_array_equal(loaded.features.numpy(), np.asarray(jidx.features))
    assert dataclasses.asdict(loaded.stats) == dataclasses.asdict(jidx.stats)
    assert loaded.metric_cfg.alpha == jidx.metric_cfg.alpha
    # port → port keeps search results
    again = TIndex.load(str(tmp_path / "port"), device="cpu")
    a = tidx.search(qf, qa, k=10)
    b = again.search(qf, qa, k=10)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.sqdists, b.sqdists)


def test_build_rejects_codecs_and_needs_a_device():
    f, a, _, _ = dataset(n=300, n_queries=2, integer=False)
    with pytest.raises(TypeError):  # a codec is a QuantConfig, not its mode name
        TIndex.build(f, a, quant_cfg="pq", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TIndex.build(f, a)  # device=None means the CUDA card


def test_graphless_build():
    f, a, qf, qa = dataset(n=300, n_queries=2, integer=False)
    idx = TIndex.build(f, a, build_graph=False, device="cpu")
    assert tuple(idx.graph.shape) == (300, 0) and idx.report is None
