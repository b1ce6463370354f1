"""Traversal parity over one graph: the reference builds and saves an
index, the port loads it (``StableIndex.load`` / ``index_from_numpy``) and
both search it. On integer-valued features every score is exact, so ids,
sqdists, ``n_dist_evals`` and ``n_hops`` must be equal for MATCH, subset,
ONE_OF and BETWEEN batches, with and without ``enforce_equality``. On
sift-profile floats, the port's recall@10 against its brute oracle must be
within 0.005 of the reference's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_data import HELP_KW, dataset, predicate_batches  # noqa: E402
from repro.api import query as jquery  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import routing as jr  # noqa: E402
from repro.core.help_graph import HelpConfig as JHelp  # noqa: E402
from repro.core.index import StableIndex as JIndex  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import routing as tr  # noqa: E402
from repro_torch.core.index import StableIndex as TIndex, index_from_numpy  # noqa: E402

CLASSES = ("match", "subset", "one_of", "between")


def jax_search(idx, q, cfg_kw, search=jr.search):
    return search(
        idx.features, idx.attrs, idx.graph, jnp.asarray(q.vectors), jnp.asarray(q.targets),
        idx.metric_cfg, jr.RoutingConfig(**cfg_kw),
        mask=None if q.mask is None else jnp.asarray(q.mask),
    )


def port_search(idx, q, cfg_kw, search=tr.search):
    return search(
        idx.features, idx.attrs, idx.graph, q.vectors, q.targets, idx.metric_cfg,
        tr.RoutingConfig(**cfg_kw), mask=q.mask,
    )


def assert_same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.ids), tres.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jres.sqdists), tres.sqdists.numpy())
    # XLA's CPU sqrt is not correctly rounded; the ranking scale above is exact
    np.testing.assert_allclose(np.asarray(jres.dists), tres.dists.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(jres.n_dist_evals), tres.n_dist_evals.numpy())
    assert int(jres.n_hops) == int(tres.n_hops)


@pytest.fixture(scope="module")
def int_case(tmp_path_factory):
    f, a, qf, qa = dataset(n=2048, n_queries=32, integer=True)
    jidx = JIndex.build(f, a, JHelp(**HELP_KW))
    path = str(tmp_path_factory.mktemp("jax_index"))
    jidx.save(path)
    return jidx, TIndex.load(path, device="cpu"), predicate_batches(qf, qa, jquery)


@pytest.mark.parametrize("enforce", [False, True])
@pytest.mark.parametrize("cls", CLASSES)
def test_exact_parity_on_integer_features(int_case, cls, enforce):
    jidx, tidx, batches = int_case
    kw = dict(k=10, pool_size=40, enforce_equality=enforce)
    assert_same(jax_search(jidx, batches[cls], kw), port_search(tidx, batches[cls], kw))


@pytest.mark.parametrize("variant", ["greedy_only", "two_stage", "no_visited", "fixed_coarse"])
def test_exact_parity_of_routing_variants(int_case, variant):
    jidx, tidx, batches = int_case
    q = batches["match"]
    kw = dict(k=10, pool_size=32)
    js, ts = jr.search, tr.search
    if variant == "greedy_only":
        js, ts = jr.search_greedy_only, tr.search_greedy_only
    elif variant == "two_stage":
        js, ts = jr.search_two_stage, tr.search_two_stage
    elif variant == "no_visited":
        kw["use_visited"] = False
    else:
        kw.update(coarse_fixed=True, coarse_max_iters=5)
    assert_same(jax_search(jidx, q, kw, js), port_search(tidx, q, kw, ts))


def test_entry_ids_byte_for_byte():
    for n, b, pool, seed in [(2000, 4, 40, 0), (10, 3, 32, 7)]:
        np.testing.assert_array_equal(
            np.asarray(jr.make_entry_ids(n, b, pool, seed)),
            tr.make_entry_ids(n, b, pool, seed, device="cpu").numpy(),
        )


def test_index_from_numpy_equals_load(int_case):
    jidx, tidx, batches = int_case
    built = index_from_numpy(
        np.asarray(jidx.features), np.asarray(jidx.attrs), np.asarray(jidx.graph),
        dataclasses.asdict(jidx.metric_cfg), dataclasses.asdict(jidx.help_cfg),
        dataclasses.asdict(jidx.stats), device="cpu",
    )
    assert torch.equal(built.graph, tidx.graph) and built.metric_cfg == tidx.metric_cfg
    kw = dict(k=10, pool_size=40)
    assert_same(jax_search(jidx, batches["subset"], kw), port_search(built, batches["subset"], kw))


def test_brute_oracle_exact_on_integer_features(int_case):
    jidx, tidx, batches = int_case
    for cls in ("match", "subset"):
        q = batches[cls]
        mask = None if q.mask is None else q.mask
        jres = jbase.brute_force_hybrid(
            jidx.features, jidx.attrs, jnp.asarray(q.vectors), jnp.asarray(q.attrs), 10,
            None if mask is None else jnp.asarray(mask),
        )
        tres = tbase.brute_force_hybrid(tidx.features, tidx.attrs, q.vectors, q.attrs, 10, mask)
        assert_same(jres, tres)


def test_quantized_traversal_is_not_ported(int_case):
    """A codec named in the config without a store to read codes from is
    refused, as the reference refuses it (quantized search itself is held
    to the reference in tests/test_torch_quant_search.py)."""
    _, tidx, batches = int_case
    with pytest.raises(ValueError, match="needs a quant store"):
        port_search(tidx, batches["match"], dict(k=10, pool_size=40, quant_mode="pq"))


def test_float_recall_within_half_a_point():
    f, a, qf, qa = dataset(n=2048, n_queries=64, integer=False, seed=2)
    jidx = JIndex.build(f, a, JHelp(**HELP_KW))
    tidx = index_from_numpy(
        np.asarray(jidx.features), np.asarray(jidx.attrs), np.asarray(jidx.graph),
        dataclasses.asdict(jidx.metric_cfg), dataclasses.asdict(jidx.help_cfg),
        dataclasses.asdict(jidx.stats), device="cpu",
    )
    for active in (None, [0, 1]):
        q = jquery.QueryBatch.match(qf, qa, active=active)
        kw = dict(k=10, pool_size=40)
        jres = jax_search(jidx, q, kw)
        tres = port_search(tidx, q, kw)
        jo = jbase.brute_force_hybrid(
            jidx.features, jidx.attrs, jnp.asarray(qf), jnp.asarray(qa), 10,
            None if q.mask is None else jnp.asarray(q.mask),
        )
        to = tbase.brute_force_hybrid(tidx.features, tidx.attrs, qf, qa, 10, q.mask)
        j_recall = jbase.recall_at_k(jres.ids, jo.ids, 10)
        t_recall = tbase.recall_at_k(tres.ids, to.ids, 10)
        assert abs(j_recall - t_recall) <= 0.005, (active, j_recall, t_recall)
        assert t_recall > 0.5
