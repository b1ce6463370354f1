"""The port's sharded backend (``repro_torch.distributed``), its local mesh,
the index-builder CLI and the search examples, against the reference.

The reference's mesh needs eight host devices, so it runs once, in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it. On ``make_local_mesh(data=2,
model=4)`` it builds the cases of ``tests/test_distributed.py`` (:32, n =
2,048; :73, the exhaustive n = 512; :256, pq4 and opq-pq4) and those of
``tests/test_api.py:753`` (exact through the engine: MATCH, subset mask,
ONE_OF/BETWEEN; pq), saves each index and writes every result to an npz.
Every case runs on integer-valued features (``_torch_data.integerize``)
and, for the PQ family, on integer-valued codec state: the reference's
trained centroids rounded and the rows encoded again, and a permutation
as the OPQ rotation. Every score of both packages is then an exact
integer. The subprocess also loads two directories the port wrote, saves
them again and searches the exact one.

What "matches" means here (``assert_matches``): ids equal except at
near-ties (|Δd| ≤ 2·(1e-6 + 1e-5·|d|) to another returned distance),
sqdists within rtol 1e-5, and ``n_dist_evals``, ``n_code_evals`` and
``n_hops`` exactly equal. Bit parity across frameworks is not asked for.
Inside the port, ``data=1`` and ``data=2`` must give the same ids and
sqdists bit for bit, and the exhaustive case (pool ≥ shard rows) must
equal the port's own flat brute oracle. Directories cross both ways with
every array equal byte for byte, codes included.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_data import HELP_KW, dataset, integerize, predicate_batches  # noqa: E402
from repro.data.synthetic import make_hybrid_dataset  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.api import planner as tplanner, query as tquery  # noqa: E402
from repro_torch.cache import TieredEngine  # noqa: E402
from repro_torch.core import auto as tauto, routing as trouting  # noqa: E402
from repro_torch.core.help_graph import HelpConfig  # noqa: E402
from repro_torch.core.routing import RoutingConfig  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    SHARDED_META, ShardedStableIndex, is_sharded_dir, sharded_index_from_numpy,
)
from repro_torch.launch import build as tbuild, serve as tserve  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.mutable import MutableEngine  # noqa: E402
from repro_torch.quant import QuantConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mesh(data=2, model=4):
    return make_local_mesh(data, model, devices=["cpu"])


def d32_data():
    """``tests/test_distributed.py:32`` and ``tests/test_api.py:753``'s data."""
    ds = make_hybrid_dataset(n=2048, n_queries=32, profile="sift", attr_dim=5, labels_per_dim=3,
                             n_clusters=8, attr_cluster_corr=0.8, seed=5)
    return integerize(ds.features), ds.attrs, integerize(ds.query_features), ds.query_attrs


def exh_data():
    """``tests/test_distributed.py:73``'s data."""
    ds = make_hybrid_dataset(n=512, n_queries=16, profile="sift", attr_dim=4, labels_per_dim=3,
                             n_clusters=4, attr_cluster_corr=0.8, seed=6)
    return integerize(ds.features), ds.attrs, integerize(ds.query_features), ds.query_attrs


def pq4_data():
    """``tests/test_distributed.py:256``'s data."""
    ds = make_hybrid_dataset(n=2048, n_queries=16, profile="sift", attr_dim=3, labels_per_dim=3,
                             n_clusters=8, attr_cluster_corr=0.8, seed=3)
    return integerize(ds.features), ds.attrs


D32_HELP = dict(gamma=16, gamma_new=4, max_rounds=4, quality_sample=64, node_block=512)
EXH_HELP = dict(gamma=12, gamma_new=4, max_rounds=5, quality_sample=64, node_block=256)
PQ4_HELP = dict(gamma=12, gamma_new=4, max_rounds=3, quality_sample=64, node_block=512)
EXH_CFG = dict(k=10, pool_size=128, pioneer_size=16, refine_max_iters=512)

REFERENCE = r"""
import dataclasses, json, os, sys
from collections import OrderedDict
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, "tests")
import test_torch_sharded as T
from _torch_data import HELP_KW, dataset
from repro import quant as jq
from repro.api import ANY, BETWEEN, MATCH, ONE_OF, Engine, Query, QueryBatch, SearchParams
from repro.core.auto import MetricConfig, sample_stats
from repro.core.help_graph import HelpConfig
from repro.core.routing import RoutingConfig
from repro.distributed.search import ShardedStableIndex
from repro.launch.mesh import make_local_mesh

root = sys.argv[1]
mesh, mesh1 = make_local_mesh(data=2, model=4), make_local_mesh(data=1, model=4)
fsh, rep = NamedSharding(mesh, P("model", None)), NamedSharding(mesh, P())
out = {}


def record(key, res):
    for f in ("ids", "sqdists", "n_dist_evals", "n_code_evals", "n_hops"):
        out[f"{key}/{f}"] = np.asarray(getattr(res, f))


def integer_codec(idx, mode, f, **kw):
    # the reference's trained codebook, rounded, the rows encoded again; a
    # permutation stands in for the OPQ rotation
    cfg = jq.QuantConfig(mode=mode, pq_subspaces=8, **kw)
    x, rot = jnp.asarray(f), None
    if jq.has_rotation(mode):
        rot = jnp.asarray(np.eye(f.shape[1], dtype=np.float32)[
            np.random.default_rng(0).permutation(f.shape[1])])
        x = jq.rotate(x, rot)
    cb = jq.pq_train(x, n_subspaces=8, n_centroids=cfg.effective_centroids,
                     n_iters=cfg.pq_train_iters)
    cb = jq.PQCodebook(centroids=jnp.round(cb.centroids), dim=cb.dim)
    codes = jq.pq_encode(x, cb)
    if jq.is_packed_mode(mode):
        codes = jq.pack_nibbles(codes)
    return dataclasses.replace(
        idx, quant_mode=mode, codes=jax.device_put(codes, fsh),
        pq_centroids=jax.device_put(cb.centroids, rep), pq_dim=cb.dim,
        pq_rotation=None if rot is None else jax.device_put(rot, rep),
        _fn_cache=OrderedDict(), _entry_cache=OrderedDict())


def data1_hops(name, qv, qa, **kw):
    idx1 = ShardedStableIndex.load(os.path.join(root, name), mesh1)
    with mesh1:
        record(f"{name}/data1", idx1.search(qv, qa, **kw))


mc = MetricConfig(mode="auto", alpha=1.0)
params = SearchParams(k=10)

# tests/test_distributed.py:32 and tests/test_api.py:753
f, a, qf, qa = T.d32_data()
idx = ShardedStableIndex.build(mesh, f, a, mc, HelpConfig(**T.D32_HELP))
eng = Engine(idx)
batches = {
    "match": QueryBatch.match(qf, qa),
    "masked": QueryBatch.match(qf, qa, active=[0, 1]),
    "interval": QueryBatch.from_queries([
        Query(qf[i], [ONE_OF(0, 2), BETWEEN(0, 1), ANY, ANY, ANY]) for i in range(16)]),
}
with mesh:
    record("d32/legacy", idx.search(qf, qa, k=10))
    for kind, qb in batches.items():
        out[f"d32/{kind}/plan"] = np.asarray(eng.plan(qb, params).backend == "sharded")
        record(f"d32/{kind}", eng.search(qb, params))
    record("d32/enforce", eng.search(batches["match"], SearchParams(k=10, enforce_equality=True)))
eng.save(os.path.join(root, "d32"))
data1_hops("d32", qf, qa, k=10)
engq = Engine(integer_codec(idx, "pq", f, pq_train_iters=4))
with mesh:
    record("pq/match", engq.search(batches["match"], params))
    record("pq/enforce", engq.search(batches["match"], SearchParams(k=10, enforce_equality=True)))
engq.save(os.path.join(root, "pq"))
data1_hops("pq", qf, qa, k=10)

# tests/test_distributed.py:73, the exhaustive merge
f, a, qf, qa = T.exh_data()
idx = ShardedStableIndex.build(mesh, f, a, mc, HelpConfig(**T.EXH_HELP))
with mesh:
    record("exh/legacy", idx.search(qf, qa, k=10, routing_cfg=RoutingConfig(**T.EXH_CFG)))
idx.save(os.path.join(root, "exh"))

# tests/test_distributed.py:256, pq4 and opq-pq4 through the pooled rerank
f, a = T.pq4_data()
base = ShardedStableIndex.build(mesh, f, a, mc, HelpConfig(**T.PQ4_HELP))
for mode in ("pq4", "opq-pq4"):
    idx = integer_codec(base, mode, f, pq_train_iters=5, opq_iters=2)
    cfg = RoutingConfig(k=10, pool_size=40, enforce_equality=True, quant_mode=mode)
    with mesh:
        record(f"{mode}/legacy", idx.search(f[:16], a[:16], k=10))
        record(f"{mode}/enforce", idx.search(f[:16], a[:16], k=10, routing_cfg=cfg))
    idx.save(os.path.join(root, mode))
data1_hops("pq4", f[:16], a[:16], k=10)

# build parity on tests/_torch_data.py's data; the port's directories
f, a, qf, qa = dataset()
alpha = sample_stats(f, a).alpha
idx = ShardedStableIndex.build(mesh, f, a, MetricConfig(mode="auto", alpha=alpha),
                               HelpConfig(**HELP_KW))
out["build/graphs"] = np.asarray(idx.graphs)
for name in ("port_exact", "port_pq"):
    idx = ShardedStableIndex.load(os.path.join(root, name), mesh)
    idx.save(os.path.join(root, "rt_" + name))
    if name == "port_exact":
        with mesh:
            record("port_exact/legacy", idx.search(qf, qa, k=10))
np.savez(os.path.join(root, "results.npz"), **out)
print(json.dumps({"ok": True}))
"""


@pytest.fixture(scope="module")
def built():
    """The port's sharded index on ``_torch_data.dataset`` (build parity),
    exact and with a port-trained pq codec."""
    f, a, qf, qa = dataset()
    mc = tauto.MetricConfig(alpha=tauto.sample_stats(f, a).alpha)
    exact = ShardedStableIndex.build(mesh(), f, a, mc, HelpConfig(**HELP_KW))
    pq = ShardedStableIndex.build(mesh(), f, a, mc, HelpConfig(**HELP_KW),
                                  QuantConfig(mode="pq", pq_subspaces=8, pq_train_iters=3))
    return exact, pq, qf, qa


@pytest.fixture(scope="module")
def ref(built, tmp_path_factory):
    """Runs the reference once; returns (root dir, results)."""
    root = str(tmp_path_factory.mktemp("sharded"))
    built[0].save(os.path.join(root, "port_exact"))
    built[1].save(os.path.join(root, "port_pq"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), root], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["ok"]
    with np.load(os.path.join(root, "results.npz")) as z:
        return root, dict(z)


def assert_matches(res, out, key):
    """ids equal except at near-ties, sqdists rtol 1e-5, evals and hops equal."""
    want_sq = out[f"{key}/sqdists"]
    got_sq, got_ids = res.sqdists.cpu().numpy(), res.ids.cpu().numpy()
    np.testing.assert_allclose(got_sq, want_sq, rtol=1e-5, err_msg=key)
    tie = 1e-6 + 1e-5 * np.abs(want_sq)
    for r, p in zip(*np.nonzero(got_ids != out[f"{key}/ids"])):
        near = np.abs(want_sq[r] - want_sq[r, p]) <= 2 * tie[r, p]
        near[p] = False
        assert near.any(), (key, r, p)
    for f in ("n_dist_evals", "n_code_evals", "n_hops"):
        np.testing.assert_array_equal(np.asarray(getattr(res, f).cpu()), out[f"{key}/{f}"],
                                      err_msg=f"{key}: {f}")


def assert_bit_equal(a, b):
    assert torch.equal(a.ids, b.ids) and torch.equal(a.sqdists, b.sqdists)


def load(root, name, data=2):
    return ShardedStableIndex.load(os.path.join(root, name), mesh(data))


def port_batches(qf, qa):
    return {
        "match": tquery.QueryBatch.match(qf, qa),
        "masked": tquery.QueryBatch.match(qf, qa, active=[0, 1]),
        "interval": tquery.QueryBatch.from_queries([
            tquery.Query(qf[i], [tquery.ONE_OF(0, 2), tquery.BETWEEN(0, 1), tquery.ANY,
                                 tquery.ANY, tquery.ANY]) for i in range(16)]),
    }


# ---------------------------------------------------------------------------
# Parity with the reference, on the reference's own directories
# ---------------------------------------------------------------------------


def test_build_parity_per_shard(built, ref):
    _, out = ref
    exact = built[0]
    want = out["build/graphs"]
    for s in range(4):
        np.testing.assert_array_equal(exact.shard_graphs[s].numpy(), want[s * 512:(s + 1) * 512])


@pytest.mark.parametrize("kind", ["match", "masked", "interval"])
def test_engine_search_matches_reference(ref, kind):
    root, out = ref
    eng = tapi.Engine.load(os.path.join(root, "d32"), mesh=mesh())
    _, _, qf, qa = d32_data()
    qb = port_batches(qf, qa)[kind]
    assert eng.plan(qb, tapi.SearchParams(k=10)).backend == "sharded"
    assert bool(out[f"d32/{kind}/plan"])
    assert_matches(eng.search(qb, tapi.SearchParams(k=10)), out, f"d32/{kind}")


def test_legacy_and_enforced_search_match_reference(ref):
    root, out = ref
    eng = tapi.Engine.load(os.path.join(root, "d32"), mesh=mesh())
    _, _, qf, qa = d32_data()
    assert_matches(eng.index.search(qf, qa, k=10), out, "d32/legacy")
    qb = tquery.QueryBatch.match(qf, qa)
    assert_matches(eng.search(qb, tapi.SearchParams(k=10, enforce_equality=True)), out,
                   "d32/enforce")


@pytest.mark.parametrize("enforce", [False, True])
def test_pq_engine_search_matches_reference(ref, enforce):
    root, out = ref
    eng = tapi.Engine.load(os.path.join(root, "pq"), mesh=mesh())
    assert eng.quant_mode == "pq"
    _, _, qf, qa = d32_data()
    res = eng.search(tquery.QueryBatch.match(qf, qa),
                     tapi.SearchParams(k=10, enforce_equality=enforce))
    assert bool((res.n_dist_evals <= tapi.SearchParams(k=10).effective_pool).all())
    assert_matches(res, out, "pq/enforce" if enforce else "pq/match")


@pytest.mark.parametrize("mode", ["pq4", "opq-pq4"])
@pytest.mark.parametrize("enforce", [False, True])
def test_packed_pooled_rerank_matches_reference(ref, mode, enforce):
    root, out = ref
    idx = load(root, mode)
    assert idx.quant_mode == mode and (idx.pq_rotation is not None) == (mode == "opq-pq4")
    f, a = pq4_data()
    if enforce:
        cfg = RoutingConfig(k=10, pool_size=40, enforce_equality=True, quant_mode=mode)
        res = idx.search(f[:16], a[:16], k=10, routing_cfg=cfg)
    else:
        res = idx.search(f[:16], a[:16], k=10)
        assert float(np.mean([i in res.ids[i].tolist() for i in range(16)])) >= 0.8
    assert_matches(res, out, f"{mode}/{'enforce' if enforce else 'legacy'}")


def test_exhaustive_case_matches_reference(ref):
    root, out = ref
    _, _, qf, qa = exh_data()
    res = load(root, "exh").search(qf, qa, k=10, routing_cfg=RoutingConfig(**EXH_CFG))
    assert_matches(res, out, "exh/legacy")


def test_exhaustive_merge_equals_flat_brute_oracle():
    """With pool ≥ shard rows each shard's search is exhaustive, so the
    merge must equal the port's own flat brute top-k (ids except at ties,
    sqdists bit for bit on integer data)."""
    f, a, qf, qa = exh_data()
    mc = tauto.MetricConfig(mode="auto", alpha=1.0)
    idx = ShardedStableIndex.build(mesh(), f, a, mc, HelpConfig(**EXH_HELP))
    res = idx.search(qf, qa, k=10, routing_cfg=RoutingConfig(**EXH_CFG))
    want_sq, want_ids = tauto.brute_topk(torch.from_numpy(qf), torch.from_numpy(qa),
                                         torch.from_numpy(f), torch.from_numpy(a), 10, mc)
    assert torch.equal(res.sqdists, want_sq)
    assert_matches(res, {"x/ids": want_ids.numpy(), "x/sqdists": want_sq.numpy(),
                         "x/n_dist_evals": res.n_dist_evals.numpy(),
                         "x/n_code_evals": res.n_code_evals.numpy(),
                         "x/n_hops": res.n_hops.numpy()}, "x")


# ---------------------------------------------------------------------------
# Mesh and data axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["d32", "pq", "pq4"])
def test_data_axis_bit_equal_and_hops_match_reference(ref, name):
    root, out = ref
    if name == "pq4":
        qf, qa = (x[:16] for x in pq4_data())
    else:
        _, _, qf, qa = d32_data()
    r2, r1 = load(root, name, 2).search(qf, qa, k=10), load(root, name, 1).search(qf, qa, k=10)
    assert_bit_equal(r1, r2)
    assert torch.equal(r1.n_dist_evals, r2.n_dist_evals)
    want2 = out.get(f"{name}/legacy/n_hops", out.get(f"{name}/match/n_hops"))
    assert int(r2.n_hops) == int(want2)
    assert int(r1.n_hops) == int(out[f"{name}/data1/n_hops"])


def test_mesh_shape_devices_and_wrong_model_size(ref):
    root, _ = ref
    m = mesh(2, 4)
    assert m.shape == {"data": 2, "model": 4} and set(m.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="model shards but"):
        ShardedStableIndex.load(os.path.join(root, "d32"), mesh(1, 2))
    with pytest.raises(ValueError, match="model shards but"):
        tapi.Engine.load(os.path.join(root, "d32"), mesh=mesh(2, 8))
    _, _, qf, qa = d32_data()
    with pytest.raises(ValueError, match="data blocks"):  # B = 3 over data = 2
        load(root, "d32").search(qf[:3], qa[:3], k=10)
    default = ShardedStableIndex.load(os.path.join(root, "d32"), device="cpu")
    assert default.mesh.shape == {"data": 1, "model": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_local_mesh(1, 4)


# ---------------------------------------------------------------------------
# Persistence both ways
# ---------------------------------------------------------------------------


def same_tree(a: str, b: str):
    """Every .npy under ``a`` equals its counterpart under ``b`` (dtype,
    shape and bytes); the metas agree on every key the reference reads."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs if f.endswith(".npy"))
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs if f.endswith(".npy"))
    for rel in files:
        x, y = np.load(os.path.join(a, rel)), np.load(os.path.join(b, rel))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), rel
    ma, mb = (json.load(open(os.path.join(p, SHARDED_META))) for p in (a, b))
    keys = ("format", "n_shards", "shard_rows", "metric_cfg", "quant_mode", "pq_dim")
    assert {k: ma[k] for k in keys} == {k: mb[k] for k in keys}


@pytest.mark.parametrize("name", ["d32", "pq", "exh", "pq4", "opq-pq4"])
def test_reference_dir_round_trips_through_port(ref, name, tmp_path):
    root, _ = ref
    assert is_sharded_dir(os.path.join(root, name))
    load(root, name).save(str(tmp_path / "back"))
    same_tree(os.path.join(root, name), str(tmp_path / "back"))


@pytest.mark.parametrize("name", ["port_exact", "port_pq"])
def test_port_dir_round_trips_through_reference(ref, name):
    root, _ = ref
    same_tree(os.path.join(root, name), os.path.join(root, "rt_" + name))


def test_reference_searches_port_dir_alike(built, ref):
    _, out = ref
    exact, _, qf, qa = built
    assert_matches(exact.search(qf, qa, k=10), out, "port_exact/legacy")


def test_sharded_index_from_numpy_equals_load(built, ref):
    root, _ = ref
    pq = built[1]
    handed = sharded_index_from_numpy(
        mesh(), pq.features.numpy(), pq.attrs.numpy(), pq.graphs.numpy(),
        dataclasses.asdict(pq.metric_cfg), "pq", pq.codes.numpy(),
        pq_centroids=pq.pq_centroids.numpy(), pq_dim=pq.pq_dim,
    )
    loaded = load(root, "port_pq")
    _, _, qf, qa = dataset()
    assert_bit_equal(handed.search(qf, qa, k=10), loaded.search(qf, qa, k=10))
    assert torch.equal(handed.codes, loaded.codes) and handed.codes.dtype == torch.uint8


# ---------------------------------------------------------------------------
# Engine surface (tests/test_api.py:328, :753)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(built):
    exact, pq, qf, qa = built
    return tapi.Engine(exact), tapi.Engine(pq), tquery.QueryBatch.match(qf, qa)


def test_plan_is_sharded_and_engine_equals_index(engines, built):
    eng, _, qb = engines
    plan = eng.plan(qb, tapi.SearchParams(k=10))
    assert plan.backend == "sharded" and plan.routing_cfg is not None
    assert eng.is_sharded and not eng.is_partitioned
    assert eng.n_items == 2048 and eng.attr_dim == 5 and eng.has_graph
    assert_bit_equal(eng.search(qb, tapi.SearchParams(k=10)),
                     built[0].search(qb.vectors, qb.targets, k=10))


def test_same_signature_compiles_once(engines):
    eng, _, qb = engines
    params = tapi.SearchParams(k=7, pool_size=48, seed=3)
    eng.search(qb, params)
    t0 = trouting.trace_count()
    eng.search(qb, params)
    assert trouting.trace_count() == t0


def test_cost_model_raises_on_sharded(engines):
    eng, _, _ = engines
    with pytest.raises(ValueError, match="single-host"):
        eng.cost_model

    class _Fake:  # anything that is neither flat nor partitioned
        pass

    assert tapi.Engine(_Fake()).is_sharded


def test_backend_and_quant_rules(engines, built):
    eng, engq, qb = engines
    with pytest.raises(ValueError, match="unavailable on a sharded index"):
        eng.plan(qb, tapi.SearchParams(backend="graph"))
    with pytest.raises(ValueError, match="unavailable on a sharded index"):
        eng.plan(qb, tapi.SearchParams(backend="brute"))
    with pytest.raises(ValueError, match="quant='none' on a quantized sharded"):
        engq.plan(qb, tapi.SearchParams(quant="none"))
    assert engq.plan(qb, tapi.SearchParams()).quant_mode == "pq"
    flat = tapi.Engine.build(*dataset(n=300)[:2], HelpConfig(**HELP_KW), device="cpu")
    with pytest.raises(ValueError, match="needs a sharded index"):
        flat.plan(tquery.QueryBatch.match(*dataset(n=300, n_queries=2)[2:]),
                  tapi.SearchParams(backend="sharded"))


def test_mutable_and_tiered_reject_sharded(engines):
    eng, engq, _ = engines
    with pytest.raises(ValueError, match="sharded"):
        MutableEngine(eng)
    with pytest.raises(ValueError, match="sharded"):
        TieredEngine(engq, hot_rows=64)


def test_engine_save_load_keeps_injected_cost_model(built, tmp_path):
    table = dict(unit_evals=3.0, probe_pool=32, probe_n=2048, brute_eval_cost=0.7,
                 batch_overhead=40.0, pool_intercept=5.0)
    eng = tapi.Engine(built[1], cost_model_override=tplanner.cost_model_from_table(table))
    eng.save(str(tmp_path / "e"))
    back = tapi.Engine.load(str(tmp_path / "e"), mesh=mesh(1, 4))
    assert back.cost_model == eng.cost_model
    qb = tquery.QueryBatch.match(*built[2:])
    res, want = back.search(qb, tapi.SearchParams(k=10)), eng.search(qb, tapi.SearchParams(k=10))
    assert_bit_equal(res, want)
    assert torch.equal(res.n_code_evals, want.n_code_evals)
    tapi.Engine(built[0]).save(str(tmp_path / "plain"))  # no model injected: none saved
    assert "cost_model" not in json.load(open(tmp_path / "plain" / SHARDED_META))
    with pytest.raises(ValueError, match="residency_rows"):
        tapi.Engine.load(str(tmp_path / "e"), mesh=mesh(1, 4), residency_rows=64)


def test_mesh_refused_for_unsharded_layout(tmp_path):
    f, a, _, _ = dataset(n=300, n_queries=2)
    tapi.Engine.build(f, a, HelpConfig(**HELP_KW), device="cpu").save(str(tmp_path / "flat"))
    with pytest.raises(ValueError, match="mesh= only applies"):
        tapi.Engine.load(str(tmp_path / "flat"), mesh=mesh(1, 4))


def test_predicate_batches_through_sharded_engine(engines, built):
    """Every predicate class plans sharded and keeps ONE_OF membership."""
    eng, _, _ = engines
    _, _, qf, qa = built
    a = dataset()[1]
    for kind, qb in predicate_batches(qf, qa, tquery).items():
        res = eng.search(qb, tapi.SearchParams(k=10))
        assert res.ids.shape == (len(qf), 10), kind
        if kind == "one_of":
            got = a[np.maximum(res.ids.numpy(), 0)]
            ok = ((got[..., 0] == 0) | (got[..., 0] == 2)) | (res.ids.numpy() < 0)
            assert ok.all()


# ---------------------------------------------------------------------------
# CLI and examples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,kind", [([], "flat"), (["--partitions", "4"], "partitioned"),
                                        (["--shards", "4"], "sharded")])
def test_build_cli_writes_a_loadable_engine(tmp_path, flags, kind, capsys):
    out = str(tmp_path / kind)
    tbuild.main(["--device", "cpu", "--n", "2048", "--max-rounds", "3", "--out", out] + flags)
    eng = tapi.Engine.load(out, device="cpu")
    assert eng.n_items == 2048
    assert eng.is_sharded == (kind == "sharded") and eng.is_partitioned == (kind == "partitioned")
    assert "built" in capsys.readouterr().out


def test_build_cli_shards_with_partitions_exits(tmp_path):
    with pytest.raises(SystemExit) as e:
        tbuild.main(["--device", "cpu", "--n", "2048", "--shards", "4", "--partitions", "4",
                     "--out", str(tmp_path / "x")])
    assert e.value.code not in (0, None)


def test_serve_cli_serves_a_sharded_dir(tmp_path, capsys):
    out = str(tmp_path / "sharded")
    tbuild.main(["--device", "cpu", "--n", "1024", "--max-rounds", "2", "--shards", "4",
                 "--out", out])
    tserve.main(["--device", "cpu", "--n", "1024", "--requests", "16", "--index-dir", out])
    text = capsys.readouterr().out
    assert "[served] 16/16 completed" in text and "Recall@10=" in text


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--n", "1200", "--queries", "8"]),
    ("serve_hybrid", ["--n", "1200", "--batch", "8", "--batches", "2"]),
    ("subset_query", ["--n", "1200", "--queries", "16"]),
])
def test_examples_run(name, argv, capsys):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "Recall@10" in text or "respected" in text
    if name == "subset_query":
        assert out["one_of_ok"] and out["between_ok"]
