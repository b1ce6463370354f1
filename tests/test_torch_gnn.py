"""The port's GNN (``models/gnn.py``, the four graph ops of
``core/graph_ops.py``, ``data/graph.py``, ``configs/graphcast.py``, the GNN
train and infer steps and the GNN branch of ``launch/train.py``) against the
reference on the CPU.

The reference's ``init_params`` (perturbed, so that the layers, which it
starts equal, and the biases and norm weights differ) crosses as numpy
arrays through ``params_from_numpy``; both packages run the same numpy
graphs. Tolerances, as |Δ| ≤ tol·max|ref| over a tensor:

- ``FP32``: 1e-5 (the same f32 products summed in other orders);
- ``MIXED``: 0.03, at the stated mean in-degree of 5 (64 nodes; each node
  one in-edge plus 256 random ones). The reference's ``segment_sum`` adds
  bf16 messages one at a time in bf16 on the CPU; the port sums in f32 and
  rounds once. Against the exact sum of N(0, 1) bf16 messages the
  reference lies 0.47%, 1.58% and 2.53% of max|sum| away at in-degrees 4,
  25 and 200, the port at most one bf16 rounding (≤ 0.23%)
  (``test_bf16_scatter_sum_gap_by_in_degree`` states both);
- ``MIXED`` gradients: bf16 gradients at this size lie up to 22% of a
  leaf's scale from the f32 gradient in either package (the bias sums over
  nodes, the scatter's sums), so a leaf past 0.03 of the reference's passes
  where the reference's own lies further than 0.03 from the f32 gradient
  and the port's at most twice as far as that (tests/test_torch_train.py's
  rule; the port's lies as close as the reference's or closer, but for
  one leaf 3% further);
- ``data/graph.py``: bit for bit (the same numpy draws in the same order);
- the updated parameters of a train step within 2·lr + 1e-6 (an Adam step
  moves a weight by about lr whatever the gradient's size).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; one worker per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import graphcast as jgraphcast  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import graph_ops as jops  # noqa: E402
from repro.data import graph as jgraph  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import graphcast as tgraphcast  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import graph_ops as tops  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data import graph as tgraph  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = {"FP32": 1e-5, "MIXED": 0.03}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OP_TOL = {"f32": 1e-6, "bf16": 0.03}  # the ops alone, at in-degree ≈ 6
N, E = 64, 256  # the model tests' graph: every node one in-edge plus E random ones


def perturb(tree_, rng):
    """Each leaf plus 0.3 of its spread (0.1 for a constant leaf) times
    N(0, 1), as numpy."""
    def one(a):
        a = np.asarray(a)
        s = float(a.std()) or 0.1
        return (a + 0.3 * s * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(one, tree_)


def assert_close(got, want, tol, what, atol=None, equal_nan=False):
    """max|Δ| ≤ tol·max|want| (over the finite entries), or ≤ ``atol``;
    with ``equal_nan`` the non-finite entries must match exactly."""
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    fin = np.isfinite(want)
    if equal_nan:
        np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    else:
        assert fin.all(), f"{what}: the reference is not finite"
    if not fin.any():
        return
    bound = atol if atol is not None else tol * np.abs(want[fin]).max()
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= bound, f"{what}: max|Δ| {err:.3e} > {bound:.3e}"


def assert_trees_close(got, want, tol, what, atol=None, equal_nan=False):
    for (name, g), w in zip(tree.flatten_with_paths(got), jax.tree.leaves(want), strict=True):
        assert_close(g, w, tol, f"{what} {name}", atol, equal_nan)


def assert_mixed_grads_close(got, want, want32, what):
    """Each MIXED gradient leaf within 0.03·max|ref|; past it, only where
    the reference's own bf16 gradient lies further than that from its f32
    gradient, and then the port's at most twice as far from it."""
    for (name, g), w, w32 in zip(tree.flatten_with_paths(got), jax.tree.leaves(want),
                                 jax.tree.leaves(want32), strict=True):
        g, w, w32 = g.double().numpy(), np.asarray(w, np.float64), np.asarray(w32, np.float64)
        scale = TOL["MIXED"] * np.abs(w).max()
        if np.abs(g - w).max() <= scale:
            continue
        ref_off = np.abs(w - w32).max()
        assert ref_off > scale, f"{what} {name}: max|Δ| {np.abs(g - w).max():.3e} > {scale:.3e}"
        assert np.abs(g - w32).max() <= 2.0 * ref_off, \
            f"{what} {name}: further than 2× the reference's {ref_off:.3e} from the f32 gradient"


# ---------------------------------------------------------------------------
# the four graph ops
# ---------------------------------------------------------------------------


def op_case(dtype, seed=0, n=16, e=96):
    """Messages (E + 4, 8) with integer steps of 0.5 (so maxima tie), ids
    with −1, n and n + 3 among them (dropped) and nodes n − 2, n − 1 that
    no edge reaches (empty segments); src in [0, n)."""
    rng = np.random.default_rng(seed)
    m = (rng.integers(-8, 9, (e + 4, 8)) * 0.5).astype(np.float32)
    dst = np.concatenate([rng.integers(0, n - 2, e), [-1, n, n + 3, -1]]).astype(np.int32)
    src = rng.integers(0, n, e + 4).astype(np.int32)
    up = rng.normal(size=(n, 8)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(m, jdt), jnp.asarray(dst), jnp.asarray(src), up,
            torch.tensor(m).to(tdt), torch.from_numpy(dst), torch.from_numpy(src), n)


OPS = {
    "scatter_sum": lambda ops, m, dst, src, n: ops.scatter_sum(m, dst, n),
    "scatter_max": lambda ops, m, dst, src, n: ops.scatter_max(m, dst, n),
    "scatter_mean": lambda ops, m, dst, src, n: ops.scatter_mean(m, dst, n),
    "degree_normalized_adjacency_apply":
        lambda ops, m, dst, src, n: ops.degree_normalized_adjacency_apply(m[:n], src, dst, n),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", list(OPS))
def test_graph_op_matches_reference(op, dtype):
    """Values, dtype and the gradient under a random upstream, with dropped
    ids (−1, n, n + 3), empty segments (0 for the sums and the mean, −inf
    for the max) and tied maxima (the gradient shared equally)."""
    jm, jdst, jsrc, up, tm, tdst, tsrc, n = op_case(dtype)
    if op == "degree_normalized_adjacency_apply":  # the gather's ids stay in range
        jdst, tdst = jnp.clip(jdst, 0, n - 1), tdst.clamp(0, n - 1)
    fn = OPS[op]
    want = fn(jops, jm, jdst, jsrc, n)
    x = tm.clone().requires_grad_(True)
    got = fn(tops, x, tdst, tsrc, n)
    assert str(got.dtype).rsplit(".", 1)[-1] == str(want.dtype)
    assert_close(got, want.astype(jnp.float32), OP_TOL[dtype], "value", equal_nan=True)
    if op == "scatter_max":
        assert bool(torch.isneginf(got[n - 2:]).all())

    def jloss(m):
        out = fn(jops, m, jdst, jsrc, n).astype(jnp.float32)
        return (jnp.where(jnp.isfinite(out), out, 0.0) * up).sum()

    (tg,) = torch.autograd.grad((torch.where(torch.isfinite(got.float()), got.float(), 0.0)
                                 * torch.from_numpy(up)).sum(), x)
    jg = jax.grad(jloss)(jm)
    assert_close(tg.float(), jg.astype(jnp.float32), OP_TOL[dtype], "gradient")
    if op in ("scatter_sum", "scatter_mean", "scatter_max"):
        assert float(tg[-4:].abs().max()) == 0.0  # dropped ids get no gradient


def test_scatter_max_ties_share_the_gradient():
    """Two equal maxima into one node take half of its gradient each, as
    in the reference; an integer max leaves an empty node at the lowest
    int32."""
    m = np.array([[1.0, 2.0], [1.0, 0.0], [3.0, 2.0], [5.0, 5.0]], np.float32)
    dst = np.array([0, 0, 1, -1], np.int32)
    up = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    x = torch.tensor(m, requires_grad=True)
    (g,) = torch.autograd.grad((tops.scatter_max(x, torch.from_numpy(dst), 3)[:2]
                                * torch.from_numpy(up[:2])).sum(), x)
    want = jax.grad(lambda a: (jops.scatter_max(a, jnp.asarray(dst), 3)[:2] * up[:2]).sum())(
        jnp.asarray(m))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g.numpy(), [[0.5, 2.0], [0.5, 0.0], [3.0, 4.0], [0.0, 0.0]])
    ints = tops.scatter_max(torch.tensor(m).int(), torch.from_numpy(dst), 3)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(
        jops.scatter_max(jnp.asarray(m, jnp.int32), jnp.asarray(dst), 3)))
    assert int(ints[2, 0]) == np.iinfo(np.int32).min


#: the reference's one-at-a-time bf16 sum against the exact sum, measured
#: at each in-degree on these messages (max|Δ| / max|exact|)
REF_BF16_GAP = {4: 0.00467, 25: 0.01578, 200: 0.02526}


@pytest.mark.parametrize("deg", sorted(REF_BF16_GAP))
def test_bf16_scatter_sum_gap_by_in_degree(deg):
    """N(0, 1) bf16 messages, ``deg`` into each of 64 nodes: the port's sum
    is the exact sum rounded once to bf16 (within one bf16 step, 2^-8 of
    max|sum|); the reference's lies further away the higher the in-degree
    (``REF_BF16_GAP``, to 1%), within 0.03 of the port's up to 25."""
    rng = np.random.default_rng(deg)
    n = 64
    m = jnp.asarray(rng.normal(size=(n * deg, 32)), jnp.bfloat16)
    dst = rng.permutation(np.repeat(np.arange(n), deg)).astype(np.int32)
    exact = np.zeros((n, 32))
    np.add.at(exact, dst, np.asarray(m, np.float64))
    scale = np.abs(exact).max()
    ref = np.asarray(jops.scatter_sum(m, jnp.asarray(dst), n), np.float64)
    got = tops.scatter_sum(torch.from_numpy(np.asarray(m, np.float32)).bfloat16(),
                           torch.from_numpy(dst), n)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    assert np.abs(got - exact).max() <= scale * 2.0**-8
    ref_gap = np.abs(ref - exact).max() / scale
    assert ref_gap == pytest.approx(REF_BF16_GAP[deg], rel=0.01)
    if deg <= 25:
        assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# data/graph.py, bit for bit
# ---------------------------------------------------------------------------


def assert_same_arrays(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("build_csr", [False, True])
def test_make_random_graph_equals_reference(build_csr):
    got = tgraph.make_random_graph(500, 4000, 16, 4, seed=3, build_csr=build_csr)
    want = jgraph.make_random_graph(500, 4000, 16, 4, seed=3, build_csr=build_csr)
    assert_same_arrays(got, want)
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges) == (500, 4000)


def test_make_molecule_batch_equals_reference():
    assert_same_arrays(tgraph.make_molecule_batch(8, 30, 64, 32, 1, seed=2),
                       jgraph.make_molecule_batch(8, 30, 64, 32, 1, seed=2))


def test_sample_fanout_and_subgraph_batch_equal_reference():
    """A graph with nodes no edge reaches (their samples masked out)."""
    g = tgraph.make_random_graph(3000, 2000, 12, 3, seed=4, build_csr=True)
    jg_ = jgraph.make_random_graph(3000, 2000, 12, 3, seed=4, build_csr=True)
    seeds = np.arange(40, 72)
    sub = tgraph.sample_fanout(g, seeds, (5, 3), seed=7)
    want = jgraph.sample_fanout(jg_, seeds, (5, 3), seed=7)
    assert_same_arrays(sub, want)
    assert not sub.edge_mask.all() and sub.edge_mask.any()
    got_b, want_b = tgraph.subgraph_batch(g, sub), jgraph.subgraph_batch(jg_, want)
    assert set(got_b) == set(want_b)
    for k in want_b:
        assert got_b[k].dtype == want_b[k].dtype
        np.testing.assert_array_equal(got_b[k], want_b[k], err_msg=k)


def test_sample_fanout_needs_the_csr():
    g = tgraph.make_random_graph(50, 100, 4, 2)
    with pytest.raises(AssertionError, match="build_csr"):
        tgraph.sample_fanout(g, np.arange(4), (2,))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["precision"] = {k: str(v).rsplit(".", 1)[-1].strip("'>")
                        for k, v in dataclasses.asdict(cfg.precision).items()}
    return out


def test_gnn_shapes_and_graphcast_configs_equal_the_reference():
    assert [dataclasses.asdict(c) for c in tbase.GNN_SHAPES] == \
        [dataclasses.asdict(c) for c in jbase.GNN_SHAPES]
    assert tbase._pad_to(10556, 512) == jbase._pad_to(10556, 512) == 10752
    for cell in [None, *tbase.GNN_SHAPES]:
        jcell = jbase.GNN_SHAPES[tbase.GNN_SHAPES.index(cell)] if cell else None
        t, j = tgraphcast.make_config(cell), jgraphcast.make_config(jcell)
        assert _fields(t) == _fields(j)
        assert t.param_count == j.param_count
    assert _fields(tgraphcast.make_reduced()) == _fields(jgraphcast.make_reduced())
    assert _fields(tgraphcast.make_config(None, n_layers=3)) == \
        _fields(jgraphcast.make_config(None, n_layers=3))
    spec, ref = get_arch("graphcast"), jregistry.get_arch("graphcast")
    assert spec is tgraphcast.SPEC and spec.family == ref.family == "gnn"
    assert (spec.arch_id, spec.source, spec.micro_batches) == \
        (ref.arch_id, ref.source, ref.micro_batches)
    assert dataclasses.asdict(spec.optim) == dataclasses.asdict(ref.optim)


@pytest.mark.parametrize("cell", [c.name for c in tbase.GNN_SHAPES] + ["reduced"])
def test_init_params_shapes_scales_and_count(cell):
    """Every leaf's shape and dtype equal the reference's (and
    ``abstract_params``' on meta); the count is the reference's formula plus
    the L·d norm weights it leaves out; weights uniform in ±1/√fan_in,
    each layer weight one draw repeated over L, biases 0, norms 1."""
    cfg = tgraphcast.make_reduced() if cell == "reduced" else \
        tgraphcast.make_config(tbase.GNN_SHAPES[[c.name for c in tbase.GNN_SHAPES].index(cell)])
    jcfg = jgraphcast.make_reduced() if cell == "reduced" else jgraphcast.make_config(
        jbase.GNN_SHAPES[[c.name for c in jbase.GNN_SHAPES].index(cell)])
    want = jax.eval_shape(lambda: jgnn.init_params(jcfg, jax.random.PRNGKey(0)))
    meta = tgnn.abstract_params(cfg)
    assert [(n, tuple(t.shape)) for n, t in tree.flatten_with_paths(meta)] == \
        [(n, tuple(w.shape)) for (n, _), w in zip(tree.flatten_with_paths(meta),
                                                   jax.tree.leaves(want))]
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in tree.leaves(meta))
    assert tcommon.count_params(meta) == cfg.param_count + cfg.n_layers * cfg.d_hidden
    if cell in ("reduced", "molecule"):
        p = tgnn.init_params(cfg, seed=1, device="cpu")
        for name, leaf in tree.flatten_with_paths(p):
            assert tuple(leaf.shape) == tuple(tree.flatten_with_paths(meta)[
                [n for n, _ in tree.flatten_with_paths(meta)].index(name)][1].shape)
        for k in ("we1", "we2", "wn1"):
            w = p["layers"][k]
            assert bool((w == w[0]).all()) and float(w.abs().max()) <= w.shape[1] ** -0.5
        assert float(p["encoder"]["w"].abs().max()) <= cfg.d_in ** -0.5
        assert not p["layers"]["be1"].any() and bool((p["layers"]["ln"] == 1).all())


def test_params_from_numpy_checks_keys_and_shapes_and_sharding_fields_raise():
    cfg = tgraphcast.make_reduced()
    good = jax.tree.map(np.asarray, jgnn.init_params(jgraphcast.make_reduced(),
                                                     jax.random.PRNGKey(0)))
    p = tgnn.params_from_numpy(cfg, good, device="cpu")
    assert p["layers"]["we1"].shape == (2, 64, 32)
    bad = jax.tree.map(np.copy, good)
    bad["layers"]["we1"] = bad["layers"]["we1"][:1]
    with pytest.raises(ValueError, match="we1"):
        tgnn.params_from_numpy(cfg, bad, device="cpu")
    del bad["layers"]["ln"]
    with pytest.raises(ValueError):
        tgnn.params_from_numpy(cfg, bad, device="cpu")
    for field in ("edge_shard_axes", "node_shard_axes"):
        sharded = dataclasses.replace(cfg, **{field: ("data",)})
        with pytest.raises(NotImplementedError, match="item 16.3"):
            tgnn.forward(sharded, p, torch.zeros(4, 16), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tgnn._aggregate(dataclasses.replace(cfg, aggregator="median"), torch.zeros(2, 3),
                        torch.zeros(2, dtype=torch.int32), 2)


# ---------------------------------------------------------------------------
# forward, loss, gradients, steps
# ---------------------------------------------------------------------------


def configs(prec, aggregator="sum"):
    jcfg = dataclasses.replace(jgraphcast.make_reduced(), precision=getattr(jcommon, prec),
                               aggregator=aggregator)
    tcfg = dataclasses.replace(tgraphcast.make_reduced(), precision=getattr(tcommon, prec),
                               aggregator=aggregator)
    return jcfg, tcfg


@functools.cache
def ref_params(prec):
    jcfg, _ = configs(prec)
    return perturb(jgnn.init_params(jcfg, jax.random.PRNGKey(3)), np.random.default_rng(3))


def graph_batch(seed, d_in, d_out, masks=True, isolated=0):
    """N nodes, each reached by one edge (but the last ``isolated``), plus E
    random edges among the others; with ``masks``, 20% of the edges
    masked out and 70% of the nodes in the loss."""
    rng = np.random.default_rng(seed)
    reach = N - isolated
    dst = np.concatenate([np.arange(reach), rng.integers(0, reach, E)]).astype(np.int32)
    src = rng.integers(0, N, dst.size).astype(np.int32)
    batch = {"node_feats": rng.normal(size=(N, d_in)).astype(np.float32),
             "src": src, "dst": dst,
             "targets": rng.normal(size=(N, d_out)).astype(np.float32)}
    if masks:
        batch["edge_mask"] = rng.random(dst.size) < 0.8
        batch["node_mask"] = (rng.random(N) < 0.7).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.copy(v)) for k, v in batch.items()}


def port_params(tcfg, prec):
    return tgnn.params_from_numpy(tcfg, jax.tree.map(np.copy, ref_params(prec)), device="cpu")


@pytest.mark.parametrize("masks", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_forward_loss_and_gradients_match_reference(prec, aggregator, masks):
    jcfg, tcfg = configs(prec, aggregator)
    batch = graph_batch(7, jcfg.d_in, jcfg.d_out, masks)
    jp = jax.tree.map(jnp.asarray, ref_params(prec))
    jb = jax.tree.map(jnp.asarray, batch)
    tp, tb = port_params(tcfg, prec), to_torch(batch)
    tol = TOL[prec]
    want = jgnn.forward(jcfg, jp, jb["node_feats"], jb["src"], jb["dst"], jb.get("edge_mask"))
    got = tgnn.forward(tcfg, tp, tb["node_feats"], tb["src"], tb["dst"], tb.get("edge_mask"))
    assert got.dtype == torch.float32
    assert_close(got, want, tol, "forward")
    jl, jg = jax.value_and_grad(functools.partial(jgnn.loss_fn, jcfg))(jp, jb)
    tl, tg = tstep.loss_and_grads(functools.partial(tgnn.loss_fn, tcfg), tp, tb)
    assert_close(tl, jl, tol, "loss")
    if prec == "FP32":
        assert_trees_close(tg, jg, tol, "gradient")
    else:
        jcfg32, _ = configs("FP32", aggregator)
        jg32 = jax.grad(functools.partial(jgnn.loss_fn, jcfg32))(jp, jb)
        assert_mixed_grads_close(tg, jg, jg32, "gradient")


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_max_aggregator_isolated_nodes_turn_non_finite(prec):
    """Under ``max`` a node no edge reaches aggregates −inf, and the states
    it touches turn non-finite: the same entries as the reference's, the
    finite ones within the tolerance."""
    jcfg, tcfg = configs(prec, "max")
    batch = graph_batch(8, jcfg.d_in, jcfg.d_out, masks=False, isolated=3)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = to_torch(batch)
    want = jgnn.forward(jcfg, jax.tree.map(jnp.asarray, ref_params(prec)), jb["node_feats"],
                        jb["src"], jb["dst"])
    got = tgnn.forward(tcfg, port_params(tcfg, prec), tb["node_feats"], tb["src"], tb["dst"])
    assert not np.isfinite(np.asarray(want)).all()
    assert_close(got, want, TOL[prec], "forward", equal_nan=True)


@pytest.mark.parametrize("prec", ["FP32", "MIXED"])
def test_gnn_train_and_infer_steps_match_reference(prec):
    """One ``make_gnn_train_step`` call against the reference's jitted
    step (loss, gradient norm, each parameter within 2·lr + 1e-6), then
    ``make_gnn_infer_step`` on the updated parameters against the
    reference's (under inference mode: no autograd)."""
    jcfg, tcfg = configs(prec)
    opt = get_arch("graphcast").optim
    batch = graph_batch(9, jcfg.d_in, jcfg.d_out)
    jp = jax.tree.map(jnp.asarray, ref_params(prec))
    jb = jax.tree.map(jnp.asarray, batch)
    new_p, _, metrics = jax.jit(jstep.make_gnn_train_step(jcfg, opt))(
        jp, joptim.init_state(opt, jp), jb)
    tp, tb = port_params(tcfg, prec), to_torch(batch)
    tp, _, tm = tstep.make_gnn_train_step(tcfg, opt)(tp, toptim.init_state(opt, tp), tb)
    assert_close(tm["loss"], metrics["loss"], TOL[prec], "loss")
    assert_close(tm["grad_norm"], metrics["grad_norm"], TOL[prec], "grad norm")
    assert_trees_close(tp, new_p, None, "updated param", atol=2 * opt.lr + 1e-6)
    want = jax.jit(jstep.make_gnn_infer_step(jcfg))(new_p, jb)
    got = tstep.make_gnn_infer_step(tcfg)(tp, tb)
    assert got.is_inference() and got.shape == (N, jcfg.d_out)
    assert_close(got, want, TOL[prec], "infer")


# ---------------------------------------------------------------------------
# tests/test_archs_smoke.py:56 and :79, for the port
# ---------------------------------------------------------------------------


def test_gnn_smoke():
    spec = get_arch("graphcast")
    cfg = spec.make_reduced()
    params = tgnn.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    n, e = 64, 256
    batch = {
        "node_feats": torch.tensor(rng.normal(size=(n, cfg.d_in)), dtype=torch.float32),
        "src": torch.tensor(rng.integers(0, n, (e,)), dtype=torch.int32),
        "dst": torch.tensor(rng.integers(0, n, (e,)), dtype=torch.int32),
        "edge_mask": torch.ones((e,), dtype=torch.bool),
        "targets": torch.tensor(rng.normal(size=(n, cfg.d_out)), dtype=torch.float32),
        "node_mask": torch.ones((n,), dtype=torch.float32),
    }
    out = tgnn.forward(cfg, params, batch["node_feats"], batch["src"], batch["dst"],
                       batch["edge_mask"])
    assert out.shape == (n, cfg.d_out) and bool(torch.isfinite(out).all())
    step = tstep.make_gnn_train_step(cfg, spec.optim)
    state = toptim.init_state(spec.optim, params)
    new_p, _, metrics = step(params, state, batch)
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(new_p))
    assert float(metrics["loss"]) >= 0


def test_gnn_neighbor_sampler_end_to_end():
    """The port's sampler output through the port's loss, finite and equal
    to the reference's loss on the reference's sample (FP32 1e-5)."""
    spec = get_arch("graphcast")
    g = tgraph.make_random_graph(500, 4000, d_feat=16, d_out=4, seed=0, build_csr=True)
    sub = tgraph.sample_fanout(g, np.arange(8), fanouts=(4, 3), seed=1)
    assert sub.nodes.shape == (8 + 32 + 96,)
    assert sub.src.shape == sub.dst.shape == sub.edge_mask.shape == (32 + 96,)
    batch = tgraph.subgraph_batch(g, sub)
    cfg = dataclasses.replace(spec.make_reduced(), precision=tcommon.FP32)
    jcfg = dataclasses.replace(jgraphcast.make_reduced(), precision=jcommon.FP32)
    jp = jgnn.init_params(jcfg, jax.random.PRNGKey(0))
    loss = tgnn.loss_fn(cfg, tgnn.params_from_numpy(cfg, jax.tree.map(np.array, jp), "cpu"),
                        to_torch(batch))
    assert bool(torch.isfinite(loss))
    jg_ = jgraph.make_random_graph(500, 4000, d_feat=16, d_out=4, seed=0, build_csr=True)
    jbatch = jgraph.subgraph_batch(jg_, jgraph.sample_fanout(jg_, np.arange(8), (4, 3), seed=1))
    want = jgnn.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, jbatch))
    assert_close(loss, want, TOL["FP32"], "sampled loss")


# ---------------------------------------------------------------------------
# launch/train.py's GNN branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_make_batch_fn_gnn_equals_reference(size):
    """The fixed 256-node, 1,024-edge batch of each step equals the
    reference's bit for bit (``--full-config``: 227 features)."""
    spec, jspec = get_arch("graphcast"), jregistry.get_arch("graphcast")
    cfg = spec.make_reduced() if size == "reduced" else spec.make_config(None)
    jcfg = jspec.make_reduced() if size == "reduced" else jspec.make_config(None)
    got, want = tlaunch.make_batch_fn(spec, cfg, 16, 64, "cpu"), jlaunch.make_batch_fn(
        jspec, jcfg, 16, 64)
    for s in (0, 3):
        g, w = got(s), want(s)
        assert set(g) == set(w)
        for k in w:
            assert str(g[k].dtype).rsplit(".", 1)[-1] == str(w[k].dtype)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    assert g["node_feats"].shape == (256, cfg.d_in) and g["src"].shape == (1024,)


def test_launch_train_gnn_on_cpu(tmp_path, capsys):
    """``main`` trains graphcast's reduced config on the CPU with
    checkpoints, prints its ``[done]`` line, and a second run resumes."""
    argv = ["--arch", "graphcast", "--steps", "6", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4", "--device", "cpu"]
    res = tlaunch.main(argv)
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert res.losses[-1] < res.losses[0]
    assert res.checkpoints_written == 2
    assert "[done] graphcast: loss" in capsys.readouterr().out
    res2 = tlaunch.main([*argv[:3], "8", *argv[4:]])
    assert res2.resumed_from == 6 and len(res2.losses) == 2
