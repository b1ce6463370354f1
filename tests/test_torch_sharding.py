"""The port's sharded side against the reference's: the sharding specs and
cell builds on both production meshes, the argument bytes a device holds,
``all_cells`` and ``abstract_like``, the ring collectives on a CPU
``LocalMesh``, and the sharding fields of the LM and GNN configs.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names``, so its ``build_cell`` runs in process on a stand-in
mesh. What needs JAX devices (``NamedSharding.shard_shape`` on the 512-
device production meshes, the compiled argument sizes on a (2, 4) mesh,
the ring functions under ``shard_map`` on 8 devices) runs once, in one
subprocess with 512 placeholder host devices, as tests/test_distributed.py
runs its cases.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import build as jbuild  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.core import graph_ops  # noqa: E402
from repro_torch.core import tree as tree_mod  # noqa: E402
from repro_torch.distributed.collective_matmul import (  # noqa: E402
    ring_allreduce_matmul, ring_reduce_scatter_matmul,
)
from repro_torch.distributed.gnn_aggregate import ring_partitioned_aggregate  # noqa: E402
from repro_torch.distributed.sharding import NamedSharding, P, sharded_bytes  # noqa: E402
from repro_torch.launch import build as tbuild  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.recsys import embedding_lookup  # noqa: E402
from repro_torch.train import optim as optim_mod  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("single", "pod")
CELLS = [(a, c) for a, c in registry.all_cells() if not registry.get_arch(a).cell(c).skipped]
#: the reduced cells the compiled argument sizes are read at
SMALL_LM = ShapeCell(name="train_small", kind="train", seq_len=64, global_batch=16)
SMALL_RECSYS = ShapeCell(name="train_small", kind="train", global_batch=64)


def reduced_spec(reg, arch: str):
    """``arch``'s spec with ``make_config`` giving its reduced config (the
    same in both packages: overrides applied with ``dataclasses.replace``)."""
    spec = reg.get_arch(arch)
    return dataclasses.replace(
        spec, make_config=lambda **kw: dataclasses.replace(spec.make_reduced(), **kw))


def production(kind: str):
    return make_production_mesh(multi_pod=(kind == "pod"))


def stand_in(kind: str):
    """A mesh with only the two attributes the reference's specs read."""
    m = production(kind)
    return SimpleNamespace(shape=m.shape, axis_names=m.axis_names)


def ref_specs(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(k), tuple(v)) for k, v in flat]


def port_specs(tree) -> list:
    return [(path, tuple(v)) for path, v in tree_mod.flatten_with_paths(tree)]


# ---------------------------------------------------------------------------
# The reference's side that needs JAX devices: one subprocess
# ---------------------------------------------------------------------------

REF_BODY = """
import dataclasses, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ShapeCell
from repro.launch.build import build_cell
from repro.launch.mesh import make_production_mesh
from repro.distributed.sharding import shard_map, to_shardings
from repro.distributed.collective_matmul import (
    ring_allreduce_matmul, ring_reduce_scatter_matmul)
from repro.distributed.gnn_aggregate import ring_partitioned_aggregate

out_dir = sys.argv[1]
res = {"shards": {}, "compiled": {}}
for kind in ("single", "pod"):
    mesh = make_production_mesh(multi_pod=(kind == "pod"))
    for arch, shape in registry.all_cells():
        spec = registry.get_arch(arch)
        cell = spec.cell(shape)
        if cell.skipped:
            continue
        b = build_cell(spec, cell, mesh)
        leaves = jax.tree.leaves(b.abstract_args)
        specs = jax.tree.leaves(b.in_specs, is_leaf=lambda x: isinstance(x, P))
        res["shards"][f"{arch}|{shape}|{kind}"] = [
            [int(np.prod(NamedSharding(mesh, s).shard_shape(l.shape))), l.dtype.itemsize]
            for l, s in zip(leaves, specs)]

def reduced(arch):
    spec = registry.get_arch(arch)
    return dataclasses.replace(
        spec, make_config=lambda **kw: dataclasses.replace(spec.make_reduced(), **kw))

mesh8 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
for arch, cell in (
        ("phi3-mini-3.8b", ShapeCell(name="train_small", kind="train", seq_len=64,
                                     global_batch=16)),
        ("dlrm-rm2", ShapeCell(name="train_small", kind="train", global_batch=64))):
    b = build_cell(reduced(arch), cell, mesh8)
    with mesh8:
        jitted = jax.jit(b.step, in_shardings=to_shardings(mesh8, b.in_specs),
                         out_shardings=to_shardings(mesh8, b.out_specs),
                         donate_argnums=b.donate)
        compiled = jitted.lower(*b.abstract_args).compile()
    res["compiled"][arch] = int(compiled.memory_analysis().argument_size_in_bytes)

# the ring functions on the inputs of tests/test_distributed.py
ring = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("data", "model"))
rng = np.random.default_rng(0)
x = jnp.asarray(rng.normal(size=(16, 64)), jnp.float32)
w = jnp.asarray(rng.normal(size=(64, 32)), jnp.float32)
sm = lambda f, out: shard_map(f, mesh=ring, in_specs=(P(None, "model"), P("model", None)),
                              out_specs=out, check_vma=False)
y = sm(lambda a, b: ring_allreduce_matmul(a, b, "model"), P("model", None))(x, w)
z = sm(lambda a, b: ring_reduce_scatter_matmul(a, b, "model"), P("model", None))(x, w)
rng = np.random.default_rng(0)
n_nodes, e, d = 64, 512, 16
msgs = jnp.asarray(rng.normal(size=(e, d)), jnp.float32)
dst = jnp.asarray(rng.integers(0, n_nodes, (e,)), jnp.int32)
agg = shard_map(lambda m, dd: ring_partitioned_aggregate(m, dd, n_nodes, "model"),
                mesh=ring, in_specs=(P("model", None), P("model")),
                out_specs=P("model", None), check_vma=False)(msgs, dst)
np.savez(os.path.join(out_dir, "ring.npz"), x=np.asarray(x), w=np.asarray(w),
         allreduce=np.asarray(y), reduce_scatter=np.asarray(z), msgs=np.asarray(msgs),
         dst=np.asarray(dst), aggregate=np.asarray(agg))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_sharding")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_BODY), str(out)],
                          env=env, capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-3000:]}"
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["ring"] = dict(np.load(out / "ring.npz"))
    return res


# ---------------------------------------------------------------------------
# Registry, meshes, abstract_like
# ---------------------------------------------------------------------------


def test_all_cells_equals_the_reference():
    assert registry.all_cells() == jregistry.all_cells()
    assert len(registry.all_cells()) == 40 and len(CELLS) == 36


def test_production_and_local_meshes_name_their_axes():
    single, pod = production("single"), production("pod")
    assert single.shape == {"data": 16, "model": 16} and single.axis_names == ("data", "model")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod.axis_names == ("pod", "data", "model")
    local = make_local_mesh(2, 4, devices=["cpu"])
    assert local.axis_names == ("data", "model") and local.shape == {"data": 2, "model": 4}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "graphcast", "bert4rec", "dlrm-rm2"])
def test_abstract_like_gives_the_reference_shapes(arch):
    spec, jspec = registry.get_arch(arch), jregistry.get_arch(arch)
    cfg, jcfg = spec.make_reduced(), jspec.make_reduced()
    port_mod, ref_mod = {"lm": (ttfm, jtfm), "gnn": (tgnn, jgnn),
                         "recsys": (trecsys, jrecsys)}[spec.family]
    got = common.abstract_like(lambda: port_mod.init_params(cfg, 0, device="cpu"))
    want = jax.eval_shape(lambda: ref_mod.init_params(jcfg, jax.random.PRNGKey(0)))
    got_flat = tree_mod.flatten_with_paths(got)
    want_flat = [(jax.tree_util.keystr(k), v) for k, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(got_flat) == len(want_flat)
    for (path, t), (_, w) in zip(got_flat, want_flat):
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(w.shape), path
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path


# ---------------------------------------------------------------------------
# Cell builds: specs, meta and argument bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_and_meta_equal_the_reference(arch, shape, mesh_kind):
    spec, jspec = registry.get_arch(arch), jregistry.get_arch(arch)
    got = tbuild.build_cell(spec, spec.cell(shape), production(mesh_kind))
    want = jbuild.build_cell(jspec, jspec.cell(shape), stand_in(mesh_kind))
    assert [v for _, v in port_specs(got.in_specs)] == [v for _, v in ref_specs(want.in_specs)]
    if want.out_specs is None:
        assert got.out_specs is None
    else:
        assert [v for _, v in port_specs(got.out_specs)] == \
            [v for _, v in ref_specs(want.out_specs)]
    assert got.meta == want.meta
    assert got.donate == want.donate
    # the arguments: the reference's shapes and dtypes, leaf for leaf
    want_args = jax.tree.leaves(want.abstract_args)
    got_args = tree_mod.flatten_with_paths(got.abstract_args)
    assert [tuple(t.shape) for _, t in got_args] == [tuple(w.shape) for w in want_args]
    assert all(t.is_meta for _, t in got_args)
    for (path, t), w in zip(got_args, want_args):
        assert t.element_size() == w.dtype.itemsize or promoted(spec, path, t), path


def promoted(spec, path: str, t) -> bool:
    """A bf16 LM parameter among the stacked attention and FFN weights
    (a serving cell's, or kimi-k2's, whose config is bf16), which the
    reference's ``init_params`` draws in bf16 and then divides by an
    ``np.sqrt`` (a float64 scalar, not weakly typed), so they come out
    f32; the port keeps them in the config's dtype, as the reference's
    ``build_cell`` means them ("serving checkpoints are bf16")."""
    names = path.split("/")
    return (spec.family == "lm" and t.dtype == torch.bfloat16 and names[:2] == ["0", "layers"]
            and names[2] in ("attn", "ffn") and names[-1] != "router")


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_the_reference_shard_shapes(ref, arch, shape, mesh_kind):
    """A device's shard of each argument has the reference's element count
    (``NamedSharding.shard_shape`` on the 512-device mesh), and the bytes
    summed are the reference's but for the weights ``promoted`` names."""
    spec = registry.get_arch(arch)
    mesh = production(mesh_kind)
    got = tbuild.build_cell(spec, spec.cell(shape), mesh)
    want = ref["shards"][f"{arch}|{shape}|{mesh_kind}"]
    leaves = tree_mod.flatten_with_paths(got.abstract_args)
    specs = tree_mod.leaves(got.in_specs)
    numel = [int(np.prod(NamedSharding(mesh, s).shard_shape(t.shape)))
             for (_, t), s in zip(leaves, specs)]
    assert numel == [n for n, _ in want]
    assert sharded_bytes(mesh, got.abstract_args, got.in_specs) == sum(
        n * (t.element_size() if promoted(spec, path, t) else size)
        for (path, t), (n, size) in zip(leaves, want))


@pytest.mark.parametrize("arch,cell", [("phi3-mini-3.8b", SMALL_LM), ("dlrm-rm2", SMALL_RECSYS)])
def test_argument_bytes_equal_the_reference_compiled_size(ref, arch, cell):
    mesh = make_local_mesh(2, 4, devices=["cpu"])
    got = tbuild.build_cell(reduced_spec(registry, arch), cell, mesh)
    assert sharded_bytes(mesh, got.abstract_args, got.in_specs) == ref["compiled"][arch]


def test_named_sharding_shapes_split_and_join():
    mesh = make_local_mesh(2, 4, devices=["cpu"])
    t = torch.arange(8 * 16 * 3, dtype=torch.float32).reshape(8, 16, 3)
    for spec in (P("data", "model"), P(("data", "model")), P(None, ("model", "data")), P(),
                 P(None, None, None)):
        sh = NamedSharding(mesh, spec)
        pieces = sh.split(t)
        assert len(pieces) == 8
        assert all(tuple(p.shape) == sh.shard_shape(t.shape) for p in pieces)
        assert torch.equal(sh.join(pieces), t)
    # point (data 1, model 2) of P(("data", "model")): the major axis first
    assert torch.equal(NamedSharding(mesh, P(("data", "model"))).split(t)[6], t[6:7])
    with pytest.raises(ValueError, match="divide"):
        NamedSharding(mesh, P("model")).shard_shape((6, 3))
    with pytest.raises(ValueError, match="no axis"):
        NamedSharding(mesh, P("pod"))
    assert P(("data",), None) == P("data", None) == ("data", None)
    assert P((), "model") == (None, "model") and P("a")[0:1] == ("a",)


# ---------------------------------------------------------------------------
# Ring collectives on a CPU LocalMesh
# ---------------------------------------------------------------------------


def ring_inputs(ref, size: int = 8):
    mesh = make_local_mesh(1, size, devices=["cpu"])
    r = ref["ring"]
    x, w = torch.from_numpy(r["x"]), torch.from_numpy(r["w"])
    return mesh, NamedSharding(mesh, P(None, "model")).split(x), \
        NamedSharding(mesh, P("model", None)).split(w)


def plain_ring_sum(parts: list, i: int) -> torch.Tensor:
    """((p_{i+1} + p_{i+2}) + …) + p_i: shard i's order on the ring."""
    size = len(parts)
    acc = parts[(i + 1) % size]
    for s in range(2, size + 1):
        acc = acc + parts[(i + s) % size]
    return acc


def test_ring_allreduce_matmul_matches_the_reference(ref):
    mesh, xs, ws = ring_inputs(ref)
    got = ring_allreduce_matmul(mesh, xs, ws)
    want = torch.from_numpy(ref["ring"]["allreduce"])  # (8·16, 32): each shard's copy
    for i, g in enumerate(got):
        w = want[i * 16:(i + 1) * 16]
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5
    partials = [x @ w for x, w in zip(xs, ws)]
    for i, g in enumerate(got):  # the plain sum in ring order, bit for bit
        assert torch.equal(g, plain_ring_sum(partials, i))


def test_ring_reduce_scatter_matmul_matches_the_reference(ref):
    mesh, xs, ws = ring_inputs(ref)
    got = ring_reduce_scatter_matmul(mesh, xs, ws)
    want = torch.from_numpy(ref["ring"]["reduce_scatter"])
    assert [tuple(g.shape) for g in got] == [(2, 32)] * 8
    full = torch.cat(got)
    assert float((full - want).abs().max() / want.abs().max()) < 1e-5
    partials = [x @ w for x, w in zip(xs, ws)]
    for i, g in enumerate(got):
        assert torch.equal(g, plain_ring_sum([p[i * 2:(i + 1) * 2] for p in partials], i))


def aggregate_parts(mesh, msgs: torch.Tensor, dst: torch.Tensor):
    return (NamedSharding(mesh, P("model", None)).split(msgs),
            NamedSharding(mesh, P("model")).split(dst))


def test_ring_partitioned_aggregate_matches_the_reference(ref):
    r = ref["ring"]
    mesh = make_local_mesh(1, 8, devices=["cpu"])
    msgs, dst = torch.from_numpy(r["msgs"]), torch.from_numpy(r["dst"])
    got = torch.cat(ring_partitioned_aggregate(mesh, *aggregate_parts(mesh, msgs, dst), 64))
    want = torch.from_numpy(r["aggregate"])
    assert float((got - want).abs().max() / (want.abs().max() + 1e-9)) < 1e-5
    # the plain sum of the same contributions in ring order, bit for bit
    m_parts, d_parts = aggregate_parts(mesh, msgs, dst)
    rows = 8
    for j, g in enumerate(ring_partitioned_aggregate(mesh, m_parts, d_parts, 64)):
        contrib = [graph_ops.scatter_sum(m, d - j * rows, rows, dtype=torch.float32)
                   for m, d in zip(m_parts, d_parts)]
        assert torch.equal(g, plain_ring_sum(contrib, j))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_partitioned_aggregate_drops_out_of_range_ids(dtype):
    g = torch.Generator().manual_seed(3)
    n_nodes, e, d = 96, 1000, 8
    msgs = torch.randn(e, d, generator=g).to(dtype)
    dst = torch.randint(-20, n_nodes + 20, (e,), generator=g, dtype=torch.int32)
    mesh = make_local_mesh(1, 4, devices=["cpu"])
    parts = (list(msgs.chunk(4)), list(dst.chunk(4)))  # uneven edge shards are fine
    got = torch.cat(ring_partitioned_aggregate(mesh, *parts, n_nodes))
    assert got.dtype == dtype and got.shape == (n_nodes, d)
    want32 = graph_ops.scatter_sum(msgs.float(), dst, n_nodes)
    if dtype == torch.float32:
        assert float((got - want32).abs().max() / want32.abs().max()) < 1e-5
    else:  # the f32 sum rounded once: within half a bf16 step, plus f32 order
        assert bool(((got.float() - want32).abs() <= want32.abs() * 2.0**-8 + 1e-6).all())
    # ids outside [0, N) are dropped: a message to them changes nothing
    keep = (dst >= 0) & (dst < n_nodes)
    clean = torch.cat(ring_partitioned_aggregate(
        mesh, list(torch.where(keep[:, None], msgs, 0).chunk(4)),
        list(torch.where(keep, dst, 0).chunk(4)), n_nodes))
    assert torch.equal(got, clean)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_distributed.py: data-parallel step, sharded lookup
# ---------------------------------------------------------------------------


def test_data_parallel_train_step_matches_single_slice():
    spec = registry.get_arch("phi3-mini-3.8b")
    cfg = spec.make_reduced()
    params = ttfm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64)).astype(np.int32))}
    p1 = tree_mod.tree_map(torch.clone, params)
    p1, _, m1 = step_mod.make_lm_train_step(cfg, spec.optim, 1)(
        p1, optim_mod.init_state(spec.optim, p1), batch)

    mesh = make_local_mesh(8, 1, devices=["cpu"])
    sh = NamedSharding(mesh, P("data", None))
    slices = [dict(zip(batch, parts)) for parts in zip(*(sh.split(v) for v in batch.values()))]
    p2 = tree_mod.tree_map(torch.clone, params)
    per = [step_mod.loss_and_grads(partial(ttfm.loss_fn, cfg), p2, s) for s in slices]
    grads = tree_mod.tree_map(lambda *g: sum(x.float() for x in g) / len(g), *(g for _, g in per))
    loss2 = torch.stack([loss for loss, _ in per]).mean()
    p2, _, _ = optim_mod.apply_updates(spec.optim, p2, grads,
                                       optim_mod.init_state(spec.optim, p2))
    assert abs(float(m1["loss"]) - float(loss2)) < 1e-4
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_mod.leaves(p1), tree_mod.leaves(p2)))
    assert diff < 1e-3


def test_row_sharded_embedding_lookup_matches_dense():
    mesh = make_local_mesh(1, 8, devices=["cpu"])
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.normal(size=(4, 64, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (32, 4)).astype(np.int32))
    want = embedding_lookup(tables, ids)
    sh = NamedSharding(mesh, P(None, "model", None))
    shards = sh.split(tables)
    rows = sh.shard_shape(tables.shape)[1]
    got = torch.zeros_like(want)
    for s, shard in enumerate(shards):  # each shard looks up its rows; the sum reduces
        local = ids - s * rows
        mine = (local >= 0) & (local < rows)
        got += torch.where(mine[..., None], embedding_lookup(shard, local.clamp(0, rows - 1)), 0.0)
    assert float((got - want).abs().max()) < 1e-6
    assert torch.equal(sh.join(shards), tables)


# ---------------------------------------------------------------------------
# The sharding fields change no value
# ---------------------------------------------------------------------------


LM_FIELDS = {
    "dense": dict(act_dp_axes=("data",), act_seq_axis="model"),
    "moe-ep": dict(act_dp_axes=("pod", "data"), act_seq_axis="model", moe_expert_axis="model",
                   moe_capacity_axes=("pod", "data"), moe_ff_axis=None),
    "moe-tp": dict(act_dp_axes=("data",), act_seq_axis="model", moe_expert_axis=None,
                   moe_capacity_axes=("data",), moe_ff_axis="model"),
}


@pytest.mark.parametrize("case", sorted(LM_FIELDS))
def test_lm_sharding_fields_change_no_value(case):
    arch = "phi3-mini-3.8b" if case == "dense" else "mixtral-8x7b"
    cfg = registry.get_arch(arch).make_reduced()
    sharded = dataclasses.replace(cfg, **LM_FIELDS[case])
    params = ttfm.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g, dtype=torch.int32)
    assert torch.equal(ttfm.forward(sharded, params, tokens), ttfm.forward(cfg, params, tokens))
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1)}
    assert torch.equal(ttfm.loss_fn(sharded, params, batch), ttfm.loss_fn(cfg, params, batch))
    caches = [ttfm.init_cache(c, 2, 16, device="cpu") for c in (sharded, cfg)]
    for t in range(3):
        (c1, l1), (c2, l2) = (ttfm.decode_step(c, params, cache, tokens[:, t:t + 1])
                              for c, cache in zip((sharded, cfg), caches))
        assert torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])


def test_gnn_sharding_fields_change_no_value():
    cfg = registry.get_arch("graphcast").make_reduced()
    sharded = dataclasses.replace(cfg, edge_shard_axes=("data", "model"),
                                  node_shard_axes=("data", "model"))
    params = tgnn.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(30, cfg.d_in, generator=g)
    src, dst = (torch.randint(0, 30, (90,), generator=g, dtype=torch.int32) for _ in range(2))
    assert torch.equal(tgnn.forward(sharded, params, feats, src, dst),
                       tgnn.forward(cfg, params, feats, src, dst))
