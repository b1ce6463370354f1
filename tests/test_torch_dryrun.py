"""The port's dry run (``repro_torch.launch.dryrun``) on meta tensors: the
extrapolated counts against full-depth counts, ``run_cell`` for every
family and kind of cell, the CLI's artifacts, and the meta paths of the
kernel wrappers and the two host reads.

The cells here are the reduced configs at cut shapes (the full-size cells
take the CLI about 40 s a mesh: ``--all --mesh both``), registered in place
of the real ones for ``run_cell``.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.core import graph_ops  # noqa: E402
from repro_torch.core import tree as tree_mod  # noqa: E402
from repro_torch.kernels.fm_interaction.ops import fm_interaction  # noqa: E402
from repro_torch.kernels.fused_auto.ops import fused_auto  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.build import build_cell  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

MESH = make_production_mesh()

#: cut shapes: every batch divides over the 16 data shards of the mesh
SMALL_SHAPES = {
    "lm": (ShapeCell(name="train_4k", kind="train", seq_len=64, global_batch=64),
           ShapeCell(name="prefill_32k", kind="prefill", seq_len=96, global_batch=32),
           ShapeCell(name="decode_32k", kind="decode", seq_len=80, global_batch=32)),
    "gnn": (ShapeCell(name="minibatch_lg", kind="train", n_nodes=512, n_edges=2048,
                      d_feat=16, d_out=4),),
    "recsys": (ShapeCell(name="train_batch", kind="train", global_batch=256),
               ShapeCell(name="serve_p99", kind="serve", global_batch=64),
               ShapeCell(name="retrieval_cand", kind="retrieval", global_batch=1,
                         n_candidates=4096)),
}


def small_spec(arch: str, n_layers: int = None):
    """``arch`` with its reduced config (``n_layers`` deep) and cut shapes."""
    spec = registry.get_arch(arch)
    base = spec.make_reduced()
    if n_layers:
        base = dataclasses.replace(base, n_layers=n_layers)
    if spec.family == "gnn":
        def make_config(cell=None, **kw):
            cut = dict(d_in=cell.d_feat, d_out=cell.d_out) if cell else {}
            return dataclasses.replace(base, **cut, **kw)
    else:
        def make_config(**kw):
            return dataclasses.replace(base, **kw)
    return dataclasses.replace(spec, make_config=make_config, shapes=SMALL_SHAPES[spec.family])


@pytest.fixture
def small_registry(monkeypatch):
    specs = {a: small_spec(a) for a in registry.ARCHS}
    monkeypatch.setattr(registry, "get_arch", lambda a: specs[a])
    return specs


class MetaOnly(TorchDispatchMode):
    """Fails if any op gives a tensor that is not on meta."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in dryrun._tensors(out):
            assert t.is_meta, f"{func} made a {t.device} tensor"
        return out


# ---------------------------------------------------------------------------
# The extrapolations against full-depth counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [("phi3-mini-3.8b", "train_4k"),
                                        ("phi3-mini-3.8b", "prefill_32k"),
                                        ("phi3-mini-3.8b", "decode_32k"),
                                        ("graphcast", "minibatch_lg")])
def test_corrected_costs_equal_a_full_depth_count(arch, shape):
    spec = dataclasses.replace(small_spec(arch, n_layers=4), micro_batches=2)
    cell = spec.cell(shape)
    got = dryrun.corrected_costs(spec, cell, MESH)
    full = dryrun.count_step(build_cell(spec, cell, MESH))
    assert "L=4" in got["method"]
    assert ("m=2" in got["method"]) == (cell.kind == "train" and spec.family == "lm")
    for key in ("flops", "bytes_accessed"):
        assert full[key] > 0
        assert abs(got[key] - full[key]) <= 1e-9 * full[key], key


@pytest.mark.parametrize("global_batch,depths", [(128, "{1,2}"), (64, "{3,4}")])
def test_temp_extrapolation_equals_a_full_depth_run_for_a_dense_lm(global_batch, depths):
    """From 1 and 2 layers, or from 3 and 4 where a micro-batch has 2 rows
    (a stacked (L, S, d)-shaped parameter would match an activation)."""
    spec = dataclasses.replace(small_spec("phi3-mini-3.8b", n_layers=6), micro_batches=2)
    cell = dataclasses.replace(spec.cell("train_4k"), global_batch=global_batch)
    got, how = dryrun.temp_estimate(spec, cell, MESH)
    assert how == f"extrapolated L∈{depths}→L=6"
    assert got == dryrun._temp(build_cell(spec, cell, MESH), MESH, "train") > 0


def test_replica_args_divide_the_data_dimensions():
    spec = small_spec("mixtral-8x7b")
    build = build_cell(spec, spec.cell("decode_32k"), MESH)
    params, cache, batch = dryrun.replica_args(build, MESH, "decode")
    assert params is build.abstract_args[0]
    assert tuple(cache["k"].shape) == (2, 2, 32, 2, 16)  # B 32 / 16; window 32 rows whole
    assert tuple(batch["tokens"].shape) == (2, 1)
    pod = make_production_mesh(multi_pod=True)
    gb = build_cell(small_spec("graphcast"), small_spec("graphcast").cell("minibatch_lg"), pod)
    _, _, gbatch = dryrun.replica_args(gb, pod, "train")
    assert tuple(gbatch["src"].shape) == (2048 // 32,)  # edges over (pod, data, model)
    assert tuple(gbatch["node_feats"].shape) == (512, 16)  # node states replicated


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------

RUN_CELLS = [("phi3-mini-3.8b", "train_4k"), ("phi3-mini-3.8b", "prefill_32k"),
             ("mixtral-8x7b", "decode_32k"), ("graphcast", "minibatch_lg"),
             ("dlrm-rm2", "train_batch"), ("fm", "train_batch"), ("xdeepfm", "serve_p99"),
             ("bert4rec", "serve_p99"), ("xdeepfm", "retrieval_cand"),
             ("bert4rec", "retrieval_cand")]


@pytest.mark.parametrize("mesh_kind", ["single", "pod"])
@pytest.mark.parametrize("arch,shape", RUN_CELLS)
def test_run_cell_for_each_family_and_kind(small_registry, arch, shape, mesh_kind):
    with MetaOnly():
        res = dryrun.run_cell(arch, shape, mesh_kind)
    assert res["ok"] and not res.get("skipped")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod"))
    spec = small_registry[arch]
    build = build_cell(spec, spec.cell(shape), mesh)
    mem = res["memory"]
    assert mem["argument_bytes"] == dryrun.sharded_bytes(mesh, build.abstract_args,
                                                         build.in_specs) > 0
    assert mem["per_device_total"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                       + mem["output_bytes"] - mem["alias_bytes"])
    assert mem["temp_bytes"] >= 0 and "replica" in mem["temp_method"]
    assert mem["alias_bytes"] == (mem["argument_bytes"] - dryrun.sharded_bytes(
        mesh, build.abstract_args[-1], build.in_specs[-1]) if build.donate == (0, 1)
        else dryrun.sharded_bytes(mesh, build.abstract_args[1], build.in_specs[1])
        if build.donate == (1,) else 0)
    if build.out_specs is not None and build.donate == (0, 1):  # train: params and state back
        assert mem["output_bytes"] == mem["alias_bytes"] + 8  # + the f32 loss and norm
    assert res["n_chips"] == (512 if mesh_kind == "pod" else 256)
    assert res["meta"] == build.meta
    assert res["cost"]["flops"] >= 0 and res["cost"]["bytes_accessed"] > 0
    assert res["collectives"] is None and res["hlo_ops"] is None and res["no_hlo"]
    if "flops" in res["corrected"]:
        assert res["cost"]["flops"] == res["corrected"]["flops"]
    else:
        assert res["cost"]["method"] == "counted at full depth"


def test_run_cell_records_a_skipped_cell():
    res = dryrun.run_cell("phi3-mini-3.8b", "long_500k", "single")
    assert res["ok"] and res["skipped"] and "full-attention" in res["skip_reason"]


def test_cli_writes_one_json_per_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DRYRUN_ARTIFACTS", str(tmp_path))
    assert dryrun.main(["--arch", "fm", "--shape", "serve_p99", "--mesh", "both"]) == 0
    assert dryrun.main(["--arch", "yi-34b", "--shape", "long_500k"]) == 0
    out = capsys.readouterr().out
    assert "[OK] fm × serve_p99 × single" in out and "[SKIP] yi-34b × long_500k" in out
    assert sorted(os.listdir(tmp_path)) == ["fm__serve_p99__pod.json",
                                            "fm__serve_p99__single.json",
                                            "yi-34b__long_500k__single.json"]
    res = json.loads((tmp_path / "fm__serve_p99__pod.json").read_text())
    assert res["ok"] and res["mesh"] == "pod" and res["memory"]["argument_bytes"] > 0
    assert res["cost"]["method"] == "counted at full depth"
    assert dryrun.main(["--arch", "fm", "--shape", "serve_p99", "--skip-existing"]) == 0
    assert "(exists)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# A count on real tensors equals the count on meta tensors
# ---------------------------------------------------------------------------


def materialize(build, seed: int = 0):
    """The build's arguments as CPU tensors drawn from ``seed`` (ids in
    range for every table)."""
    g = torch.Generator().manual_seed(seed)

    def draw(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g).to(t.dtype)
        if t.dtype == torch.bool:
            return torch.ones(t.shape, dtype=torch.bool)
        return torch.randint(0, 16, t.shape, generator=g, dtype=t.dtype)

    return tree_mod.tree_map(draw, build.abstract_args)


@pytest.mark.parametrize("arch,shape", [("phi3-mini-3.8b", "train_4k"),
                                        ("graphcast", "minibatch_lg"),
                                        ("dlrm-rm2", "serve_p99")])
def test_flop_count_on_real_tensors_equals_the_meta_count(arch, shape):
    spec = small_spec(arch)
    build = build_cell(spec, spec.cell(shape), MESH)
    want = dryrun.count_step(build)["flops"]
    with FlopCounterMode(display=False) as fc:
        build.step(*materialize(build))
    assert fc.get_total_flops() == want > 0


# ---------------------------------------------------------------------------
# Meta paths of the kernel wrappers and the host reads
# ---------------------------------------------------------------------------


def test_kernel_wrappers_give_shapes_on_meta_and_count_no_launch():
    before = (fused_auto.launches, fm_interaction.launches)
    out = fused_auto(torch.empty(3, 8, device="meta"),
                     torch.empty(3, 4, dtype=torch.int32, device="meta"),
                     torch.empty(50, 8, device="meta"),
                     torch.empty(50, 4, dtype=torch.int32, device="meta"))
    assert out.is_meta and tuple(out.shape) == (3, 50) and out.dtype == torch.float32
    emb = torch.empty(7, 5, 3, device="meta", requires_grad=True)
    y = fm_interaction(emb)
    assert y.is_meta and tuple(y.shape) == (7,)
    y.sum().backward()
    assert emb.grad.is_meta and tuple(emb.grad.shape) == (7, 5, 3)
    assert (fused_auto.launches, fm_interaction.launches) == before


def test_host_reads_are_skipped_on_meta():
    vals, idx = graph_ops.largest_k(torch.empty(4, 300, device="meta"), 100)
    assert vals.is_meta and tuple(vals.shape) == tuple(idx.shape) == (4, 100)
    ids = trecsys._wrap_ids(torch.empty(5, 3, dtype=torch.int32, device="meta"), 10, "meta")
    assert ids.is_meta and ids.dtype == torch.int64
    # real tensors keep the checks
    with pytest.raises(IndexError):
        trecsys._wrap_ids(torch.tensor([0, 10]), 10, "cpu")
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0]])
    assert graph_ops.largest_k(x, 1)[1].tolist() == [[1]]


def test_lm_and_gnn_abstract_params_are_meta():
    cfg = dataclasses.replace(registry.get_arch("kimi-k2-1t-a32b").make_config(), n_layers=1)
    assert all(t.is_meta for t in tree_mod.leaves(ttfm.abstract_params(cfg)))
    g = registry.get_arch("graphcast")
    assert all(t.is_meta for t in tree_mod.leaves(tgnn.abstract_params(g.make_config())))
