"""Offline STABLE index builder:
``python -m repro_torch.launch.build --n 20000 --quant pq --out DIR``.

Builds (and optionally quantizes) an index over a synthetic hybrid dataset
and saves it for ``repro_torch.launch.serve --index-dir DIR`` (or
``Engine.load``; either package reads the directory). ``--partitions P``
builds the IVF-partitioned engine (``stable-partitioned-v1``), ``--shards
S`` a sharded engine with one HELP sub-index per model shard
(``stable-sharded-v1``, loaded back onto a mesh with S model shards). The
two are mutually exclusive. The build runs on the CUDA card unless
``--device cpu`` asks for the kernels' plain PyTorch versions.

It also holds the cell builder, as the reference's module does:
``build_cell(spec, cell, mesh)`` gives an (architecture × shape × mesh)
cell's step (``train.step``), its arguments as meta tensors (shapes and
dtypes, nothing allocated), their partition specs and the outputs'
(``distributed.sharding``), the donated arguments and the reference's
``meta`` (parameter counts and ``model_flops``). The dry run
(``launch.dryrun``) reads it on the production mesh; on a ``LocalMesh`` the
same specs split real tensors.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.build --device cpu --n 2048 \\
      --max-rounds 3 --out /tmp/flat
  PYTHONPATH=src python -m repro_torch.launch.build --n 1000000 --shards 4 \\
      --quant pq --pq-subspaces 64 --out /tmp/sharded
  PYTHONPATH=src python -m repro_torch.launch.build --n 1000000 \\
      --partitions 128 --residency-rows 180224 --out /tmp/partitioned
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.distributed import sharding as shard
from repro_torch.distributed.sharding import P
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Precision, tree_bytes
from repro_torch.train import optim as optim_mod
from repro_torch.train import step as step_mod


class CellBuild(NamedTuple):
    step: Callable  # positional-arguments step (train.step)
    abstract_args: tuple  # trees of meta tensors
    in_specs: tuple  # trees of P, the arguments' structure
    out_specs: Any  # trees of P, or None (the layout left open)
    meta: dict  # parameter counts, model_flops, notes
    donate: tuple = ()  # donated arguments (params and state; the decode cache)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _build_lm(spec: ArchSpec, cell: ShapeCell, mesh, overrides: Optional[dict] = None
              ) -> CellBuild:
    overrides = dict(overrides or {})
    micro_batches = overrides.pop("micro_batches", spec.micro_batches)
    unroll_micro = overrides.pop("unroll_micro", False)
    bx = shard.batch_axes(mesh)
    train_like = cell.kind in ("train", "prefill")
    cfg_kw = {}
    if train_like and overrides.pop("seq_shard_acts", True):
        cfg_kw = {"act_dp_axes": bx, "act_seq_axis": "model"}
    cfg: tfm.TransformerConfig = spec.make_config(**cfg_kw)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.moe:
        ep = cfg.moe.n_experts % mesh.shape["model"] == 0
        cfg = dataclasses.replace(cfg, moe_expert_axis="model" if ep else None,
                                  moe_capacity_axes=bx, moe_ff_axis=None if ep else "model")
    if cell.kind in ("prefill", "decode"):  # serving checkpoints are bf16
        cfg = dataclasses.replace(cfg, precision=Precision(param_dtype=torch.bfloat16))

    params = tfm.abstract_params(cfg)
    p_specs = shard.lm_param_specs(cfg, mesh, fsdp=(cell.kind == "train"))
    b, s = cell.global_batch, cell.seq_len
    meta = {
        "params": cfg.param_count,
        "active_params": cfg.active_param_count,
        "seq_len": s,
        "global_batch": b,
        # 6 (train) or 2 · active parameters · tokens, the embedding and
        # head included, attention's quadratic term left out
        "model_flops": tfm.model_flops(cfg, cell),
    }

    if cell.kind == "train":
        opt_state = optim_mod.abstract_state(spec.optim, params)
        o_specs = shard.opt_state_specs(spec.optim, p_specs, params)
        batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
        step = step_mod.make_lm_train_step(cfg, spec.optim, micro_batches,
                                           unroll_micro=unroll_micro)
        return CellBuild(
            step=step, abstract_args=(params, opt_state, batch),
            in_specs=(p_specs, o_specs, shard.lm_batch_specs(mesh, b)),
            out_specs=(p_specs, o_specs, {"loss": P(), "grad_norm": P()}),
            meta=meta | {"micro_batches": micro_batches}, donate=(0, 1))

    b_specs = {"tokens": P(shard.maybe(mesh, b, bx), None)}
    if cell.kind == "prefill":
        return CellBuild(
            step=step_mod.make_lm_prefill_step(cfg),
            abstract_args=(params, {"tokens": _meta((b, s), torch.int32)}),
            in_specs=(p_specs, b_specs), out_specs=None, meta=meta)

    # decode: one new token against a seq_len KV cache
    cache = tfm.abstract_cache(cfg, b, s)
    c_specs = shard.lm_cache_specs(cfg, mesh, b, seq_shard=True)
    return CellBuild(
        step=step_mod.make_lm_decode_step(cfg),
        abstract_args=(params, cache, {"tokens": _meta((b, 1), torch.int32)}),
        in_specs=(p_specs, c_specs, b_specs), out_specs=(c_specs, None),
        meta=meta | {"kv_cache_bytes": tree_bytes(cache)}, donate=(1,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _build_gnn(spec: ArchSpec, cell: ShapeCell, mesh, overrides: Optional[dict] = None
               ) -> CellBuild:
    overrides = dict(overrides or {})
    all_axes = tuple(mesh.axis_names)
    if overrides.pop("shard_activations", True):
        overrides.setdefault("edge_shard_axes", all_axes)
        if cell.n_nodes % math.prod(mesh.shape.values()) == 0:
            overrides.setdefault("node_shard_axes", all_axes)
    cfg: gnn_mod.GNNConfig = spec.make_config(cell, **overrides)
    params = gnn_mod.abstract_params(cfg)
    p_specs = shard.gnn_param_specs(cfg, mesh)
    opt_state = optim_mod.abstract_state(spec.optim, params)
    o_specs = shard.opt_state_specs(spec.optim, p_specs, params)
    n, e = cell.n_nodes, cell.n_edges
    batch = {
        "node_feats": _meta((n, cell.d_feat), torch.float32),
        "src": _meta((e,), torch.int32),
        "dst": _meta((e,), torch.int32),
        "edge_mask": _meta((e,), torch.bool),
        "targets": _meta((n, cell.d_out), torch.float32),
        "node_mask": _meta((n,), torch.float32),
    }
    d = cfg.d_hidden
    per_layer = 6 * d * d * e + 4 * d * d * n  # edge MLP (2d → d → d) + node MLP
    enc_dec = 2 * cell.d_feat * d * n + 2 * d * cell.d_out * n
    meta = {"params": cfg.param_count, "n_nodes": n, "n_edges": e,
            "model_flops": 3.0 * (cfg.n_layers * per_layer + enc_dec)}  # ×3: train
    return CellBuild(
        step=step_mod.make_gnn_train_step(cfg, spec.optim),
        abstract_args=(params, opt_state, batch),
        in_specs=(p_specs, o_specs, shard.gnn_batch_specs(mesh, e)),
        out_specs=(p_specs, o_specs, {"loss": P(), "grad_norm": P()}),
        meta=meta, donate=(0, 1))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

N_MASKED = 20  # bert4rec masked positions a sequence
N_NEG = 8192  # shared sampled-softmax negatives


def _recsys_batch(cfg: recsys_mod.RecsysConfig, b: int, train: bool) -> dict:
    if cfg.kind == "bert4rec":
        base = {"items": _meta((b, cfg.seq_len), torch.int32)}
        if train:
            base |= {"masked_pos": _meta((b, N_MASKED), torch.int32),
                     "labels": _meta((b, N_MASKED), torch.int32),
                     "neg_ids": _meta((N_NEG,), torch.int32)}
        return base
    base = {"sparse": _meta((b, cfg.n_sparse), torch.int32)}
    if cfg.n_dense:
        base["dense"] = _meta((b, cfg.n_dense), torch.float32)
    if train:
        base["labels"] = _meta((b,), torch.float32)
    return base


def _build_recsys(spec: ArchSpec, cell: ShapeCell, mesh, overrides: Optional[dict] = None
                  ) -> CellBuild:
    overrides = dict(overrides or {})
    serve_chunk = overrides.pop("serve_chunk", 4096)
    score_chunk = overrides.pop("score_chunk", 16384)
    cfg: recsys_mod.RecsysConfig = spec.make_config(**overrides)
    params = recsys_mod.abstract_params(cfg)
    p_specs = shard.recsys_param_specs(cfg, mesh, params)
    b = cell.global_batch
    # dense compute a step: embedding rows are lookups, not FLOPs
    meta = {"params": cfg.param_count, "model_flops": recsys_mod.model_flops(cfg, cell)}

    if cell.kind == "train":
        opt_state = optim_mod.abstract_state(spec.optim, params)
        o_specs = shard.opt_state_specs(spec.optim, p_specs, params)
        return CellBuild(
            step=step_mod.make_recsys_train_step(cfg, spec.optim),
            abstract_args=(params, opt_state, _recsys_batch(cfg, b, train=True)),
            in_specs=(p_specs, o_specs, shard.recsys_batch_specs(cfg, mesh, b, train=True)),
            out_specs=(p_specs, o_specs, {"loss": P(), "grad_norm": P()}),
            meta=meta, donate=(0, 1))

    if cell.kind == "serve":
        if cfg.kind == "bert4rec":
            def step(params, batch):
                return recsys_mod.bert4rec_serve_topk(cfg, params, batch["items"],
                                                      batch_chunk=serve_chunk)
        else:
            step = step_mod.make_recsys_serve_step(cfg)
        return CellBuild(
            step=step, abstract_args=(params, _recsys_batch(cfg, b, train=False)),
            in_specs=(p_specs, shard.recsys_batch_specs(cfg, mesh, b, train=False)),
            out_specs=None, meta=meta)

    # retrieval_cand: the STABLE hybrid scoring of n_candidates items
    n_cand, l_attr = cell.n_candidates, cfg.n_attr_dims
    cx = shard.maybe(mesh, n_cand, "model")
    batch = _recsys_batch(cfg, b, train=False) | {
        "query_attrs": _meta((b, l_attr), torch.int32),
        "item_embs": _meta((n_cand, cfg.embed_dim), torch.float32),
        "item_attrs": _meta((n_cand, l_attr), torch.int32),
    }
    b_specs = shard.recsys_batch_specs(cfg, mesh, b, train=False) | {
        "query_attrs": P(None, None), "item_embs": P(cx, None), "item_attrs": P(cx, None)}
    model = mesh.shape["model"]
    step = step_mod.make_recsys_retrieval_step(
        cfg, k=100, score_chunk=score_chunk,
        topk_shards=model if n_cand % model == 0 else 1)
    return CellBuild(step=step, abstract_args=(params, batch), in_specs=(p_specs, b_specs),
                     out_specs=None, meta=meta | {"n_candidates": n_cand})


def build_cell(spec: ArchSpec, cell: ShapeCell, mesh, overrides: Optional[dict] = None
               ) -> CellBuild:
    """The cell's ``CellBuild`` on ``mesh`` (anything with ``shape`` and
    ``axis_names``). ``overrides``: ``micro_batches``, ``unroll_micro``,
    ``seq_shard_acts`` (LM), ``shard_activations`` (GNN), ``serve_chunk``,
    ``score_chunk`` (recsys), and config fields."""
    if cell.skipped:
        raise ValueError(f"cell {spec.arch_id}×{cell.name} is skipped: {cell.skip_reason}")
    if spec.family == "lm":
        return _build_lm(spec, cell, mesh, overrides)
    if spec.family == "gnn":
        return _build_gnn(spec, cell, mesh, overrides)
    if spec.family == "recsys":
        return _build_recsys(spec, cell, mesh, overrides)
    raise ValueError(spec.family)


# ---------------------------------------------------------------------------
# Offline STABLE index builder CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    from repro_torch.api import Engine
    from repro_torch.core import resolve_device
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.quant import QUANT_MODES, QuantConfig

    ap = argparse.ArgumentParser(description="build + save a STABLE engine")
    ap.add_argument("--out", required=True, help="output index directory")
    ap.add_argument("--device", default=None,
                    help="torch device to build on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--profile", default="sift")
    ap.add_argument("--attr-dim", type=int, default=5)
    ap.add_argument("--gamma", type=int, default=24)
    ap.add_argument("--max-rounds", type=int, default=8)
    ap.add_argument("--quant", default="none", choices=QUANT_MODES,
                    help="attach a quantized code store to the index")
    ap.add_argument("--pq-subspaces", type=int, default=32)
    ap.add_argument("--no-graph", action="store_true",
                    help="scan-only corpus: skip the HELP graph build "
                         "(the engine planner will use brute force)")
    ap.add_argument("--shards", type=int, default=0,
                    help="build a sharded engine over this many model shards "
                         "and save the per-shard layout (0 = single-host)")
    ap.add_argument("--partitions", type=int, default=0,
                    help="build an IVF-partitioned engine: coarse k-means "
                         "over this many partitions, each with its own HELP "
                         "subgraph, saved one subdirectory per partition for "
                         "streaming residency (0 = flat)")
    ap.add_argument("--residency-rows", type=int, default=0,
                    help="partitioned only: device-resident row cap of the "
                         "built engine's segment store (0 = hold all)")
    args = ap.parse_args(argv)
    if args.partitions and args.shards:
        raise SystemExit("--partitions and --shards are mutually exclusive")
    dev = resolve_device(args.device)

    ds = make_hybrid_dataset(
        n=args.n, n_queries=1, profile=args.profile, attr_dim=args.attr_dim,
        labels_per_dim=3, n_clusters=16, attr_cluster_corr=0.6, seed=0,
    )
    t0 = time.time()
    help_cfg = HelpConfig(gamma=args.gamma, gamma_new=6, max_rounds=args.max_rounds)
    quant_cfg = QuantConfig(mode=args.quant, pq_subspaces=args.pq_subspaces)
    if args.shards:
        from repro_torch.core import auto as auto_mod
        from repro_torch.core.auto import MetricConfig
        from repro_torch.distributed import ShardedStableIndex
        from repro_torch.launch.mesh import make_local_mesh

        if args.n % args.shards:
            raise SystemExit(f"--shards {args.shards} does not divide --n {args.n}")
        # model shards round-robin over the visible cards unless --device names one
        mesh = make_local_mesh(data=1, model=args.shards,
                               devices=None if args.device is None else [dev])
        stats = auto_mod.sample_stats(ds.features, ds.attrs)
        eng = Engine(ShardedStableIndex.build(
            mesh, ds.features, ds.attrs, MetricConfig(mode="auto", alpha=stats.alpha),
            help_cfg=help_cfg, quant_cfg=quant_cfg,
        ))
        eng.save(args.out)
        print(f"built {args.shards}-shard {args.n}×{ds.features.shape[1]} engine on {dev} "
              f"in {time.time()-t0:.1f}s → {args.out} (per-shard layout; Engine.load "
              "puts it on a mesh with the same model shards)")
        return
    if args.partitions:
        eng = Engine.build_partitioned(
            ds.features, ds.attrs, n_partitions=args.partitions,
            help_cfg=help_cfg, quant_cfg=quant_cfg, build_graph=not args.no_graph,
            residency_rows=args.residency_rows or None, device=dev,
        )
        eng.save(args.out)
        pidx = eng.index
        print(f"built {args.n}×{ds.features.shape[1]} index over {pidx.n_partitions} "
              f"partitions on {dev} in {time.time()-t0:.1f}s "
              f"(α={pidx.metric_cfg.alpha:.3f}, quant={args.quant}) → {args.out} "
              "(per-partition layout; Engine.load streams partitions under "
              "--residency-rows)")
        return
    eng = Engine.build(
        ds.features, ds.attrs, help_cfg, quant_cfg=quant_cfg,
        build_graph=not args.no_graph, device=dev,
    )
    eng.save(args.out)
    idx = eng.index
    quant_note = (
        f", {idx.quant.code_bytes / 2**20:.1f} MiB codes ({args.quant})"
        if idx.quant is not None else ""
    )
    print(f"built {args.n}×{ds.features.shape[1]} index on {dev} in {time.time()-t0:.1f}s"
          f" (α={idx.metric_cfg.alpha:.3f}{quant_note}) → {args.out}")


if __name__ == "__main__":
    main()
