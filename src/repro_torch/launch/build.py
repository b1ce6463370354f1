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

The reference's module of the same name also holds the cell builder of its
LM, GNN and recsys cells (``build_cell``), JAX sharding and dry-run
machinery; that part waits for the sharded and dry-run side (ROADMAP.md
queue 1, item 16.3). The cells' FLOP counts are ``models.recsys.model_flops``
and ``models.transformer.model_flops``.

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
import time


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
