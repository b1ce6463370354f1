"""Serving launcher: build/load a STABLE engine and serve a multi-tenant
request stream — ``python -m repro_torch.launch.serve [--index-dir DIR]``.

The launcher is a client of the ``repro_torch.serve`` subsystem: requests
are admitted per tenant (token bucket + k/pool caps), coalesced by
compatible plan signature inside a micro-batch window, padded up the bucket
ladder and executed through one shared ``Engine`` — repeated windows replay
cached executables and compile nothing. One engine is built (or loaded from
``--index-dir``, a ``stable-single-v1``, ``stable-sharded-v1`` or
``stable-partitioned-v1`` index saved by either package, e.g. by
``repro_torch.launch.build``; a sharded one goes onto a mesh with its saved
model shards and one data block; ``--residency-rows`` caps a partitioned
index's device-resident rows) once and reused for the whole stream; all
timing comes from ``ServerStats`` (end-to-end p50/p95/p99, batch-fill
ratio, plan-cache hit rate, per-tenant QPS), not ad-hoc stopwatches.

The engine runs on the CUDA card unless ``--device cpu`` asks for the
kernels' plain PyTorch versions; without a card the default raises.

With ``--writes`` the launcher serves a *mutable* engine: the last W rows
are held out of the build and streamed back as ``Upsert`` requests (plus
W//4 ``Delete``\\ s) interleaved with the queries, so the run exercises the
LSM write path — delta scans federated into every query, per-tenant write
admission (``--write-rate``), and background merges that never block
serving (``--max-delta-rows``) — and reports the write, merge and delta
metrics beside the read-side ones.

With ``--hot-rows H`` the engine is wrapped in a ``TieredEngine``: the H
most frequently returned rows stay full-precision on the device and a
quantized engine's rerank gathers the cold tail from the host (answers
bit-identical to the untiered engine); the run prints a ``tier:`` line.
It is incompatible with ``--writes`` (the launcher says so and serves
untiered).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 4000 --requests 128
  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --requests 512
  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --quant pq \\
      --tenants 8 --window-ms 4 --buckets 1,8,32
  PYTHONPATH=src python -m repro_torch.launch.serve --index-dir DIR --rate 200
  PYTHONPATH=src python -m repro_torch.launch.serve --index-dir PART_DIR \
      --residency-rows 65536
  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --writes 2000 \\
      --write-rate 500 --max-delta-rows 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --quant pq \\
      --hot-rows 2500
  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 \\
      --metrics-port 9100 --trace-sample 16 --trace-out trace.json
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch


def main(argv=None) -> None:
    from repro_torch.api import MATCH, Engine, Query, SearchParams
    from repro_torch.cache import ResultCache, TieredEngine
    from repro_torch.core import resolve_device, to_tensor
    from repro_torch.core.baselines import brute_force_hybrid, recall_at_k
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.mutable import CompactionPolicy, MutableEngine
    from repro_torch.obs import Tracer, dump_chrome_trace
    from repro_torch.quant import QUANT_MODES, QuantConfig
    from repro_torch.serve import (
        Delete, Request, TenantPolicy, TenantRegistry, ThreadedServer,
        Upsert, serve_loop,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--index-dir", default=None,
                    help="load a saved index instead of building one")
    ap.add_argument("--save-index", default=None)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--profile", default="sift")
    ap.add_argument("--attr-dim", type=int, default=5)
    ap.add_argument("--requests", type=int, default=512,
                    help="total requests in the served stream")
    ap.add_argument("--tenants", type=int, default=4,
                    help="number of tenants (round-robin request stream)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="micro-batch coalescing window")
    ap.add_argument("--buckets", default="1,8,32,128",
                    help="comma-separated batch bucket ladder")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="per-tenant admitted QPS (token bucket); 0 = unlimited")
    ap.add_argument("--burst", type=float, default=32.0,
                    help="per-tenant token-bucket burst capacity")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--quant", default="none", choices=QUANT_MODES,
                    help="serve over compressed codes + full-precision rerank")
    ap.add_argument("--rerank", type=int, default=0,
                    help="pool entries reranked exactly (0 = whole pool)")
    ap.add_argument("--pq-subspaces", type=int, default=32)
    ap.add_argument("--writes", type=int, default=0,
                    help="hold the last W rows out of the build and stream "
                         "them back as Upserts (plus W//4 Deletes) "
                         "interleaved with the queries")
    ap.add_argument("--write-rate", type=float, default=0.0,
                    help="per-tenant admitted writes/second; 0 = unlimited")
    ap.add_argument("--residency-rows", type=int, default=0,
                    help="partitioned --index-dir only: cap on device-"
                         "resident rows (0 = everything may stay resident)")
    ap.add_argument("--max-delta-rows", type=int, default=1024,
                    help="compaction trigger: merge when the delta holds "
                         "this many rows")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="hot/cold tiering: keep the top-frequency rows "
                         "full-precision on device and rerank the cold "
                         "tail from host (0 = untiered; incompatible "
                         "with --writes)")
    ap.add_argument("--result-cache", type=int, default=0,
                    help="serve-layer result cache capacity in entries "
                         "(0 = off); hits return the cached top-k payload "
                         "bit-identical")
    ap.add_argument("--cache-ttl", type=float, default=0.0,
                    help="result-cache entry lifetime in seconds "
                         "(0 = no expiry)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the metrics registry over HTTP on this "
                         "port: Prometheus text at /metrics, JSON at "
                         "/metrics.json (0 = pick an ephemeral port)")
    ap.add_argument("--trace-sample", type=int, default=0,
                    help="sample every Nth request into a per-query trace "
                         "(0 = tracing off; the no-op path costs nothing)")
    ap.add_argument("--trace-out", default=None,
                    help="write sampled traces as Chrome trace-event JSON "
                         "(chrome://tracing / Perfetto); implies "
                         "--trace-sample 1 unless set explicitly")
    args = ap.parse_args(argv)
    if args.hot_rows < 0:
        ap.error("--hot-rows must be nonnegative (0 = untiered)")
    dev = resolve_device(args.device)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    n_writes = max(0, min(args.writes, args.n // 2))

    ds = make_hybrid_dataset(
        n=args.n, n_queries=args.requests, profile=args.profile,
        attr_dim=args.attr_dim, labels_per_dim=3, n_clusters=16,
        attr_cluster_corr=0.6, seed=0,
    )
    if args.index_dir:
        if n_writes:
            print("--writes needs a fresh build (holdout rows); ignoring")
            n_writes = 0
        print(f"loading engine from {args.index_dir} onto {dev} "
              "(one engine reused for the whole stream)")
        eng = Engine.load(args.index_dir, device=dev,
                          residency_rows=args.residency_rows or None)
    else:
        n_build = args.n - n_writes
        print(f"building index over {n_build} nodes on {dev} "
              f"({args.profile} profile, quant={args.quant}"
              + (f", {n_writes} rows held out for the write stream)"
                 if n_writes else ")"))
        t0 = time.perf_counter()
        eng = Engine.build(
            ds.features[:n_build], ds.attrs[:n_build],
            HelpConfig(gamma=24, gamma_new=6, max_rounds=8),
            quant_cfg=QuantConfig(mode=args.quant,
                                  pq_subspaces=args.pq_subspaces),
            device=dev,
        )
        idx = eng.index
        print(f"  built in {time.perf_counter()-t0:.1f}s "
              f"(α={idx.metric_cfg.alpha:.3f}, "
              f"ψ={idx.report.psi_history[-1]:.3f})")
        if idx.quant is not None:
            f32_mb = idx.features.numel() * 4 / 2**20
            code_mb = idx.quant.code_bytes / 2**20
            print(f"  codes: {code_mb:.1f} MiB vs {f32_mb:.1f} MiB f32 "
                  f"({f32_mb/code_mb:.0f}× compression)")
        if args.save_index:
            eng.save(args.save_index)
            print(f"  saved to {args.save_index} (incl. calibrated cost "
                  "model — loads skip the probe)")

    # one policy per tenant; the engine derives quant from the index
    params = SearchParams(
        k=args.k, pool_size=args.pool,
        pioneer_size=max(4, args.pool // 8), rerank_size=args.rerank,
    )
    rate = args.rate if args.rate > 0 else math.inf
    write_rate = args.write_rate if args.write_rate > 0 else math.inf
    reg = TenantRegistry()
    tenants = [f"tenant-{t}" for t in range(max(args.tenants, 1))]
    for t in tenants:
        reg.register(t, TenantPolicy(
            params=params, rate=rate, burst=args.burst,
            write_rate=write_rate, write_burst=max(args.burst, 1.0),
        ))
    read_reqs = [
        Request(tenants[i % len(tenants)],
                Query(ds.query_features[i],
                      [MATCH(int(v)) for v in ds.query_attrs[i]]),
                request_id=i)
        for i in range(args.requests)
    ]
    reqs = list(read_reqs)

    hot_rows = args.hot_rows
    if hot_rows and n_writes:
        # merges renumber rows under the frequency tracker, so the tier
        # only wraps an immutable engine (TieredEngine rejects the mix)
        print("--hot-rows is incompatible with --writes; serving untiered")
        hot_rows = 0
    if hot_rows:
        eng = TieredEngine(
            eng, hot_rows=hot_rows,
            epoch_queries=min(512, max(64, args.requests // 4)),
        )
        print(f"hot/cold tiering: top {hot_rows} rows full-precision on "
              "device, cold tail reranked from host")

    deleted: list = []
    if n_writes:
        eng = MutableEngine(eng, CompactionPolicy(max_delta_rows=args.max_delta_rows))
        n_build = args.n - n_writes
        rng = np.random.default_rng(7)
        deleted = sorted(
            int(i) for i in
            rng.choice(n_build, size=min(n_writes // 4, n_build), replace=False)
        )
        writes = [
            Upsert(tenants[i % len(tenants)], ds.features[n_build + i],
                   ds.attrs[n_build + i], id=n_build + i)
            for i in range(n_writes)
        ] + [Delete(tenants[i % len(tenants)], d)
             for i, d in enumerate(deleted)]
        # interleave writes uniformly through the read stream
        stride = max(len(reqs) // max(len(writes), 1), 1)
        mixed: list = []
        wi = 0
        for i, r in enumerate(reqs):
            mixed.append(r)
            while wi * stride <= i and wi < len(writes):
                mixed.append(writes[wi])
                wi += 1
        mixed.extend(writes[wi:])
        reqs = mixed

    # warmup: compile the executables the stream will replay (deterministic
    # loop, same buckets/params) so the timed run measures serving, not
    # planning and compiling. Reads only: warming must not write.
    warm = min(len(read_reqs), max(buckets))
    serve_loop(eng, [(0.0, r) for r in read_reqs[:warm]],
               TenantRegistry(default_policy=TenantPolicy(params=params)),
               window_ms=args.window_ms, buckets=buckets)

    print(f"serving {len(reqs)} requests ({len(read_reqs)} queries, "
          f"{len(reqs) - len(read_reqs)} writes) from {len(tenants)} "
          f"tenants (window={args.window_ms}ms, buckets={buckets})")
    result_cache = None
    if args.result_cache > 0:
        result_cache = ResultCache(
            max_entries=args.result_cache,
            ttl=args.cache_ttl if args.cache_ttl > 0 else None,
        )
        print(f"result cache: {args.result_cache} entries"
              + (f", ttl={args.cache_ttl:g}s" if args.cache_ttl > 0 else ""))
    sample_every = args.trace_sample or (1 if args.trace_out else 0)
    tracer = Tracer(sample_every=sample_every) if sample_every > 0 else None
    if tracer is not None:
        print(f"tracing: sampling every {sample_every} request(s)")
    with ThreadedServer(eng, reg, window_ms=args.window_ms,
                        buckets=buckets, result_cache=result_cache,
                        tracer=tracer,
                        metrics_port=args.metrics_port) as srv:
        if srv.metrics_server is not None:
            print(f"metrics: {srv.metrics_server.url}/metrics "
                  f"(JSON at /metrics.json)")
        futs = [srv.submit(r) for r in reqs]
        results = [f.result() for f in futs]

    done = [r for r in results if r.ok and hasattr(r, "ids")]
    snap = srv.stats.snapshot()
    lat = snap["latency_ms"]
    print(f"[served] {snap['completed']}/{snap['submitted']} completed, "
          f"{snap['rejected']} shed {dict(snap['rejected_by_reason'])}")
    print(f"  end-to-end: QPS={snap['qps']:.0f}  p50={lat['p50']:.1f}ms "
          f"p95={lat['p95']:.1f}ms p99={lat['p99']:.1f}ms")
    print(f"  batches: {snap['batches']} "
          f"(fill={snap['batch_fill_ratio']:.2f}, "
          f"queue p99={snap['queue_ms_p99']:.1f}ms, "
          f"service p99={snap['service_ms_p99']:.1f}ms)")
    pc = snap["plan_cache"]
    print(f"  plan cache: {pc['hits']} hits / {pc['misses']} misses "
          f"(hit rate {pc['hit_rate']:.2f}, {pc['evictions']} evictions, "
          f"{pc['size']} resident)  compiled plans={snap['retraces']} "
          f"(reuse rate {snap['jit_hit_rate']:.2f})")
    for t, c in snap["per_tenant"].items():
        print(f"    {t}: {c['completed']}/{c['submitted']} served "
              f"({c['qps']:.0f} qps, {c['rejected']} shed)")
    if "tier" in snap:
        t = snap["tier"]
        print(f"  tier: hit rate {t.get('tier_hit_rate', 0.0):.2f} "
              f"(hot budget {t['hot_rows_budget']} rows, "
              f"{t.get('promotions', 0)} promotions, "
              f"{t.get('demotions', 0)} demotions)")
    if getattr(eng, "is_partitioned", False):  # a MutableEngine never is
        store = eng.index.store.stats()
        print(f"  segment store: {store['loads']} loads, {store['hits']} hits, "
              f"{store['evictions']} evictions, {store['prefetch_hits']} prefetch "
              f"hits; peak {store['peak_resident_rows']} of "
              f"{store['cap_rows']} resident rows")
    if "result_cache" in snap:
        rc = snap["result_cache"]
        print(f"  result cache: {rc['hits']} hits / {rc['misses']} misses "
              f"(hit rate {rc['hit_rate']:.2f}, {rc['invalidations']} "
              f"invalidated, {rc['served']} served without device work)")
    if "writes" in snap:
        w = snap["writes"]
        print(f"  writes: {w['upserts']} upserts, {w['deletes']} deletes, "
              f"{w['shed']} shed; {w['merges']} merges "
              f"(p50={w['merge_ms_p50']:.0f}ms p95={w['merge_ms_p95']:.0f}ms)")
    if "delta" in snap:
        d = snap["delta"]
        print(f"  delta: {d['delta_alive']} alive rows / "
              f"{d['tombstones']} tombstones "
              f"(logical n={d['logical_n']}, "
              f"{d['delta_result_fraction']:.1%} of served ids from delta)")

    if tracer is not None:
        traces = tracer.traces()
        if args.trace_out:
            dump_chrome_trace(traces, args.trace_out)
            print(f"  traces: {len(traces)} sampled -> {args.trace_out} "
                  "(open in chrome://tracing or ui.perfetto.dev)")
        elif traces:
            root = traces[-1].root
            print(f"  traces: {len(traces)} sampled "
                  f"(last root {root.duration * 1e3:.1f}ms end-to-end)")

    if done:
        take = [r.request_id for r in done]
        ids = np.stack([r.ids for r in done])
        # the oracle scans the post-write corpus: held-out rows were
        # upserted back with their original values, deleted ids are pushed
        # out of range so they can never rank
        feats = ds.features
        if deleted:
            feats = feats.copy()
            feats[np.asarray(deleted)] = 1e6
        truth = brute_force_hybrid(
            to_tensor(feats, torch.float32, dev),
            to_tensor(ds.attrs, torch.int32, dev),
            ds.query_features[take], ds.query_attrs[take], args.k,
        )
        print(f"  Recall@{args.k}={recall_at_k(ids, truth.ids.cpu(), args.k):.3f} "
              f"(vs exact post-write oracle, completed requests)")


if __name__ == "__main__":
    main()
