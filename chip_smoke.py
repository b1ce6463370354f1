#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every kernel
against its plain PyTorch version.

Run from the root of a checkout (it needs one card and builds the kernels
into build/kernels/ itself):

    python3 chip_smoke.py            # N = 1,000,000 (SIFT1M's shape)
    python3 chip_smoke.py --n 200000 # a cut corpus

Phases:
  1. device: the card's name and power limit (nvidia-smi), kernel build time
  2. kernels: gather_auto at a refine hop (B=128, C=1280), an NN-descent
     block (B=2048, C=520) and the build's narrow block (B=2048, C=32),
     fused_auto at (B=128, N) - point, interval and masked targets, auto and
     l2 modes - against their plain versions, with a bitwise
     batch-invariance check (gather_auto: rows 0, 77 and B-1 against
     single-row calls) and CUDA-event timings of each mode (gather_auto:
     device time in both modes at each shape, beside its bound);
     gather_auto at M in {12289, 20000} (B=4, C=64) against its plain
     version; fused_auto in auto mode at L in {97, 200} (above its staged
     attributes) on integer data bit for bit at B in {1, 49, 130};
     fused_auto timed in both modes at B=32 and B=64 (its narrow and middle
     tiles), beside torch.cdist at the same shapes; fused_auto on integer-valued operands bit for bit against its
     plain version at B in {1, 16, 17, 48, 49, 64, 65, 128, 512} and M in
     {10, 128} (each tile of the kernel on both sides of its bounds), and
     rows of B=128 and B=512 batches against single-row calls bit for bit;
     adc_scan
     (K=256) and adc_scan4 (K=16) at (B=128, N, S=64), bit for bit against
     their plain versions, batch-invariant, adc_scan4 on packed codes equal
     to adc_scan on the same codes unpacked, plus small odd-S cases; each
     timed in l2 and auto beside its bytes bound and its lookup ceiling
     (B·N·S lookups over SMs x 32 a clock at the card's maximum SM clock)
  3. small input (N = 20,000): the main path on the card against the same
     path on the CPU (plain versions); MATCH recall@10 must reach 0.5 on the
     card and stay within 0.02 of the CPU's; then the pq4 and pq codecs
     (S=64) trained over that engine's rows and attached to its graph on
     both (what Engine.build with a codec builds), graph and brute MATCH
     recall@10 against the exact oracle within 0.02 of the CPU's
  4. main path: Engine.build on the sift profile, then Engine.search on the
     graph backend and on the brute oracle for MATCH, subset, ONE_OF and
     BETWEEN batches of 128 (recall@10, latency, QPS, evals, hops), a pool
     sweep for MATCH and one auto-planned search (the planner's probe).
     Then serving on the same engine: 1,024 requests from 4 tenants (the
     four predicate kinds in turn, Poisson arrivals at 8,000 a second on
     serve_loop's virtual clock, window 2 ms, buckets 1/8/32/128) through
     serve_loop on each backend, every response Completed and every 16th
     equal bit for bit to its query searched alone; the first 512 again
     through a ThreadedServer fed by 4 client threads, each answer equal to
     serve_loop's, and its metrics endpoint scraped (/metrics and
     /metrics.json); latency percentiles, service ms by bucket, fill,
     plan-cache hit rate and launches printed, and a bucket-128 graph
     flush of 128 MATCH requests timed on the host clock. Then the
     quantized slice on the same graph: each codec (sq8, pq, pq4,
     opq-pq, opq-pq4; S=64) trained and attached to the index, MATCH and
     ONE_OF searched on both backends against the exact oracle (brute-ADC
     MATCH recall@10 must reach 0.5 for the PQ family). Last, profiled
     graph and brute searches, exact and pq, and one bucket-128 graph flush
     of the serve path (device busy share, each kernel's part, top kernels).
     Then the partitioned backend at the reference's scale_sweep
     configuration (P = 128 at N = 1M, HelpConfig(12, 4, 4), the pq codec
     at S=64): Engine.build_partitioned, saved and loaded back with a cap
     of max bucket x max(4, √P) rows; 128 queries with MATCH on attribute
     0 at nprobe 1, √P/2, √P and 2√P on the brute sub-backend (recall@10
     against the flat brute oracle, ≥ 0.9 at √P; the store's peak under
     the cap, evictions), pq brute and graph at √P; the full probe bit for
     bit against the flat brute engine (exact, and pq over the same codes)
     on the four predicate kinds; device memory back after evict_all; 256
     requests of the serve trace on the partitioned engine, every 16th
     equal to its solo search; fused_auto and adc_scan at the probe shape
     it runs most, timed beside their bounds; one profiled search.
     Then the tiered step: a TieredEngine over the pq engine (hot budget
     N/8, an epoch every 128 queries); MATCH, ONE_OF and BETWEEN batches
     of 128 on both backends bit for bit equal to the untiered engine in
     the cold, warm and churned tier states; the reference's cache_sweep
     traffic (512 requests over 128 distinct queries, Zipf skews 0, 0.8
     and 1.2, bursts of mean 4) served untiered, tiered at hot 0 and N/8,
     and with a ResultCache, every answer equal to the untiered stream's
     (service QPS, p50 / p99, tier and cache hit rates, promotions); the
     rerank gather of an all-hot and an all-cold bucket-8 batch on the host
     clock; on the partitioned engine under its cap the skew-1.2 trace
     untiered and with hot partitions pinned (answers equal, pinned rows
     under the cap, loads and ms a search); gather_auto at the tiered
     rerank (B = 8 and 128 against 40 staged rows each, equal bit for bit
     to the same call over the row table) and at a serve bucket-8 hop,
     timed beside its bound.
     Then the sharded step: ShardedStableIndex.build of the same data on a
     (data=1, model=4) mesh on the one card (250,000 rows a shard), exact
     and then with the pq codec (S=64), through Engine on the sharded
     backend: the four predicate classes at B=128 timed beside the flat
     engine of the same codec (hops, evals, recall@10 against the flat
     brute oracle), every 16th row equal to its solo search, data=2 equal
     to data=1, a save and Engine.load round trip equal to the saved
     engine (codes included), all bit for bit; pq exact evals within the
     pool; 256 requests of the serve trace through serve_loop with the
     backend pinned, every 16th equal to its solo search; gather_auto at a
     shard hop (B=128, C=1280 over 250,000 rows) beside its bound; the
     exhaustive merge at N=4,096 (pool = shard rows) equal to a brute
     oracle scored by the same kernel; sharded MATCH recall@10 at
     N=20,000, exact and pq, on the card within 0.02 of the CPU's; one
     profiled sharded search.
     Then the mutable step on the exact index, handed over so that the
     merge frees it: a MutableEngine with a WAL; with no writes its
     search equals Engine.search bit for bit; 3,072 inserts (a second
     draw, --seed + 1), 512 overwrites and 512 deletes; the federated
     brute read against a fresh oracle over the logical corpus (ids
     except near-ties, sqdists rtol 1e-5), no deleted id on either
     backend, inserted and overwritten rows first for their new vectors;
     the WAL replayed over the base bit for bit; a synchronous merge timed
     by part (apply_rows, routed search, hop scoring, repair; apply),
     link_nodes's launches, the linked rows' in-edges, device memory once
     the old index is released, brute results unchanged across it; a
     checkpoint loaded back with its WAL bit for bit; 1,024 reads with 256
     writes through serve_loop, then through a ThreadedServer that merges
     in the background past 128 delta rows (read-your-writes on every
     insert, read latency with and without a merge in flight,
     serve_merge_ms scraped); fused_auto at the delta scan and
     gather_auto at the link hop against their plain versions, timed
     beside their bounds; and the reference's freshness script at N =
     20,000 on the card and the CPU (graph MATCH recall@10 ≥ 0.9 before
     and after the merge, within 0.02 of the CPU's)
  5. recsys: the fm model at its full width (F=39 fields, V=1,000,000 rows a
     field, D=10; 1.56 GB of tables and 156 MB of linear weights drawn on
     the card from --seed). fm_interaction at serve_p99 (B=512), serve_bulk
     (B=262,144) and odd shapes, bit for bit against its plain version and
     batch-invariant; fused_auto at the retrieval shape (M=10, L=4, B=1 and
     B=512, N=1M) under its tolerance, timed in auto and l2 modes; the serve and retrieval steps on the
     card against the CPU's at a cut vocabulary (V=1,000; N=20,000 items).
     Then the recsys path: make_recsys_serve_step at serve_p99 and
     serve_bulk, make_recsys_retrieval_step at retrieval_cand (one user
     against 1,000,000 items, k=100) and at B=512, each a median of
     several batches, then each profiled once. Then the recsys models, one
     at a time at full width, each freed before the next: dlrm-rm2 (26 x
     1M x 64 tables, 6.66 GB), xdeepfm (39 x 1M x 10 tables, linear
     weights, a CIN of 3 x 200) and bert4rec (a 1M x 64 item table, 2
     blocks, sequences of 200), parameters drawn on the card from --seed
     (the count held to the reference's formula); the card against the
     CPU at a cut vocabulary (V=1,000; bert4rec 20,000 items) under FP32
     and MIXED: serve logits at B=512 (bert4rec: bert4rec_serve_topk, its
     chunks of 4, 5 and 16 against each other), user towers and
     retrieval at B=16 against 20,000 items (k=100, topk_shards 1 and 4);
     fused_auto at M=64 on the dlrm-rm2 and bert4rec user vectors (B=1
     and 512, N=1M, L=4) against its plain version, batch-invariant,
     timed; the serve cells (bert4rec through bert4rec_serve_topk, k=100,
     chunks of 4,096) and retrieval steps timed as fm's (serve_bulk over 2
     batches after a warm-up) with peak memory and model FLOP/s, each
     profiled once. Then training (AdamW from each spec, lr 1e-3): the
     fm_interaction autograd Function at the train_batch shape (65,536, 39,
     10), its forward kernel bit for bit against its plain version and its
     backward kernel's gradient on the card against the CPU's plain ops bit
     for bit there and at B in {1, 255, 257}, F in {1, 39}, D in {1, 10,
     64} (one forward and one backward launch each), the forward and the
     backward each timed beside its bound; make_recsys_train_step on each
     model's full-width parameters (fm, dlrm-rm2 and xdeepfm at B =
     65,536; bert4rec at B = 8,192 with 20 masked positions and 8,192
     shared negatives), one warm-up step and 5
     timed (median ms, examples/s, model TFLOP/s, peak over the resident
     parameters, losses; the first BCE loss within 0.05 of ln 2, every
     parameter moved), one profiled; fm through
     `repro_torch.launch.train.main` (--full-config, B = 65,536, 5 steps);
     each model's step at the cut vocabulary, the card against the CPU
     under FP32 and MIXED (loss, gradient norm and gradients within the
     models' tolerances; apply_updates on identical gradients within
     1e-6); the loop at fm's widths and V = 1,000 (12 steps, a checkpoint
     every 4, a crash at 7 and a resume from 4 within rtol 1e-4, the last
     checkpoint restored bit for bit); examples/train_retrieval.py on the
     card. Then the LM step (no kernel of the port lies on it): the five
     reduced LM configs on the card against the CPU under FP32 and MIXED
     (forward at B=2, S=96, forward_last, loss_fn, 40 decode tokens against
     a cache of 36 rows; MoE tokens near a router tie under MIXED counted
     and left out); decode token by token against forward over a 64-token
     prompt (yi-34b and mistral-large-123b reduced, phi3 full width);
     phi3-mini-3.8b at full width and depth and mixtral-8x7b at full width
     on 8 of its 32 layers, bf16 parameters drawn on the card: prefill_32k
     (phi3 at B=1; mixtral at the largest B that leaves a quarter of the
     card free), decode_32k and long_500k (mixtral) with caches filled from
     a generator, each timed (ms, tokens/s, model TFLOP/s, peak memory,
     decode against its bytes bound), profiled once (busy share, top ops,
     MoE drops), the attention's part of prefill from one q-chunk's time;
     device memory back to its level after. Then LM training (no kernel of
     the port on it either): the five reduced configs card against CPU
     under FP32 and MIXED (one micro-batched step's loss, gradient norm and
     gradients; MoE under MIXED on the sequences no router near-tie
     unsettles), remat on against off bit for bit on the card; train_4k
     (S=4,096, MIXED, AdamW, the spec's micro_batches, remat) at full
     width: phi3-mini-3.8b on the deepest stack that leaves a quarter of
     the card free (measured from two shallow probes) at B=2, mixtral-8x7b
     on 1 layer at B=4: median step ms, tokens/s, model TFLOP/s, peak over
     the resident state, one profiled step, MoE drops. Then the GNN:
     graphcast card against CPU (graphcast-smoke under FP32 and MIXED,
     full_graph_sm at full width under FP32: loss, gradients, infer), then
     graphcast at full width and depth (16 layers, d=512, MIXED, AdamW) on
     full_graph_sm, minibatch_lg (a fanout sample of a Reddit-sized random
     graph, edges cut by 8), ogb_products (nodes and edges cut by the
     smallest power of two that fits, from two probes) and molecule: train
     and infer ms, edges/s, model TFLOP/s, peak, one profiled step. Then
     the sharded and dry-run step: the dry run (launch/dryrun.py, meta
     tensors) over every cell on the single production mesh, and on the
     pod mesh too if both fit in 90 s, one line a cell; fm train_batch,
     xdeepfm retrieval_cand, dlrm-rm2 serve_bulk, graphcast minibatch_lg
     and mixtral-8x7b decode_32k (1 layer) built with build_cell on a
     (1, 1) mesh, their arguments drawn on the card requesting exactly the
     dry run's argument bytes, one step's FLOPs under FlopCounterMode equal
     to the meta count and its outputs finite, a second step timed and its
     peak printed beside the dry run's per_device_total; both ring matmuls
     at (8,192 x 8,192) @ (8,192 x 3,072) f32 over 4 shards on the card,
     bit for bit the plain ring-order sums of their partials, within 1e-5
     of one matmul, timed; the ring aggregate over ogb_products cut by 8
     (d = 512, 15.8 GB of f32 messages) within 1e-5 of scatter_sum, its
     peak above the messages beside one whole accumulator; the LM and GNN
     sharding fields changing no value, bit for bit. Last
     of all, one more Engine.build of phase 4's data under the profiler
  6. a JSON line of every kernel's launches in phases 4 and 5 (the exact,
     serve, quantized, partitioned, tiered, sharded, mutable, recsys,
     recsys-model, training, LM, LM-training, GNN and sharded/dry-run
     paths, each counted from 0; a kernel of
     a path that the path never launched fails the run), error and times

At N = 1M this dataset's graph recall is low (the AUTO-built HELP graph
splits by attribute combination; the reference does the same): it is
printed, not held to a floor. The floor is held where the reference
reaches it, on the small input of phase 3.

Any failure exits non-zero before the last line, which is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM data sheet peaks (dense, no sparsity) used for bound_ms.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: four-byte shared-memory accesses an SM serves a clock (one conflict-free
#: warp access): the ADC scanners' lookup ceiling
SMEM_LOOKUPS_PER_CLOCK = 32
#: gather_auto: rtol on each score (sums of M positive terms, other order).
GATHER_RTOL = 1e-5
#: gather_auto's (B, C) on the main path: a refine hop (128 queries x 40·32
#: candidates), an NN-descent block (2048 nodes x Γ_new·Γ + R + R·Γ = 520)
#: and the build's narrow blocks (2048 x Γ = 32: the random init and the
#: reverse insert)
GATHER_SHAPES = {"hop": (128, 1280), "descent": (2048, 520), "narrow": (2048, 32)}
#: gather_auto above the 48 KB query row its first kernel staged (M > 12,288):
#: a width that is not a multiple of 4 (scalar loads) and one that is
GATHER_WIDE = (12_289, 20_000)
#: fused_auto above the attributes it stages (kMaxAttrs = 96): each tile
#: (B = 1, 49, 130) on integer data at N = 65,539
FUSED_MANY_ATTRS, FUSED_MANY_ATTRS_BATCHES = (97, 200), (1, 49, 130)
#: fused_auto: |Δsv2| ≤ 1e-5·(‖q‖² + ‖x‖²) + 1e-6 (the decomposition cancels),
#: scaled by the penalty (1 + sa/α)² in auto mode.
FUSED_RTOL_NORMS, FUSED_ATOL = 1e-5, 1e-6
MATCH_RECALL_FLOOR = 0.5
#: fused_auto's tiles and load paths: batches on both sides of each tile's
#: bound (48 and 64 queries) and of the narrow tile's first query tile
#: (16), the retrieval and oracle widths, and a row count that is not a
#: multiple of 4 (scalar stores) beside one that is
FUSED_EXACT_BATCHES = (1, 16, 17, 48, 49, 64, 65, 128, 512)
FUSED_EXACT_WIDTHS = (10, 128)
#: fused_auto's narrow and middle tiles timed at the oracle width, each at
#: a batch it serves (16 x 256 at B = 32, 64 x 64 at B = 64)
FUSED_TILE_BATCHES = (32, 64)
FUSED_EXACT_ROWS = (65_536, 65_539)
#: ADC subspaces: the pq_subspaces of the repo's quant sweep
#: (benchmarks/paper_benchmarks.py:360); 2 dims each at M = 128.
ADC_S = 64
#: odd subspace counts checked beside it: below one 32-subspace chunk, and
#: a partial second chunk
ADC_ODD_S = (7, 33)
QUANT_MODES = ("sq8", "pq", "pq4", "opq-pq", "opq-pq4")
#: phase 3: corpus size where both packages reach MATCH recall@10 0.986 on
#: the CPU, and how far the card's recall may sit from the CPU's (float
#: sums in another order change a few graph edges)
SMALL_N, SMALL_RECALL_GAP = 20_000, 0.02
#: phase 5: fm_interaction shapes besides the two serve cells (a D that is
#: not a power of two, small batches read directly, an example too large to
#: stage, a staged batch whose last run is partial, a D past a warp staged)
FM_ODD_SHAPES = ((7, 5, 3), (77, 100, 7), (50, 233, 3), (3, 2000, 9), (65541, 39, 10),
                 (40000, 7, 33))
#: the retrieval head's k (launch/build.py:310), the cut vocabulary and
#: item count of the card-against-CPU check, and the retrieval tolerance:
#: sq-dists rtol 1e-5, atol 1e-6, ids equal except at near-ties
RETRIEVAL_K, CUT_VOCAB, CUT_ITEMS = 100, 1000, 20_000
RETRIEVAL_RTOL, RETRIEVAL_ATOL = 1e-5, 1e-6
#: item factors at the scale of a user vector (a sum of 39 rows of N(0, 0.01²))
ITEM_SCALE = 0.0625
#: phase 5's recsys models after fm, each driven at full width and freed
#: before the next, with the cut vocabulary of its card-against-CPU check
#: (bert4rec: its item count)
RECSYS_MODELS = (("dlrm-rm2", {"vocab_per_field": CUT_VOCAB}),
                 ("xdeepfm", {"vocab_per_field": CUT_VOCAB}),
                 ("bert4rec", {"n_items": CUT_ITEMS}))
#: the models' card against the CPU, |Δ| ≤ tol·max|cpu| by precision: f32
#: products summed in other orders; bf16 steps of 2^-8 that run on through
#: the layers (the tolerances of tests/test_torch_recsys_models.py)
MODEL_TOL = {"FP32": 1e-5, "MIXED": 0.03}
#: bert4rec serves through bert4rec_serve_topk in chunks of the reference's
#: serve_chunk (launch/build.py:229); the chunks held against each other
SERVE_CHUNK, TOPK_CHUNKS = 4096, (4, 5, 16)
#: H100 SXM dense bf16 peak (data sheet), for model FLOP/s beside the f32 one
PEAK_BF16_FLOPS = 989e12
#: phase 5's training step: the reference's train_batch cell (B = 65,536)
#: for fm, dlrm-rm2 and xdeepfm; bert4rec at the largest power-of-two batch
#: that leaves a quarter of the card free (its (B, 20, 8,192) f32 sampled-
#: softmax block is 42.9 GB at 65,536, and its gradient as much), with the
#: reference cell's 20 masked positions and 8,192 shared negatives
#: (launch/build.py:204-205); one warm-up step, then TRAIN_STEPS timed
TRAIN_BERT4REC_BATCH, TRAIN_MASKED, TRAIN_NEGATIVES, TRAIN_STEPS = 8192, 20, 8192, 5
#: the card against the CPU at the cut vocabulary: a step's batch by kind,
#: and apply_updates on identical gradients within OPT_TOL·max|cpu| (the
#: same f32 ops in the same order; pow and reductions round otherwise)
TRAIN_SMALL_BATCH, TRAIN_SMALL_BERT4REC, OPT_TOL = 256, 32, 1e-6
#: a bf16 gradient leaf past MODEL_TOL passes where it lies at most this
#: many times as far from the f32 gradient as the CPU's bf16 one does
#: (check_close; tests/test_torch_train.py holds the reference's
#: gradients to the port's the same way)
BF16_GRAD_SLACK = 2.0
#: phase 5's LM step. The card against the CPU at each of the five reduced
#: configs: forward at (B, S) = (2, 96) (not a chunk multiple), then
#: LM_DECODE_STEPS tokens against a cache of LM_CACHE_ROWS rows (past its
#: end for the full-attention archs; mixtral-smoke's rolling cache of 32
#: wraps). Under MIXED, a MoE token within LM_EPS of a router tie (or whose
#: rank such a tie could move across the capacity: unsettled_tokens) may
#: route otherwise on the card; it is counted, and at most half may be.
LM_IDS = ("phi3-mini-3.8b", "yi-34b", "mistral-large-123b", "mixtral-8x7b", "kimi-k2-1t-a32b")
LM_SMALL_B, LM_SMALL_S, LM_DECODE_STEPS, LM_CACHE_ROWS, LM_EPS = 2, 96, 40, 36, 0.01
#: decode against prefill (the dense archs): a prompt decoded token by token
#: from an empty cache, each position's logits against forward's there
LM_PROMPT = 64
#: the full-width cells may fill this share of the card (a quarter free);
#: mixtral-8x7b runs on 8 of its 32 layers (1.45 B parameters a layer,
#: 23.7 GB with the embeddings in bf16); decode ms a token is the median of
#: LM_DECODE_REPS steps after a warm-up
LM_MEM_SHARE, MIXTRAL_LAYERS, LM_DECODE_REPS = 0.75, 8, 20
#: phase 5's LM training step: the train_4k cell (S = 4,096) under MIXED
#: (f32 master parameters, bf16 compute), each spec's AdamW and
#: micro_batches, every layer checkpointed (remat). (arch, layers, B):
#: phi3-mini-3.8b at full width on the deepest stack that leaves a quarter
#: of the card free (None: two steps' peak at each of LM_TRAIN_PROBE layers
#: gives the peak a layer), B = 2, one sequence a micro-batch; mixtral-8x7b
#: at full width on 1 layer (2 would take 63 GB at 20 B a parameter), B =
#: 4. Step ms: the median of LM_TRAIN_STEPS after one warm-up
LM_TRAIN_CELLS = (("phi3-mini-3.8b", None, 2), ("mixtral-8x7b", 1, 4))
LM_TRAIN_PROBE, LM_TRAIN_STEPS = (2, 4), 3
#: the card against the CPU at the reduced configs: one step's batch (B, S)
#: with the spec's micro_batches; under MIXED the MoE archs instead take the
#: sequences of LM_TRAIN_MOE_S tokens (the spec's micro_batches of them from
#: each of LM_TRAIN_MOE_SEEDS seeds) that no router near-tie unsettles, as
#: one micro-batched step a sequence a micro-batch (at least half held)
LM_TRAIN_SMALL, LM_TRAIN_MOE_SEEDS, LM_TRAIN_MOE_S = (8, 16), 8, 2
#: phase 5's GNN step: graphcast at full width and depth (16 layers, d =
#: 512) under MIXED with its AdamW (lr 1e-3), make_config(cell) for each
#: GNN_SHAPES cell. minibatch_lg samples 1,024 seeds with fanouts (15, 10)
#: from a random graph of Reddit's 232,965 nodes and 602 features and its
#: 114,615,892 edges cut by GNN_REDDIT_EDGE_CUT (numpy draws it on the
#: host: 8.4 s at the cut, ≈ 67 s whole); the sample's shape is the cell's.
#: ogb_products runs with its nodes and edges cut by the smallest power of
#: two that leaves a quarter of the card free (two steps' peak at each of
#: GNN_OGB_PROBE cuts gives the peak an edge). Train and infer ms: the
#: median of GNN_STEPS after one warm-up
GNN_REDDIT = (232_965, 114_615_892, 602, 41)
GNN_REDDIT_EDGE_CUT, GNN_OGB_PROBE, GNN_STEPS = 8, (512, 256), 5
#: the card against the CPU at graphcast-smoke: GNN_SMALL = (N, E), every
#: node reached by one edge plus E random ones (mean in-degree 5), 20% of
#: the edges masked, 70% of the nodes in the loss; and at full_graph_sm's
#: full width under FP32 on GNN_FULL_CHECK_LAYERS layers: deeper, the f32
#: gradients move by ~1e-4 of their scale when the features move by 1e-7
#: (ReLU gates flip), which check_gnn_small measures on the CPU at both
#: depths (GNN_PERTURB)
GNN_SMALL, GNN_FULL_CHECK_LAYERS, GNN_PERTURB = (64, 256), 2, 1e-7
#: the sharded and dry-run step: the cells held against the card (arch,
#: shape, overrides), the dry run's time under which it also runs the pod
#: mesh (both meshes take about twice the single one), the ring matmul at
#: phi3's FFN down-projection width (x (B, K) @ w (K, N), K split over the
#: shards), the aggregate's cut of ogb_products and width (graphcast's d)
DRY_CELLS = (("fm", "train_batch", None), ("xdeepfm", "retrieval_cand", None),
             ("dlrm-rm2", "serve_bulk", None), ("graphcast", "minibatch_lg", None),
             ("mixtral-8x7b", "decode_32k", {"n_layers": 1}))
DRY_BOTH_S, RING_SHARDS, RING_SHAPE = 90.0, 4, (8192, 8192, 3072)
AGG_CUT, AGG_D, RING_RTOL = 8, 512, 1e-5
#: fm_interaction's gradient, card against CPU, at B x F x D besides the
#: training shape
FM_GRAD_SHAPES = tuple((b, f, d) for b in (1, 255, 257) for f in (1, 39) for d in (1, 10, 64))
#: the loop on the card at the cut vocabulary: the reference's resume test
#: (tests/test_fault_tolerance.py:73-98: 12 steps, a checkpoint every 4, a
#: crash at 7, the final loss within rtol 1e-4) at fm's widths, B = 4,096
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_CRASH, LOOP_BATCH, LOOP_RTOL = 12, 4, 7, 4096, 1e-4
#: phase 4's serve trace: requests from tenants in turn, Poisson arrivals
#: at SERVE_RATE a second in all on serve_loop's virtual clock, the window
#: and bucket ladder of launch/serve.py, every 16th response held to its
#: solo search; the first 512 requests again through a ThreadedServer fed
#: by 4 client threads
SERVE_REQUESTS, SERVE_TENANTS, SERVE_RATE = 1024, 4, 8000.0
SERVE_WINDOW_MS, SERVE_BUCKETS = 2.0, (1, 8, 32, 128)
SERVE_SOLO_EVERY, SERVE_THREADED, SERVE_CLIENTS = 16, 512, 4
#: phase 4's partitioned step: the reference's scale_sweep configuration
#: (benchmarks/paper_benchmarks.py:1141-1167: P from N, HelpConfig(12, 4,
#: 4), 128 queries with MATCH on attribute 0, the nprobe sweep
#: {1, √P/2, √P, 2√P}, the cap of max bucket x max(4, √P) rows) with the
#: quant sweep's pq codec; its recall target at √P
#: (artifacts/bench/BENCH_scale.json); the first 256 requests of the serve
#: trace
PART_QUERIES, PART_RECALL_FLOOR, PART_SERVE_REQUESTS = 128, 0.9, 256
PART_HELP_KW = dict(gamma=12, gamma_new=4, max_rounds=4)
#: phase 4's mutable step: the reference's write script
#: (tests/test_mutable.py:68-90) at N = 1M on a copy of the exact engine:
#: inserts at fresh ids from a second draw of the profile (seed + 1),
#: overwrites of main rows (vector + 0.05·N(0, 1), attrs (a + 1) mod
#: labels) and deletes of other main rows: 3,584 delta rows, under
#: CompactionPolicy's default max_delta_rows of 4,096
MUT_INSERTS, MUT_OVERWRITES, MUT_DELETES = 3072, 512, 512
#: serving with writes: phase 4's 1,024 reads with 192 inserts and 64
#: deletes spread through them, through serve_loop (no merge) and then
#: through a ThreadedServer that merges in the background past 128 delta
#: rows: the reads from SERVE_CLIENTS closed-loop clients (a client waits
#: for each answer, so a read's latency is its service, not a backlog),
#: the writes from one more thread at MUT_WRITE_RATE a second, each
#: acknowledged insert read back at once on the brute backend
MUT_SERVE_INSERTS, MUT_SERVE_DELETES, MUT_THREADED_DELTA = 192, 64, 128
MUT_WRITE_RATE = 64.0
#: N = 20,000 (phase 3's size): the reference's freshness script
#: (tests/test_mutable.py:526-588: HelpConfig(24, 6, 8), pool 128, pioneer
#: 16, graph MATCH) scaled to 1,500 inserts and 750 deletes; its recall bar
MUT_SMALL_INSERTS, MUT_SMALL_DELETES, MUT_RECALL_FLOOR = 1500, 750, 0.9
#: the kernels at the step's shapes: the delta scan (B = 128 against the
#: capacity of 4,096 rows) and link_nodes's hop scoring (D = 3,584 linked
#: rows against pool·Γ = 128·32 = 4,096 candidates)
MUT_SCAN_ROWS, MUT_HOP_SHAPE = 4096, (3584, 4096)
#: phase 4's tiered step: the traffic of the reference's cache_sweep
#: (benchmarks/paper_benchmarks.py:807-816, benchmarks/trace.py): 512
#: requests over 128 distinct queries at Zipf skews 0, 0.8 and 1.2, 4
#: tenants round robin, 5e-5 s a request in geometric bursts of mean 4;
#: window 2 ms, buckets 1/8/32; hot budgets 0 and N/8, an epoch every 128
#: queries; the graph backend pinned at k = 10 (pool 40: the rerank's R)
TIER_REQUESTS, TIER_DISTINCT, TIER_SKEWS = 512, 128, (0.0, 0.8, 1.2)
TIER_SPACING_S, TIER_BURST, TIER_BUCKETS, TIER_EPOCH = 5e-5, 4.0, (1, 8, 32), 128
#: gather_auto at the tiered rerank (R rows a query in a staged buffer) at
#: the batches timed, and at a serve bucket-8 graph hop (B, C)
TIER_RERANK, TIER_STAGED_BATCHES, TIER_HOP8 = 40, (8, 128), (8, 1280)
#: phase 4's sharded step: the search cell on a (data=1, model=SHARDS) mesh
#: on the one card, exact then pq at ADC_S; every SERVE_SOLO_EVERY-th row
#: of each batch held to its solo search; a save and Engine.load round
#: trip; the first SHARD_SERVE_REQUESTS of the serve trace. Its checks: the
#: exhaustive merge at SHARD_EXH_N rows (pool = shard rows) against the
#: card's brute oracle, and card against CPU at SMALL_N
SHARDS, SHARD_EXH_N, SHARD_SERVE_REQUESTS = 4, 4096, 256
#: gather_auto at a shard hop: a refine hop (B, C) over one shard's rows
SHARD_HOP = (128, 1280)


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed between two CUDA events after a warm-up replay.
    The replay leaves out the host's time in the wrapper before each
    launch, which ``cuda_ms`` counts and which sets it for kernels shorter
    than about 0.1 ms. Memory freed inside the capture is reused by the
    next call, so the graph holds about one call's outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # build and allocate outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def target_cases(rng, qa_np, labels: int):
    """point, interval and masked (point + mask) target operands."""
    lo = np.minimum(qa_np, rng.integers(0, labels, qa_np.shape))
    hi = np.maximum(qa_np, rng.integers(0, labels, qa_np.shape))
    mask = rng.integers(0, 2, qa_np.shape).astype(np.int32)
    return {
        "point": (qa_np, None),
        "interval": (np.stack([lo, hi], -1).astype(np.int32), None),
        "masked": (qa_np, mask),
    }


def check_kernels(dev, ds, alpha: float, seed: int) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from repro_torch.core import to_tensor
    from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_ref
    from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref
    from repro_torch.kernels.gather_auto.ref import penalty_sa

    rng = np.random.default_rng(seed)
    f32, i32 = torch.float32, torch.int32
    db_v = to_tensor(ds.features, f32, dev)
    db_a = to_tensor(ds.attrs, i32, dev)
    n, m = db_v.shape
    l = db_a.shape[1]
    report = {}

    # ---- gather_auto at the main path's three shapes (GATHER_SHAPES)
    worst_ratio, max_err, invariant = 0.0, 0.0, True
    timings = {}
    for tag, (b, c) in GATHER_SHAPES.items():
        rows = rng.integers(0, n, b)
        qv = db_v[to_tensor(rows, torch.int64, dev)]
        cand_np = rng.integers(-1, n, (b, c)).astype(np.int32)
        cand_np[rng.random((b, c)) < 0.1] = -1  # INVALID slots, as traversal makes
        cand = to_tensor(cand_np, i32, dev)
        for tname, (qa_np, mask_np) in target_cases(rng, ds.attrs[rows], ds.labels_per_dim).items():
            qa = to_tensor(qa_np, i32, dev)
            mask = None if mask_np is None else to_tensor(mask_np, i32, dev)
            for mode in ("auto", "l2"):
                got = gather_auto(qv, qa, db_v, db_a, cand, alpha, mode, mask)
                want = gather_auto_ref(qv, qa, db_v, db_a, cand, alpha, mode, mask)
                torch.cuda.synchronize()
                err = (got.double() - want.double()).abs()
                tol = GATHER_RTOL * want.double().abs() + 1e-6
                worst_ratio = max(worst_ratio, float((err / tol).max()))
                max_err = max(max_err, float(err.max()))
                for r in (0, 77, b - 1):
                    sl = slice(r, r + 1)
                    alone = gather_auto(
                        qv[sl].contiguous(), qa[sl].contiguous(), db_v, db_a,
                        cand[sl].contiguous(), alpha, mode,
                        None if mask is None else mask[sl].contiguous(),
                    )
                    invariant &= bool(torch.equal(alone[0], got[r]))
                log(f"  gather_auto {tag:7s} B={b} C={c} {tname:8s} {mode:4s} "
                    f"max|err|={float(err.max()):.3e} worst err/tol={float((err / tol).max()):.3f}")
        qa = to_tensor(ds.attrs[rows], i32, dev)
        tm = timings[tag] = dict(
            ms=cuda_ms(lambda: gather_auto(qv, qa, db_v, db_a, cand, alpha, "auto")),
            device_ms=device_ms(lambda: gather_auto(qv, qa, db_v, db_a, cand, alpha, "auto")),
            l2_device_ms=device_ms(lambda: gather_auto(qv, qa, db_v, db_a, cand, alpha, "l2")),
            plain_ms=cuda_ms(lambda: gather_auto_ref(qv, qa, db_v, db_a, cand, alpha, "auto")),
        )
        valid = cand[cand >= 0]
        rows_read = int(torch.unique(valid).numel())
        n_pairs = int(valid.numel())
        # each distinct row read once (the bound), and, as context, each
        # pair's row read from device memory
        tm["bound_ms"], tm["bound_by"] = bound(
            rows_read * (m + l) * 4 + b * c * 4 * 2 + b * (m + 2 * l) * 4,
            n_pairs * (3 * m + 4 * l + 4))
        tm["l2_bound_ms"], _ = bound(rows_read * m * 4 + b * c * 4 * 2 + b * m * 4,
                                     n_pairs * (3 * m + 1))
        tm["every_pair_from_memory_ms"], _ = bound(
            n_pairs * (m + l) * 4 + b * c * 4 * 2 + b * (m + 2 * l) * 4, 0)
        tm.update(rows=rows_read, pairs=n_pairs, shape=f"B={b} C={c} M={m} L={l}")
        log(f"  gather_auto {tag} B={b} C={c} M={m}: auto kernel {tm['ms']:.4f} ms (device "
            f"{tm['device_ms']:.4f} ms), l2 device {tm['l2_device_ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms; bound auto {tm['bound_ms']:.4f} ms ({tm['bound_by']}), "
            f"l2 {tm['l2_bound_ms']:.4f} ms; every pair's row from memory "
            f"{tm['every_pair_from_memory_ms']:.4f} ms ({rows_read} rows, {n_pairs} pairs)")
        del qv, qa, cand
    if worst_ratio > 1.0:
        raise SystemExit(f"gather_auto disagrees with its plain version: err/tol {worst_ratio:.3f}")
    if not invariant:
        raise SystemExit("gather_auto: a row alone (0, 77 or B-1) is not bitwise equal to the "
                         "same row in the batch")
    log(f"  gather_auto: max|err| {max_err:.3e} (tol {GATHER_RTOL:g}·|ref| + 1e-6), "
        f"rows 0, 77, B-1 batch-invariant bitwise: {invariant}")
    timings["hop"]["shape"] += " (refine hop)"
    report["gather_auto"] = dict(
        max_abs_err=max_err, worst_err_over_tol=worst_ratio, bitwise_batch_invariant=invariant,
        **timings["hop"], descent_block=timings["descent"], narrow_block=timings["narrow"],
        library_ms=None,
    )

    # ---- fused_auto: the brute oracle / psi shape (128 x N)
    b = 128
    rows = rng.integers(0, n, b)
    qv = to_tensor(ds.query_features[rng.integers(0, ds.query_features.shape[0], b)], f32, dev)
    qsq = (qv.double() ** 2).sum(1)[:, None]
    xsq = (db_v.double() ** 2).sum(1)[None, :]
    worst_ratio, max_err, invariant = 0.0, 0.0, True
    for tname, (qa_np, mask_np) in target_cases(rng, ds.attrs[rows], ds.labels_per_dim).items():
        qa = to_tensor(qa_np, i32, dev)
        mask = None if mask_np is None else to_tensor(mask_np, i32, dev)
        for mode in ("auto", "l2"):
            got = fused_auto(qv, qa, db_v, db_a, alpha, mode, mask)
            want = fused_auto_ref(qv, qa, db_v, db_a, alpha, mode, mask)
            torch.cuda.synchronize()
            pen2 = 1.0
            if mode == "auto":
                sa = penalty_sa(qa, db_a[None].expand(b, -1, -1), mask).double()
                pen2 = (1.0 + sa / alpha) ** 2
                del sa
            tol = (FUSED_RTOL_NORMS * (qsq + xsq) + FUSED_ATOL) * pen2 + 1e-6 * want.double().abs()
            err = (got.double() - want.double()).abs()
            ratio = float((err / tol).max())
            worst_ratio = max(worst_ratio, ratio)
            max_err = max(max_err, float(err.max()))
            alone = fused_auto(
                qv[:1].contiguous(), qa[:1].contiguous(), db_v, db_a, alpha, mode,
                None if mask is None else mask[:1].contiguous(),
            )
            invariant &= bool(torch.equal(alone[0], got[0]))
            log(f"  fused_auto  B={b} N={n} {tname:8s} {mode:4s} max|err|={float(err.max()):.3e} "
                f"worst err/tol={ratio:.3f}")
            del got, want, err, tol, pen2
    if worst_ratio > 1.0:
        raise SystemExit(f"fused_auto disagrees with its plain version: err/tol {worst_ratio:.3f}")
    if not invariant:
        raise SystemExit("fused_auto: row 0 alone is not bitwise equal to row 0 in the batch")
    qa = to_tensor(ds.attrs[rows], i32, dev)
    ms = cuda_ms(lambda: fused_auto(qv, qa, db_v, db_a, alpha, "l2"))
    dev_ms = device_ms(lambda: fused_auto(qv, qa, db_v, db_a, alpha, "l2"))
    plain_ms = cuda_ms(lambda: fused_auto_ref(qv, qa, db_v, db_a, alpha, "l2"))
    library_ms = cuda_ms(lambda: torch.cdist(qv, db_v))
    auto_ms = cuda_ms(lambda: fused_auto(qv, qa, db_v, db_a, alpha, "auto"))
    auto_dev_ms = device_ms(lambda: fused_auto(qv, qa, db_v, db_a, alpha, "auto"))
    bytes_ = (b * m + n * m + n * l + b * l * 2) * 4 + b * n * 4
    ops = 2 * b * n * m + 2 * (b + n) * m + 4 * b * n
    bound_ms = max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS) * 1e3
    bound_by = "bytes" if bytes_ / PEAK_BYTES_PER_S >= ops / PEAK_F32_FLOPS else "operations"
    log(f"  fused_auto  B={b} N={n} M={m} l2: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, "
        f"torch.cdist {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{2 * b * n * m / ms / 1e9:.2f} TFLOP/s")
    log(f"  fused_auto  B={b} N={n} M={m} auto: kernel {auto_ms:.4f} ms (device "
        f"{auto_dev_ms:.4f} ms): the epilogue's penalty costs {auto_dev_ms - dev_ms:.4f} ms")
    tiles = {}
    for bt in FUSED_TILE_BATCHES:
        qv_t, qa_t = qv[:bt].contiguous(), qa[:bt].contiguous()
        tiles[bt] = {f"{md}_device_ms": device_ms(
            lambda md=md: fused_auto(qv_t, qa_t, db_v, db_a, alpha, md))
            for md in ("l2", "auto")}
        tiles[bt]["library_ms"] = cuda_ms(lambda: torch.cdist(qv_t, db_v))
        t_bytes = (bt * m + n * m + n * l + bt * l * 2) * 4 + bt * n * 4
        t_ops = 2 * bt * n * m + 2 * (bt + n) * m + 4 * bt * n
        tiles[bt]["bound_ms"], tiles[bt]["bound_by"] = bound(t_bytes, t_ops)
        log(f"  fused_auto  B={bt} N={n} M={m}: device l2 {tiles[bt]['l2_device_ms']:.4f} ms, "
            f"auto {tiles[bt]['auto_device_ms']:.4f} ms, torch.cdist "
            f"{tiles[bt]['library_ms']:.4f} ms, bound {tiles[bt]['bound_ms']:.4f} ms "
            f"({tiles[bt]['bound_by']})")
    log(f"  fused_auto: max|err| {max_err:.3e} (tol (1e-5·(|q|²+|x|²)+1e-6)·pen² + 1e-6·|ref|), "
        f"batch-invariant bitwise: {invariant}")
    report["fused_auto"] = dict(
        max_abs_err=max_err, worst_err_over_tol=worst_ratio, bitwise_batch_invariant=invariant,
        shape=f"B=128 N={n} M=128 L=5 (brute oracle)", ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        auto_ms=auto_ms, auto_device_ms=auto_dev_ms, tiles=tiles,
    )
    del db_v, db_a, qsq, xsq
    torch.cuda.empty_cache()
    return report


def check_fused_auto_exact(dev, alpha: float, seed: int) -> dict:
    """Phase 2: fused_auto on integer-valued operands (features in
    [-20, 20], so every sum is exact in f32) equals its plain version bit
    for bit, in auto and l2 modes with point, interval and masked targets,
    at every batch of FUSED_EXACT_BATCHES (each tile) and width of
    FUSED_EXACT_WIDTHS; and rows 0, 77 and B-1 of B = 128 and B = 512
    batches of float data equal single-row calls bit for bit."""
    from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_ref

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    l, labels, cases, invariant = 5, 4, 0, True
    for m in FUSED_EXACT_WIDTHS:
        for i, b in enumerate(FUSED_EXACT_BATCHES):
            n = FUSED_EXACT_ROWS[i % 2]
            qv = torch.randint(-20, 21, (b, m), generator=g, device=dev).float()
            xv = torch.randint(-20, 21, (n, m), generator=g, device=dev).float()
            xa = torch.randint(0, labels, (n, l), generator=g, device=dev, dtype=torch.int32)
            qa = torch.randint(0, labels, (b, l), generator=g, device=dev, dtype=torch.int32)
            other = torch.randint(0, labels, (b, l), generator=g, device=dev, dtype=torch.int32)
            mask = torch.randint(0, 2, (b, l), generator=g, device=dev, dtype=torch.int32)
            targets = {
                "point": (qa, None),
                "interval": (torch.stack([torch.minimum(qa, other), torch.maximum(qa, other)], -1)
                             .contiguous(), None),
                "masked": (qa, mask),
            }
            for tname, (qt, mk) in targets.items():
                for mode in ("auto", "l2"):
                    got = fused_auto(qv, qt, xv, xa, alpha, mode, mk)
                    want = fused_auto_ref(qv, qt, xv, xa, alpha, mode, mk)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        bad = int((got != want).sum())
                        raise SystemExit(
                            f"fused_auto B={b} N={n} M={m} {tname} {mode}: {bad} outputs differ "
                            f"from the plain version on integer data "
                            f"(max|err| {float((got - want).abs().max()):.3e})")
                    cases += 1
            del xv, got, want
        for b in (128, 512):  # float data, rows against single-row calls
            qv = torch.randn((b, m), generator=g, device=dev)
            xv = torch.randn((FUSED_EXACT_ROWS[1], m), generator=g, device=dev)
            xa = torch.randint(0, labels, (xv.shape[0], l), generator=g, device=dev,
                               dtype=torch.int32)
            qa = torch.randint(0, labels, (b, l), generator=g, device=dev, dtype=torch.int32)
            for mode in ("auto", "l2"):
                full = fused_auto(qv, qa, xv, xa, alpha, mode)
                for r in (0, 77, b - 1):
                    one = fused_auto(qv[r:r + 1].contiguous(), qa[r:r + 1].contiguous(), xv, xa,
                                     alpha, mode)
                    invariant &= bool(torch.equal(one[0], full[r]))
            del xv, full
    if not invariant:
        raise SystemExit("fused_auto: a row of a B=128 or B=512 batch differs from a single-row call")
    log(f"  fused_auto: {cases} integer cases bit for bit against the plain version "
        f"(B in {FUSED_EXACT_BATCHES}, M in {FUSED_EXACT_WIDTHS}, N in {FUSED_EXACT_ROWS}); "
        f"rows 0, 77, B-1 of B=128 and 512 equal single-row calls: {invariant}")

    # above the staged attributes: auto mode, integer data, bit for bit (the
    # plain version in slices of 16 rows, exact on integer data whatever
    # the slicing, to bound its (B, N, L) temporaries)
    n, m, many = FUSED_EXACT_ROWS[1], 128, 0
    xv = torch.randint(-20, 21, (n, m), generator=g, device=dev).float()
    for l in FUSED_MANY_ATTRS:
        xa = torch.randint(0, labels, (n, l), generator=g, device=dev, dtype=torch.int32)
        for b in FUSED_MANY_ATTRS_BATCHES:
            qv = torch.randint(-20, 21, (b, m), generator=g, device=dev).float()
            qa = torch.randint(0, labels, (b, l), generator=g, device=dev, dtype=torch.int32)
            other = torch.randint(0, labels, (b, l), generator=g, device=dev, dtype=torch.int32)
            mask = torch.randint(0, 2, (b, l), generator=g, device=dev, dtype=torch.int32)
            iv = torch.stack([torch.minimum(qa, other), torch.maximum(qa, other)], -1).contiguous()
            for tname, (qt, mk) in {"point": (qa, None), "interval": (iv, None),
                                    "masked": (qa, mask)}.items():
                got = fused_auto(qv, qt, xv, xa, alpha, "auto", mk)
                want = torch.cat([
                    fused_auto_ref(qv[r0:r0 + 16], qt[r0:r0 + 16], xv, xa, alpha, "auto",
                                   None if mk is None else mk[r0:r0 + 16])
                    for r0 in range(0, b, 16)])
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(
                        f"fused_auto B={b} N={n} M={m} L={l} {tname} auto: "
                        f"{int((got != want).sum())} outputs differ from the plain version")
                many += 1
                del got, want
    log(f"  fused_auto: {many} integer cases above the staged attributes bit for bit "
        f"(L in {FUSED_MANY_ATTRS}, B in {FUSED_MANY_ATTRS_BATCHES}, N={n}, M={m}, auto)")
    del xv, xa
    torch.cuda.empty_cache()
    return {"fused_auto_exact_cases": cases, "fused_auto_many_attrs_cases": many,
            "fused_auto_rows_equal_single_calls": invariant}


def check_gather_wide(dev, alpha: float, seed: int) -> dict:
    """Phase 2: gather_auto at widths above the 48 KB query row its first
    kernel staged (GATHER_WIDE), B = 4, C = 64, every target kind and mode,
    against its plain version (GATHER_RTOL), and each row against a
    single-row call bit for bit."""
    from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref

    g = torch.Generator(device=dev).manual_seed(seed + 9)
    rng = np.random.default_rng(seed + 9)
    b, c, n, l, labels = 4, 64, 2048, 5, 4
    worst, max_err, invariant = 0.0, 0.0, True
    for m in GATHER_WIDE:
        db_v = torch.randn((n, m), generator=g, device=dev)
        db_a = torch.randint(0, labels, (n, l), generator=g, device=dev, dtype=torch.int32)
        qv = torch.randn((b, m), generator=g, device=dev)
        cand = torch.from_numpy(rng.integers(-1, n, (b, c)).astype(np.int32)).to(dev)
        qa_np = rng.integers(0, labels, (b, l)).astype(np.int32)
        for tname, (qt_np, mk_np) in target_cases(rng, qa_np, labels).items():
            qt = torch.from_numpy(qt_np).to(dev)
            mk = None if mk_np is None else torch.from_numpy(mk_np).to(dev)
            for mode in ("auto", "l2"):
                got = gather_auto(qv, qt, db_v, db_a, cand, alpha, mode, mk)
                want = gather_auto_ref(qv, qt, db_v, db_a, cand, alpha, mode, mk).double()
                torch.cuda.synchronize()
                err = (got.double() - want).abs()
                worst = max(worst, float((err / (GATHER_RTOL * want.abs() + 1e-6)).max()))
                max_err = max(max_err, float(err.max()))
                for r in range(b):
                    sl = slice(r, r + 1)
                    alone = gather_auto(qv[sl].contiguous(), qt[sl].contiguous(), db_v, db_a,
                                        cand[sl].contiguous(), alpha, mode,
                                        None if mk is None else mk[sl].contiguous())
                    invariant &= bool(torch.equal(alone[0], got[r]))
        log(f"  gather_auto B={b} C={c} M={m}: worst err/tol so far {worst:.3f}, rows equal "
            f"single-row calls: {invariant}")
        del db_v, db_a, qv
    if worst > 1.0:
        raise SystemExit(f"gather_auto at M in {GATHER_WIDE} disagrees with its plain version: "
                         f"err/tol {worst:.3f}")
    if not invariant:
        raise SystemExit(f"gather_auto at M in {GATHER_WIDE}: a row differs from a single-row call")
    torch.cuda.empty_cache()
    return {"wide": dict(widths=GATHER_WIDE, max_abs_err=max_err, worst_err_over_tol=worst,
                         rows_equal_single_calls=invariant)}


def check_adc_kernels(dev, ds, alpha: float, seed: int) -> dict:
    """Phase 2: adc_scan (K = 256) and adc_scan4 (K = 16) at the brute
    path's shape (B = 128, N, S = 64), bit for bit against their plain
    versions. Codes and tables are random (uniform codes, tables >= 0)."""
    from repro_torch.core import to_tensor
    from repro_torch.kernels.adc_scan.ops import (
        adc_scan4_ref, adc_scan4_scores, adc_scan_ref, adc_scan_scores,
    )
    from repro_torch.quant import pack_nibbles

    rng = np.random.default_rng(seed + 1)
    b, s = 128, ADC_S
    n = ds.attrs.shape[0]
    db_a = to_tensor(ds.attrs, torch.int32, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.rand((b, s, 256), generator=g, device=dev) * 100
    codes = torch.randint(0, 256, (n, s), generator=g, device=dev, dtype=torch.uint8)
    lut4, codes4 = lut[:, :, :16].contiguous(), (codes & 0xF).contiguous()
    packed = pack_nibbles(codes4)
    kernels = {
        "adc_scan": (adc_scan_scores, adc_scan_ref, lut, codes),
        "adc_scan4": (adc_scan4_scores, adc_scan4_ref, lut4, packed),
    }
    stats = {name: dict(max_abs_err=0.0, bitwise=True, invariant=True) for name in kernels}
    packed_equals_unpacked = True
    rows = rng.integers(0, n, b)

    def one_case(tag, name, fn, ref, lt, cd, qa, xa, mode, mask):
        got = fn(lt, cd, qa, xa, alpha, mode, mask)
        want = ref(lt, cd, qa, xa, alpha, mode, mask)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["bitwise"] &= bool(torch.equal(got, want))
        alone = fn(lt[:1].contiguous(), cd, qa[:1].contiguous(), xa, alpha, mode,
                   None if mask is None else mask[:1].contiguous())
        st["invariant"] &= bool(torch.equal(alone[0], got[0]))
        log(f"  {name:9s} {tag} {mode:4s} max|err|={err:.3e} bitwise={torch.equal(got, want)}")
        return got

    for tname, (qa_np, mask_np) in target_cases(rng, ds.attrs[rows], ds.labels_per_dim).items():
        qa = to_tensor(qa_np, torch.int32, dev)
        mask = None if mask_np is None else to_tensor(mask_np, torch.int32, dev)
        for mode in ("auto", "l2"):
            for name, (fn, ref, lt, cd) in kernels.items():
                got = one_case(f"B={b} N={n} S={s} {tname:8s}", name, fn, ref, lt, cd, qa, db_a,
                               mode, mask)
                if name == "adc_scan4":
                    unpacked = adc_scan_scores(lut4, codes4, qa, db_a, alpha, mode, mask)
                    packed_equals_unpacked &= bool(torch.equal(got, unpacked))
                    del unpacked
                del got
    # odd S: fewer subspaces than the 32 residue classes, and a partial second
    # chunk; the 4-bit scanner's pad nibble counts as +0.0
    n_odd = 10007
    for s_odd in ADC_ODD_S:
        lut_o, lut4_o = lut[:16, :s_odd].contiguous(), lut4[:16, :s_odd].contiguous()
        codes_o, codes4_o = codes[:n_odd, :s_odd].contiguous(), codes4[:n_odd, :s_odd].contiguous()
        for tname, (qa_np, mask_np) in target_cases(rng, ds.attrs[rows[:16]],
                                                    ds.labels_per_dim).items():
            qa = to_tensor(qa_np, torch.int32, dev)
            mask = None if mask_np is None else to_tensor(mask_np, torch.int32, dev)
            for mode in ("auto", "l2"):
                tag = f"B=16 N={n_odd} S={s_odd} {tname:8s}"
                one_case(tag, "adc_scan", adc_scan_scores, adc_scan_ref, lut_o, codes_o, qa,
                         db_a[:n_odd], mode, mask)
                got = one_case(tag, "adc_scan4", adc_scan4_scores, adc_scan4_ref, lut4_o,
                               pack_nibbles(codes4_o), qa, db_a[:n_odd], mode, mask)
                unpacked = adc_scan_scores(lut4_o, codes4_o, qa, db_a[:n_odd], alpha, mode, mask)
                packed_equals_unpacked &= bool(torch.equal(got, unpacked))
    for name, st in stats.items():
        if not st["bitwise"]:
            raise SystemExit(f"{name} is not bitwise equal to its plain version "
                             f"(max|err| {st['max_abs_err']:.3e})")
        if not st["invariant"]:
            raise SystemExit(f"{name}: row 0 alone is not bitwise equal to row 0 in the batch")
    if not packed_equals_unpacked:
        raise SystemExit("adc_scan4 on packed codes differs from adc_scan on the unpacked codes")
    log(f"  adc_scan4 on packed codes == adc_scan on the unpacked codes, bitwise: "
        f"{packed_equals_unpacked}")

    report = {}
    qa = to_tensor(ds.attrs[rows], torch.int32, dev)
    sm_clock_hz = max_sm_clock_mhz() * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (fn, ref, lt, cd) in kernels.items():
        ms = cuda_ms(lambda: fn(lt, cd, qa, db_a, alpha, "l2"))
        dev_ms = device_ms(lambda: fn(lt, cd, qa, db_a, alpha, "l2"))
        auto_dev_ms = device_ms(lambda: fn(lt, cd, qa, db_a, alpha, "auto"))
        plain_ms = cuda_ms(lambda: ref(lt, cd, qa, db_a, alpha, "l2"), reps=5)
        k = lt.shape[2]
        bytes_ = cd.numel() + lt.numel() * 4 + b * n * 4  # codes, tables, scores (l2 mode)
        ops = b * n * (s + 1)  # one add per subspace and the clamp
        bound_ms = max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS) * 1e3
        bound_by = "bytes" if bytes_ / PEAK_BYTES_PER_S >= ops / PEAK_F32_FLOPS else "operations"
        # one shared-memory table lookup per add; an SM serves 32 a clock
        ceiling_ms = b * n * s / (n_sm * SMEM_LOOKUPS_PER_CLOCK * sm_clock_hz) * 1e3
        log(f"  {name} B={b} N={n} S={s} K={k} l2: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
            f"auto device {auto_dev_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); lookup ceiling {ceiling_ms:.4f} ms "
            f"({n_sm} SMs x {SMEM_LOOKUPS_PER_CLOCK} a clock at {sm_clock_hz / 1e6:.0f} MHz); "
            f"{b * n * s / dev_ms / 1e6:.1f} G lookups/s")
        report[name] = dict(
            max_abs_err=stats[name]["max_abs_err"], worst_err_over_tol=0.0,
            bitwise_equal=stats[name]["bitwise"], bitwise_batch_invariant=stats[name]["invariant"],
            shape=f"B={b} N={n} S={s} K={k} L={ds.attr_dim} (brute ADC scan, l2)",
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            auto_device_ms=auto_dev_ms, lookup_ceiling_ms=ceiling_ms,
            # no single PyTorch call computes this: the one-hot product
            # would need an (N, S*K) one-hot of N*S*K*4 bytes (64 GB at 1M)
            library_ms=None,
        )
    report["adc_scan4"]["packed_equals_unpacked"] = packed_equals_unpacked
    del lut, codes, lut4, codes4, packed, db_a
    torch.cuda.empty_cache()
    return report


def predicate_batches(ds, b: int = 128) -> dict:
    """MATCH, subset (active=[0, 1]), ONE_OF and BETWEEN batches of b."""
    from repro_torch.api import ANY, BETWEEN, MATCH, ONE_OF, Query, QueryBatch

    qf, qa = ds.query_features, ds.query_attrs
    labels = ds.labels_per_dim
    lo, hi = slice(0, b), slice(b, 2 * b)
    return {
        "MATCH": QueryBatch.match(qf[lo], qa[lo]),
        "subset": QueryBatch.match(qf[hi], qa[hi], active=[0, 1]),
        "ONE_OF": QueryBatch.from_queries([
            Query(qf[i], [ONE_OF(int(a[0]), (int(a[0]) + 1) % labels), MATCH(int(a[1])), ANY,
                          MATCH(int(a[3])), MATCH(int(a[4]))])
            for i, a in enumerate(qa[lo])
        ]),
        "BETWEEN": QueryBatch.from_queries([
            Query(qf[b + i], [BETWEEN(0, 1), MATCH(int(a[1])), MATCH(int(a[2])),
                              BETWEEN(1, labels - 1), ANY])
            for i, a in enumerate(qa[hi])
        ]),
    }


def match_recall(dev, ds) -> tuple[float, object]:
    """Engine.build + MATCH graph search recall@10 against the brute
    oracle; returns the recall and the engine."""
    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.core.baselines import recall_at_k

    eng = Engine.build(ds.features, ds.attrs, device=dev)
    q = QueryBatch.match(ds.query_features[:128], ds.query_attrs[:128])
    g = eng.search(q, SearchParams(k=10, backend="graph"))
    o = eng.search(q, SearchParams(k=10, backend="brute"))
    return recall_at_k(g.ids.cpu(), o.ids.cpu(), 10), eng


def check_small_input(dev, seed: int) -> dict:
    """Phase 3: the main path on the card against the CPU's plain versions
    on an input where the reference's recall is high."""
    from repro_torch.data.synthetic import make_hybrid_dataset

    ds = make_hybrid_dataset(n=SMALL_N, n_queries=128, profile="sift", seed=seed)
    card, card_eng = match_recall(dev, ds)
    t0 = time.perf_counter()
    cpu, cpu_eng = match_recall(torch.device("cpu"), ds)
    log(f"  N={SMALL_N}: MATCH recall@10 card {card:.4f}, CPU plain versions {cpu:.4f} "
        f"(CPU run {time.perf_counter() - t0:.1f} s)")
    if card < MATCH_RECALL_FLOOR:
        raise SystemExit(f"MATCH recall@10 on the card {card:.4f} < {MATCH_RECALL_FLOOR}")
    if abs(card - cpu) > SMALL_RECALL_GAP:
        raise SystemExit(f"card recall {card:.4f} vs CPU {cpu:.4f}: gap > {SMALL_RECALL_GAP}")
    out = {"n": SMALL_N, "recall_card": card, "recall_cpu": cpu}
    for mode in ("pq4", "pq"):
        t0 = time.perf_counter()
        on_card = quant_match_recall(card_eng, ds, mode)
        t1 = time.perf_counter()
        on_cpu = quant_match_recall(cpu_eng, ds, mode)
        log(f"  N={SMALL_N} {mode} S={ADC_S}: MATCH recall@10 card {on_card}, CPU {on_cpu} "
            f"(card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s)")
        for backend, r in on_card.items():
            if abs(r - on_cpu[backend]) > SMALL_RECALL_GAP:
                raise SystemExit(f"{mode} {backend}: card recall {r:.4f} vs CPU "
                                 f"{on_cpu[backend]:.4f}: gap > {SMALL_RECALL_GAP}")
        out[mode] = {"card": on_card, "cpu": on_cpu}
    return out


def quant_match_recall(exact, ds, mode: str) -> dict:
    """The codec trained over the built exact engine's rows and attached to
    its graph (what Engine.build with the codec builds: the graph over the
    exact rows, then the codec), then MATCH recall@10 of the graph and
    brute backends against the exact oracle."""
    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.quant import QuantConfig, QuantizedVectors

    store = QuantizedVectors.build(exact.index.features, QuantConfig(mode, pq_subspaces=ADC_S))
    eng = Engine(dataclasses.replace(exact.index, quant=store))
    q = QueryBatch.match(ds.query_features[:128], ds.query_attrs[:128])
    oracle = eng.search(q, SearchParams(k=10, backend="brute", quant="none")).ids.cpu()
    return {b: recall_at_k(eng.search(q, SearchParams(k=10, backend=b)).ids.cpu(), oracle, 10)
            for b in ("graph", "brute")}


#: the port's kernels by the name their CUDA symbol carries
OUR_KERNELS = ("gather_auto_kernel", "fused_auto_kernel", "adc_scan", "fm_interaction_kernel",
               "fm_interaction_bwd_kernel")


def profile_call(label: str, fn, warmup: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler, after one warm-up unless
    told otherwise: wall time, the device's busy time (kernel self time,
    summed as torch's own table total does), each of the port's kernels'
    part of it and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    ours = {k: sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3
            for k in OUR_KERNELS}
    ours = {k: v for k, v in ours.items() if v > 0}
    log(f"  profile {label}: wall {wall_ms:.2f} ms under the profiler, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%, idle {100 - 100 * busy_ms / wall_ms:.1f}%); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items()))
    for e in top:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "ours_ms": ours,
            "top": [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top]}


def profile_search(eng, q, params) -> dict:
    """One search under torch.profiler (``profile_call``)."""
    return profile_call(params.backend, lambda: eng.search(q, params))


def check_result(res, n: int, b: int, k: int = 10) -> None:
    """What a search returns is well formed: (B, k) ids in [-1, N), finite
    squared distances sorted ascending (INVALID slots carry INF = 3e38)."""
    ids, sq = res.ids.cpu(), res.sqdists.cpu()
    if tuple(ids.shape) != (b, k) or tuple(sq.shape) != (b, k):
        raise SystemExit(f"result shape {tuple(ids.shape)} / {tuple(sq.shape)} != {(b, k)}")
    if not bool(((ids >= -1) & (ids < n)).all()):
        raise SystemExit("result ids out of range")
    if not bool(torch.isfinite(sq).all()) or not bool((sq[:, 1:] >= sq[:, :-1]).all()):
        raise SystemExit("result distances not finite and ascending")


def run_main_path(dev, ds, reps: int = 5):
    """Phase 4, exact: Engine.build, then graph and brute searches per
    class, a MATCH pool sweep and one auto-planned search. Returns the
    results and the engine."""
    from repro_torch.api import Engine, SearchParams
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.kernels.fused_auto.ops import fused_auto
    from repro_torch.kernels.gather_auto.ops import gather_auto

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    eng = Engine.build(ds.features, ds.attrs, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    rep = eng.index.report
    build_launches = {"gather_auto": gather_auto.launches, "fused_auto": fused_auto.launches}
    log(f"  build: N={eng.n_items} alpha={eng.index.metric_cfg.alpha:.6f} rounds={rep.rounds} "
        f"psi={[round(p, 4) for p in rep.psi_history]} pruned={rep.pruned_edge_fraction:.4f} "
        f"build_s={build_s:.2f} launches={build_launches}")
    out = {"build_s": build_s, "rounds": rep.rounds, "psi_history": rep.psi_history,
           "pruned_edge_fraction": rep.pruned_edge_fraction, "build_launches": build_launches,
           "classes": {}}
    for name, q in predicate_batches(ds).items():
        row = {}
        for backend in ("graph", "brute"):
            params = SearchParams(k=10, backend=backend)
            g0 = gather_auto.launches
            lat = []
            for _ in range(reps):
                t1 = time.perf_counter()
                res = eng.search(q, params)
                sync()
                lat.append(time.perf_counter() - t1)
            med = statistics.median(lat)
            check_result(res, eng.n_items, q.batch_size)
            row[backend] = dict(
                ids=res.ids.cpu().numpy(), median_ms=med * 1e3, qps=q.batch_size / med,
                mean_evals=res.mean_dist_evals, hops=int(res.n_hops),
                gather_launches_per_search=(gather_auto.launches - g0) / reps,
            )
        rec = recall_at_k(row["graph"]["ids"], row["brute"]["ids"], 10)
        g, br = row["graph"], row["brute"]
        log(f"  {name:7s} recall@10={rec:.4f} graph {g['median_ms']:.2f} ms "
            f"({g['qps']:.0f} QPS, {g['hops']} hops, {g['median_ms'] / max(g['hops'], 1):.3f} ms/hop, "
            f"evals {g['mean_evals']:.1f}, {g['gather_launches_per_search']:.0f} gather launches) | "
            f"brute {br['median_ms']:.2f} ms ({br['qps']:.0f} QPS)")
        out["classes"][name] = dict(
            recall_at_10=rec, graph_ms=g["median_ms"], graph_qps=g["qps"], hops=g["hops"],
            mean_dist_evals=g["mean_evals"], brute_ms=br["median_ms"], brute_qps=br["qps"],
            gather_launches_per_search=g["gather_launches_per_search"],
        )
    q = predicate_batches(ds)["MATCH"]
    oracle = eng.search(q, SearchParams(k=10, backend="brute")).ids.cpu()
    out["match_pool_sweep"] = {}
    for pool in (40, 128, 512):
        params = SearchParams(k=10, pool_size=pool, backend="graph")
        eng.search(q, params)
        sync()
        t1 = time.perf_counter()
        res = eng.search(q, params)
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        rec = recall_at_k(res.ids.cpu(), oracle, 10)
        out["match_pool_sweep"][pool] = dict(recall_at_10=rec, ms=ms, hops=int(res.n_hops),
                                             mean_dist_evals=res.mean_dist_evals)
        log(f"  MATCH pool {pool}: recall@10={rec:.4f} {ms:.2f} ms {int(res.n_hops)} hops "
            f"evals {res.mean_dist_evals:.1f}")
    t1 = time.perf_counter()
    plan = eng.plan(q, SearchParams(k=10))  # calibrates the cost model on the card
    res = eng.search(q, SearchParams(k=10))
    sync()
    log(f"  auto plan: {plan.backend} ({plan.reason}); probe + search "
        f"{time.perf_counter() - t1:.2f} s; recall@10="
        f"{recall_at_k(res.ids.cpu(), oracle, 10):.4f}; cost model {eng.cost_model.to_json()}")
    out["auto_plan"] = dict(backend=plan.backend, reason=plan.reason,
                            cost_model=eng.cost_model.to_json())
    return out, eng


def serve_queries(ds) -> list:
    """ds's query vectors, cycled through four predicate kinds: MATCH on
    every attribute; MATCH on attributes 0 and 1, ANY on the rest; ONE_OF
    of two labels on attribute 0; BETWEEN(0, 1) on attribute 0 (MATCH on
    the rest in both)."""
    from repro_torch.api import ANY, BETWEEN, MATCH, ONE_OF, Query

    labels, out = ds.labels_per_dim, []
    for i, (v, a) in enumerate(zip(ds.query_features, ds.query_attrs)):
        a = [int(x) for x in a]
        rest = [MATCH(x) for x in a[1:]]
        out.append(Query(v, [
            [MATCH(x) for x in a],
            [MATCH(a[0]), MATCH(a[1])] + [ANY] * (len(a) - 2),
            [ONE_OF(a[0], (a[0] + 1) % labels)] + rest,
            [BETWEEN(0, 1)] + rest,
        ][i % 4]))
    return out


def serve_trace(ds, seed: int):
    """(tenants, trace) of phase 4: SERVE_REQUESTS requests from
    SERVE_TENANTS tenants in turn (``serve_queries``), Poisson arrivals at
    SERVE_RATE a second drawn from ``seed``, as (arrival s, Request)."""
    from repro_torch.serve import Request

    tenants = [f"tenant-{t}" for t in range(SERVE_TENANTS)]
    queries = serve_queries(ds)
    arrivals = np.cumsum(np.random.default_rng(seed).exponential(1.0 / SERVE_RATE, SERVE_REQUESTS))
    reqs = [Request(tenants[i % SERVE_TENANTS], queries[i % len(queries)], request_id=i)
            for i in range(SERVE_REQUESTS)]
    return tenants, list(zip(arrivals.tolist(), reqs))


def serve_registry(tenants, params):
    """A TenantRegistry giving every tenant ``params`` and no rate limit."""
    from repro_torch.serve import TenantPolicy, TenantRegistry

    reg = TenantRegistry()
    for t in tenants:
        reg.register(t, TenantPolicy(params=params))
    return reg


def run_serve_path(dev, ds, eng, seed: int):
    """Phase 4, serving: a multi-tenant request trace through the port's
    serve_loop on the exact engine, once on each backend; every 16th
    response against its query searched alone, bit for bit; a
    ThreadedServer on 4 client threads against serve_loop's answers; one
    scrape of its metrics endpoint. Returns the results and a bucket-128
    graph flush of 128 MATCH requests, which the caller profiles last."""
    import threading
    import urllib.request
    from collections import defaultdict

    from repro_torch.api import QueryBatch, SearchParams
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.kernels.fused_auto.ops import fused_auto
    from repro_torch.kernels.gather_auto.ops import gather_auto
    from repro_torch.serve import (
        Completed, Microbatcher, ServerStats, ThreadedServer, serve_loop,
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    class BucketStats(ServerStats):
        """ServerStats that also keeps each batch's service ms by bucket."""

        def __init__(self, engine):
            super().__init__(engine)
            self.by_bucket = defaultdict(list)

        def record_batch(self, n_real, bucket, service_s):
            super().record_batch(n_real, bucket, service_s)
            self.by_bucket[bucket].append(service_s * 1e3)

    tenants, trace = serve_trace(ds, seed)
    reqs = [r for _, r in trace]

    def registry(params):
        return serve_registry(tenants, params)

    log(f"  serve trace: {SERVE_REQUESTS} requests, {SERVE_TENANTS} tenants round robin, "
        f"4 predicate kinds, Poisson arrivals at {SERVE_RATE:.0f}/s over "
        f"{trace[-1][0] * 1e3:.1f} ms of serve_loop's virtual clock; window {SERVE_WINDOW_MS} ms, "
        f"buckets {SERVE_BUCKETS}, no rate limit, k=10")
    out, answers = {}, {}
    for backend in ("graph", "brute"):
        params = SearchParams(k=10, backend=backend)
        stats = BucketStats(eng)
        g0, f0 = gather_auto.launches, fused_auto.launches
        t0 = time.perf_counter()
        resp, _ = serve_loop(eng, trace, registry(params), window_ms=SERVE_WINDOW_MS,
                             buckets=SERVE_BUCKETS, stats=stats)
        sync()
        wall_s = time.perf_counter() - t0
        snap = stats.snapshot()  # before the solo searches touch the plan cache
        launches = {"gather_auto": gather_auto.launches - g0,
                    "fused_auto": fused_auto.launches - f0}
        kernel = "gather_auto" if backend == "graph" else "fused_auto"
        if launches[kernel] == 0:
            raise SystemExit(f"serve {backend}: {kernel} was not launched")
        if not all(isinstance(r, Completed) for r in resp):
            raise SystemExit(f"serve {backend}: not every response is Completed: "
                             f"{sorted({type(r).__name__ for r in resp})}")
        ids = np.stack([r.ids for r in resp])
        if ids.shape != (SERVE_REQUESTS, 10) or ((ids < -1) | (ids >= eng.n_items)).any():
            raise SystemExit(f"serve {backend}: ids of shape {ids.shape} out of range")
        if not all(np.isfinite(r.dists[r.ids >= 0]).all() for r in resp):
            raise SystemExit(f"serve {backend}: a valid slot's distance is not finite")
        for i in range(0, SERVE_REQUESTS, SERVE_SOLO_EVERY):
            alone = eng.search(QueryBatch.from_queries([reqs[i].query]), params)
            if not (np.array_equal(alone.ids[0].cpu().numpy(), resp[i].ids)
                    and np.array_equal(alone.dists[0].cpu().numpy(), resp[i].dists)):
                raise SystemExit(f"serve {backend}: request {i} (bucket {resp[i].bucket}) differs "
                                 f"from its query searched alone")
        lat = snap["latency_ms"]
        service = {b: dict(batches=len(v), mean_ms=statistics.fmean(v))
                   for b, v in sorted(stats.by_bucket.items())}
        out[backend] = row = dict(
            p50_ms=lat["p50"], p95_ms=lat["p95"], p99_ms=lat["p99"],
            queue_ms_p99=snap["queue_ms_p99"], service_ms_p99=snap["service_ms_p99"],
            service_by_bucket=service, batches=snap["batches"],
            batch_fill_ratio=snap["batch_fill_ratio"],
            plan_cache_hit_rate=snap["plan_cache"]["hit_rate"],
            compiled_plans=snap["retraces"], offered_qps_virtual=snap["qps"],
            wall_s=wall_s, launches=launches,
        )
        answers[backend] = resp
        log(f"  serve {backend}: {snap['completed']}/{snap['submitted']} Completed in "
            f"{snap['batches']} batches, fill {snap['batch_fill_ratio']:.4f}; end-to-end p50 "
            f"{lat['p50']:.3f} p95 {lat['p95']:.3f} p99 {lat['p99']:.3f} ms (queue p99 "
            f"{snap['queue_ms_p99']:.3f}, service p99 {snap['service_ms_p99']:.3f}); plan cache "
            f"hit rate {row['plan_cache_hit_rate']:.4f} ({row['compiled_plans']} plans compiled); "
            f"launches {launches}; {wall_s:.2f} s of wall time")
        log(f"    service ms by bucket: " + ", ".join(
            f"{b}: {s['mean_ms']:.3f} x{s['batches']}" for b, s in service.items()))
        log(f"    QPS {snap['qps']:.1f} is the offered rate on serve_loop's virtual clock, "
            f"not a capacity; every {SERVE_SOLO_EVERY}th response equals its solo search bit "
            f"for bit")
    recall = recall_at_k(np.stack([r.ids for r in answers["graph"]]),
                         np.stack([r.ids for r in answers["brute"]]), 10)
    out["recall_at_10_graph_vs_brute"] = recall
    log(f"  serve recall@10 of the graph run against the brute run: {recall:.4f} "
        f"(printed, not gated: the algorithm's at N = 1M)")

    # a ThreadedServer on the wall clock: 4 client threads submit at once
    graph = SearchParams(k=10, backend="graph")
    take = reqs[:SERVE_THREADED]
    futures = [None] * len(take)
    with ThreadedServer(eng, registry(graph), window_ms=SERVE_WINDOW_MS, buckets=SERVE_BUCKETS,
                        metrics_port=0) as srv:
        def client(c):
            for i in range(c, len(take), SERVE_CLIENTS):
                futures[i] = srv.submit(take[i])

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        if any(t.is_alive() for t in clients):
            raise SystemExit("serve: a ThreadedServer client did not finish submitting")
        threaded = [f.result(timeout=600) for f in futures]
        wall_s = time.perf_counter() - t0
        url = srv.metrics_server.url
        text = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        scraped = json.loads(urllib.request.urlopen(url + "/metrics.json", timeout=30).read())
    for i, r in enumerate(threaded):
        want = answers["graph"][i]
        if not (isinstance(r, Completed) and np.array_equal(r.ids, want.ids)
                and np.array_equal(r.dists, want.dists)):
            raise SystemExit(f"serve: ThreadedServer's answer to request {i} differs from "
                             f"serve_loop's")
    snap = srv.stats.snapshot()
    prom = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            prom[name] = float(value)
    if not (prom.get("serve_completed") == snap["completed"] == len(take)
            == scraped["providers"]["serve_completed"]):
        raise SystemExit(f"serve: metrics endpoint counts {prom.get('serve_completed')} / "
                         f"{scraped['providers'].get('serve_completed')} completed, stats "
                         f"{snap['completed']}")
    lat = snap["latency_ms"]
    out["threaded"] = dict(requests=len(take), clients=SERVE_CLIENTS, wall_s=wall_s,
                           requests_per_s=len(take) / wall_s, p50_ms=lat["p50"],
                           p99_ms=lat["p99"], batches=snap["batches"],
                           batch_fill_ratio=snap["batch_fill_ratio"],
                           metrics_lines=len(prom))
    log(f"  serve ThreadedServer (graph, {SERVE_CLIENTS} client threads): {len(take)} requests "
        f"in {wall_s:.3f} s = {len(take) / wall_s:.1f} requests/s on the wall clock; end-to-end "
        f"p50 {lat['p50']:.3f} p99 {lat['p99']:.3f} ms; {snap['batches']} batches, fill "
        f"{snap['batch_fill_ratio']:.4f}; every answer equals serve_loop's bit for bit; "
        f"/metrics ({len(prom)} samples) and /metrics.json scraped, serve_completed "
        f"{snap['completed']}")

    # one bucket-128 graph flush under the profiler: 128 MATCH requests
    match = [r for r in reqs if r.request_id % 4 == 0][:SERVE_BUCKETS[-1]]

    def flush() -> float:
        """Enqueue the 128 requests (each planned at B = 1); the last one
        flushes the bucket. Returns the flush's service ms."""
        stats = ServerStats(eng)
        mb = Microbatcher(eng, stats, window_s=1.0, buckets=SERVE_BUCKETS)
        done = [c for r in match for c in mb.enqueue(r, graph, 0.0)]
        if len(done) != len(match) or done[0].bucket != SERVE_BUCKETS[-1]:
            raise SystemExit("serve: 128 MATCH requests did not flush as one bucket-128 batch")
        return stats.service_wall_s * 1e3

    walls, services = [], []
    for _ in range(6):  # the first warms up
        t0 = time.perf_counter()
        services.append(flush())
        walls.append((time.perf_counter() - t0) * 1e3)
    out["flush_128"] = dict(wall_ms=statistics.median(walls[1:]),
                            service_ms=statistics.median(services[1:]))
    log(f"  serve bucket-128 graph flush of 128 MATCH requests: {out['flush_128']['wall_ms']:.3f} ms "
        f"from the first enqueue to the last answer, of which the search (service) "
        f"{out['flush_128']['service_ms']:.3f} ms (medians of 5, host clock)")
    return out, flush


def run_quant_path(dev, ds, eng, reps: int = 5):
    """Phase 4, quantized: train each codec over the built index's rows and
    attach it to the same graph, then search MATCH and ONE_OF on both
    backends against the exact oracle. Returns the results and the pq
    engine (profiled last)."""
    from repro_torch.api import Engine, SearchParams
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.quant import QuantConfig, QuantizedVectors, is_pq_mode

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    batches = predicate_batches(ds)
    classes = {c: batches[c] for c in ("MATCH", "ONE_OF")}
    oracle = {c: eng.search(q, SearchParams(k=10, backend="brute")).ids.cpu()
              for c, q in classes.items()}
    feats = eng.index.features
    out, keep = {}, None
    for mode in QUANT_MODES:
        t0 = time.perf_counter()
        store = QuantizedVectors.build(feats, QuantConfig(mode, pq_subspaces=ADC_S))
        sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = store.encode_rows(feats)
        sync()
        encode_s = time.perf_counter() - t0
        if not torch.equal(again, store.codes):
            raise SystemExit(f"{mode}: encode_rows disagrees with the codes built")
        del again
        qeng = Engine(dataclasses.replace(eng.index, quant=store))
        row = dict(train_s=build_s - encode_s, encode_s=encode_s,
                   code_bytes_per_row=store.code_bytes_per_row, classes={})
        log(f"  {mode:7s} S={ADC_S}: train {build_s - encode_s:.2f} s, encode {encode_s:.2f} s, "
            f"{store.code_bytes_per_row} B/row ({store.code_bytes / 1e6:.1f} MB)")
        for cname, q in classes.items():
            for backend in ("graph", "brute"):
                params = SearchParams(k=10, backend=backend)
                plan = qeng.plan(q, params)
                lat = []
                for _ in range(reps):
                    t1 = time.perf_counter()
                    res = qeng.search(q, params)
                    sync()
                    lat.append(time.perf_counter() - t1)
                med = statistics.median(lat)
                check_result(res, qeng.n_items, q.batch_size)
                rec = recall_at_k(res.ids.cpu(), oracle[cname], 10)
                row["classes"][f"{cname}/{backend}"] = r = dict(
                    codec=plan.quant_mode, recall_at_10=rec, median_ms=med * 1e3,
                    qps=q.batch_size / med, fp_evals=res.mean_dist_evals,
                    code_evals=res.mean_code_evals, hops=int(res.n_hops),
                )
                log(f"    {cname:6s} {backend:5s} ({plan.quant_mode:7s}) recall@10={rec:.4f} "
                    f"{r['median_ms']:.2f} ms ({r['qps']:.0f} QPS) fp evals {r['fp_evals']:.1f} "
                    f"code evals {r['code_evals']:.1f} hops {r['hops']}")
        brute_match = row["classes"]["MATCH/brute"]["recall_at_10"]
        if is_pq_mode(mode) and brute_match < MATCH_RECALL_FLOOR:
            raise SystemExit(f"{mode}: brute-ADC MATCH recall@10 {brute_match:.4f} "
                             f"< {MATCH_RECALL_FLOOR}")
        out[mode] = row
        if mode == "pq":
            keep = qeng
        del store, qeng
    return out, keep


def part_config(n: int) -> tuple[int, int]:
    """(P, √P) of the reference's scale_sweep: P = 2^round(log2(N/8000)),
    at least 8; the probe default round(√P)."""
    p = max(8, 2 ** int(round(math.log2(max(n // 8000, 8)))))
    return p, max(1, int(round(math.sqrt(p))))


def part_nprobes(p: int, sp: int) -> list:
    """scale_sweep's nprobe points: 1, √P/2, √P and 2√P (at most P)."""
    return sorted({1, max(1, sp // 2), sp, min(2 * sp, p)})


def run_partitioned_path(dev, ds, eng, seed: int, workdir: str):
    """Phase 4, partitioned: Engine.build_partitioned at scale_sweep's
    configuration with the pq codec, saved and loaded back under a cap on
    resident rows; an nprobe sweep on the brute sub-backend (exact), the
    pq brute and the graph sub-backends at √P, the full probe held to the
    flat exact engine ``eng`` and to a flat pq engine over the same codes
    bit for bit, device memory after evict_all, and 256 requests of
    phase 4's trace served on the partitioned engine. Returns the results
    and what ``check_partition_probe`` and the profile need."""
    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.kernels.adc_scan.ops import adc_scan_scores
    from repro_torch.kernels.fused_auto.ops import fused_auto
    from repro_torch.kernels.gather_auto.ops import gather_auto
    from repro_torch.partition import row_bucket
    from repro_torch.quant import QuantConfig, QuantizedVectors
    from repro_torch.serve import Completed, ServerStats, serve_loop

    n, l = ds.attrs.shape
    p, sp = part_config(n)
    nprobes = part_nprobes(p, sp)
    help_cfg = HelpConfig(**PART_HELP_KW)
    t0 = time.perf_counter()
    built = Engine.build_partitioned(
        ds.features, ds.attrs, n_partitions=p, help_cfg=help_cfg, device=dev,
        quant_cfg=QuantConfig(mode="pq", pq_subspaces=ADC_S),
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    secs = built.index.build_seconds
    sizes = built.index.summaries.n_rows
    cap = max(row_bucket(int(r)) for r in sizes) * max(4, sp)
    row_bytes = ds.features.shape[1] * 4 + l * 4 + help_cfg.gamma * 4 + ADC_S + 4
    out = dict(n_partitions=p, sqrt_p=sp, build_s=build_s, build_split_s=secs,
               sizes=dict(min=int(sizes.min()), median=float(np.median(sizes)),
                          max=int(sizes.max())),
               cap_rows=cap, cap_fraction=cap / n, bytes_per_row=row_bytes)
    log(f"  build_partitioned: N={n} P={p} in {build_s:.2f} s (codec {secs['codec']:.2f} s, "
        f"k-means {secs['kmeans']:.2f} s, {p} partition builds {secs['partitions']:.2f} s); "
        f"partition rows min {sizes.min()} median {np.median(sizes):.1f} max {sizes.max()}; "
        f"cap {cap} rows ({cap / n:.4f} of N) x {row_bytes} B a row")
    path = os.path.join(workdir, "index")
    t0 = time.perf_counter()
    built.save(path)
    out["save_s"] = time.perf_counter() - t0
    out["saved_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(path) for f in fs)
    del built
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    peng = Engine.load(path, device=dev, residency_rows=cap)
    store = peng.index.store
    log(f"  saved in {out['save_s']:.2f} s ({out['saved_bytes'] / 1e9:.3f} GB); loaded with "
        f"residency_rows={cap}")

    qb = QueryBatch.match(ds.query_features[:PART_QUERIES], ds.query_attrs[:PART_QUERIES],
                          active=[0])
    truth = eng.search(qb, SearchParams(k=10, backend="brute")).ids.cpu()
    wrappers = {"fused_auto": fused_auto, "gather_auto": gather_auto,
                "adc_scan": adc_scan_scores}

    def point(params, reps: int = 3) -> dict:
        store.evict_all()
        store.reset_counters()
        t1 = time.perf_counter()
        res = peng.search(qb, params)  # cold: every partition loads
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t1) * 1e3
        before = {k: w.launches for k, w in wrappers.items()}
        lat = []
        for _ in range(reps):
            t1 = time.perf_counter()
            res = peng.search(qb, params)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        check_result(res, n, qb.batch_size)
        st = store.stats()
        if st["peak_resident_rows"] > cap:
            raise SystemExit(f"partitioned: peak resident rows {st['peak_resident_rows']} > cap {cap}")
        return dict(recall_at_10=recall_at_k(res.ids.cpu(), truth, 10),
                    median_ms=statistics.median(lat), cold_ms=cold_ms, store=st,
                    fp_evals=res.mean_dist_evals, code_evals=res.mean_code_evals,
                    launches_per_search={k: (w.launches - before[k]) / reps
                                         for k, w in wrappers.items()})

    out["sweep"] = {}
    for nprobe in nprobes:
        params = SearchParams(k=10, nprobe=nprobe, sub_backend="brute", quant="none")
        if nprobe == 1:
            torch.cuda.reset_peak_memory_stats()
        r = out["sweep"][nprobe] = point(params)
        if nprobe == 1:
            r["peak_allocated_bytes"] = torch.cuda.max_memory_allocated() - mem0
            log(f"    peak device bytes allocated above the load's start during nprobe={nprobe}: "
                f"{r['peak_allocated_bytes']} (cap x bytes a row = {cap * row_bytes})")
        log(f"  nprobe={nprobe:3d} brute exact: recall@10={r['recall_at_10']:.4f} "
            f"{r['median_ms']:.2f} ms (cold {r['cold_ms']:.2f}); fp evals {r['fp_evals']:.1f}; "
            f"launches a search {r['launches_per_search']}; store {r['store']}")
    if not any(r["store"]["evictions"] > 0 for r in out["sweep"].values()):
        raise SystemExit("partitioned: the cap forced no eviction at any nprobe")
    rec = out["sweep"][sp]["recall_at_10"]
    if rec < PART_RECALL_FLOOR:
        raise SystemExit(f"partitioned: recall@10 {rec:.4f} at nprobe={sp} < {PART_RECALL_FLOOR}")
    out["pq"] = point(SearchParams(k=10, nprobe=sp, sub_backend="brute"))
    log(f"  nprobe={sp} brute pq: recall@10={out['pq']['recall_at_10']:.4f} "
        f"{out['pq']['median_ms']:.2f} ms; code evals {out['pq']['code_evals']:.1f}; launches a "
        f"search {out['pq']['launches_per_search']}; store {out['pq']['store']}")
    out["graph"] = point(SearchParams(k=10, nprobe=sp, sub_backend="graph", pool_size=64,
                                      enforce_equality=True, quant="none"))
    log(f"  nprobe={sp} graph (pool 64, enforce_equality): recall@10="
        f"{out['graph']['recall_at_10']:.4f} {out['graph']['median_ms']:.2f} ms; fp evals "
        f"{out['graph']['fp_evals']:.1f}; launches a search {out['graph']['launches_per_search']}; "
        f"store {out['graph']['store']}")

    # the full probe, bit for bit: exact against eng's brute oracle, pq
    # against a flat brute engine over the same codebook and codes
    codes = torch.empty((n, ADC_S), dtype=torch.uint8)
    for pid in range(p):
        part = peng.index._load_partition(pid)
        codes[torch.from_numpy(np.array(part.row_ids))] = torch.from_numpy(np.array(part.codes))
    pidx = peng.index
    pq_flat = Engine.from_parts(
        eng.index.features, eng.index.attrs, eng.index.graph, eng.index.metric_cfg,
        stats=eng.index.stats, device=dev,
        quant=QuantizedVectors(cfg=pidx.quant_cfg, codes=codes.to(dev), codebook=pidx.codebook),
    )
    del codes
    out["full_probe"] = {}
    store.evict_all()
    store.reset_counters()
    for kind, q in predicate_batches(ds).items():
        for codec, flat in (("none", eng), ("pq", pq_flat)):
            want = flat.search(q, SearchParams(k=10, backend="brute"))
            got = peng.search(q, SearchParams(k=10, nprobe=p, sub_backend="brute",
                                              quant="none" if codec == "none" else "auto"))
            same = {f: bool(torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()))
                    for f in ("ids", "dists", "sqdists")}
            out["full_probe"][f"{kind}/{codec}"] = same
            if not all(same.values()):
                diff = int((got.ids.cpu() != want.ids.cpu()).sum())
                raise SystemExit(f"partitioned full probe {kind}/{codec}: not bit for bit equal "
                                 f"to the flat brute engine ({same}; {diff} ids differ)")
    log(f"  full probe nprobe={p}, brute sub-backend: ids, dists and sqdists equal to the flat "
        f"brute engine bit for bit on MATCH, subset, ONE_OF and BETWEEN, exact and pq; store "
        f"{store.stats()}")
    # an Engine and its executor refer to each other: only the cycle
    # collector frees the flat pq engine's 0.6 GB
    del pq_flat, flat, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # 256 requests of phase 4's trace on the partitioned engine
    tenants, trace = serve_trace(ds, seed)
    trace = trace[:PART_SERVE_REQUESTS]
    params = SearchParams(k=10, backend="partitioned", nprobe=sp, sub_backend="brute",
                          quant="none")
    stats = ServerStats(peng)
    t0 = time.perf_counter()
    resp, _ = serve_loop(peng, trace, serve_registry(tenants, params),
                         window_ms=SERVE_WINDOW_MS, buckets=SERVE_BUCKETS, stats=stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    snap = stats.snapshot()
    providers = stats.registry.snapshot()["providers"]
    if not all(isinstance(r, Completed) for r in resp):
        raise SystemExit(f"partitioned serve: not every response is Completed: "
                         f"{sorted({type(r).__name__ for r in resp})}")
    for i in range(0, len(resp), SERVE_SOLO_EVERY):
        alone = peng.search(QueryBatch.from_queries([trace[i][1].query]), params)
        if not (np.array_equal(alone.ids[0].cpu().numpy(), resp[i].ids)
                and np.array_equal(alone.dists[0].cpu().numpy(), resp[i].dists)):
            raise SystemExit(f"partitioned serve: request {i} (bucket {resp[i].bucket}) differs "
                             f"from its query searched alone")
    seg = {k[len("segment_store_"):]: v for k, v in providers.items()
           if k.startswith("segment_store_")}
    if not seg:
        raise SystemExit("partitioned serve: no segment_store provider in the ServerStats registry")
    lat = snap["latency_ms"]
    out["serve"] = dict(requests=len(resp), p50_ms=lat["p50"], p99_ms=lat["p99"],
                        service_ms_p99=snap["service_ms_p99"], batches=snap["batches"],
                        batch_fill_ratio=snap["batch_fill_ratio"], wall_s=wall_s,
                        segment_store=seg)
    log(f"  partitioned serve (nprobe={sp}, brute): {snap['completed']}/{len(resp)} Completed in "
        f"{snap['batches']} batches, fill {snap['batch_fill_ratio']:.4f}; end-to-end p50 "
        f"{lat['p50']:.3f} p99 {lat['p99']:.3f} ms (service p99 {snap['service_ms_p99']:.3f}); "
        f"{wall_s:.2f} s of wall time; every {SERVE_SOLO_EVERY}th response equals its solo search "
        f"bit for bit; registry segment_store {seg}")

    store.evict_all()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    limit = 2 * max(row_bucket(int(r)) for r in sizes) * row_bytes
    out["memory"] = dict(after_evict_all_bytes=grown, limit_bytes=limit)
    log(f"  device memory after evict_all: {grown} bytes above the level before the load "
        f"(limit: two staged partitions, {limit} bytes)")
    if grown >= limit:
        raise SystemExit(f"partitioned: {grown} bytes stay allocated after evict_all (>= {limit})")
    return out, (peng, qb, SearchParams(k=10, nprobe=sp, sub_backend="brute", quant="none"))


def check_partition_probe(dev, peng, qb, params) -> dict:
    """fused_auto (l2) and adc_scan (l2, K = 256) at the probe shape the
    partitioned step runs most: the median sub-batch bucket against the
    median partition bucket at ``params.nprobe``; each against its plain
    version, its rows against the same rows of a full-batch call bit for
    bit, timed (one call between CUDA events, and a CUDA-graph replay)
    beside its bound."""
    from repro_torch.core import to_tensor
    from repro_torch.kernels.adc_scan.ops import adc_scan_ref, adc_scan_scores
    from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_ref
    from repro_torch.partition import row_bucket
    from repro_torch.partition.search import _batch_bucket, _groups

    pidx = peng.index
    probes = pidx.probe(qb, params.nprobe, True)
    groups = _groups(probes)
    shapes = [(_batch_bucket(q.size, qb.batch_size), row_bucket(int(pidx.summaries.n_rows[pid])),
               pid) for pid, q in groups.items()]
    b = statistics.median_low([s[0] for s in shapes])
    nb = statistics.median_low([s[1] for s in shapes])
    pid = next(s[2] for s in shapes if s[1] == nb)
    part = pidx.store.get(pid)
    n, m = part.features.shape
    l = part.attrs.shape[1]
    qv_all = to_tensor(qb.vectors, torch.float32, dev)
    qa_all = to_tensor(qb.attrs, torch.int32, dev)
    qv, qa = qv_all[:b].contiguous(), qa_all[:b].contiguous()
    lut_all = pidx.query_lut(qv_all)
    lut = lut_all[:b].contiguous()
    report = {}

    got = fused_auto(qv, qa, part.features, part.attrs, mode="l2")
    want = fused_auto_ref(qv, qa, part.features, part.attrs, 1.0, "l2")
    full = fused_auto(qv_all, qa_all, part.features, part.attrs, mode="l2")
    invariant = bool(torch.equal(got, full[:b]))
    max_err, ratio = fused_err(got, want, qv, qa, part.features, part.attrs, 1.0, "l2")
    bytes_ = (b * m + n * m + n * l + b * l * 2) * 4 + b * n * 4
    ops = 2 * b * n * m + 2 * (b + n) * m + 4 * b * n
    bound_ms, bound_by = bound(bytes_, ops)
    report["fused_auto"] = dict(
        shape=f"B={b} N={n} M={m} L={l} l2 (partition {pid}, {part.n_real} rows)",
        max_abs_err=max_err, worst_err_over_tol=ratio, bitwise_batch_invariant=invariant,
        ms=cuda_ms(lambda: fused_auto(qv, qa, part.features, part.attrs, mode="l2")),
        device_ms=device_ms(lambda: fused_auto(qv, qa, part.features, part.attrs, mode="l2")),
        plain_ms=cuda_ms(lambda: fused_auto_ref(qv, qa, part.features, part.attrs, 1.0, "l2")),
        library_ms=cuda_ms(lambda: torch.cdist(qv, part.features)),
        bound_ms=bound_ms, bound_by=bound_by,
    )
    got = adc_scan_scores(lut, part.codes, qa, part.attrs, mode="l2")
    want = adc_scan_ref(lut, part.codes, qa, part.attrs, 1.0, "l2")
    full = adc_scan_scores(lut_all, part.codes, qa_all, part.attrs, mode="l2")
    s = part.codes.shape[1]
    bytes_ = part.codes.numel() + lut.numel() * 4 + b * n * 4
    ops = b * n * (s + 1)
    bound_ms, bound_by = bound(bytes_, ops)
    report["adc_scan"] = dict(
        shape=f"B={b} N={n} S={s} K={lut.shape[2]} L={l} l2 (partition {pid})",
        max_abs_err=float((got.double() - want.double()).abs().max()),
        bitwise_equal=bool(torch.equal(got, want)),
        bitwise_batch_invariant=bool(torch.equal(got, full[:b])),
        ms=cuda_ms(lambda: adc_scan_scores(lut, part.codes, qa, part.attrs, mode="l2")),
        device_ms=device_ms(lambda: adc_scan_scores(lut, part.codes, qa, part.attrs, mode="l2")),
        plain_ms=cuda_ms(lambda: adc_scan_ref(lut, part.codes, qa, part.attrs, 1.0, "l2"), reps=5),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
    )
    for name, r in report.items():
        log(f"  partition probe {name} {r['shape']}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max|err| {r['max_abs_err']:.3e}, "
            f"rows equal to a full-batch call's bitwise: {r['bitwise_batch_invariant']}")
    log(f"  probe shapes at nprobe={params.nprobe}: {len(shapes)} groups, sub-batch buckets "
        f"{sorted(collections.Counter(s[0] for s in shapes).items())}, partition buckets "
        f"{sorted(collections.Counter(s[1] for s in shapes).items())}")
    if ratio > 1.0:
        raise SystemExit(f"partition probe: fused_auto disagrees with its plain version "
                         f"(err/tol {ratio:.3f})")
    if not report["adc_scan"]["bitwise_equal"]:
        raise SystemExit("partition probe: adc_scan is not bitwise equal to its plain version")
    if not (invariant and report["adc_scan"]["bitwise_batch_invariant"]):
        raise SystemExit("partition probe: a kernel's rows differ from a full-batch call's")
    return report


def run_mutable_path(dev, ds, base: list, seed: int, workdir: str):
    """Phase 4, mutable: a MutableEngine over phase 4's exact index (handed
    over in ``base`` as (index, cost model); the caller keeps no reference,
    so the merge can free it). The fast path against Engine.search bit for
    bit; the write script logged to a WAL; the federated brute read against
    a fresh oracle over the logical corpus, no deleted id on either backend,
    inserted and overwritten rows found by their new vectors; the WAL
    replayed over the base bit for bit; a synchronous merge, timed by part;
    brute results unchanged across it; a checkpoint loaded back bit for
    bit; then serving with writes through serve_loop and a ThreadedServer
    that merges in the background. Returns the results and the merged
    engine, which ``check_mutable_kernels`` reads."""
    import threading
    import urllib.request

    from repro_torch.api import MATCH, Engine, Query, QueryBatch, SearchParams
    from repro_torch.core import to_tensor
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.core.graph_ops import in_degrees
    from repro_torch.core.index import StableIndex
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.kernels.fused_auto.ops import fused_auto
    from repro_torch.kernels.gather_auto.ops import gather_auto
    from repro_torch.mutable import CompactionPolicy, MutableEngine
    from repro_torch.serve import (
        Completed, Delete, Request, TenantPolicy, ThreadedServer, Upsert, WriteAck, serve_loop,
    )

    index, cost_model = base.pop()
    n, mdim = (int(x) for x in index.features.shape)
    labels = ds.labels_per_dim
    index_bytes = sum(t.numel() * t.element_size()
                      for t in (index.features, index.attrs, index.graph))
    wal_path = os.path.join(workdir, "mutable.wal")
    params = {b: SearchParams(k=10, backend=b) for b in ("graph", "brute")}
    batches = predicate_batches(ds)
    out = {}

    def engine(idx):
        return Engine(dataclasses.replace(idx), cost_model_override=cost_model)

    def search_all(eng):
        return {(kind, b): eng.search(q, p) for kind, q in batches.items()
                for b, p in params.items()}

    def differ(a: dict, b: dict) -> list:
        return [key for key in a if not all(
            torch.equal(getattr(a[key], f), getattr(b[key], f))
            for f in ("ids", "dists", "sqdists", "n_dist_evals"))]

    m = MutableEngine(engine(index), wal_path=wal_path)
    bad = differ(search_all(m.engine), search_all(m))
    if bad:
        raise SystemExit(f"mutable: with no writes, MutableEngine.search differs from "
                         f"Engine.search on {bad}")
    log(f"  fast path: with no writes MutableEngine.search equals Engine.search bit for bit on "
        f"both backends, four kinds, B=128")

    # the write script
    extra = make_hybrid_dataset(n=MUT_INSERTS + 2 * MUT_SERVE_INSERTS, n_queries=1,
                                profile="sift", seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    picked = rng.choice(n, MUT_OVERWRITES + MUT_DELETES + 2 * MUT_SERVE_DELETES, replace=False)
    over = np.sort(picked[:MUT_OVERWRITES])
    deleted = np.sort(picked[MUT_OVERWRITES:MUT_OVERWRITES + MUT_DELETES])
    serve_deletes = picked[MUT_OVERWRITES + MUT_DELETES:]
    new_v = (ds.features[over] + 0.05 * rng.standard_normal((len(over), mdim))).astype(np.float32)
    new_a = ((ds.attrs[over] + 1) % labels).astype(np.int32)
    inserted = np.arange(n, n + MUT_INSERTS)
    t0 = time.perf_counter()
    for j, i in enumerate(inserted):
        m.upsert(extra.features[j], extra.attrs[j], id=int(i))
    for r, i in enumerate(over):
        m.upsert(new_v[r], new_a[r], id=int(i))
    for i in deleted:
        if not m.delete(int(i)):
            raise SystemExit(f"mutable: delete of visible id {i} was not applied")
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    n_ops = len(inserted) + len(over) + len(deleted)
    ws = m.write_stats()
    out["writes"] = dict(ops=n_ops, seconds=write_s, per_s=n_ops / write_s, **ws)
    out["writes"]["policy_would_merge"] = m.should_merge()
    log(f"  writes: {len(inserted)} inserts, {len(over)} overwrites, {len(deleted)} deletes in "
        f"{write_s:.3f} s ({n_ops / write_s:.1f} a second, WAL {ws['wal_bytes']} bytes); delta "
        f"{ws['delta_rows']} rows ({ws['delta_alive']} alive), {ws['tombstones']} tombstones, "
        f"logical n={ws['logical_n']}; write_epoch {m.write_epoch}; the default policy's cost "
        f"gate would merge now: {out['writes']['policy_would_merge']} (direct writes never "
        f"merge: the merge below is asked for)")
    if ws["delta_rows"] != MUT_INSERTS + MUT_OVERWRITES or m.merge_count:
        raise SystemExit(f"mutable: delta {ws['delta_rows']} rows, {m.merge_count} merges")

    # a fresh brute oracle over the logical corpus: main minus deletes
    # (overwritten rows with their new values), then the inserts
    keep = np.setdiff1d(np.arange(n), deleted)
    feats = ds.features[keep]
    attrs = ds.attrs[keep].copy()
    pos = np.searchsorted(keep, over)
    feats[pos] = new_v
    attrs[pos] = new_a
    id_of = torch.from_numpy(np.concatenate([keep, inserted])).to(dev)
    oracle = Engine(StableIndex(
        features=to_tensor(np.concatenate([feats, extra.features[:MUT_INSERTS]]), torch.float32,
                           dev),
        attrs=to_tensor(np.concatenate([attrs, extra.attrs[:MUT_INSERTS]]), torch.int32, dev),
        graph=torch.zeros((len(id_of), 0), dtype=torch.int32, device=dev),
        metric_cfg=index.metric_cfg, help_cfg=index.help_cfg, stats=index.stats,
    ))
    del feats, attrs
    deleted_dev = torch.from_numpy(deleted).to(dev)
    pre, truth = {}, {}
    for kind, q in batches.items():
        want = oracle.search(q, params["brute"])
        want_ids = torch.where(want.ids >= 0, id_of[want.ids.clamp_min(0).long()], -1)
        got = pre[kind] = m.search(q, params["brute"])
        truth[kind] = want_ids
        check_topk((got.sqdists, got.ids), (want.sqdists.cpu(), want_ids.cpu()),
                   f"mutable {kind}: the federated brute read against the oracle")
    del oracle, id_of
    gc.collect()
    log("  federated brute read equals a fresh brute oracle over the logical corpus (main minus "
        "tombstones plus alive delta rows) on MATCH, subset, ONE_OF, BETWEEN: ids except "
        "near-ties, sqdists rtol 1e-5 (check_topk)")

    def self_hits(ids, vecs, attrs_, backend) -> np.ndarray:
        """For each row, whether a MATCH query with its vector and
        attributes returns ``ids[r]`` at rank 0."""
        hits = []
        for s in range(0, len(ids), 128):
            q = QueryBatch.match(vecs[s:s + 128], attrs_[s:s + 128])
            hits.append(m.search(q, params[backend]).ids[:, 0].cpu().numpy() == ids[s:s + 128])
        return np.concatenate(hits)

    res_all = search_all(m)
    old = QueryBatch.match(ds.features[over[:128]], ds.attrs[over[:128]])
    own = torch.from_numpy(over[:128, None].astype(np.int32)).to(dev)
    if (m.search(old, params["brute"]).ids == own).any():
        raise SystemExit("mutable brute: an overwritten id came back for its old attributes")
    for b in params:
        probe = QueryBatch.match(ds.features[deleted[:128]], ds.attrs[deleted[:128]])
        res_all["deleted_self", b] = m.search(probe, params[b])
        for what, ids_, v, a in (("inserted", inserted[:128], extra.features[:128],
                                  extra.attrs[:128]),
                                 ("overwritten", over[:128], new_v[:128], new_a[:128])):
            if not self_hits(ids_, v, a, b).all():
                raise SystemExit(f"mutable {b}: an {what} row is not first for its own vector")
    leaked = [key for key, r in res_all.items() if bool(torch.isin(r.ids, deleted_dev).any())]
    if leaked:
        raise SystemExit(f"mutable: a deleted id was returned on {leaked}")
    recall_pre = recall_at_k(res_all["MATCH", "graph"].ids.cpu(), truth["MATCH"].cpu(), 10)
    out["pre_merge"] = dict(graph_match_recall_at_10=recall_pre)
    log(f"  no deleted id on either backend (four kinds and the deleted rows' own vectors); 128 "
        f"inserted and 128 overwritten rows first for their new vectors on both backends, "
        f"overwritten ids absent for their old attributes on the brute backend; graph MATCH recall@10 against the "
        f"oracle {recall_pre:.4f} (printed: the algorithm's at N = 1M)")

    # the WAL replayed over the same base
    t0 = time.perf_counter()
    m2 = MutableEngine(engine(index), wal_path=wal_path)
    replay_s = time.perf_counter() - t0
    if m2.tombstones != m.tombstones or m2.n_items != m.n_items:
        raise SystemExit("mutable: WAL replay rebuilt another logical state")
    bad = differ(search_all(m), search_all(m2))
    if bad:
        raise SystemExit(f"mutable: searches after WAL replay differ on {bad}")
    m2.wal.close()
    del m2, index
    gc.collect()
    log(f"  WAL replay over the base: {n_ops} ops in {replay_s:.3f} s; searches equal the "
        f"original's bit for bit on both backends, four kinds")

    # the merge, synchronous
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    g0, f0 = gather_auto.launches, fused_auto.launches
    stats = m.merge()
    torch.cuda.synchronize()
    link_launches = {"gather_auto": gather_auto.launches - g0,
                     "fused_auto": fused_auto.launches - f0}
    gc.collect()
    torch.cuda.empty_cache()
    grown = torch.cuda.memory_allocated() - mem_before
    linked = np.concatenate([inserted, over])
    deg = in_degrees(m.index.graph, m.engine.n_items)
    in_share = float((deg[torch.from_numpy(linked).to(dev)] > 0).float().mean().cpu())
    out["merge"] = dict(stats=stats, launches=link_launches,
                        linked_in_edge_share=in_share, memory_grown_bytes=grown,
                        old_index_bytes=index_bytes)
    log(f"  merge: prepare {stats['prepare_ms']:.3f} ms, apply "
        f"{stats['apply_ms']:.3f} ms; linked {stats['linked']}, repaired {stats['repaired']}; "
        f"link_nodes launched {link_launches}; {in_share:.4f} of linked rows have an in-edge; "
        f"device memory {grown} bytes above its level before the merge once the old index "
        f"({index_bytes} bytes) is released")
    if stats["linked"] != len(linked) or link_launches["gather_auto"] == 0 \
            or link_launches["fused_auto"] == 0:
        raise SystemExit(f"mutable merge: linked {stats['linked']}, launches {link_launches}")
    if grown >= index_bytes // 4:
        raise SystemExit(f"mutable merge: {grown} bytes stay allocated: the old index was not "
                         f"released")
    bitwise = True
    for kind, q in batches.items():
        got = m.search(q, params["brute"])
        bitwise &= bool(torch.equal(got.sqdists, pre[kind].sqdists))
        check_topk((got.sqdists, got.ids), (pre[kind].sqdists.cpu(), pre[kind].ids.cpu()),
                   f"mutable {kind}: brute results across the merge")
    graph_post = m.search(batches["MATCH"], params["graph"]).ids
    if bool(torch.isin(graph_post, deleted_dev).any()):
        raise SystemExit("mutable: a deleted id came back after the merge")
    recall_post = recall_at_k(graph_post.cpu(), truth["MATCH"].cpu(), 10)
    self_graph = float(self_hits(inserted, extra.features[:MUT_INSERTS],
                                 extra.attrs[:MUT_INSERTS], "graph").mean())
    if not self_hits(inserted, extra.features[:MUT_INSERTS], extra.attrs[:MUT_INSERTS],
                     "brute").all():
        raise SystemExit("mutable: after the merge an inserted row is not first for its own "
                         "vector on the brute backend")
    out["post_merge"] = dict(graph_match_recall_at_10=recall_post, brute_sqdists_bitwise=bitwise,
                             inserted_self_hit_graph=self_graph)
    log(f"  after the merge: brute results equal the pre-merge ones (ids except near-ties, "
        f"sqdists bitwise {bitwise}); graph MATCH recall@10 {recall_post:.4f}; self-hit rate of "
        f"the {MUT_INSERTS} inserted rows at rank 0 on the graph backend {self_graph:.4f}")

    # checkpoint, then Engine.load + the WAL
    ck = os.path.join(workdir, "checkpoint")
    t0 = time.perf_counter()
    m.checkpoint(ck)
    ck_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = MutableEngine(Engine.load(ck, device=dev), wal_path=wal_path)
    load_s = time.perf_counter() - t0
    if loaded.tombstones != m.tombstones or loaded.n_items != m.n_items:
        raise SystemExit("mutable: the checkpoint and its WAL rebuild another logical state")
    bad = differ(search_all(m), search_all(loaded))
    if bad:
        raise SystemExit(f"mutable: the reloaded checkpoint's searches differ on {bad}")
    loaded.wal.close()
    del loaded
    gc.collect()
    shutil.rmtree(ck, ignore_errors=True)
    out["checkpoint"] = dict(save_s=ck_s, load_s=load_s, wal_bytes=m.write_stats()["wal_bytes"])
    log(f"  checkpoint in {ck_s:.2f} s (WAL now {out['checkpoint']['wal_bytes']} bytes: the "
        f"tombstones restated); Engine.load + WAL replay in {load_s:.2f} s equals the "
        f"checkpointed engine bit for bit on both backends, four kinds")

    # serving with writes: serve_loop, then a ThreadedServer that merges
    tenants, trace = serve_trace(ds, seed)
    reg = serve_registry(tenants, params["graph"])
    reg.register("ryw", TenantPolicy(params=params["brute"]))

    def write_items(half: int):
        """Inserts and deletes; their request ids (and the read-back
        requests') lie past the trace's, which are explicit."""
        base_row = MUT_INSERTS + half * MUT_SERVE_INSERTS
        ws_ = [Upsert(tenants[j % SERVE_TENANTS], extra.features[base_row + j],
                      extra.attrs[base_row + j], id=n + base_row + j,
                      request_id=SERVE_REQUESTS + 2 * j)
               for j in range(MUT_SERVE_INSERTS)]
        dl = serve_deletes[half * MUT_SERVE_DELETES:(half + 1) * MUT_SERVE_DELETES]
        return ws_ + [Delete(tenants[j % SERVE_TENANTS], int(i),
                             request_id=SERVE_REQUESTS + 2 * MUT_SERVE_INSERTS + j)
                      for j, i in enumerate(dl)]

    writes = write_items(0)
    stride = len(trace) // len(writes)
    mixed = []
    for i, (t, r) in enumerate(trace):
        if i % stride == 0 and i // stride < len(writes):
            mixed.append((t, writes[i // stride]))
        mixed.append((t, r))
    m.policy = CompactionPolicy(min_delta_rows=10 ** 9)  # size trigger only: no merge here
    t0 = time.perf_counter()
    resp, stats_ = serve_loop(m, mixed, reg, window_ms=SERVE_WINDOW_MS, buckets=SERVE_BUCKETS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    reads = [r for (_, item), r in zip(mixed, resp) if isinstance(item, Request)]
    acks = [r for (_, item), r in zip(mixed, resp) if not isinstance(item, Request)]
    if not (all(isinstance(r, Completed) for r in reads)
            and all(isinstance(r, WriteAck) and r.applied for r in acks)):
        raise SystemExit("mutable serve_loop: a read not Completed or a write not applied")
    snap = stats_.snapshot()
    lat = snap["latency_ms"]
    out["serve_loop"] = dict(reads=len(reads), writes=len(acks), p50_ms=lat["p50"],
                             p99_ms=lat["p99"], wall_s=wall_s, writes_block=snap["writes"],
                             delta=snap["delta"])
    log(f"  serve_loop with writes: {len(reads)} reads Completed, {len(acks)} writes applied "
        f"({snap['writes']}); end-to-end p50 {lat['p50']:.3f} p99 {lat['p99']:.3f} ms; "
        f"{wall_s:.2f} s of wall time; delta {snap['delta']}")

    # what the federated read adds to the main search it wraps, at a
    # serve bucket: the plain search, the same widened, the federated read
    q8 = batches["MATCH"].take(np.arange(SERVE_BUCKETS[1]))
    graph = params["graph"]
    calls = {"main": lambda: m.engine.search(q8, graph),
             "main_widened": lambda: m.engine.search(q8, m._widen(graph)),
             "federated": lambda: m.search(q8, graph)}
    read_ms = {}
    for name, fn in calls.items():
        fn()
        lat = []
        for _ in range(7):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        read_ms[name] = statistics.median(lat)
    out["read_ms_b8"] = read_ms
    log(f"  graph MATCH B={SERVE_BUCKETS[1]} with {m.delta.n_alive} delta rows and "
        f"{len(m.tombstones)} tombstones, host-clock medians of 7: main search "
        f"{read_ms['main']:.3f} ms, widened {read_ms['main_widened']:.3f} ms, federated read "
        f"{read_ms['federated']:.3f} ms")

    m.policy = CompactionPolicy(max_delta_rows=MUT_THREADED_DELTA, min_delta_rows=10 ** 9)
    merges0 = m.merge_count
    writes = write_items(1)
    reqs = [r for _, r in trace]
    answers, lat, ryw, errors = [None] * len(reqs), [], [], []
    lock = threading.Lock()
    with ThreadedServer(m, reg, window_ms=SERVE_WINDOW_MS, buckets=SERVE_BUCKETS,
                        metrics_port=0) as srv:
        def client(c):
            """A closed loop: submit one read, wait for it, then the next."""
            try:
                for i in range(c, len(reqs), SERVE_CLIENTS):
                    inflight = srv._merge_inflight
                    t1 = time.perf_counter()
                    answers[i] = srv.submit(reqs[i]).result(timeout=600)
                    ms = (time.perf_counter() - t1) * 1e3
                    with lock:
                        lat.append((ms, inflight or srv._merge_inflight))
            except Exception as exc:  # reported below, after the join
                errors.append(repr(exc))

        def writer():
            """The writes at MUT_WRITE_RATE a second, each insert read back
            at once."""
            try:
                for j, w in enumerate(writes):
                    time.sleep(max(t0 + j / MUT_WRITE_RATE - time.perf_counter(), 0.0))
                    ack = srv.submit(w).result(timeout=60)
                    if not (isinstance(ack, WriteAck) and ack.applied):
                        errors.append(f"write {w.id} answered {ack}")
                    if isinstance(w, Upsert):
                        ryw.append((w.id, srv.submit(Request("ryw", Query(
                            w.vector, [MATCH(int(v)) for v in w.attrs]),
                            request_id=w.request_id + 1)).result(timeout=600)))
            except Exception as exc:
                errors.append(repr(exc))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads) or errors:
            raise SystemExit(f"mutable ThreadedServer: a client did not finish: {errors[:4]}")
        wall_s = time.perf_counter() - t0
        text = urllib.request.urlopen(srv.metrics_server.url + "/metrics", timeout=30).read()
    if not all(isinstance(r, Completed) for r in answers):
        raise SystemExit(f"mutable ThreadedServer: a read is not Completed: "
                         f"{sorted({repr(r)[:120] for r in answers if not isinstance(r, Completed)})}")
    missed = [i for i, r in ryw if not (isinstance(r, Completed) and int(r.ids[0]) == i)]
    if missed:
        raise SystemExit(f"mutable ThreadedServer: read-your-writes failed for ids {missed[:8]}")
    merges = m.merge_count - merges0
    if merges == 0:
        raise SystemExit("mutable ThreadedServer: no background merge fired")
    prom = {}
    for line in text.decode().splitlines():
        if line.startswith(("serve_merge_ms_count", "serve_merge_ms_sum")):
            name, value = line.rsplit(" ", 1)
            prom[name] = float(value)
    snap = srv.stats.snapshot()
    if prom.get("serve_merge_ms_count") != merges or snap["writes"]["merges"] != merges:
        raise SystemExit(f"mutable: /metrics serve_merge_ms_count {prom.get('serve_merge_ms_count')}"
                         f", snapshot {snap['writes']['merges']}, merges {merges}")
    split_lat = {}
    for flag in (False, True):
        v = [ms for ms, f in lat if f == flag]
        split_lat["during_merge" if flag else "no_merge"] = dict(
            reads=len(v), p50_ms=float(np.percentile(v, 50)) if v else None,
            p99_ms=float(np.percentile(v, 99)) if v else None)
    out["threaded"] = dict(reads=len(answers), writes=len(writes), wall_s=wall_s,
                           merges=merges, merge_ms=list(m.merge_ms[-merges:]),
                           read_latency=split_lat, ryw_checked=len(ryw),
                           serve_merge_ms_prometheus=prom)
    log(f"  ThreadedServer with writes: {len(answers)} reads from {SERVE_CLIENTS} closed-loop "
        f"clients and {len(writes)} writes at {MUT_WRITE_RATE:.0f}/s in {wall_s:.3f} s; {merges} "
        f"background merges ({', '.join(f'{x:.1f}' for x in m.merge_ms[-merges:])} ms prepare "
        f"+ apply); read latency, submit to answer: {split_lat}; read-your-writes held on "
        f"{len(ryw)} acknowledged inserts; /metrics {prom}")
    return out, m


def check_mutable_kernels(dev, ds, m, alpha: float, seed: int) -> dict:
    """fused_auto at the delta scan (B = 128 against MUT_SCAN_ROWS rows,
    l2 and auto) and gather_auto at link_nodes's hop scoring (B = D = 3,584
    linked rows against 4,096 candidates, 10% INVALID as a pool pads,
    auto), on the merged index's rows: each against its plain version,
    timed (one call between CUDA events, and a CUDA-graph replay) beside
    its bound; fused_auto also beside torch.cdist."""
    from repro_torch.core import to_tensor
    from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_ref
    from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref

    rng = np.random.default_rng(seed)
    idx = m.index
    n, mdim = (int(x) for x in idx.features.shape)
    l = int(idx.attrs.shape[1])
    q = predicate_batches(ds)["MATCH"]
    qv = to_tensor(q.vectors, torch.float32, dev)
    qa = to_tensor(q.attrs, torch.int32, dev)
    b = qv.shape[0]
    rows_v = idx.features[n - MUT_SCAN_ROWS:].contiguous()
    rows_a = idx.attrs[n - MUT_SCAN_ROWS:].contiguous()
    report = {}
    worst, max_err = 0.0, 0.0
    for mode in ("l2", "auto"):
        got = fused_auto(qv, qa, rows_v, rows_a, alpha, mode)
        want = fused_auto_ref(qv, qa, rows_v, rows_a, alpha, mode)
        err, ratio = fused_err(got, want, qv, qa, rows_v, rows_a, alpha, mode)
        worst, max_err = max(worst, ratio), max(max_err, err)
    bytes_ = (b * mdim + MUT_SCAN_ROWS * (mdim + l) + b * l * 2) * 4 + b * MUT_SCAN_ROWS * 4
    ops = 2 * b * MUT_SCAN_ROWS * mdim + 2 * (b + MUT_SCAN_ROWS) * mdim + 4 * b * MUT_SCAN_ROWS
    bound_ms, bound_by = bound(bytes_, ops)
    report["fused_auto"] = dict(
        shape=f"delta scan B={b} C={MUT_SCAN_ROWS} M={mdim} L={l} l2", max_abs_err=max_err,
        worst_err_over_tol=worst,
        ms=cuda_ms(lambda: fused_auto(qv, qa, rows_v, rows_a, alpha, "l2")),
        device_ms=device_ms(lambda: fused_auto(qv, qa, rows_v, rows_a, alpha, "l2")),
        auto_device_ms=device_ms(lambda: fused_auto(qv, qa, rows_v, rows_a, alpha, "auto")),
        plain_ms=cuda_ms(lambda: fused_auto_ref(qv, qa, rows_v, rows_a, alpha, "l2")),
        library_ms=cuda_ms(lambda: torch.cdist(qv, rows_v)),
        bound_ms=bound_ms, bound_by=bound_by,
    )
    del got, want

    d, c = MUT_HOP_SHAPE
    node = torch.from_numpy(rng.choice(n, d, replace=False)).to(dev)
    hv, ha = idx.features[node].contiguous(), idx.attrs[node].contiguous()
    cand_np = rng.integers(0, n, (d, c)).astype(np.int32)
    cand_np[rng.random((d, c)) < 0.1] = -1
    cand = to_tensor(cand_np, torch.int32, dev)
    got = gather_auto(hv, ha, idx.features, idx.attrs, cand, alpha, "auto")
    want = gather_auto_ref(hv, ha, idx.features, idx.attrs, cand, alpha, "auto")
    err = (got.double() - want.double()).abs()
    ratio = float((err / (GATHER_RTOL * want.double().abs() + 1e-6)).max())
    del want
    valid = cand[cand >= 0]
    rows_read, pairs = int(torch.unique(valid).numel()), int(valid.numel())
    bound_ms, bound_by = bound(rows_read * (mdim + l) * 4 + d * c * 4 * 2 + d * (mdim + 2 * l) * 4,
                               pairs * (3 * mdim + 4 * l + 4))
    # as context: each pair's row read from device memory (the rows do not
    # fit in L2, and random candidates share few)
    every_pair_ms, _ = bound(pairs * (mdim + l) * 4 + d * c * 4 * 2 + d * (mdim + 2 * l) * 4, 0)
    report["gather_auto"] = dict(
        shape=f"link hop B={d} C={c} M={mdim} L={l} auto", max_abs_err=float(err.max()),
        worst_err_over_tol=ratio, rows=rows_read, pairs=pairs,
        every_pair_from_memory_ms=every_pair_ms,
        ms=cuda_ms(lambda: gather_auto(hv, ha, idx.features, idx.attrs, cand, alpha, "auto")),
        device_ms=device_ms(lambda: gather_auto(hv, ha, idx.features, idx.attrs, cand, alpha,
                                                "auto")),
        plain_ms=cuda_ms(lambda: gather_auto_ref(hv, ha, idx.features, idx.attrs, cand, alpha,
                                                 "auto"), reps=3),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
    )
    del got, err, cand
    torch.cuda.empty_cache()
    for name, r in report.items():
        log(f"  mutable {name} {r['shape']}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max|err| {r['max_abs_err']:.3e}, "
            f"worst err/tol {r['worst_err_over_tol']:.3f}")
    if worst > 1.0 or ratio > 1.0:
        raise SystemExit(f"mutable kernels: disagree with their plain versions (fused_auto "
                         f"err/tol {worst:.3f}, gather_auto {ratio:.3f})")
    return report


def mutable_freshness(dev, seed: int) -> dict:
    """The reference's freshness script at N = 20,000 on ``dev``: build,
    then 1,500 inserts and 750 deletes served, graph MATCH reads (pool
    128, pioneer 16) before the merge; one more insert trips the size
    trigger, the merge runs inside serve_loop, the reads again. Recall@10
    against the logical corpus's brute oracle (a deleted row's attributes
    set to -1 match no MATCH query)."""
    from repro_torch.api import MATCH, Engine, Query, SearchParams
    from repro_torch.core import to_tensor
    from repro_torch.core.baselines import brute_force_hybrid, recall_at_k
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.mutable import CompactionPolicy, MutableEngine
    from repro_torch.serve import Delete, Request, TenantPolicy, TenantRegistry, Upsert, serve_loop

    total = SMALL_N + MUT_SMALL_INSERTS
    ds = make_hybrid_dataset(n=total, n_queries=128, profile="sift", seed=seed)
    eng = Engine.build(ds.features[:SMALL_N], ds.attrs[:SMALL_N],
                       HelpConfig(gamma=24, gamma_new=6, max_rounds=8), device=dev)
    m = MutableEngine(eng, CompactionPolicy(max_delta_rows=10 ** 9))
    reg = TenantRegistry(default_policy=TenantPolicy(
        params=SearchParams(k=10, pool_size=128, pioneer_size=16, backend="graph")))
    deleted = np.sort(np.random.default_rng(7).choice(SMALL_N, MUT_SMALL_DELETES, replace=False))
    writes = [Upsert("t", ds.features[i], ds.attrs[i], id=i) for i in range(SMALL_N, total)]
    writes += [Delete("t", int(i)) for i in deleted]
    reads = [Request("t", Query(ds.query_features[i], [MATCH(int(v)) for v in ds.query_attrs[i]]),
                     request_id=10_000 + i) for i in range(len(ds.query_features))]
    attrs = ds.attrs.copy()
    attrs[deleted] = -1
    truth = brute_force_hybrid(to_tensor(ds.features, torch.float32, dev),
                               to_tensor(attrs, torch.int32, dev),
                               ds.query_features, ds.query_attrs, 10).ids.cpu()

    def recall_of(resp):
        done = sorted((r for r in resp if hasattr(r, "ids")), key=lambda r: r.request_id)
        if len(done) != len(reads) or not all(r.ok for r in resp):
            raise SystemExit(f"mutable freshness on {dev}: not every request answered")
        ids = np.stack([r.ids for r in done])
        if np.isin(ids, deleted).any():
            raise SystemExit(f"mutable freshness on {dev}: a deleted id was served")
        return recall_at_k(ids, truth, 10)

    out, _ = serve_loop(m, [(0.0, w) for w in writes] + [(1.0, r) for r in reads], reg)
    pre = recall_of(out)
    m.policy = CompactionPolicy(max_delta_rows=10)
    poke = Upsert("t", ds.features[total - 1], ds.attrs[total - 1], id=total - 1)
    out, _ = serve_loop(m, [(0.0, poke)] + [(1.0, r) for r in reads], reg)
    post = recall_of(out)
    if m.merge_count != 1:
        raise SystemExit(f"mutable freshness on {dev}: {m.merge_count} merges, not 1")
    return {"pre_merge": pre, "post_merge": post, "merge_ms": m.merge_ms[-1]}


def check_mutable_small(dev, seed: int) -> dict:
    """The freshness script at N = 20,000 on the card and on the CPU: graph
    MATCH recall@10 ≥ MUT_RECALL_FLOOR before and after the merge on the
    card, within SMALL_RECALL_GAP of the CPU's."""
    t0 = time.perf_counter()
    card = mutable_freshness(dev, seed)
    t1 = time.perf_counter()
    cpu = mutable_freshness(torch.device("cpu"), seed)
    log(f"  N={SMALL_N} freshness ({MUT_SMALL_INSERTS} inserts, {MUT_SMALL_DELETES} deletes, "
        f"graph MATCH): recall@10 card {card['pre_merge']:.4f} before / {card['post_merge']:.4f} "
        f"after the merge ({card['merge_ms']:.1f} ms), CPU {cpu['pre_merge']:.4f} / "
        f"{cpu['post_merge']:.4f} (card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s)")
    for key in ("pre_merge", "post_merge"):
        if card[key] < MUT_RECALL_FLOOR:
            raise SystemExit(f"mutable freshness: card recall {card[key]:.4f} {key} < "
                             f"{MUT_RECALL_FLOOR}")
        if abs(card[key] - cpu[key]) > SMALL_RECALL_GAP:
            raise SystemExit(f"mutable freshness: card {card[key]:.4f} vs CPU {cpu[key]:.4f} "
                             f"{key}: gap > {SMALL_RECALL_GAP}")
    return {"card": card, "cpu": cpu}


def zipf_trace(ds, skew: float, seed: int):
    """(trace, info): a copy of ``zipf_query_trace`` (benchmarks/trace.py:32)
    over ds's first TIER_DISTINCT queries with the port's request types.
    Request i draws its query from P(rank r) ∝ 1/r^skew (uniform at 0), a
    repeat is the same vector and predicates verbatim; arrivals come in
    geometric bursts of mean TIER_BURST that share one timestamp, the clock
    advancing TIER_SPACING_S a request; tenants round robin."""
    from repro_torch.api import MATCH, Query
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    pool, n_requests = TIER_DISTINCT, TIER_REQUESTS
    if skew > 0:
        w = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** float(skew)
        w /= w.sum()
        qidx = rng.choice(pool, size=n_requests, p=w)
    else:
        qidx = rng.integers(0, pool, size=n_requests)
    times = np.empty(n_requests, np.float64)
    t, i = 0.0, 0
    while i < n_requests:
        b = min(int(rng.geometric(1.0 / TIER_BURST)), n_requests - i)
        times[i:i + b] = t
        t += TIER_SPACING_S * b
        i += b
    trace = [(float(times[i]), Request(f"t{i % SERVE_TENANTS}", Query(
        ds.query_features[j], [MATCH(int(v)) for v in ds.query_attrs[j]])))
        for i, j in enumerate(qidx)]
    counts = np.bincount(qidx, minlength=pool)
    info = dict(skew=skew, distinct_queries=int((counts > 0).sum()),
                repeat_fraction=float((n_requests - (counts > 0).sum()) / n_requests),
                head10_traffic_share=float(np.sort(counts)[::-1][:max(1, pool // 10)].sum()
                                           / n_requests))
    return trace, info


def run_tiered_path(dev, ds, eng, peng, part_params, cap: int, seed: int):
    """Phase 4, tiered: a TieredEngine over the pq engine ``eng`` (hot
    budget N/8, an epoch every TIER_EPOCH queries). MATCH, ONE_OF and
    BETWEEN batches of 128 on the graph and brute backends equal the
    untiered engine's bit for bit in the cold, warm and churned tier
    states; cache_sweep's Zipf traces served untiered, tiered at hot 0 and
    N/8, and tiered with a ResultCache, every answer equal to the untiered
    stream's; the rerank gather's host ms for an all-hot and an all-cold
    bucket-8 batch. Then, on the partitioned engine ``peng`` under its cap,
    the skew-1.2 trace untiered and with pinned partitions (hot budget
    cap / 2): answers equal, pinned rows under the cap, loads and ms a
    search beside each other."""
    from repro_torch.api import SearchParams
    from repro_torch.cache import ResultCache, TieredEngine
    from repro_torch.serve import Completed, ServerStats, TenantPolicy, TenantRegistry, serve_loop

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    n = eng.n_items
    hot = n // 8
    out = dict(hot_rows=hot, epoch_queries=TIER_EPOCH, bits={}, serve={})

    # bits: each tier state against the untiered engine
    batches = {k: q for k, q in predicate_batches(ds).items() if k in ("MATCH", "ONE_OF", "BETWEEN")}
    for backend in ("graph", "brute"):
        params = SearchParams(k=10, backend=backend)
        refs = {kind: eng.search(q, params) for kind, q in batches.items()}
        tiered = TieredEngine(eng, hot_rows=hot, epoch_queries=TIER_EPOCH)
        for state in ("cold", "warm", "churned"):
            if state == "churned":
                # popularity moves to rows nobody returned, above the
                # residents' counts even after their hysteresis
                tiered.tracker.observe(np.tile(np.arange(n // 2, n // 2 + hot), 8))
                tiered.refresh_tier()
            for kind, q in batches.items():
                got = tiered.search(q, params)
                same = {f: bool(torch.equal(getattr(got, f), getattr(refs[kind], f)))
                        for f in ("ids", "dists", "sqdists", "n_dist_evals", "n_code_evals")}
                if not all(same.values()):
                    raise SystemExit(f"tiered {backend} {kind} {state}: not bit for bit equal to "
                                     f"the untiered engine ({same})")
        st = tiered.tier_stats()
        out["bits"][backend] = {k: st[k] for k in ("hot_row_hits", "cold_row_gathers",
                                                  "tier_hit_rate", "promotions", "demotions",
                                                  "epochs", "hot_rows_resident")}
        if not (st["hot_row_hits"] > 0 and st["cold_row_gathers"] > 0 and st["demotions"] > 0):
            raise SystemExit(f"tiered {backend}: the tier states were not reached: {st}")
        log(f"  tiered {backend}: MATCH, ONE_OF and BETWEEN x 128 bit for bit equal to the "
            f"untiered engine cold, warm and churned; tier {out['bits'][backend]}")
        del tiered, refs

    # cache_sweep's traffic: untiered, tiered at hot 0 and N/8, N/8 + cache
    params = SearchParams(k=10, backend="graph")

    def registry():
        return TenantRegistry(default_policy=TenantPolicy(params=params))

    def served(engine, trace, cache=None):
        """A warm pass (plans compiled, the tier promoted), then the counted
        pass: (responses, snapshot, service s)."""
        serve_loop(engine, trace, registry(), window_ms=SERVE_WINDOW_MS, buckets=TIER_BUCKETS,
                   result_cache=cache)
        if cache is not None:
            cache.clear()
            cache.reset_counters()
        if getattr(engine, "tier", None) is not None:
            engine.tier.reset_counters()
        stats = ServerStats(engine)
        resp, stats = serve_loop(engine, trace, registry(), window_ms=SERVE_WINDOW_MS,
                                 buckets=TIER_BUCKETS, stats=stats, result_cache=cache)
        sync()
        return resp, stats.snapshot(), stats.service_wall_s

    traces = {}
    for skew in TIER_SKEWS:
        trace, info = zipf_trace(ds, skew, seed)
        traces[skew] = trace
        row = out["serve"][str(skew)] = dict(trace=info)
        want = None
        for variant in ("untiered", "hot0", "hot_n8", "hot_n8_cache"):
            engine, cache = eng, None
            if variant != "untiered":
                engine = TieredEngine(eng, hot_rows=0 if variant == "hot0" else hot,
                                      epoch_queries=TIER_EPOCH)
            if variant == "hot_n8_cache":
                cache = ResultCache(max_entries=4 * TIER_DISTINCT)
            resp, snap, service_s = served(engine, trace, cache)
            if not all(isinstance(r, Completed) for r in resp):
                raise SystemExit(f"tiered serve {variant} s={skew}: not every response is Completed")
            if want is None:
                want = resp
            for i, (a, b) in enumerate(zip(want, resp)):
                if not (np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)):
                    raise SystemExit(f"tiered serve {variant} s={skew}: request {i} differs from "
                                     f"the untiered stream's answer")
            tier, rc = snap.get("tier", {}), snap.get("result_cache", {})
            lat = snap["latency_ms"]
            row[variant] = r = dict(
                service_qps=snap["service_qps"], p50_ms=lat["p50"], p99_ms=lat["p99"],
                batches=snap["batches"], service_s=service_s,
                tier_hit_rate=tier.get("tier_hit_rate"), promotions=tier.get("promotions"),
                demotions=tier.get("demotions"), cache_hit_rate=rc.get("hit_rate"),
                cache_served=rc.get("served"),
            )
            log(f"  tiered serve s={skew} {variant:12s}: service QPS {r['service_qps']:.1f}, p50 "
                f"{r['p50_ms']:.3f} p99 {r['p99_ms']:.3f} ms, {r['batches']} batches; tier hit "
                f"rate {r['tier_hit_rate']}, promotions {r['promotions']}; cache hit rate "
                f"{r['cache_hit_rate']} ({r['cache_served']} served from the cache)")
            if variant == "hot_n8" and skew == TIER_SKEWS[-1]:
                out["gather_ms"] = gather_host_ms(dev, engine.tier, seed)
            del engine
        log(f"    trace s={skew}: {info}; every answer of every variant equals the untiered "
            f"stream's bit for bit")

    if peng is not None:
        out["partitioned"] = tiered_partitioned(peng, part_params, cap, traces[TIER_SKEWS[-1]],
                                                registry, sync)
    return out


def gather_host_ms(dev, tier, seed: int, reps: int = 20) -> dict:
    """HotTier.gather of an all-hot and an all-cold bucket-8 rerank
    (8 x TIER_RERANK ids), host clock up to a sync: medians of ``reps``."""
    rng = np.random.default_rng(seed)
    shape = (8, TIER_RERANK)
    hot_ids = rng.choice(tier.hot_ids, size=shape)
    cold = np.flatnonzero(tier.slot_of < 0)
    cold_ids = rng.choice(cold, size=shape)
    out = {}
    for label, ids in (("all_hot", hot_ids), ("all_cold", cold_ids)):
        times = []
        for _ in range(reps + 1):  # the first warms up
            t0 = time.perf_counter()
            tier.gather(ids)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[label] = statistics.median(times[1:])
    log(f"  rerank gather of a bucket-8 batch ({shape[0]} x {shape[1]} rows), host clock to a "
        f"sync, median of {reps}: all hot {out['all_hot']:.4f} ms, all cold "
        f"{out['all_cold']:.4f} ms")
    return out


def tiered_partitioned(peng, part_params, cap: int, trace, registry, sync) -> dict:
    """The skew-1.2 trace on the partitioned engine under its cap, untiered
    and through a TieredEngine that pins hot partitions (budget cap / 2),
    each after a warm pass: answers bit for bit equal, pinned rows under the
    cap, store loads and service ms a search (a served batch)."""
    from repro_torch.cache import TieredEngine
    from repro_torch.serve import ServerStats, TenantPolicy, TenantRegistry, serve_loop

    store = peng.index.store
    params = dataclasses.replace(part_params, backend="partitioned")

    def reg():
        return TenantRegistry(default_policy=TenantPolicy(params=params))

    out, answers = {}, {}
    for variant in ("untiered", "pinned"):
        engine = peng
        store.evict_all()
        if variant == "pinned":
            engine = TieredEngine(peng, hot_rows=cap // 2, epoch_queries=TIER_EPOCH)
        serve_loop(engine, trace, reg(), window_ms=SERVE_WINDOW_MS, buckets=TIER_BUCKETS)
        store.reset_counters()
        stats = ServerStats(engine)
        resp, stats = serve_loop(engine, trace, reg(), window_ms=SERVE_WINDOW_MS,
                                 buckets=TIER_BUCKETS, stats=stats)
        sync()
        st = store.stats()
        snap = stats.snapshot()
        answers[variant] = resp
        out[variant] = r = dict(
            batches=snap["batches"], loads=st["loads"], hits=st["hits"],
            loads_per_search=st["loads"] / snap["batches"],
            ms_per_search=stats.service_wall_s * 1e3 / snap["batches"],
            p50_ms=snap["latency_ms"]["p50"], p99_ms=snap["latency_ms"]["p99"],
            pinned_partitions=st["pinned_partitions"], pinned_rows=st["pinned_rows"],
            peak_resident_rows=st["peak_resident_rows"],
        )
        log(f"  tiered partitioned {variant:8s} (nprobe={params.nprobe}, cap {cap} rows): "
            f"{r['loads_per_search']:.2f} loads and {r['ms_per_search']:.3f} ms a search over "
            f"{r['batches']} searches, p50 {r['p50_ms']:.3f} p99 {r['p99_ms']:.3f} ms; "
            f"{r['pinned_partitions']} partitions pinned ({r['pinned_rows']} rows), peak "
            f"{r['peak_resident_rows']} resident")
    store.unpin()
    for i, (a, b) in enumerate(zip(answers["untiered"], answers["pinned"])):
        if not (np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)):
            raise SystemExit(f"tiered partitioned: request {i} differs from the untiered answer")
    pinned = out["pinned"]
    if not 0 < pinned["pinned_rows"] <= cap:
        raise SystemExit(f"tiered partitioned: {pinned['pinned_rows']} pinned rows, cap {cap}")
    log("    every pinned answer equals the untiered engine's bit for bit")
    return out


def check_tiered_kernels(dev, ds, eng, seed: int) -> dict:
    """gather_auto at the tiered rerank: B x TIER_RERANK rows staged in a
    buffer of their own and scored through ``routing.staged_operands``
    (the pool's last 3 slots INVALID), in the index's metric, at each of
    TIER_STAGED_BATCHES: bit for bit equal to the same call over the whole
    row table, against its plain version, timed beside its bound. Then at a
    serve bucket-8 graph hop (TIER_HOP8 over N rows, 10% INVALID)."""
    from repro_torch.core import to_tensor
    from repro_torch.core.routing import staged_operands
    from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref

    rng = np.random.default_rng(seed)
    idx = eng.index
    n, m = (int(x) for x in idx.features.shape)
    l = int(idx.attrs.shape[1])
    alpha, mode = idx.metric_cfg.alpha, idx.metric_cfg.mode
    q = predicate_batches(ds)["MATCH"]
    qv_all = to_tensor(q.vectors, torch.float32, dev)
    qa_all = to_tensor(q.attrs, torch.int32, dev)
    report = {}

    def case(label, shape, qv, qa, v, a, ids, direct=None):
        got = gather_auto(qv, qa, v, a, ids, alpha, mode)
        want = gather_auto_ref(qv, qa, v, a, ids, alpha, mode)
        err = (got.double() - want.double()).abs()
        ratio = float((err / (GATHER_RTOL * want.double().abs() + 1e-6)).max())
        valid = ids[ids >= 0]
        b, c = ids.shape
        rows = int(torch.unique(valid).numel())
        bound_ms, bound_by = bound(rows * (m + l) * 4 + b * c * 4 * 2 + b * (m + 2 * l) * 4,
                                   int(valid.numel()) * (3 * m + 4 * l + 4))
        r = report[label] = dict(
            shape=shape, max_abs_err=float(err.max()), worst_err_over_tol=ratio,
            ms=cuda_ms(lambda: gather_auto(qv, qa, v, a, ids, alpha, mode)),
            device_ms=device_ms(lambda: gather_auto(qv, qa, v, a, ids, alpha, mode)),
            plain_ms=cuda_ms(lambda: gather_auto_ref(qv, qa, v, a, ids, alpha, mode), reps=5),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        )
        if direct is not None:
            r["bitwise_equal_to_the_row_table"] = bool(torch.equal(got, direct))
        log(f"  tiered {label} {shape}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"max|err| {r['max_abs_err']:.3e}, worst err/tol {ratio:.3f}"
            + (f"; equal to the call over the row table bit for bit: "
               f"{r['bitwise_equal_to_the_row_table']}" if direct is not None else ""))
        if ratio > 1.0:
            raise SystemExit(f"tiered {label}: gather_auto disagrees with its plain version")
        if direct is not None and not r["bitwise_equal_to_the_row_table"]:
            raise SystemExit(f"tiered {label}: gather_auto over the staged rows differs from "
                             f"the same call over the row table")

    for b in TIER_STAGED_BATCHES:
        qv, qa = qv_all[:b].contiguous(), qa_all[:b].contiguous()
        r_np = rng.integers(0, n, (b, TIER_RERANK)).astype(np.int32)
        r_np[:, -3:] = -1
        r_ids = to_tensor(r_np, torch.int32, dev)
        cv = idx.features[r_ids.clamp_min(0).long()]  # the rows in a buffer of their own
        direct = gather_auto(qv, qa, idx.features, idx.attrs, r_ids, alpha, mode)
        case(f"rerank_b{b}", f"staged rerank B={b} R={TIER_RERANK} M={m} L={l} {mode}", qv, qa,
             *staged_operands(cv, idx.attrs, r_ids), direct=direct)
    b, c = TIER_HOP8
    cand_np = rng.integers(0, n, (b, c)).astype(np.int32)
    cand_np[rng.random((b, c)) < 0.1] = -1
    case("serve_bucket8_hop", f"serve bucket-8 hop B={b} C={c} N={n} M={m} L={l} {mode}",
         qv_all[:b].contiguous(), qa_all[:b].contiguous(), idx.features, idx.attrs,
         to_tensor(cand_np, torch.int32, dev))
    return report


def run_sharded_path(dev, ds, eng, pq_eng, seed: int, workdir: str):
    """Phase 4, sharded: ShardedStableIndex.build on a (data=1, model=4)
    mesh on the one card, exact then with the pq codec, served through
    Engine: each predicate class at B = 128 timed beside the flat engine of
    the same codec, recall@10 against the flat brute oracle, every 16th row
    against its solo search bit for bit, data=2 against data=1 bit for bit,
    a save and Engine.load round trip bit for bit, pq rerank evals within
    the pool; then the first 256 requests of the serve trace through
    serve_loop with the backend pinned. Returns the results and the exact
    sharded engine (for ``check_sharded_kernels`` and the profile)."""
    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.core.baselines import recall_at_k
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.distributed import ShardedStableIndex
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.quant import QuantConfig
    from repro_torch.serve import Completed, ServerStats, serve_loop

    n = int(ds.features.shape[0])
    mesh = make_local_mesh(1, SHARDS, devices=[dev])
    batches = predicate_batches(ds)
    oracle = {c: eng.search(q, SearchParams(k=10, backend="brute")).ids.cpu()
              for c, q in batches.items()}
    flat = {"none": eng, "pq": pq_eng}
    out = {"mesh": mesh.shape, "shard_rows": n // SHARDS, "codecs": {}}
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()

    def timed(fn, reps=3):
        lat = []
        for _ in range(reps):
            t1 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        return res, statistics.median(lat) * 1e3

    def same(a, b):
        return torch.equal(a.ids, b.ids) and torch.equal(a.sqdists, b.sqdists)

    for codec in ("none", "pq"):
        t0 = time.perf_counter()
        sidx = ShardedStableIndex.build(mesh, ds.features, ds.attrs, eng.index.metric_cfg,
                                        HelpConfig(), QuantConfig(codec, pq_subspaces=ADC_S))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        by_shard = [r.build_seconds for r in sidx.build_reports]
        seng = Engine(sidx)
        row = out["codecs"][codec] = dict(
            build_s=build_s, build_s_by_shard=by_shard,
            memory_bytes=torch.cuda.memory_allocated() - mem0, classes={})
        log(f"  sharded {codec}: built {SHARDS} shards of {n // SHARDS} rows in {build_s:.2f} s "
            f"(graphs by shard {[round(x, 2) for x in by_shard]} s; codec and copies "
            f"{build_s - sum(by_shard):.2f} s); device memory +{row['memory_bytes'] / 1e9:.3f} GB")
        params = SearchParams(k=10)
        for cname, q in batches.items():
            plan = seng.plan(q, params)
            if plan.backend != "sharded":
                raise SystemExit(f"sharded {codec} {cname}: planned {plan.backend}")
            res, ms = timed(lambda: seng.search(q, params))
            check_result(res, n, q.batch_size)
            fres, flat_ms = timed(lambda: flat[codec].search(q, SearchParams(k=10, backend="graph")))
            rec = recall_at_k(res.ids.cpu(), oracle[cname], 10)
            flat_rec = recall_at_k(fres.ids.cpu(), oracle[cname], 10)
            if codec == "pq" and not bool((res.n_dist_evals <= params.effective_pool).all()):
                raise SystemExit(f"sharded pq {cname}: a row's exact evals exceed the pool "
                                 f"{params.effective_pool}: {int(res.n_dist_evals.max())}")
            for i in range(0, q.batch_size, SERVE_SOLO_EVERY):
                alone = seng.search(q.take([i]), params)
                if not (torch.equal(alone.ids[0], res.ids[i])
                        and torch.equal(alone.sqdists[0], res.sqdists[i])):
                    raise SystemExit(f"sharded {codec} {cname}: row {i} differs from its query "
                                     "searched alone")
            r = row["classes"][cname] = dict(
                ms=ms, flat_graph_ms=flat_ms, recall_at_10=rec, flat_recall_at_10=flat_rec,
                hops=int(res.n_hops), flat_hops=int(fres.n_hops),
                fp_evals=res.mean_dist_evals, code_evals=res.mean_code_evals,
                flat_fp_evals=fres.mean_dist_evals, flat_code_evals=fres.mean_code_evals)
            log(f"    {cname:7s} sharded {ms:.2f} ms ({r['hops']} hops over {SHARDS} shards, "
                f"{r['hops'] / SHARDS:.1f} a shard; fp evals {r['fp_evals']:.1f}, code evals "
                f"{r['code_evals']:.1f}) recall@10={rec:.4f} | flat graph {flat_ms:.2f} ms "
                f"({r['flat_hops']} hops, fp evals {r['flat_fp_evals']:.1f}, code evals "
                f"{r['flat_code_evals']:.1f}) recall@10={flat_rec:.4f}; every "
                f"{SERVE_SOLO_EVERY}th row equals its solo search bit for bit")
        q = batches["MATCH"]
        want = seng.search(q, params)
        two = Engine(dataclasses.replace(sidx, mesh=make_local_mesh(2, SHARDS, devices=[dev])))
        got2 = two.search(q, params)
        if not same(got2, want) or int(got2.n_hops) == 0:
            raise SystemExit(f"sharded {codec}: data=2 differs from data=1")
        path = os.path.join(workdir, f"sharded_{codec}")
        t0 = time.perf_counter()
        seng.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Engine.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = back.search(q, params)
        if not (same(got, want) and torch.equal(got.n_code_evals, want.n_code_evals)
                and int(got.n_hops) == int(want.n_hops)):
            raise SystemExit(f"sharded {codec}: the loaded engine's search differs")
        if codec == "pq" and not torch.equal(back.index.codes, sidx.codes):
            raise SystemExit("sharded pq: codes differ after save and load")
        row.update(data2_hops=int(got2.n_hops), data1_hops=int(want.n_hops), save_s=save_s,
                   load_s=load_s)
        log(f"  sharded {codec}: data=2 equals data=1 bit for bit (hops {int(got2.n_hops)} vs "
            f"{int(want.n_hops)}); save {save_s:.2f} s, Engine.load {load_s:.2f} s, the loaded "
            "search bit for bit")
        del back, two
        shutil.rmtree(path, ignore_errors=True)
        if codec == "none":
            exact_eng = seng
        del seng, sidx
        gc.collect()

    # the first 256 requests of phase 4's trace on the exact sharded engine
    tenants, trace = serve_trace(ds, seed)
    trace = trace[:SHARD_SERVE_REQUESTS]
    params = SearchParams(k=10, backend="sharded")
    stats = ServerStats(exact_eng)
    t0 = time.perf_counter()
    resp, _ = serve_loop(exact_eng, trace, serve_registry(tenants, params),
                         window_ms=SERVE_WINDOW_MS, buckets=SERVE_BUCKETS, stats=stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    snap = stats.snapshot()
    if not all(isinstance(r, Completed) for r in resp):
        raise SystemExit(f"sharded serve: not every response is Completed: "
                         f"{sorted({type(r).__name__ for r in resp})}")
    for i in range(0, len(resp), SERVE_SOLO_EVERY):
        alone = exact_eng.search(QueryBatch.from_queries([trace[i][1].query]), params)
        if not (np.array_equal(alone.ids[0].cpu().numpy(), resp[i].ids)
                and np.array_equal(alone.dists[0].cpu().numpy(), resp[i].dists)):
            raise SystemExit(f"sharded serve: request {i} (bucket {resp[i].bucket}) differs "
                             "from its query searched alone")
    lat = snap["latency_ms"]
    out["serve"] = dict(requests=len(resp), p50_ms=lat["p50"], p99_ms=lat["p99"],
                        service_ms_p99=snap["service_ms_p99"], batches=snap["batches"],
                        batch_fill_ratio=snap["batch_fill_ratio"], wall_s=wall_s)
    log(f"  sharded serve: {snap['completed']}/{len(resp)} Completed in {snap['batches']} "
        f"batches, fill {snap['batch_fill_ratio']:.4f}; end-to-end p50 {lat['p50']:.3f} p99 "
        f"{lat['p99']:.3f} ms (service p99 {snap['service_ms_p99']:.3f}); {wall_s:.2f} s of wall "
        f"time; every {SERVE_SOLO_EVERY}th response equals its solo search bit for bit")
    return out, exact_eng


def check_sharded_small(dev, seed: int) -> dict:
    """The sharded step's checks away from N = 1M: (1) the exhaustive merge
    at SHARD_EXH_N rows, pool = shard rows, against a brute oracle on the
    card that scores every row with the same kernel (gather_auto over all
    ids, then the stable top-k): sqdists bit for bit, ids except at ties;
    (2) card against CPU at SMALL_N: sharded MATCH recall@10 against the
    exact oracle, exact and pq, within SMALL_RECALL_GAP."""
    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.core import to_tensor
    from repro_torch.core.auto import MetricConfig, sample_stats
    from repro_torch.core.baselines import brute_force_hybrid, recall_at_k
    from repro_torch.core.graph_ops import smallest_k
    from repro_torch.core.help_graph import HelpConfig
    from repro_torch.core.routing import RoutingConfig
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.distributed import ShardedStableIndex
    from repro_torch.kernels.gather_auto.ops import gather_auto
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.quant import QuantConfig

    out = {}
    ds = make_hybrid_dataset(n=SHARD_EXH_N, n_queries=64, profile="sift", seed=seed)
    mc = MetricConfig(alpha=sample_stats(ds.features, ds.attrs).alpha)
    rows = SHARD_EXH_N // SHARDS
    sidx = ShardedStableIndex.build(make_local_mesh(1, SHARDS, devices=[dev]), ds.features,
                                    ds.attrs, mc)
    cfg = RoutingConfig(k=10, pool_size=rows, pioneer_size=16, refine_max_iters=4 * rows)
    res = sidx.search(ds.query_features, ds.query_attrs, k=10, routing_cfg=cfg)
    qv = to_tensor(ds.query_features, torch.float32, dev)
    qa = to_tensor(ds.query_attrs, torch.int32, dev)
    every = torch.arange(SHARD_EXH_N, dtype=torch.int32, device=dev).expand(len(qv), -1)
    want_sq, want_ids = smallest_k(gather_auto(
        qv, qa, to_tensor(ds.features, torch.float32, dev), to_tensor(ds.attrs, torch.int32, dev),
        every.contiguous(), mc.alpha, mc.mode), 10)
    got_sq, got_ids, want_sq, want_ids = (x.cpu() for x in (res.sqdists, res.ids, want_sq,
                                                             want_ids))
    differ = got_ids != want_ids.to(torch.int32)
    at_ties = all(bool((want_sq[r] == want_sq[r, p]).sum() > 1)
                  for r, p in zip(*torch.nonzero(differ, as_tuple=True)))
    out["exhaustive"] = dict(n=SHARD_EXH_N, pool=rows, ids_differ=int(differ.sum()),
                             all_at_ties=at_ties, sqdists_equal=bool(torch.equal(got_sq, want_sq)))
    log(f"  sharded exhaustive merge N={SHARD_EXH_N}, {SHARDS} shards, pool {rows}: sqdists equal "
        f"the brute oracle's bit for bit: {out['exhaustive']['sqdists_equal']}; "
        f"{out['exhaustive']['ids_differ']} ids differ, all at ties: {at_ties}")
    if not (out["exhaustive"]["sqdists_equal"] and at_ties):
        raise SystemExit("sharded: the exhaustive merge differs from the brute oracle")

    ds = make_hybrid_dataset(n=SMALL_N, n_queries=128, profile="sift", seed=seed)
    q = QueryBatch.match(ds.query_features, ds.query_attrs)
    mc = MetricConfig(alpha=sample_stats(ds.features, ds.attrs).alpha)
    recall = {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        mesh = make_local_mesh(1, SHARDS, devices=[where])
        pq = ShardedStableIndex.build(mesh, ds.features, ds.attrs, mc, HelpConfig(),
                                      QuantConfig("pq", pq_subspaces=ADC_S))
        exact = dataclasses.replace(pq, quant_mode="none", shard_codes=None, pq_centroids=None,
                                    pq_dim=0)
        oracle = brute_force_hybrid(to_tensor(ds.features, torch.float32, where),
                                    to_tensor(ds.attrs, torch.int32, where),
                                    ds.query_features, ds.query_attrs, 10).ids.cpu()
        recall[tag] = {c: recall_at_k(Engine(i).search(q, SearchParams(k=10)).ids.cpu(),
                                             oracle, 10)
                              for c, i in (("none", exact), ("pq", pq))}
        log(f"  sharded N={SMALL_N} on the {tag}: MATCH recall@10 {recall[tag]} "
            f"({time.perf_counter() - t0:.1f} s)")
    for c in ("none", "pq"):
        if abs(recall["card"][c] - recall["cpu"][c]) > SMALL_RECALL_GAP:
            raise SystemExit(f"sharded {c} N={SMALL_N}: card recall {recall['card'][c]:.4f} vs "
                             f"CPU {recall['cpu'][c]:.4f}: gap > {SMALL_RECALL_GAP}")
    out["card_vs_cpu"] = recall
    return out


def check_sharded_kernels(dev, ds, sidx, seed: int) -> dict:
    """gather_auto at a shard hop: SHARD_HOP over one shard's rows (10%
    INVALID), in the index's metric, against its plain version and timed
    beside its bound."""
    from repro_torch.core import to_tensor
    from repro_torch.kernels.gather_auto.ops import gather_auto, gather_auto_ref

    rng = np.random.default_rng(seed)
    v, a = sidx.shard_features[0], sidx.shard_attrs[0]
    rows, m = (int(x) for x in v.shape)
    l = int(a.shape[1])
    alpha, mode = sidx.metric_cfg.alpha, sidx.metric_cfg.mode
    b, c = SHARD_HOP
    q = predicate_batches(ds)["MATCH"]
    qv = to_tensor(q.vectors[:b], torch.float32, dev)
    qa = to_tensor(q.attrs[:b], torch.int32, dev)
    cand_np = rng.integers(0, rows, (b, c)).astype(np.int32)
    cand_np[rng.random((b, c)) < 0.1] = -1
    ids = to_tensor(cand_np, torch.int32, dev)
    got = gather_auto(qv, qa, v, a, ids, alpha, mode)
    want = gather_auto_ref(qv, qa, v, a, ids, alpha, mode)
    err = (got.double() - want.double()).abs()
    ratio = float((err / (GATHER_RTOL * want.double().abs() + 1e-6)).max())
    valid = ids[ids >= 0]
    n_rows = int(torch.unique(valid).numel())
    bound_ms, bound_by = bound(n_rows * (m + l) * 4 + b * c * 4 * 2 + b * (m + 2 * l) * 4,
                               int(valid.numel()) * (3 * m + 4 * l + 4))
    r = dict(
        shape=f"shard hop B={b} C={c} over {rows} rows, M={m} L={l} {mode}",
        max_abs_err=float(err.max()), worst_err_over_tol=ratio,
        ms=cuda_ms(lambda: gather_auto(qv, qa, v, a, ids, alpha, mode)),
        device_ms=device_ms(lambda: gather_auto(qv, qa, v, a, ids, alpha, mode)),
        plain_ms=cuda_ms(lambda: gather_auto_ref(qv, qa, v, a, ids, alpha, mode), reps=5),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
    )
    log(f"  sharded {r['shape']}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
        f"plain {r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); max|err| "
        f"{r['max_abs_err']:.3e}, worst err/tol {ratio:.3f}")
    if ratio > 1.0:
        raise SystemExit("sharded hop: gather_auto disagrees with its plain version")
    return r


def fused_err(got, want, qv, qa, xv, xa, alpha: float, mode: str) -> tuple[float, float]:
    """(max |err|, worst err/tol) of fused_auto against its plain version,
    tol = (1e-5·(‖q‖² + ‖x‖²) + 1e-6)·pen² + 1e-6·|ref| with pen² the
    square of the AUTO penalty in auto mode (1 in l2)."""
    from repro_torch.kernels.gather_auto.ref import penalty_sa

    qsq = (qv.double() ** 2).sum(1)[:, None]
    xsq = (xv.double() ** 2).sum(1)[None, :]
    pen2 = 1.0
    if mode == "auto":
        pen2 = (1.0 + penalty_sa(qa, xa[None].expand(qv.shape[0], -1, -1), None).double()
                / alpha) ** 2
    tol = (FUSED_RTOL_NORMS * (qsq + xsq) + FUSED_ATOL) * pen2 + 1e-6 * want.double().abs()
    err = (got.double() - want.double()).abs()
    return float(err.max()), float((err / tol).max())


def bound(bytes_: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the FP32 rate."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def recsys_batch(rng, cfg, b: int, dev) -> dict:
    """b users' inputs from numpy: ids (B, F) (and dense features (B, 13)
    N(0, 1) for dlrm), or bert4rec histories (B, seq_len); attribute
    targets (B, 4)."""
    if cfg.kind == "bert4rec":
        batch = {"items": rng.integers(0, cfg.n_items, (b, cfg.seq_len), dtype=np.int32)}
    else:
        batch = {"sparse": rng.integers(0, cfg.vocab_per_field, (b, cfg.n_sparse), dtype=np.int32)}
        if cfg.n_dense:
            batch["dense"] = rng.standard_normal((b, cfg.n_dense), dtype=np.float32)
    batch["query_attrs"] = rng.integers(0, 3, (b, cfg.n_attr_dims), dtype=np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def make_items(dev, n: int, cfg, seed: int) -> dict:
    """n candidates: (n, D) f32 factors and (n, L) int32 attributes in
    [0, 3), drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "item_embs": torch.randn((n, cfg.embed_dim), generator=g, device=dev).mul_(ITEM_SCALE),
        "item_attrs": torch.randint(0, 3, (n, cfg.n_attr_dims), generator=g, device=dev,
                                    dtype=torch.int32),
    }


def check_topk(got, want, label: str, rtol: float = RETRIEVAL_RTOL,
               atol: float = RETRIEVAL_ATOL) -> float:
    """(scores, ids) on the card against another run's (the CPU's by
    default): scores within atol + rtol·|want|, ids equal except where
    ``want`` holds another score within twice that (near-ties). Returns the
    share of ids equal."""
    gd, gi = (t.cpu() for t in got)
    wd, wi = (t.cpu() for t in want)
    if gd.shape != wd.shape or gi.shape != wi.shape or gd.dtype != wd.dtype:
        raise SystemExit(f"{label}: {tuple(gd.shape)} {gd.dtype} against "
                         f"{tuple(wd.shape)} {wd.dtype}")
    tie = atol + rtol * wd.abs()
    if not bool(((gd - wd).abs() <= tie).all()):
        raise SystemExit(f"{label}: scores differ by {float((gd - wd).abs().max()):.3e}")
    for r, p in zip(*torch.nonzero(gi != wi, as_tuple=True)):
        near = (wd[r] - wd[r, p]).abs() <= 2 * tie[r, p]
        near[p] = False
        if not bool(near.any()):
            raise SystemExit(f"{label}: row {int(r)} slot {int(p)} id {int(gi[r, p])} != "
                             f"{int(wi[r, p])} and no near-tie")
    return float((gi == wi).float().mean())


def check_recsys_kernels(dev, cfg, params, seed: int) -> dict:
    """Phase 5: fm_interaction on the embedding blocks of the two serve
    cells and at odd shapes, bit for bit; fused_auto at the retrieval shape
    (M = 10, L = 4, B = 1 and 512, N = 1M) within its PR 11 tolerance."""
    from repro_torch.configs.fm import SPEC
    from repro_torch.kernels.fm_interaction.ops import fm_interaction, fm_interaction_ref
    from repro_torch.models.recsys import embedding_lookup, user_tower

    rng = np.random.default_rng(seed + 4)
    f, d = cfg.n_sparse, cfg.embed_dim
    report = {}

    # ---- fm_interaction: bit for bit, batch-invariant, at both serve cells
    fm_stats = dict(bitwise=True, invariant=True, max_abs_err=0.0)

    def fm_case(e, tag):
        got = fm_interaction(e)
        want = fm_interaction_ref(e)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        fm_stats["max_abs_err"] = max(fm_stats["max_abs_err"], err)
        fm_stats["bitwise"] &= bool(torch.equal(got, want))
        alone = fm_interaction(e[:1].contiguous())
        fm_stats["invariant"] &= bool(torch.equal(alone[0], got[0]))
        log(f"  fm_interaction {tag}: max|err|={err:.3e} bitwise={torch.equal(got, want)} "
            f"row 0 alone bitwise={torch.equal(alone[0], got[0])}")

    timings = {}
    for cell in ("serve_p99", "serve_bulk"):
        b = SPEC.cell(cell).global_batch
        ids = rng.integers(0, cfg.vocab_per_field, (b, f), dtype=np.int32)
        emb = embedding_lookup(params["tables"], torch.from_numpy(ids).to(dev))
        fm_case(emb, f"{cell} B={b} F={f} D={d}")
        ms = cuda_ms(lambda: fm_interaction(emb))
        dev_ms = device_ms(lambda: fm_interaction(emb))
        plain_ms = cuda_ms(lambda: fm_interaction_ref(emb), reps=5)
        bound_ms, bound_by = bound(b * f * d * 4 + b * 4, b * (3 * f * d + 3 * d + 1))
        timings[cell] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        log(f"  fm_interaction {cell} B={b}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{b * f * d * 4 / dev_ms / 1e9:.1f} GB/s on the device")
        del emb
    g = torch.Generator(device=dev).manual_seed(seed)
    for shape in FM_ODD_SHAPES:
        fm_case(torch.randn(shape, generator=g, device=dev).mul_(0.3), f"B,F,D={shape}")
    if not fm_stats["bitwise"]:
        raise SystemExit(f"fm_interaction is not bitwise equal to its plain version "
                         f"(max|err| {fm_stats['max_abs_err']:.3e})")
    if not fm_stats["invariant"]:
        raise SystemExit("fm_interaction: row 0 alone is not bitwise equal to row 0 in the batch")
    report["fm_interaction"] = dict(
        max_abs_err=fm_stats["max_abs_err"], worst_err_over_tol=0.0, bitwise_equal=True,
        bitwise_batch_invariant=True, shape=f"B=262144 F={f} D={d} (serve_bulk)",
        **timings["serve_bulk"], serve_p99=timings["serve_p99"],
        # no single PyTorch call computes the sum-square term: it takes a
        # sum, a square, a difference and a reduction, each its own op
        library_ms=None,
    )

    # ---- fused_auto at the retrieval shape: user vectors from the tower
    items = make_items(dev, SPEC.cell("retrieval_cand").n_candidates, cfg, seed + 3)

    def users(b):
        batch = recsys_batch(rng, cfg, b, dev)
        return user_tower(cfg, params, batch), batch["query_attrs"]

    report["fused_auto_retrieval"] = check_fused_retrieval(
        users, items["item_embs"], items["item_attrs"], "retrieval_cand")
    del items
    torch.cuda.empty_cache()
    return report


def check_fused_retrieval(users, xv, xa, cell: str) -> dict:
    """fused_auto at a retrieval shape: ``users(b)`` gives (B, M) user
    vectors and (B, L) targets, for B = 1 and 512, against the N items
    (xv, xa). In auto and l2 modes within its tolerance (FUSED_RTOL_NORMS,
    FUSED_ATOL), row 0 alone bit for bit against row 0 in the batch; timed
    beside its plain version, torch.cdist and its bound."""
    from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_ref
    from repro_torch.kernels.gather_auto.ref import penalty_sa

    n, m, l = xv.shape[0], xv.shape[1], xa.shape[1]
    xsq = (xv.double() ** 2).sum(1)[None, :]
    worst, max_err, invariant, retr = 0.0, 0.0, True, {}
    for b in (1, 512):
        qv, qa = users(b)
        for mode in ("auto", "l2"):
            got = fused_auto(qv, qa, xv, xa, 1.0, mode)
            for r0 in range(0, b, 64):  # the tolerance in double, 64 rows at a time
                sl = slice(r0, min(b, r0 + 64))
                want = fused_auto_ref(qv[sl], qa[sl], xv, xa, 1.0, mode).double()
                pen2 = 1.0
                if mode == "auto":
                    sa = penalty_sa(qa[sl], xa[None].expand(want.shape[0], -1, -1), None)
                    pen2 = (1.0 + sa.double()) ** 2
                qsq = (qv[sl].double() ** 2).sum(1)[:, None]
                tol = (FUSED_RTOL_NORMS * (qsq + xsq) + FUSED_ATOL) * pen2 + 1e-6 * want.abs()
                err = (got[sl].double() - want).abs()
                worst = max(worst, float((err / tol).max()))
                max_err = max(max_err, float(err.max()))
                del want, pen2, tol, err
            alone = fused_auto(qv[:1].contiguous(), qa[:1].contiguous(), xv, xa, 1.0, mode)
            invariant &= bool(torch.equal(alone[0], got[0]))
            del got
        log(f"  fused_auto  B={b} N={n} M={m} L={l}: worst err/tol {worst:.3f}")
        ms = cuda_ms(lambda: fused_auto(qv, qa, xv, xa, 1.0, "auto"))
        dev_ms = device_ms(lambda: fused_auto(qv, qa, xv, xa, 1.0, "auto"))
        plain_ms = cuda_ms(lambda: fused_auto_ref(qv, qa, xv, xa, 1.0, "auto"), reps=5)
        library_ms = cuda_ms(lambda: torch.cdist(qv, xv))
        l2_ms = cuda_ms(lambda: fused_auto(qv, qa, xv, xa, 1.0, "l2"))
        l2_dev_ms = device_ms(lambda: fused_auto(qv, qa, xv, xa, 1.0, "l2"))
        bound_ms, bound_by = bound(
            (b * m + n * m + n * l + b * l * 2) * 4 + b * n * 4,
            2 * b * n * m + 2 * (b + n) * m + 4 * b * n + b * n * (5 * l + 3),
        )
        l2_bound_ms, _ = bound((b * m + n * m) * 4 + b * n * 4,
                               2 * b * n * m + 2 * (b + n) * m + b * n)
        retr[f"B={b}"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by, l2_ms=l2_ms,
                              l2_device_ms=l2_dev_ms, l2_bound_ms=l2_bound_ms)
        log(f"  fused_auto  B={b} N={n} M={m} L={l} auto: kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, torch.cdist {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); l2: kernel {l2_ms:.4f} ms (device {l2_dev_ms:.4f} ms), bound "
            f"{l2_bound_ms:.4f} ms")
    if worst > 1.0:
        raise SystemExit(f"fused_auto at M={m} disagrees with its plain version: err/tol {worst:.3f}")
    if not invariant:
        raise SystemExit(f"fused_auto at M={m}: row 0 alone is not bitwise equal to row 0")
    return dict(max_abs_err=max_err, worst_err_over_tol=worst, bitwise_batch_invariant=invariant,
                shape=f"B=1 and B=512, N={n} M={m} L={l} auto ({cell})", **retr)


def check_recsys_small(dev, seed: int) -> dict:
    """Phase 5: the fm serve and retrieval steps on the card against the
    CPU's plain versions at a cut vocabulary, with the same parameters."""
    from repro_torch.configs.fm import make_config
    from repro_torch.models.recsys import init_params
    from repro_torch.train.step import make_recsys_retrieval_step, make_recsys_serve_step

    cfg = dataclasses.replace(make_config(), vocab_per_field=CUT_VOCAB)
    cpu_params = init_params(cfg, seed=seed, device="cpu")
    card_params = {k: v.to(dev) for k, v in cpu_params.items()}
    rng = np.random.default_rng(seed + 5)
    batch = recsys_batch(rng, cfg, 512, dev)
    serve = make_recsys_serve_step(cfg)
    got = serve(card_params, batch).cpu()
    want = serve(cpu_params, {k: v.cpu() for k, v in batch.items()})
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 1e-6 + 1e-6 * want.abs()).all()):
        raise SystemExit(f"fm serve step: card logits differ from the CPU's by {err:.3e}")
    out = {"serve_max_abs_err": err, "serve_bitwise": bool(torch.equal(got, want))}
    items = make_items(dev, CUT_ITEMS, cfg, seed + 6)
    users = {k: v[:16] for k, v in batch.items()}
    card_batch = {**users, **items}
    cpu_batch = {k: v.cpu() for k, v in card_batch.items()}
    for shards in (1, 4):
        step = make_recsys_retrieval_step(cfg, k=RETRIEVAL_K, topk_shards=shards)
        want_r = step(cpu_params, cpu_batch)
        got_r = step(card_params, card_batch)
        out[f"retrieval_shards{shards}_ids_equal"] = check_topk(
            got_r, want_r, f"retrieval N={CUT_ITEMS} shards={shards}")
    log(f"  cut vocabulary V={CUT_VOCAB}: serve B=512 card vs CPU max|err| {err:.3e} "
        f"(bitwise {out['serve_bitwise']}); retrieval B=16 N={CUT_ITEMS} k={RETRIEVAL_K}: "
        f"ids equal {out['retrieval_shards1_ids_equal']:.4f} (1 shard), "
        f"{out['retrieval_shards4_ids_equal']:.4f} (4 shards)")
    return out


def serve_step(cfg):
    """The serve cells' step: bert4rec's next-item top-k
    (bert4rec_serve_topk, k = 100, chunks of SERVE_CHUNK), as the
    reference's ``build_cell`` serves it; every other kind's logits."""
    from repro_torch.models.recsys import bert4rec_serve_topk
    from repro_torch.train.step import make_recsys_serve_step

    if cfg.kind == "bert4rec":
        return lambda params, batch: bert4rec_serve_topk(
            cfg, params, batch["items"], k=RETRIEVAL_K, batch_chunk=SERVE_CHUNK)
    return make_recsys_serve_step(cfg)


def run_recsys_path(dev, cfg, params, seed: int, reps: int = 20, bulk_batches: int = 5):
    """Phase 5, the recsys path: the serve step (``serve_step``) at
    serve_p99 and serve_bulk, make_recsys_retrieval_step at retrieval_cand
    and at B = 512. Inputs are uploaded before the clock starts; each
    latency is host time to a synchronised result, the median over batches
    (the first, a warm-up, not counted), with the peak device memory over
    the batches and model FLOP/s (``model_flops``: the reference's count,
    B times a retrieval cell's for B users). Returns the results and the
    steps' closures for the profiler."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.models.recsys import model_flops
    from repro_torch.train.step import make_recsys_retrieval_step

    cells = {c.name: c for c in RECSYS_SHAPES}
    rng = np.random.default_rng(seed + 2)
    serve = serve_step(cfg)
    retrieve = make_recsys_retrieval_step(cfg, k=RETRIEVAL_K)
    items = make_items(dev, cells["retrieval_cand"].n_candidates, cfg, seed + 3)
    n = items["item_embs"].shape[0]
    out, last = {}, {}

    def timed(label, cell, fn, b, n_batches):
        lat = []
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_batches + 1):
            batch = recsys_batch(rng, cfg, b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(batch)
            torch.cuda.synchronize()
            if i:
                lat.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(lat)
        flops = model_flops(cfg, cell) * (b if cell.kind == "retrieval" else 1)
        out[label] = dict(batch=b, median_ms=med, min_ms=min(lat), max_ms=max(lat),
                          batches=n_batches, examples_per_s=b / med * 1e3,
                          peak_gb=peak / 1e9, peak_over_resident_gb=(peak - resident) / 1e9,
                          model_flops=flops, model_tflops_per_s=flops / med / 1e9)
        last[label] = batch
        log(f"  {label:22s} B={b:<6d} median {med:.3f} ms (min {min(lat):.3f}, max "
            f"{max(lat):.3f}, {n_batches} batches), {b / med * 1e3:.0f} examples/s, peak "
            f"{peak / 1e9:.3f} GB ({(peak - resident) / 1e9:.3f} over the resident), model "
            f"{flops / med / 1e9:.3f} TFLOP/s ({100 * flops / med * 1e3 / PEAK_BF16_FLOPS:.3f}% "
            f"of the bf16 peak, {100 * flops / med * 1e3 / PEAK_F32_FLOPS:.3f}% of the f32)")
        return res

    for name, n_batches in (("serve_p99", reps), ("serve_bulk", bulk_batches)):
        b = cells[name].global_batch
        res = timed(name, cells[name], lambda bt: serve(params, bt), b, n_batches)
        if cfg.kind == "bert4rec":
            scores, ids = (t.cpu() for t in res)
            if tuple(ids.shape) != (b, RETRIEVAL_K) or not bool(
                    ((ids >= 0) & (ids < cfg.n_items)).all()):
                raise SystemExit(f"{name}: ids not (B, {RETRIEVAL_K}) in [0, {cfg.n_items})")
            if not bool(torch.isfinite(scores).all()) or not bool(
                    (scores[:, 1:] <= scores[:, :-1]).all()):
                raise SystemExit(f"{name}: scores not finite and descending")
            # the scoring of every item, which the reference's count leaves out
            out[name]["scoring_flops"] = 2.0 * b * cfg.embed_dim * cfg.n_items
        elif tuple(res.shape) != (b,) or not bool(torch.isfinite(res).all()):
            raise SystemExit(f"{name}: logits not finite of shape ({b},)")
    for label, b, n_batches in (("retrieval_cand", 1, reps), ("retrieval B=512", 512, 3)):
        dist, ids = timed(label, cells["retrieval_cand"],
                          lambda bt: retrieve(params, {**bt, **items}), b, n_batches)
        dist, ids = dist.cpu(), ids.cpu()
        if tuple(ids.shape) != (b, RETRIEVAL_K) or not bool(((ids >= 0) & (ids < n)).all()):
            raise SystemExit(f"{label}: ids not (B, {RETRIEVAL_K}) in [0, {n})")
        if not bool(torch.isfinite(dist).all()) or not bool((dist[:, 1:] >= dist[:, :-1]).all()):
            raise SystemExit(f"{label}: sq-dists not finite and ascending")
    calls = {
        "serve_p99": lambda: serve(params, last["serve_p99"]),
        "serve_bulk": lambda: serve(params, last["serve_bulk"]),
        "retrieval_cand": lambda: retrieve(params, {**last["retrieval_cand"], **items}),
        "retrieval B=512": lambda: retrieve(params, {**last["retrieval B=512"], **items}),
    }
    return out, calls


def reference_param_count(cfg) -> int:
    """The number of parameters the reference's init_params draws for a
    dlrm, xdeepfm or bert4rec config, in closed form."""
    def mlp(dims):
        return sum(a * b + b for a, b in zip(dims, dims[1:]))

    f, v, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    if cfg.kind == "bert4rec":  # wq wk wv wo, w1 w2, b1 b2, ln1 ln2 a block
        block = 4 * d * d + 8 * d * d + 4 * d + d + 2 * d
        return cfg.n_items * d + cfg.seq_len * d + cfg.n_blocks * block + 2 * d
    if cfg.kind == "dlrm":
        n_int = (f + 1) * f // 2
        return (f * v * d + mlp([cfg.n_dense, *cfg.bot_mlp])
                + mlp([cfg.bot_mlp[-1] + n_int, *cfg.top_mlp]))
    hs = [f, *cfg.cin_layers]  # xdeepfm: tables, CIN, cin_out, DNN, linear
    return (f * v * d + sum(hs[i] * f * hs[i + 1] for i in range(len(cfg.cin_layers)))
            + sum(cfg.cin_layers) + mlp([f * d, *cfg.mlp, 1]) + f * v)


def check_close(got, want, tol: float, label: str, want32=None) -> float:
    """Card against CPU: max|Δ| ≤ tol·max|cpu|. Returns max|Δ| / max|cpu|.
    For a bf16 gradient, ``want32`` is the CPU's f32 gradient: a leaf past
    the bound passes where the CPU's bf16 gradient itself lies further than
    the bound from it and the card's lies at most BF16_GRAD_SLACK times as
    far (two bf16 roundings of one f32 gradient, not a fault)."""
    g, w = got.float().cpu(), want.float()
    scale = float(w.abs().max()) or 1.0
    rel = float((g - w).abs().max()) / scale
    if rel <= tol:
        return rel
    if want32 is not None:
        ref_off = float((w - want32).abs().max())
        if ref_off > tol * scale and float((g - want32).abs().max()) <= BF16_GRAD_SLACK * ref_off:
            return rel
    raise SystemExit(f"{label}: the card differs from the CPU by {rel:.3e} of max|cpu| "
                     f"(tolerance {tol})")


def check_model_small(dev, spec, cut: dict, seed: int) -> dict:
    """Phase 5: one recsys model at full width with a cut vocabulary, the
    card against the CPU with the same parameters, under FP32 and MIXED
    (within MODEL_TOL): the serve step at B = 512 (bert4rec:
    bert4rec_serve_topk, k = 100, and on the card its chunks of
    TOPK_CHUNKS against each other on 16 histories); the user tower and
    make_recsys_retrieval_step at B = 16 against CUT_ITEMS items, k = 100,
    topk_shards 1 and 4 (check_topk). Where the tower runs in bf16
    (bert4rec under MIXED), the CPU's head scores the card's user vectors."""
    from repro_torch.models import common
    from repro_torch.models.recsys import (
        bert4rec_serve_topk, hybrid_retrieval_topk, init_params, user_tower,
    )
    from repro_torch.train.step import make_recsys_retrieval_step

    out = {}
    for prec in ("FP32", "MIXED"):
        cfg = dataclasses.replace(spec.make_config(), precision=getattr(common, prec), **cut)
        tol = MODEL_TOL[prec]
        cpu_params = init_params(cfg, seed=seed, device="cpu")
        card_params = tree_to(cpu_params, dev)
        batch = recsys_batch(np.random.default_rng(seed + 7), cfg, 512, dev)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        serve = serve_step(cfg)
        got, want = serve(card_params, batch), serve(cpu_params, cpu_batch)
        r = {}
        if cfg.kind == "bert4rec":  # scores within tol·max|cpu|
            atol = tol * float(want[0].abs().max())
            r["serve_ids_equal"] = check_topk(got, want, f"{spec.arch_id} {prec} serve", 0.0, atol)
            runs = [bert4rec_serve_topk(cfg, card_params, batch["items"][:16], k=RETRIEVAL_K,
                                        batch_chunk=c) for c in TOPK_CHUNKS]
            r["chunk_ids_equal"] = min(
                check_topk(run, runs[0], f"{spec.arch_id} {prec} chunks", 0.0,
                           tol * float(runs[0][0].abs().max())) for run in runs[1:])
            r["chunks_bitwise"] = all(torch.equal(run[1], runs[0][1]) for run in runs[1:])
        else:
            if got.dtype != want.dtype:
                raise SystemExit(f"{spec.arch_id} {prec}: logits {got.dtype} on the card, "
                                 f"{want.dtype} on the CPU")
            r["serve_max_rel_err"] = check_close(got, want, tol, f"{spec.arch_id} {prec} serve")
            r["serve_bitwise"] = bool(torch.equal(got.cpu(), want))
        users = {k: v[:16] for k, v in batch.items()}
        cpu_users = {k: v[:16] for k, v in cpu_batch.items()}
        card_u = user_tower(cfg, card_params, users)
        r["tower_max_rel_err"] = check_close(card_u, user_tower(cfg, cpu_params, cpu_users), tol,
                                             f"{spec.arch_id} {prec} user tower")
        items = make_items(dev, CUT_ITEMS, cfg, seed + 6)
        cpu_items = {k: v.cpu() for k, v in items.items()}
        for shards in (1, 4):
            step = make_recsys_retrieval_step(cfg, k=RETRIEVAL_K, topk_shards=shards)
            got_r = step(card_params, {**users, **items})
            if cfg.kind == "bert4rec" and prec == "MIXED":
                want_r = hybrid_retrieval_topk(card_u.cpu(), cpu_users["query_attrs"],
                                               cpu_items["item_embs"], cpu_items["item_attrs"],
                                               RETRIEVAL_K, topk_shards=shards)
            else:
                want_r = step(cpu_params, {**cpu_users, **cpu_items})
            r[f"retrieval_shards{shards}_ids_equal"] = check_topk(
                got_r, want_r, f"{spec.arch_id} {prec} retrieval shards={shards}")
        log(f"  {spec.arch_id} {prec} cut vocabulary {cut}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
        out[prec] = r
    return out


def tree_to(tree, dev):
    """A copy of a nested dict of tensors on ``dev``."""
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


def recsys_model_step(dev, arch: str, cut: dict, seed: int, drive) -> tuple[dict, dict, dict]:
    """Phase 5, one recsys model at full width: its parameters drawn on the
    card from ``seed`` (the count held to the reference's formula); the
    card against the CPU at the cut vocabulary ``cut``; at M = 64 (dlrm-rm2,
    bert4rec) fused_auto on its user vectors against 1M items
    (``check_fused_retrieval``; M = 10 is fm's shape); the serve and
    retrieval steps timed under ``drive`` (a run where fused_auto is never
    launched fails) and profiled once each; then the parameters freed.
    Returns (results, launches, the fused_auto rows or {})."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.common import tree_bytes
    from repro_torch.models.recsys import init_params, user_tower

    spec = get_arch(arch)
    cfg = spec.make_config()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    out = {"params": cfg.param_count, "reference_formula": reference_param_count(cfg),
           "param_gb": tree_bytes(params) / 1e9, "init_s": time.perf_counter() - t0}
    log(f"  {arch}: {out['params']} parameters ({out['param_gb']:.3f} GB) drawn on the card in "
        f"{out['init_s']:.2f} s; the reference's formula gives {out['reference_formula']}")
    if out["params"] != out["reference_formula"]:
        raise SystemExit(f"{arch}: {out['params']} parameters, the reference's formula "
                         f"{out['reference_formula']}")
    t0 = time.perf_counter()
    out["cut_vocab"] = check_model_small(dev, spec, cut, seed)
    out["cut_vocab_s"] = time.perf_counter() - t0
    row = {}
    if cfg.embed_dim == 64:
        rng = np.random.default_rng(seed + 4)
        n = {c.name: c for c in RECSYS_SHAPES}["retrieval_cand"].n_candidates
        items = make_items(dev, n, cfg, seed + 3)

        def users(b):
            batch = recsys_batch(rng, cfg, b, dev)
            return user_tower(cfg, params, batch), batch["query_attrs"]

        row = check_fused_retrieval(users, items["item_embs"], items["item_attrs"],
                                    f"{arch} retrieval")
        del items
    (out["steps"], calls), launches = drive(run_recsys_path, ("fused_auto",), dev, cfg, params,
                                            seed, 20, 2)
    # no warm-up: each step just ran (bert4rec's serve_bulk takes ≈ 6 s a call)
    out["profiles"] = {label: profile_call(f"{arch} {label}", fn, warmup=False)
                       for label, fn in calls.items()}
    del calls
    # the training step trains these parameters in place; no kernel of the
    # port lies on it (the reference trains these models outside Pallas)
    out["train"], train_launches = drive(run_train_path, (), dev, spec, cfg, params, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["train"]["cut_vocab"] = check_train_small(dev, spec, cut, seed)
    launches = {k: launches[k] + train_launches[k] for k in launches}
    return out, launches, row


def train_batch_fn(spec, cfg, b: int, dev):
    """``step → batch`` of b examples on the card: launch/train.py's numpy
    stream for the CTR kinds (ids, labels in {0, 1}, dlrm's dense
    features); for bert4rec histories with the reference cell's
    TRAIN_MASKED masked positions and TRAIN_NEGATIVES shared negatives,
    drawn from ``default_rng(10_000 + step)``."""
    from repro_torch.launch.train import make_batch_fn

    if cfg.kind != "bert4rec":
        return make_batch_fn(spec, cfg, b, 64, dev)

    def batch(step):
        rng = np.random.default_rng(10_000 + step)
        n, s = cfg.n_items, cfg.seq_len
        out = {"items": rng.integers(0, n, (b, s), dtype=np.int32),
               "masked_pos": rng.integers(0, s, (b, TRAIN_MASKED), dtype=np.int32),
               "labels": rng.integers(0, n, (b, TRAIN_MASKED), dtype=np.int32),
               "neg_ids": rng.integers(0, n, (TRAIN_NEGATIVES,), dtype=np.int32)}
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    return batch


def run_train_path(dev, spec, cfg, params, seed: int) -> dict:
    """Phase 5's training step at full width on ``params`` (trained in
    place): AdamW state from ``init_state(spec.optim)``,
    ``make_recsys_train_step``, one warm-up step and TRAIN_STEPS timed ones
    (host time to a synchronised loss, the batch uploaded first) at the
    train_batch cell's B (bert4rec: TRAIN_BERT4REC_BATCH). Checks: every
    loss finite, the first BCE loss within 0.05 of ln 2, every parameter
    leaf moved. Prints the median step ms, examples/s, model TFLOP/s
    (``model_flops`` with the train cell: 3 passes), the peak over the
    resident parameters, then one profiled step."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import tree
    from repro_torch.models.recsys import model_flops
    from repro_torch.train.optim import init_state
    from repro_torch.train.step import make_recsys_train_step

    arch = spec.arch_id
    b = TRAIN_BERT4REC_BATCH if cfg.kind == "bert4rec" else spec.cell("train_batch").global_batch
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    state = init_state(spec.optim, params)
    step = make_recsys_train_step(cfg, spec.optim)
    batches = train_batch_fn(spec, cfg, b, dev)
    before = [p.reshape(-1)[:4096].clone() for p in tree.leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, lat = [], [], []
    for i in range(TRAIN_STEPS + 1):
        batch = batches(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        if i:
            lat.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    moved = [not torch.equal(a, p.reshape(-1)[:4096]) for a, p in zip(before, tree.leaves(params))]
    names = [n for n, _ in tree.flatten_with_paths(params)]
    med = statistics.median(lat)
    flops = model_flops(cfg, ShapeCell(name="train_batch", kind="train", global_batch=b))
    out = dict(batch=b, median_ms=med, min_ms=min(lat), max_ms=max(lat), steps=TRAIN_STEPS,
               examples_per_s=b / med * 1e3, model_flops=flops,
               model_tflops_per_s=flops / med / 1e9, peak_gb=peak / 1e9,
               resident_gb=resident / 1e9, peak_over_resident_gb=(peak - resident) / 1e9,
               state_gb=sum(x.numel() * x.element_size() for x in tree.leaves(state)) / 1e9,
               losses=losses, grad_norms=norms)
    if cfg.kind == "bert4rec":  # the sampled softmax's products, outside the reference's count
        out["sampled_softmax_flops"] = 3.0 * 2 * b * TRAIN_MASKED * TRAIN_NEGATIVES * cfg.embed_dim
    log(f"  {arch} train B={b}: median {med:.3f} ms (min {min(lat):.3f}, max {max(lat):.3f}, "
        f"{TRAIN_STEPS} steps), {b / med * 1e3:.0f} examples/s, model {flops / med / 1e9:.3f} "
        f"TFLOP/s ({100 * flops / med * 1e3 / PEAK_BF16_FLOPS:.3f}% of the bf16 peak); peak "
        f"{peak / 1e9:.3f} GB, {(peak - resident) / 1e9:.3f} over the resident "
        f"{resident / 1e9:.3f} GB of parameters (state {out['state_gb']:.3f} GB); losses "
        + ", ".join(f"{v:.5f}" for v in losses) + f"; grad norm {norms[0]:.4e}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise SystemExit(f"{arch} train: a loss or gradient norm is not finite: {losses} {norms}")
    if cfg.kind != "bert4rec" and abs(losses[0] - math.log(2)) > 0.05:
        raise SystemExit(f"{arch} train: first BCE loss {losses[0]:.5f} is not within 0.05 of ln 2")
    if not all(moved):
        raise SystemExit(f"{arch} train: parameters did not move: "
                         f"{[n for n, m in zip(names, moved) if not m]}")
    out["profile"] = profile_call(f"{arch} train step B={b}",
                                  lambda: step(params, state, batch), warmup=False)
    del state, before
    return out


def check_train_small(dev, spec, cut: dict, seed: int) -> dict:
    """Phase 5: one training step of a model at full width with a cut
    vocabulary, the card against the CPU from the same parameters and
    batch, under FP32 and MIXED: the loss, the gradient norm and every
    gradient within MODEL_TOL·max|cpu| (``check_close``); then
    ``apply_updates`` on the CPU's gradients on both, params and AdamW
    state within OPT_TOL·max|cpu|."""
    import functools

    from repro_torch.core import tree
    from repro_torch.models import common
    from repro_torch.models.recsys import init_params, loss_fn
    from repro_torch.train.optim import _global_norm, apply_updates, init_state
    from repro_torch.train.step import loss_and_grads

    out = {}
    for prec in ("FP32", "MIXED"):
        cfg = dataclasses.replace(spec.make_config(), precision=getattr(common, prec), **cut)
        tol = MODEL_TOL[prec]
        cpu_params = init_params(cfg, seed=seed, device="cpu")
        card_params = tree_to(cpu_params, dev)
        b = TRAIN_SMALL_BERT4REC if cfg.kind == "bert4rec" else TRAIN_SMALL_BATCH
        batch = train_batch_fn(spec, cfg, b, dev)(seed)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        fn = functools.partial(loss_fn, cfg)
        want_l, want_g = loss_and_grads(fn, cpu_params, cpu_batch)
        got_l, got_g = loss_and_grads(fn, card_params, batch)
        want32 = [None] * len(tree.leaves(want_g))
        if prec == "MIXED":  # the f32 gradient that both bf16 ones approximate
            cfg32 = dataclasses.replace(cfg, precision=common.FP32)
            want32 = tree.leaves(loss_and_grads(functools.partial(loss_fn, cfg32), cpu_params,
                                                cpu_batch)[1])
        label = f"{spec.arch_id} {prec} train"
        r = {"loss_rel_err": check_close(got_l, want_l, tol, f"{label} loss"),
             "grad_norm_rel_err": check_close(_global_norm(got_g), _global_norm(want_g), tol,
                                              f"{label} grad norm"),
             "grad_worst_rel_err": max(
                 check_close(g, w, tol, f"{label} grad {n}", w32)
                 for (n, g), w, w32 in zip(tree.flatten_with_paths(got_g), tree.leaves(want_g),
                                           want32))}
        del got_g, want32
        cpu_state, card_state = init_state(spec.optim, cpu_params), init_state(spec.optim, card_params)
        same_g = tree_to(want_g, dev)
        _, cpu_state, mc = apply_updates(spec.optim, cpu_params, want_g, cpu_state)
        _, card_state, mg = apply_updates(spec.optim, card_params, same_g, card_state)
        r["update_worst_rel_err"] = max(
            check_close(g, w, OPT_TOL, f"{label} update {n}")
            for (n, g), w in zip(tree.flatten_with_paths((card_params, card_state)),
                                 tree.leaves((cpu_params, cpu_state))))
        r["update_grad_norm_rel_err"] = check_close(mg["grad_norm"], mc["grad_norm"], OPT_TOL,
                                                    f"{label} update grad norm")
        log(f"  {label} cut vocabulary {cut} B={b}: loss {float(want_l):.5f} (card "
            f"{float(got_l):.5f}); " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
        out[prec] = r
    return out



class _NoKernel(torch.autograd.Function):
    """(B, F, D) → (B,) with a backward, launching no kernel either way:
    what autograd itself costs the host around fm_interaction."""

    @staticmethod
    def forward(ctx, e):
        ctx.shape = e.shape
        return e.new_empty(e.shape[0])

    @staticmethod
    def backward(ctx, g):
        return g[:, None, None].expand(ctx.shape)


def check_fm_gradient(dev, cfg, params, seed: int) -> dict:
    """Phase 5: fm_interaction at the training shape (train_batch B, the fm
    widths) on rows gathered from ``params``. The forward kernel bit for
    bit against its plain version, rows 0 and B-1 alone equal to theirs in
    the batch. The card's gradient is the backward kernel
    (``fm_interaction_bwd``, the autograd ``Function``'s backward), held
    to the CPU's plain ops (``fm_interaction_bwd_ref``) bit for bit there
    and at FM_GRAD_SHAPES, one forward and one backward launch a gradient
    call, rows 0 and B-1 alone equal to theirs. Times the forward and the
    backward alone (event ms, device ms, plain ms) beside their bounds,
    the two together through autograd (event ms and, captured in a CUDA
    graph, device ms), and autograd around a Function with no kernel."""
    from repro_torch.configs.fm import SPEC
    from repro_torch.kernels.fm_interaction.ops import (
        fm_interaction, fm_interaction_bwd, fm_interaction_bwd_ref, fm_interaction_ref,
    )
    from repro_torch.models.recsys import embedding_lookup

    b, f, d = SPEC.cell("train_batch").global_batch, cfg.n_sparse, cfg.embed_dim
    rng = np.random.default_rng(seed + 8)
    ids = rng.integers(0, cfg.vocab_per_field, (b, f), dtype=np.int32)
    emb = embedding_lookup(params["tables"], torch.from_numpy(ids).to(dev))
    fwd = fm_interaction(emb)
    fwd_bitwise = bool(torch.equal(fwd, fm_interaction_ref(emb)))
    invariant = all(bool(torch.equal(fm_interaction(emb[r:r + 1].contiguous())[0], fwd[r]))
                    for r in (0, b - 1))

    def grad(e, g):
        x = e.detach().requires_grad_(True)
        return torch.autograd.grad(fm_interaction(x), x, g)[0]

    g = torch.Generator().manual_seed(seed)
    cases = [(f"B,F,D={b},{f},{d} (train_batch)", emb, torch.randn(b, generator=g).to(dev))]
    for shape in FM_GRAD_SHAPES:
        e = torch.randn(shape, generator=g).mul_(0.3)
        cases.append((f"B,F,D={shape}", e.to(dev), torch.randn(shape[0], generator=g).to(dev)))
    max_err = 0.0
    for tag, e, up in cases:
        n0, m0 = fm_interaction.launches, fm_interaction_bwd.launches
        got = grad(e, up)
        torch.cuda.synchronize()
        counts = (fm_interaction.launches - n0, fm_interaction_bwd.launches - m0)
        if counts != (1, 1):
            raise SystemExit(f"fm_interaction gradient {tag}: {counts} forward and backward "
                             "launches, not one each")
        got, want = got.cpu(), grad(e.cpu(), up.cpu())
        err = float((got.double() - want.double()).abs().max()) if want.numel() else 0.0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise SystemExit(f"fm_interaction gradient {tag}: the backward kernel differs from "
                             f"the CPU's plain gradient by {err:.3e}")
    if not fwd_bitwise or not invariant:
        raise SystemExit(f"fm_interaction at the training shape: bitwise {fwd_bitwise}, rows "
                         f"alone equal {invariant}")
    up = cases[0][2]
    full = fm_interaction_bwd(emb, up)
    bwd_invariant = all(bool(torch.equal(fm_interaction_bwd(emb[r:r + 1].contiguous(),
                                                            up[r:r + 1].contiguous())[0], full[r]))
                        for r in (0, b - 1))
    if not bwd_invariant:
        raise SystemExit("fm_interaction_bwd: a row's gradient alone differs from the batch's")
    del full
    x = emb.detach().requires_grad_(True)
    ms = cuda_ms(lambda: fm_interaction(emb))
    dev_ms = device_ms(lambda: fm_interaction(emb))
    plain_ms = cuda_ms(lambda: fm_interaction_ref(emb), reps=5)
    bwd_ms = cuda_ms(lambda: fm_interaction_bwd(emb, up))
    bwd_dev_ms = device_ms(lambda: fm_interaction_bwd(emb, up))
    bwd_plain_ms = cuda_ms(lambda: fm_interaction_bwd_ref(emb, up), reps=5)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(fm_interaction(x), x, up))
    fwd_bwd_dev_ms = device_ms(lambda: torch.autograd.grad(fm_interaction(x), x, up))
    # autograd's own round trip through a Function that launches nothing:
    # the host time under the event ms above that no kernel can remove
    floor_ms = cuda_ms(lambda: torch.autograd.grad(_NoKernel.apply(x), x, up))
    bound_ms, bound_by = bound(b * f * d * 4 + b * 4, b * (3 * f * d + 3 * d + 1))
    # the backward reads emb and g once and writes (B, F, D) once; a sum,
    # a difference and a product an element
    bwd_bound_ms, bwd_bound_by = bound(2 * b * f * d * 4 + b * 4, 3 * b * f * d)
    backward = dict(
        shape=f"B={b} F={f} D={d} (train_batch)", max_abs_err=max_err, worst_err_over_tol=0.0,
        bitwise_batch_invariant=True, ms=bwd_ms, device_ms=bwd_dev_ms, plain_ms=bwd_plain_ms,
        bound_ms=bwd_bound_ms, bound_by=bwd_bound_by,
        # no single PyTorch call computes g·(Σ_f e − e): a sum, a
        # difference and a product, each its own op
        library_ms=None, grad_bitwise=True, grad_cases=len(cases),
        gradient_of="src/repro/kernels/fm_interaction/ref.py:14 fm_interaction_ref (the "
                    "reference differentiates it with XLA; its TPU kernel has no backward)")
    out = dict(shape=f"B={b} F={f} D={d} (train_batch)", ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, forward_bitwise=True,
               backward=backward, fwd_bwd_ms=fwd_bwd_ms, fwd_bwd_device_ms=fwd_bwd_dev_ms,
               autograd_floor_ms=floor_ms,
               fwd_bwd_bound_ms=bound_ms + bwd_bound_ms, grad_bitwise=True,
               grad_max_abs_err=max_err, grad_cases=len(cases))
    log(f"  fm_interaction train_batch B={b} F={f} D={d}: forward bitwise {fwd_bitwise}, rows "
        f"alone equal; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    log(f"  fm_interaction_bwd train_batch: the backward kernel's gradient equals the CPU's "
        f"plain ops bit for bit over {len(cases)} shapes, one forward and one backward launch "
        f"each; kernel {bwd_ms:.4f} ms (device {bwd_dev_ms:.4f} ms), plain {bwd_plain_ms:.4f} "
        f"ms, bound {bwd_bound_ms:.4f} ms ({bwd_bound_by}); forward + backward through autograd "
        f"{fwd_bwd_ms:.4f} ms (device {fwd_bwd_dev_ms:.4f} ms; bound "
        f"{bound_ms + bwd_bound_ms:.4f}; autograd through a Function with no kernel "
        f"{floor_ms:.4f} ms)")
    del emb, x
    return out


def run_launch_train(dev) -> dict:
    """fm through its normal entry point, on the card:
    ``repro_torch.launch.train.main`` with the full config, B = 65,536, 5
    steps."""
    from repro_torch.launch.train import main as train_main

    res = train_main(["--arch", "fm", "--full-config", "--batch-size", "65536", "--steps", "5"])
    if len(res.losses) != 5 or not all(math.isfinite(v) for v in res.losses):
        raise SystemExit(f"launch.train fm: losses {res.losses}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": res.losses}


def check_train_loop(dev, seed: int) -> dict:
    """Phase 5: the loop on the card at fm's widths with the cut
    vocabulary (V = 1,000), B = LOOP_BATCH, launch/train.py's stream:
    LOOP_STEPS steps with a checkpoint every LOOP_CKPT_EVERY; a crash at
    LOOP_CRASH and a resume, which must resume from LOOP_CKPT_EVERY and end
    within LOOP_RTOL of the uninterrupted run's loss; the last checkpoint the
    port wrote restores onto the card equal to the trained tensors bit for
    bit. Checkpoints go under build/ and are removed."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.fm import SPEC
    from repro_torch.core import tree
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.recsys import init_params
    from repro_torch.train import loop, optim, step

    cfg = dataclasses.replace(SPEC.make_config(), vocab_per_field=CUT_VOCAB)

    def setup():
        params = init_params(cfg, seed=seed, device=dev)
        return (step.make_recsys_train_step(cfg, SPEC.optim), params,
                optim.init_state(SPEC.optim, params), make_batch_fn(SPEC, cfg, LOOP_BATCH, 64, dev))

    workdir = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build"))
    try:
        base = dict(total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT_EVERY, log_every=0)
        a, b = os.path.join(workdir, "a"), os.path.join(workdir, "b")
        t0 = time.perf_counter()
        pa, sa, res_a = loop.run(*setup(), loop.LoopConfig(ckpt_dir=a, **base))
        run_s = time.perf_counter() - t0
        try:
            loop.run(*setup(), loop.LoopConfig(ckpt_dir=b, crash_at_step=LOOP_CRASH, **base))
            raise SystemExit("train loop: the injected preemption did not fire")
        except loop.SimulatedPreemption:
            pass
        _, _, res_b = loop.run(*setup(), loop.LoopConfig(ckpt_dir=b, **base))
        (rp, rs), _ = ckpt.restore(a, LOOP_STEPS, (pa, sa))
        restored_equal = all(x.device == y.device and torch.equal(x, y)
                             for x, y in zip(tree.leaves((rp, rs)), tree.leaves((pa, sa))))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rel = abs(res_a.losses[-1] - res_b.losses[-1]) / abs(res_a.losses[-1])
    out = dict(resumed_from=res_b.resumed_from, final_loss=res_a.losses[-1],
               resumed_final_loss=res_b.losses[-1], final_loss_rel_diff=rel,
               checkpoints_written=res_a.checkpoints_written, restored_bitwise=restored_equal,
               run_s=run_s, losses=res_a.losses)
    log(f"  loop V={CUT_VOCAB} B={LOOP_BATCH}: {LOOP_STEPS} steps in {run_s:.2f} s with "
        f"{res_a.checkpoints_written} checkpoints; crash at {LOOP_CRASH}, resumed from "
        f"{res_b.resumed_from}; final loss {res_a.losses[-1]:.6f} against {res_b.losses[-1]:.6f} "
        f"(rel {rel:.2e}); restored checkpoint bitwise {restored_equal}")
    if res_b.resumed_from != LOOP_CKPT_EVERY or rel > LOOP_RTOL:
        raise SystemExit(f"train loop: resumed from {res_b.resumed_from}, final loss rel {rel:.3e}")
    if not restored_equal:
        raise SystemExit("train loop: a checkpoint the port wrote on the card does not restore "
                         "equal")
    return out


def run_train_retrieval(dev) -> dict:
    """``repro_torch.examples.train_retrieval`` on the card: fm trained for
    300 steps with checkpoints (it raises unless the loss falls), then the
    brute MATCH search through ``Engine``."""
    from repro_torch.examples import train_retrieval

    res = train_retrieval.main([])
    return {"first_loss": res["losses"][0], "last_loss": res["losses"][-1],
            "backend": res["backend"], "matched": res["matched"]}


def lm_unsettled(cfg, stats: dict, prec: str, shape) -> torch.Tensor:
    """The tokens the card may route otherwise than the CPU did
    (``unsettled_tokens`` of the CPU run's router logits): MoE under MIXED
    only; none elsewhere."""
    from repro_torch.models.transformer import unsettled_tokens

    if prec != "MIXED" or not stats.get("router_logits"):
        return torch.zeros(shape, dtype=torch.bool)
    return unsettled_tokens(cfg, stats["router_logits"], LM_EPS).view(shape)


def check_held(got, want, tol: float, label: str, unsure=None) -> float:
    """Card against CPU over the settled rows (``unsure`` false): max|Δ| ≤
    tol·max|cpu|, the scale over every row. Returns max|Δ| / max|cpu|."""
    g, w = got.float().cpu(), want.float()
    scale = float(w.abs().max()) or 1.0
    err = (g - w).abs()
    if unsure is not None:
        err = err[~unsure]
    rel = float(err.max()) / scale if err.numel() else 0.0
    if rel > tol:
        raise SystemExit(f"{label}: the card differs from the CPU by {rel:.3e} of max|cpu| "
                         f"(tolerance {tol})")
    return rel


def check_lm_small(dev, seed: int) -> dict:
    """Phase 5, LM: each reduced config on the card against the CPU with
    the same parameters (drawn on the CPU from ``seed``), under FP32 and
    MIXED within MODEL_TOL: forward logits at (LM_SMALL_B, LM_SMALL_S),
    forward_last, loss_fn, and LM_DECODE_STEPS decode tokens from an empty
    cache of LM_CACHE_ROWS rows; MoE tokens near a router tie under MIXED
    are counted and left out (``lm_unsettled``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import common
    from repro_torch.models import transformer as tfm

    out = {}
    b, s = LM_SMALL_B, LM_SMALL_S
    for arch in LM_IDS:
        for prec in ("FP32", "MIXED"):
            cfg = dataclasses.replace(get_arch(arch).make_reduced(),
                                      precision=getattr(common, prec))
            tol, label = MODEL_TOL[prec], f"{arch} reduced {prec}"
            cpu_params = tfm.init_params(cfg, seed=seed, device="cpu")
            card_params = tree_to(cpu_params, dev)
            rng = np.random.default_rng(seed + 11)
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))
            labels = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))
            dec = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_DECODE_STEPS, b, 1),
                                                dtype=np.int32))
            stats = {}
            want = tfm.forward(cfg, cpu_params, tokens, stats)
            unsure = lm_unsettled(cfg, stats, prec, (b, s))
            r = {"forward": check_held(tfm.forward(cfg, card_params, tokens.to(dev)), want, tol,
                                       f"{label} forward", unsure)}
            r["forward_last"] = check_held(
                tfm.forward_last(cfg, card_params, tokens.to(dev)),
                tfm.forward_last(cfg, cpu_params, tokens), tol, f"{label} forward_last",
                unsure[:, -1])
            batch = {"tokens": tokens, "labels": labels}
            r["loss"] = check_held(
                tfm.loss_fn(cfg, card_params, {k: v.to(dev) for k, v in batch.items()})[None],
                tfm.loss_fn(cfg, cpu_params, batch)[None], tol, f"{label} loss")
            caches = [tfm.init_cache(cfg, b, LM_CACHE_ROWS, device=d) for d in ("cpu", dev)]
            r["decode"], n_unsure = 0.0, int(unsure.sum())
            for i in range(LM_DECODE_STEPS):
                st = {}
                _, w = tfm.decode_step(cfg, cpu_params, caches[0], dec[i], st)
                _, g = tfm.decode_step(cfg, card_params, caches[1], dec[i].to(dev))
                u = lm_unsettled(cfg, st, prec, (b,))
                n_unsure += int(u.sum())
                r["decode"] = max(r["decode"], check_held(g, w, tol, f"{label} decode {i}", u))
            if int(caches[1]["len"]) != LM_DECODE_STEPS:
                raise SystemExit(f"{label}: the card's cache length {int(caches[1]['len'])}")
            if n_unsure > (b * s + b * LM_DECODE_STEPS) // 2:
                raise SystemExit(f"{label}: {n_unsure} tokens unsettled, more than half")
            r["unsettled_tokens"] = n_unsure
            log(f"  {label}: " + ", ".join(
                f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
            out[f"{arch} {prec}"] = r
    return out


def check_decode_prefill(dev, cfg, params, seed: int, label: str) -> float:
    """A LM_PROMPT-token prompt decoded token by token from an empty cache
    on the card: each position's logits against ``forward``'s at that
    position, within MODEL_TOL["MIXED"] of max|forward| there. Returns the
    worst ratio."""
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(seed + 13)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_PROMPT), dtype=np.int32)).to(dev)
    with torch.inference_mode():
        want = tfm.forward(cfg, params, prompt)[0]
    cache = tfm.init_cache(cfg, 1, LM_PROMPT, device=dev)
    worst = 0.0
    for pos in range(LM_PROMPT):
        _, got = tfm.decode_step(cfg, params, cache, prompt[:, pos:pos + 1])
        worst = max(worst, check_held(got[0], want[pos].cpu(), MODEL_TOL["MIXED"],
                                      f"{label} decode against prefill at {pos}"))
    log(f"  {label}: decode against prefill over {LM_PROMPT} positions, worst "
        f"{worst:.3e} of max|forward|")
    return worst


def lm_cell(dev, cfg, params, cell, b: int, step, inputs, label: str, timed: int = 1) -> dict:
    """One LM cell at batch ``b``: ``timed`` calls of ``step(*inputs())``
    on the host clock to a synchronised result (median), the peak device
    memory over what was allocated before (the parameters, and a decode
    cell's cache), tokens/s and model TFLOP/s
    (``model_flops``: 2·active parameters a token, attention left out)."""
    from repro_torch.models.transformer import model_flops

    cell = dataclasses.replace(cell, global_batch=b)
    times = []
    for _ in range(timed):
        args = inputs()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del args, out
    ms = statistics.median(times)
    tokens = b * (cell.seq_len if cell.kind == "prefill" else 1)
    flops = model_flops(cfg, cell)
    r = {"batch": b, "ms": ms, "tokens_per_s": tokens / ms * 1e3,
         "model_tflops": flops / ms / 1e9, "peak_gb_over_before":
             (torch.cuda.max_memory_allocated() - base) / 1e9}
    log(f"  {label} B={b}: {ms:.3f} ms ({'median of %d' % timed if timed > 1 else 'one call'}), "
        f"{r['tokens_per_s']:.1f} tokens/s, {r['model_tflops']:.3f} model TFLOP/s "
        f"({100 * r['model_tflops'] * 1e12 / PEAK_BF16_FLOPS:.2f}% of the bf16 peak), peak "
        f"{r['peak_gb_over_before']:.3f} GB over what was allocated before")
    return r


def lm_weight_bytes(cfg, params, tokens: int) -> int:
    """Bytes of the parameters a step over ``tokens`` tokens must read: all
    but the embedding table (its rows only) and, for MoE, the experts no
    assignment can reach (at most tokens·k of E a layer)."""
    from repro_torch.models.common import tree_bytes

    total = tree_bytes(params) - params["embed"].numel() * params["embed"].element_size()
    total += tokens * cfg.d_model * params["embed"].element_size()
    if cfg.moe:
        experts = sum(params["layers"]["ffn"][w].numel() for w in ("w1", "w2", "w3"))
        unused = 1 - min(cfg.moe.n_experts, tokens * cfg.moe.top_k) / cfg.moe.n_experts
        total -= int(unused * experts * params["layers"]["ffn"]["w1"].element_size())
    return total


def lm_model_step(dev, arch: str, seed: int, n_layers=None) -> dict:
    """Phase 5, one LM arch at full width with bf16 parameters (the
    reference's serving precision, launch/build.py:80-86), on ``n_layers``
    of its layers if given: parameters drawn on the card (the count held to
    the config's); decode against prefill (dense archs); then each cell of
    its shape table that is not skipped:

    - prefill_32k: one sequence first (the peak it adds over the
      parameters sets the batch), then at the largest B that leaves a
      quarter of the card free, or B = 1 where one sequence's full (S, S)
      attention already takes seconds; one profiled call with the MoE
      drop count; the time of one ``_attend`` q-chunk at that shape, times
      the chunks and layers, as the attention's part;
    - decode_32k and long_500k: the cache filled from a generator with
      ``len`` = S − 1, at the reference's B or the largest that leaves a
      quarter free; the median ms a token of LM_DECODE_REPS steps beside
      the bytes bound (the weights a step reads and the cache, over 3.35
      TB/s); one profiled step with the drop count.

    Every logit finite. The parameters and caches are freed at the end."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import Precision, count_params, tree_bytes
    from repro_torch.train.step import make_lm_decode_step, make_lm_prefill_step

    spec = get_arch(arch)
    cfg = spec.make_config(precision=Precision(param_dtype=torch.bfloat16))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    budget = LM_MEM_SHARE * torch.cuda.get_device_properties(dev).total_memory
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    pbytes = tree_bytes(params)
    out = {"layers": cfg.n_layers, "params": cfg.param_count, "param_gb": pbytes / 1e9,
           "init_s": time.perf_counter() - t0}
    log(f"  {arch} ({cfg.n_layers} layers, bf16): {cfg.param_count} parameters "
        f"({out['param_gb']:.3f} GB) drawn on the card in {out['init_s']:.2f} s")
    if count_params(params) != cfg.param_count:
        raise SystemExit(f"{arch}: {count_params(params)} parameters, the config says "
                         f"{cfg.param_count}")
    if not cfg.moe:
        out["decode_vs_prefill"] = check_decode_prefill(dev, cfg, params, seed,
                                                        f"{arch} full width")
    gen = torch.Generator(device=dev).manual_seed(seed + 17)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)

    def finite(logits, label):
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"{label}: logits not finite")

    # ---- prefill
    cell = spec.cell("prefill_32k")
    s, label = cell.seq_len, f"{arch} prefill_32k"
    prefill = make_lm_prefill_step(cfg)
    prefill(params, {"tokens": tokens(1, 2048)})  # warm-up at a short prompt
    one = lm_cell(dev, cfg, params, cell, 1, prefill,
                  lambda: (params, {"tokens": tokens(1, s)}), label)
    b = 1
    if cfg.sliding_window:  # banded: a sequence is cheap, fill the card
        free = budget - torch.cuda.memory_allocated()
        b = min(cell.global_batch, max(1, int(free // (one["peak_gb_over_before"] * 1e9))))
    r = one if b == 1 else dict(lm_cell(dev, cfg, params, cell, b, prefill,
                                        lambda: (params, {"tokens": tokens(b, s)}), label),
                                one_sequence=one)
    stats, batch = {}, {"tokens": tokens(b, s)}
    logits = []
    r["profile"] = profile_call(f"{label} B={b}",
                                lambda: logits.append(tfm.forward_last(cfg, params,
                                                                       batch["tokens"], stats)),
                                warmup=False)
    finite(logits[-1], label)
    if cfg.moe:
        r["dropped"], r["assignments"] = int(stats["dropped"]), stats["assignments"]
        log(f"  {label}: {r['dropped']} of {r['assignments']} assignments dropped by the "
            f"capacity ({100 * r['dropped'] / r['assignments']:.3f}%)")
    del stats, batch, logits
    # the attention's part: one q-chunk's _attend at this shape
    kv, g, dh, qc = cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head, min(cfg.q_chunk, s)
    band = min(cfg.sliding_window + qc, s) if cfg.sliding_window else s
    q = torch.randn((b, qc, kv, g, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, kv, band, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    mask = torch.ones((qc, band), dtype=torch.bool, device=dev)
    chunk_ms = cuda_ms(lambda: tfm._attend(q, k, k, mask), reps=5)
    n_chunks = (s + qc - 1) // qc
    r["attend_chunk_ms"] = chunk_ms
    r["attention_share"] = chunk_ms * n_chunks * cfg.n_layers / r["ms"]
    # the f32 score block: ≈ 45 B an element (bf16 product, f32 copy, /√dh,
    # mask, softmax's passes, bf16 probabilities)
    r["score_block_gb"] = b * kv * g * qc * band * 4 / 1e9
    log(f"  {label}: one q-chunk's _attend (B={b}, {qc} queries x {band} keys, "
        f"{r['score_block_gb']:.3f} GB f32 score block) {chunk_ms:.3f} ms; x {n_chunks} chunks "
        f"x {cfg.n_layers} layers = {100 * r['attention_share']:.1f}% of the prefill")
    del q, k, mask
    out["prefill_32k"] = r

    # ---- decode
    decode = make_lm_decode_step(cfg)
    for cell in spec.shapes:
        if cell.kind != "decode" or cell.skipped:
            continue
        label = f"{arch} {cell.name}"
        rows = tfm.abstract_cache(cfg, 1, cell.seq_len)["k"].shape[2]
        per_seq = 2 * cfg.n_layers * rows * cfg.n_kv_heads * cfg.d_head * 2
        free = budget - torch.cuda.memory_allocated()
        b = min(cell.global_batch, max(1, int(free // per_seq)))
        cache = tfm.init_cache(cfg, b, cell.seq_len, device=dev)
        cache["k"].normal_(generator=gen)
        cache["v"].normal_(generator=gen)
        cache["len"].fill_(cell.seq_len - 1)
        cache_bytes = cache["k"].numel() * 4
        tok = {"tokens": tokens(b, 1)}
        decode(params, cache, tok)  # warm-up
        r = lm_cell(dev, cfg, params, cell, b, decode, lambda: (params, cache, tok), label,
                    timed=LM_DECODE_REPS)
        r["cache_rows"], r["cache_gb"] = rows, cache_bytes / 1e9
        r["weights_read_gb"] = lm_weight_bytes(cfg, params, b) / 1e9
        r["bound_ms"] = (r["weights_read_gb"] + r["cache_gb"]) * 1e9 / PEAK_BYTES_PER_S * 1e3
        stats, logits = {}, []
        r["profile"] = profile_call(f"{label} B={b}", lambda: logits.append(
            tfm.decode_step(cfg, params, cache, tok["tokens"], stats)[1]), warmup=False)
        finite(logits[-1], label)
        if cfg.moe:
            r["dropped"], r["assignments"] = int(stats["dropped"]), stats["assignments"]
        log(f"  {label} B={b}: cache {rows} rows ({r['cache_gb']:.3f} GB), {r['ms']:.3f} ms a "
            f"token against a {r['bound_ms']:.3f} ms bound (weights read "
            f"{r['weights_read_gb']:.3f} GB + cache over 3.35 TB/s; "
            f"{100 * r['bound_ms'] / r['ms']:.1f}%)"
            + (f"; {r['dropped']} of {r['assignments']} assignments dropped" if cfg.moe else ""))
        out[cell.name] = r
        del cache, stats, logits
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_lm_path(dev, seed: int) -> dict:
    """Phase 5's LM step: ``check_lm_small``; decode against prefill at
    yi-34b's and mistral-large-123b's reduced widths; then phi3-mini-3.8b
    at full width and depth and mixtral-8x7b at full width on
    MIXTRAL_LAYERS layers (``lm_model_step``), each freed before the next.
    Device memory must come back to its level before the step."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    out = {"small": check_lm_small(dev, seed), "decode_vs_prefill_reduced": {}}
    for arch in ("yi-34b", "mistral-large-123b"):
        cfg = get_arch(arch).make_reduced()
        params = tfm.init_params(cfg, seed=seed, device=dev)
        out["decode_vs_prefill_reduced"][arch] = check_decode_prefill(
            dev, cfg, params, seed, f"{arch} reduced")
        del params
    out["phi3-mini-3.8b"] = lm_model_step(dev, "phi3-mini-3.8b", seed)
    out["mixtral-8x7b"] = lm_model_step(dev, "mixtral-8x7b", seed, MIXTRAL_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out["memory_before_after"] = (before, after)
    log(f"  LM step: device memory {before} B before, {after} B after")
    if after > before + (64 << 20):
        raise SystemExit(f"LM step: {after - before} B still allocated after the models were freed")
    return out


def lm_train_small_batch(cfg, spec, seed: int) -> tuple[dict, int, str]:
    """``check_lm_train_small``'s CPU batch and its micro-batch count: the
    LM_TRAIN_SMALL batch with the spec's micro_batches; for a MoE config
    under bf16 compute, the settled LM_TRAIN_MOE_S-token sequences (router
    logits of the CPU's forward, ``unsettled_tokens`` at LM_EPS), a
    micro-batch each."""
    from repro_torch.models import transformer as tfm

    if not (cfg.moe and cfg.precision.compute_dtype == torch.bfloat16):
        b, s = LM_TRAIN_SMALL
        rng = np.random.default_rng(seed + 31)
        return ({k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))
                 for k in ("tokens", "labels")}, spec.micro_batches, "")
    params = tfm.init_params(cfg, seed=seed, device="cpu")
    seqs = []
    for i in range(LM_TRAIN_MOE_SEEDS):
        rng = np.random.default_rng(seed + 100 + i)
        t, lab = (torch.from_numpy(rng.integers(0, cfg.vocab, (spec.micro_batches,
                                                               LM_TRAIN_MOE_S), dtype=np.int32))
                  for _ in range(2))
        seqs += [(t[j:j + 1], lab[j:j + 1]) for j in range(spec.micro_batches)]
    held = []
    for t, lab in seqs:
        stats = {}
        with torch.no_grad():
            tfm.forward(cfg, params, t, stats)
        if not bool(tfm.unsettled_tokens(cfg, stats["router_logits"], LM_EPS).any()):
            held.append((t, lab))
    if len(held) < len(seqs) / 2:
        raise SystemExit(f"{spec.arch_id} MIXED train: only {len(held)} of {len(seqs)} "
                         f"sequences settled")
    return ({"tokens": torch.cat([t for t, _ in held]), "labels": torch.cat([x for _, x in held])},
            len(held), f"{len(held)} of {len(seqs)} sequences settled")


def check_lm_train_small(dev, seed: int) -> dict:
    """Phase 5, LM training: each reduced config, the card against the CPU
    with the same parameters (drawn on the CPU from ``seed``) under FP32
    and MIXED: one micro-batched step's loss, gradient norm and every
    accumulated gradient (``train.step.accumulated_grads``, what
    make_lm_train_step applies) within MODEL_TOL (``check_close``, the
    bf16 slack against the CPU's f32 gradient); then on the card the
    gradients of one micro-batch with every layer checkpointed against
    without, bit for bit."""
    import functools

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.models import common
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import _global_norm
    from repro_torch.train.step import _split_leading, accumulated_grads, loss_and_grads

    out = {}
    for arch in LM_IDS:
        spec = get_arch(arch)
        for prec in ("FP32", "MIXED"):
            cfg = dataclasses.replace(spec.make_reduced(), precision=getattr(common, prec))
            tol, label = MODEL_TOL[prec], f"{arch} reduced {prec} train"
            cpu = tfm.init_params(cfg, seed=seed, device="cpu")
            card = tree_to(cpu, dev)
            batch, micro, held = lm_train_small_batch(cfg, spec, seed)
            card_batch = {k: v.to(dev) for k, v in batch.items()}
            fn = functools.partial(tfm.loss_fn, cfg)
            want_l, want_g = accumulated_grads(fn, cpu, batch, micro, _split_leading)
            got_l, got_g = accumulated_grads(fn, card, card_batch, micro, _split_leading)
            want32 = [None] * len(tree.leaves(want_g))
            if prec == "MIXED":
                fn32 = functools.partial(tfm.loss_fn, dataclasses.replace(cfg, precision=common.FP32))
                want32 = tree.leaves(accumulated_grads(fn32, cpu, batch, micro, _split_leading)[1])
            r = {"micro_batches": micro,
                 "loss_rel_err": check_close(got_l, want_l, tol, f"{label} loss"),
                 "grad_norm_rel_err": check_close(_global_norm(got_g), _global_norm(want_g), tol,
                                                  f"{label} grad norm"),
                 "grad_worst_rel_err": max(
                     check_close(g, w, tol, f"{label} grad {n}", w32)
                     for (n, g), w, w32 in zip(tree.flatten_with_paths(got_g),
                                               tree.leaves(want_g), want32))}
            if held:
                r["held"] = held
            first = {k: v[0] for k, v in _split_leading(card_batch, micro).items()}
            on = loss_and_grads(fn, card, first)
            off = loss_and_grads(functools.partial(tfm.loss_fn,
                                                   dataclasses.replace(cfg, remat=False)),
                                 card, first)
            r["remat_bitwise"] = bool(torch.equal(on[0], off[0])) and all(
                torch.equal(a, b) for a, b in zip(tree.leaves(on[1]), tree.leaves(off[1])))
            log(f"  {label} B={tuple(batch['tokens'].shape)} micro_batches={micro}: loss "
                f"{float(want_l):.5f} (card {float(got_l):.5f}); " + ", ".join(
                    f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
            if not r["remat_bitwise"]:
                raise SystemExit(f"{label}: gradients with remat differ from those without on "
                                 f"the card")
            out[f"{arch} {prec}"] = r
            del card, got_g
    return out


def lm_train_run(dev, spec, cfg, b: int, seed: int, steps: int, first=None) -> dict:
    """``steps`` steps of make_lm_train_step (the spec's optimizer and
    micro_batches) at batch ``b`` of the train_4k cell, through
    launch/train.py's batch stream, parameters and state drawn on the card.
    Returns the peak allocated bytes, the resident bytes before the steps,
    host ms a step to a synchronised loss, losses and gradient norms, and
    the parameters, state, step and last batch (dropping the dict frees
    them). ``first(params, batch)`` runs before the first step."""
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import init_state
    from repro_torch.train.step import make_lm_train_step

    gc.collect()
    torch.cuda.empty_cache()
    params = tfm.init_params(cfg, seed=seed, device=dev)
    state = init_state(spec.optim, params)
    step = make_lm_train_step(cfg, spec.optim, spec.micro_batches)
    batches = make_batch_fn(spec, cfg, b, spec.cell("train_4k").seq_len, dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lat, losses, norms = [], [], []
    if first is not None:
        first(params, batches(0))
    for i in range(steps):
        batch = batches(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return dict(peak=torch.cuda.max_memory_allocated(), resident=resident, lat=lat,
                losses=losses, norms=norms, params=params, state=state, step=step, batch=batch)


def moe_drops(cfg, spec, params, batch) -> tuple[int, int]:
    """(dropped, assignments) of the capacity over ``batch``'s micro-batches,
    each routed alone as the train step routes it."""
    from repro_torch.models import transformer as tfm

    stats, per = {}, batch["tokens"].shape[0] // spec.micro_batches
    with torch.no_grad():
        for j in range(spec.micro_batches):
            tfm.forward(cfg, params, batch["tokens"][j * per:(j + 1) * per], stats)
    return int(stats["dropped"]), stats["assignments"]


def lm_train_step(dev, arch: str, n_layers, b: int, seed: int) -> dict:
    """Phase 5, one LM arch's train step at full width (MIXED, remat):
    with ``n_layers`` None, two steps at each of LM_TRAIN_PROBE depths give
    the peak a layer, and the deepest stack under LM_MEM_SHARE of the card
    is taken. One warm-up step and LM_TRAIN_STEPS timed: median step ms,
    tokens/s, model TFLOP/s (``model_flops``: 6·active parameters·tokens),
    the peak over the resident parameters and state (it must stay under
    the share), every loss finite and the first within 1 of ln V, every
    parameter moved; one profiled step (busy share, top ops); for MoE the
    capacity's drops over the first batch's micro-batches before the first
    step and over the last batch's after the last."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_bytes

    spec = get_arch(arch)
    base = spec.make_config()
    cell = spec.cell("train_4k")
    s = cell.seq_len
    budget = LM_MEM_SHARE * torch.cuda.get_device_properties(dev).total_memory
    out = {"batch": b, "seq_len": s, "micro_batches": spec.micro_batches}
    if n_layers is None:
        peaks = []
        for depth in LM_TRAIN_PROBE:
            r = lm_train_run(dev, spec, dataclasses.replace(base, n_layers=depth), b, seed, 2)
            peaks.append(r["peak"])
            del r
        lo, hi = LM_TRAIN_PROBE
        per_layer = max(peaks[1] - peaks[0], 1) / (hi - lo)
        n_layers = min(base.n_layers, lo + int((budget - peaks[0]) // per_layer))
        out["probe"] = {"layers": LM_TRAIN_PROBE, "peak_gb": [p / 1e9 for p in peaks],
                        "per_layer_gb": per_layer / 1e9, "budget_gb": budget / 1e9}
        log(f"  {arch} train probe: peak {peaks[0] / 1e9:.3f} / {peaks[1] / 1e9:.3f} GB at "
            f"{lo} / {hi} layers, {per_layer / 1e9:.3f} GB a layer; {n_layers} layers fit "
            f"{budget / 1e9:.1f} GB")
    cfg = dataclasses.replace(base, n_layers=n_layers)
    label = f"{arch} train_4k ({n_layers} layers) B={b}"
    init = {}
    r = lm_train_run(dev, spec, cfg, b, seed, LM_TRAIN_STEPS + 1,
                     (lambda p, bt: init.update(drops=moe_drops(cfg, spec, p, bt))) if cfg.moe
                     else None)
    params, state, step, batch = r["params"], r["state"], r["step"], r["batch"]
    lat, losses = r["lat"][1:], r["losses"]
    med = statistics.median(lat)
    flops = tfm.model_flops(cfg, dataclasses.replace(cell, global_batch=b))
    before = {n: p.reshape(-1)[:4096].clone() for n, p in tree.flatten_with_paths(params)}
    out.update(layers=n_layers, params=cfg.param_count, median_ms=med, min_ms=min(lat),
               max_ms=max(lat), tokens_per_s=b * s / med * 1e3, model_flops=flops,
               model_tflops_per_s=flops / med / 1e9, peak_gb=r["peak"] / 1e9,
               resident_gb=r["resident"] / 1e9,
               peak_over_resident_gb=(r["peak"] - r["resident"]) / 1e9,
               param_gb=tree_bytes(params) / 1e9,
               state_gb=sum(x.numel() * x.element_size() for x in tree.leaves(state)) / 1e9,
               losses=losses, grad_norms=r["norms"], budget_gb=budget / 1e9)
    log(f"  {label}: median {med:.3f} ms (min {min(lat):.3f}, max {max(lat):.3f}, "
        f"{LM_TRAIN_STEPS} steps), {out['tokens_per_s']:.1f} tokens/s, model "
        f"{out['model_tflops_per_s']:.3f} TFLOP/s ({100 * flops / med * 1e3 / PEAK_BF16_FLOPS:.2f}% "
        f"of the bf16 peak); peak {out['peak_gb']:.3f} GB of a {budget / 1e9:.1f} GB budget, "
        f"{out['peak_over_resident_gb']:.3f} over the resident {out['resident_gb']:.3f} GB "
        f"(parameters {out['param_gb']:.3f}, state {out['state_gb']:.3f}); losses "
        + ", ".join(f"{v:.5f}" for v in losses) + f"; grad norm {r['norms'][0]:.4e}")
    if not all(math.isfinite(v) for v in losses + r["norms"]):
        raise SystemExit(f"{label}: a loss or gradient norm is not finite")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        raise SystemExit(f"{label}: first loss {losses[0]:.4f} is not within 1 of ln V")
    if r["peak"] > budget:
        raise SystemExit(f"{label}: peak {r['peak'] / 1e9:.3f} GB leaves less than a quarter "
                         f"of the card free")
    out["profile"] = profile_call(label, lambda: step(params, state, batch), warmup=False)
    moved = [n for n, p in tree.flatten_with_paths(params)
             if torch.equal(before[n], p.reshape(-1)[:4096])]
    if moved:
        raise SystemExit(f"{label}: parameters did not move in the profiled step: {moved}")
    if cfg.moe:
        out["dropped_at_init"] = init["drops"][0]
        out["dropped"], out["assignments"] = moe_drops(cfg, spec, params, batch)
        log(f"  {label}: {out['dropped_at_init']} of {out['assignments']} assignments dropped by "
            f"the capacity before the first step, {out['dropped']} after the last "
            f"({LM_TRAIN_STEPS + 2} steps)")
    del params, state, step, batch, r, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_lm_train_path(dev, seed: int) -> dict:
    """Phase 5's LM training step: ``check_lm_train_small``, then each of
    LM_TRAIN_CELLS (``lm_train_step``), each freed before the next. Device
    memory must come back to its level before the step."""
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = {"small": check_lm_train_small(dev, seed)}
    out["small_s"] = time.perf_counter() - t0
    log(f"  LM train card against CPU: {out['small_s']:.2f} s")
    for arch, layers, b in LM_TRAIN_CELLS:
        out[arch] = lm_train_step(dev, arch, layers, b, seed)
    after = torch.cuda.memory_allocated()
    log(f"  LM train step: device memory {before} B before, {after} B after")
    if after > before + (64 << 20):
        raise SystemExit(f"LM train step: {after - before} B still allocated after the models "
                         f"were freed")
    return out


def gnn_small_batch(n: int, e: int, d_in: int, d_out: int, seed: int) -> dict:
    """A numpy graph of n nodes, each reached by one edge, plus e random
    edges; 20% of the edges masked out, 70% of the nodes in the loss."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.arange(n), rng.integers(0, n, e)]).astype(np.int32)
    return {"node_feats": rng.normal(size=(n, d_in)).astype(np.float32),
            "src": rng.integers(0, n, dst.size).astype(np.int32), "dst": dst,
            "edge_mask": rng.random(dst.size) < 0.8,
            "targets": rng.normal(size=(n, d_out)).astype(np.float32),
            "node_mask": (rng.random(n) < 0.7).astype(np.float32)}


def gnn_cell_batch(name: str, cut: int = 1, seed: int = 0) -> dict:
    """The numpy batch of one GNN_SHAPES cell (``cut`` divides
    ogb_products' padded nodes and edges), with edge_mask and node_mask."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data import graph

    cell = {c.name: c for c in GNN_SHAPES}[name]
    if name == "minibatch_lg":
        n, e, f, o = GNN_REDDIT
        g = graph.make_random_graph(n, e // GNN_REDDIT_EDGE_CUT, f, o, seed=seed, build_csr=True)
        sub = graph.sample_fanout(g, np.arange(1024), (15, 10), seed=seed + 1)
        batch = graph.subgraph_batch(g, sub)
    else:
        if name == "full_graph_sm":
            g = graph.make_random_graph(2708, 10556, cell.d_feat, cell.d_out, seed=seed)
        elif name == "ogb_products":
            g = graph.make_random_graph(cell.n_nodes // cut, cell.n_edges // cut, cell.d_feat,
                                        cell.d_out, seed=seed)
        else:
            g = graph.make_molecule_batch(128, 30, 64, cell.d_feat, cell.d_out, seed=seed)
        n_edges = cell.n_edges // cut
        pad = n_edges - g.n_edges
        batch = {"node_feats": g.node_feats,
                 "src": np.concatenate([g.src, np.zeros(pad, np.int32)]),
                 "dst": np.concatenate([g.dst, np.zeros(pad, np.int32)]),
                 "edge_mask": np.arange(n_edges) < g.n_edges,
                 "targets": g.targets.astype(np.float32),
                 "node_mask": np.ones(g.n_nodes, np.float32)}
    if batch["src"].shape[0] != cell.n_edges // cut or \
            batch["node_feats"].shape != (cell.n_nodes // cut, cell.d_feat):
        raise SystemExit(f"{name}: batch shapes {batch['node_feats'].shape} nodes, "
                         f"{batch['src'].shape} edges against the cell's")
    return batch


def gnn_model_flops(cfg, n: int, e: int) -> float:
    """The reference's count for one train step (launch/build.py:184-186):
    3 × (L·(6d²E + 4d²N) + 2·d_feat·d·N + 2·d·d_out·N)."""
    d = cfg.d_hidden
    return 3.0 * (cfg.n_layers * (6 * d * d * e + 4 * d * d * n)
                  + 2 * cfg.d_in * d * n + 2 * d * cfg.d_out * n)


def gnn_train_peak(dev, spec, cfg, batch_np: dict, seed: int) -> int:
    """Peak allocated bytes over two GNN train steps of ``cfg`` on
    ``batch_np`` (everything freed after)."""
    from repro_torch.models import gnn
    from repro_torch.train.optim import init_state
    from repro_torch.train.step import make_gnn_train_step

    gc.collect()
    torch.cuda.empty_cache()
    params = gnn.init_params(cfg, seed=seed, device=dev)
    state = init_state(spec.optim, params)
    step = make_gnn_train_step(cfg, spec.optim)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        params, state, m = step(params, state, batch)
        float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    del params, state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def gnn_cell(dev, spec, name: str, batch_np: dict, seed: int, label: str) -> dict:
    """One GNN cell at full width: parameters and AdamW state drawn on the
    card; make_gnn_train_step timed (one warm-up, the median of GNN_STEPS
    on the host clock to a synchronised loss), edges/s and model TFLOP/s
    (the reference's count), the peak over the resident parameters and
    state (under the budget), every loss finite; make_gnn_infer_step timed
    likewise, its output finite and of the cell's shape; one profiled train
    step (busy share, top ops)."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models import gnn
    from repro_torch.models.common import tree_bytes
    from repro_torch.train.optim import init_state
    from repro_torch.train.step import make_gnn_infer_step, make_gnn_train_step

    cell = {c.name: c for c in GNN_SHAPES}[name]
    cfg = spec.make_config(cell)
    budget = LM_MEM_SHARE * torch.cuda.get_device_properties(dev).total_memory
    n, e = batch_np["node_feats"].shape[0], batch_np["src"].shape[0]
    gc.collect()
    torch.cuda.empty_cache()
    params = gnn.init_params(cfg, seed=seed, device=dev)
    state = init_state(spec.optim, params)
    step, infer = make_gnn_train_step(cfg, spec.optim), make_gnn_infer_step(cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lat, losses = [], []
    for i in range(GNN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        if i:
            lat.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    infer_lat = []
    for i in range(GNN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = infer(params, batch)
        torch.cuda.synchronize()
        if i:
            infer_lat.append((time.perf_counter() - t0) * 1e3)
    if tuple(y.shape) != (n, cfg.d_out) or not bool(torch.isfinite(y).all()):
        raise SystemExit(f"{label}: infer output {tuple(y.shape)} not finite or not (N, d_out)")
    med, imed = statistics.median(lat), statistics.median(infer_lat)
    flops = gnn_model_flops(cfg, n, e)
    out = dict(nodes=n, edges=e, d_in=cfg.d_in, d_out=cfg.d_out, layers=cfg.n_layers,
               median_ms=med, min_ms=min(lat), max_ms=max(lat), edges_per_s=e / med * 1e3,
               model_flops=flops, model_tflops_per_s=flops / med / 1e9, peak_gb=peak / 1e9,
               resident_gb=resident / 1e9, peak_over_resident_gb=(peak - resident) / 1e9,
               param_gb=tree_bytes(params) / 1e9, infer_median_ms=imed, losses=losses)
    log(f"  {label} N={n} E={e}: train median {med:.3f} ms (min {min(lat):.3f}, max "
        f"{max(lat):.3f}, {GNN_STEPS} steps), {out['edges_per_s']:.4g} edges/s, model "
        f"{out['model_tflops_per_s']:.3f} TFLOP/s; peak {peak / 1e9:.3f} GB, "
        f"{(peak - resident) / 1e9:.3f} over the resident {resident / 1e9:.3f} GB; infer median "
        f"{imed:.3f} ms; losses " + ", ".join(f"{v:.5f}" for v in losses))
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"{label}: a loss is not finite: {losses}")
    if peak > budget:
        raise SystemExit(f"{label}: peak {peak / 1e9:.3f} GB leaves less than a quarter of the "
                         f"card free")
    out["profile"] = profile_call(f"{label} train step", lambda: step(params, state, batch),
                                  warmup=False)
    del params, state, batch, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_gnn_small(dev, seed: int) -> dict:
    """Phase 5, GNN: the card against the CPU with the same parameters
    (drawn on the CPU from ``seed``): graphcast-smoke under FP32 and MIXED
    on the GNN_SMALL graph (the loss, every gradient within MODEL_TOL, the
    bf16 slack against the CPU's f32 gradient; the infer step's output),
    then the full_graph_sm cell at full width under FP32 on
    GNN_FULL_CHECK_LAYERS layers (loss and every gradient within
    1e-5·max|cpu|). Prints the CPU's own gradients' move when the features
    move by GNN_PERTURB (relative, N(0, 1)) at that depth and at full
    depth: the model's conditioning, against which the bar is set."""
    import functools

    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.models import common, gnn
    from repro_torch.train.step import loss_and_grads, make_gnn_infer_step

    spec = get_arch("graphcast")
    cases = []
    for prec in ("FP32", "MIXED"):
        cfg = dataclasses.replace(spec.make_reduced(), precision=getattr(common, prec))
        cases.append((f"graphcast-smoke {prec}", cfg, prec,
                      gnn_small_batch(*GNN_SMALL, cfg.d_in, cfg.d_out, seed + 41)))
    full = {c.name: c for c in GNN_SHAPES}["full_graph_sm"]
    full_batch = gnn_cell_batch("full_graph_sm", seed=seed)
    cases.append((f"graphcast full_graph_sm FP32 ({GNN_FULL_CHECK_LAYERS} layers)",
                  spec.make_config(full, precision=common.FP32, n_layers=GNN_FULL_CHECK_LAYERS),
                  "FP32", full_batch))
    out = {"conditioning": {}}
    cpu_b = {k: torch.from_numpy(v) for k, v in full_batch.items()}
    noise = torch.randn(cpu_b["node_feats"].shape, generator=torch.Generator().manual_seed(seed))
    moved_b = dict(cpu_b, node_feats=cpu_b["node_feats"] * (1 + GNN_PERTURB * noise))
    for layers in (GNN_FULL_CHECK_LAYERS, spec.make_config(full).n_layers):
        cfg = spec.make_config(full, precision=common.FP32, n_layers=layers)
        params = gnn.init_params(cfg, seed=seed, device="cpu")
        fn = functools.partial(gnn.loss_fn, cfg)
        g0, g1 = (loss_and_grads(fn, params, b)[1] for b in (cpu_b, moved_b))
        moves = {n: float((a - b).abs().max() / b.abs().max())
                 for (n, a), b in zip(tree.flatten_with_paths(g1), tree.leaves(g0))}
        worst = max(moves, key=moves.get)
        out["conditioning"][layers] = {"worst_leaf": worst, "move": moves[worst]}
        log(f"  graphcast full_graph_sm FP32, {layers} layers, CPU: features moved by "
            f"{GNN_PERTURB:g} move the gradients by up to {moves[worst]:.3e} of their scale "
            f"({worst})")
        del params, g0, g1
    for label, cfg, prec, batch in cases:
        tol = MODEL_TOL[prec]
        cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()}
        card_b = {k: v.to(dev) for k, v in cpu_b.items()}
        cpu = gnn.init_params(cfg, seed=seed, device="cpu")
        card = tree_to(cpu, dev)
        fn = functools.partial(gnn.loss_fn, cfg)
        t0 = time.perf_counter()
        want_l, want_g = loss_and_grads(fn, cpu, cpu_b)
        cpu_s = time.perf_counter() - t0
        got_l, got_g = loss_and_grads(fn, card, card_b)
        want32 = [None] * len(tree.leaves(want_g))
        if prec == "MIXED":
            fn32 = functools.partial(gnn.loss_fn, dataclasses.replace(cfg, precision=common.FP32))
            want32 = tree.leaves(loss_and_grads(fn32, cpu, cpu_b)[1])
        infer = make_gnn_infer_step(cfg)
        r = {"loss_rel_err": check_close(got_l, want_l, tol, f"{label} loss"),
             "grad_worst_rel_err": max(
                 check_close(g, w, tol, f"{label} grad {n}", w32)
                 for (n, g), w, w32 in zip(tree.flatten_with_paths(got_g), tree.leaves(want_g),
                                           want32)),
             "infer_rel_err": check_close(infer(card, card_b), infer(cpu, cpu_b), tol,
                                          f"{label} infer"),
             "cpu_s": cpu_s}
        log(f"  {label} N={batch['node_feats'].shape[0]} E={batch['src'].shape[0]}: loss "
            f"{float(want_l):.6f} (card {float(got_l):.6f}); " + ", ".join(
                f"{k} {v:.3g}" for k, v in r.items()))
        out[label] = r
        del card, got_g
    return out


def run_gnn_path(dev, seed: int) -> dict:
    """Phase 5's GNN step: ``check_gnn_small``, then graphcast at full
    width on each GNN_SHAPES cell (``gnn_cell``), ogb_products at the cut
    its probe picks. Device memory must come back to its level before."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_arch

    spec = get_arch("graphcast")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = {"small": check_gnn_small(dev, seed)}
    out["small_s"] = time.perf_counter() - t0
    log(f"  GNN card against CPU: {out['small_s']:.2f} s")
    budget = LM_MEM_SHARE * torch.cuda.get_device_properties(dev).total_memory
    for cell in GNN_SHAPES:
        t0 = time.perf_counter()
        cut = 1
        if cell.name == "ogb_products":
            cfg = spec.make_config(cell)
            lo, hi = GNN_OGB_PROBE
            peaks = [gnn_train_peak(dev, spec, cfg, gnn_cell_batch(cell.name, c, seed), seed)
                     for c in (lo, hi)]
            per_edge = max(peaks[1] - peaks[0], 1) / (cell.n_edges // hi - cell.n_edges // lo)
            cut = lo
            while cut > 1 and peaks[0] + per_edge * (cell.n_edges // (cut // 2)
                                                     - cell.n_edges // lo) <= budget:
                cut //= 2
            out["ogb_probe"] = {"cuts": GNN_OGB_PROBE, "peak_gb": [p / 1e9 for p in peaks],
                                "per_edge_kb": per_edge / 1e3, "cut": cut}
            log(f"  ogb_products probe: peak {peaks[0] / 1e9:.3f} / {peaks[1] / 1e9:.3f} GB at "
                f"cuts {lo} / {hi}, {per_edge / 1e3:.2f} KB an edge; cut {cut} fits "
                f"{budget / 1e9:.1f} GB")
        batch = gnn_cell_batch(cell.name, cut, seed)
        data_s = time.perf_counter() - t0
        label = f"graphcast {cell.name}" + (f" (cut {cut})" if cut > 1 else "")
        out[cell.name] = dict(gnn_cell(dev, spec, cell.name, batch, seed, label), cut=cut,
                              data_s=data_s)
        del batch
    after = torch.cuda.memory_allocated()
    log(f"  GNN step: device memory {before} B before, {after} B after")
    if after > before + (64 << 20):
        raise SystemExit(f"GNN step: {after - before} B still allocated after the cells")
    return out


def run_dryrun_cells() -> dict:
    """The dry run over ``all_cells()`` in process (meta tensors, nothing on
    the card): the single mesh, then the pod mesh if the single one took
    under half of DRY_BOTH_S. One line a cell; any cell not ok fails.
    Returns each cell's [argument bytes, temp bytes, per_device_total,
    model_flops, counted FLOPs, method] and each mesh's seconds."""
    from repro_torch.configs.registry import all_cells
    from repro_torch.launch import dryrun

    out = {"meshes": []}
    for mesh_kind in ("single", "pod"):
        if mesh_kind == "pod" and 2 * out["single_s"] > DRY_BOTH_S:
            log(f"  pod mesh left out: both meshes would take over {DRY_BOTH_S:.0f} s")
            break
        t0 = time.perf_counter()
        for arch, shape in all_cells():
            res = dryrun.run_cell(arch, shape, mesh_kind)
            if not res["ok"] or "error" in res.get("corrected", {}):
                raise SystemExit(f"dry run {arch} × {shape} × {mesh_kind}: {res}")
            log(f"  dry run {arch} × {shape} × {mesh_kind}: {dryrun.summary(res)}")
            if not res.get("skipped"):
                mem = res["memory"]
                out[f"{arch}|{shape}|{mesh_kind}"] = [
                    mem["argument_bytes"], mem["temp_bytes"], mem["per_device_total"],
                    res["meta"]["model_flops"], res["cost"]["flops"], res["cost"]["method"]]
        out[f"{mesh_kind}_s"] = time.perf_counter() - t0
        out["meshes"].append(mesh_kind)
        log(f"  dry run on the {mesh_kind} mesh: {out[f'{mesh_kind}_s']:.2f} s")
    return out


def dry_materialize(dev, spec, cell, build, overrides, seed: int) -> tuple:
    """A cell's arguments on the card from ``seed``: the port's initialisers
    (parameters, optimizer state, the KV cache), this script's recsys batch
    makers and a random graph of the GNN cell's sizes; shapes and dtypes
    held to the build's meta arguments."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.models import gnn, recsys, transformer
    from repro_torch.models.common import Precision
    from repro_torch.train.optim import init_state

    rng = np.random.default_rng(seed)
    if spec.family == "lm":  # the decode cell: bf16 serving parameters
        cfg = dataclasses.replace(spec.make_config(), **(overrides or {}),
                                  precision=Precision(param_dtype=torch.bfloat16))
        params = transformer.init_params(cfg, seed, dev)
        tokens = rng.integers(0, cfg.vocab, (cell.global_batch, 1), dtype=np.int32)
        args = (params, transformer.init_cache(cfg, cell.global_batch, cell.seq_len, device=dev),
                {"tokens": torch.from_numpy(tokens).to(dev)})
    elif spec.family == "gnn":
        cfg = spec.make_config(cell)
        params = gnn.init_params(cfg, seed, dev)
        n, e = cell.n_nodes, cell.n_edges  # random edges (minibatch_lg has fewer than nodes)
        g = {"node_feats": rng.normal(size=(n, cell.d_feat)).astype(np.float32),
             "src": rng.integers(0, n, e, dtype=np.int32),
             "dst": rng.integers(0, n, e, dtype=np.int32), "edge_mask": rng.random(e) < 0.8,
             "targets": rng.normal(size=(n, cell.d_out)).astype(np.float32),
             "node_mask": (rng.random(n) < 0.7).astype(np.float32)}
        args = (params, init_state(spec.optim, params),
                {k: torch.from_numpy(v).to(dev) for k, v in g.items()})
    else:
        cfg = spec.make_config()
        params = recsys.init_params(cfg, seed, dev)
        if cell.kind == "train":
            args = (params, init_state(spec.optim, params),
                    train_batch_fn(spec, cfg, cell.global_batch, dev)(0))
        else:
            batch = recsys_batch(rng, cfg, cell.global_batch, dev)
            if cell.kind == "retrieval":
                batch |= make_items(dev, cell.n_candidates, cfg, seed)
            else:
                del batch["query_attrs"]
            args = (params, batch)
    got = [(p, tuple(t.shape), t.dtype) for p, t in tree_mod.flatten_with_paths(args)]
    want = [(p, tuple(t.shape), t.dtype) for p, t in
            tree_mod.flatten_with_paths(build.abstract_args)]
    if got != want:
        bad = [(a, b) for a, b in zip(got, want) if a != b] or (len(got), len(want))
        raise SystemExit(f"{spec.arch_id} {cell.name}: materialised arguments {bad}")
    return args


def dry_cell_on_card(dev, arch: str, shape: str, overrides, seed: int) -> dict:
    """One cell built on a (1, 1) LocalMesh: its arguments materialised on
    the card hold the dry run's argument_bytes (the allocator's requested
    bytes exactly; its blocks round each leaf up to 512 B, and a leaf over
    1 MiB may take up to 1 MiB more where less would be left of a block);
    one step under FlopCounterMode counts what the meta count counts, and
    its outputs are finite; a second step is timed, its peak printed beside
    the dry run's per_device_total."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree as tree_mod
    from repro_torch.distributed.sharding import sharded_bytes
    from repro_torch.launch import dryrun
    from repro_torch.launch.build import build_cell
    from repro_torch.launch.mesh import make_local_mesh

    spec = get_arch(arch)
    cell = spec.cell(shape)
    mesh = make_local_mesh(1, 1)
    build = build_cell(spec, cell, mesh, overrides)
    arg_bytes = sharded_bytes(mesh, build.abstract_args, build.in_specs)
    mem = dryrun.memory_analysis(spec, cell, mesh, build, overrides)
    meta_flops = dryrun.count_step(build)["flops"]
    leaves = tree_mod.leaves(build.abstract_args)
    nbytes = [t.numel() * t.element_size() for t in leaves]
    rounded = sum(-(-n // 512) * 512 for n in nbytes)
    slack = sum(1 << 20 for n in nbytes if n > 1 << 20)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
    args = dry_materialize(dev, spec, cell, build, overrides, seed)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - base_req
    label = f"{arch} {shape}" + (f" {overrides}" if overrides else "")
    if not (requested == arg_bytes == mem["argument_bytes"] == sum(nbytes)
            and rounded <= held <= rounded + slack):
        raise SystemExit(f"{label}: argument bytes on the card {requested} requested, {held} "
                         f"held (rounded {rounded} + up to {slack}); dry run {arg_bytes}")
    with FlopCounterMode(display=False) as fc:
        out = build.step(*args)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    if card_flops != meta_flops:
        raise SystemExit(f"{label}: {card_flops} FLOPs counted on the card, {meta_flops} on meta")
    bad = [p for p, t in tree_mod.flatten_with_paths(out)
           if t.dtype.is_floating_point and not bool(torch.isfinite(t).all())]
    if bad:
        raise SystemExit(f"{label}: non-finite outputs {bad}")
    del out
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = build.step(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    row = {"argument_bytes": arg_bytes, "requested_bytes": requested, "held_bytes": held,
           "flops": card_flops, "step_ms": step_ms, "peak_bytes": peak,
           "per_device_total": mem["per_device_total"], "temp_bytes": mem["temp_bytes"],
           "peak_over_estimate": peak / mem["per_device_total"]}
    log(f"  {label} on the card: arguments {arg_bytes / 1e9:.4f} GB (requested {requested} B = "
        f"the dry run's, held {held} B), {card_flops / 1e12:.4f} TFLOP counted on the card "
        f"= meta; step {step_ms:.2f} ms, peak {peak / 1e9:.3f} GB against per_device_total "
        f"{mem['per_device_total'] / 1e9:.3f} GB (temp estimate {mem['temp_bytes'] / 1e9:.3f} "
        f"GB): {row['peak_over_estimate']:.3f}")
    del out, args
    gc.collect()
    torch.cuda.empty_cache()
    return row


def plain_ring_sum(parts: list, i: int):
    """((p_{i+1} + p_{i+2}) + …) + p_i: shard i's order on the ring."""
    acc = parts[(i + 1) % len(parts)]
    for s in range(2, len(parts) + 1):
        acc = acc + parts[(i + s) % len(parts)]
    return acc


def check_ring_matmuls(dev, seed: int) -> dict:
    """Both ring matmuls on a (data 1, model RING_SHARDS) mesh on the card
    at RING_SHAPE in f32: each shard's result equal bit for bit to the
    plain sum of the same partials in ring order, and within RING_RTOL of
    one torch.matmul; all three timed."""
    from repro_torch.distributed.collective_matmul import (
        ring_allreduce_matmul, ring_reduce_scatter_matmul,
    )
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_local_mesh

    b, k, n = RING_SHAPE
    mesh = make_local_mesh(1, RING_SHARDS)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev).div_(math.sqrt(k))
    xs = NamedSharding(mesh, P(None, "model")).split(x)
    ws = NamedSharding(mesh, P("model", None)).split(w)
    ar = ring_allreduce_matmul(mesh, xs, ws)
    rs = ring_reduce_scatter_matmul(mesh, xs, ws)
    partials = [torch.matmul(a, c) for a, c in zip(xs, ws)]
    chunk = b // RING_SHARDS
    for i in range(RING_SHARDS):
        if not torch.equal(ar[i], plain_ring_sum(partials, i)):
            raise SystemExit(f"ring_allreduce_matmul shard {i}: not the plain ring-order sum")
        if not torch.equal(rs[i], plain_ring_sum([p[i * chunk:(i + 1) * chunk]
                                                  for p in partials], i)):
            raise SystemExit(f"ring_reduce_scatter_matmul shard {i}: not the plain sum")
    ref = torch.matmul(x, w)
    scale = float(ref.abs().max())
    err = max(max(float((a - ref).abs().max()) for a in ar),
              float((torch.cat(rs) - ref).abs().max())) / scale
    if err > RING_RTOL:
        raise SystemExit(f"ring matmuls: {err:.3e}·max|ref| from torch.matmul")
    del ar, rs, partials
    out = {"shape": list(RING_SHAPE), "shards": RING_SHARDS, "rel_err": err,
           "allreduce_ms": cuda_ms(lambda: ring_allreduce_matmul(mesh, xs, ws), reps=5),
           "reduce_scatter_ms": cuda_ms(lambda: ring_reduce_scatter_matmul(mesh, xs, ws), reps=5),
           "matmul_ms": cuda_ms(lambda: torch.matmul(x, w), reps=5)}
    log(f"  ring matmuls x {b}x{k} @ w {k}x{n} f32 over {RING_SHARDS} shards on the card: bit "
        f"for bit the plain ring-order sums, {err:.3e}·max|ref| from one matmul; allreduce "
        f"{out['allreduce_ms']:.3f} ms, reduce-scatter {out['reduce_scatter_ms']:.3f} ms, "
        f"torch.matmul {out['matmul_ms']:.3f} ms")
    return out


def check_ring_aggregate(dev, seed: int) -> dict:
    """``ring_partitioned_aggregate`` on a (1, RING_SHARDS) mesh on the card
    over ogb_products' graph cut by AGG_CUT with AGG_D-wide f32 messages,
    within RING_RTOL of ``scatter_sum`` over every edge; the peak above
    the messages beside one whole (N, d) f32 accumulator."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.core import graph_ops
    from repro_torch.distributed.gnn_aggregate import ring_partitioned_aggregate
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_local_mesh

    cell = {c.name: c for c in GNN_SHAPES}["ogb_products"]
    n = cell.n_nodes // AGG_CUT
    dst = torch.from_numpy(gnn_cell_batch("ogb_products", AGG_CUT, seed)["dst"]).to(dev)
    e = dst.numel()
    mesh = make_local_mesh(1, RING_SHARDS)
    g = torch.Generator(device=dev).manual_seed(seed)
    msgs = torch.randn((e, AGG_D), generator=g, device=dev)
    m_parts = NamedSharding(mesh, P("model", None)).split(msgs)
    d_parts = NamedSharding(mesh, P("model")).split(dst)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = ring_partitioned_aggregate(mesh, m_parts, d_parts, n)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    want = graph_ops.scatter_sum(msgs, dst, n)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    err = float((torch.cat(got) - want).abs().max()) / float(want.abs().max())
    if err > RING_RTOL:
        raise SystemExit(f"ring_partitioned_aggregate: {err:.3e}·max|want| from scatter_sum")
    whole = n * AGG_D * 4
    out = {"nodes": n, "edges": e, "d": AGG_D, "messages_gb": msgs.numel() * 4 / 1e9,
           "rel_err": err, "ring_ms": ring_ms, "scatter_sum_ms": full_ms,
           "peak_above_messages_gb": peak / 1e9, "whole_accumulator_gb": whole / 1e9}
    log(f"  ring aggregate over ogb_products cut by {AGG_CUT} ({n} nodes, {e} edges, d = "
        f"{AGG_D}, {out['messages_gb']:.2f} GB of f32 messages) on {RING_SHARDS} shards: "
        f"{err:.3e}·max|want| from scatter_sum; {ring_ms:.2f} ms (scatter_sum {full_ms:.2f} ms); "
        f"peak above the messages {peak / 1e9:.3f} GB, a whole (N, d) f32 accumulator "
        f"{whole / 1e9:.3f} GB")
    del msgs, m_parts, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_sharding_fields(dev, seed: int) -> dict:
    """phi3 and mixtral at their reduced configs and graphcast-smoke: the
    forward with the sharding fields build_cell sets on the single
    production mesh equals the forward without, bit for bit on the card
    (the GNN's under deterministic algorithms: its scatter adds otherwise
    land in any order)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import gnn, transformer

    g = torch.Generator(device=dev).manual_seed(seed)
    lm_fields = {
        "phi3-mini-3.8b": dict(act_dp_axes=("data",), act_seq_axis="model"),
        "mixtral-8x7b": dict(act_dp_axes=("data",), act_seq_axis="model", moe_expert_axis=None,
                             moe_capacity_axes=("data",), moe_ff_axis="model"),
    }
    for arch, fields in lm_fields.items():
        cfg = get_arch(arch).make_reduced()
        params = transformer.init_params(cfg, seed, dev)
        tokens = torch.randint(0, cfg.vocab, (2, 96), generator=g, device=dev, dtype=torch.int32)
        with torch.no_grad():
            a = transformer.forward(dataclasses.replace(cfg, **fields), params, tokens)
            b = transformer.forward(cfg, params, tokens)
        if not torch.equal(a, b):
            raise SystemExit(f"{arch} reduced: the sharding fields changed the forward")
    cfg = get_arch("graphcast").make_reduced()
    params = gnn.init_params(cfg, seed, dev)
    feats = torch.randn((64, cfg.d_in), generator=g, device=dev)
    src, dst = (torch.randint(0, 64, (256,), generator=g, device=dev, dtype=torch.int32)
                for _ in range(2))
    sharded = dataclasses.replace(cfg, edge_shard_axes=("data", "model"),
                                  node_shard_axes=("data", "model"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            a, b = (gnn.forward(c, params, feats, src, dst) for c in (sharded, cfg))
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(a, b):
        raise SystemExit("graphcast-smoke: the sharding fields changed the forward")
    log("  sharding fields: phi3 and mixtral reduced, graphcast-smoke forward equal with and "
        "without them, bit for bit on the card")
    return {"equal": ["phi3-mini-3.8b", "mixtral-8x7b", "graphcast-smoke"]}


def run_sharded_dryrun_path(dev, seed: int) -> dict:
    """Phase 5's sharded and dry-run step: the dry run over every cell
    (``run_dryrun_cells``), the DRY_CELLS against the card
    (``dry_cell_on_card``), the ring functions (``check_ring_matmuls``,
    ``check_ring_aggregate``) and the sharding fields
    (``check_sharding_fields``)."""
    t0 = time.perf_counter()
    out = {"dryrun": run_dryrun_cells()}
    out["cells"] = {}
    for arch, shape, overrides in DRY_CELLS:
        out["cells"][f"{arch}|{shape}"] = dry_cell_on_card(dev, arch, shape, overrides, seed)
    # fm's backward is a kernel on the card and one (B, F, D) tensor on meta
    ratio = out["cells"]["fm|train_batch"]["peak_over_estimate"]
    if not 0.95 <= ratio <= 1.05:
        raise SystemExit(f"fm train_batch: the card's peak is {ratio:.3f} of the dry run's "
                         "per_device_total, not within 5%")
    out["ring_matmul"] = check_ring_matmuls(dev, seed)
    out["ring_aggregate"] = check_ring_aggregate(dev, seed)
    out["fields"] = check_sharding_fields(dev, seed)
    out["step_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus size (>= 200000 for a record)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: run it from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.data.synthetic import make_hybrid_dataset
    from repro_torch.core.auto import sample_stats
    from repro_torch.api import Engine, SearchParams
    from repro_torch.kernels import build
    from repro_torch.kernels.adc_scan.ops import adc_scan4_scores, adc_scan_scores
    from repro_torch.kernels.fm_interaction.ops import fm_interaction, fm_interaction_bwd
    from repro_torch.kernels.fused_auto.ops import fused_auto
    from repro_torch.kernels.gather_auto.ops import gather_auto

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: device + build
    card = gpu_line()
    log(f"[1] device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    ds = make_hybrid_dataset(n=args.n, n_queries=256, profile="sift", seed=args.seed)
    alpha = sample_stats(ds.features, ds.attrs).alpha
    log(f"  data: sift profile N={args.n} M={ds.features.shape[1]} L={ds.attr_dim}x{ds.labels_per_dim} "
        f"in {time.perf_counter() - t0:.2f} s; alpha={alpha:.6f}")

    # ---- phase 2: kernels against their plain versions
    log("[2] kernels against their plain versions")
    kern = check_kernels(dev, ds, alpha, args.seed)
    kern["fused_auto"].update(check_fused_auto_exact(dev, alpha, args.seed))
    kern["gather_auto"].update(check_gather_wide(dev, alpha, args.seed))
    kern.update(check_adc_kernels(dev, ds, alpha, args.seed))

    # ---- phase 3: a small input against the CPU's plain versions
    log("[3] small input: the main path on the card against the CPU")
    small = check_small_input(dev, args.seed)

    # ---- phase 4: the main path, exact then quantized; each path's launch
    # counts start from 0 just before it and are read just after it
    log("[4] main path: Engine.build + Engine.search (graph, brute), exact then quantized")
    wrappers = {"gather_auto": gather_auto, "fused_auto": fused_auto,
                "adc_scan": adc_scan_scores, "adc_scan4": adc_scan4_scores,
                "fm_interaction": fm_interaction, "fm_interaction_bwd": fm_interaction_bwd}

    def drive(path, kernels, *args):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = path(*args)
        counts = {name: w.launches for name, w in wrappers.items()}
        log(f"  {path.__name__}: {time.perf_counter() - t0:.2f} s; launches {counts}")
        idle = [k for k in kernels if counts[k] == 0]
        if idle:
            raise SystemExit(f"{path.__name__}: kernels not launched: {idle}")
        return out, counts

    (main_out, eng), exact_launches = drive(
        run_main_path, ("gather_auto", "fused_auto"), dev, ds)
    log("[4] serving: serve_loop and ThreadedServer over the exact engine")
    (serve_out, serve_flush), serve_launches = drive(
        run_serve_path, ("gather_auto", "fused_auto"), dev, ds, eng, args.seed)
    (quant_out, pq_eng), quant_launches = drive(
        run_quant_path, ("gather_auto", "fused_auto", "adc_scan", "adc_scan4"), dev, ds, eng)
    log("[4] partitioned: Engine.build_partitioned, saved, loaded under a residency cap")
    workdir = tempfile.mkdtemp(prefix="partitioned_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        (part_out, (peng, part_q, part_params)), part_launches = drive(
            run_partitioned_path, ("fused_auto", "gather_auto", "adc_scan"),
            dev, ds, eng, args.seed, workdir)
        part_out["step_s"] = time.perf_counter() - t0
        log(f"  partitioned step: {part_out['step_s']:.2f} s")
        kern["partition_probe"] = check_partition_probe(dev, peng, part_q, part_params)
        log("[4] tiered: TieredEngine over the pq engine, then over the partitioned engine")
        t0 = time.perf_counter()
        tier_out, tier_launches = drive(
            run_tiered_path, ("gather_auto", "adc_scan"), dev, ds, pq_eng, peng, part_params,
            part_out["cap_rows"], args.seed)
        tier_out["step_s"] = time.perf_counter() - t0
        log(f"  tiered step: {tier_out['step_s']:.2f} s")
        kern["tiered"] = check_tiered_kernels(dev, ds, pq_eng, args.seed)
        log("[4] sharded: ShardedStableIndex on a (data=1, model=4) mesh on the one card, exact "
            "then pq")
        t0 = time.perf_counter()
        (shard_out, seng), shard_launches = drive(
            run_sharded_path, ("gather_auto", "fused_auto"), dev, ds, eng, pq_eng, args.seed,
            workdir)
        shard_out["step_s"] = time.perf_counter() - t0
        kern["sharded"] = check_sharded_kernels(dev, ds, seng.index, args.seed)
        t0 = time.perf_counter()
        shard_out.update(check_sharded_small(dev, args.seed))
        shard_out["checks_s"] = time.perf_counter() - t0
        log(f"  sharded step: {shard_out['step_s']:.2f} s, exhaustive and N={SMALL_N} checks "
            f"{shard_out['checks_s']:.2f} s")
        # last: searches timed after the profiler run slower; not counted
        q = predicate_batches(ds)["MATCH"]
        profiles = {f"{tag}/{b}": profile_search(e, q, SearchParams(k=10, backend=b))
                    for tag, e in (("exact", eng), ("pq", pq_eng)) for b in ("graph", "brute")}
        profiles["serve/flush_128"] = profile_call("serve bucket-128 graph flush", serve_flush)
        profiles["partitioned/brute"] = profile_call(
            f"partitioned nprobe={part_params.nprobe} brute",
            lambda: peng.search(part_q, part_params))
        profiles["sharded/exact"] = profile_call(
            f"sharded {SHARDS} shards exact", lambda: seng.search(q, SearchParams(k=10)))
        # the mutable step takes the exact index over; nothing else keeps it
        mutable_base = [(eng.index, eng._cost_model)]
        del eng, pq_eng, serve_flush, peng, seng
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("[4] mutable: writes, the federated read, merge, WAL, checkpoint, serving with writes")
    workdir = tempfile.mkdtemp(prefix="mutable_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        (mut_out, meng), mut_launches = drive(
            run_mutable_path, ("gather_auto", "fused_auto"), dev, ds, mutable_base, args.seed,
            workdir)
        mut_out["step_s"] = time.perf_counter() - t0
        kern["mutable"] = check_mutable_kernels(dev, ds, meng, alpha, args.seed)
        meng.wal.close()
        del meng
        t0 = time.perf_counter()
        mut_out["freshness"] = check_mutable_small(dev, args.seed)
        mut_out["freshness_s"] = time.perf_counter() - t0
        log(f"  mutable step: {mut_out['step_s']:.2f} s, N={SMALL_N} freshness "
            f"{mut_out['freshness_s']:.2f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 5: the recsys path at the full fm width
    log("[5] recsys: the fm model's serve and retrieval steps at full width")
    from repro_torch.configs.fm import make_config
    from repro_torch.models.common import tree_bytes
    from repro_torch.models.recsys import init_params

    fm_cfg = make_config()
    t0 = time.perf_counter()
    fm_params = init_params(fm_cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    log(f"  fm F={fm_cfg.n_sparse} V={fm_cfg.vocab_per_field} D={fm_cfg.embed_dim}: "
        f"{fm_cfg.param_count} parameters ({tree_bytes(fm_params) / 1e9:.3f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    kern.update(check_recsys_kernels(dev, fm_cfg, fm_params, args.seed))
    recsys_small = check_recsys_small(dev, args.seed)
    (recsys_out, calls), recsys_launches = drive(
        run_recsys_path, ("fm_interaction", "fused_auto"), dev, fm_cfg, fm_params, args.seed)
    profiles.update({f"recsys/{label}": profile_call(label, fn) for label, fn in calls.items()})
    del calls
    # fm training: the kernel's gradient, then the step on the same
    # parameters (trained in place, then freed), the launcher, the card
    # against the CPU, the loop and the example
    from repro_torch.configs.fm import SPEC as FM_SPEC

    log("[5] recsys training: fm at full width")
    kern["fm_interaction"]["train_batch"] = check_fm_gradient(dev, fm_cfg, fm_params, args.seed)
    kern["fm_interaction_bwd"] = kern["fm_interaction"]["train_batch"]["backward"]
    train_out = {}
    train_out["fm"], fm_train_launches = drive(
        run_train_path, ("fm_interaction", "fm_interaction_bwd"), dev, FM_SPEC, fm_cfg,
        fm_params, args.seed)
    del fm_params
    gc.collect()
    torch.cuda.empty_cache()
    train_out["fm_launch"], launch_train_launches = drive(
        run_launch_train, ("fm_interaction", "fm_interaction_bwd"), dev)
    train_out["fm"]["cut_vocab"] = check_train_small(dev, FM_SPEC, {"vocab_per_field": CUT_VOCAB},
                                                     args.seed)
    train_out["loop"] = check_train_loop(dev, args.seed)
    train_out["train_retrieval"], retrieval_train_launches = drive(
        run_train_retrieval, ("fm_interaction", "fm_interaction_bwd", "fused_auto"), dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the other recsys models, one at a time, each freed before the next
    models_out, models_launches, m64 = {}, dict.fromkeys(wrappers, 0), {}
    for arch, cut in RECSYS_MODELS:
        log(f"[5] recsys model {arch} at full width")
        t0 = time.perf_counter()
        models_out[arch], model_launches, row = recsys_model_step(dev, arch, cut, args.seed, drive)
        models_out[arch]["step_s"] = time.perf_counter() - t0
        log(f"  {arch} step: {models_out[arch]['step_s']:.2f} s")
        for k in wrappers:
            models_launches[k] += model_launches[k]
        if row:
            m64[arch] = row
        train_out[arch] = models_out[arch].pop("train")
    # the LM family's serving path: no kernel of the port lies on it (the
    # reference computes its layers in plain jnp)
    log("[5] LM: the five reduced configs card against CPU, then phi3-mini-3.8b and "
        f"mixtral-8x7b ({MIXTRAL_LAYERS} layers) at full width")
    t0 = time.perf_counter()
    lm_out, lm_launches = drive(run_lm_path, (), dev, args.seed)
    lm_out["step_s"] = time.perf_counter() - t0
    log(f"  LM step: {lm_out['step_s']:.2f} s")
    # LM training and the GNN: no kernel of the port lies on either (the
    # reference computes them in plain jnp and jax.ops.segment_*)
    log("[5] LM training: the five reduced configs card against CPU, then train_4k at full "
        "width: " + ", ".join(f"{a} ({n or 'deepest that fits'} layers, B={b})"
                              for a, n, b in LM_TRAIN_CELLS))
    t0 = time.perf_counter()
    lm_train_out, lm_train_launches = drive(run_lm_train_path, (), dev, args.seed)
    lm_train_out["step_s"] = time.perf_counter() - t0
    log(f"  LM train step: {lm_train_out['step_s']:.2f} s")
    log("[5] GNN: graphcast card against CPU, then the four graph cells at full width")
    t0 = time.perf_counter()
    gnn_out, gnn_launches = drive(run_gnn_path, (), dev, args.seed)
    gnn_out["step_s"] = time.perf_counter() - t0
    log(f"  GNN step: {gnn_out['step_s']:.2f} s")
    log("[5] sharded and dry run: every cell on meta tensors, five cells against the card, "
        "the ring functions and the sharding fields")
    dry_out, dry_launches = drive(run_sharded_dryrun_path,
                                  ("fm_interaction", "fm_interaction_bwd", "fused_auto"),
                                  dev, args.seed)
    log(f"  sharded and dry-run step: {dry_out['step_s']:.2f} s")
    train_launches = {k: fm_train_launches[k] + launch_train_launches[k]
                      + retrieval_train_launches[k] for k in wrappers}
    launches = {k: exact_launches[k] + serve_launches[k] + quant_launches[k] + part_launches[k]
                + tier_launches[k] + shard_launches[k] + mut_launches[k] + recsys_launches[k]
                + models_launches[k] + train_launches[k] + lm_launches[k]
                + lm_train_launches[k] + gnn_launches[k] + dry_launches[k] for k in wrappers}
    # one more build, profiled (no warm-up: the kernels ran in the first).
    # Last of all: after its many thousand launches the profiler drops the
    # events of later profiles.
    profiles["exact/build"] = profile_call(
        "build", lambda: Engine.build(ds.features, ds.attrs, device=dev), warmup=False)

    # ---- phase 6: the kernels line
    sources = {
        "gather_auto": ("src/repro_torch/kernels/csrc/gather_auto.cu",
                        "src/repro/kernels/gather_auto/gather_auto.py:73"),
        "fused_auto": ("src/repro_torch/kernels/csrc/fused_auto.cu",
                       "src/repro/kernels/fused_auto/fused_auto.py:98"),
        "adc_scan": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                     "src/repro/kernels/adc_scan/adc_scan.py:102"),
        "adc_scan4": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                      "src/repro/kernels/adc_scan/adc_scan.py:160"),
        "fm_interaction": ("src/repro_torch/kernels/csrc/fm_interaction.cu",
                           "src/repro/kernels/fm_interaction/fm_interaction.py:34"),
        # the gradient of the same function (``gradient_of`` in its entry)
        "fm_interaction_bwd": ("src/repro_torch/kernels/csrc/fm_interaction.cu",
                               "src/repro/kernels/fm_interaction/fm_interaction.py:34"),
    }
    kern["fused_auto"]["retrieval"] = kern.pop("fused_auto_retrieval")
    kern["fused_auto"]["retrieval_m64"] = m64
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kern[name]["max_abs_err"],
         "ms": kern[name]["ms"], "device_ms": kern[name]["device_ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"], "shape": kern[name]["shape"],
         "worst_err_over_tol": kern[name]["worst_err_over_tol"],
         "bitwise_batch_invariant": kern[name]["bitwise_batch_invariant"],
         **{k: kern[name][k] for k in ("serve_p99", "train_batch", "retrieval", "retrieval_m64",
                                       "auto_ms",
                                       "auto_device_ms",
                                       "tiles", "fused_auto_exact_cases",
                                       "fused_auto_many_attrs_cases",
                                       "fused_auto_rows_equal_single_calls", "l2_device_ms",
                                       "l2_bound_ms", "every_pair_from_memory_ms",
                                       "lookup_ceiling_ms",
                                       "descent_block", "narrow_block", "wide",
                                       "gradient_of", "grad_cases")
                if k in kern[name]},
         **({"partition_probe": kern["partition_probe"][name]}
            if name in kern["partition_probe"] else {}),
         **({{"fused_auto": "delta_scan", "gather_auto": "link_hop"}[name]:
             kern["mutable"][name]} if name in kern["mutable"] else {}),
         **({"tiered": kern["tiered"], "sharded_hop": kern["sharded"]}
            if name == "gather_auto" else {})}
        for name, (src, rep) in sources.items()
    ]}
    log("[6] summary " + json.dumps({"n": args.n, "main_path": main_out, "serve": serve_out,
                                     "quantized": quant_out, "partitioned": part_out,
                                     "tiered": tier_out, "sharded": shard_out,
                                     "mutable": mut_out,
                                     "recsys": recsys_out, "recsys_cut_vocab": recsys_small,
                                     "recsys_models": models_out, "train": train_out,
                                     "lm": lm_out, "lm_train": lm_train_out,
                                     "gnn": gnn_out, "sharded_dryrun": dry_out,
                                     "profiles": profiles, "small_input": small,
                                     "launches": {"exact": exact_launches,
                                                  "serve": serve_launches,
                                                  "quantized": quant_launches,
                                                  "partitioned": part_launches,
                                                  "tiered": tier_launches,
                                                  "sharded": shard_launches,
                                                  "mutable": mut_launches,
                                                  "recsys": recsys_launches,
                                                  "recsys_models": models_launches,
                                                  "fm_train": fm_train_launches,
                                                  "fm_launch_train": launch_train_launches,
                                                  "train_retrieval": retrieval_train_launches,
                                                  "lm": lm_launches,
                                                  "lm_train": lm_train_launches,
                                                  "gnn": gnn_launches,
                                                  "sharded_dryrun": dry_launches},
                                     "gather_descent_block": kern["gather_auto"]["descent_block"],
                                     "gather_narrow_block": kern["gather_auto"]["narrow_block"],
                                     "fm_serve_p99": kern["fm_interaction"]["serve_p99"],
                                     "fused_auto_retrieval": kern["fused_auto"]["retrieval"],
                                     "fused_auto_retrieval_m64": m64}))
    log(gpu_line())
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
