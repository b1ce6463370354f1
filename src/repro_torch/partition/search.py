"""PartitionedSearcher: probe → per-partition search → merge → rerank.

Executes a ``Plan(backend="partitioned")`` over a ``PartitionedStableIndex``:
score the P coarse centroids, prune partitions whose attribute summaries
cannot contain a survivor, group the batch's queries by probed partition
(sub-batches padded up a power-of-two ladder), search each resident
partition, and merge the per-partition pools into one global top-k.

Bit-exact parity with the port's unpartitioned brute engine (``nprobe = P``)
comes from three properties, kept deliberately:

* every scoring call is the kernel the flat ``BruteForceSearcher`` runs
  (``fused_auto`` through ``brute_fused_sqdist``, ``adc_scan`` over the
  same ADC tables, ``gather_auto`` for the exact rerank) on the
  partition's rows; the kernels are invariant to a row's position and to
  the batch, so slicing cannot change a score;
* per-partition selection and the global merge both order candidates by
  the lexicographic key (score, global id) (``graph_ops.lexsort``), the
  tie order of the flat engine's stable sort, where position == global id;
* the PQ path builds the ADC tables once for the whole batch, merges *raw
  ADC pools* globally and runs ONE exact rerank of the merged pool head,
  as ``_adc_two_stage`` does (a per-partition rerank would rank in another
  currency).

The merge buffer lives on the engine's device and is filled by indexed
writes, so a probed partition costs no device-to-host copy on the brute
sub-backend.

On the card, with every partition resident, the brute sub-backend replays
its probe and each group's operations as CUDA graphs (``_ScanGraphs``):
the call's groups go up as one array, and each group's graph reads its
row at a device cursor. A group then costs the host one replay instead
of about forty operations, so the card, not the host thread, paces a
call. The graphs run the same kernels on the same values as the eager
loop, so the answers are the same bits.

Spans (``obs.trace``; recorded in a sampled request, or under
``torch.profiler``): ``probe`` around the centroid scores and the probe
order (``partitions_scored``, ``partitions_probed``, ``partitions_pruned``,
``nprobe``), one ``group`` a probed partition around everything its
sub-batch costs (``pid``, ``queries``, ``bucket``, ``rows_real``, ``rows``),
and ``merge`` around the global merge. Their attributes are host values:
recording them adds no device wait.

The graph sub-backend traverses each partition's HELP subgraph with the
global metric calibration and merges fused sqdists (approximate across
partitions, like any IVF layer); partitions too small to carry a subgraph
are scanned with the same fused metric so the merge currency matches.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import lru_get, to_tensor
from repro_torch.core import routing as routing_mod
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID, lexsort, smallest_k
from repro_torch.core.routing import SearchResult
from repro_torch.kernels.gather_auto.ops import gather_auto
from repro_torch.obs import trace as obs_trace
from repro_torch.partition.store import row_bucket
from repro_torch.quant import adc_scan
from repro_torch.quant.store import is_packed_mode, is_pq_mode

Tensor = torch.Tensor

__all__ = ["PartitionedSearcher"]

#: Bound on cached per-partition entry pools (pid × batch-bucket × seed).
ENTRY_CACHE_SIZE = 512

_L2 = MetricConfig(mode="l2")


def _batch_bucket(b: int, cap: int) -> int:
    """Next power-of-two sub-batch size, capped at the full batch."""
    s = 1
    while s < b:
        s *= 2
    return min(s, cap)


def _iter_groups(store, groups: dict[int, np.ndarray]):
    """Yield (pid, qidx) while double-buffering: stage pid[i+1] on the
    store's background worker before pid[i] is scored, so the next
    partition's disk read and device copy overlap the current probe."""
    order = list(groups.items())
    for i, (pid, qidx) in enumerate(order):
        if i + 1 < len(order):
            store.prefetch(order[i + 1][0])
        yield pid, qidx


def _groups(probes: np.ndarray) -> dict[int, np.ndarray]:
    """pid → ascending query indices probing it (-1 slots are pruned), in
    ascending pid order. A query probes a partition at most once."""
    pid = probes.ravel()
    qid = np.repeat(np.arange(probes.shape[0]), probes.shape[1])
    keep = pid >= 0
    pid, qid = pid[keep], qid[keep]
    order = np.lexsort((qid, pid))
    pid, qid = pid[order], qid[order]
    pids, starts = np.unique(pid, return_index=True)
    ends = np.append(starts[1:], pid.size)
    return {int(p): qid[a:e] for p, a, e in zip(pids, starts, ends)}


def _pad_idx(qidx: np.ndarray, bucket: int) -> np.ndarray:
    if qidx.size == bucket:
        return qidx
    return np.concatenate([qidx, np.full(bucket - qidx.size, qidx[0])])


def _group_attrs(sp, pid: int, n: int, bucket: int, rows_real: int, rows: int) -> None:
    """A recorded ``group`` span's shape, from host values only: the
    partition, its queries and their padded sub-batch, its rows and their
    padded bucket (the scan's pairs are ``bucket × rows``, of which
    ``queries × rows_real`` are real)."""
    if sp:
        sp.set("pid", int(pid))
        sp.set("queries", int(n))
        sp.set("bucket", int(bucket))
        sp.set("rows_real", int(rows_real))
        sp.set("rows", int(rows))


def _h2d(a: np.ndarray, dev: torch.device) -> Tensor:
    """A small host index array on ``dev``: on the card through pinned
    memory without waiting for the stream (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _operand_arrays(queries) -> dict:
    """The batch's query operands on the host, each in the dtype its
    kernels read (None where the batch has no such field)."""
    lo, hi = queries._bounds()
    fields = {
        "vectors": (queries.vectors, np.float32), "targets": (queries.targets, np.int32),
        "attrs": (queries.attrs, np.int32), "lo": (lo, np.int32), "hi": (hi, np.int32),
        "allowed": (queries.allowed, np.int32), "hard": (queries.hard, np.bool_),
        "mask": (queries.mask, np.int32),
    }
    out = {name: None if a is None else np.ascontiguousarray(a, dtype)
           for name, (a, dtype) in fields.items()}
    # torch.from_numpy needs a writable buffer
    return {name: a if a is None or a.flags.writeable else a.copy() for name, a in out.items()}


class _Operands:
    """The batch's query operands on the device, once; sub-batches index
    rows out of them (``take``)."""

    def __init__(self, queries, dev: torch.device):
        self.fields = {name: None if a is None else torch.from_numpy(a).to(dev)
                       for name, a in _operand_arrays(queries).items()}

    def take(self, rows: Tensor) -> SimpleNamespace:
        return SimpleNamespace(**{
            k: None if v is None else v.index_select(0, rows) for k, v in self.fields.items()
        })


def _ok_local(part, sub) -> Tensor:
    """(b, n_pad) hard admissibility on one partition: the semantics of the
    engine's ``admissible_matrix`` (containment × ONE_OF membership × wildcard),
    plus the pad-row mask."""
    attrs_p = part.attrs[None, :, :]
    okl = (attrs_p >= sub.lo[:, None, :]) & (attrs_p <= sub.hi[:, None, :])
    if sub.allowed is not None:
        member = (attrs_p[..., None] == sub.allowed[:, None, :, :]).any(-1)
        okl = okl & (member | ~sub.hard[:, None, :])
    if sub.mask is not None:
        okl = okl | (sub.mask[:, None, :] == 0)
    return okl.all(-1) & (part.row_ids[None, :] >= 0)


def _select_perm(scores: Tensor, gids: Tensor, k_sel: int):
    """Ascending lexicographic (score, gid) head and the positions it came
    from: the tie order of ``smallest_k`` over the unpartitioned array."""
    perm = lexsort([gids, scores])[:, :k_sel]
    return scores.gather(1, perm), gids.gather(1, perm), perm


def _select(scores: Tensor, gids: Tensor, k_sel: int):
    s, g, _ = _select_perm(scores, gids, k_sel)
    return s, g


def _result_from_pools(
    buf: "_PoolBuffer", k: int, evals, code_evals, hops: int = 0,
) -> SearchResult:
    """Global merge of the accumulated (score, gid) pools → SearchResult
    with the brute oracle's INVALID/INF conventions."""
    dev = buf.scores.device
    sq, gid = _select(buf.scores, buf.gids, k)
    out = torch.where(torch.isfinite(sq) & (sq < INF / 2), gid, INVALID).to(torch.int32)
    sq = sq.masked_fill(out < 0, INF)
    return SearchResult(
        ids=out,
        dists=torch.sqrt(torch.clamp_min(sq, 0.0)),
        sqdists=sq,
        n_dist_evals=to_tensor(evals, torch.int32, dev),
        n_hops=torch.full((), hops, dtype=torch.int32, device=dev),
        n_code_evals=to_tensor(code_evals, torch.int32, dev),
    )


class _PoolBuffer:
    """Per-query candidate pools on the device, scattered from grouped
    per-partition results (widths vary per query with pruning). The fill
    level of each query is host state, so a scatter costs one small
    host-to-device copy of its indices and no sync."""

    def __init__(self, b: int, width: int, dev: torch.device, with_feats: Optional[int] = None):
        self.scores = torch.full((b, width), INF, dtype=torch.float32, device=dev)
        self.gids = torch.full((b, width), -1, dtype=torch.int32, device=dev)
        self.feats = (
            None if with_feats is None
            else torch.zeros((b, width, with_feats), dtype=torch.float32, device=dev)
        )
        self._fill = np.zeros(b, np.int64)

    def scatter(self, idx: Tensor, qidx: np.ndarray, scores, gids, feats=None) -> None:
        """``idx`` holds ``qidx`` then each query's fill level on the
        device (``PartitionedSearcher._indices``)."""
        n, k = qidx.size, scores.shape[1]
        rows = idx[:n, None].expand(n, k)
        cols = idx[n:, None] + torch.arange(k, device=idx.device)[None, :]
        self.scores[rows, cols] = scores
        self.gids[rows, cols] = gids
        if feats is not None:
            self.feats[rows, cols] = feats
        self._fill[qidx] += k


def _scan_group(part, fields: dict, rows: Tensor, k_sel: int):
    """One group of the brute sub-backend: the sub-batch ``rows`` scored
    against ``part`` with the flat brute backend's scorer (pure-L2 fused
    sqdist), masked by the predicates and cut to its ``k_sel`` head."""
    sub = SimpleNamespace(**{
        name: None if v is None else v.index_select(0, rows) for name, v in fields.items()
    })
    sv2 = auto_mod.brute_fused_sqdist(sub.vectors, sub.targets, part.features, part.attrs, _L2)
    scores = sv2.masked_fill(~_ok_local(part, sub), INF)
    return _select(scores, part.row_ids[None, :].expand_as(scores), k_sel)


def _stage_rows(probes: np.ndarray, k: int, n_pad: np.ndarray, slot: np.ndarray) -> tuple:
    """A call's groups as rows of one array, in ascending pid order: (stage,
    pids, queries a group, sub-batch buckets). Row g is [the partition's
    slot | its sub-batch rows | the merge-buffer row of each | its first
    column], each part ``bucket`` wide and the row ``1 + 3·B`` wide. As in
    the eager loop: a sub-batch is the ascending queries probing the
    partition, padded with the first; a query's columns follow its lower
    partitions' ``min(k, rows)``; pad rows go to row B."""
    b, p = probes.shape[0], n_pad.size
    srt = np.sort(np.where(probes < 0, p, probes).astype(np.int64), axis=1)  # pruned last
    valid = srt < p
    ksel = np.where(valid, np.minimum(k, n_pad[np.minimum(srt, p - 1)]), 0)
    col = (np.cumsum(ksel, axis=1) - ksel)[valid]  # a query's lower partitions come first
    pid = srt[valid]
    qid = np.broadcast_to(np.arange(b)[:, None], srt.shape)[valid]
    o = np.argsort(pid * b + qid)  # by partition, then query
    pid, qid, col = pid[o], qid[o], col[o]
    counts = np.bincount(pid, minlength=p)
    pids = np.flatnonzero(counts)
    n = counts[pids]
    start = np.cumsum(n) - n
    bucket = np.minimum(np.left_shift(1, np.ceil(np.log2(n)).astype(np.int64)), b)
    g = np.repeat(np.arange(pids.size), n)
    j = np.arange(pid.size) - start[g]
    stage = np.zeros((pids.size, 1 + 3 * b), np.int64)
    stage[:, 0] = slot[pids]
    pad = bucket - n
    gp = np.repeat(np.arange(pids.size), pad)
    jp = n[gp] + np.arange(gp.size) - np.repeat(np.cumsum(pad) - pad, pad)
    stage[gp, 1 + jp] = qid[start[gp]]
    stage[gp, 1 + bucket[gp] + jp] = b
    stage[g, 1 + j] = qid
    stage[g, 1 + bucket[g] + j] = qid
    stage[g, 1 + 2 * bucket[g] + j] = col
    return stage, pids, n, bucket


def _holds_every_partition(pidx) -> bool:
    """Whether the store's cap holds every partition at once, so that no
    partition is ever evicted (residency ``None``)."""
    need = getattr(pidx, "_bucket_rows", None)
    if need is None:
        need = pidx._bucket_rows = sum(row_bucket(int(n)) for n in pidx.summaries.n_rows)
    return pidx.store.cap_rows >= need


class _ScanGraphs:
    """CUDA graphs of the brute sub-backend's probe and groups, per index.

    Built once every partition is resident: the partitions are stacked by
    row bucket (a copy on the card), and a call's groups are one host
    array ``stage`` (a row a group: its partition's slot in its stack, its
    sub-batch rows, the merge-buffer row of each, its first column) that
    one upload puts on the card. A group's graph reads the stage row a
    device cursor points at and advances the cursor, so a group costs the
    host one replay. A graph is keyed by (operand layout, merge-buffer
    width, sub-batch bucket, row bucket, ``k_sel``); the probe's by
    (operand layout, ``nprobe``, ``hard_all``). The query operands are
    static copies. Pad rows of a sub-batch write to the merge buffer's
    spare last row, which the merge never reads. All graphs share one
    memory pool: only the probe's ids stay alive after a graph ends, and
    the graphs replay one after another on one stream. A graph's first use
    runs its body eagerly (its answer, and its kernels' lazy set-up) and
    captures it after.
    """

    def __init__(self, pidx):
        dev = self.dev = pidx.device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=dev)
        self.graphs: dict = {}
        self.probes: dict = {}  # probe key -> (graph, its ids)
        self.fields: dict = {}  # operand layout -> static query operands
        self.bufs: dict = {}  # (batch, width) -> merge buffer with a spare row
        self.stages: dict = {}  # batch -> static stage
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        p = pidx.n_partitions
        self.n_real = np.asarray(pidx.summaries.n_rows, np.int64)
        self.n_pad = np.zeros(p, np.int64)
        self.slot = np.zeros(p, np.int64)
        by_rows: dict = {}
        for pid in np.flatnonzero(self.n_real > 0):
            part = pidx.store.get(int(pid))
            self.n_pad[pid] = part.n_pad
            by_rows.setdefault(part.n_pad, []).append(part)
            self.slot[pid] = len(by_rows[part.n_pad]) - 1
        self.stacks = {n: SimpleNamespace(
            features=torch.stack([q.features for q in parts]),
            attrs=torch.stack([q.attrs for q in parts]),
            row_ids=torch.stack([q.row_ids for q in parts]),
        ) for n, parts in by_rows.items()}

    @classmethod
    def of(cls, pidx) -> "_ScanGraphs":
        graphs = getattr(pidx, "_scan_graphs", None)
        if graphs is None:
            graphs = pidx._scan_graphs = cls(pidx)
        return graphs

    def operands(self, queries) -> tuple:
        """(layout, the static operands of ``layout`` holding this call's),
        uploaded from pinned memory without waiting for the stream."""
        arrays = _operand_arrays(queries)
        layout = tuple((name, None if a is None else (a.shape, a.dtype.str))
                       for name, a in arrays.items())
        if layout not in self.fields:
            self.fields[layout] = {
                name: None if a is None else torch.empty(a.shape, device=self.dev,
                                                         dtype=torch.from_numpy(a).dtype)
                for name, a in arrays.items()}
        static = self.fields[layout]
        for name, a in arrays.items():
            if a is not None:
                static[name].copy_(torch.from_numpy(a).pin_memory(), non_blocking=True)
        return layout, static

    def upload(self, a: np.ndarray) -> Tensor:
        """``a`` on the card, from pinned memory without waiting."""
        return torch.from_numpy(a).pin_memory().to(self.dev, non_blocking=True)

    def buffer(self, b: int, width: int) -> "_PoolBuffer":
        """The call's merge buffer: every row reset, row ``b`` the spare."""
        if (b, width) not in self.bufs:
            self.bufs[(b, width)] = _PoolBuffer(b + 1, width, self.dev)
        buf = self.bufs[(b, width)]
        buf.scores.fill_(INF)
        buf.gids.fill_(-1)
        return buf

    def _capture(self, fn):
        """``fn`` captured into a graph of the shared pool: (graph, output)."""
        g = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.stream):
            g.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                g.capture_end()
        torch.cuda.current_stream(self.dev).wait_stream(self.stream)
        return g, out

    def probe(self, pidx, layout: tuple, fields: dict, nprobe: int, hard_all: bool) -> np.ndarray:
        """``pidx.probe`` over the static operands, replayed: (B, nprobe) ids."""
        key = (layout, nprobe, hard_all)
        got = self.probes.get(key)
        if got is None:
            ids = pidx.probe_ids(fields, nprobe, hard_all)
            self.probes[key] = self._capture(lambda: pidx.probe_ids(fields, nprobe, hard_all))
            return ids.cpu().numpy()
        got[0].replay()
        return got[1].cpu().numpy()

    def stage(self, probes: np.ndarray, k: int) -> tuple:
        """Upload a call's groups and reset the cursor: (pids, queries a
        group, sub-batch buckets), in ascending pid order."""
        stage, pids, n, bucket = _stage_rows(probes, k, self.n_pad, self.slot)
        b = probes.shape[0]
        if b not in self.stages:
            self.stages[b] = torch.zeros((self.slot.size, stage.shape[1]), dtype=torch.int64,
                                         device=self.dev)
        self.stages[b][:pids.size].copy_(torch.from_numpy(stage).pin_memory(), non_blocking=True)
        self.cursor.zero_()
        return pids, n, bucket

    def run(self, key: tuple, fields: dict, buf: "_PoolBuffer", b: int, bucket: int,
            n_pad: int, k_sel: int) -> None:
        """Score, mask, select and scatter the group at the cursor: replay
        its graph, or run it eagerly and capture it on first use."""
        g = self.graphs.get(key)
        if g is not None:
            g.replay()
            return
        stage, stack = self.stages[b], self.stacks[n_pad]

        def body():
            row = stage.index_select(0, self.cursor)[0]
            slot = row[:1]
            part = SimpleNamespace(features=stack.features.index_select(0, slot)[0],
                                   attrs=stack.attrs.index_select(0, slot)[0],
                                   row_ids=stack.row_ids.index_select(0, slot)[0])
            s, gid = _scan_group(part, fields, row[1:1 + bucket], k_sel)
            cols = row[1 + 2 * bucket:1 + 3 * bucket, None] + torch.arange(
                k_sel, device=self.dev)[None, :]
            tgt = row[1 + bucket:1 + 2 * bucket, None].expand(bucket, k_sel)
            buf.scores[tgt, cols] = s
            buf.gids[tgt, cols] = gid
            self.cursor.add_(1)

        body()
        self.graphs[key] = self._capture(body)[0]


class PartitionedSearcher:
    """IVF probe/merge execution over ``PartitionedStableIndex``."""

    name = "partitioned"

    def search(self, engine, queries, params, plan, entry_ids=None):
        pidx = engine.index
        hard_all = plan.sub_backend == "brute" or params.enforce_equality
        graphed = (plan.sub_backend == "brute" and not is_pq_mode(plan.quant_mode)
                   and self._graphed(pidx))
        if graphed:
            graphs = _ScanGraphs.of(pidx)
            layout, fields = graphs.operands(queries)
        else:
            ops = _Operands(queries, pidx.device)
        with obs_trace.span("probe") as sp:
            if graphed:
                probes = graphs.probe(pidx, layout, fields, plan.nprobe, hard_all)
            else:
                probes = pidx.probe(queries, plan.nprobe, hard_all, ops.fields)  # (B, nprobe)
            if sp:
                # host-side probe attribution: -1 slots are summary-pruned
                sp.set("partitions_scored", int(pidx.n_partitions))
                sp.set("partitions_probed", int((probes >= 0).sum()))
                sp.set("partitions_pruned", int((probes < 0).sum()))
                sp.set("nprobe", int(probes.shape[1]))
        if graphed:
            return self._probe_exact_graphed(pidx, graphs, layout, fields, params.k, probes)
        if plan.sub_backend == "brute":
            if is_pq_mode(plan.quant_mode):
                return self._probe_pq(pidx, queries, params, plan, probes, ops)
            return self._probe_exact(pidx, queries, params, probes, ops)
        return self._probe_graph(pidx, queries, params, plan, probes, ops)

    @staticmethod
    def _indices(buf: _PoolBuffer, qidx: np.ndarray, bucket: int, dev):
        """One host-to-device copy per group: the padded sub-batch rows,
        then ``qidx`` and each query's fill level for the scatter."""
        pad = _pad_idx(qidx, bucket)
        both = _h2d(np.concatenate([pad, qidx, buf._fill[qidx]]).astype(np.int64), dev)
        return both[:bucket], both[bucket:]

    # -- oracle sub-backend (exact scan) ----------------------------------

    def _probe_exact(self, pidx, queries, params, probes, ops):
        dev = pidx.device
        b, k = queries.batch_size, params.k
        buf = _PoolBuffer(b, probes.shape[1] * k, dev)
        for pid, qidx in _iter_groups(pidx.store, _groups(probes)):
            with obs_trace.span("group") as sp:
                part = pidx.store.get(pid)
                bucket = _batch_bucket(qidx.size, b)
                _group_attrs(sp, pid, qidx.size, bucket, part.n_real, part.n_pad)
                rows, idx = self._indices(buf, qidx, bucket, dev)
                s, g = _scan_group(part, ops.fields, rows, min(k, part.n_pad))
                n = qidx.size
                buf.scatter(idx, qidx, s[:n], g[:n])
        with obs_trace.span("merge"):
            return _result_from_pools(buf, k, self._probe_rows(pidx, probes),
                                      np.zeros(b, np.int64))

    @staticmethod
    def _graphed(pidx) -> bool:
        """Graphs need the card and partitions that never move."""
        return pidx.device.type == "cuda" and _holds_every_partition(pidx)

    def _probe_exact_graphed(self, pidx, graphs, layout, fields, k: int, probes):
        """``_probe_exact``'s groups replayed from ``_ScanGraphs``: the
        same scans, masks, selections and scatters, one replay a group."""
        b = probes.shape[0]
        width = probes.shape[1] * k
        buf = graphs.buffer(b, width)
        # the counters go up before the groups, so that the merge waits on nothing
        evals = graphs.upload(self._probe_rows(pidx, probes).astype(np.int32))
        code_evals = torch.zeros(b, dtype=torch.int32, device=graphs.dev)
        pids, ns, buckets = graphs.stage(probes, k)
        for pid, n, bucket in zip(pids.tolist(), ns.tolist(), buckets.tolist()):
            with obs_trace.span("group") as sp:
                n_pad = int(graphs.n_pad[pid])
                _group_attrs(sp, pid, n, bucket, graphs.n_real[pid], n_pad)
                k_sel = min(k, n_pad)
                graphs.run((layout, width, bucket, n_pad, k_sel), fields, buf, b, bucket,
                           n_pad, k_sel)
        with obs_trace.span("merge"):
            pools = SimpleNamespace(scores=buf.scores[:b], gids=buf.gids[:b])
            return _result_from_pools(pools, k, evals, code_evals)

    # -- oracle sub-backend, PQ codes (ADC scan + global exact rerank) ----

    def _probe_pq(self, pidx, queries, params, plan, probes, ops):
        dev = pidx.device
        b, k = queries.batch_size, params.k
        pool = min(params.effective_pool, pidx.n_items)
        pool = min(max(params.rerank_size or pool, k), pool)
        m = pidx.feat_dim
        width = probes.shape[1] * pool
        buf = _PoolBuffer(b, width, dev, with_feats=m)
        qv = ops.fields["vectors"]
        qa = ops.fields["attrs"]
        # one table build for the whole batch: the flat path's tables, bit
        # for bit, whatever the sub-batch a query lands in
        lut_all = pidx.query_lut(qv)
        packed = is_packed_mode(plan.quant_mode)
        for pid, qidx in _iter_groups(pidx.store, _groups(probes)):
            with obs_trace.span("group") as sp:
                part = pidx.store.get(pid)
                bucket = _batch_bucket(qidx.size, b)
                _group_attrs(sp, pid, qidx.size, bucket, part.n_real, part.n_pad)
                rows, idx = self._indices(buf, qidx, bucket, dev)
                sub = ops.take(rows)
                scores = adc_scan(
                    lut_all.index_select(0, rows), part.codes, sub.attrs, part.attrs,
                    mode="l2", packed=packed,
                )
                scores = scores.masked_fill(~_ok_local(part, sub), INF)
                k_sel = min(pool, int(scores.shape[1]))
                s, g, perm = _select_perm(scores, part.row_ids[None, :].expand_as(scores), k_sel)
                n = qidx.size
                buf.scatter(idx, qidx, s[:n], g[:n], part.features[perm[:n]])
        # global merge of raw ADC pools, then ONE exact rerank of the head
        # with the flat path's scorer (gather_auto, l2) over the buffered
        # rows: the same two-stage split and tie order as _adc_two_stage
        with obs_trace.span("merge"):
            code_sq, gid, perm = _select_perm(buf.scores, buf.gids, pool)
            flat_ids = (perm + torch.arange(b, device=dev)[:, None] * width).to(torch.int32)
            rows_v = buf.feats.view(b * width, m)
            rows_a = torch.zeros((b * width, qa.shape[1]), dtype=torch.int32, device=dev)
            rd = gather_auto(qv, qa, rows_v, rows_a, flat_ids.contiguous(), mode="l2")
            rd = rd.masked_fill(code_sq >= INF / 2, INF)
            out_sq, take = smallest_k(rd, k)
            out = gid.gather(1, take)
            out = torch.where(torch.isfinite(out_sq) & (out_sq < INF / 2), out, INVALID)
            out = out.to(torch.int32)
            out_sq = out_sq.masked_fill(out < 0, INF)
            return SearchResult(
                ids=out,
                dists=torch.sqrt(torch.clamp_min(out_sq, 0.0)),
                sqdists=out_sq,
                n_dist_evals=torch.full((b,), pool, dtype=torch.int32, device=dev),
                n_hops=torch.zeros((), dtype=torch.int32, device=dev),
                n_code_evals=to_tensor(self._probe_rows(pidx, probes), torch.int32, dev),
            )

    # -- traversal sub-backend (HELP subgraphs) ---------------------------

    def _probe_graph(self, pidx, queries, params, plan, probes, ops):
        dev = pidx.device
        cfg = plan.routing_cfg
        b, k_exec = queries.batch_size, cfg.k
        buf = _PoolBuffer(b, probes.shape[1] * k_exec, dev)
        evals = np.zeros(b, np.int64)
        code_evals = np.zeros(b, np.int64)
        hops = 0
        quant_on = plan.quant_mode != "none"
        for pid, qidx in _iter_groups(pidx.store, _groups(probes)):
            with obs_trace.span("group") as sp:
                part = pidx.store.get(pid)
                bucket = _batch_bucket(qidx.size, b)
                _group_attrs(sp, pid, qidx.size, bucket, part.n_real, part.n_pad)
                rows, idx = self._indices(buf, qidx, bucket, dev)
                sub = ops.take(rows)
                n = qidx.size
                if part.graph.shape[1] == 0:
                    # scan-only partition (too small for a subgraph): fused
                    # metric scan keeps the merge currency identical
                    sv2 = auto_mod.brute_fused_sqdist(
                        sub.vectors, sub.targets, part.features, part.attrs,
                        pidx.metric_cfg, mask=sub.mask,
                    )
                    ok = part.row_ids[None, :] >= 0
                    if cfg.enforce_equality:
                        ok = ok & _ok_local(part, sub)
                    scores = sv2.masked_fill(~ok, INF)
                    k_sel = min(k_exec, int(scores.shape[1]))
                    s, g = _select(scores, part.row_ids[None, :].expand_as(scores), k_sel)
                    buf.scatter(idx, qidx, s[:n], g[:n])
                    evals[qidx] += part.n_real
                    continue
                eids = self._entry_ids(pidx, pid, part.n_real, bucket, cfg.pool_size, params.seed)
                res = routing_mod.search(
                    part.features, part.attrs, part.graph, sub.vectors, sub.targets,
                    pidx.metric_cfg, cfg, mask=sub.mask, entry_ids=eids, seed=params.seed,
                    quant=pidx.quant_for(part.codes) if quant_on else None,
                )
                gid = torch.where(
                    res.ids >= 0, part.row_ids[res.ids.clamp_min(0).long()], INVALID
                ).to(torch.int32)
                sq = res.sqdists.masked_fill(gid < 0, INF)
                buf.scatter(idx, qidx, sq[:n], gid[:n])
                evals[qidx] += res.n_dist_evals[:n].cpu().numpy()
                code_evals[qidx] += res.n_code_evals[:n].cpu().numpy()
                hops += int(res.n_hops)
        with obs_trace.span("merge"):
            return _result_from_pools(buf, k_exec, evals, code_evals, hops)

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _probe_rows(pidx, probes: np.ndarray) -> np.ndarray:
        """(B,) true rows scanned: Σ n_rows over each query's probe set."""
        rows = np.concatenate([pidx.summaries.n_rows, [0]])  # -1 → 0
        return rows[probes].sum(axis=1).astype(np.int64)

    @staticmethod
    def _entry_ids(pidx, pid, n_real, bucket, pool, seed):
        """Per-partition entry pools, LRU-cached on the index (the values
        depend only on (n_real, bucket, pool, seed), not on residency)."""
        key = (pid, n_real, bucket, pool, seed)
        out, _ = lru_get(
            pidx._entry_cache, key,
            lambda: routing_mod.make_entry_ids(n_real, bucket, pool, seed, device=pidx.device),
            ENTRY_CACHE_SIZE,
        )
        return out
