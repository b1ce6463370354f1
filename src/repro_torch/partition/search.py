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
    """pid → ascending query indices probing it (-1 slots are pruned)."""
    out: dict[int, np.ndarray] = {}
    for pid in np.unique(probes):
        if pid < 0:
            continue
        out[int(pid)] = np.where((probes == pid).any(axis=1))[0]
    return out


def _pad_idx(qidx: np.ndarray, bucket: int) -> np.ndarray:
    if qidx.size == bucket:
        return qidx
    return np.concatenate([qidx, np.full(bucket - qidx.size, qidx[0])])


def _h2d(a: np.ndarray, dev: torch.device) -> Tensor:
    """A small host index array on ``dev``: on the card through pinned
    memory without waiting for the stream (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class _Operands:
    """The batch's query operands on the device, once; sub-batches index
    rows out of them (``take``)."""

    def __init__(self, queries, dev: torch.device):
        lo, hi = queries._bounds()
        self.fields = {
            "vectors": to_tensor(queries.vectors, torch.float32, dev),
            "targets": to_tensor(queries.targets, torch.int32, dev),
            "attrs": to_tensor(queries.attrs, torch.int32, dev),
            "lo": to_tensor(lo, torch.int32, dev),
            "hi": to_tensor(hi, torch.int32, dev),
            "allowed": (None if queries.allowed is None
                        else to_tensor(queries.allowed, torch.int32, dev)),
            "hard": None if queries.hard is None else to_tensor(queries.hard, torch.bool, dev),
            "mask": None if queries.mask is None else to_tensor(queries.mask, torch.int32, dev),
        }

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
        n_hops=torch.tensor(hops, dtype=torch.int32, device=dev),
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


class PartitionedSearcher:
    """IVF probe/merge execution over ``PartitionedStableIndex``."""

    name = "partitioned"

    def search(self, engine, queries, params, plan, entry_ids=None):
        pidx = engine.index
        hard_all = plan.sub_backend == "brute" or params.enforce_equality
        probes = pidx.probe(queries, plan.nprobe, hard_all)  # (B, nprobe)
        sp = obs_trace.current()  # the executor's "execute" span when sampled
        if sp:
            # host-side probe attribution: -1 slots are summary-pruned
            sp.set("partitions_scored", int(pidx.n_partitions))
            sp.set("partitions_probed", int((probes >= 0).sum()))
            sp.set("partitions_pruned", int((probes < 0).sum()))
            sp.set("nprobe", int(probes.shape[1]))
        ops = _Operands(queries, pidx.device)
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
            part = pidx.store.get(pid)
            rows, idx = self._indices(buf, qidx, _batch_bucket(qidx.size, b), dev)
            sub = ops.take(rows)
            # the flat brute backend's scorer: pure-L2 fused sqdist
            sv2 = auto_mod.brute_fused_sqdist(
                sub.vectors, sub.targets, part.features, part.attrs, _L2
            )
            scores = sv2.masked_fill(~_ok_local(part, sub), INF)
            k_sel = min(k, int(scores.shape[1]))
            s, g = _select(scores, part.row_ids[None, :].expand_as(scores), k_sel)
            n = qidx.size
            buf.scatter(idx, qidx, s[:n], g[:n])
        return _result_from_pools(buf, k, self._probe_rows(pidx, probes), np.zeros(b, np.int64))

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
            part = pidx.store.get(pid)
            rows, idx = self._indices(buf, qidx, _batch_bucket(qidx.size, b), dev)
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
            part = pidx.store.get(pid)
            bucket = _batch_bucket(qidx.size, b)
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
