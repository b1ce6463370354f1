"""Plain PyTorch reference of partitioned (IVF) hybrid search, independent of
the program.

Given the index's coarse centroids and each row's partition (taken from the
built index, as a model's reference takes the same weights), it works out
again, from the raw features, attributes and the reference's compiled
predicates (``reference.Predicates``), which rows a query's probe reaches
and the exact top-k among them. The rules, and where the program states
them:

* a partition's attribute hull is the per-attribute [min, max] over its
  rows; an empty partition has none and never survives
  (``PartitionSummaries``, ``PartitionedStableIndex.build``);
* a partition survives a query when, on every constrained attribute, the
  query's target meets the hull: [lo, hi] ∩ [min, max] ≠ ∅, and for a
  ONE_OF attribute some member label lies in [min, max]. Every constrained
  attribute counts, as for a scan under every predicate
  (``PartitionedStableIndex.survivor_mask`` with ``hard_all``);
* the probe is the ``nprobe`` surviving partitions whose centroids are
  nearest by squared L2, ties to the lower partition id; fewer survivors
  leave the rest of the probe empty (``PartitionedStableIndex.probe``);
* the answer is the exact filtered top-k over the rows of the probed
  partitions: rows that satisfy every predicate (``reference.admissible``),
  ranked by squared L2, ties to the lower row id
  (``PartitionedSearcher._probe_exact``, ``_select`` and
  ``_result_from_pools``: the (score, global id) order).

Distances are float64 unless a lower precision is asked for (the control:
features, centroids and queries rounded to it, sums in float32).
``compare`` holds a program's answers to the reference's. Nothing of the
program is imported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from stable_bench import reference as ref

INVALID = ref.INVALID
#: queries computed in one block
QUERY_BLOCK = 256


class Hulls(NamedTuple):
    """Per-partition row counts and attribute hulls."""

    n_rows: torch.Tensor  # (P,) int64
    lo: torch.Tensor  # (P, L) int64: the least value of each attribute
    hi: torch.Tensor  # (P, L) int64: the largest


class Answer(NamedTuple):
    ids: torch.Tensor  # (Q, k) int64, INVALID-padded
    d2: torch.Tensor  # (Q, k) float64 squared L2, inf-padded
    reached: torch.Tensor  # (Q,) admitted rows in the probed partitions
    probes: torch.Tensor  # (Q, nprobe) int64 partition ids, INVALID where empty


def hulls(attrs: torch.Tensor, assign: torch.Tensor, n_partitions: int) -> Hulls:
    """Row counts and [min, max] of every attribute, per partition (an empty
    partition's hull is left at [0, 0]; it never survives)."""
    a = attrs.to(torch.int64)
    part = assign.to(torch.int64)
    n_rows = torch.bincount(part, minlength=n_partitions)
    idx = part[:, None].expand_as(a)
    big = torch.iinfo(torch.int64).max
    lo = torch.full((n_partitions, a.shape[1]), big, dtype=torch.int64, device=a.device)
    hi = torch.full_like(lo, -big)
    lo = lo.scatter_reduce(0, idx, a, "amin")
    hi = hi.scatter_reduce(0, idx, a, "amax")
    empty = (n_rows == 0)[:, None]
    return Hulls(n_rows, lo.masked_fill(empty, 0), hi.masked_fill(empty, 0))


def survivors(p: ref.Predicates, h: Hulls) -> torch.Tensor:
    """(Q, P) bool: partitions whose hull meets every constrained attribute's
    target (ONE_OF: some member inside the hull)."""
    lo, hi = h.lo[None], h.hi[None]  # (1, P, L)
    meets = (hi >= p.lo[:, None, :]) & (lo <= p.hi[:, None, :])  # (Q, P, L)
    mem = p.allowed[:, None, :, :]  # (Q, 1, L, V)
    member = ((mem >= 0) & (mem >= lo[..., None]) & (mem <= hi[..., None])).any(-1)
    meets = torch.where(p.hard[:, None, :], member, meets)
    ok = (meets | ~p.mask[:, None, :]).all(-1)
    return ok & (h.n_rows > 0)[None, :]


def _sqdist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, M) × (N, M) squared L2, in the tensors' precision."""
    return ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)).clamp_min(0.0)


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    comp = torch.float64 if dtype == torch.float64 else torch.float32
    return x.to(dtype).to(comp)


def probe(qf: torch.Tensor, centroids: torch.Tensor, ok: torch.Tensor, nprobe: int,
          dtype=torch.float64) -> torch.Tensor:
    """(Q, nprobe) the nearest surviving centroids, ties to the lower id;
    INVALID where fewer survive."""
    s = _sqdist(_cast(qf, dtype), _cast(centroids, dtype)).masked_fill(~ok, float("inf"))
    vals, order = torch.sort(s, dim=1, stable=True)
    take = min(nprobe, s.shape[1])
    out = torch.where(torch.isfinite(vals[:, :take]), order[:, :take], INVALID)
    if take < nprobe:
        out = torch.nn.functional.pad(out, (0, nprobe - take), value=INVALID)
    return out


def topk(features: torch.Tensor, attrs: torch.Tensor, qf: torch.Tensor, preds: ref.Predicates,
         centroids: torch.Tensor, assign: torch.Tensor, nprobe: int, k: int,
         dtype=torch.float64) -> Answer:
    """The exact filtered top-k of every query over the rows its probe
    reaches. Queries with the same compiled predicates share one admissible
    set, scored a block of queries at a time."""
    q, dev = qf.shape[0], qf.device
    n_part = centroids.shape[0]
    part = assign.to(device=dev, dtype=torch.int64)
    probes = probe(qf, centroids.to(dev), survivors(preds, hulls(attrs, part, n_part)), nprobe,
                   dtype)
    # (Q, P + 1): the partitions each query probes; an empty slot lands in the last column
    probed = torch.zeros((q, n_part + 1), dtype=torch.bool, device=dev)
    probed.scatter_(1, probes.masked_fill(probes < 0, n_part), True)
    probed[:, n_part] = False
    ids = torch.full((q, k), INVALID, dtype=torch.int64, device=dev)
    d2 = torch.full((q, k), float("inf"), dtype=torch.float64, device=dev)
    reached = torch.zeros((q,), dtype=torch.int64, device=dev)
    key = torch.cat([preds.lo, preds.hi, preds.mask.long(), preds.hard.long(),
                     preds.allowed.flatten(1)], 1)
    _, group = torch.unique(key, dim=0, return_inverse=True)
    order = torch.argsort(group, stable=True)
    start = 0
    for end in torch.cumsum(torch.bincount(group), 0).tolist():
        members = order[start:end]
        start = end
        rows = ref.admissible(attrs, preds.take(members[:1]))[0].nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xv = _cast(features[rows], dtype)
        row_part = part[rows]
        for b in range(0, members.numel(), QUERY_BLOCK):
            mb = members[b: b + QUERY_BLOCK]
            reach = probed[mb][:, row_part]  # (b, rows)
            reached[mb] = reach.sum(1)
            s = _sqdist(_cast(qf[mb], dtype), xv).masked_fill(~reach, float("inf"))
            take = min(k, rows.numel())
            vals, pos = torch.sort(s, dim=1, stable=True)
            vals, pos = vals[:, :take].double(), pos[:, :take]
            found = torch.isfinite(vals)
            ids[mb, :take] = torch.where(found, rows[pos], INVALID)
            d2[mb, :take] = vals
    return Answer(ids, d2, reached, probes)


class Parity(NamedTuple):
    ivf_gap: float  # largest |score of the j-th returned row − the reference's j-th| / (|q|² + |x|²)
    differ: int  # answers whose id set differs from the reference's beyond float ties
    answers: int


def compare(features: torch.Tensor, qf: torch.Tensor, query: torch.Tensor, ids: torch.Tensor,
            want: Answer, tie: float = 1e-5) -> Parity:
    """Hold answers (``ids`` (A, k) of queries ``query`` (A,)) to the
    reference's: each returned row is scored again in float64, the scores
    sorted, and the j-th held to the reference's j-th over
    |q|² + |x_j|², x_j the reference's j-th row (a tie costs nothing, a row
    outside the reference's top-k costs its margin, a row on one side only
    reads 1). An answer differs beyond float ties where its id set is not
    the reference's and its gap exceeds ``tie`` or it holds another number
    of rows."""
    dev = features.device
    n = features.shape[0]
    qi = query.to(device=dev, dtype=torch.int64)
    got_ids = ids.to(device=dev, dtype=torch.int64)
    ref_ids, ref_d2 = want.ids[qi], want.d2[qi]
    valid, ref_valid = got_ids >= 0, ref_ids >= 0
    qv = qf[qi].double()
    qsq = (qv * qv).sum(1)[:, None]
    xv = features[got_ids.clamp(0, n - 1)].double()
    got = ((xv - qv[:, None, :]) ** 2).sum(-1).masked_fill(~valid, float("inf"))
    got = torch.sort(got, 1).values
    rv = features[ref_ids.clamp(0, n - 1)].double()
    scale = qsq + (rv * rv).sum(-1)
    held = torch.isfinite(got)
    gap = ((got - ref_d2).abs() / scale).masked_fill(~(held & ref_valid), 0.0)
    gap = gap.masked_fill(held != ref_valid, 1.0)  # a row on one side only
    per = gap.max(1).values
    counts = valid.sum(1) != ref_valid.sum(1)
    same = (torch.sort(got_ids.masked_fill(~valid, INVALID), 1).values
            == torch.sort(ref_ids, 1).values).all(1)
    differ = ~same & ((per > tie) | counts)
    worst = float(per.max()) if per.numel() else 0.0
    return Parity(worst, int(differ.sum()), int(qi.numel()))
