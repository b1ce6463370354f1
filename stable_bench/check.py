"""The comparison that decides ``correct``, and recall.

Every answer the window produced is held to the reference
(``reference.py``), which works everything out again from the raw data:

``predicates``  entries (query, attribute) where the program's compiled
                batches differ from the reference's compilation:
                constrained or not, [lo, hi] where constrained, ONE_OF or
                not, and the ONE_OF label set. Exact: limit 0.
``malformed``   answers with an id out of range, a repeated id, a valid id
                after an INVALID one, scores that do not ascend, fewer
                valid ids than are due (an exact backend: every admitted row
                up to k; any other: k, unless a predicate is enforced on
                its output), or an id that breaks a predicate the backend
                enforces. Exact: limit 0.
``score_gap``   the largest gap between a returned score and the
                reference's score of that (query, row), over
                (|q|² + |x|²) · (1 + S_A / α)², the scale of float32
                rounding in either form of the distance.
``exact_gap``   (exact backends) the largest gap between the k-th score
                of the returned rows, in the reference's scores, and the
                reference's own k-th score, over (|q|² + |x|²): ties cost
                nothing, a row outside the exact top-k costs its margin.
``short_share`` (backends that enforce every predicate and are not exact: a
                scan of some partitions, a scan of codes, a traversal under
                ``enforce_equality``) the share of answers, of queries that
                admit any row, with fewer valid ids than min(k, rows
                admitted): rows the search did not reach, which
                ``malformed`` cannot count there. Its limit is the cell's,
                from its readings.

What a backend promises follows from the search parameters and the index
(``promises``): the brute backend over full-precision rows enforces every
predicate and is exact; a traversal enforces ONE_OF membership (every
predicate with ``enforce_equality``) and is not exact. A partitioned index
promises what its searcher enforces: its brute sub-backend scans the
probed partitions with every predicate, and is exact over full-precision
rows when it probes every partition; its graph sub-backend is a traversal.
Returned scores are held to AUTO's, which equals L2 on a row that meets
every predicate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stable_bench import reference as ref

#: answers judged in one block
ANSWER_BLOCK = 8192


class Answers(NamedTuple):
    """All answers of a window, in call order (host arrays)."""

    query: np.ndarray  # (A,) query id
    ids: np.ndarray  # (A, k) returned row ids, INVALID-padded
    sq: np.ndarray  # (A, k) returned squared scores


def program_predicates(qb, device) -> ref.Predicates:
    """The program's compiled batch in the reference's form."""
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    attrs = t(qb.attrs)
    if qb.intervals is None:
        lo = hi = attrs
    else:
        lo, hi = t(qb.intervals[..., 0]), t(qb.intervals[..., 1])
    mask = torch.ones_like(attrs, dtype=torch.bool) if qb.mask is None else t(qb.mask) != 0
    if qb.allowed is None:
        hard = torch.zeros_like(mask)
        allowed = torch.full(attrs.shape + (1,), ref.INVALID, dtype=torch.int64, device=device)
    else:
        hard, allowed = t(qb.hard, torch.bool), t(qb.allowed)
    return ref.Predicates(lo, hi, mask, hard, allowed)


def _label_sets(allowed: torch.Tensor, width: int) -> torch.Tensor:
    """Each (query, attribute) label set, sorted and padded to ``width``."""
    pad = width - allowed.shape[-1]
    if pad > 0:
        allowed = torch.nn.functional.pad(allowed, (0, pad), value=ref.INVALID)
    return torch.sort(allowed, -1).values


def predicate_mismatches(batches: list, group_rows: list, preds: ref.Predicates) -> int:
    """Entries (query, attribute) where the program's compilation of each
    group of queries differs from the reference's."""
    bad = 0
    for qb, rows in zip(batches, group_rows):
        want = preds.take(torch.as_tensor(rows, device=preds.lo.device))
        got = program_predicates(qb, want.lo.device)
        width = max(got.allowed.shape[-1], want.allowed.shape[-1])
        m = want.mask
        wrong = (got.mask != m) | (m & ((got.lo != want.lo) | (got.hi != want.hi)))
        wrong |= got.hard != want.hard
        sets = (_label_sets(got.allowed, width) != _label_sets(want.allowed, width)).any(-1)
        wrong |= want.hard & sets
        bad += int(wrong.sum())
    return bad


def promises(params: dict, index: dict) -> dict:
    """``exact`` and ``hard_all`` (every predicate enforced) of a backend over
    the configuration's ``index``. A partitioned plan's sub-backend decides,
    as ``PartitionedSearcher.search`` does: a scan enforces every predicate,
    and is exact at full probe."""
    full = not index.get("quant") or index["quant"].get("mode", "none") == "none"
    scans = params["backend"] == "brute"
    every_row = True
    if params["backend"] == "partitioned":
        scans = params["sub_backend"] == "brute"
        every_row = params["nprobe"] >= index["partition"]["n_partitions"]
    return {"exact": scans and full and every_row,
            "hard_all": scans or bool(params.get("enforce_equality", False))}


def judge(features, attrs, qf, preds: ref.Predicates, alpha: float, exact, answers: Answers,
          promised: dict) -> dict:
    """``malformed`` (with ``malformed_by``, the answers of each kind of
    fault), ``score_gap``, ``exact_gap`` (exact backends), ``short_share``
    (every predicate enforced, not exact) and
    ``recall`` (the mean, over answers whose query admits any row, of the
    share of the exact top-k returned) of every answer. ``exact`` is ``reference.exact_topk``'s."""
    dev = features.device
    n = features.shape[0]
    x_ids, x_d2, x_adm = exact
    enforce_all = promised["hard_all"]
    malformed, score_gap, exact_gap, hits, judged, by = 0, 0.0, 0.0, 0.0, 0, {}
    short, admitting = 0, 0
    counts_short = enforce_all and not promised["exact"]
    for s in range(0, len(answers.query), ANSWER_BLOCK):
        qi = torch.as_tensor(answers.query[s: s + ANSWER_BLOCK], device=dev, dtype=torch.int64)
        ids = torch.as_tensor(answers.ids[s: s + ANSWER_BLOCK], device=dev).to(torch.int64)
        sq = torch.as_tensor(answers.sq[s: s + ANSWER_BLOCK], device=dev).to(torch.float64)
        p = preds.take(qi)
        k = ids.shape[1]
        valid = ids >= 0
        safe = ids.clamp(0, n - 1)
        srt = torch.sort(ids, 1).values
        adm = x_adm[qi]
        if promised["exact"]:
            due = adm.clamp_max(k)
        else:
            # a traversal fills its pool from every row; a filtered one may
            # keep none of it, and a scan of some partitions under every
            # predicate owes only the admitted rows it scanned (recall
            # counts that loss)
            enforced = p.mask if enforce_all else p.hard
            due = torch.where(enforced.any(1), 0, min(k, n))
        # the predicates the backend enforces, on every returned row
        xa = attrs[safe].to(torch.int64)  # (A, k, L)
        inside = (xa >= p.lo[:, None, :]) & (xa <= p.hi[:, None, :])
        member = (xa[..., None] == p.allowed[:, None, :, :]).any(-1)
        if enforce_all:
            ok = ((inside & (member | ~p.hard[:, None, :])) | ~p.mask[:, None, :]).all(-1)
        else:
            ok = (member | ~p.hard[:, None, :]).all(-1)
        faults = {
            "id out of range": ((ids < ref.INVALID) | (ids >= n)).any(1),
            "valid id after INVALID": (valid[:, 1:] & ~valid[:, :-1]).any(1),
            "repeated id": ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1),
            "scores not ascending": (valid[:, 1:] & (sq[:, 1:] < sq[:, :-1])).any(1),
            "fewer ids than due": valid.sum(1) < due,
            "predicate broken": (valid & ~ok).any(1),
        }
        bad = torch.zeros_like(valid[:, 0])
        for why, f in faults.items():
            by[why] = by.get(why, 0) + int(f.sum())
            bad |= f
        malformed += int(bad.sum())
        if counts_short:
            short += int(((valid.sum(1) < adm.clamp_max(k)) & (adm > 0)).sum())
            admitting += int((adm > 0).sum())
        # the returned scores against the reference's
        qv = qf[qi].double()
        xv = features[safe].double()
        sa = ref.attribute_gap(xa, p.lo[:, None, :], p.hi[:, None, :], p.mask[:, None, :])
        want = ref.auto_sqdist(qv[:, None, :], xv, sa, alpha)
        scale = ((qv * qv).sum(1)[:, None] + (xv * xv).sum(-1)) * (1.0 + sa / alpha) ** 2
        gap = ((sq - want).abs() / scale).masked_fill(~valid, 0.0)
        score_gap = max(score_gap, float(gap.max()))
        # the exact top-k: the returned rows' scores in order against the reference's
        xk_ids, xk_d2 = x_ids[qi], x_d2[qi]
        xk_valid = xk_ids >= 0
        if promised["exact"]:
            got = torch.sort(want.masked_fill(~valid, float("inf")), 1).values
            xk_v = features[xk_ids.clamp(0, n - 1)].double()
            xk_scale = (qv * qv).sum(1)[:, None] + (xk_v * xk_v).sum(-1)
            both = xk_valid & torch.isfinite(got)
            eg = ((got - xk_d2).abs() / xk_scale).masked_fill(~both, 0.0)
            exact_gap = max(exact_gap, float(eg.max()))
        hit = ((ids[:, :, None] == xk_ids[:, None, :]) & valid[:, :, None]).any(1) & xk_valid
        due_x = xk_valid.sum(1)
        hits += float((hit.sum(1) / due_x.clamp_min(1)).sum())
        judged += int((due_x > 0).sum())
    out = {"malformed": malformed, "score_gap": score_gap}
    if promised["exact"]:
        out["exact_gap"] = exact_gap
    if counts_short:
        out["short_share"] = short / max(admitting, 1)
    out["recall"] = hits / max(judged, 1)
    out["malformed_by"] = {k: v for k, v in by.items() if v}
    return out
