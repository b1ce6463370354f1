"""Plain PyTorch reference of hybrid search, independent of the program.

It works out again, from the raw features, attributes and predicate
templates that the benchmark made, everything a search answer is judged
by:

* the compiled predicates: per query and attribute, the target bounds
  [lo, hi], whether the attribute is constrained (``mask``) and, for ONE_OF,
  the exact set of admitted labels (``hard``, ``allowed``);
* α of the AUTO metric (paper Eq. 5) from the data;
* the AUTO squared distance U² = S_V² · (1 + S_A / α)² (Eqs. 2–4, 8), with
  S_A the interval gap Σ_l m_l · max(lo_l − a_l, a_l − hi_l, 0);
* the exact filtered top-k: every row that satisfies every predicate,
  ranked by squared L2, ties to the lower row id.

Distances are float64 unless a lower precision is asked for (the control
of the correctness check). The reference imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INVALID = -1
#: queries whose exact top-k is computed in one block
QUERY_BLOCK = 256


class Predicates(NamedTuple):
    """Compiled predicates of Q queries over L attributes (on one device)."""

    lo: torch.Tensor  # (Q, L) int64
    hi: torch.Tensor  # (Q, L) int64
    mask: torch.Tensor  # (Q, L) bool: the attribute is constrained
    hard: torch.Tensor  # (Q, L) bool: a ONE_OF attribute (membership is exact)
    allowed: torch.Tensor  # (Q, L, V) int64, INVALID-padded label sets

    def take(self, idx) -> "Predicates":
        return Predicates(*(t[idx] for t in self))


def compile_predicates(classes: list, qattrs: torch.Tensor, labels: int) -> Predicates:
    """Query i takes class ``i % len(classes)``. A class is
    ``{"name", "default", "attrs": {str(l): template}}``; a template is
    ``"match"`` (the query's own label), ``"any"``, ``["one_of", o, ...]``
    (the labels (a + o) mod labels) or ``["between", lo, hi]``."""
    q, l = qattrs.shape
    a = qattrs.to(torch.int64)
    dev = a.device
    width = max([len(t) - 1 for c in classes for t in c.get("attrs", {}).values()
                 if isinstance(t, list) and t[0] == "one_of"] + [1])
    lo = torch.zeros((q, l), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    mask = torch.zeros((q, l), dtype=torch.bool, device=dev)
    hard = torch.zeros_like(mask)
    allowed = torch.full((q, l, width), INVALID, dtype=torch.int64, device=dev)
    cls_of = torch.arange(q, device=dev) % len(classes)
    for ci, cls in enumerate(classes):
        rows = (cls_of == ci).nonzero()[:, 0]
        for j in range(l):
            t = cls.get("attrs", {}).get(str(j), cls["default"])
            aj = a[rows, j]
            if t == "match":
                lo[rows, j] = hi[rows, j] = aj
                mask[rows, j] = True
            elif t == "any":
                pass
            elif t[0] == "between":
                lo[rows, j], hi[rows, j] = int(t[1]), int(t[2])
                mask[rows, j] = True
            elif t[0] == "one_of":
                vals = torch.stack([(aj + int(o)) % labels for o in t[1:]], 1)
                vals = torch.sort(vals, 1).values
                dup = torch.zeros_like(vals, dtype=torch.bool)
                dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
                lo[rows, j], hi[rows, j] = vals[:, 0], vals[:, -1]
                mask[rows, j] = hard[rows, j] = True
                vals = vals.masked_fill(dup, INVALID)  # a label named twice counts once
                allowed[rows, j, : vals.shape[1]] = torch.sort(vals, 1, descending=True).values
            else:
                raise ValueError(f"unknown predicate template {t!r}")
    return Predicates(lo, hi, mask, hard, allowed)


def norm_to_unit(x: float) -> float:
    """The paper's Norm(·): scale by powers of 10 into (0.1, 1]."""
    if not np.isfinite(x) or x <= 0.0:
        return 0.1
    while x > 1.0:
        x /= 10.0
    while x <= 0.1:
        x *= 10.0
    return float(x)


def alpha(features: torch.Tensor, attrs: torch.Tensor, n_samples: int = 1000,
          seed: int = 0) -> float:
    """Eq. 5, α = Norm(N / S̄_V) + Norm(S̄_A / L), over the pairs of
    ``n_samples`` rows drawn without replacement by numpy's
    ``default_rng(seed).choice``, the paper's calibration sample."""
    n, l = attrs.shape
    idx = np.random.default_rng(seed).choice(n, size=min(n_samples, n), replace=False)
    idx = torch.from_numpy(idx).to(features.device)
    f = features[idx].double()
    a = attrs[idx].double()
    sq = (f * f).sum(1)
    fd = (sq[:, None] + sq[None, :] - 2.0 * (f @ f.T)).clamp_min(0.0).sqrt()
    ad = (a[:, None, :] - a[None, :, :]).abs().sum(-1)
    iu = torch.triu_indices(len(idx), len(idx), 1, device=f.device)
    mean_sv = float(fd[iu[0], iu[1]].mean())
    mean_sa = float(ad[iu[0], iu[1]].mean())
    return norm_to_unit(n / max(mean_sv, 1e-12)) + norm_to_unit(mean_sa / max(l, 1))


def admissible(attrs: torch.Tensor, p: Predicates) -> torch.Tensor:
    """(Q, N) bool: row n satisfies every predicate of query q."""
    xa = attrs.to(torch.int64)[None]  # (1, N, L)
    inside = (xa >= p.lo[:, None, :]) & (xa <= p.hi[:, None, :])
    member = (xa[..., None] == p.allowed[:, None, :, :]).any(-1)
    ok = inside & (member | ~p.hard[:, None, :])
    return (ok | ~p.mask[:, None, :]).all(-1)


def attribute_gap(xa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """S_A of rows ``xa`` (..., L) against [lo, hi] (..., L), float64."""
    x = xa.double()
    gap = torch.maximum(lo.double() - x, x - hi.double()).clamp_min(0.0)
    return (gap * mask.double()).sum(-1)


def auto_sqdist(qv: torch.Tensor, xv: torch.Tensor, sa: torch.Tensor, alpha_: float) -> torch.Tensor:
    """U² = S_V² · (1 + S_A / α)² of matching rows of qv and xv, float64."""
    sv2 = ((xv.double() - qv.double()) ** 2).sum(-1)
    return sv2 * (1.0 + sa / alpha_) ** 2


def exact_topk(features: torch.Tensor, attrs: torch.Tensor, qf: torch.Tensor,
               preds: Predicates, k: int, dtype=torch.float64):
    """Exact filtered top-k of every query: (ids (Q, k) int64, squared L2
    (Q, k) float64, admissible count (Q,)); INVALID / inf where fewer than
    k rows qualify. Queries with the same compiled predicates share one
    admissible set. ``dtype`` below float64 rounds features and queries to
    it and sums in float32."""
    q = qf.shape[0]
    dev = qf.device
    comp = torch.float64 if dtype == torch.float64 else torch.float32
    ids = torch.full((q, k), INVALID, dtype=torch.int64, device=dev)
    d2 = torch.full((q, k), float("inf"), dtype=torch.float64, device=dev)
    n_adm = torch.zeros((q,), dtype=torch.int64, device=dev)
    key = torch.cat([preds.lo, preds.hi, preds.mask.long(), preds.hard.long(),
                     preds.allowed.flatten(1)], 1)
    _, group = torch.unique(key, dim=0, return_inverse=True)
    order = torch.argsort(group, stable=True)
    bounds = torch.cumsum(torch.bincount(group), 0).tolist()
    start = 0
    for end in bounds:
        members = order[start:end]
        start = end
        rows = admissible(attrs, preds.take(members[:1]))[0].nonzero()[:, 0]
        n_adm[members] = rows.numel()
        if rows.numel() == 0:
            continue
        xv = features[rows].to(dtype).to(comp)
        xsq = (xv * xv).sum(1)
        take = min(k, rows.numel())
        for b in range(0, members.numel(), QUERY_BLOCK):
            mb = members[b: b + QUERY_BLOCK]
            qv = qf[mb].to(dtype).to(comp)
            s = ((qv * qv).sum(1)[:, None] + xsq[None, :] - 2.0 * (qv @ xv.T)).clamp_min(0.0)
            vals, pos = torch.sort(s, dim=1, stable=True)
            ids[mb, :take] = rows[pos[:, :take]]
            d2[mb, :take] = vals[:, :take].double()
    return ids, d2, n_adm
