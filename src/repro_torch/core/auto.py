"""AUTO metric: enhanced heterogeneous semantic perception (paper §III-B).

  Eq. 2  S_A(A_i, Â)   = Σ_l |a_l - â_l|                (Manhattan, integer-mapped)
  Eq. 3  S_V(V_i, V̂)   = sqrt(Σ_m (v_m - v̂_m)²)          (Euclidean)
  Eq. 4  U(D_i, Q)     = S_V · (1 + S_A / α)
  Eq. 5  α             = Norm(N / S̄_V) + Norm(S̄_A / L)
  Eq. 8  masked S_A    = Σ_l m_l · |a_l - â_l|            (subset / missing-value)

Hot paths rank by the squared fused metric U² = S_V² · (1 + S_A/α)², which
orders identically and lets S_V² come from ‖q‖² + ‖x‖² − 2 q·x. Query
targets are points ``(…, L)`` or per-dimension [lo, hi] intervals
``(…, L, 2)``; the interval gap max(lo − a, a − hi, 0) reduces bit-exactly
to |a − q| when lo = hi = q.

The calibration (``sample_stats``, ``compute_alpha``) is numpy, copied from
the reference so α is bit-equal. ``brute_fused_sqdist`` runs the
``fused_auto`` kernel for the ``auto``/``l2`` modes and applies the other
three modes to the kernel's ``l2`` output.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph_ops import smallest_k
from repro_torch.kernels.fused_auto.ops import fused_auto
from repro_torch.kernels.gather_auto.ref import auto_penalize

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Numerical mapping (paper Eq. 1)
# ---------------------------------------------------------------------------


def numerical_map(raw_attrs: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]]:
    """Map raw (possibly categorical) attribute columns to position ids.

    Returns the int32 mapped matrix and the per-dimension value tables
    (``MAP(a_u) = u``: position in the sorted distinct-value set).
    """
    raw_attrs = np.asarray(raw_attrs)
    n, l = raw_attrs.shape
    mapped = np.empty((n, l), dtype=np.int32)
    tables = []
    for j in range(l):
        values, inverse = np.unique(raw_attrs[:, j], return_inverse=True)
        mapped[:, j] = inverse.astype(np.int32)
        tables.append(values)
    return mapped, tables


def map_query_attrs(raw_query: np.ndarray, tables: list[np.ndarray]) -> np.ndarray:
    """Map query attribute values through the dataset's value tables."""
    raw_query = np.asarray(raw_query)
    out = np.empty_like(raw_query, dtype=np.int32)
    for j, table in enumerate(tables):
        idx = np.searchsorted(table, raw_query[..., j])
        out[..., j] = np.clip(idx, 0, len(table) - 1)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Basic measurements (Eq. 2, Eq. 3, Eq. 8)
# ---------------------------------------------------------------------------


def is_interval_targets(targets: Tensor, attrs: Tensor) -> bool:
    """True iff ``targets`` carries the extra trailing [lo, hi] axis
    relative to the database attribute array it scores against."""
    if targets.ndim != attrs.ndim + 1:
        return False
    if targets.shape[-1] != 2:
        raise ValueError(
            "attribute targets one rank above the attrs must be [lo, hi] "
            f"intervals with a trailing axis of 2, got shape "
            f"{tuple(targets.shape)} against attrs {tuple(attrs.shape)}; point "
            "targets must match the attrs rank"
        )
    return True


def interval_bounds(targets: Tensor) -> tuple[Tensor, Tensor]:
    """Split ``(…, L, 2)`` interval targets into f32 (lo, hi) views."""
    return targets[..., 0].to(torch.float32), targets[..., 1].to(torch.float32)


def attribute_distance(a: Tensor, b: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Manhattan attribute consistency S_A (Eq. 2); masked variant (Eq. 8).
    ``a`` holds point targets or [lo, hi] intervals; ``b`` the integer-mapped
    database attributes; ``mask`` 0 marks a wildcard dimension."""
    bf = b.to(torch.float32)
    if is_interval_targets(a, b):
        lo, hi = interval_bounds(a)
        diff = torch.clamp_min(torch.maximum(lo - bf, bf - hi), 0.0)
    else:
        diff = torch.abs(a.to(torch.float32) - bf)
    if mask is not None:
        diff = diff * mask.to(torch.float32)
    return diff.sum(-1)


def attribute_violation(a: Tensor, b: Tensor) -> Tensor:
    """Bool per-dimension mismatch: point targets ⇒ inequality; interval
    targets ⇒ outside [lo, hi]."""
    if is_interval_targets(a, b):
        lo, hi = interval_bounds(a)
        bf = b.to(torch.float32)
        return (bf < lo) | (bf > hi)
    return a != b


def feature_distance(x: Tensor, y: Tensor) -> Tensor:
    """Euclidean feature similarity S_V (Eq. 3)."""
    return torch.sqrt(feature_sqdist(x, y))


def feature_sqdist(x: Tensor, y: Tensor) -> Tensor:
    d = x.to(torch.float32) - y.to(torch.float32)
    return torch.clamp_min((d * d).sum(-1), 0.0)


# ---------------------------------------------------------------------------
# α calibration (Eq. 5): numpy, a copy of the reference's
# ---------------------------------------------------------------------------


def norm_to_unit(x: float) -> float:
    """Paper's Norm(·): scale by powers of 10 into (0.1, 1]."""
    if not np.isfinite(x) or x <= 0.0:
        return 0.1
    while x > 1.0:
        x /= 10.0
    while x <= 0.1:
        x *= 10.0
    return float(x)


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    """Sampled statistics feeding Eq. 5."""

    n_total: int
    feat_dim: int
    attr_dim: int
    mean_feature_dist: float
    mean_attribute_dist: float
    min_feature_dist: float
    max_feature_dist: float
    min_attribute_dist: float
    max_attribute_dist: float

    @property
    def alpha(self) -> float:
        return compute_alpha(
            self.n_total, self.mean_feature_dist, self.mean_attribute_dist, self.attr_dim
        )


def compute_alpha(n_total: int, mean_sv: float, mean_sa: float, attr_dim: int) -> float:
    """Eq. 5: α = Norm(N / S̄_V) + Norm(S̄_A / L)."""
    return norm_to_unit(n_total / max(mean_sv, 1e-12)) + norm_to_unit(
        mean_sa / max(attr_dim, 1)
    )


def sample_stats(
    features: np.ndarray,
    attrs: np.ndarray,
    n_samples: int = 1000,
    seed: int = 0,
) -> DatasetStats:
    """Sample ≤``n_samples`` nodes, compute pairwise distance statistics
    (the paper's calibration pass, §III-B2, 1,000 sampled nodes)."""
    features = np.asarray(features, dtype=np.float32)
    attrs = np.asarray(attrs)
    n = features.shape[0]
    rng = np.random.default_rng(seed)
    take = min(n_samples, n)
    idx = rng.choice(n, size=take, replace=False)
    f = features[idx]
    a = attrs[idx].astype(np.float32)

    sq = (f * f).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (f @ f.T)
    np.maximum(d2, 0.0, out=d2)
    fd = np.sqrt(d2)
    ad = np.abs(a[:, None, :] - a[None, :, :]).sum(-1)
    iu = np.triu_indices(take, k=1)
    fd, ad = fd[iu], ad[iu]

    return DatasetStats(
        n_total=n,
        feat_dim=features.shape[1],
        attr_dim=attrs.shape[1],
        mean_feature_dist=float(fd.mean()),
        mean_attribute_dist=float(ad.mean()),
        min_feature_dist=float(fd.min()),
        max_feature_dist=float(fd.max()),
        min_attribute_dist=float(ad.min()),
        max_attribute_dist=float(ad.max()),
    )


# ---------------------------------------------------------------------------
# Fused metric (Eq. 4)
# ---------------------------------------------------------------------------

#:   auto      paper Eq. 4 (multiplicative fusion)
#:   l2        pure feature distance
#:   attr      attribute distance only ("w/o FeatureDis" ablation)
#:   additive  S_V + S_A ("w/o AUTO" ablation)
#:   nhq       S_V + w · Hamming(A, Â) (NHQ-style static fusion baseline)
METRIC_MODES = ("auto", "l2", "attr", "additive", "nhq")


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    mode: str = "auto"
    alpha: float = 1.0
    nhq_weight: float = 1.0

    def __post_init__(self):
        if self.mode not in METRIC_MODES:
            raise ValueError(f"unknown metric mode {self.mode!r}")


def auto_distance(
    qv: Tensor, qa: Tensor, xv: Tensor, xa: Tensor, alpha: float,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Paper-exact U(D, Q) (Eq. 4), broadcasting over leading dims."""
    sv = feature_distance(qv, xv)
    sa = attribute_distance(qa, xa, mask)
    return sv * (1.0 + sa / alpha)


def fused_sqdist_from_sv2(
    sv2: Tensor,
    qa: Tensor,
    xa: Tensor,
    cfg: MetricConfig,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Apply the mode's attribute fusion to a precomputed squared feature
    term. ``qa`` may be point targets or [lo, hi] interval targets."""
    if cfg.mode == "l2":
        return sv2
    sa = attribute_distance(qa, xa, mask)
    if cfg.mode == "attr":
        return sa * sa + 1e-6 * sv2  # feature term only tie-breaks
    if cfg.mode == "auto":
        return auto_penalize(sv2, sa, cfg.alpha)
    if cfg.mode == "additive":
        u = torch.sqrt(sv2) + sa
        return u * u
    # nhq: static-weight fusion over Hamming distance (interval form: a
    # dimension counts iff the value falls outside [lo, hi])
    ham = attribute_violation(qa, xa)
    if mask is not None:
        ham = ham & mask.to(torch.bool)
    ham = ham.to(torch.float32).sum(-1)
    u = torch.sqrt(sv2) + cfg.nhq_weight * ham
    return u * u


def fused_sqdist(
    qv: Tensor, qa: Tensor, xv: Tensor, xa: Tensor, cfg: MetricConfig,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Squared fused metric for ranking, pointwise/broadcast form."""
    return fused_sqdist_from_sv2(feature_sqdist(qv, xv), qa, xa, cfg, mask)


def brute_fused_sqdist(
    qv: Tensor,
    qa: Tensor,
    db_v: Tensor,
    db_a: Tensor,
    cfg: MetricConfig,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """(B, N) squared fused distances of every query to every row, through
    the ``fused_auto`` kernel. ``qa`` is (B, L) points or (B, L, 2)
    intervals."""
    if cfg.mode in ("auto", "l2"):
        return fused_auto(qv, qa, db_v, db_a, alpha=cfg.alpha, mode=cfg.mode, mask=mask)
    sv2 = fused_auto(qv, qa, db_v, db_a, mode="l2")
    return fused_sqdist_from_sv2(
        sv2, qa[:, None], db_a[None], cfg, None if mask is None else mask[:, None, :]
    )


def brute_topk(
    qv: Tensor,
    qa: Tensor,
    db_v: Tensor,
    db_a: Tensor,
    k: int,
    cfg: MetricConfig,
    mask: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Exact top-k under the fused metric: (sq-dists, ids), ascending; ties
    go to the lower id."""
    return smallest_k(brute_fused_sqdist(qv, qa, db_v, db_a, cfg, mask), k)
