"""Synthetic hybrid datasets with controlled distribution heterogeneity.

Profiles reproduce the *similarity-magnitude* landscape of the paper's
Table I: the mean feature distance spans three orders of magnitude across
datasets while the attribute distance stays O(1) — the exact mismatch the
AUTO metric must reconcile. Features are drawn from a clustered Gaussian
mixture (so graph ANN is meaningful); attributes are categorical with
configurable per-dimension cardinality (Θ = labels^L) and optional Zipf skew
(non-uniform attribute distributions, paper §III-B3[e]).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: Feature profiles calibrated against paper Table I mean distances.
#:   name: (dim, per-axis noise scale, cluster spread ratio, normalize)
PROFILES = {
    "sift": dict(dim=128, scale=33.5, spread=1.5, normalize=False),  # ~537
    "glove": dict(dim=100, scale=0.54, spread=1.5, normalize=False),  # ~7.7
    "crawl": dict(dim=300, scale=0.32, spread=1.5, normalize=False),  # ~7.8
    "bigann": dict(dim=128, scale=33.0, spread=1.5, normalize=False),  # ~529
    "deep": dict(dim=96, scale=1.0, spread=1.5, normalize=True),  # ~1.36
}


@dataclasses.dataclass
class HybridDataset:
    name: str
    features: np.ndarray  # (N, M) f32
    attrs: np.ndarray  # (N, L) int32, numerically mapped
    query_features: np.ndarray  # (Q, M)
    query_attrs: np.ndarray  # (Q, L)
    labels_per_dim: int
    attr_dim: int

    @property
    def cardinality(self) -> int:  # Θ = labels^L
        return self.labels_per_dim ** self.attr_dim

    @property
    def selectivity(self) -> float:
        """Expected fraction of exact attribute matches ((1/labels)^L)."""
        return float((1.0 / self.labels_per_dim) ** self.attr_dim)


def _sample_attrs(
    rng: np.random.Generator, n: int, attr_dim: int, labels: int, zipf_a: float
) -> np.ndarray:
    if zipf_a <= 0:
        return rng.integers(0, labels, size=(n, attr_dim), dtype=np.int32)
    # Zipf-skewed categorical: p(v) ∝ 1/(v+1)^a
    w = 1.0 / np.arange(1, labels + 1) ** zipf_a
    p = w / w.sum()
    return rng.choice(labels, size=(n, attr_dim), p=p).astype(np.int32)


def make_hybrid_dataset(
    n: int = 20000,
    n_queries: int = 256,
    profile: str = "sift",
    attr_dim: int = 5,
    labels_per_dim: int = 3,
    n_clusters: int = 64,
    zipf_a: float = 0.0,
    attr_cluster_corr: float = 0.0,
    seed: int = 0,
) -> HybridDataset:
    """Clustered features + categorical attributes; queries near the data.

    ``attr_cluster_corr`` ∈ [0,1]: probability an attribute dimension copies
    a cluster-determined value instead of an independent draw (models the
    real-world correlation between visual similarity and product attributes).
    """
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r} (have {list(PROFILES)})")
    p = PROFILES[profile]
    dim, scale, spread, normalize = p["dim"], p["scale"], p["spread"], p["normalize"]
    rng = np.random.default_rng(seed)

    centers = rng.normal(0.0, scale * spread, size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    feats = centers[assign] + rng.normal(0.0, scale, size=(n, dim)).astype(np.float32)
    if normalize:
        feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12

    attrs = _sample_attrs(rng, n, attr_dim, labels_per_dim, zipf_a)
    if attr_cluster_corr > 0.0:
        cluster_attr = rng.integers(
            0, labels_per_dim, size=(n_clusters, attr_dim), dtype=np.int32
        )
        copy = rng.random((n, attr_dim)) < attr_cluster_corr
        attrs = np.where(copy, cluster_attr[assign], attrs)

    # Queries are *generic* mixture samples (like SIFT/GLOVE query sets): a
    # fresh draw from a random cluster, NOT a perturbation of a database
    # point. This matches the paper's regime where the nearest-neighbor
    # distance distribution is the same for matching and non-matching nodes,
    # so the AUTO penalty (Eq. 6's relative margin) cleanly separates them.
    q_assign = rng.integers(0, n_clusters, size=n_queries)
    qf = centers[q_assign] + rng.normal(0.0, scale, size=(n_queries, dim)).astype(
        np.float32
    )
    if normalize:
        qf /= np.linalg.norm(qf, axis=1, keepdims=True) + 1e-12
    qa = _sample_attrs(rng, n_queries, attr_dim, labels_per_dim, zipf_a)
    if attr_cluster_corr > 0.0:
        # Query constraints follow the same feature↔attribute correlation as
        # the data (users filter on attributes consistent with what the query
        # looks like) — keeps matched-neighbor density realistic at small N.
        copy_q = rng.random((n_queries, attr_dim)) < attr_cluster_corr
        qa = np.where(copy_q, cluster_attr[q_assign], qa)

    return HybridDataset(
        name=f"{profile}-{attr_dim}-{labels_per_dim}",
        features=feats.astype(np.float32),
        attrs=attrs,
        query_features=qf.astype(np.float32),
        query_attrs=qa.astype(np.int32),
        labels_per_dim=labels_per_dim,
        attr_dim=attr_dim,
    )
