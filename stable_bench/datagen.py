"""The benchmark's hybrid data: features on a low-dimensional latent.

A rewrite of the port's ``make_hybrid_dataset`` for corpora of a million
rows. That generator adds full-rank Gaussian noise in every one of the d
dimensions, so its intrinsic dimension is d, far above that of real
descriptors, and graph search on it loses almost all recall at 1M. Here
the features are drawn from a Gaussian mixture on an r-dimensional latent
(``latent_dim`` in the configuration) and mapped into d dimensions by a
seeded map with orthonormal columns. They are then scaled to the
profile's magnitude (the mean pairwise feature distance of paper Table I)
or, for a unit-norm profile, normalised. Attributes are independent
uniform labels (Θ = labels^L), and queries are fresh mixture draws with
their own uniform attributes, as in the original.

Everything is drawn in torch on ``device``, in a few large calls, from one
generator seeded with the configuration's ``data_seed``: each configuration
is one fixed data set, as SIFT1M or Deep1M is. A run's ``seed`` orders its
rows (a permutation drawn after reseeding the generator with it), so every seed indexes
the same rows in another order and answers the same queries: the same
seed on the same kind of device gives the same tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: rows the magnitude is measured over (the first ones drawn)
SCALE_SAMPLE = 1000


class Data(NamedTuple):
    features: torch.Tensor  # (N, d) f32
    attrs: torch.Tensor  # (N, L) int32
    query_features: torch.Tensor  # (Q, d) f32
    query_attrs: torch.Tensor  # (Q, L) int32


def mean_pairwise_distance(x: torch.Tensor) -> float:
    """Mean Euclidean distance over the distinct pairs of the rows of x,
    computed in float64."""
    x = x.double()
    sq = (x * x).sum(1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    iu = torch.triu_indices(x.shape[0], x.shape[0], 1, device=x.device)
    return float(d2[iu[0], iu[1]].sqrt().mean())


def orthonormal_columns(a: torch.Tensor) -> torch.Tensor:
    """The columns of ``a`` made orthonormal in order (Gram-Schmidt, twice
    over for float32): ``torch.linalg.qr``'s Q up to the signs of its
    columns, in plain operations, so that set-up loads no solver library."""
    cols = []
    for j in range(a.shape[1]):
        v = a[:, j]
        for _ in range(2):
            for u in cols:
                v = v - (u * v).sum() * u
        cols.append(v / v.norm())
    return torch.stack(cols, 1)


def make_data(cfg: dict, seed: int, device) -> Data:
    """A configuration's corpus, in the order ``seed`` gives it, and queries."""
    n, d, r = cfg["n_rows"], cfg["dim"], cfg["latent_dim"]
    q, c = cfg["n_queries"], cfg["n_clusters"]
    prof = cfg["profile"]
    g = torch.Generator(device=device)
    g.manual_seed(int(cfg["data_seed"]))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    basis = orthonormal_columns(torch.randn(d, r, **f32))  # (d, r)
    centers = torch.randn(c, r, **f32) * prof["spread"]
    assign = torch.randint(0, c, (n + q,), device=device, generator=g)
    latent = centers[assign] + torch.randn(n + q, r, **f32)
    feats = latent @ basis.T  # rows of the corpus, then the queries
    del latent
    if prof["normalize"]:
        feats /= feats.norm(dim=1, keepdim=True).clamp_min(1e-12)
    else:
        feats *= prof["mean_feature_dist"] / mean_pairwise_distance(feats[:SCALE_SAMPLE])
    labels, l = cfg["labels_per_dim"], cfg["attr_dim"]
    attrs = torch.randint(0, labels, (n + q, l), device=device, generator=g, dtype=torch.int32)
    g.manual_seed(int(seed))
    order = torch.randperm(n, device=device, generator=g)
    return Data(feats[order], attrs[order], feats[n:].contiguous(), attrs[n:].contiguous())
