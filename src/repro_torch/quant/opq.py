"""Optimized Product Quantization: a learned orthogonal rotation before PQ.

OPQ (Ge et al., CVPR'13, non-parametric variant) learns an orthogonal R
that minimizes ‖XR − Q(XR)‖² by alternating minimization:

    repeat: rotate X → XR; refine the S codebooks on XR (warm-started
            Lloyd); encode/decode to the reconstruction Y; R ← UVᵀ from
            the SVD of XᵀY (orthogonal Procrustes).

R is orthogonal, so ‖Rx − Ry‖ = ‖x − y‖ and the rotation hides inside the
codec: rows rotate once at encode time, each query once inside the LUT
build. R acts on the zero-padded S·D_sub space that ``_split_subspaces``
makes. ``anisotropic > 0`` weights each training row by
1 + anisotropic · (‖x‖/mean‖x‖ − 1), clamped at 0.1, in the Lloyd steps and
the Procrustes update.
"""
from __future__ import annotations

import torch

from repro_torch.quant.pq import (
    PQCodebook,
    _kmeans_one_subspace,
    _pairwise_sqdist,
    _sample_and_inits,
    pq_decode,
)

Tensor = torch.Tensor

__all__ = ["opq_train", "rotate", "opq_reconstruct"]


def rotate(x: Tensor, rotation: Tensor) -> Tensor:
    """(N, M) × (Mp, Mp) → (N, Mp): zero-pad to the rotated space, multiply."""
    x = x.to(torch.float32)
    pad = rotation.shape[0] - x.shape[1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x @ rotation


def _weighted_kmeans_step(x: Tensor, w: Tensor, cents: Tensor) -> Tensor:
    """One weighted Lloyd step, batched over subspaces: x (S, N, D),
    w (N,), cents (S, K, D) → (S, K, D)."""
    k = cents.shape[-2]
    assign = torch.argmin(_pairwise_sqdist(x, cents), dim=-1)
    onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32) * w[:, None]
    counts = onehot.sum(-2)
    new = (onehot.transpose(-1, -2) @ x) / torch.clamp_min(counts, 1e-6)[..., None]
    return torch.where((counts > 1e-6)[..., None], new, cents)


def _encode_decode(xs: Tensor, centroids: Tensor) -> Tensor:
    """xs (N, S, D), centroids (S, K, D) → (N, S, D) nearest-centroid recon."""
    assign = torch.argmin(_pairwise_sqdist(xs.transpose(0, 1), centroids), dim=-1)  # (S, N)
    s = torch.arange(centroids.shape[0], device=xs.device)[:, None]
    return centroids[s, assign].transpose(0, 1)


def opq_train(
    x: Tensor,
    n_subspaces: int = 8,
    n_centroids: int = 256,
    n_iters: int = 15,
    opq_iters: int = 6,
    n_samples: int = 16384,
    seed: int = 0,
    anisotropic: float = 0.0,
) -> tuple[Tensor, PQCodebook]:
    """Alternating-minimization OPQ → (rotation (Mp, Mp), codebook).

    The codebook lives in the rotated padded space (``dim == Mp``): encode
    with ``pq_encode(rotate(x, R), codebook)``, build query LUTs from
    ``rotate(q, R)``. Round 0 runs ``n_iters`` Lloyd iterations from data
    inits; later rounds warm-start with two weighted steps each.
    """
    x = x.to(torch.float32)
    xs3, inits = _sample_and_inits(x, n_subspaces, n_centroids, n_samples, seed)
    take, _, sub = xs3.shape
    mp = n_subspaces * sub
    xflat = xs3.reshape(take, mp)

    if anisotropic > 0.0:
        norms = torch.linalg.vector_norm(xflat, dim=1)
        w = 1.0 + anisotropic * (norms / torch.clamp_min(norms.mean(), 1e-6) - 1.0)
        w = torch.clamp_min(w, 0.1)
    else:
        w = torch.ones((take,), dtype=torch.float32, device=x.device)

    rotation = torch.eye(mp, dtype=torch.float32, device=x.device)
    centroids = _kmeans_one_subspace(xs3.transpose(0, 1), inits, n_iters)

    def refine(cents: Tensor) -> Tensor:
        xr = (xflat @ rotation).reshape(take, n_subspaces, sub).transpose(0, 1)
        for _ in range(2):
            cents = _weighted_kmeans_step(xr, w, cents)
        return cents

    for _ in range(max(opq_iters, 0)):
        centroids = refine(centroids)
        xr = (xflat @ rotation).reshape(take, n_subspaces, sub)
        y = _encode_decode(xr, centroids).reshape(take, mp)
        # weighted orthogonal Procrustes: R ← UVᵀ of Xᵀ diag(w) Y
        u, _, vh = torch.linalg.svd(xflat.T @ (y * w[:, None]), full_matrices=False)
        rotation = u @ vh

    centroids = refine(centroids)  # final refit against the final rotation
    return rotation, PQCodebook(centroids=centroids.contiguous(), dim=mp)


def opq_reconstruct(codes: Tensor, codebook: PQCodebook, rotation: Tensor,
                    dim: int) -> Tensor:
    """Decode codes from the rotated space back to the original M dims."""
    return (pq_decode(codes, codebook) @ rotation.T)[:, :dim]
