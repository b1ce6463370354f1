"""Product quantization codec: per-subspace K-means codebooks.

The M-dim feature space is split into S subspaces of D_sub = ⌈M/S⌉ dims
(zero-padded to S·D_sub); each subspace gets its own K-centroid codebook by
Lloyd's K-means (K = 256: one byte per subspace; K = 16: one nibble, two
codes per byte, see ``pack_nibbles``). Asymmetric distance computation
(ADC) precomputes per query an (S, K) table of partial squared distances
‖q_s − c_{s,j}‖²; the squared distance to a code is then S lookups and
adds. Padding dims are zero in queries and centroids alike.

Every subspace runs at once here: the reference's per-subspace loops
(``vmap`` over s) become one batched product over a leading S axis. The
numpy draws (sample, then one init per subspace) come in the reference's
order, so both packages train from the same sample and inits. Cluster sums
are a one-hot product, as in the reference, so they are deterministic on
the card (no atomics).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class PQCodebook:
    """Trained per-subspace centroids plus original-dimension metadata."""

    centroids: Tensor  # (S, K, D_sub) f32, zero-padded beyond `dim`
    dim: int  # original feature dimension M (before padding)

    @property
    def n_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def sub_dim(self) -> int:
        return self.centroids.shape[2]


def _split_subspaces(x: Tensor, n_subspaces: int) -> Tensor:
    """(N, M) → (N, S, D_sub) with zero padding up to S · D_sub."""
    n, m = x.shape
    sub = -(-m // n_subspaces)  # ceil
    pad = n_subspaces * sub - m
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(n, n_subspaces, sub)


def _pairwise_sqdist(a: Tensor, b: Tensor) -> Tensor:
    """(..., N, D) × (..., K, D) → (..., N, K) squared distances by the
    ‖a‖² + ‖b‖² − 2a·b decomposition: one definition for train, encode and
    LUT, so the three never drift apart."""
    return (
        (a * a).sum(-1)[..., :, None]
        + (b * b).sum(-1)[..., None, :]
        - 2.0 * (a @ b.transpose(-1, -2))
    )


def _kmeans_one_subspace(x: Tensor, init: Tensor, n_iters: int) -> Tensor:
    """Lloyd iterations, batched over a leading subspace axis:
    x (S, N, D), init (S, K, D) → (S, K, D). Empty clusters keep their
    previous centroid."""
    k = init.shape[-2]
    cents = init
    for _ in range(n_iters):
        assign = torch.argmin(_pairwise_sqdist(x, cents), dim=-1)  # (S, N)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)  # (S, N, K)
        counts = onehot.sum(-2)  # (S, K)
        sums = onehot.transpose(-1, -2) @ x  # (S, K, D)
        new = sums / torch.clamp_min(counts, 1.0)[..., None]
        cents = torch.where((counts > 0.5)[..., None], new, cents)
    return cents


def _sample_and_inits(x: Tensor, n_subspaces: int, n_centroids: int, n_samples: int,
                      seed: int) -> tuple[Tensor, Tensor]:
    """The reference's numpy draws, in its order: the training sample
    (N', S, D) and then one data-point init per subspace (S, K, D)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    take = min(n, n_samples)
    sample_idx = rng.choice(n, size=take, replace=False)
    xs = _split_subspaces(x[torch.from_numpy(sample_idx).to(x.device)], n_subspaces)
    inits = []
    for s in range(n_subspaces):
        # init from data points (with replacement iff the sample is tiny)
        init_idx = rng.choice(take, size=n_centroids, replace=take < n_centroids)
        inits.append(xs[torch.from_numpy(init_idx).to(x.device), s, :])
    return xs, torch.stack(inits)


def pq_train(
    x: Tensor,
    n_subspaces: int = 8,
    n_centroids: int = 256,
    n_iters: int = 15,
    n_samples: int = 16384,
    seed: int = 0,
) -> PQCodebook:
    """Train S independent K-means codebooks over (a sample of) the
    database, on the device that holds ``x``."""
    x = x.to(torch.float32)
    xs, inits = _sample_and_inits(x, n_subspaces, n_centroids, n_samples, seed)
    cents = _kmeans_one_subspace(xs.transpose(0, 1), inits, n_iters)
    return PQCodebook(centroids=cents.contiguous(), dim=x.shape[1])


def pq_encode(x: Tensor, codebook: PQCodebook, block: int = 8192) -> Tensor:
    """Encode (N, M) f32 → (N, S) uint8 codes (values < K ≤ 256), blocked
    over N. ``argmin`` takes the first minimum, as ``jnp.argmin`` does."""
    xs = _split_subspaces(x.to(torch.float32), codebook.n_subspaces)
    out = [
        torch.argmin(_pairwise_sqdist(xs[i:i + block].transpose(0, 1), codebook.centroids),
                     dim=-1).T.to(torch.uint8)
        for i in range(0, xs.shape[0], block)
    ]
    return torch.cat(out, 0).contiguous() if len(out) > 1 else out[0].contiguous()


# ---------------------------------------------------------------------------
# 4-bit packing: two codes (values < 16) per byte
# ---------------------------------------------------------------------------


def pack_nibbles(codes: Tensor) -> Tensor:
    """(..., S) codes (values < 16) → (..., ⌈S/2⌉) uint8.

    Even subspace s = 2i lands in the low nibble, odd s = 2i+1 in the high
    one; odd S pads a zero high nibble, which contributes nothing to an ADC
    sum."""
    codes = codes.to(torch.uint8)
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    return (codes[..., 0::2] | (codes[..., 1::2] << 4)).contiguous()


def unpack_nibbles(packed: Tensor, n_subspaces: int) -> Tensor:
    """(..., ⌈S/2⌉) uint8 → (..., S) int32 codes (inverse of pack_nibbles)."""
    p = packed.to(torch.int32)
    inter = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(*p.shape[:-1], -1)
    return inter[..., :n_subspaces]


def pq_decode(codes: Tensor, codebook: PQCodebook) -> Tensor:
    """Decode (N, S) codes → (N, M) f32 centroid reconstructions."""
    s = torch.arange(codebook.n_subspaces, device=codes.device)
    gathered = codebook.centroids[s[None, :], codes.long()]  # (N, S, D)
    return gathered.reshape(codes.shape[0], -1)[:, : codebook.dim]


def adc_lut(qv: Tensor, codebook: PQCodebook) -> Tensor:
    """Per-query ADC tables: (B, S, K) partial squared distances, ≥ 0."""
    qs = _split_subspaces(qv.to(torch.float32), codebook.n_subspaces)
    lut = _pairwise_sqdist(qs.transpose(0, 1), codebook.centroids).transpose(0, 1)
    return torch.clamp_min(lut, 0.0).contiguous()


def adc_gathered_sqdist(lut: Tensor, codes: Tensor) -> Tensor:
    """ADC squared distances for per-query gathered codes: lut (B, S, K),
    codes (B, C, S) → (B, C) = Σ_s lut[b, s, codes[b, c, s]]. The routing
    inner loop's scorer, where each query expands its own candidates (the
    full-scan counterpart is the ``adc_scan`` kernel)."""
    g = torch.gather(lut, 2, codes.transpose(1, 2).long())  # (B, S, C)
    return g.sum(1)
