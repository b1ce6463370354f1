"""Coarse quantizer: mini-batch k-means over the feature space.

The IVF layer in front of HELP (``repro_torch.partition.index``) routes
queries by nearest coarse centroid, so the quantizer only has to carve the
corpus into P geometrically coherent partitions: mini-batch k-means
(Sculley-style per-center learning rates) gets there in a few dozen
4k-row batches without ever holding more than one mini-batch on the
device, which keeps the build path memmap-friendly.

Assignment is chunked for the same reason: ``assign`` walks the (possibly
memory-mapped) feature array ``chunk_rows`` at a time, so the full (N, P)
distance matrix never materializes.

The numpy draws (initial rows, then one sorted mini-batch an iteration)
are the reference's, call for call, so both packages start from the same
rows and see the same batches. ``torch.argmin`` keeps the first minimum,
as ``jnp.argmin`` does.

Every squared distance here goes through the ``fused_auto`` kernel in l2
mode, the reference's function max(‖x‖² + ‖c‖² − 2x·c, 0): on the card a
cuBLAS product may change a row's bits with the batch size, the kernel
does not, so a query probes the same partitions alone or inside any batch
(the serving layer returns a batched answer equal to the solo one bit for
bit). On the CPU the kernel's plain version is the reference's product.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import resolve_device, to_tensor
from repro_torch.kernels.fused_auto.ops import fused_auto

Tensor = torch.Tensor

__all__ = ["CoarseQuantizer", "assign_partitions", "train_coarse"]


def _sqdist(x: Tensor, c: Tensor) -> Tensor:
    """(B, M) × (P, M) → (B, P) squared L2 through ``fused_auto`` (l2 mode
    reads no attributes: a zero column stands in for them)."""
    qa = torch.zeros((x.shape[0], 1), dtype=torch.int32, device=x.device)
    xa = torch.zeros((c.shape[0], 1), dtype=torch.int32, device=c.device)
    return fused_auto(x.contiguous(), qa, c.contiguous(), xa, mode="l2")


def _minibatch_step(
    centroids: Tensor, counts: Tensor, batch: Tensor
) -> tuple[Tensor, Tensor]:
    """One mini-batch k-means update with per-center 1/count learning rates."""
    a = torch.argmin(_sqdist(batch, centroids), dim=1)  # (B,)
    oh = torch.nn.functional.one_hot(a, centroids.shape[0]).to(torch.float32)  # (B, P)
    cnt_b = oh.sum(0)  # (P,)
    sum_b = oh.T @ batch  # (P, M)
    counts_new = counts + cnt_b
    mean_b = sum_b / torch.clamp_min(cnt_b, 1.0)[:, None]
    lr = (cnt_b / torch.clamp_min(counts_new, 1.0))[:, None]
    centroids_new = centroids + lr * (mean_b - centroids)
    # centers that saw nothing this batch stay put exactly
    centroids_new = torch.where(cnt_b[:, None] > 0, centroids_new, centroids)
    return centroids_new, counts_new


@dataclasses.dataclass
class CoarseQuantizer:
    """Trained coarse centroids: a host copy, and a device copy on
    ``device`` (None → the CUDA card) made on first use."""

    centroids: np.ndarray  # (P, M) f32
    device: Optional[torch.device] = None

    _dev: Optional[Tensor] = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self.centroids = np.asarray(self.centroids, np.float32)
        self.device = resolve_device(self.device)

    @property
    def n_partitions(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def device_centroids(self) -> Tensor:
        if self._dev is None:
            self._dev = to_tensor(self.centroids, torch.float32, self.device)
        return self._dev

    def scores(self, qv) -> Tensor:
        """(B, P) squared centroid distances: the coarse routing signal."""
        return _sqdist(to_tensor(qv, torch.float32, self.device), self.device_centroids)

    def assign(self, features, chunk_rows: int = 200_000) -> np.ndarray:
        """(N,) nearest-centroid partition id, chunked over (memmap) rows."""
        return assign_partitions(features, self.centroids, chunk_rows, device=self.device)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        np.save(os.path.join(path, "coarse_centroids.npy"), self.centroids)

    @classmethod
    def load(cls, path: str, device=None) -> "CoarseQuantizer":
        return cls(np.load(os.path.join(path, "coarse_centroids.npy")), device=device)


def assign_partitions(
    features, centroids: np.ndarray, chunk_rows: int = 200_000, device=None
) -> np.ndarray:
    """Nearest-centroid assignment without materializing (N, P), on
    ``device`` (None → the CUDA card)."""
    dev = resolve_device(device)
    c = to_tensor(centroids, torch.float32, dev)
    n = features.shape[0]
    out = np.empty(n, np.int32)
    for i in range(0, n, chunk_rows):
        x = to_tensor(np.asarray(features[i : i + chunk_rows]), torch.float32, dev)
        out[i : i + x.shape[0]] = (
            torch.argmin(_sqdist(x, c), dim=1).to(torch.int32).cpu().numpy()
        )
    return out


def train_coarse(
    features,
    n_partitions: int,
    n_iters: int = 50,
    batch_size: int = 4096,
    seed: int = 0,
    device=None,
) -> CoarseQuantizer:
    """Mini-batch k-means on ``device`` (None → the CUDA card): init from
    random rows, ``n_iters`` sampled batches.

    ``features`` may be any row-indexable host array (ndarray or
    np.memmap); only one mini-batch is ever resident on the device.
    """
    dev = resolve_device(device)
    n = int(features.shape[0])
    if n_partitions <= 0:
        raise ValueError("n_partitions must be positive")
    if n_partitions > n:
        raise ValueError(f"n_partitions={n_partitions} exceeds corpus n={n}")
    rng = np.random.default_rng(seed)
    init_idx = np.sort(rng.choice(n, size=n_partitions, replace=False))
    centroids = to_tensor(np.asarray(features[init_idx]), torch.float32, dev)
    counts = torch.zeros((n_partitions,), dtype=torch.float32, device=dev)
    b = min(batch_size, n)
    for _ in range(n_iters):
        take = np.sort(rng.choice(n, size=b, replace=False))
        batch = to_tensor(np.asarray(features[take]), torch.float32, dev)
        centroids, counts = _minibatch_step(centroids, counts, batch)
    return CoarseQuantizer(centroids.cpu().numpy(), device=dev)
