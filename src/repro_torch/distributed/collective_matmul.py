"""Ring matmuls over the ``model`` axis of a ``LocalMesh``: the full
product Σ_s x_s @ w_s of a contraction split over the shards, and its
reduce-scatter form.

The reference decomposes ``psum(x_local @ w_local)`` into ``size − 1``
``ppermute`` hops, each followed by an add, inside ``shard_map``, so that
XLA can overlap the hops with other work. The port runs the same schedule
in one process: the inputs are lists of per-shard tensors, one per model
shard on ``mesh.device(s)``, and a hop moves each running sum to the next
shard's device (a no-op where both shards sit on one card). The adds run
in the reference's order (shard ``i`` receives from ``i − 1``; the
reduce-scatter seeds chunk ``i − 1``), so each result equals the plain sum
of the same partials in that order, bit for bit. The local products are
plain ``torch.matmul``: the reference's are plain products outside any
Pallas kernel.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _ring(mesh, x_shards: list, w_shards: list) -> tuple[int, list]:
    size = mesh.shape["model"]
    if len(x_shards) != size or len(w_shards) != size:
        raise ValueError(f"{len(x_shards)} x and {len(w_shards)} w shards for {size} model shards")
    return size, [torch.matmul(x, w) for x, w in zip(x_shards, w_shards)]


def ring_allreduce_matmul(mesh, x_shards: list, w_shards: list) -> list:
    """Each shard's (B, N) Σ_s x_s @ w_s: x_s (B, K_s) is shard s's slice of
    the contraction, w_s (K_s, N) the matching weight rows. Shard ``i``
    ends with ((p_{i+1} + p_{i+2}) + …) + p_i of the partials p."""
    size, partials = _ring(mesh, x_shards, w_shards)
    acc = partials
    for _ in range(size - 1):
        acc = [acc[(i - 1) % size].to(mesh.device(i)) + partials[i] for i in range(size)]
    return acc


def ring_reduce_scatter_matmul(mesh, x_shards: list, w_shards: list) -> list:
    """Shard ``i``'s (B/size, N) rows [i·B/size, (i+1)·B/size) of
    Σ_s x_s @ w_s, the down-projection of sequence-parallel tensor
    parallelism: shard ``i`` seeds its partial of chunk ``i − 1``; each hop
    passes the running sum on and adds the local partial of the chunk now
    in hand."""
    size, partials = _ring(mesh, x_shards, w_shards)
    b = partials[0].shape[0]
    if b % size:
        raise ValueError(f"{b} rows do not divide over {size} shards")
    chunk = b // size

    def block(i: int, j: int) -> Tensor:
        j %= size
        return partials[i][j * chunk:(j + 1) * chunk]

    acc = [block(i, i - 1) for i in range(size)]
    for step in range(1, size):
        acc = [acc[(i - 1) % size].to(mesh.device(i)) + block(i, i - 1 - step)
               for i in range(size)]
    return acc
