"""Gradient compression for a data-parallel all-reduce: int8 + error
feedback.

1-byte quantization with a per-leaf scale cuts gradient traffic 4×
(f32 → int8). Error feedback (Seide et al. '14 / EF-SGD) keeps the
quantization residual locally and adds it back at the next step, which
keeps convergence intact.

Usage: wrap grads between the backward and the optimizer:
    comp, state = compress_grads(grads, state)
    grads_hat   = decompress_grads(comp)
Leaves are walked in JAX's order (``core.tree``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import tree as tree_mod

PyTree = Any


class CompressedTree(NamedTuple):
    q: PyTree  # int8 leaves
    scale: PyTree  # 0-d f32 per-leaf scales


def init_error_state(params: PyTree) -> PyTree:
    return tree_mod.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads: PyTree, error_state: PyTree) -> tuple[CompressedTree, PyTree]:
    """Quantize (grads + carried error) to int8 with scale max|·|/127
    (round half to even, clipped to ±127); returns the new error state."""
    qs, scales, errs = [], [], []
    for g, e in zip(tree_mod.leaves(grads), tree_mod.leaves(error_state), strict=True):
        g = g.float() + e
        scale = g.abs().max().clamp_min(1e-12) / 127.0
        q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
        qs.append(q)
        scales.append(scale)
        errs.append(g - q.float() * scale)
    return (CompressedTree(q=tree_mod.unflatten(grads, qs),
                           scale=tree_mod.unflatten(grads, scales)),
            tree_mod.unflatten(grads, errs))


def decompress_grads(comp: CompressedTree) -> PyTree:
    return tree_mod.tree_map(lambda q, s: q.float() * s, comp.q, comp.scale)


def compressed_bytes(comp: CompressedTree) -> int:
    return int(sum(q.numel() for q in tree_mod.leaves(comp.q)))
