"""Scalar quantization codec: int8 per-dimension affine (SQ8).

Each feature dimension m gets an affine map x ≈ zero[m] + scale[m] · (q + 128)
with q ∈ [-128, 127] stored as int8, 4× smaller than f32. The range is the
per-dimension [min, max], so skewed dimensions keep full resolution.

Traversal decodes gathered codes and reuses the exact fused-AUTO math; the
saving is the bytes read, not the arithmetic. ``torch.round`` rounds half
to even like ``jnp.round``, so the codes equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class SQParams(NamedTuple):
    """Per-dimension affine dequantization parameters."""

    scale: Tensor  # (M,) f32, step size per dimension
    zero: Tensor  # (M,) f32, value of code -128 per dimension


def sq8_train(x: Tensor) -> SQParams:
    """Fit per-dimension [min, max] affine ranges over the database."""
    x = x.to(torch.float32)
    lo = x.min(0).values
    hi = x.max(0).values
    scale = torch.clamp_min(hi - lo, 1e-12) / 255.0
    return SQParams(scale=scale, zero=lo)


def sq8_encode(x: Tensor, params: Optional[SQParams] = None) -> tuple[Tensor, SQParams]:
    """Encode (N, M) f32 → (N, M) int8 codes. Trains params when not given."""
    x = x.to(torch.float32)
    if params is None:
        params = sq8_train(x)
    q = torch.round((x - params.zero[None, :]) / params.scale[None, :]) - 128.0
    return torch.clamp(q, -128.0, 127.0).to(torch.int8), params


def sq8_decode(codes: Tensor, params: SQParams) -> Tensor:
    """Decode (..., M) int8 codes back to f32 (params broadcast over leads)."""
    q = codes.to(torch.float32) + 128.0
    return params.zero + q * params.scale
