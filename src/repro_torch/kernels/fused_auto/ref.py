"""Plain PyTorch version of the brute-force AUTO scorer.

Computes the (B, N) squared fused metric
    U² = max(‖q‖² + ‖x‖² − 2 q·x, 0) · (1 + S_A/α)²
with S_A the (optionally masked) attribute penalty: |a − q| for (B, L)
point targets, the interval gap max(lo − a, a − hi, 0) for (B, L, 2)
[lo, hi] targets. ``mode='l2'`` drops the attribute factor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather_auto.ref import auto_penalize, penalty_sa


def fused_auto_ref(
    qv: torch.Tensor,  # (B, M) f32
    qa: torch.Tensor,  # (B, L) int32 points or (B, L, 2) intervals
    xv: torch.Tensor,  # (N, M) f32
    xa: torch.Tensor,  # (N, L) int32
    alpha: float,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,  # (B, L) int32
) -> torch.Tensor:
    qsq = (qv * qv).sum(-1)[:, None]
    xsq = (xv * xv).sum(-1)[None, :]
    sv2 = torch.clamp_min(qsq + xsq - 2.0 * (qv @ xv.T), 0.0)
    if mode == "l2":
        return sv2
    if mode != "auto":
        raise ValueError(f"fused_auto mode must be 'auto' or 'l2', got {mode!r}")
    sa = penalty_sa(qa, xa[None].expand(qv.shape[0], -1, -1), mask)
    return auto_penalize(sv2, sa, alpha)
