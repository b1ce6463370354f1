"""Plain PyTorch version of the gathered-candidate AUTO scorer."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import INF, inv_alpha, split_targets


def penalty_sa(
    qa: torch.Tensor, ca: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Σ_l mask_l · max(lo_l − a_l, a_l − hi_l, 0) of per-query targets
    ``qa`` (B, L[, 2]) against candidate attributes ``ca`` (B, C, L)."""
    lo, hi = split_targets(qa)
    caf = ca.to(torch.float32)
    lo = lo.to(torch.float32)[:, None, :]
    hi = hi.to(torch.float32)[:, None, :]
    diff = torch.clamp_min(torch.maximum(lo - caf, caf - hi), 0.0)
    if mask is not None:
        diff = diff * mask.to(torch.float32)[:, None, :]
    return diff.sum(-1)


def auto_penalize(sv2: torch.Tensor, sa: torch.Tensor, alpha: float) -> torch.Tensor:
    """(sv2 · p) · p with p = 1 + sa · f32(1/α), as the kernels and the
    reference's compiled main path compute it (see ``common.inv_alpha``)."""
    r = torch.tensor(inv_alpha(alpha), dtype=torch.float32, device=sa.device)
    pen = 1.0 + sa * r
    return sv2 * pen * pen


def gather_auto_ref(
    qv: torch.Tensor,  # (B, M) f32
    qa: torch.Tensor,  # (B, L) points or (B, L, 2) [lo, hi] intervals, int32
    db_v: torch.Tensor,  # (N, M) f32 row table
    db_a: torch.Tensor,  # (N, L) int32
    cand_ids: torch.Tensor,  # (B, C) int32, INVALID (< 0) allowed
    alpha: float,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,  # (B, L) int32
) -> torch.Tensor:
    """(B, C) squared fused distances of each query to its own candidate
    rows; INF where ``cand_ids < 0``."""
    safe = cand_ids.clamp_min(0).long()
    d = db_v[safe] - qv[:, None, :]
    sv2 = torch.clamp_min((d * d).sum(-1), 0.0)
    if mode == "auto":
        sv2 = auto_penalize(sv2, penalty_sa(qa, db_a[safe], mask), alpha)
    elif mode != "l2":
        raise ValueError(f"gather_auto mode must be 'auto' or 'l2', got {mode!r}")
    return torch.where(cand_ids < 0, torch.full_like(sv2, INF), sv2)
