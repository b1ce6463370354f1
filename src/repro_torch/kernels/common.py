"""Shared helpers for the kernel wrappers.

One canonical parse of the attribute-target operand: every scorer accepts
(B, L) point targets or (B, L, 2) [lo, hi] interval targets and lowers them
to the two (B, L) bound tiles its kernel consumes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: Padding distance written for INVALID candidates (same value as
#: ``core.graph_ops.INF``; kept here so the kernels depend on nothing above).
INF = 3.0e38

#: Kernel mode codes shared with ``csrc/*.cu``.
MODE_CODES = {"l2": 0, "auto": 1}


def inv_alpha(alpha: float) -> float:
    """f32(1) / f32(α): the reciprocal the penalty multiplies by.

    The reference's source divides (``1 + sa / α``), but its main path runs
    under ``jax.jit`` with α static, and XLA folds that division into a
    multiply by this f32 reciprocal; ``(sv2 · p) · p`` with
    ``p = 1 + sa · inv_alpha`` reproduces its compiled scores bit for bit.
    """
    return float(np.float32(1.0) / np.float32(alpha))


def split_targets(qa: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize (B, L) point / (B, L, 2) interval targets to (qlo, qhi).

    Point targets duplicate into a degenerate lo = hi pair: the interval
    gap max(lo − a, a − hi, 0) is then bit-identical to |a − q|. They come
    back as the same tensor twice, and fused_auto's kernel reads one
    buffer passed as both bounds (``qlo == qhi``) as point targets, whose
    gap it takes in 2 operations instead of 5.
    """
    if qa.ndim == 3:
        if qa.shape[-1] != 2:
            raise ValueError(f"interval targets must be (B, L, 2), got {tuple(qa.shape)}")
        return qa[..., 0], qa[..., 1]
    return qa, qa


#: operand dtypes other than int32, by wrapper argument name.
_DTYPES = {
    "qv": torch.float32, "xv": torch.float32, "db_v": torch.float32, "lut": torch.float32,
    "codes": torch.uint8, "emb": torch.float32,
}


def check_operands(name: str, **tensors: Optional[torch.Tensor]) -> torch.device:
    """Validate a kernel wrapper's operands: one device, contiguous, and
    the dtype the kernel reads (float32 rows, tables and embeddings, uint8
    codes, int32 ids/attributes/masks). Returns the common device."""
    device = None
    for arg, t in tensors.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor")
        want = _DTYPES.get(arg, torch.int32)
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(
                f"{name}: {arg} is on {t.device}, other operands on {device}"
            )
    return device


def mode_code(mode: str) -> int:
    if mode not in MODE_CODES:
        raise ValueError(f"kernel mode must be one of {tuple(MODE_CODES)}, got {mode!r}")
    return MODE_CODES[mode]
