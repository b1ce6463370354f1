"""Plain PyTorch versions of the ADC scanners.

Computes the (B, N) squared fused metric over PQ codes
    U² ≈ max(Σ_s LUT[b, s, codes[n, s]], 0) · (1 + S_A/α)²
with S_A the (optionally masked) attribute penalty: |a − q| for (B, L)
point targets, the interval gap max(lo − a, a − hi, 0) for (B, L, 2)
targets. ``mode='l2'`` drops the attribute factor.

The sum runs over s in ascending order, one f32 add per subspace, as the
reference's plain version does and as the CUDA kernels do, so kernel and
plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather_auto.ref import auto_penalize, penalty_sa


def adc_scan_ref(
    lut: torch.Tensor,  # (B, S, K) f32
    codes: torch.Tensor,  # (N, S) integer codes (values < K)
    qa: torch.Tensor,  # (B, L) int32 points or (B, L, 2) intervals
    xa: torch.Tensor,  # (N, L) int32
    alpha: float,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,  # (B, L) int32
) -> torch.Tensor:
    if mode not in ("auto", "l2"):
        raise ValueError(f"adc_scan supports modes ('auto', 'l2'), got {mode!r}")
    lut = lut.to(torch.float32)
    sv2 = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32, device=lut.device)
    for s in range(lut.shape[1]):
        sv2 = sv2 + lut[:, s, :].index_select(1, codes[:, s].long())
    sv2 = torch.clamp_min(sv2, 0.0)
    if mode == "l2":
        return sv2
    sa = penalty_sa(qa, xa[None].expand(lut.shape[0], -1, -1), mask)
    return auto_penalize(sv2, sa, alpha)


def adc_scan4_ref(
    lut: torch.Tensor,  # (B, S, 16) f32
    codes: torch.Tensor,  # (N, ⌈S/2⌉) uint8 packed nibbles
    qa: torch.Tensor,
    xa: torch.Tensor,
    alpha: float,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The packed 4-bit scanner: unpack, then ``adc_scan_ref``."""
    from repro_torch.quant.pq import unpack_nibbles  # quant imports this package

    return adc_scan_ref(lut, unpack_nibbles(codes, lut.shape[1]), qa, xa, alpha, mode, mask)
