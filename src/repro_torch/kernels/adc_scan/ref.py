"""Plain PyTorch versions of the ADC scanners.

Computes the (B, N) squared fused metric over PQ codes
    U² ≈ max(Σ_s LUT[b, s, codes[n, s]], 0) · (1 + S_A/α)²
with S_A the (optionally masked) attribute penalty: |a − q| for (B, L)
point targets, the interval gap max(lo − a, a − hi, 0) for (B, L, 2)
targets. ``mode='l2'`` drops the attribute factor.

The sum order defines the bits, and the CUDA kernels (``csrc/adc_scan.cu``)
use the same one, so kernel and plain version agree bit for bit: for each
residue class r = s mod 32, sum the class's entries in ascending s from
+0.0 (a class that holds no subspace is +0.0), then reduce the 32 class
sums by a halving tree, c[i] + c[i + h] for i < h, h = 16, 8, 4, 2, 1.
Every step is one f32 add. The reference sums in another order (its Pallas
body is a one-hot product, its plain version a gather-sum), so across the
packages the scores agree exactly on integer tables and within float
rounding otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather_auto.ref import auto_penalize, penalty_sa

#: residue classes of the subspaces (s mod CLASSES): one shared-memory bank
#: each in the kernel
CLASSES = 32
#: floats of gathered table entries held at once, (B, 32, rows): 256 MB
CHUNK_ELEMENTS = 1 << 26


def class_tree_sum(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, N) Σ_s lut[b, s, codes[n, s]] in the scanners' order: class sums
    over s ≡ r (mod 32) in ascending s from +0.0, then the halving tree.
    Rows go in chunks of at most ``CHUNK_ELEMENTS`` gathered entries."""
    b, s, _ = lut.shape
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    rows = max(1, CHUNK_ELEMENTS // (b * CLASSES))
    idx = codes.long()
    for r0 in range(0, n, rows):
        part = idx[r0:r0 + rows]
        c = torch.zeros((b, CLASSES, part.shape[0]), dtype=torch.float32, device=lut.device)
        for s0 in range(0, s, CLASSES):
            w = min(CLASSES, s - s0)
            # (B, w, rows): lut[b, s0 + i, codes[n, s0 + i]]
            e = torch.gather(lut[:, s0:s0 + w], 2, part[:, s0:s0 + w].T[None].expand(b, -1, -1))
            c[:, :w] = c[:, :w] + e
        h = CLASSES // 2
        while h >= 1:
            c = c[:, :h] + c[:, h:2 * h]
            h //= 2
        out[:, r0:r0 + rows] = c[:, 0]
    return out


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
    sv2 = torch.clamp_min(class_tree_sum(lut.to(torch.float32), codes), 0.0)
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
