"""Dispatch for the ADC scanners over PQ codes.

CPU tensors run the plain versions (``ref.py``); CUDA tensors launch the
hand-written kernels (``kernels/csrc/adc_scan.cu``) or raise.
``adc_scan_scores`` scans 8-bit codes (N, S); ``adc_scan4_scores`` scans
4-bit codes packed two per byte (N, ⌈S/2⌉) against K = 16 tables. Each
counts its own kernel launches in ``.launches``. ``adc_scan(...,
packed=...)`` picks one, as the reference's wrapper does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph_ops import smallest_k
from repro_torch.kernels import build
from repro_torch.kernels.adc_scan.ref import adc_scan4_ref, adc_scan_ref
from repro_torch.kernels.common import check_operands, inv_alpha, mode_code, split_targets


def _scan(wrapper, name: str, plain, lut, codes, qa, xa, alpha, mode, mask) -> torch.Tensor:
    """Check the operands, then run ``plain`` on the CPU or launch ``name``
    on the card, counting the launch on ``wrapper``."""
    device = check_operands(name, lut=lut, codes=codes, qa=qa, xa=xa, mask=mask)
    code = mode_code(mode)
    b, s, k = lut.shape
    n, l = xa.shape
    width = (s + 1) // 2 if name == "adc_scan4" else s
    if name == "adc_scan4" and k != 16:
        raise ValueError(f"adc_scan4: packed ADC needs K = 16 tables, got K = {k}")
    if codes.shape != (n, width) or qa.shape[:2] != (b, l):
        raise ValueError(
            f"{name}: shapes lut {tuple(lut.shape)}, codes {tuple(codes.shape)}, "
            f"qa {tuple(qa.shape)}, xa {tuple(xa.shape)} do not agree"
        )
    if mask is not None and mask.shape != (b, l):
        raise ValueError(f"{name}: mask must be {(b, l)}, got {tuple(mask.shape)}")
    if device.type == "cpu":
        return plain(lut, codes, qa, xa, alpha, mode, mask)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    qlo, qhi = (t.contiguous() for t in split_targets(qa))
    out = torch.empty((b, n), dtype=torch.float32, device=device)
    launch = build.launcher(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            lut.data_ptr(), codes.data_ptr(), qlo.data_ptr(), qhi.data_ptr(),
            None if mask is None else mask.data_ptr(), xa.data_ptr(), out.data_ptr(),
            b, n, s, k, l, inv_alpha(alpha), code, stream,
        )
    build.check(name, rc)
    wrapper.launches += 1
    return out


def adc_scan_scores(
    lut: torch.Tensor,  # (B, S, K) f32 per-query ADC tables
    codes: torch.Tensor,  # (N, S) uint8 codes (values < K)
    qa: torch.Tensor,  # (B, L) int32 points or (B, L, 2) intervals
    xa: torch.Tensor,  # (N, L) int32
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, N) squared fused ADC distances over 8-bit codes."""
    return _scan(adc_scan_scores, "adc_scan", adc_scan_ref, lut, codes, qa, xa, alpha, mode, mask)


def adc_scan4_scores(
    lut: torch.Tensor,  # (B, S, 16) f32 per-query ADC tables
    codes: torch.Tensor,  # (N, ⌈S/2⌉) uint8 packed nibbles
    qa: torch.Tensor,
    xa: torch.Tensor,
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, N) squared fused ADC distances over 4-bit codes packed two per
    byte (subspace 2i in the low nibble). Odd S stops at S: the pad nibble
    is never read."""
    return _scan(adc_scan4_scores, "adc_scan4", adc_scan4_ref, lut, codes, qa, xa, alpha, mode,
                 mask)


adc_scan_scores.launches = 0
adc_scan4_scores.launches = 0


def adc_scan(
    lut: torch.Tensor,
    codes: torch.Tensor,
    qa: torch.Tensor,
    xa: torch.Tensor,
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
    packed: bool = False,
) -> torch.Tensor:
    """(B, N) squared fused ADC distances; ``packed`` selects the 4-bit
    scanner."""
    fn = adc_scan4_scores if packed else adc_scan_scores
    return fn(lut, codes, qa, xa, alpha=alpha, mode=mode, mask=mask)


def adc_scan_topk(
    lut: torch.Tensor,
    codes: torch.Tensor,
    qa: torch.Tensor,
    xa: torch.Tensor,
    k: int,
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
    packed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate hybrid top-k over PQ codes: (sq-dists, ids), ascending,
    ties to the lower id."""
    return smallest_k(adc_scan(lut, codes, qa, xa, alpha, mode, mask, packed), k)


__all__ = [
    "adc_scan", "adc_scan_topk", "adc_scan_scores", "adc_scan4_scores",
    "adc_scan_ref", "adc_scan4_ref",
]
