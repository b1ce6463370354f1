"""Dispatch for the brute-force AUTO scorer.

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
hand-written kernel (``kernels/csrc/fused_auto.cu``) or raise.
``fused_auto.launches`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph_ops import smallest_k
from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands, inv_alpha, mode_code, split_targets
from repro_torch.kernels.fused_auto.ref import fused_auto_ref

#: Most attributes the kernel stages in shared memory in auto mode
#: (``kMaxAttrs`` in fused_auto.cu); above it the kernel reads them from
#: device memory in the same order, so any L gives the same bits.
MAX_ATTRS = 96


def fused_auto(
    qv: torch.Tensor,
    qa: torch.Tensor,
    xv: torch.Tensor,
    xa: torch.Tensor,
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, N) squared fused AUTO distances of every query to every row.
    ``qa`` is (B, L) point targets or (B, L, 2) [lo, hi] intervals."""
    device = check_operands(
        "fused_auto", qv=qv, qa=qa, xv=xv, xa=xa, mask=mask
    )
    code = mode_code(mode)
    b, m = qv.shape
    n, l = xa.shape
    if xv.shape != (n, m) or qa.shape[:2] != (b, l):
        raise ValueError(
            f"fused_auto: shapes qv {tuple(qv.shape)}, qa {tuple(qa.shape)}, "
            f"xv {tuple(xv.shape)}, xa {tuple(xa.shape)} do not agree"
        )
    if mask is not None and mask.shape != (b, l):
        raise ValueError(f"fused_auto: mask must be {(b, l)}, got {tuple(mask.shape)}")
    if device.type == "cpu":
        return fused_auto_ref(qv, qa, xv, xa, alpha, mode, mask)
    if device.type != "cuda":
        raise ValueError(f"fused_auto: unsupported device {device}")
    qlo, qhi = split_targets(qa)
    if qlo is not qhi:  # intervals; point targets stay one buffer, read as such
        qlo, qhi = qlo.contiguous(), qhi.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=device)
    launch = build.launcher("fused_auto")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            qv.data_ptr(), xv.data_ptr(), qlo.data_ptr(), qhi.data_ptr(),
            None if mask is None else mask.data_ptr(), xa.data_ptr(),
            out.data_ptr(), b, n, m, l, inv_alpha(alpha), code, stream,
        )
    build.check("fused_auto", rc)
    fused_auto.launches += 1
    return out


fused_auto.launches = 0


def fused_auto_topk(
    qv: torch.Tensor,
    qa: torch.Tensor,
    xv: torch.Tensor,
    xa: torch.Tensor,
    k: int,
    alpha: float = 1.0,
    mode: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact hybrid top-k over a candidate set through the fused scorer:
    (sq-dists, ids), ascending, ties to the lower id."""
    return smallest_k(fused_auto(qv, qa, xv, xa, alpha=alpha, mode=mode, mask=mask), k)


__all__ = ["MAX_ATTRS", "fused_auto", "fused_auto_ref", "fused_auto_topk"]
