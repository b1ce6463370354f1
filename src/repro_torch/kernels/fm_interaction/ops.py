"""Dispatch for the FM second-order interaction.

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
hand-written kernel (``kernels/csrc/fm_interaction.cu``) or raise.
``fm_interaction.launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_pairwise_ref,
    fm_interaction_ref,
)

_INT_MAX = 2**31 - 1


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """(B,) f32 FM second-order term ½ Σ_d [(Σ_f e_fd)² − Σ_f e_fd²] of
    (B, F, D) f32 field embeddings."""
    device = check_operands("fm_interaction", emb=emb)
    if emb.ndim != 3:
        raise ValueError(f"fm_interaction: emb must be (B, F, D), got {tuple(emb.shape)}")
    b, f, d = emb.shape
    if max(b, f, d) > _INT_MAX:
        raise ValueError(f"fm_interaction: shape {tuple(emb.shape)} exceeds int32")
    if device.type == "cpu":
        return fm_interaction_ref(emb)
    if device.type != "cuda":
        raise ValueError(f"fm_interaction: unsupported device {device}")
    if b == 0 or f * d == 0:  # nothing to launch: an empty sum is 0
        return torch.zeros((b,), dtype=torch.float32, device=device)
    out = torch.empty((b,), dtype=torch.float32, device=device)
    launch = build.launcher("fm_interaction")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(emb.data_ptr(), out.data_ptr(), b, f, d, stream)
    build.check("fm_interaction", rc)
    fm_interaction.launches += 1
    return out


fm_interaction.launches = 0

__all__ = ["fm_interaction", "fm_interaction_ref", "fm_interaction_pairwise_ref"]
