"""Dispatch for the FM second-order interaction, and its gradient.

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
hand-written kernel (``kernels/csrc/fm_interaction.cu``) or raise; meta
tensors (``launch.dryrun``) get the result's shape and nothing is counted.
``fm_interaction.launches`` counts kernel launches only (forwards).

``fm_interaction`` is a ``torch.autograd.Function``: the kernel's result
carries no ``grad_fn`` of its own, and fm's training takes the gradient of
``tables`` through it. The backward, ∂/∂e_fd = g·(s_d − e_fd) with ``s``
the field sum, is the same plain PyTorch ops on both devices in one fixed
order (``s`` summed over f = 0 … F−1 as ``ref.py`` sums it), so the card's
gradient equals the CPU's bit for bit. It is not a kernel: the TPU kernel
has no backward (the reference trains fm through ``fm_interaction_ref``
and XLA's autodiff), and at the training shape (65,536, 39, 10) it moves
about 0.3 GB.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands
from repro_torch.kernels.fm_interaction.ref import (
    field_sum,
    fm_interaction_pairwise_ref,
    fm_interaction_ref,
)

_INT_MAX = 2**31 - 1


def _forward(emb: torch.Tensor) -> torch.Tensor:
    device = check_operands("fm_interaction", emb=emb)
    if emb.ndim != 3:
        raise ValueError(f"fm_interaction: emb must be (B, F, D), got {tuple(emb.shape)}")
    b, f, d = emb.shape
    if max(b, f, d) > _INT_MAX:
        raise ValueError(f"fm_interaction: shape {tuple(emb.shape)} exceeds int32")
    if device.type == "cpu":
        return fm_interaction_ref(emb)
    if device.type == "meta":  # the dry run: the result's shape, no work
        return torch.empty((b,), dtype=torch.float32, device=device)
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


class _FmInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return _forward(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return g[:, None, None] * (field_sum(emb)[:, None, :] - emb)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """(B,) f32 FM second-order term ½ Σ_d [(Σ_f e_fd)² − Σ_f e_fd²] of
    (B, F, D) f32 field embeddings, differentiable in ``emb``."""
    return _FmInteraction.apply(emb)


fm_interaction.launches = 0

__all__ = ["fm_interaction", "fm_interaction_ref", "fm_interaction_pairwise_ref"]
