"""Plain PyTorch versions of the FM second-order interaction (Rendle,
ICDM'10).

    second_order(E) = ½ Σ_d [ (Σ_f e_fd)² − Σ_f e_fd² ]   for E (B, F, D)

``fm_interaction_ref`` is the O(F·D) sum-square trick in a fixed order:
``s`` and ``sq`` sum over f = 0 … F−1, one rounded add a field
(``field_sum``; the square rounded first); ``t_d = s_d·s_d − sq_d``; the
output sums ``t_d`` over
d = 0 … D−1, one add a term, then multiplies by 0.5. Every step is its own
PyTorch op, so nothing is contracted into an fma, and the CUDA kernel
(``csrc/fm_interaction.cu``) repeats the same steps: the two agree bit for
bit. ``fm_interaction_pairwise_ref`` is the O(F²·D) definition
Σ_{i<j} ⟨e_i, e_j⟩ it is checked against.
"""
from __future__ import annotations

import torch


def field_sum(e: torch.Tensor) -> torch.Tensor:
    """(B, D) Σ_f e_fd of (B, F, D), over f = 0 … F−1 from +0, one rounded
    add a field. ``fm_interaction_bwd_ref`` sums in this order too."""
    s = torch.zeros((e.shape[0], e.shape[2]), dtype=e.dtype, device=e.device)
    for i in range(e.shape[1]):
        s = s + e[:, i, :]
    return s


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """(B,) f32 second-order term of (B, F, D) field embeddings."""
    e = emb.to(torch.float32)
    b, _, d = e.shape
    s = field_sum(e)
    t = s * s - field_sum(e * e)
    acc = torch.zeros((b,), dtype=torch.float32, device=e.device)
    for j in range(d):
        acc = acc + t[:, j]
    return 0.5 * acc


def fm_interaction_bwd_ref(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, F, D) gradient of Σ_b g_b·second_order(E)_b: g_b·(s_bd − e_bfd),
    with ``s`` summed as ``field_sum`` sums it, then the difference and the
    product each rounded (the CUDA backward repeats these steps)."""
    return g[:, None, None] * (field_sum(emb)[:, None, :] - emb)


def fm_interaction_pairwise_ref(emb: torch.Tensor) -> torch.Tensor:
    """The literal definition Σ_{i<j} ⟨e_i, e_j⟩, used to validate the
    sum-square form."""
    e = emb.to(torch.float32)
    gram = torch.einsum("bfd,bgd->bfg", e, e)
    iu = torch.triu_indices(e.shape[1], e.shape[1], offset=1, device=e.device)
    return gram[:, iu[0], iu[1]].sum(-1)
