"""Architecture registry: ``get_arch(<id>)`` resolution.

Every architecture id of the reference is ported: the five LM ids, the GNN
id (graphcast) and the four recsys ids. ``NOT_PORTED`` is empty; an id
listed there would raise ``KeyError`` naming the ROADMAP.md item that ports
it.
"""
from __future__ import annotations

from repro_torch.configs import (
    bert4rec,
    dlrm_rm2,
    fm,
    graphcast,
    kimi_k2_1t_a32b,
    mistral_large_123b,
    mixtral_8x7b,
    phi3_mini_3_8b,
    xdeepfm,
    yi_34b,
)
from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        mistral_large_123b.SPEC,
        yi_34b.SPEC,
        phi3_mini_3_8b.SPEC,
        kimi_k2_1t_a32b.SPEC,
        mixtral_8x7b.SPEC,
        graphcast.SPEC,
        dlrm_rm2.SPEC,
        xdeepfm.SPEC,
        bert4rec.SPEC,
        fm.SPEC,
    )
}

#: the reference's other architecture ids, with the item that ports each
NOT_PORTED: dict[str, str] = {}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: {NOT_PORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
