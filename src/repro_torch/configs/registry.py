"""Architecture registry: ``get_arch(<id>)`` resolution.

The four recsys ids are ported. Every LM and GNN id of the reference raises
``KeyError`` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from repro_torch.configs import bert4rec, dlrm_rm2, fm, xdeepfm
from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in (dlrm_rm2.SPEC, xdeepfm.SPEC, bert4rec.SPEC, fm.SPEC)
}

_MODELS = "ROADMAP.md queue 1, item 16 (the LM and GNN models)"
#: the reference's other architecture ids, with the item that ports each
NOT_PORTED: dict[str, str] = {
    "mistral-large-123b": _MODELS, "yi-34b": _MODELS, "phi3-mini-3.8b": _MODELS,
    "kimi-k2-1t-a32b": _MODELS, "mixtral-8x7b": _MODELS, "graphcast": _MODELS,
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: {NOT_PORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
