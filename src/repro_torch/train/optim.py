"""Optimizer settings. Only ``OptimConfig`` is ported: ``ArchSpec`` carries
it. AdamW, Adafactor and SGD come with the training slice (ROADMAP.md
queue 1, item 15)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    kind: str = "adamw"  # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999  # adafactor: decay exponent handled separately
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    min_dim_size_to_factor: int = 128
    decay_offset: float = 0.8  # \hat{β}2_t = 1 - t^{-0.8}
