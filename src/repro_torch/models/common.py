"""Shared model-building blocks: the precision policy and parameter
counting over a dict of tensors. The MLP, norm and loss helpers come with
the families that use them (ROADMAP.md queue 1, items 13 and 16)."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: f32 master params, bf16 compute."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


FP32 = Precision(param_dtype=torch.float32, compute_dtype=torch.float32)
MIXED = Precision()


def count_params(params: dict[str, torch.Tensor]) -> int:
    """Number of parameters in a dict of tensors (meta tensors count
    without memory)."""
    return int(sum(math.prod(t.shape) for t in params.values()))


def tree_bytes(params: dict[str, torch.Tensor]) -> int:
    return int(sum(math.prod(t.shape) * t.element_size() for t in params.values()))
