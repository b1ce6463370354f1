"""Peaks of one NVIDIA H100 SXM and the work each timed kernel needs.

Peaks are NVIDIA's data sheet (dense, no sparsity, at the 700 W limit).
A kernel's least time is the larger of its operations over the float32
rate and its bytes over the memory rate. Bytes count each input read once
and each output written once, the convention of the port's kernel table.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def least_time_s(bytes_: float, ops: float) -> float:
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def fused_auto_work(b: int, n: int, m: int, l: int) -> tuple[float, float]:
    """(bytes, operations) of scoring b queries against n rows of m
    features and l attributes: the queries, the rows, their attributes
    and both target bounds read, the (b, n) scores written; 2·m operations
    a pair for the product, 2·m a vector for the norms, 4 a pair for the
    epilogue."""
    bytes_ = (b * m + n * m + n * l + b * l * 2) * 4 + b * n * 4
    ops = 2 * b * n * m + 2 * (b + n) * m + 4 * b * n
    return bytes_, ops
